"""Fault-tolerant training loop of the port (the counterpart of
``repro.train.loop``): checkpoint/restart, straggler watchdog,
deterministic data resume, optional gradient compression.

Designed so that a SIGKILL at any step loses at most ``ckpt_every`` steps:
the data pipeline is stateless (batch_at(step)), checkpoints are atomic,
and restore puts the tree on whatever device the restarted job has.  Each
step moves its batch to the device once and reads the loss back once
(``float``), its one host sync."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.api import Model
from repro_torch.models.base import resolve_device
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    # straggler watchdog: flag steps slower than watchdog_factor x the
    # running median (on real clusters this triggers requeue/hot-spare;
    # here it logs and counts -- the hook point is `on_straggler`)
    watchdog_factor: float = 3.0
    grad_compression: Optional[str] = None


class StragglerWatchdog:
    def __init__(self, factor: float):
        self.factor = factor
        self.times = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = float(np.median(self.times[-50:]))
            slow = dt > self.factor * med
        self.times.append(dt)
        if slow:
            self.flagged += 1
        return slow


def train(model: Model, data: SyntheticLM, opt_cfg: adamw.AdamWConfig,
          loop_cfg: LoopConfig, params=None,
          on_metrics: Optional[Callable[[int, Dict], None]] = None, device=None):
    """Run (or resume) training on ``device`` (default the card).  Returns
    (params, opt_state, history); ``params`` passed in are updated in place."""
    dev = resolve_device(device)
    if params is None:
        params = model.init_params(torch.Generator(dev).manual_seed(0))
    opt_state = adamw.init(params)
    start_step = 0

    mgr = None
    if loop_cfg.ckpt_dir:
        mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep_ckpts)
        step0, restored = mgr.restore_latest({"params": params, "opt": opt_state}, dev)
        if step0 is not None:
            opt = restored["opt"]
            params, opt_state = restored["params"], adamw.AdamWState(
                opt.step.cpu(), opt.m, opt.v)
            start_step = step0
            print(f"[resume] from step {step0}")

    step_fn = make_train_step(model, opt_cfg, loop_cfg.grad_compression)
    dog = StragglerWatchdog(loop_cfg.watchdog_factor)
    history = []
    tokens_per_batch = data.cfg.global_batch * data.cfg.seq_len

    for step in range(start_step, loop_cfg.steps):
        t0 = time.monotonic()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # blocks; honest step time
        dt = time.monotonic() - t0
        slow = dog.observe(dt)
        rec = {"step": step + 1, "loss": loss, "dt": dt,
               "tok_s": tokens_per_batch / dt, "straggler": slow}
        history.append(rec)
        if on_metrics:
            on_metrics(step + 1, rec)
        if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
            print(f"[step {step+1:>5}] loss {loss:.4f}  {dt*1e3:7.1f} ms "
                  f"{rec['tok_s']:,.0f} tok/s"
                  + ("  [STRAGGLER]" if slow else ""))
        if mgr and (step + 1) % loop_cfg.ckpt_every == 0:
            path = mgr.save(step + 1, {"params": params, "opt": opt_state._asdict()})
            print(f"[ckpt] step {step+1} -> {path}")
    if dog.flagged:
        print(f"[watchdog] flagged {dog.flagged} straggler steps")
    return params, opt_state, history
