"""The port's training loop (``repro_torch.train.loop``), launcher
(``repro_torch.launch.train``) and example (``repro_torch.examples.train_lm``)
on the CPU.

On ``TINY`` (JAX's loop-test model) the port's loss history over 5 steps,
from JAX's parameters, matches JAX's ``train()``: float32 within
``F32_TOL`` relative, bfloat16 within twice JAX's own bf16-vs-f32 error at
each step.  Then the port's twins of ``tests/test_train_loop.py``: the loss
improves, crash-resume continues exactly, the watchdog flags outliers,
int8-compressed training converges; the launcher for one arch per family
and the example, with their resume paths; the card is the default."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import llm_parity as lp
import train_parity as tp
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import train as jax_train
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.examples import train_lm
from repro_torch.launch import train as launch_train
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, StragglerWatchdog, train
from repro_torch.train.steps import make_eval_step, make_serve_step, make_train_step
from torch_threads import one_intra_op_thread  # noqa: F401

STEPS = 5


def _data():
    return dict(vocab=tp.TINY.vocab, seq_len=16, global_batch=4, seed=1)


def _opt():
    return dict(lr=1e-3, warmup_steps=2, total_steps=30)


def _setup(cfg=tp.TINY):
    return (get_model(cfg), SyntheticLM(DataConfig(**_data())), adamw.AdamWConfig(**_opt()))


def _jax_history(dtype: str):
    jcfg = dataclasses.replace(tp.JAX_TINY, dtype=dtype)
    params = tp.jax_params(jcfg, seed=0)
    _, _, hist = jax_train(jax_get_model(jcfg), JaxSyntheticLM(JaxDataConfig(**_data())),
                           jadamw.AdamWConfig(**_opt()),
                           JaxLoopConfig(steps=STEPS, ckpt_dir=None, log_every=100),
                           params=jax.tree.map(np.asarray, params))
    return params, [r["loss"] for r in hist]


@pytest.fixture(scope="module")
def jax_histories():
    return {dtype: _jax_history(dtype) for dtype in lp.DTYPES}


@pytest.mark.parametrize("dtype", lp.DTYPES)
def test_loss_history_matches_jax(jax_histories, dtype):
    params, want = jax_histories[dtype]
    cfg = dataclasses.replace(tp.TINY, dtype=dtype)
    model, data, ocfg = _setup(cfg)
    _, _, hist = train(model, data, ocfg, LoopConfig(steps=STEPS, ckpt_dir=None, log_every=100),
                       params=base.params_from_numpy(params, "cpu"), device="cpu")
    assert [r["step"] for r in hist] == list(range(1, STEPS + 1))
    want32 = jax_histories["float32"][1] if dtype != "float32" else None
    for i, (r, w) in enumerate(zip(hist, want)):
        if want32 is None:
            assert abs(r["loss"] - w) <= lp.F32_TOL * max(1.0, abs(w)), (i, r["loss"], w)
        else:
            lp.assert_close(r["loss"], w, want32[i], f"bf16 step {i + 1}")


def test_loss_improves():
    model, data, ocfg = _setup()
    _, _, hist = train(model, data, ocfg, LoopConfig(steps=25, ckpt_dir=None, log_every=100),
                       device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(r["loss"]) and r["tok_s"] > 0 for r in hist)


def test_crash_resume_continues_exactly(tmp_path, capsys):
    """Train 20 straight vs 10 + resume 10: the same final loss (stateless
    data + checkpointed params + opt make restarts reproducible)."""
    model, data, ocfg = _setup()
    _, _, straight = train(model, data, ocfg,
                           LoopConfig(steps=20, ckpt_dir=None, log_every=100), device="cpu")
    ck = str(tmp_path / "ck")
    train(model, data, ocfg, LoopConfig(steps=10, ckpt_every=10, ckpt_dir=ck, log_every=100),
          device="cpu")
    capsys.readouterr()
    _, _, resumed = train(model, data, ocfg,
                          LoopConfig(steps=20, ckpt_every=10, ckpt_dir=ck, log_every=100),
                          device="cpu")
    out = capsys.readouterr().out
    assert "[resume] from step 10" in out and "[ckpt] step 20" in out
    assert resumed[0]["step"] == 11
    a, b = straight[-1]["loss"], resumed[-1]["loss"]
    assert a == pytest.approx(b, rel=1e-4), (a, b)


def test_watchdog_flags_outliers():
    dog = StragglerWatchdog(factor=3.0)
    for _ in range(10):
        assert not dog.observe(0.1)
    assert dog.observe(1.0)                    # 10x median -> straggler
    assert dog.flagged == 1


def test_int8_compressed_training_converges():
    model, data, ocfg = _setup()
    _, _, hist = train(model, data, ocfg,
                       LoopConfig(steps=25, ckpt_dir=None, log_every=100,
                                  grad_compression="int8"), device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_step_metrics_carry_jax_s_keys():
    model, data, ocfg = _setup()
    params = model.init_params(torch.Generator().manual_seed(0))
    state = adamw.init(params)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    ev = make_eval_step(model)(params, batch)
    _, state, m = make_train_step(model, ocfg, "int8")(params, state, batch)
    assert set(m) == {"loss", "xent", "aux", "grad_norm", "lr"} and set(ev) == {"loss", "xent", "aux"}
    assert float(m["loss"]) == pytest.approx(float(ev["loss"]), rel=1e-6)
    assert int(state.step) == 1 and float(m["grad_norm"]) > 0
    caches = model.init_caches(4, 8, "cpu")
    nxt, _ = make_serve_step(model)(params, caches, batch["tokens"][:, :1], 0)
    assert nxt.shape == (4, 1) and nxt.dtype == torch.int32


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, data, ocfg = _setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(model, data, ocfg, LoopConfig(steps=1, ckpt_dir=None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])


FAMILY_ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "internvl2-2b", "zamba2-1.2b",
                "rwkv6-1.6b", "whisper-base"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launch_train_smoke_on_cpu(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    hist = launch_train.main(argv)
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "done: loss" in out and "[ckpt] step 2" in out
    assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)
    resumed = launch_train.main(argv[:4] + ["4"] + argv[5:])
    assert "[resume] from step 2" in capsys.readouterr().out
    assert [r["step"] for r in resumed] == [3, 4]
    assert resumed[0]["loss"] == pytest.approx(hist[2]["loss"], rel=1e-5)


def test_train_lm_example_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    hist = train_lm.main(["--preset", "nano", "--steps", "6", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", ck, "--ckpt-every", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "preset=nano" in out and "over 6 steps" in out and len(hist) == 6
    more = train_lm.main(["--preset", "nano", "--steps", "8", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", ck, "--ckpt-every", "3", "--device", "cpu", "--resume"])
    assert "[resume] from step 6" in capsys.readouterr().out
    assert [r["step"] for r in more] == [7, 8]
