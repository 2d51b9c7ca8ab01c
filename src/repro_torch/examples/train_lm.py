"""End-to-end LM training driver of the port (the counterpart of
``examples/train_lm.py``): data pipeline -> model -> AdamW ->
checkpoint/restart -> straggler watchdog, on the card unless given
``--device cpu``.

Presets scale the same llama-family architecture to the runtime budget:

    PYTHONPATH=src python -m repro_torch.examples.train_lm                # nano, 200 steps
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --resume       # crash-restart
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

`--preset 100m` is the deliverable configuration (~100M params, a few
hundred steps); `nano` (~3M) makes the loss curve visible in CPU minutes.
Kill the process mid-run and re-invoke with --resume to exercise the
fault-tolerance path (atomic checkpoints + stateless data resume).  The
checkpoints go to ``--ckpt-dir`` (default ``repro_train_ckpt`` in the
temporary directory).
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.configs.registry import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, train

PRESETS = {
    "nano": ModelConfig("train-nano", "dense", 4, 128, 4, 2, 512, 2048,
                        rope_theta=10000.0),
    "30m": ModelConfig("train-30m", "dense", 6, 512, 8, 4, 2048, 8192,
                       rope_theta=10000.0),
    "100m": ModelConfig("train-100m", "dense", 12, 768, 12, 4, 3072, 32000,
                        rope_theta=10000.0),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_lm")
    ap.add_argument("--preset", default="nano", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="resume from latest checkpoint in --ckpt-dir")
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card; 'cpu' "
                         "trains it on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = PRESETS[args.preset]
    model = get_model(cfg)
    print(f"preset={args.preset}: {model.param_count():,} params, "
          f"{cfg.n_layers}L d{cfg.d_model}, vocab {cfg.vocab}")

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=0))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps)
    loop_cfg = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir if (args.resume or
                                                     args.ckpt_every) else None,
                          log_every=10,
                          grad_compression=args.grad_compression)
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
        os.makedirs(args.ckpt_dir, exist_ok=True)

    params, _, history = train(model, data, opt_cfg, loop_cfg, device=args.device)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.4f} -> {last:.4f} over {len(history)} steps "
          f"({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
