"""Training launcher of the port (the counterpart of ``repro.launch.train``),
on the card unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --steps 50 --batch 8 --seq 64 --ckpt-dir CKPT_DIR [--device cpu]

* ``--smoke`` selects the reduced same-family config (CPU-runnable);
  without it the full registered config is used (on the card).
* Resumes automatically from the latest checkpoint in --ckpt-dir.
* ``--grad-compression int8`` trains on int8-rounded gradients.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.registry import ARCHS, SMOKE
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, train


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card; 'cpu' "
                         "trains it on the CPU)")
    return ap


def data_config(cfg, seq: int, batch: int) -> DataConfig:
    """The batches of ``cfg``'s family: frame embeddings for whisper (one per
    position), patch embeddings for the VLM."""
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
    if cfg.family == "whisper":
        dc = dataclasses.replace(dc, frames_dim=cfg.d_model, n_frames=seq)
    if cfg.family == "vlm":
        dc = dataclasses.replace(dc, img_dim=cfg.d_model,
                                 n_patches=cfg.n_img_patches)
    return dc


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    model = get_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} params={model.param_count():,}")

    data = SyntheticLM(data_config(cfg, args.seq, args.batch))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    loop_cfg = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, log_every=10,
                          grad_compression=args.grad_compression)
    _, _, hist = train(model, data, opt_cfg, loop_cfg, device=args.device)
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
