"""Unified model interface of the port (the counterpart of
``repro.models.api``): one entry point per family for the serving driver
and the tests.

    model = get_model(cfg)
    model.param_defs()                       -> ParamDef tree
    model.init_params(generator)             -> parameter tree on the generator's device
    model.loss_fn(params, batch)             (train/prefill compute)
    model.init_caches(batch, seq, device)    (decode state)
    model.decode_step(params, caches, token, pos)   -> (next token, caches)
    model.decode_logits(params, caches, token, pos) -> (logits, caches)
    model.forward_logits(params, tokens)     uncached full-sequence logits
    model.input_specs(shape_cell)            meta tensors (JAX: ShapeDtypeStruct)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.registry import ModelConfig, ShapeCell
from repro_torch.models import base, layers
from repro_torch.models import rwkv_model, transformer, whisper, zamba


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    _defs: Callable
    _loss: Callable
    _init_caches: Callable
    _decode_logits: Callable
    _decode_step: Callable

    def param_defs(self):
        return self._defs(self.cfg)

    def param_shapes(self):
        return base.shape_tree(self.param_defs())

    def init_params(self, generator: torch.Generator, device=None):
        return base.init_tree(self.param_defs(), generator, device)

    def param_count(self) -> int:
        return base.param_count(self.param_defs())

    def loss_fn(self, params, batch):
        return self._loss(params, batch, self.cfg)

    def init_caches(self, batch: int, max_seq: int, device=None):
        return self._init_caches(self.cfg, batch, max_seq, device)

    def decode_logits(self, params, caches, token, pos):
        return self._decode_logits(params, caches, token, self.cfg, pos)

    def decode_step(self, params, caches, token, pos):
        return self._decode_step(params, caches, token, self.cfg, pos)

    def forward_logits(self, params, tokens):
        """Logits of the uncached forward pass over ``tokens`` (B, S): what
        the cached decode of the same stream must give (decoder-only
        families; whisper's decode attends to its encoder caches)."""
        fam = self.cfg.family
        if fam in ("dense", "moe", "vlm"):
            h, _, _ = transformer.forward(params, tokens, self.cfg)
        elif fam == "hybrid":
            h, _, _ = zamba.forward(params, tokens, self.cfg)
        elif fam == "rwkv":
            h, _ = rwkv_model.forward(params, tokens, self.cfg)
        else:
            raise ValueError(f"no uncached decoder-only pass for family {fam!r}")
        return layers.lm_logits(params, h, self.cfg)

    # ------------------------------------------------------------------
    # Dry-run inputs, as meta tensors
    # ------------------------------------------------------------------
    def input_specs(self, cell: ShapeCell) -> Dict[str, Any]:
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        dt = base.compute_dtype(cfg)

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")
        if cell.kind in ("train", "prefill"):
            if cfg.family == "whisper":
                return {"frames": meta((B, S, cfg.d_model), dt),
                        "tokens": meta((B, S + 1))}
            if cfg.family == "vlm":
                P = cfg.n_img_patches
                return {"tokens": meta((B, S - P + 1)),
                        "img_embeds": meta((B, P, cfg.d_model), dt)}
            return {"tokens": meta((B, S + 1))}
        # decode: caches at full length + one token
        return {"caches": self.init_caches(B, S, device="meta"),
                "token": meta((B, 1)),
                "pos": meta(())}


def _whisper_caches(cfg, batch, max_seq, device=None):
    # encoder context scales with the cell seq too; enc_seq == max_seq
    return whisper.init_caches(cfg, batch, max_seq, max_seq, device)


def _rwkv_state(cfg, batch, max_seq, device=None):
    return rwkv_model.init_state(cfg, batch, device)


_TRANSFORMER = (transformer.param_defs, transformer.loss_fn, transformer.init_caches,
                transformer.decode_logits, transformer.decode_step)
_FAMILIES = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "vlm": _TRANSFORMER,
    "hybrid": (zamba.param_defs, zamba.loss_fn, zamba.init_caches,
               zamba.decode_logits, zamba.decode_step),
    "whisper": (whisper.param_defs, whisper.loss_fn, _whisper_caches,
                whisper.decode_logits, whisper.decode_step),
    "rwkv": (rwkv_model.param_defs, rwkv_model.loss_fn, _rwkv_state,
             rwkv_model.decode_logits, rwkv_model.decode_step),
}


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg, *_FAMILIES[cfg.family])
