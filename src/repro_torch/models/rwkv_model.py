"""RWKV-6 full model of the port (the counterpart of
``repro.models.rwkv_model``): (time_mix + channel_mix) layers over the
shared embedding/head.  State tree (stacked per layer): last-token streams
for both mixes + the (B,H,K,V) WKV state -- O(1) in sequence length."""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models import rwkv6
from repro_torch.models.base import ParamDef, compute_dtype, layers_of, remat
from repro_torch.parallel.sharding import logical_state


def param_defs(cfg: ModelConfig):
    L = cfg.n_layers
    return {
        "blocks": {
            "ln1": ParamDef((L, cfg.d_model), ("layers", None), init="ones"),
            "ln2": ParamDef((L, cfg.d_model), ("layers", None), init="ones"),
            "tm": rwkv6.timemix_defs(cfg, L),
            "cm": rwkv6.chanmix_defs(cfg, L),
        },
        **nn.embed_defs(cfg),
    }


def init_state(cfg: ModelConfig, batch: int, device=None):
    H, hd = rwkv6.rwkv_dims(cfg)
    L, D = cfg.n_layers, cfg.d_model
    dtype = compute_dtype(cfg)
    return {
        "tm_last": torch.zeros((L, batch, 1, D), dtype=dtype, device=device),
        "cm_last": torch.zeros((L, batch, 1, D), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32, device=device),
    }


def _body(cfg, h, lp, tm_last, cm_last, wkv):
    a_in = nn.rmsnorm(h, lp["ln1"], cfg.norm_eps)
    a, (tm_last2, wkv2) = rwkv6.time_mix(lp["tm"], a_in, cfg, tm_last, wkv)
    h = h + a
    c_in = nn.rmsnorm(h, lp["ln2"], cfg.norm_eps)
    c, cm_last2 = rwkv6.channel_mix(lp["cm"], c_in, cfg, cm_last)
    return h + c, tm_last2.to(tm_last.dtype), cm_last2.to(cm_last.dtype), wkv2


def forward(params, tokens, cfg: ModelConfig, state=None):
    """Returns (hidden, new_state); the new state is a fresh tree."""
    h = nn.embed(params, tokens, cfg, compute_dtype(cfg))
    if state is None:
        state = logical_state(init_state(cfg, h.shape[0], h.device))
    tm, cm, wkv = [], [], []
    use_remat = cfg.remat and tokens.shape[1] > 1
    for i, lp in enumerate(layers_of(params["blocks"])):
        h, tm_last2, cm_last2, wkv2 = remat(
            _body, use_remat, cfg, h, lp, state["tm_last"][i], state["cm_last"][i],
            state["wkv"][i])
        tm.append(tm_last2)
        cm.append(cm_last2)
        wkv.append(wkv2)
    return h, {"tm_last": torch.stack(tm), "cm_last": torch.stack(cm),
               "wkv": torch.stack(wkv)}


def loss_fn(params, batch, cfg: ModelConfig):
    tokens = batch["tokens"]
    h, _ = forward(params, tokens[:, :-1], cfg)
    loss = nn.chunked_xent(params, h, tokens[:, 1:], cfg)
    return loss, {"xent": loss}


def decode_logits(params, state, token, cfg: ModelConfig, pos=None):
    h, new_state = forward(params, token, cfg, state=state)
    return nn.lm_logits(params, h, cfg), new_state


def decode_step(params, state, token, cfg: ModelConfig, pos=None):
    logits, new_state = decode_logits(params, state, token, cfg, pos)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_state
