"""Zamba2-style hybrid of the port (the counterpart of
``repro.models.zamba``): Mamba2 backbone + a SHARED attention block applied
every ``ssm.shared_attn_every`` layers (weights shared, activations and KV
caches distinct per application site: site ``i // every`` before layer
``i`` when ``i % every == 0``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.base import ParamDef, compute_dtype, layer, layers_of, remat


def n_shared_sites(cfg) -> int:
    k = cfg.ssm.shared_attn_every
    return (cfg.n_layers + k - 1) // k


def param_defs(cfg: ModelConfig):
    L = cfg.n_layers
    return {
        "mamba": {
            "ln": ParamDef((L, cfg.d_model), ("layers", None), init="ones"),
            "block": ssm_lib.ssm_defs(cfg, L),
        },
        "shared": {                       # ONE set of weights, many sites
            "ln1": ParamDef((cfg.d_model,), (None,), init="ones"),
            "ln2": ParamDef((cfg.d_model,), (None,), init="ones"),
            "attn": nn.attn_defs(cfg, 0),
            "mlp": nn.mlp_defs(cfg, 0),
        },
        **nn.embed_defs(cfg),
    }


def _shared_block(cfg, params, h, positions, cache=None):
    sp = params["shared"]
    a_in = nn.rmsnorm(h, sp["ln1"], cfg.norm_eps)
    attn_out, new_cache = nn.attention(sp["attn"], a_in, cfg, positions,
                                       cache=cache)
    h = h + attn_out
    m_in = nn.rmsnorm(h, sp["ln2"], cfg.norm_eps)
    h = h + nn.mlp(sp["mlp"], m_in, cfg)
    return h, new_cache


def _train_body(cfg, params, h, lp, positions, with_attn: bool):
    """One layer of the full-sequence path: the shared block at a site,
    then the Mamba2 block (JAX's scan body, remat'ed as a whole)."""
    if with_attn:
        h, _ = _shared_block(cfg, params, h, positions)
    out, _ = ssm_lib.mamba_block(lp["block"], nn.rmsnorm(h, lp["ln"], cfg.norm_eps), cfg)
    return h + out


def forward(params, tokens, cfg: ModelConfig, caches=None, positions=None):
    """caches: {"kv": stacked (sites,...) KV, "ssm": (L,...), "conv": (L,...)}.
    In decode the sites' k/v are written in place; the returned tree holds
    them, the new per-site ``pos`` and fresh ssm/conv stacks."""
    h = nn.embed(params, tokens, cfg, compute_dtype(cfg))
    B, S, _ = h.shape
    if positions is None:
        positions = nn.seq_positions(B, S, h.device)
    every = cfg.ssm.shared_attn_every
    mamba = layers_of(params["mamba"])

    if caches is None:
        for i, lp in enumerate(mamba):
            h = remat(_train_body, cfg.remat, cfg, params, h, lp, positions,
                      i % every == 0)
        return h, None, torch.zeros((), dtype=torch.float32, device=h.device)

    kv = caches["kv"]
    site_pos = list(kv["pos"].unbind(0))
    ssm2, conv2 = [], []
    for i, lp in enumerate(mamba):
        if i % every == 0:
            site = i // every
            h, new_c = _shared_block(cfg, params, h, positions, cache=layer(kv, site))
            site_pos[site] = new_c["pos"]
        out, (st2, cv2) = ssm_lib.mamba_block(
            lp["block"], nn.rmsnorm(h, lp["ln"], cfg.norm_eps), cfg,
            state=caches["ssm"][i], conv_state=caches["conv"][i])
        h = h + out
        ssm2.append(st2)
        conv2.append(cv2)
    new_caches = {"kv": dict(kv, pos=torch.stack(site_pos)),
                  "ssm": torch.stack(ssm2), "conv": torch.stack(conv2)}
    return h, new_caches, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(params, batch, cfg: ModelConfig):
    tokens = batch["tokens"]
    h, _, _ = forward(params, tokens[:, :-1], cfg)
    loss = nn.chunked_xent(params, h, tokens[:, 1:], cfg)
    return loss, {"xent": loss}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    sites = n_shared_sites(cfg)
    kv = nn.init_kv_cache(cfg, batch, max_seq, compute_dtype(cfg), device)
    kv = {k: v[None].expand((sites,) + v.shape).clone() for k, v in kv.items()}
    s = ssm_lib.init_ssm_cache(cfg, batch, device)
    L = cfg.n_layers
    return {
        "kv": kv,
        "ssm": s["ssm"][None].expand((L,) + s["ssm"].shape).clone(),
        "conv": s["conv"][None].expand((L,) + s["conv"].shape).clone(),
    }


def decode_logits(params, caches, token, cfg: ModelConfig, pos):
    positions = nn.decode_positions(pos, token.shape[0], token.device)
    h, new_caches, _ = forward(params, token, cfg, caches=caches,
                               positions=positions)
    return nn.lm_logits(params, h, cfg), new_caches


def decode_step(params, caches, token, cfg: ModelConfig, pos):
    logits, new_caches = decode_logits(params, caches, token, cfg, pos)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_caches
