"""Decoder-only transformer LM of the port (the counterpart of
``repro.models.transformer``): dense (llama/glm/deepseek/tinyllama), MoE
(olmoe/qwen3-moe) and VLM (internvl2 backbone + stub patch embeds).

Parameters are stacked over layers, as in JAX; JAX's ``lax.scan`` over them
is a loop over the layers' views of the stacked tensors (``layers_of``).
Under autograd each layer body is recomputed in the backward when
``cfg.remat`` (``jax.checkpoint`` in JAX).  Decode threads the stacked KV
caches (``(L, ...)`` leaves) through the same loop, writing each layer's
new key/value in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models.base import ParamDef, compute_dtype, layer, layers_of, remat
from repro_torch.parallel.sharding import logical


def param_defs(cfg: ModelConfig):
    L = cfg.n_layers
    block: Dict[str, Any] = {
        "ln1": ParamDef((L, cfg.d_model), ("layers", None), init="ones"),
        "ln2": ParamDef((L, cfg.d_model), ("layers", None), init="ones"),
        "attn": nn.attn_defs(cfg, L),
    }
    if cfg.family == "moe":
        block["moe"] = moe_lib.moe_defs(cfg, L)
    else:
        block["mlp"] = nn.mlp_defs(cfg, L)
    defs = {"blocks": block, **nn.embed_defs(cfg)}
    if cfg.family == "vlm":
        # stub frontend -> backbone projector (patch embeds arrive precomputed)
        defs["img_proj"] = ParamDef((cfg.d_model, cfg.d_model),
                                    ("w_embed", "w_embed2"))
    return defs


def _block(cfg, h, lp, positions, cache=None):
    """One transformer block.  Returns (h, new_cache, aux)."""
    a_in = nn.rmsnorm(h, lp["ln1"], cfg.norm_eps)
    attn_out, new_cache = nn.attention(lp["attn"], a_in, cfg, positions,
                                       cache=cache)
    h = h + attn_out
    m_in = nn.rmsnorm(h, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        m_out, aux = moe_lib.moe_mlp(lp["moe"], m_in, cfg)
    else:
        m_out, aux = nn.mlp(lp["mlp"], m_in, cfg), 0.0
    return logical(h + m_out, "batch", "seq", "embed"), new_cache, aux


def _train_block(cfg, h, lp, positions):
    h, _, a = _block(cfg, h, lp, positions)
    return h, a


def forward(params, tokens, cfg: ModelConfig, img_embeds=None, caches=None,
            positions=None):
    """Run the backbone.  Returns (hidden, new_caches, aux_loss).

    * train/prefill: caches=None, tokens (B, S) [+ img_embeds (B, P, D)].
    * decode: caches = stacked KV tree, tokens (B, 1); the caches' k/v are
      written in place and returned with the new per-layer ``pos``.
    """
    dtype = compute_dtype(cfg)
    h = nn.embed(params, tokens, cfg, dtype)
    if cfg.family == "vlm" and img_embeds is not None:
        img = torch.einsum("bpd,de->bpe", img_embeds.to(dtype),
                           params["img_proj"].to(dtype))
        h = torch.cat([img, h], dim=1)
        h = logical(h, "batch", "seq", "embed")
    B, S, _ = h.shape
    if positions is None:
        positions = nn.seq_positions(B, S, h.device)

    blocks = layers_of(params["blocks"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if caches is None:
        for lp in blocks:
            h, a = remat(_train_block, cfg.remat, cfg, h, lp, positions)
            aux = aux + a
        return h, None, aux

    new_pos = []
    for i, lp in enumerate(blocks):
        h, new_cache, _ = _block(cfg, h, lp, positions, cache=layer(caches, i))
        new_pos.append(new_cache["pos"])
    return h, dict(caches, pos=torch.stack(new_pos)), aux


def loss_fn(params, batch, cfg: ModelConfig):
    """batch: {tokens (B,S) int, [img_embeds (B,P,D)]}.  Next-token CE."""
    tokens = batch["tokens"]
    img = batch.get("img_embeds")
    h, _, aux = forward(params, tokens[:, :-1], cfg, img_embeds=img)
    if img is not None:
        h = h[:, img.shape[1]:]          # loss on the text positions only
    loss = nn.chunked_xent(params, h, tokens[:, 1:], cfg)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Stacked (L-leading) KV caches for decode."""
    one = nn.init_kv_cache(cfg, batch, max_seq, compute_dtype(cfg), device)
    return {k: v[None].expand((cfg.n_layers,) + v.shape).clone()
            for k, v in one.items()}


def prefill(params, tokens, cfg: ModelConfig, max_seq: int, img_embeds=None):
    """Full-sequence pass that also fills the KV caches (no sampling here):
    the blocks run at full sequence length, each writing its K/V first."""
    B, S = tokens.shape
    caches = init_caches(cfg, B, max_seq, tokens.device)
    dtype = compute_dtype(cfg)
    h = nn.embed(params, tokens, cfg, dtype)
    positions = nn.seq_positions(B, S, h.device)
    for i, lp in enumerate(layers_of(params["blocks"])):
        a_in = nn.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        k = torch.einsum("bsd,dhk->bshk", a_in, lp["attn"]["wk"].to(dtype))
        v = torch.einsum("bsd,dhk->bshk", a_in, lp["attn"]["wv"].to(dtype))
        k = nn.rope(k, positions, cfg.rope_theta)
        caches["k"][i, :, :S] = k.to(caches["k"].dtype)
        caches["v"][i, :, :S] = v.to(caches["v"].dtype)
        caches["pos"][i] = S
        h, _, _ = _block(cfg, h, lp, positions)
    logits = nn.lm_logits(params, h[:, -1:], cfg)
    return logits, caches


def decode_logits(params, caches, token, cfg: ModelConfig, pos):
    """One cached decode step.  token (B,1) -> (logits (B,1,V), caches)."""
    positions = nn.decode_positions(pos, token.shape[0], token.device)
    h, new_caches, _ = forward(params, token, cfg, caches=caches,
                               positions=positions)
    return nn.lm_logits(params, h, cfg), new_caches


def decode_step(params, caches, token, cfg: ModelConfig, pos):
    """One greedy decode step.  token (B,1) -> (next (B,1), new caches)."""
    logits, new_caches = decode_logits(params, caches, token, cfg, pos)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_caches
