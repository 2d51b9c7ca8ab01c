"""Whisper-style encoder-decoder backbone of the port (the counterpart of
``repro.models.whisper``).  The conv/log-mel frontend is a stub: the
encoder takes precomputed frame embeddings (B, S_frames, d_model).

Decode = decoder one-token step with a self-attention KV cache +
cross-attention over cached encoder K/V.  RoPE replaces Whisper's absolute
embeddings, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models.base import ParamDef, compute_dtype, layer, layers_of, remat
from repro_torch.parallel.sharding import logical


def param_defs(cfg: ModelConfig):
    L, Ld = cfg.n_layers, cfg.dec_layers
    D = cfg.d_model
    enc_block = {
        "ln1": ParamDef((L, D), ("layers", None), init="ones"),
        "ln2": ParamDef((L, D), ("layers", None), init="ones"),
        "attn": nn.attn_defs(cfg, L),
        "mlp": nn.mlp_defs(cfg, L),
    }
    dec_block = {
        "ln1": ParamDef((Ld, D), ("layers", None), init="ones"),
        "ln2": ParamDef((Ld, D), ("layers", None), init="ones"),
        "ln3": ParamDef((Ld, D), ("layers", None), init="ones"),
        "self_attn": nn.attn_defs(cfg, Ld),
        "cross_attn": nn.attn_defs(cfg, Ld),
        "mlp": nn.mlp_defs(cfg, Ld),
    }
    return {"encoder": enc_block, "decoder": dec_block,
            # Whisper's ln_post: the encoder residual stream is normalized
            # before cross-attention K/V consume it.
            "enc_ln_post": ParamDef((D,), (None,), init="ones"),
            **nn.embed_defs(cfg)}


def encode(params, frames, cfg: ModelConfig):
    """frames: (B, S_f, D) precomputed embeddings (stub frontend output)."""
    h = logical(frames.to(compute_dtype(cfg)), "batch", "seq", "embed")
    B, S, _ = h.shape
    positions = nn.seq_positions(B, S, h.device)
    for lp in layers_of(params["encoder"]):
        h = remat(_enc_block, cfg.remat, cfg, h, lp, positions)
    return nn.rmsnorm(h, params["enc_ln_post"], cfg.norm_eps)


def _enc_block(cfg, h, lp, positions):
    a, _ = nn.attention(lp["attn"], nn.rmsnorm(h, lp["ln1"], cfg.norm_eps),
                        cfg, positions, causal=False)
    h = h + a
    h = h + nn.mlp(lp["mlp"], nn.rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg)
    return logical(h, "batch", "seq", "embed")


def _cross_kv(lp, enc_h, cfg):
    """Cross-attention K/V from encoder states (one decoder layer)."""
    dtype = enc_h.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_h, lp["cross_attn"]["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_h, lp["cross_attn"]["wv"].to(dtype))
    return k, v


def decode_train(params, tokens, enc_h, cfg: ModelConfig):
    """Teacher-forced decoder pass over full target sequence."""
    h = nn.embed(params, tokens, cfg, compute_dtype(cfg))
    B, S, _ = h.shape
    positions = nn.seq_positions(B, S, h.device)
    for lp in layers_of(params["decoder"]):
        h = remat(_dec_block, cfg.remat, cfg, h, lp, enc_h, positions)
    return h


def _dec_block(cfg, h, lp, enc_h, positions):
    a, _ = nn.attention(lp["self_attn"], nn.rmsnorm(h, lp["ln1"], cfg.norm_eps),
                        cfg, positions, causal=True)
    h = h + a
    c, _ = nn.attention(lp["cross_attn"], nn.rmsnorm(h, lp["ln2"], cfg.norm_eps),
                        cfg, positions, cross_kv=_cross_kv(lp, enc_h, cfg),
                        use_rope=False)
    h = h + c
    h = h + nn.mlp(lp["mlp"], nn.rmsnorm(h, lp["ln3"], cfg.norm_eps), cfg)
    return logical(h, "batch", "seq", "embed")


def loss_fn(params, batch, cfg: ModelConfig):
    """batch: {frames (B,Sf,D), tokens (B,St)}."""
    enc_h = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    h = decode_train(params, tokens[:, :-1], enc_h, cfg)
    loss = nn.chunked_xent(params, h, tokens[:, 1:], cfg)
    return loss, {"xent": loss}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, enc_seq: int,
                device=None):
    Ld = cfg.dec_layers
    dt = compute_dtype(cfg)
    kv = nn.init_kv_cache(cfg, batch, max_seq, dt, device)
    KVH, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "self": {k: v[None].expand((Ld,) + v.shape).clone() for k, v in kv.items()},
        "cross_k": torch.zeros((Ld, batch, enc_seq, KVH, hd), dtype=dt, device=device),
        "cross_v": torch.zeros((Ld, batch, enc_seq, KVH, hd), dtype=dt, device=device),
    }


def prefill(params, frames, cfg: ModelConfig, batch: int, max_seq: int):
    """Encode audio + precompute cross K/V for decoding."""
    enc_h = encode(params, frames, cfg)
    caches = init_caches(cfg, batch, max_seq, frames.shape[1], frames.device)
    for i, lp in enumerate(layers_of(params["decoder"])):
        ck, cv = _cross_kv(lp, enc_h, cfg)
        caches["cross_k"][i] = ck.to(caches["cross_k"].dtype)
        caches["cross_v"][i] = cv.to(caches["cross_v"].dtype)
    return caches


def decode_logits(params, caches, token, cfg: ModelConfig, pos):
    dtype = compute_dtype(cfg)
    h = nn.embed(params, token, cfg, dtype)
    positions = nn.decode_positions(pos, token.shape[0], token.device)
    new_pos = []
    for i, lp in enumerate(layers_of(params["decoder"])):
        a, new_cache = nn.attention(lp["self_attn"],
                                    nn.rmsnorm(h, lp["ln1"], cfg.norm_eps), cfg,
                                    positions, cache=layer(caches["self"], i))
        h = h + a
        cross = (caches["cross_k"][i].to(dtype), caches["cross_v"][i].to(dtype))
        c, _ = nn.attention(lp["cross_attn"], nn.rmsnorm(h, lp["ln2"], cfg.norm_eps),
                            cfg, positions, cross_kv=cross, use_rope=False)
        h = h + c
        h = h + nn.mlp(lp["mlp"], nn.rmsnorm(h, lp["ln3"], cfg.norm_eps), cfg)
        new_pos.append(new_cache["pos"])
    new_caches = dict(caches, self=dict(caches["self"], pos=torch.stack(new_pos)))
    return nn.lm_logits(params, h, cfg), new_caches


def decode_step(params, caches, token, cfg: ModelConfig, pos):
    logits, new_caches = decode_logits(params, caches, token, cfg, pos)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_caches
