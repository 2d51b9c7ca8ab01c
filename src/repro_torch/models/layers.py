"""Shared neural layers of the port (the counterpart of
``repro.models.layers``): norms, RoPE, GQA attention (train/prefill/decode),
MLPs, embeddings, chunked cross-entropy.  Pure functions over parameter
trees, run under ``torch.no_grad()`` by the serving path and under autograd
by the train step, which recomputes each attention and cross-entropy chunk
in the backward (``jax.checkpoint`` in JAX).

JAX's ``logical(...)`` sharding constraints are no-ops off a mesh and are
left out.  Attention is JAX's exact query-chunked form ("lazy flash"): per
chunk of queries the full key row is scored on bf16 operands with f32
accumulation, masked to -1e30 and softmaxed in f32 -- written out, not
``F.scaled_dot_product_attention``, so the masking and casts are JAX's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamDef, remat

#: The masked score, as in JAX.
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)   # jnp.var: ddof=0
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: (..., S, H, hd), positions: (..., S) int.  Rotates halves (not
    interleaved pairs); a bf16 ``x`` times the f32 tables is f32 until the
    final cast, as in JAX."""
    hd = x.shape[-1]
    half = hd // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, expo)        # a Python base: no host-to-device copy
    angles = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def decode_positions(pos, batch: int, device) -> torch.Tensor:
    """(batch, 1) int32 positions of a decode step at ``pos`` (an int or a
    0-d tensor; a tensor is not read back to the host)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device, torch.int32).reshape(1, 1).expand(batch, 1)
    return torch.full((batch, 1), pos, dtype=torch.int32, device=device)


def _even_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target (handles e.g. the VLM's
    S - n_patches = 3840 text positions against a 512 target)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# Attention (GQA) -- param defs
# ---------------------------------------------------------------------------
def attn_defs(cfg, L: int) -> Dict[str, ParamDef]:
    D, H, KVH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    return {
        "wq": ParamDef(lead + (D, H, hd), la + ("w_embed", "heads", "head_dim")),
        "wk": ParamDef(lead + (D, KVH, hd), la + ("w_embed", "heads", "head_dim")),
        "wv": ParamDef(lead + (D, KVH, hd), la + ("w_embed", "heads", "head_dim")),
        "wo": ParamDef(lead + (H, hd, D), la + ("heads", "head_dim", "w_embed")),
    }


def _expand_kv(k, n_heads):
    """(B,S,KVH,hd) -> (B,S,H,hd) by group replication: ``jnp.repeat`` on
    axis 2, each KV head ``g`` times in a row (head h reads KV head h // g)."""
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2)


def _scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX casts a weak Python scalar to the
    array's dtype before it multiplies."""
    return float(torch.tensor(value, dtype=dtype))


def _chunked_attention(q, k, v, positions_q, positions_k, causal, chunk):
    """Exact chunked attention.  q:(B,Sq,H,hd).  The dots run on q's-dtype
    operands with f32 accumulation (the operands widened to f32, where a
    product of two bf16 values is exact); only the softmax runs in f32.
    Under autograd each chunk is recomputed in the backward, so the live
    footprint stays O(chunk * Sk)."""
    b, sq, h, hd = q.shape
    scale = _scalar_in(1.0 / math.sqrt(hd), q.dtype)
    chunk = _even_chunk(sq, chunk)
    kf, vf = k.float(), v.float()

    def one_chunk(qc, pq):
        # qc:(B,C,H,hd) x k:(B,Sk,H,hd) -> scores (B,H,C,Sk), f32 accum
        scores = torch.einsum("bchd,bkhd->bhck", (qc * scale).to(q.dtype).float(), kf)
        if causal:
            mask = pq[:, None, :, None] >= positions_k[:, None, None, :]
            scores = torch.where(mask, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        # p:(B,H,C,Sk) x v:(B,Sk,H,hd) -> (B,C,H,hd), f32 accum
        out = torch.einsum("bhck,bkhd->bchd", p.to(q.dtype).float(), vf)
        return out.to(q.dtype)

    if chunk == sq:
        return remat(one_chunk, True, q, positions_q)
    return torch.cat([remat(one_chunk, True, q[:, i:i + chunk], positions_q[:, i:i + chunk])
                      for i in range(0, sq, chunk)], dim=1)


def attention(
    p, x, cfg, positions,
    cache: Optional[Dict[str, Any]] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal: bool = True,
    use_rope: bool = True,
):
    """GQA attention.  Returns (out, new_cache).

    * train/prefill: cache=None, full-sequence chunked attention.
    * decode: cache={"k","v","pos"} (one layer's views); x is (B,1,D).  The
      new key/value is written into the cache tensors in place, at the
      cache's own ``pos`` clamped into range (``dynamic_update_slice``);
      the keys up to and including ``pos`` are attended.  ``new_cache``
      holds the same k/v tensors and ``pos + 1``.
    * cross attention: cross_kv=(k,v) precomputed encoder keys/values.
    """
    B, S, D = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)

    if cross_kv is not None:
        k, v = cross_kv
        pos_k = torch.arange(k.shape[1], device=k.device)[None].expand(k.shape[:2])
        k = _expand_kv(k, H)
        v = _expand_kv(v, H)
        out = _chunked_attention(q, k, v, positions, pos_k, False, cfg.attn_chunk)
        new_cache = cache
    elif cache is None:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
        if use_rope:
            k = rope(k, positions, cfg.rope_theta)
        out = _chunked_attention(q, _expand_kv(k, H), _expand_kv(v, H),
                                 positions, positions, causal, cfg.attn_chunk)
        new_cache = None
    else:
        # --- single-token decode against the KV cache ---------------------
        k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
        v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
        if use_rope:
            k_new = rope(k_new, positions, cfg.rope_theta)
        kc, vc, pos = cache["k"], cache["v"], cache["pos"]
        Sk = kc.shape[1]
        slot = pos.clamp(0, Sk - 1).reshape(1).long()
        kc.index_copy_(1, slot, k_new.to(kc.dtype))
        vc.index_copy_(1, slot, v_new.to(vc.dtype))
        g = H // KVH
        qg = q.reshape(B, 1, KVH, g, hd)
        scores = torch.einsum("bqhgd,bkhd->bhgk", qg.float(), kc.float()) / math.sqrt(hd)
        mask = torch.arange(Sk, device=kc.device) <= pos        # valid prefix
        scores = torch.where(mask, scores, NEG_INF)
        pr = torch.softmax(scores, dim=-1)
        outg = torch.einsum("bhgk,bkhd->bhgd", pr, vc.float())
        out = outg.reshape(B, 1, H, hd).to(x.dtype)
        new_cache = {"k": kc, "v": vc, "pos": pos + 1}

    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"].to(x.dtype))
    return y, new_cache


def init_kv_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, device=None):
    KVH, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_seq, KVH, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, KVH, hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_defs(cfg, L: int) -> Dict[str, ParamDef]:
    D, Fd = cfg.d_model, cfg.d_ff
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    if cfg.mlp_act == "swiglu":
        return {
            "wg": ParamDef(lead + (D, Fd), la + ("w_embed", "mlp")),
            "wu": ParamDef(lead + (D, Fd), la + ("w_embed", "mlp")),
            "wd": ParamDef(lead + (Fd, D), la + ("mlp", "w_embed")),
        }
    return {
        "wi": ParamDef(lead + (D, Fd), la + ("w_embed", "mlp")),
        "wd": ParamDef(lead + (Fd, D), la + ("mlp", "w_embed")),
    }


def mlp(p, x, cfg):
    if cfg.mlp_act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))
        u = torch.einsum("bsd,df->bsf", x, p["wu"].to(x.dtype))
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype)),
                   approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wd"].to(x.dtype))


# ---------------------------------------------------------------------------
# Embedding / LM head / loss
# ---------------------------------------------------------------------------
def embed_defs(cfg) -> Dict[str, ParamDef]:
    return {
        "tok_embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "w_embed"),
                              init="embed", scale=0.02),
        "lm_head": ParamDef((cfg.d_model, cfg.vocab), ("w_embed", "vocab")),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


def embed(p, tokens, cfg, dtype):
    return p["tok_embed"][tokens.long()].to(dtype)


def lm_logits(p, h, cfg):
    h = rmsnorm(h, p["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", h, p["lm_head"].to(h.dtype))


def chunked_xent(p, h, labels, cfg, chunk: int = 512):
    """Mean next-token CE without materializing (B,S,V) at once.

    h is pre-final-norm hidden states; labels are already shifted.
    """
    B, S, D = h.shape
    chunk = _even_chunk(S, chunk)
    hn = rmsnorm(h, p["final_norm"], cfg.norm_eps)

    def one(hc, lc):
        logits = torch.einsum("bsd,dv->bsv", hc, p["lm_head"].to(hc.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return torch.sum(lse - ll)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        total = total + remat(one, True, hn[:, i:i + chunk], labels[:, i:i + chunk])
    return total / (B * S)
