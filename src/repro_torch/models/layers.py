"""Shared neural layers of the port (the counterpart of
``repro.models.layers``): norms, RoPE, GQA attention (train/prefill/decode),
MLPs, embeddings, chunked cross-entropy.  Pure functions over parameter
trees, run under ``torch.no_grad()`` by the serving path and under autograd
by the train step, which recomputes each attention and cross-entropy chunk
in the backward (``jax.checkpoint`` in JAX).

Sharding: activations are annotated with *logical* axis names via
``repro_torch.parallel.sharding.logical`` at JAX's places -- resolved only
inside a ``use_mesh`` context (DTensor leaves), the input itself off a
mesh.  Attention is JAX's exact query-chunked form ("lazy flash"): per
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
from repro_torch.parallel.sharding import gathered, locally, logical, multi_rank, on_mesh

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


def seq_positions(batch: int, seq: int, device) -> torch.Tensor:
    """(batch, seq) positions 0..seq-1 of a full-sequence pass.  On a mesh
    they are batch-sharded like the activations (JAX's SPMD propagates a
    sharding to its ``broadcast_to``; DTensor needs it stated), so the masks
    and RoPE tables derived from them are this rank's rows, not the global
    batch's."""
    return logical(torch.arange(seq, device=device)[None].expand(batch, seq),
                   "batch", None)


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


def _attention_local(q, k, v, positions_q, positions_k, causal, chunk):
    """``_chunked_attention`` on this rank's shards.

    Attention is independent per (batch row, head), so on a mesh it runs on
    the local shards (``local_map``): q, k and v constrained to (batch, *,
    heads, *), the positions with the batch's sharding, the output placed
    like q.  The chunk loop is then plain tensors, and no einsum flattens
    two sharded dims (batch and heads), which some DTensor versions refuse
    to view.  Off a mesh it is ``_chunked_attention`` itself."""
    if not on_mesh():
        return _chunked_attention(q, k, v, positions_q, positions_k, causal, chunk)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, qp = q.device_mesh, tuple(q.placements)
    if any(not (isinstance(p, Replicate) or p in (Shard(0), Shard(2))) for p in qp):
        raise ValueError(f"attention inputs must be sharded on batch and heads only, got {qp}")
    pp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in qp)
    pos = [x if isinstance(x, DTensor) else
           DTensor.from_local(x, mesh, [Replicate()] * len(qp), run_check=False)
           for x in (positions_q, positions_k)]
    run = local_map(locally(_chunked_attention), out_placements=(qp,),
                    in_placements=(qp, qp, qp, pp, pp, None, None),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v, *pos, causal, chunk)


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

    # Megatron-SP: all-gather the sequence-sharded residual once at
    # attention entry; k/v below then derive seq-gathered.
    x = logical(x, "batch", None, "embed")
    q = torch.einsum("bsd,dhk->bshk", x, gathered(p["wq"]).to(x.dtype))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
    q = logical(q, "batch", None, "heads", None)

    if cross_kv is not None:
        k, v = cross_kv
        pos_k = torch.arange(k.shape[1], device=k.device)[None].expand(k.shape[:2])
        k = _expand_kv(k, H)
        v = _expand_kv(v, H)
        out = _attention_local(q, k, v, positions, pos_k, False, cfg.attn_chunk)
        new_cache = cache
    elif cache is None:
        k = torch.einsum("bsd,dhk->bshk", x, gathered(p["wk"]).to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, gathered(p["wv"]).to(x.dtype))
        if use_rope:
            k = rope(k, positions, cfg.rope_theta)
        k = logical(_expand_kv(k, H), "batch", None, "heads", None)
        v = logical(_expand_kv(v, H), "batch", None, "heads", None)
        out = _attention_local(q, k, v, positions, positions, causal,
                               cfg.attn_chunk)
        new_cache = None
    else:
        # --- single-token decode against the KV cache ---------------------
        k_new = torch.einsum("bsd,dhk->bshk", x, gathered(p["wk"]).to(x.dtype))
        v_new = torch.einsum("bsd,dhk->bshk", x, gathered(p["wv"]).to(x.dtype))
        if use_rope:
            k_new = rope(k_new, positions, cfg.rope_theta)
        kc, vc, pos = cache["k"], cache["v"], cache["pos"]
        Sk = kc.shape[1]
        slot = pos.clamp(0, Sk - 1).reshape(1).long()
        _write_slot(kc, slot, k_new)
        _write_slot(vc, slot, v_new)
        kc = logical(kc, "batch", "kv_seq", None, None)
        vc = logical(vc, "batch", "kv_seq", None, None)
        g = H // KVH
        # the GQA split of the query heads: on a mesh they are gathered
        # first, since KV heads need not divide `model` (8 on 16)
        qg = logical(q, "batch", None, None, None).reshape(B, 1, KVH, g, hd)
        scores = torch.einsum("bqhgd,bkhd->bhgk", qg.float(), kc.float()) / math.sqrt(hd)
        mask = torch.arange(Sk, device=kc.device) <= pos        # valid prefix
        scores = torch.where(mask, scores, NEG_INF)
        pr = torch.softmax(scores, dim=-1)
        outg = torch.einsum("bhgk,bkhd->bhgd", pr, vc.float())
        out = outg.reshape(B, 1, H, hd).to(x.dtype)
        new_cache = {"k": kc, "v": vc, "pos": pos + 1}

    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"].to(x.dtype))
    return logical(y, "batch", "seq", "embed"), new_cache


def _write_slot(cache, slot, new) -> None:
    """``cache[:, slot] = new`` in place (``slot``: a (1,) long tensor).

    On a mesh the write is shard-local, as JAX's ``dynamic_update_slice``
    into the kv_seq-sharded cache is: every rank writes its own shard, the
    slot's row where its kv_seq range holds the slot and its old row back
    elsewhere, so no rank gathers the cache (DTensor's own ``index_copy_``
    would replicate it)."""
    from torch.distributed.tensor import DTensor

    if not (on_mesh() and isinstance(cache, DTensor)):
        cache.index_copy_(1, slot, new.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    loc = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    new = new.redistribute(mesh, [Replicate() if p == Shard(1) else p for p in pl])
    if isinstance(slot, DTensor):
        slot = slot.full_tensor()
    idx = slot - offset[1]
    inside = ((idx >= 0) & (idx < loc.shape[1])).reshape(1, 1, 1, 1)
    idx = idx.clamp(0, loc.shape[1] - 1)
    row = torch.where(inside, new.to_local().to(loc.dtype), loc.index_select(1, idx))
    loc.index_copy_(1, idx, row)


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
    # Megatron-SP: the sequence-sharded residual is gathered once at the
    # block's entry, as at attention's (some DTensor versions refuse the
    # einsums' flatten of a sharded sequence)
    x = logical(x, "batch", None, "embed")
    if cfg.mlp_act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))
        u = torch.einsum("bsd,df->bsf", x, p["wu"].to(x.dtype))
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype)),
                   approximate="tanh")
    h = logical(h, "batch", None, "mlp")
    y = torch.einsum("bsf,fd->bsd", h, p["wd"].to(x.dtype))
    return logical(y, "batch", "seq", "embed")


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
    # On a mesh of several ranks: the FSDP-sharded table gathered first, as
    # FSDP does, the ids sharded like the batch, and the lookup as
    # F.embedding, whose backward DTensor shards (some versions' index_put
    # backward refuses the row shards); elsewhere the index, whose
    # gradient JAX's take matches bit for bit.
    table = gathered(p["tok_embed"])
    if multi_rank(table):
        h = F.embedding(logical(tokens.long(), "batch", None), table)
    else:
        h = table[tokens.long()]
    return logical(h.to(dtype), "batch", "seq", "embed")


def lm_logits(p, h, cfg):
    h = rmsnorm(h, p["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, p["lm_head"].to(h.dtype))
    return logical(logits, "batch", None, "vocab")


def chunked_xent(p, h, labels, cfg, chunk: int = 512):
    """Mean next-token CE without materializing (B,S,V) at once.

    h is pre-final-norm hidden states; labels are already shifted.  On a
    mesh of several ranks the label's logit is picked by JAX's one-hot sum
    (over vocab-sharded logits a partial sum per shard, then one
    reduction), and the log-sum-exp from a max and a sum, which DTensor
    reduces without gathering the logits: elementwise ops, where DTensor's
    ``gather`` backward builds a zero tensor of the global batch.
    Elsewhere by ``gather`` and ``torch.logsumexp``, which give the same
    values without the (B, chunk, V) mask.  On a mesh the sequence-sharded
    ``hn`` is gathered once, not once per chunk, and the labels take the
    activations' batch sharding.
    """
    B, S, D = h.shape
    chunk = _even_chunk(S, chunk)
    hn = rmsnorm(h, p["final_norm"], cfg.norm_eps)
    if on_mesh():
        hn = logical(hn, "batch", None, "embed")
        labels = logical(labels, "batch", None)

    def one(hc, lc):
        logits = torch.einsum("bsd,dv->bsv", hc, p["lm_head"].to(hc.dtype))
        logits = logical(logits, "batch", None, "vocab").float()
        if multi_rank(logits):
            m = torch.amax(logits, dim=-1, keepdim=True).detach()
            lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
            vocab = torch.arange(logits.shape[-1], device=lc.device)
            ll = torch.sum(torch.where(vocab == lc[..., None], logits, 0.0), dim=-1)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return torch.sum(lse - ll)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        total = total + remat(one, True, hn[:, i:i + chunk], labels[:, i:i + chunk])
    return total / (B * S)
