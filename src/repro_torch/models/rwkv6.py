"""RWKV-6 ("Finch") block of the port (the counterpart of
``repro.models.rwkv6``): time-mix with data-dependent per-channel decay,
plus channel-mix.  Attention-free; O(1) decode state.

Time-mix recurrence (per head, K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
with w_t = exp(-exp(wx_t)) data-dependent (projected from x).  Training
and prefill use a chunked form whose pairwise decay factors are exp of
non-positive sums; decode is the one-token recurrence.

Simplification vs full RWKV-6, as in JAX: static token-shift lerp
coefficients, no GroupNorm (RMSNorm).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamDef
from repro_torch.models.layers import rmsnorm
from repro_torch.parallel.sharding import gathered, locally, logical, on_mesh

#: ``jnp.log(4.0)`` in float32: the decay clamp's top under ``wkv_factored``.
_LOG4_F32 = float(torch.tensor(math.log(4.0), dtype=torch.float32))


def rwkv_dims(cfg):
    hd = cfg.d_model // cfg.n_heads
    return cfg.n_heads, hd


def timemix_defs(cfg, L: int) -> Dict[str, ParamDef]:
    D = cfg.d_model
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    return {
        "mix": ParamDef(lead + (5, D), la + (None, "w_embed"), init="zeros"),
        "wr": ParamDef(lead + (D, D), la + ("w_embed", "mlp")),
        "wk": ParamDef(lead + (D, D), la + ("w_embed", "mlp")),
        "wv": ParamDef(lead + (D, D), la + ("w_embed", "mlp")),
        "wg": ParamDef(lead + (D, D), la + ("w_embed", "mlp")),
        "ww": ParamDef(lead + (D, D), la + ("w_embed", "mlp"), scale=0.1),
        "w_bias": ParamDef(lead + (D,), la + ("w_embed",), init="zeros"),
        "u": ParamDef(lead + (D,), la + ("w_embed",), init="zeros"),
        "wo": ParamDef(lead + (D, D), la + ("mlp", "w_embed")),
        "ln_w": ParamDef(lead + (D,), la + (None,), init="ones"),
    }


def chanmix_defs(cfg, L: int) -> Dict[str, ParamDef]:
    D, Fd = cfg.d_model, cfg.d_ff
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    return {
        "mix": ParamDef(lead + (2, D), la + (None, "w_embed"), init="zeros"),
        "wk": ParamDef(lead + (D, Fd), la + ("w_embed", "mlp")),
        "wv": ParamDef(lead + (Fd, D), la + ("mlp", "w_embed")),
        "wr": ParamDef(lead + (D, D), la + ("w_embed", "mlp")),
    }


def _token_shift(x, last):
    """x_{t-1} stream; ``last`` (B,1,D) carries state across decode steps."""
    if x.shape[1] == 1:
        return last
    return torch.cat([last, x[:, :-1]], dim=1)


def _lerp(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def _chunks(a, nchunks: int, chunk: int):
    """(B,S,H,d) -> nchunks slices of (B,chunk,H,d); S must split evenly,
    as JAX's reshape requires."""
    if nchunks * chunk != a.shape[1]:
        raise ValueError(f"cannot split {a.shape[1]} positions into {nchunks} "
                         f"chunks of {chunk}")
    return [a[:, i * chunk:(i + 1) * chunk] for i in range(nchunks)]


def wkv_chunked(r, k, v, lw, u, state, chunk: int = 32):
    """Chunked WKV-6.  r,k,v: (B,S,H,K); lw = log w_t (<=0): (B,S,H,K).

    state: (B,H,K,V) f32.  Returns (y, new_state).  All pairwise decay
    factors are exp() of non-positive sums -- numerically safe for any w.
    """
    B, S, H, K = r.shape
    nchunks = max(1, S // chunk)
    chunk = S // nchunks
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)

    def _chunked(a):
        return [logical(c, "batch", None, "heads", None) for c in _chunks(a, nchunks, chunk)]

    st, ys = state, []
    for rc, kc, vc, lc in zip(*(_chunked(a) for a in (r, k, v, lw))):
        cum = torch.cumsum(lc, dim=1)                        # (B,C,H,K) inclusive
        cum_prev = cum - lc
        dmat = cum_prev[:, :, None] - cum[:, None, :]        # (B,Ci,Cj,H,K)
        dec = torch.exp(torch.where(causal[None, :, :, None, None], dmat, -math.inf))
        scores = torch.einsum("bihk,bijhk,bjhk->bhij", rc, dec, kc)
        y = torch.einsum("bhij,bjhv->bihv", scores, vc)
        bonus = torch.einsum("bihk,hk,bihk->bih", rc, u, kc)
        y = y + bonus[..., None] * vc
        y = y + torch.einsum("bihk,bhkv->bihv", rc * torch.exp(cum_prev), st)
        dec_out = torch.exp(cum[:, -1:] - cum)               # (B,C,H,K)
        st = (torch.exp(cum[:, -1])[..., None] * st
              + torch.einsum("bjhk,bjhv->bhkv", kc * dec_out, vc))
        ys.append(y)
    return torch.cat(ys, dim=1), st


def wkv_chunked_factored(r, k, v, lw, u, state, chunk: int = 16):
    """Factored intra-chunk decay (no (C,C,K) tensor):

    scores_ij = sum_k [r_ik e^{cumprev_ik}] [k_jk e^{-cum_jk}]  (j<i masked)

    The e^{-cum} factor grows with in-chunk position, so safety requires
    chunk * max|log w| <= ~64: callers clamp lw to [-4, 0] and keep
    chunk <= 16 (enforced here)."""
    B, S, H, K = r.shape
    if chunk * 4.0 > 66:
        raise ValueError("factored WKV needs chunk*clamp <= ~64")
    nchunks = max(1, S // chunk)
    chunk = S // nchunks
    causal = torch.tril(torch.ones((chunk, chunk), dtype=r.dtype, device=r.device), -1)

    def _chunked(a):
        return [logical(c, "batch", None, "heads", None) for c in _chunks(a, nchunks, chunk)]

    st, ys = state, []
    for rc, kc, vc, lc in zip(*(_chunked(a) for a in (r, k, v, lw))):
        cum = torch.cumsum(lc, dim=1)
        cum_prev = cum - lc
        r_ = rc * torch.exp(cum_prev)                        # <= |r|
        k_ = kc * torch.exp(-cum)                            # <= |k| e^{64}
        scores = torch.einsum("bihk,bjhk->bhij", r_, k_) * causal[None, None]
        y = torch.einsum("bhij,bjhv->bihv", scores, vc)
        bonus = torch.einsum("bihk,hk,bihk->bih", rc, u, kc)
        y = y + bonus[..., None] * vc
        y = y + torch.einsum("bihk,bhkv->bihv", r_, st)
        dec_out = torch.exp(cum[:, -1:] - cum)
        st = (torch.exp(cum[:, -1])[..., None] * st
              + torch.einsum("bjhk,bjhv->bhkv", kc * dec_out, vc))
        ys.append(y)
    return torch.cat(ys, dim=1), st


def _wkv_local(fn, r, k, v, lw, u, state, chunk):
    """``fn(r, k, v, lw, u, state, chunk)`` on this rank's shards.

    The WKV scan is independent per (batch row, head), so on a mesh it runs
    on the local shards (``local_map``): the chunk loop is a loop over
    plain tensors, not hundreds of DTensor dispatches per layer.  r, k, v
    and lw come constrained to (batch, *, heads, *); u and the state follow
    their head and batch sharding, y is placed like r and the new state
    like the old.  Off a mesh it is ``fn`` itself."""
    if not on_mesh():
        return fn(r, k, v, lw, u, state, chunk)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rp = tuple(r.placements)
    if not isinstance(state, DTensor):     # the zero state: every rank's alike
        state = DTensor.from_local(state, r.device_mesh, [Replicate()] * len(rp),
                                   run_check=False)
    if any(not (isinstance(p, Replicate) or p in (Shard(0), Shard(2))) for p in rp):
        raise ValueError(f"WKV inputs must be sharded on batch and heads only, got {rp}")
    up = tuple(Shard(0) if p == Shard(2) else Replicate() for p in rp)
    sp = tuple(Shard(1) if p == Shard(2) else p for p in rp)
    # u's gradient sums over the batch shards; the others' are local
    ug = tuple(Partial() if p == Shard(0) else q for p, q in zip(rp, up))
    run = local_map(locally(fn), out_placements=(rp, sp),
                    in_placements=(rp, rp, rp, rp, up, sp, None),
                    in_grad_placements=(rp, rp, rp, rp, ug, sp, None),
                    device_mesh=r.device_mesh, redistribute_inputs=True)
    return run(r, k, v, lw, u, state, chunk)


def wkv_step(r, k, v, lw, u, state):
    """One-token WKV (B,1,H,K).  y_t = r.(S + u*k v);  S' = w*S + k v."""
    kv = torch.einsum("bhk,bhv->bhkv", k[:, 0], v[:, 0])
    y = torch.einsum("bhk,bhkv->bhv", r[:, 0], state + u[None, :, :, None] * kv)
    st = torch.exp(lw[:, 0])[..., None] * state + kv
    return y[:, None], st


def time_mix(p, x, cfg, last, state, chunk: int = 32):
    """RWKV-6 attention substitute.  Returns (y, (last_x, wkv_state))."""
    B, S, D = x.shape
    H, hd = rwkv_dims(cfg)
    # Megatron-SP: the sequence-sharded residual is gathered once at the
    # block's entry, as at attention's (some DTensor versions refuse the
    # einsums' flatten of a sharded sequence)
    x = logical(x, "batch", None, "embed")
    prev = _token_shift(x, last)
    mu = p["mix"].float()
    xr, xk, xv, xw, xg = (_lerp(x, prev, mu[i]) for i in range(5))

    r = torch.einsum("bsd,de->bse", xr, p["wr"].to(x.dtype))
    k = torch.einsum("bsd,de->bse", xk, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,de->bse", xv, p["wv"].to(x.dtype))
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["wg"].to(x.dtype)))
    # data-dependent decay; the clamp keeps exp(-exp(.)) in a sane range;
    # factored mode needs |log w| <= 4 (see wkv_chunked_factored)
    wx = torch.einsum("bsd,de->bse", xw, p["ww"].to(x.dtype))
    wx = wx.float() + p["w_bias"].float()
    hi = _LOG4_F32 if getattr(cfg, "wkv_factored", False) else 1.0
    lw = -torch.exp(torch.clamp(wx, -8.0, hi))               # log w_t in [-4,0)
    lw = torch.clamp(lw, min=-4.0)

    # Head-sharding constraints: after the S -> chunks split the WKV math
    # stays local per head shard.
    def _heads(a):
        return logical(a.reshape(B, S, H, hd), "batch", None, "heads", None)

    rh = _heads(r.float())
    kh = _heads(k.float())
    vh = _heads(v.float())
    lwh = _heads(lw)
    u = gathered(p["u"]).float().reshape(H, hd)

    if S == 1 and state is not None:
        y, st = wkv_step(rh, kh, vh, lwh, u, state)
    else:
        st0 = state if state is not None else torch.zeros(
            (B, H, hd, hd), dtype=torch.float32, device=x.device)
        if getattr(cfg, "wkv_factored", False):
            y, st = _wkv_local(wkv_chunked_factored, rh, kh, vh, lwh, u, st0,
                               min(chunk, 16))
        else:
            y, st = _wkv_local(wkv_chunked, rh, kh, vh, lwh, u, st0, chunk)

    y = y.reshape(B, S, D).to(x.dtype)
    y = rmsnorm(y, p["ln_w"], cfg.norm_eps) * g
    out = torch.einsum("bse,ed->bsd", y, p["wo"].to(x.dtype))
    return logical(out, "batch", "seq", "embed"), (x[:, -1:], st)


def channel_mix(p, x, cfg, last):
    x = logical(x, "batch", None, "embed")   # Megatron-SP, as in time_mix
    prev = _token_shift(x, last)
    mu = p["mix"].float()
    xk = _lerp(x, prev, mu[0])
    xr = _lerp(x, prev, mu[1])
    k = torch.einsum("bsd,df->bsf", xk, p["wk"].to(x.dtype))
    kv = torch.einsum("bsf,fd->bsd", torch.square(F.relu(k)), p["wv"].to(x.dtype))
    rgate = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["wr"].to(x.dtype)))
    return logical(rgate * kv, "batch", "seq", "embed"), x[:, -1:]
