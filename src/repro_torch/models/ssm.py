"""Mamba2-style selective SSM block of the port (the counterpart of
``repro.models.ssm``): SSD with scalar-per-head decay, chunked.

The full-sequence path is the chunked (SSD) algorithm: within a chunk the
contribution matrix is dense einsums; across chunks a loop carries the
(B, H, hd, N) state.  Decode is the O(1) recurrence step.

Simplifications vs the full Mamba2, as in JAX: single B/C group, conv only
on the x-branch, no RMSNorm-in-block variants.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamDef
from repro_torch.parallel.sharding import logical


def ssm_dims(cfg):
    d_inner = cfg.ssm.expand * cfg.d_model
    hd = cfg.ssm.head_dim
    nheads = d_inner // hd
    return d_inner, nheads, hd, cfg.ssm.state_dim


def ssm_defs(cfg, L: int) -> Dict[str, ParamDef]:
    D = cfg.d_model
    d_inner, H, hd, N = ssm_dims(cfg)
    cw = cfg.ssm.conv_width
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    return {
        # fused in-projection: [z, x, B, C, dt]
        "w_in": ParamDef(lead + (D, 2 * d_inner + 2 * N + H),
                         la + ("w_embed", "mlp")),
        "conv": ParamDef(lead + (cw, d_inner), la + ("conv", "mlp"),
                         init="normal", scale=0.5),
        "A_log": ParamDef(lead + (H,), la + ("heads",), init="zeros"),
        "dt_bias": ParamDef(lead + (H,), la + ("heads",), init="zeros"),
        "Dskip": ParamDef(lead + (H,), la + ("heads",), init="ones"),
        "w_out": ParamDef(lead + (d_inner, D), la + ("mlp", "w_embed")),
    }


def _split_proj(proj, cfg):
    """[z, x, B, C, dt] by split points (``jnp.split`` takes indices, as
    ``tensor_split`` does; ``torch.split`` would take sizes)."""
    d_inner, H, hd, N = ssm_dims(cfg)
    return torch.tensor_split(
        proj, [d_inner, 2 * d_inner, 2 * d_inner + N, 2 * d_inner + 2 * N], dim=-1)


def _causal_conv(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq.  x:(B,S,C), w:(cw,C).

    state (B, cw-1, C) carries the left context for decode; returns
    (y, new_state) with the new state in x's dtype."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(w[i].to(x.dtype) * xp[:, i: i + x.shape[1]] for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else None
    return y, new_state


def _segsum(lw):
    """lw: (..., C) log-decays -> (..., C, C) lower-tri pairwise sums.

    out[i, j] = sum_{s=j+1..i} lw[s]  (j < i),  0 on diagonal, -inf above.
    """
    C = lw.shape[-1]
    cs = torch.cumsum(lw, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]      # cum[i] - cum[j]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=lw.device), 0)
    return torch.where(mask, diff, -math.inf)


def ssm_scan_chunked(xh, b, c, dt, A, state, chunk: int = 64):
    """Chunked SSD.  xh:(B,S,H,hd)  b,c:(B,S,N)  dt:(B,S,H)  A:(H,) < 0.

    state: (B,H,hd,N) carried across chunks.  Returns (y, final_state).
    """
    B, S, H, hd = xh.shape
    nchunks = max(1, S // chunk)
    chunk = S // nchunks
    if nchunks * chunk != S:
        raise ValueError(f"cannot split {S} positions into {nchunks} chunks of {chunk}")

    lw = (dt * A[None, None, :]).float()                    # log-decay (B,S,H)
    xdt = xh * dt[..., None].to(xh.dtype)                   # dt-weighted input

    st, ys = state.float(), []
    for i in range(nchunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        xc_, bc_, cc_, lwc_ = xdt[:, sl].float(), b[:, sl].float(), c[:, sl].float(), lw[:, sl]
        lwt = torch.movedim(lwc_, 1, -1)                    # (B,H,C)
        decay = torch.exp(_segsum(lwt))                     # (B,H,C,C)
        # intra-chunk: scores_ij = (c_i . b_j) * decay_ij   (causal incl diag)
        g = torch.einsum("bin,bjn->bij", cc_, bc_)          # (B,C,C)
        y_intra = torch.einsum("bhij,bjhd->bihd", g[:, None] * decay, xc_)
        # inter-chunk: y_i += c_i . (decay_to_i * state)
        cum = torch.cumsum(lwt, dim=-1)                     # (B,H,C)
        y_inter = torch.einsum("bin,bhdn,bhi->bihd", cc_, st, torch.exp(cum))
        # state update: st' = exp(cum_C) st + sum_j exp(cum_C - cum_j) b_j x_j
        dec_out = torch.exp(cum[..., -1:] - cum)            # (B,H,C)
        st = torch.exp(cum[..., -1])[..., None, None] * st + torch.einsum(
            "bjn,bjhd,bhj->bhdn", bc_, xc_, dec_out)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1).to(xh.dtype), st


def ssm_step(xh, b, c, dt, A, state):
    """O(1) decode step.  xh:(B,1,H,hd) -> (y, new_state)."""
    lw = (dt[:, 0] * A[None, :]).float()                    # (B,H)
    a = torch.exp(lw)[..., None, None]                      # (B,H,1,1)
    upd = torch.einsum("bn,bhd->bhdn", b[:, 0].float(),
                       (xh[:, 0] * dt[:, 0, :, None]).float())
    st = a * state + upd
    y = torch.einsum("bn,bhdn->bhd", c[:, 0].float(), st)
    return y[:, None].to(xh.dtype), st


def mamba_block(p, x, cfg, state=None, conv_state=None, chunk: int = 64):
    """Full Mamba2 block.  state None => chunked full-sequence path.

    Returns (y, (ssm_state, conv_state)).
    """
    B, S, D = x.shape
    d_inner, H, hd, N = ssm_dims(cfg)
    # Megatron-SP: the sequence-sharded residual is gathered once at the
    # block's entry, as at attention's (some DTensor versions refuse the
    # einsums' flatten of a sharded sequence)
    x = logical(x, "batch", None, "embed")
    proj = torch.einsum("bsd,dp->bsp", x, p["w_in"].to(x.dtype))
    z, xc, b, c, dt_raw = _split_proj(proj, cfg)
    xc, conv_state = _causal_conv(xc, p["conv"], conv_state)
    xc = F.silu(xc)
    xc = logical(xc, "batch", None, "mlp")
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(p["A_log"].float())                      # (H,) < 0
    xh = xc.reshape(B, S, H, hd)
    if state is None:
        state0 = torch.zeros((B, H, hd, N), dtype=torch.float32, device=x.device)
        y, new_state = ssm_scan_chunked(xh, b, c, dt, A, state0, chunk)
    else:
        y, new_state = ssm_step(xh, b, c, dt, A, state)
    y = y + p["Dskip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner) * F.silu(z)
    out = torch.einsum("bsp,pd->bsd", y, p["w_out"].to(x.dtype))
    return logical(out, "batch", "seq", "embed"), (new_state, conv_state)


def init_ssm_cache(cfg, batch: int, device=None):
    d_inner, H, hd, N = ssm_dims(cfg)
    cw = cfg.ssm.conv_width
    return {
        "ssm": torch.zeros((batch, H, hd, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cw - 1, d_inner), dtype=torch.float32, device=device),
    }
