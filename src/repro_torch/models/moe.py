"""Mixture-of-Experts layer of the port (the counterpart of
``repro.models.moe``): top-k routing with capacity.

t5x/mesh-style dispatch: tokens are grouped by batch row; within each group
every expert accepts at most ``capacity`` tokens.  Dispatch/combine are
one-hot einsums; dropped tokens (over capacity) fall through on the
residual.  Load-balancing auxiliary loss follows Switch/OLMoE:
aux = E * sum_e f_e * p_e.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.base import ParamDef
from repro_torch.parallel.sharding import locally, logical, on_mesh


def moe_defs(cfg, L: int) -> Dict[str, ParamDef]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    return {
        "router": ParamDef(lead + (D, E), la + ("w_embed", None), scale=0.1),
        "wg": ParamDef(lead + (E, D, Fd), la + ("experts", "w_embed", "expert_mlp")),
        "wu": ParamDef(lead + (E, D, Fd), la + ("experts", "w_embed", "expert_mlp")),
        "wd": ParamDef(lead + (E, Fd, D), la + ("experts", "expert_mlp", "w_embed")),
    }


def moe_mlp(p, x, cfg):
    """x: (B, S, D) -> (B, S, D), plus scalar aux loss.

    ``cfg.moe_group > 0`` routes within sequence groups of that size
    (t5x-style): capacity shrinks linearly with group size."""
    B, S, D = x.shape
    x = logical(x, "batch", None, "embed")   # Megatron-SP, as at attention's entry
    g = getattr(cfg, "moe_group", 0) or 0
    if g and g < S and S % g == 0:
        yg, aux = _moe_mlp_grouped(p, x.reshape(B * (S // g), g, D), cfg)
        return yg.reshape(B, S, D), aux
    return _moe_mlp_grouped(p, x, cfg)


def top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _combine_einsum(eout, combine):
    return torch.einsum("ebcd,bsec->bsd", eout, combine)


def _combine(eout, combine):
    """sum over (expert, slot) of eout (E,B,C,D) x combine (B,S,E,C).

    On a mesh each rank contracts its own experts of its own rows
    (``local_map``), the sum over the expert shards left partial: the
    contraction never flattens the sharded expert dim, which some DTensor
    versions refuse to view.  Off a mesh it is the einsum itself."""
    if not on_mesh():
        return _combine_einsum(eout, combine)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    cp = tuple(combine.placements)
    if any(not (isinstance(p, Replicate) or p in (Shard(0), Shard(2))) for p in cp):
        raise ValueError(f"combine must be sharded on batch and experts only, got {cp}")
    ep = tuple(Shard(1) if p == Shard(0) else Shard(0) if p == Shard(2) else p for p in cp)
    yp = tuple(Partial() if p == Shard(2) else p for p in cp)
    run = local_map(locally(_combine_einsum), out_placements=(yp,),
                    in_placements=(ep, cp), device_mesh=combine.device_mesh,
                    redistribute_inputs=True)
    return run(eout, combine)


def _moe_mlp_grouped(p, x, cfg):
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    cap = max(1, int(cfg.moe.capacity_factor * S * K / E))

    gate_logits = torch.einsum("bsd,de->bse", x, p["router"].to(x.dtype)).float()
    probs = torch.softmax(gate_logits, dim=-1)              # (B,S,E)

    topk_p, topk_i = top_k(probs, K)                        # (B,S,K)
    topk_p = topk_p / torch.sum(topk_p, dim=-1, keepdim=True)

    # position of each (token, k) inside its expert's buffer
    onehot = (topk_i[..., None]
              == torch.arange(E, device=x.device)).float()  # (B,S,K,E)
    flat = onehot.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)   # slots before me
    within = (pos < cap) * onehot                           # keep-mask
    slot = torch.einsum("bske,bske->bsk", pos, onehot)      # my slot id

    # dispatch tensor (B, S, E, cap): 1 where token s -> expert e slot c.
    # jax.nn.one_hot gives a zero row for a slot >= cap (a dropped token);
    # F.one_hot would raise, so the mask is a comparison with arange(cap).
    slot_oh = (slot.long()[..., None]
               == torch.arange(cap, device=x.device)).float()   # (B,S,K,cap)
    dispatch = torch.einsum("bske,bskc->bsec", within, slot_oh).to(x.dtype)
    combine = torch.einsum("bsk,bske,bskc->bsec", topk_p, within,
                           slot_oh).to(x.dtype)
    dispatch = logical(dispatch, "batch", None, "experts", None)
    combine = logical(combine, "batch", None, "experts", None)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    xin = logical(xin, "experts", "batch", None, None)
    g = torch.einsum("ebcd,edf->ebcf", xin, p["wg"].to(x.dtype))
    u = torch.einsum("ebcd,edf->ebcf", xin, p["wu"].to(x.dtype))
    h = F.silu(g) * u
    eout = torch.einsum("ebcf,efd->ebcd", h, p["wd"].to(x.dtype))
    eout = logical(eout, "experts", "batch", None, None)
    y = _combine(eout, combine)

    # Switch-style load balance aux
    density = torch.mean(onehot.sum(2), dim=(0, 1))         # fraction routed
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(density / K * mean_prob)
    return logical(y, "batch", "seq", "embed"), aux
