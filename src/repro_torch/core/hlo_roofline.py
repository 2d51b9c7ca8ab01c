"""Generalized 3-term roofline of one rank's program (the counterpart of
``repro.core.hlo_roofline``, which reads compiled XLA artifacts).

For each (arch x shape x mesh) cell the port's dry run (``launch.dryrun``)
counts one rank's aten ops (``core.hlo_cost.analyze_program``) and derives

    compute term    = FLOPs            / (peak FLOP/s per card)
    memory term     = bytes            / (HBM bytes/s per card)
    collective term = collective bytes / (NVLink bytes/s per card)

The ``MODEL_FLOPS / FLOPs`` ratio is the paper's S/alpha "useful fraction"
generalized to arbitrary programs: remat recompute, padding and dispatch
overhead all surface as redundancy.

The constants are NVIDIA's H100 SXM data sheet (dense, no sparsity, at the
700 W limit), where JAX's module has TPU v5e's.  No HLO text exists here, so
JAX's ``parse_collective_bytes`` has no counterpart: the collective dict
comes from the counter's ``coll`` and ``coll_counts``
(:func:`collective_dict`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.hlo_cost import COLLECTIVES, ProgramCost

# H100 SXM per-card constants (data sheet)
PEAK_FLOPS = 989e12          # bf16 dense, data sheet
HBM_BW = 3.35e12             # bytes/s, HBM3, data sheet
NVLINK_BW = 450e9            # bytes/s per direction, NVLink 4, data sheet


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-rank FLOPs
    hbm_bytes: float             # per-rank bytes accessed
    collective_bytes: float      # per-rank collective payload
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None
    useful_fraction: Optional[float] = None   # MODEL_FLOPS / FLOPs

    def as_dict(self):
        return dataclasses.asdict(self)


def collective_dict(cost: ProgramCost) -> Dict[str, float]:
    """JAX's collective dict: payload bytes and counts by kind
    (``all-gather``, ..., ``n_all-gather``, ...)."""
    out = {k: cost.coll.get(k, 0) for k in COLLECTIVES}
    counts = {f"n_{k}": cost.coll_counts.get(k, 0) for k in COLLECTIVES}
    return {**out, **counts}


def roofline_from_cost(cost: ProgramCost, model_flops: Optional[float] = None,
                       n_chips: int = 1) -> RooflineTerms:
    """model_flops: whole-program useful FLOPs (e.g. 6*N*D*tokens); divided
    by n_chips to compare against the per-rank FLOPs.  The memory term reads
    ``bytes_major``, eager torch's own traffic (every op reads its operands
    and writes its result)."""
    flops = cost.flops
    byts = cost.bytes_major
    cbytes = cost.collective_bytes
    terms = RooflineTerms(
        flops=flops,
        hbm_bytes=byts,
        collective_bytes=cbytes,
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=cbytes / NVLINK_BW,
        bottleneck="",
        model_flops=model_flops,
    )
    tmap = {"compute": terms.compute_s, "memory": terms.memory_s,
            "collective": terms.collective_s}
    terms.bottleneck = max(tmap, key=tmap.get)
    if model_flops is not None and flops > 0:
        terms.useful_fraction = (model_flops / n_chips) / flops
    return terms


def model_flops_for(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) per step, where D =
    tokens processed.  Decode cells process one token per sequence."""
    from repro_torch.models.api import get_model
    n = get_model(cfg).param_count()
    if cfg.moe is not None:
        # subtract inactive expert params: experts contribute top_k/E of
        # their weights per token
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        expert_params = 3 * cfg.d_model * cfg.d_ff * e * cfg.n_layers
        n = n - expert_params + expert_params * (k / e)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    tokens = cell.global_batch            # one new token per sequence
    return 2.0 * n * tokens
