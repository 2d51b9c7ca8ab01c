"""Hand-written Hopper kernels for the stencil hot paths (tap-sum on the
CUDA cores, banded contraction on the tensor cores) and the plan API over
them: the PyTorch counterpart of ``repro.kernels``.

``stencil_plan`` compiles the paper's decision procedure into a reusable
``StencilPlan``; ``stencil_apply`` is the one-shot wrapper over it;
backends register through ``repro_torch.kernels.registry``;
``guarded_stencil_plan`` wraps a plan in the guarded execution layer
(failure taxonomy and degradation ladder)."""
from .ops import stencil_apply, explain
from .plan import (StencilPlan, stencil_plan, spec_from_weights,
                   plan_cache_stats, plan_cache_max, clear_plan_cache)
from .registry import (register_backend, unregister_backend,
                       registered_backends, get_backend, fallback_ladder)
from .guard import (DeviceFaultError, GuardedExecutionError, GuardedPlan,
                    HaloExchangeError, KernelCompileError,
                    NumericalFaultError, PlanBuildError, VmemOverflowError,
                    classify_failure, guarded_stencil_plan)
from .stencil_direct import stencil_direct
from .stencil_matmul import (stencil_matmul, build_bands, build_bands_nd,
                             band_sparsity)
from .stencil_sparse import (stencil_sparse_matmul, compact_bands,
                             kept_row_fraction)
from .common import (SubstrateGeom, choose_hblock, pricing_geom,
                     resolve_tile_geom, smem_budget_bytes,
                     substrate_read_amp)
from ._build import (build_all, cluster_ctas, launch_counts, launch_tiles,
                     reset_launch_counts)


def __getattr__(name):
    # Delegates to ops.__getattr__: BACKENDS is computed on access so
    # late-registered plug-in backends show up.
    if name == "BACKENDS":
        from . import ops
        return ops.BACKENDS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
