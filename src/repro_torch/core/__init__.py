"""The enhanced roofline model, criteria and selector (the counterpart of
``repro.core``), with the H100 data-sheet spec as the default hardware."""
from .perfmodel import (
    HardwareSpec,
    StencilWorkload,
    UnitPerf,
    Comparison,
    Scenario,
    Bound,
    A100_DOUBLE,
    A100_FLOAT,
    H100_SXM_DATASHEET,
    TPU_V5E_BF16,
    compare,
    perf_vector,
    perf_matrix,
    perf_matrix_reuse,
    perf_sparse_matrix,
    halo_recompute_factor,
    sparsity_banded,
    sparsity_convstencil,
    sparsity_spider,
)
from .selector import Decision, select_backend, classify_problem, transition_depth
