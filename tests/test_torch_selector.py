"""The port's performance model and selector against the JAX package's:
same backend, scenario and reason, candidates within 1e-12 relative, for
the A100 and TPU specs both packages carry."""
import inspect
import math

import pytest

pytest.importorskip("jax")

from repro.core import perfmodel as jpm  # noqa: E402
from repro.core import selector as jsel  # noqa: E402
from repro.stencil.spec import StencilSpec as JSpec  # noqa: E402
from repro_torch.core import perfmodel as tpm  # noqa: E402
from repro_torch.core import selector as tsel  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.stencil.spec import StencilSpec as TSpec  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

HW = ["A100_DOUBLE", "A100_FLOAT", "TPU_V5E_BF16", "TPU_V5E_INT8_CEILING"]
GEOMS = [
    {},                                                   # pricing defaults
    dict(strip_m=64),
    dict(strip_m=100, h_block=7),                         # non-dividing h_block
    dict(strip_m=64, h_block=8, w_tile=64, w_block=8),    # a port-style tile
    dict(strip_m=48, h_block=12, w_tile=32, w_block=12),
    dict(strip_m=128, tile_n=16),
]


def assert_same_decision(a, b):
    assert a.backend == b.backend
    assert a.scenario.name == b.scenario.name
    assert a.reason == b.reason
    assert a.candidates.keys() == b.candidates.keys()
    for k in a.candidates:
        assert math.isclose(a.candidates[k], b.candidates[k], rel_tol=1e-12)
    assert math.isclose(a.predicted_speedup, b.predicted_speedup,
                        rel_tol=1e-12)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_select_backend_parity(hw, shape, r, t):
    jhw, thw = getattr(jpm, hw), getattr(tpm, hw)
    assert (jhw.p_vector, jhw.p_matrix, jhw.bandwidth, jhw.p_sparse) == \
        (thw.p_vector, thw.p_matrix, thw.bandwidth, thw.p_sparse)
    for geom in GEOMS:
        for dtype_bytes in (4, 2):
            a = jsel.select_backend(JSpec(shape, 2, r), t, dtype_bytes,
                                    hw=jhw, **geom)
            b = tsel.select_backend(TSpec(shape, 2, r), t, dtype_bytes,
                                    hw=thw, **geom)
            assert_same_decision(a, b)


@pytest.mark.parametrize("shape", ["box", "star"])
@pytest.mark.parametrize("t", [1, 3])
def test_select_backend_parity_3d_and_boundary(shape, t):
    for geom, boundary in ((dict(strip_m=32, z_slab=16), None),
                           (dict(strip_m=64), ("reflect", "periodic"))):
        dim = 3 if "z_slab" in geom else 2
        a = jsel.select_backend(JSpec(shape, dim, 1), t, 4,
                                hw=jpm.A100_FLOAT, boundary=boundary, **geom)
        b = tsel.select_backend(TSpec(shape, dim, 1), t, 4,
                                hw=tpm.A100_FLOAT, boundary=boundary, **geom)
        assert_same_decision(a, b)


@pytest.mark.parametrize("shape", ["box", "star"])
def test_model_functions_parity(shape):
    for r in (1, 2):
        for t in (1, 2, 5):
            wa = jpm.StencilWorkload(JSpec(shape, 2, r), t, 4, read_amp=1.2)
            wb = tpm.StencilWorkload(TSpec(shape, 2, r), t, 4, read_amp=1.2)
            s = tpm.sparsity_banded(r * t, 16)
            assert s == jpm.sparsity_banded(r * t, 16)
            ca = jpm.compare(wa, jpm.A100_FLOAT, s)
            cb = tpm.compare(wb, tpm.A100_FLOAT, s)
            assert ca.speedup == cb.speedup
            assert ca.scenario.name == cb.scenario.name
            assert jpm.reuse_beta(wa.spec, t, 64, None, 48) == \
                tpm.reuse_beta(wb.spec, t, 64, None, 48)
            assert jpm.perf_matrix_reuse(wa, jpm.A100_FLOAT, s, 64).actual_flops \
                == tpm.perf_matrix_reuse(wb, tpm.A100_FLOAT, s, 64).actual_flops


def test_h100_datasheet_spec_is_the_default():
    hw = tpm.H100_SXM_DATASHEET
    assert (hw.p_vector, hw.p_matrix, hw.p_sparse, hw.bandwidth) == \
        (67e12, 495e12, 989e12, 3.35e12)
    assert "data sheet" in hw.name
    for fn in (tsel.select_backend, tplan.decide, tplan.stencil_plan,
               tplan.plan_signature):
        assert inspect.signature(fn).parameters["hw"].default is hw


@pytest.mark.parametrize("hw", HW)
def test_sparse_unit_matches_jax(hw):
    # use_sparse_unit=True (item 10) prices the compacted candidates as the
    # JAX selector does, on every spec both packages carry (the TPU specs
    # have no sparse unit: the compacted pair still competes).
    for kind, dim, r, t, tile_n in (("star", 2, 1, 1, 16), ("star", 2, 1, 4, 32),
                                    ("box", 3, 1, 2, 16), ("star", 3, 2, 1, 16)):
        a = jsel.select_backend(JSpec(kind, dim, r), t, 4, getattr(jpm, hw),
                                tile_n=tile_n, use_sparse_unit=True)
        b = tsel.select_backend(TSpec(kind, dim, r), t, 4, getattr(tpm, hw),
                                tile_n=tile_n, use_sparse_unit=True)
        assert_same_decision(a, b)
        assert {"sparse_matmul", "fused_sparse_matmul"} & set(b.candidates)
