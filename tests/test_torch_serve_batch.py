"""Batched plans (K11) on the CPU: ``stencil_plan(..., batch=B)`` of the
port equals a loop of its unbatched plans bit for bit, for every
registered backend on 1D, 2D and 3D grids, periodic and under one
boundary spec per rank, in both fold modes; it matches the JAX batched
plan over the JAX sweep (``tests/test_serve_batch.py``) within the
tolerance of ``tests/test_torch_plan.py``; and the batch plumbing (shape,
key, validation, ``explain``, launch counting, fault hooks) mirrors JAX."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import stencil_plan as jstencil_plan  # noqa: E402
from repro.stencil import StencilSpec as JSpec  # noqa: E402
from repro.stencil import jacobi_weights as jjacobi  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import common, registry  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.stencil import StencilSpec, make_weights  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

#: Grids of the in-port sweep: the 2D one divides into the 9-tile foils'
#: clamped tiles (16 x 32), the others are ragged.
_GRIDS = {1: (50,), 2: (16, 32), 3: (6, 10, 12)}
#: One non-periodic spec per rank.
_BOUNDARY = {1: "reflect", 2: ("zero", "periodic"),
             3: ("replicate", "reflect", "periodic")}
_B, _T = 3, 2


def _backends(dim, boundary):
    out = []
    for name in registry.registered_backends():
        if name.startswith("legacy_") and (dim != 2 or boundary is not None):
            continue                 # the seed foils: 2D periodic only
        if name.startswith("fused_matmul") and not \
                name.startswith("fused_matmul_reuse") and boundary is not None:
            continue                 # monolithic fusion refuses at t > 1
        out.append(name)
    return out


_SWEEP = [(dim, bc, name, mode)
          for dim in (1, 2, 3)
          for bc in (None, _BOUNDARY[dim])
          for name in _backends(dim, bc)
          for mode in ("map", "vmap")]


@pytest.mark.parametrize("dim,boundary,backend,mode", _SWEEP)
def test_batched_plan_is_the_loop_bit_for_bit(dim, boundary, backend, mode):
    grid = _GRIDS[dim]
    w = make_weights(StencilSpec("box", dim, 1), seed=dim)
    xb = torch.from_numpy(np.random.default_rng(dim).normal(
        size=(_B,) + grid).astype(np.float32))
    kw = dict(backend=backend, boundary=boundary, device="cpu",
              use_sparse_unit="sparse" in backend)
    batched = tk.stencil_plan(w, grid, torch.float32, _T, batch=_B,
                              batch_mode=mode, **kw)
    one = tk.stencil_plan(w, grid, torch.float32, _T, **kw)
    assert batched.batch_mode == mode and batched.input_shape == xb.shape
    got = batched(xb)
    want = torch.stack([one(x) for x in xb])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), f"{backend} {dim}D {boundary} {mode}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_batched_auto_plan_with_the_sparse_unit(dtype, mode):
    w = make_weights(StencilSpec("star", 2, 1), seed=4)
    xb = torch.from_numpy(np.random.default_rng(4).normal(
        size=(_B, 16, 32)).astype(np.float32)).to(dtype)
    kw = dict(device="cpu", use_sparse_unit=True)
    got = tk.stencil_plan(w, (16, 32), dtype, 1, batch=_B, batch_mode=mode,
                          **kw)(xb)
    one = tk.stencil_plan(w, (16, 32), dtype, 1, **kw)
    assert torch.equal(got, torch.stack([one(x) for x in xb]))


# ---------------------------------------------------------------------------
# Against the JAX package: the sweep of tests/test_serve_batch.py:37-41.
# ---------------------------------------------------------------------------
#: (grid, t) per rank, the JAX sweep's (3D at t=1, as there).
_JGEOM = {2: ((16, 16), 2), 3: ((8, 8, 8), 1)}
_JAX_OUT = {}


def _jax_batched(w, grid, t, xs, dtype_name, backend, B):
    """The JAX batched plan in interpret mode, batch_mode="map" (whose
    equality with "vmap" the JAX sweep asserts), once per case."""
    key = (grid, t, dtype_name, backend, B, w.tobytes())
    if key not in _JAX_OUT:
        jdt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
        jp = jstencil_plan(w, grid, jdt, t, batch=B, batch_mode="map",
                           backend=backend, interpret=True)
        _JAX_OUT[key] = np.asarray(jp(jnp.asarray(xs[:B]).astype(jdt))
                                   ).astype(np.float32)
    return _JAX_OUT[key]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["box", "star"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["map", "vmap"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_batched_plan_matches_the_jax_batched_plan(dim, shape, dtype_name,
                                                   mode, B):
    grid, t = _JGEOM[dim]
    w = jjacobi(JSpec(shape, dim, 1))
    rng = np.random.default_rng(dim * 7 + len(shape))
    xs = rng.normal(size=(8,) + grid).astype(np.float32)
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    plan = tk.stencil_plan(w, grid, dtype, t, batch=B, batch_mode=mode,
                           device="cpu")
    got = plan(torch.from_numpy(xs[:B]).to(dtype)).float().numpy()
    want = _jax_batched(w, grid, t, xs, dtype_name, plan.backend, B)
    # the port's tolerance of tests/test_torch_plan.py: f32 1e-5 * max|x|
    # per step; bf16 two ulps of max|x| per rounding (one per launch, one
    # per in-launch step of the banded regimes)
    mx = float(np.abs(xs[:B]).max())
    rounds = t if plan.backend in ("direct", "matmul", "fused_matmul_reuse",
                                   "sparse_matmul") else 1
    tol = 2 * 2.0**-8 * mx * rounds if dtype == torch.bfloat16 else \
        1e-5 * mx * t
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# Plumbing, mirrored from TestBatchedPlanShape / TestBatchInCacheKey.
# ---------------------------------------------------------------------------
def _w(shape="box"):
    return make_weights(StencilSpec(shape, 2, 1), seed=0)


class TestBatchedPlanShape:
    def test_input_shape_and_rank_check(self):
        p = tk.stencil_plan(_w(), (16, 16), torch.float32, 2, batch=4,
                            device="cpu")
        assert p.input_shape == (4, 16, 16) and p.batch == 4
        with pytest.raises(ValueError, match="built for input"):
            p(torch.zeros(16, 16))            # unbatched input, batched plan

    def test_unbatched_plan_rejects_batched_input(self):
        p = tk.stencil_plan(_w(), (16, 16), torch.float32, 2, device="cpu")
        assert p.input_shape == (16, 16) and p.batch is None
        with pytest.raises(ValueError, match="built for"):
            p(torch.zeros(4, 16, 16))

    def test_explain_and_repr_name_the_batch(self):
        p = tk.stencil_plan(_w("star"), (16, 16), torch.float32, 2, batch=8,
                            batch_mode="map", device="cpu")
        assert "batch=8" in p.explain() and "map" in p.explain()
        assert "batch=8" in repr(p)

    def test_a_batch_of_2d_grids_is_not_a_3d_grid(self):
        # the grid's rank comes from the weights, never from x.ndim
        w3 = make_weights(StencilSpec("box", 3, 1), seed=0)
        x = torch.randn(4, 16, 16, generator=torch.Generator().manual_seed(0))
        p2 = tk.stencil_plan(_w(), (16, 16), torch.float32, 1, batch=4,
                             device="cpu", backend="direct")
        p3 = tk.stencil_plan(w3, (4, 16, 16), torch.float32, 1,
                             device="cpu", backend="direct")
        assert not torch.equal(p2(x), p3(x))
        assert torch.equal(p2(x)[1], tk.stencil_plan(
            _w(), (16, 16), torch.float32, 1, device="cpu",
            backend="direct")(x[1]))


class TestBatchInCacheKey:
    def _sig(self, **kw):
        key, *_ = tplan.plan_signature(_w(), (16, 16), torch.float32, 2,
                                       device="cpu", **kw)
        return key

    def test_batch_changes_key(self):
        assert self._sig() != self._sig(batch=8)
        assert self._sig(batch=4) != self._sig(batch=8)

    def test_fold_mode_changes_key(self):
        assert self._sig(batch=8, batch_mode="map") \
            != self._sig(batch=8, batch_mode="vmap")

    def test_auto_aliases_its_resolution(self):
        # on the CPU auto == map (one plan, not two), as JAX's interpret
        assert self._sig(batch=8, batch_mode="auto") \
            == self._sig(batch=8, batch_mode="map")
        assert tplan._resolve_batch_mode("auto", False) == "map"
        assert tplan._resolve_batch_mode("auto", True) == "vmap"
        assert set(tplan.BATCH_MODES) == {"auto", "vmap", "map"}

    def test_cache_hit_on_batched_replan(self):
        tk.clear_plan_cache()
        p1 = tk.stencil_plan(_w(), (16, 16), torch.float32, 2, batch=8,
                             device="cpu")
        p2 = tk.stencil_plan(_w(), (16, 16), torch.float32, 2, batch=8,
                             device="cpu")
        assert p1 is p2
        st = tk.plan_cache_stats()
        assert st["hits"] == 1 and st["misses"] == 1
        tk.clear_plan_cache()

    def test_batch_validation(self):
        with pytest.raises(ValueError, match="batch must be >= 1"):
            tk.stencil_plan(_w(), (16, 16), torch.float32, 1, batch=0,
                            device="cpu")
        with pytest.raises(ValueError, match="batch_mode"):
            tk.stencil_plan(_w(), (16, 16), torch.float32, 1, batch=2,
                            batch_mode="scan", device="cpu")

    def test_batch_with_a_mesh_raises_as_in_jax(self):
        with pytest.raises(ValueError, match="distributed meshes"):
            tk.stencil_plan(_w(), (16, 16), torch.float32, 1, batch=2,
                            mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="distributed meshes"):
            jstencil_plan(jjacobi(JSpec("box", 2, 1)), (16, 16), np.float32,
                          1, batch=2, mesh=object(), shard_spec=("x", None))


def test_batch_chunks_split_at_the_grid_z_limit():
    assert common.MAX_GRID_Z == 65535
    assert common.batch_chunks(1) == [(0, 1)]
    assert common.batch_chunks(65535) == [(0, 65535)]
    assert common.batch_chunks(65537) == [(0, 65535), (65535, 2)]
    assert len(common.batch_chunks(3 * 65535 + 1)) == 4
    with pytest.raises(ValueError):
        common.batch_chunks(0)
    src = (common.__file__[:-len("common.py")] + "csrc/common.cuh")
    assert "#define MAX_GRID_Z 65535" in open(src).read()


@pytest.mark.parametrize("backend,calls", [
    ("direct", _T), ("fused_direct", 1), ("matmul", _T), ("fused_matmul", 1),
    ("fused_matmul_reuse", 1), ("sparse_matmul", _T),
    ("fused_sparse_matmul", 1), ("fused_direct_wholestrip", 1)])
def test_vmap_makes_one_wrapper_call_per_kernel_call(monkeypatch, backend,
                                                     calls):
    """A "vmap" plan calls each wrapper once per kernel call of its runner
    with the whole batch (one launch on the card), a "map" plan once per
    grid: direct / matmul / sparse_matmul make t batched calls, the fused
    regimes one."""
    seen = []
    for name in ("stencil_direct_at", "stencil_matmul_at",
                 "stencil_sparse_matmul_at"):
        real = getattr(registry, name)

        def spy(x, *a, _real=real, **k):
            seen.append(tuple(x.shape))
            return _real(x, *a, **k)
        monkeypatch.setattr(registry, name, spy)
    tk.clear_plan_cache()
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    xb = torch.zeros((_B, 16, 32))
    for mode, n, shape in (("vmap", calls, (_B, 16, 32)),
                           ("map", calls * _B, (16, 32))):
        seen.clear()
        tk.stencil_plan(w, (16, 32), torch.float32, _T, backend=backend,
                        batch=_B, batch_mode=mode, device="cpu",
                        use_sparse_unit=True)(xb)
        assert seen == [shape] * n, (mode, seen)
    tk.clear_plan_cache()


@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_fault_hooks_fire_once_per_kernel_call(mode):
    """JAX traces a batched runner once, so its hooks fire once per kernel
    call whatever B: a "map" plan's later grids stay quiet."""
    tk.clear_plan_cache()
    faults.reset_faults()
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    with faults.inject("vmem", times=1, skip=10**6) as spec:
        tk.stencil_plan(w, (16, 32), torch.float32, _T, backend="direct",
                        batch=_B, batch_mode=mode,
                        device="cpu")(torch.zeros(_B, 16, 32))
    assert spec.hits == _T and spec.fired == 0
    tk.clear_plan_cache()
