"""Numbers on a sample of the deep 3D cells the port refused before the
tile rule's fourth rung (``tests/test_torch_workspace_sweep.py`` builds
all of them): for each fused regime and each of Box and Star, the
shallowest and the deepest cell that raised "too deep" (by halo t*r),
built on the smallest grid both packages take (JAX's slab geometry
refuses a grid shallower than the halo, and a little past it at h = 56),
run on the CPU (the plans' plain
versions: the workspace kernels run on the card, ``chip_smoke.py`` phase
``wide``) and held to JAX's ``apply_stencil`` stepped t times within
``oracle_tolerance``.

The tap-sum and the reuse folds (this file, Box; the Star cells in
``test_torch_workspace_deep_star.py``): Box-3D7R at t = 2 (h = 14) and t =
8 (h = 56).  JAX's 3,375-tap ``apply_stencil`` takes ~95 s to jit on this
CPU and ~15 s a step eagerly, so these cells hold the plans to the port's
copy of it (``repro_torch.stencil.reference``) stepped t times, itself
held to JAX's, run eagerly, for one step on a 14^3 grid (bit for bit
here; within 1e-6 of max|y| asserted).  The composed contraction's cells
are in ``test_torch_workspace_composed.py``."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.stencil.weights as jweights  # noqa: E402
from repro.kernels import stencil_plan as j_plan  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.reference import apply_stencil as j_apply  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels.ref import oracle_tolerance  # noqa: E402
from repro_torch.stencil import weights as tweights  # noqa: E402
from repro_torch.stencil.reference import apply_stencil  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

#: The cells: (pattern, t, regime), the shallowest and the deepest the
#: parent refused of each regime.
REGIMES = ("fused_direct", "fused_matmul_reuse", "fused_sparse_matmul")


def cells(shape: str) -> list:
    return [(f"{shape}-3D7R", t, regime) for regime in REGIMES for t in (2, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _quick_support_count():
    """JAX's decision counts a star's fused support with the port's closed
    count, the composed masks' count in microseconds
    (``tests/test_torch_host.py``) where they take minutes at Star-3D7R t =
    8 on this CPU."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jweights, "fused_num_points", tweights.fused_num_points)
    yield
    mp.undo()


def grid(n: int) -> np.ndarray:
    return np.random.default_rng(n).normal(size=(n, n, n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def port_oracle(pattern: str, n: int, t: int) -> np.ndarray:
    """The port's apply_stencil stepped t times on ``grid(n)``."""
    w = make_weights(JSpec.from_name(pattern), seed=0)
    z = torch.from_numpy(grid(n))
    for _ in range(t):
        z = apply_stencil(z, w)
    return z.numpy()


def jax_one_step_check(pattern: str, n: int) -> None:
    """JAX's apply_stencil, eagerly, one step on ``grid(n)`` against the
    port's copy."""
    w = make_weights(JSpec.from_name(pattern), seed=0)
    with jax.disable_jit():
        want = np.asarray(j_apply(jnp.asarray(grid(n)), w))
    got = port_oracle(pattern, n, 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def _builds(build) -> bool:
    try:
        build()
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=None)
def smallest_grid(pattern: str, t: int, regime: str) -> int:
    """The smallest cube edge on which both packages build the cell: from
    the halo t*r up, JAX's first (its slab geometry refuses a halo past its
    blocks: "halo exceeds z_slab", "carried x-halo exceeds w_block"), where
    the port's builds too."""
    w = make_weights(JSpec.from_name(pattern), seed=0)
    h = t * ((w.shape[0] - 1) // 2)
    n = next(n for n in range(h, 4 * h) if _builds(
        lambda: j_plan(w, (n,) * 3, jnp.float32, t, backend=regime)))
    assert _builds(lambda: tk.stencil_plan(w, (n,) * 3, torch.float32, t,
                                           backend=regime, device="cpu",
                                           use_cache=False))
    return n


def check_cell(pattern: str, t: int, regime: str) -> None:
    n = smallest_grid(pattern, t, regime)
    w = make_weights(JSpec.from_name(pattern), seed=0)
    plan = tk.stencil_plan(w, (n, n, n), torch.float32, t, backend=regime,
                           device="cpu", use_cache=False)
    assert plan.fn.workspace is not None      # the fourth rung on the card
    x = torch.from_numpy(grid(n))
    y = plan(x)
    np.testing.assert_allclose(y.numpy(), port_oracle(pattern, n, t), rtol=0,
                               atol=oracle_tolerance(regime, t, w, x))


def test_the_port_oracle_is_jax_apply_stencil():
    jax_one_step_check("Box-3D7R", 14)


@pytest.mark.parametrize("pattern,t,regime", cells("Box"))
def test_deep_box_cells_match_the_oracle(pattern, t, regime):
    check_cell(pattern, t, regime)
