"""The composed contraction's cells of the sample in
``test_torch_workspace_deep.py``: for Box and Star, the shallowest cell
whose ``fused_matmul`` the port refused before the tile rule's fourth rung
(Box-3D3R t = 8 and Star-3D4R t = 7, h = 24 and 28) and the deepest whose
kernel this CPU composes in seconds (Box-3D4R t = 7 and Star-3D4R t = 8,
h = 28 and 32, both past contraction depth 64: the workspace form's deep
k-loop), each on the smallest grid both packages take, held to JAX's
``apply_stencil`` (jitted once a grid) stepped t times within
``oracle_tolerance``.  The deepest refused cells, Box- and Star-3D7R at t =
8, compose a 113^3 kernel, which takes many minutes on this CPU in either
package (``fuse_weights``); ``chip_smoke.py`` holds the composed workspace
form 72 deep to its plain version on the card.  The port's compositions
share their steps (t = 8 continues t = 7): the same float64 convolutions
in the same order as ``fuse_weights`` (JAX's too, whose plans build with
them while the smallest grid is sought)."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.registry as jregistry  # noqa: E402
import repro.stencil.weights as jweights  # noqa: E402
from repro.stencil import StencilSpec as JSpec, make_weights  # noqa: E402
from repro.stencil.reference import apply_stencil as j_apply  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
import repro_torch.kernels.registry as tregistry  # noqa: E402
from repro_torch.kernels.ref import oracle_tolerance  # noqa: E402
from repro_torch.stencil import weights as tweights  # noqa: E402
import test_torch_workspace_deep as deep  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

CELLS = [("Box-3D3R", 8), ("Box-3D4R", 7), ("Star-3D4R", 7), ("Star-3D4R", 8)]


@functools.lru_cache(maxsize=None)
def _composed64(w_bytes: bytes, shape: tuple, t: int) -> np.ndarray:
    w64 = np.frombuffer(w_bytes, np.float32).reshape(shape).astype(np.float64)
    if t == 1:
        return w64
    return tweights.convolve(_composed64(w_bytes, shape, t - 1), w64,
                             mode="full")


def shared_fuse(w, t: int) -> np.ndarray:
    """``fuse_weights(w, t)``, its convolutions shared across t."""
    w = np.asarray(w)
    return _composed64(np.ascontiguousarray(w, np.float32).tobytes(), w.shape,
                       t).astype(w.dtype)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jweights, "fused_num_points", tweights.fused_num_points)
    mp.setattr(tregistry, "fuse_weights", shared_fuse)
    mp.setattr(jregistry, "fuse_weights", shared_fuse)
    yield
    mp.undo()
    torch.set_num_threads(n)


def test_the_shared_composition_is_fuse_weights():
    w = make_weights(JSpec.from_name("Star-3D2R"), seed=0)
    for t in (2, 3):
        np.testing.assert_array_equal(shared_fuse(w, t),
                                      tweights.fuse_weights(w, t))


@functools.lru_cache(maxsize=None)
def _oracle(pattern: str, n: int, t: int) -> np.ndarray:
    w = make_weights(JSpec.from_name(pattern), seed=0)
    step = jax.jit(lambda z, w=jnp.asarray(w): j_apply(z, w))
    z = jnp.asarray(deep.grid(n))
    for _ in range(t):
        z = step(z)
    return np.asarray(z)


@pytest.mark.parametrize("pattern,t", CELLS)
def test_composed_cells_match_the_oracle(pattern, t):
    n = deep.smallest_grid(pattern, t, "fused_matmul")
    w = make_weights(JSpec.from_name(pattern), seed=0)
    plan = tk.stencil_plan(w, (n, n, n), torch.float32, t,
                           backend="fused_matmul", device="cpu",
                           use_cache=False)
    lay = plan.fn.workspace
    assert lay is not None
    r = (w.shape[0] - 1) // 2
    assert lay.base.kpad == -(-(16 + 2 * t * r) // 8) * 8
    x = torch.from_numpy(deep.grid(n))
    y = plan(x)
    np.testing.assert_allclose(y.numpy(), _oracle(pattern, n, t), rtol=0,
                               atol=oracle_tolerance("fused_matmul", t, w, x))
