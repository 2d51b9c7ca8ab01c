"""The banded-contraction kernel module against the JAX ``stencil_matmul``
(through its plain version, which is what a CPU tensor runs): one step,
monolithic fusion on composed weights, and intermediate reuse."""
import importlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels.stencil_matmul import stencil_matmul as j_matmul  # noqa: E402
from repro.stencil import StencilSpec, fuse_weights, make_weights  # noqa: E402
from repro_torch.kernels.common import BAND_N  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

t_matmul = importlib.import_module("repro_torch.kernels.stencil_matmul")

SHAPES = [(32, 64), (40, 67)]


def _grid(shape, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def tolerance(x: np.ndarray, dtype, t: int) -> float:
    """f32: both contract in f32 in their own order, 1e-5 * max|x| per
    step.  bf16: the operands round to bf16 at every step inside the
    launch, so an f32 difference can flip one operand rounding per step
    and the output rounding once: two bf16 ulps of max|x| per step."""
    mx = float(np.abs(x).max())
    if dtype == torch.bfloat16:
        return t * 2 * 2.0**-8 * mx
    return 1e-5 * mx * t


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_plain_matches_jax(shape, kind, r, t, dtype):
    w = make_weights(StencilSpec(kind, 2, r), seed=r + t)
    x, xt, xj = _grid(shape, dtype, seed=t)
    port = t_matmul.stencil_matmul(xt, w, t)          # CPU -> plain version
    assert port.dtype == dtype and tuple(port.shape) == shape
    ref = np.asarray(j_matmul(xj, w, t, interpret=True)).astype(np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=0,
                               atol=tolerance(x, dtype, t))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["box", "star"])
def test_banded_plain_monolithic_fusion_matches_jax(shape, kind):
    w = fuse_weights(make_weights(StencilSpec(kind, 2, 1), seed=4), 3)
    x, xt, xj = _grid(shape, torch.float32)
    port = t_matmul.stencil_matmul(xt, w, 1)
    ref = np.asarray(j_matmul(xj, w, 1, interpret=True))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=tolerance(x, torch.float32, 3))


@pytest.mark.parametrize("tile_n", [8, BAND_N, 67])
def test_plain_chunk_width_does_not_change_the_function(tile_n):
    w = make_weights(StencilSpec("box", 2, 2), seed=0)
    x, xt, _ = _grid((24, 67), torch.float32)
    a = t_matmul.stencil_matmul_plain(xt, w, 2, tile_n=tile_n)
    b = t_matmul.stencil_matmul_plain(xt, w, 2, tile_n=BAND_N)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * np.abs(x).max())


def test_plain_bf16_operands_are_exact_products():
    # f32 grid with bf16 operands: the products of bf16 values are exact in
    # f32, so the plain version equals an f32 contraction of rounded inputs.
    w = make_weights(StencilSpec("star", 2, 1), seed=0)
    x, xt, _ = _grid((32, 48), torch.float32)
    y = t_matmul.stencil_matmul_plain(xt, w, 1, compute_dtype=torch.bfloat16)
    wr = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    y_ref = t_matmul.stencil_matmul_plain(
        xt.to(torch.bfloat16).float(), wr, 1)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-6)
