"""The port's oracle (``repro_torch.stencil.reference``) against the JAX
oracle (``repro.stencil.reference``), and the port's roll path against its
conv path."""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.stencil import reference as jref  # noqa: E402
from repro.stencil import make_weights, StencilSpec  # noqa: E402
from repro_torch.stencil import reference as tref  # noqa: E402
from repro_torch.kernels import ref as tkref  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


def _grid(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(port, jax_out, x, t=1):
    # Both oracles add the taps in the same row-major order in f32; XLA and
    # torch may still form FMAs differently, which moves near-zero outputs
    # by an ulp of the terms, so an absolute floor rides with rtol 1e-6.
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), rtol=1e-6,
                               atol=1e-6 * t * np.abs(x).max())


@pytest.mark.parametrize("shape", ["box", "star"])
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_oracle_matches_jax_2d(shape, r, t):
    w = make_weights(StencilSpec(shape, 2, r), seed=r)
    x = _grid((24, 40), seed=t)
    port = tref.apply_stencil_steps(torch.from_numpy(x), w, t)
    _close(port, jref.apply_stencil_steps(jnp.asarray(x), jnp.asarray(w), t),
           x, t)
    # the kernels' oracle entry points are the same function
    assert torch.equal(port, tkref.stencil_direct_ref(torch.from_numpy(x),
                                                      w, t))


@pytest.mark.parametrize("boundary", ["periodic", "zero", "reflect",
                                      "replicate", ("reflect", "zero"),
                                      ("replicate", "periodic")])
@pytest.mark.parametrize("shape", ["box", "star"])
def test_oracle_boundaries_match_jax(boundary, shape):
    w = make_weights(StencilSpec(shape, 2, 2), seed=0)
    x = _grid((20, 27))
    port = tref.apply_stencil_steps(torch.from_numpy(x), w, 2, boundary)
    _close(port, jref.apply_stencil_steps(jnp.asarray(x), jnp.asarray(w), 2,
                                          boundary), x, 2)


@pytest.mark.parametrize("dim,shape", [(1, (37,)), (3, (6, 8, 10))])
@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_oracle_1d_3d_match_jax(dim, shape, boundary):
    w = make_weights(StencilSpec("star", dim, 1), seed=1)
    x = _grid(shape)
    port = tref.apply_stencil(torch.from_numpy(x), w, boundary)
    _close(port, jref.apply_stencil(jnp.asarray(x), jnp.asarray(w), boundary),
           x)


@pytest.mark.parametrize("modes", [("periodic", "periodic"),
                                   ("zero", "reflect"),
                                   ("replicate", "zero"),
                                   ("reflect", "replicate"),
                                   ("reflect", "periodic", "zero")])
def test_pad_boundary_bitwise(modes):
    x = _grid((7, 9, 5)[:len(modes)])
    port = tref.pad_boundary(torch.from_numpy(x), 3, modes)
    assert np.array_equal(port.numpy(),
                          np.asarray(jref.pad_boundary(jnp.asarray(x), 3,
                                                       modes)))


@pytest.mark.parametrize("shape", ["box", "star"])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("boundary", ["periodic", "zero", "reflect",
                                      "replicate"])
def test_roll_matches_conv(shape, r, boundary):
    w = make_weights(StencilSpec(shape, 2, r), seed=2)
    x = torch.from_numpy(_grid((33, 29)))
    roll = tref.apply_stencil(x, w, boundary)
    conv = tref.apply_stencil_conv(x, w, boundary)
    # conv sums the taps in its own order: a few f32 ulps of max|x|.
    torch.testing.assert_close(conv, roll, rtol=0,
                               atol=1e-5 * float(x.abs().max()))


def test_oracle_keeps_dtype():
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = torch.from_numpy(_grid((16, 16))).to(torch.bfloat16)
    assert tref.apply_stencil_steps(x, w, 2).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tref.apply_stencil(torch.zeros(4, 4, 4), w)


@pytest.mark.parametrize("shape", ["box", "star"])
@pytest.mark.parametrize("d", [1, 3])
def test_oracle_f64_matches_jax_x64(d, shape):
    """f64 parity: the cases of the JAX test_roll_vs_conv_cross_check_f64
    (which imports the removed ``jax.experimental.enable_x64``), with the
    port's oracle at float64 against the JAX oracle under
    ``jax.enable_x64``, roll path and conv path, at rtol = atol = 1e-13."""
    import jax
    with jax.enable_x64(True):
        w = make_weights(StencilSpec(shape, d, 1), seed=5, dtype=np.float64)
        x = np.random.default_rng(6).normal(size=(10,) * d)
        xj = jnp.asarray(x)
        assert xj.dtype == jnp.float64
        xt = torch.from_numpy(x)
        for boundary in ("periodic", "zero"):
            want = np.asarray(jref.apply_stencil(xj, jnp.asarray(w),
                                                 boundary))
            for fn in (tref.apply_stencil, tref.apply_stencil_conv):
                got = fn(xt, w, boundary)
                assert got.dtype == torch.float64
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                                           atol=1e-13)
