"""Host-side parity of the PyTorch port with the JAX package: specs,
weights, boundaries, env knobs, banded operands and the sizing subset
(all bitwise or exactly equal), and the port's import isolation."""
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import envutil as jenv  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels.stencil_matmul import (band_sparsity as j_band_sparsity,  # noqa: E402
                                          build_bands as j_build_bands,
                                          build_bands_nd as j_build_bands_nd)
from repro.stencil import boundary as jboundary  # noqa: E402
from repro.stencil import spec as jspec  # noqa: E402
from repro.stencil import weights as jweights  # noqa: E402

from repro_torch.core import envutil as tenv  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels.stencil_matmul import (  # noqa: E402
    band_sparsity as t_band_sparsity, build_bands as t_build_bands,
    build_bands_nd as t_build_bands_nd)
from repro_torch.stencil import boundary as tboundary  # noqa: E402
from repro_torch.stencil import spec as tspec  # noqa: E402
from repro_torch.stencil import weights as tweights  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
SPECS = [(shape, dim, r) for shape in ("box", "star") for dim in (1, 2, 3)
         for r in (1, 2, 3)]


@pytest.mark.parametrize("shape,dim,r", SPECS)
def test_spec_parity(shape, dim, r):
    a, b = jspec.StencilSpec(shape, dim, r), tspec.StencilSpec(shape, dim, r)
    assert (a.width, a.kernel_shape, a.num_points, a.name) == \
        (b.width, b.kernel_shape, b.num_points, b.name)
    assert np.array_equal(a.support_mask(), b.support_mask())
    assert a.flops_per_point() == b.flops_per_point()
    assert tspec.StencilSpec.from_name(a.name) == b


@pytest.mark.parametrize("shape,dim,r", SPECS)
def test_weights_bitwise(shape, dim, r):
    a, b = jspec.StencilSpec(shape, dim, r), tspec.StencilSpec(shape, dim, r)
    for seed in (0, 1, 7):
        wa, wb = jweights.make_weights(a, seed), tweights.make_weights(b, seed)
        assert wa.dtype == wb.dtype and wa.tobytes() == wb.tobytes()
    assert jweights.jacobi_weights(a).tobytes() == \
        tweights.jacobi_weights(b).tobytes()
    w = jweights.make_weights(a, 3)
    for t in (1, 2, 4):
        if dim == 3 and r * t > 4:
            continue                     # keep the composed 3D kernels small
        assert jweights.fuse_weights(w, t).tobytes() == \
            tweights.fuse_weights(w, t).tobytes()
        assert jweights.alpha(a, t) == tweights.alpha(b, t)
        assert jweights.fused_num_points(a, t) == tweights.fused_num_points(b, t)


@pytest.mark.parametrize("arg,dim", [
    (None, 2), ("periodic", 2), ("zero", 3), ("reflect", 1),
    (("reflect", "periodic"), 2), (("zero", None, "replicate"), 3),
    ([None, None], 2)])
def test_boundary_resolution(arg, dim):
    assert jboundary.resolve_boundary(arg, dim) == \
        tboundary.resolve_boundary(arg, dim)
    assert jboundary.is_periodic(arg) == tboundary.is_periodic(arg)
    modes = tboundary.resolve_boundary(arg, dim)
    assert jboundary.boundary_label(modes) == tboundary.boundary_label(modes)
    assert jboundary.PAD_MODE == tboundary.PAD_MODE


@pytest.mark.parametrize("arg,dim", [("wrap", 2), (("zero",), 2),
                                     (("bogus", "zero"), 2)])
def test_boundary_rejections_match(arg, dim):
    with pytest.raises(ValueError) as ja:
        jboundary.resolve_boundary(arg, dim)
    with pytest.raises(ValueError) as tb:
        tboundary.resolve_boundary(arg, dim)
    assert str(ja.value) == str(tb.value)


@pytest.mark.parametrize("raw", [None, "", " 17 ", "0", "zero", "1,,4,",
                                 "yes", "off", "maybe"])
def test_envutil_parity(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("REPRO_TEST_KNOB", raising=False)
    else:
        monkeypatch.setenv("REPRO_TEST_KNOB", raw)

    def outcome(mod, fn, *args):
        try:
            return ("ok", getattr(mod, fn)("REPRO_TEST_KNOB", *args))
        except ValueError as e:
            return ("err", str(e))

    for fn, args in (("env_str", ("d",)), ("env_int", (5,)),
                     ("env_int_list", ((1, 2),)), ("env_flag", (False,))):
        assert outcome(jenv, fn, *args) == outcome(tenv, fn, *args)


def _kernels():
    out = []
    for shape in ("box", "star"):
        for r in (1, 2, 3):
            w = jweights.make_weights(jspec.StencilSpec(shape, 2, r), seed=r)
            out.append(w)
            out.append(jweights.fuse_weights(w, 2))
    return out


@pytest.mark.parametrize("k", range(12))
@pytest.mark.parametrize("tile_n", [16, 67, 128])
def test_bands_bitwise(k, tile_n):
    w = _kernels()[k]
    a = j_build_bands(w.astype(np.float32), tile_n)
    b = t_build_bands(w.astype(np.float32), tile_n)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    (oa, ba), (ob, bb) = (j_build_bands_nd(w.astype(np.float32), tile_n),
                          t_build_bands_nd(w.astype(np.float32), tile_n))
    assert oa == ob and ba.tobytes() == bb.tobytes()
    assert j_band_sparsity(w, tile_n) == t_band_sparsity(w, tile_n)


def test_bands_nd_3d_star_drops_zero_rows():
    w = jweights.make_weights(jspec.StencilSpec("star", 3, 1), seed=0)
    (oa, ba), (ob, bb) = (j_build_bands_nd(w, 16), t_build_bands_nd(w, 16))
    assert oa == ob and len(ob) == 5 and ba.tobytes() == bb.tobytes()


@pytest.mark.parametrize("args", [
    (2, 4), (2, 4, 64), (2, 4, 100, 7), (2, 12, 48, 12, None, None, 32, 12),
    (3, 2, 32), (3, 2, 32, 4, 16), (1, 3)])
def test_pricing_geom_parity(args):
    a, b = jcommon.pricing_geom(*args), tcommon.pricing_geom(*args)
    assert (a.dim, a.strip_m, a.h_block, a.z_slab, a.z_block, a.w_tile,
            a.w_block) == (b.dim, b.strip_m, b.h_block, b.z_slab, b.z_block,
                           b.w_tile, b.w_block)
    assert a.read_amp == b.read_amp and a.describe() == b.describe()


@pytest.mark.parametrize("args", [
    ((64, 128), 16, 4), ((64, 128), 16, 4, (3, 18, 16), 2),
    ((64, 128), 32, 2, None, 4, 64, 8), ((96, 100), 32, 4, (9, 24, 16), 0)])
def test_traffic_model_parity(args):
    assert jcommon.hbm_read_bytes_per_step(*args) == \
        tcommon.hbm_read_bytes_per_step(*args)
    assert jcommon.substrate_read_amp(args[1], 4) == \
        tcommon.substrate_read_amp(args[1], 4)


@pytest.mark.parametrize("w,r,mode", [(5, 3, "periodic"), (2, 3, "periodic"),
                                      (3, 3, "zero"), (4, 3, "reflect")])
def test_wrap_radius_guard_parity(w, r, mode):
    def outcome(mod):
        try:
            mod._check_wrap_radius(w, r, mode)
            return None
        except ValueError as e:
            return str(e)
    assert outcome(jcommon) == outcome(tcommon)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.kernels.plan\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), REPO] + [p for p in
                                              [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
