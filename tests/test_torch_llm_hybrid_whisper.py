"""The port's Mamba2 SSM, Zamba2 hybrid and Whisper encoder-decoder
(``repro_torch.models.ssm`` / ``zamba`` / ``whisper``) against the JAX
package's on the CPU: the chunked SSD scan at every chunk size, the decode
step, the causal conv and its carried state, ``_segsum``, the in-projection
split at indices (``jnp.split``, i.e. ``tensor_split``), then per SMOKE arch
and dtype the logits, ``loss_fn`` and four cached decode steps (zamba: one
KV cache per shared-attention site; whisper from its ``prefill``'s encoder
K/V) (bounds: ``llm_parity``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro.models import ssm as jssm
from repro.models import zamba as jzamba
from repro_torch.models import ssm, whisper, zamba
from torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = ["zamba2-1.2b", "whisper-base"]
CASES = [(a, d) for a in ARCHS for d in lp.DTYPES]


@pytest.fixture(scope="module")
def refs():
    return lp.References()


def _ssd_inputs(S=32, seed=0):
    r = np.random.default_rng(seed)
    B, H, hd, N = 2, 3, 4, 5
    xh = r.normal(size=(B, S, H, hd)).astype(np.float32)
    b, c = (r.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    dt = r.uniform(0.01, 1.0, size=(B, S, H)).astype(np.float32)
    A = -r.uniform(0.1, 2.0, size=(H,)).astype(np.float32)
    st = r.normal(size=(B, H, hd, N)).astype(np.float32)
    return xh, b, c, dt, A, st


@pytest.mark.parametrize("chunk", [1, 4, 8, 16, 32, 64])
def test_ssm_scan_chunked(chunk):
    args = _ssd_inputs()
    want_y, want_st = jssm.ssm_scan_chunked(*map(jnp.asarray, args), chunk)
    got_y, got_st = ssm.ssm_scan_chunked(*map(torch.from_numpy, args), chunk)
    lp.assert_close(got_y.numpy(), np.asarray(want_y), what=f"y chunk {chunk}")
    lp.assert_close(got_st.numpy(), np.asarray(want_st), what=f"state chunk {chunk}")


def test_ssm_step_continues_the_scan():
    args = _ssd_inputs(1)
    want = jssm.ssm_step(*map(jnp.asarray, args))
    got = ssm.ssm_step(*map(torch.from_numpy, args))
    for g, w, what in zip(got, want, ("y", "state")):
        lp.assert_close(g.numpy(), np.asarray(w), what=f"step {what}")
    full = [torch.from_numpy(a) for a in _ssd_inputs(9, seed=3)]
    y9, _ = ssm.ssm_scan_chunked(*full, 9)
    _, st8 = ssm.ssm_scan_chunked(*[a[:, :8] for a in full[:4]], full[4], full[5], 8)
    y1, _ = ssm.ssm_step(*[a[:, 8:9] for a in full[:4]], full[4], st8)
    lp.assert_close(y1.numpy(), y9[:, 8:9].numpy(), what="step after scan")


def test_segsum():
    lw = -np.random.default_rng(1).uniform(0, 1, size=(2, 3, 6)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(lw)))
    got = ssm._segsum(torch.from_numpy(lw)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    lp.assert_close(got[fin], want[fin], what="segsum")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 5, 8)).astype(np.float32)
    w = r.normal(size=(4, 8)).astype(np.float32)
    st = r.normal(size=(2, 3, 8)).astype(np.float32) if with_state else None
    want_y, want_st = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                        None if st is None else jnp.asarray(st))
    got_y, got_st = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                     None if st is None else torch.from_numpy(st))
    lp.assert_close(got_y.numpy(), np.asarray(want_y), what="conv y")
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


def test_split_proj_takes_indices():
    """``jnp.split(proj, [i1, i2, i3, i4])`` cuts at indices; the port's
    ``tensor_split`` does too (``torch.split`` would read them as sizes)."""
    _, cfg = lp.configs("zamba2-1.2b", "float32")
    d_inner, H, hd, N = ssm.ssm_dims(cfg)
    width = 2 * d_inner + 2 * N + H
    proj = np.arange(2 * width, dtype=np.float32).reshape(1, 2, width)
    want = jssm._split_proj(jnp.asarray(proj), cfg)
    got = ssm._split_proj(torch.from_numpy(proj), cfg)
    assert [g.shape[-1] for g in got] == [d_inner, d_inner, N, N, H]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_zamba_sites():
    """One KV cache per shared-attention site, sites every 6 layers."""
    from repro_torch.configs import ARCHS, SMOKE
    for cfgs in (ARCHS, SMOKE):
        cfg = cfgs["zamba2-1.2b"]
        n = zamba.n_shared_sites(cfg)
        assert n == jzamba.n_shared_sites(cfg)
        assert zamba.init_caches(cfg, 1, 4, "meta")["kv"]["k"].shape[0] == n
    assert zamba.n_shared_sites(ARCHS["zamba2-1.2b"]) == 7


@pytest.mark.parametrize("arch,dtype", CASES)
def test_logits(refs, arch, dtype):
    lp.check_logits(refs, arch, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_loss(refs, arch, dtype):
    lp.check_loss(refs, arch, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_cached_decode(refs, arch, dtype):
    lp.check_decode(refs, arch, dtype)


@pytest.mark.parametrize("dtype", lp.DTYPES)
def test_whisper_prefill(refs, dtype):
    """``prefill``'s encoder output and cross K/V (the first decode caches
    of ``check_decode``), against JAX's."""
    ref, ref32 = refs.pair("whisper-base", dtype)
    _, cfg = lp.configs("whisper-base", dtype)
    with torch.no_grad():
        caches = whisper.prefill(lp.to_torch(ref["params"]),
                                 torch.from_numpy(ref["inputs"]["frames"]), cfg,
                                 lp.B, lp.MAX_SEQ)
    lp.check_tree(lp.base.tree_map(lp.as_numpy, caches), ref["caches0"],
                  None if ref32 is None else ref32["caches0"], f"whisper {dtype} prefill")


@pytest.mark.parametrize("every", [1, 2, 3])
def test_zamba_several_sites(every):
    """SMOKE zamba2 has 4 layers and one site (every 6); at every 1, 2 and
    3 it has 4, 2 and 2 sites, each its own KV cache: logits, and four
    cached decode steps' logits and caches, against JAX in float32."""
    import jax
    from repro.models import layers as jnn
    from repro.models.api import get_model as jax_get_model
    jcfg, cfg = (dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, shared_attn_every=every))
                 for c in lp.configs("zamba2-1.2b", "float32"))
    assert zamba.n_shared_sites(cfg) == {1: 4, 2: 2, 3: 2}[every]
    jp = jax_get_model(jcfg).init_params(jax.random.PRNGKey(2))
    params = lp.to_torch(lp.to_numpy(jp))
    toks = lp.make_inputs(jcfg)["tokens"]
    want = np.asarray(jax.jit(lambda p, tk: jnn.lm_logits(
        p, jzamba.forward(p, tk, jcfg)[0], jcfg))(jp, jnp.asarray(toks[:, :-1])))
    jstep = jax.jit(lambda p, c, tk, pos: jzamba.decode_step(p, c, tk, jcfg, pos))
    with torch.no_grad():
        th, _, _ = zamba.forward(params, torch.from_numpy(toks[:, :-1]), cfg)
        lp.assert_close(lp.nn.lm_logits(params, th, cfg).numpy(), want, what="logits")
        jc = jzamba.init_caches(jcfg, lp.B, lp.MAX_SEQ)
        tc = zamba.init_caches(cfg, lp.B, lp.MAX_SEQ, "cpu")
        for t in range(lp.STEPS):
            tok = toks[:, t:t + 1]
            jn, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(t, jnp.int32))
            logits, tc = zamba.decode_logits(params, tc, torch.from_numpy(tok), cfg, t)
            lp.assert_close(logits[:, 0].numpy(), want[:, t], what=f"step {t} vs forward")
            np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), np.asarray(jn))
            lp.check_tree(lp.base.tree_map(lp.as_numpy, tc), lp.to_numpy(jc), None,
                          f"step {t} caches")
