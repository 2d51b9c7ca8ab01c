"""The port's RWKV-6 (``repro_torch.models.rwkv6`` / ``rwkv_model``)
against the JAX package's on the CPU: the chunked WKV scan and its factored
form at every chunk size (``chunk = S // nchunks`` recomputed; the factored
form's clamp and its chunk * 4 <= 66 guard), the one-token step, then the
SMOKE arch per dtype (logits, ``loss_fn``, four cached decode steps) and the
factored config of the full ``rwkv6-1.6b`` at SMOKE size (bounds:
``llm_parity``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import SMOKE
from repro_torch.models import rwkv6, rwkv_model
from torch_threads import one_intra_op_thread  # noqa: F401

ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def refs():
    return lp.References()


def _wkv_inputs(S=32, seed=0, lo=-4.0):
    r = np.random.default_rng(seed)
    B, H, K = 2, 3, 8
    rr, kk, vv = (r.normal(size=(B, S, H, K)).astype(np.float32) for _ in range(3))
    lw = r.uniform(lo, 0.0, size=(B, S, H, K)).astype(np.float32)
    u = r.normal(size=(H, K)).astype(np.float32)
    st = r.normal(size=(B, H, K, K)).astype(np.float32)
    return rr, kk, vv, lw, u, st


def _check_scan(jfn, fn, chunk, S):
    args = _wkv_inputs(S)
    want_y, want_st = jfn(*map(jnp.asarray, args), chunk)
    got_y, got_st = fn(*map(torch.from_numpy, args), chunk)
    lp.assert_close(got_y.numpy(), np.asarray(want_y), what=f"y chunk {chunk}")
    lp.assert_close(got_st.numpy(), np.asarray(want_st), what=f"state chunk {chunk}")


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 32, 48])
def test_wkv_chunked(chunk):
    _check_scan(jrwkv6.wkv_chunked, rwkv6.wkv_chunked, chunk, 32)


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16])
def test_wkv_chunked_factored(chunk):
    _check_scan(jrwkv6.wkv_chunked_factored, rwkv6.wkv_chunked_factored, chunk, 32)


def test_the_chunk_is_recomputed_and_must_divide():
    """S = 24 at chunk 16: one chunk of 24 (``chunk = S // nchunks``), and
    S = 40: two of 20, as in JAX; S = 35 would split into two of 17 and
    leave one position out, which JAX's reshape refuses and the port too."""
    _check_scan(jrwkv6.wkv_chunked, rwkv6.wkv_chunked, 16, 24)
    _check_scan(jrwkv6.wkv_chunked, rwkv6.wkv_chunked, 16, 40)
    with pytest.raises(ValueError, match="cannot split"):
        rwkv6.wkv_chunked(*[torch.from_numpy(a) for a in _wkv_inputs(35)], 16)
    with pytest.raises(TypeError):
        jrwkv6.wkv_chunked(*map(jnp.asarray, _wkv_inputs(35)), 16)


def test_factored_form_refuses_a_long_chunk():
    args = [torch.from_numpy(a) for a in _wkv_inputs(34)]
    with pytest.raises(ValueError, match="chunk\\*clamp"):
        rwkv6.wkv_chunked_factored(*args, 17)
    with pytest.raises(AssertionError):
        jrwkv6.wkv_chunked_factored(*map(jnp.asarray, _wkv_inputs(34)), 17)


def test_wkv_step_continues_the_scan():
    args = _wkv_inputs(1)
    want_y, want_st = jrwkv6.wkv_step(*map(jnp.asarray, args))
    got_y, got_st = rwkv6.wkv_step(*map(torch.from_numpy, args))
    lp.assert_close(got_y.numpy(), np.asarray(want_y), what="step y")
    lp.assert_close(got_st.numpy(), np.asarray(want_st), what="step state")
    # a step from the scan's state equals one more scanned position
    full = [torch.from_numpy(a) for a in _wkv_inputs(9, seed=5)]
    y9, _ = rwkv6.wkv_chunked(*full, 9)
    y8, st8 = rwkv6.wkv_chunked(*[a[:, :8] for a in full[:4]], full[4], full[5], 8)
    y1, _ = rwkv6.wkv_step(*[a[:, 8:9] for a in full[:4]], full[4], st8)
    lp.assert_close(y1.numpy(), y9[:, 8:9].numpy(), what="step after scan")


@pytest.mark.parametrize("factored", [False, True])
def test_time_mix_decay_clamp(factored):
    """time_mix's clamp of wx to [-8, 1] ([-8, log 4] factored) and of
    log w to >= -4, on inputs large enough to reach both ends."""
    jcfg, cfg = (dataclasses.replace(c, wkv_factored=factored)
                 for c in lp.configs(ARCH, "float32"))
    r = np.random.default_rng(6)
    D = cfg.d_model
    p = {k: r.normal(size=s).astype(np.float32) for k, s in (
        ("mix", (5, D)), ("wr", (D, D)), ("wk", (D, D)), ("wv", (D, D)),
        ("wg", (D, D)), ("ww", (D, D)), ("w_bias", (D,)), ("u", (D,)),
        ("wo", (D, D)), ("ln_w", (D,)))}
    p["ww"] *= 2.0                                      # wx spans past [-8, 1.39]
    x = r.normal(size=(2, 16, D)).astype(np.float32)
    last = r.normal(size=(2, 1, D)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, (wl, wst) = jrwkv6.time_mix(jp, jnp.asarray(x), jcfg, jnp.asarray(last), None)
    got, (gl, gst) = rwkv6.time_mix(lp.to_torch(p), torch.from_numpy(x), cfg,
                                    torch.from_numpy(last), None)
    lp.assert_close(got.numpy(), np.asarray(want), what="time_mix")
    lp.assert_close(gst.numpy(), np.asarray(wst), what="time_mix state")
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("dtype", lp.DTYPES)
def test_logits(refs, dtype):
    lp.check_logits(refs, ARCH, dtype)


@pytest.mark.parametrize("dtype", lp.DTYPES)
def test_loss(refs, dtype):
    lp.check_loss(refs, ARCH, dtype)


@pytest.mark.parametrize("dtype", lp.DTYPES)
def test_cached_decode(refs, dtype):
    lp.check_decode(refs, ARCH, dtype)


def test_factored_config_logits_and_decode(refs):
    """The full config's ``wkv_factored=True`` at SMOKE size, f32: the
    factored scan over the forward, and the decode steps of the same
    weights, against JAX with the flag set."""
    ref = refs(ARCH, "float32")
    jcfg, cfg = (dataclasses.replace(c, wkv_factored=True)
                 for c in lp.configs(ARCH, "float32"))
    import jax
    from repro.models import layers as jnn, rwkv_model as jrwkv
    params = lp.to_torch(ref["params"])
    jp = jax.tree.map(jnp.asarray, ref["params"])
    toks = ref["inputs"]["tokens"][:, :-1]
    h, _ = jax.jit(lambda p, t: jrwkv.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    want = np.asarray(jnn.lm_logits(jp, h, jcfg))
    got = lp.port_logits(cfg, params, ref["inputs"]).numpy()
    lp.assert_close(got, want, what="factored logits")
    # cached decode of the same stream reproduces the uncached logits
    state = rwkv_model.init_state(cfg, lp.B, "cpu")
    with torch.no_grad():
        for t in range(lp.S):
            logits, state = rwkv_model.decode_logits(
                params, state, torch.from_numpy(toks[:, t:t + 1]), cfg)
            lp.assert_close(logits.numpy()[:, 0], want[:, t], what=f"factored step {t}")


def test_full_config_is_factored():
    assert SMOKE[ARCH].wkv_factored is False
    from repro_torch.configs import ARCHS
    assert ARCHS[ARCH].wkv_factored is True
