"""The port's dense and VLM transformers (``repro_torch.models.layers`` /
``transformer``) against the JAX package's on the CPU: the traps a literal
port falls into (``jnp.repeat`` is ``repeat_interleave``, ``jnp.var`` has
ddof 0, ``jax.nn.gelu`` is the tanh form, RoPE rotates halves, the decode
cache write clamps its slot, query-chunked attention with several chunks),
then per SMOKE arch and dtype the logits, ``loss_fn``, four cached decode
steps and ``prefill`` from JAX's parameters (bounds: ``llm_parity``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro.configs.registry import SMOKE as JAX_SMOKE
from repro.models import layers as jnn
from repro_torch.configs import SMOKE
from repro_torch.models import layers as nn
from torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = ["llama3.2-1b", "glm4-9b", "deepseek-7b", "tinyllama-1.1b", "internvl2-2b"]
CASES = [(a, d) for a in ARCHS for d in lp.DTYPES]


@pytest.fixture(scope="module")
def refs():
    return lp.References()


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_expand_kv_is_repeat_interleave():
    """KV head j serves query heads j*g .. j*g+g-1 (``jnp.repeat``), which
    the decode path's (B,1,KVH,g,hd) grouping relies on; ``.repeat`` would
    tile the heads instead."""
    k = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    got = nn._expand_kv(torch.from_numpy(k), 12).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnn._expand_kv(jnp.asarray(k), 12)))
    assert not np.array_equal(got, torch.from_numpy(k).repeat(1, 1, 3, 1).numpy())


def test_layernorm_variance_has_ddof_0():
    x = _rng().normal(size=(2, 3, 16)).astype(np.float32)
    w = _rng(1).normal(size=16).astype(np.float32)
    b = _rng(2).normal(size=16).astype(np.float32)
    want = np.asarray(jnn.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = nn.layernorm(*map(torch.from_numpy, (x, w, b))).numpy()
    lp.assert_close(got, want, what="layernorm")
    # the unbiased variance is off by far more than the bound
    var1 = torch.from_numpy(x).var(-1, keepdim=True)
    y1 = (torch.from_numpy(x) - torch.from_numpy(x).mean(-1, keepdim=True)) * torch.rsqrt(var1 + 1e-5)
    assert np.abs((y1 * torch.from_numpy(w) + torch.from_numpy(b)).numpy() - want).max() > 1e-3


def test_gelu_is_the_tanh_form():
    """Whisper's MLP: ``jax.nn.gelu`` defaults to the tanh approximation.
    With wi = [I 0] and wd = [I; 0] the MLP returns gelu(x) itself."""
    cfg = dataclasses.replace(JAX_SMOKE["whisper-base"], dtype="float32")
    eye = np.eye(64, 128, dtype=np.float32)
    p = {"wi": eye, "wd": eye.T.copy()}
    x = np.linspace(-4, 4, 2 * 5 * 64, dtype=np.float32).reshape(2, 5, 64)
    want = np.asarray(jnn.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg))
    got = nn.mlp(lp.to_torch(p), torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("dtype", lp.DTYPES)
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_rotates_halves(dtype, theta):
    x = _rng().normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) * 3, (2, 7)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = jnn.rope(jx, jnp.asarray(pos), theta)
    assert want.dtype == jx.dtype
    got = nn.rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        lp.assert_close(lp.as_numpy(got), want, what="rope")
    else:   # the f32 tables, one cast at the end: within one bf16 rounding
        lp.assert_close(lp.as_numpy(got), want, want, what="rope bf16")


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_several_chunks(causal):
    """Sq = 24 at a target chunk of 8 (3 chunks) and of 10 (_even_chunk
    picks 8), against JAX's ``lax.map`` over the same chunks."""
    r = _rng()
    q, k, v = (r.normal(size=(2, 24, 4, 16)).astype(np.float32) for _ in range(3))
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    for chunk in (8, 10, 24):
        want = np.asarray(jnn._chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                                 causal, chunk))
        got = nn._chunked_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                    causal, chunk).numpy()
        lp.assert_close(got, want, what=f"attention chunk {chunk}")
    assert nn._even_chunk(3840, 512) == 480 and nn._even_chunk(24, 10) == 8


@pytest.mark.parametrize("pos", [3, 15, 18])
def test_decode_cache_write_clamps(pos):
    """The decode write lands at the cache's own ``pos`` clamped into
    [0, Sk-1] (``dynamic_update_slice``), the mask keeps keys <= pos
    unclamped, and RoPE uses the step's ``positions``."""
    jcfg, cfg = lp.configs("llama3.2-1b", "float32")
    r = _rng()
    p = {n: r.normal(size=s).astype(np.float32) / 8 for n, s in
         (("wq", (64, 4, 16)), ("wk", (64, 2, 16)), ("wv", (64, 2, 16)), ("wo", (4, 16, 64)))}
    x = r.normal(size=(2, 1, 64)).astype(np.float32)
    kc = r.normal(size=(2, 16, 2, 16)).astype(np.float32)
    vc = r.normal(size=(2, 16, 2, 16)).astype(np.float32)
    positions = np.full((2, 1), pos + 5, np.int32)
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc), "pos": jnp.asarray(pos, jnp.int32)}
    y, c = jnn.attention({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jcfg,
                         jnp.asarray(positions), cache=jcache)
    cache = lp.to_torch({"k": kc, "v": vc, "pos": np.asarray(pos, np.int32)})
    got, c2 = nn.attention(lp.to_torch(p), torch.from_numpy(x), cfg,
                           torch.from_numpy(positions), cache=cache)
    lp.assert_close(got.numpy(), np.asarray(y), what="decode attention")
    for name in ("k", "v"):
        lp.assert_close(c2[name].numpy(), np.asarray(c[name]), what=name)
        assert c2[name] is cache[name]                 # written in place
    assert int(c2["pos"]) == int(c["pos"]) == pos + 1
    slot = min(pos, 15)
    changed = np.flatnonzero(np.abs(c2["k"].numpy() - kc).sum(axis=(0, 2, 3)))
    assert changed.tolist() == [slot]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_logits(refs, arch, dtype):
    lp.check_logits(refs, arch, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_loss(refs, arch, dtype):
    lp.check_loss(refs, arch, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_cached_decode(refs, arch, dtype):
    lp.check_decode(refs, arch, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill(refs, arch, dtype):
    lp.check_prefill(refs, arch, dtype)


def test_vlm_prepends_the_image(refs):
    """internvl2's logits cover the P image positions before the text, and
    loss_fn scores the text positions alone (checked against JAX above);
    the forward without image embeds is the text-only decoder."""
    ref = refs("internvl2-2b", "float32")
    P = SMOKE["internvl2-2b"].n_img_patches
    assert ref["logits"].shape[1] == P + lp.S
    _, cfg = lp.configs("internvl2-2b", "float32")
    text = dict(ref["inputs"])
    del text["img_embeds"]
    assert lp.port_logits(cfg, lp.to_torch(ref["params"]), text).shape[1] == lp.S
