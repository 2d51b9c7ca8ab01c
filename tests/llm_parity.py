"""Shared helpers of the LLM parity tests (``tests/test_torch_llm_*.py``):
the JAX package's SMOKE models against the port's on the CPU, from the same
parameters (JAX's, carried across with ``params_from_numpy``) and inputs
made from a seed with numpy.

Each arch is run in float32 (``dataclasses.replace(cfg, dtype="float32")``)
and in the config's bfloat16.  Bounds on max|got - ref| (``bound``):
  * float32: ``F32_TOL * max(1, max|ref|)``, F32_TOL = 1e-4;
  * bfloat16: twice bf16's own rounding error on the same quantity as JAX
    measures it, 2 * max|ref_bf16 - ref_f32| (JAX's bf16 and f32 runs of
    the same parameters and inputs), at least one unit of bf16 rounding,
    2**-8 * max(1, max|ref|).  The two frameworks round the bf16 stream at
    different points (XLA may keep excess precision inside a fusion); if
    each lies within bf16's error of the f32 result, they lie within twice
    it of each other.
Tokens are compared where the reference's top-2 margin exceeds the bound.
The JAX side runs under ``jax.jit``, once per arch and dtype
(``References``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import SMOKE as JAX_SMOKE
from repro.models import layers as jnn
from repro.models import rwkv_model as jrwkv
from repro.models import transformer as jtr
from repro.models import whisper as jwhisper
from repro.models import zamba as jzamba
from repro.models.api import get_model as jax_get_model
from repro_torch.configs import SMOKE
from repro_torch.models import base, layers as nn
from repro_torch.models import rwkv_model, transformer, whisper, zamba
from repro_torch.models.api import get_model

F32_TOL = 1e-4
BF16_UNIT = 2.0 ** -8
DTYPES = ("float32", "bfloat16")

B, S = 2, 8           # batch, sequence (tokens carry S + 1: inputs and labels)
MAX_SEQ = 16          # decode caches
STEPS = 4             # decode steps
PARAM_SEED = 0


def configs(arch: str, dtype: str):
    """(JAX config, port config) of a SMOKE arch at ``dtype``."""
    return (dataclasses.replace(JAX_SMOKE[arch], dtype=dtype),
            dataclasses.replace(SMOKE[arch], dtype=dtype))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return base.params_from_numpy(tree, "cpu")


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.is_floating_point() else t.numpy()


def bound(ref, ref32=None) -> float:
    """The bound on max|got - ref| (module docstring): ``ref32`` is the f32
    reference of a bf16 ``ref``, None for an f32 one."""
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    if ref32 is None:
        return F32_TOL * scale
    own = float(np.max(np.abs(ref - np.asarray(ref32, np.float64)))) if ref.size else 0.0
    return max(2.0 * own, BF16_UNIT * scale)


def assert_close(got, ref, ref32=None, what: str = ""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, lim = float(np.max(np.abs(got - ref))) if ref.size else 0.0, bound(ref, ref32)
    assert err <= lim, f"{what}: max|diff| {err:.3e} > {lim:.3e}"


def assert_tokens(got, ref_logits, lim: float, what: str = ""):
    """argmax tokens equal the reference's wherever its top-2 margin exceeds
    ``lim``; returns how many positions fell under it."""
    ref_logits = np.asarray(ref_logits, np.float64)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    want = np.argmax(ref_logits, axis=-1)
    sure = margin > lim
    got = np.asarray(got).reshape(want.shape)
    assert np.array_equal(got[sure], want[sure]), f"{what}: tokens differ"
    return int((~sure).sum())


def make_inputs(cfg, seed: int = 1) -> Dict[str, np.ndarray]:
    """Tokens (B, S+1) and, per family, frames / image embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)}
    if cfg.family == "whisper":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.normal(
            size=(B, cfg.n_img_patches, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# The JAX side, once per arch and dtype
# ---------------------------------------------------------------------------
def _jax_full(jcfg):
    """One jitted fn(params, inputs) for the full-sequence references: the
    family's logits, loss_fn's value and parts, and prefill (transformer:
    logits and caches; whisper: the encoder K/V caches)."""
    fam = jcfg.family
    model = jax_get_model(jcfg)

    def f(p, inp):
        toks = inp["tokens"][:, :-1]
        if fam in ("dense", "moe", "vlm"):
            h, _, _ = jtr.forward(p, toks, jcfg, img_embeds=inp.get("img_embeds"))
        elif fam == "rwkv":
            h, _ = jrwkv.forward(p, toks, jcfg)
        elif fam == "hybrid":
            h, _, _ = jzamba.forward(p, toks, jcfg)
        else:
            h = jwhisper.decode_train(p, toks, jwhisper.encode(p, inp["frames"], jcfg), jcfg)
        loss, parts = model.loss_fn(p, inp)
        out = {"logits": jnn.lm_logits(p, h, jcfg).astype(jnp.float32),
               "loss": loss, "loss_parts": parts}
        if fam in ("dense", "moe", "vlm"):
            logits, caches = jtr.prefill(p, inp["tokens"][:, :S], jcfg, MAX_SEQ)
            out["prefill"] = {"logits": logits.astype(jnp.float32), "caches": caches}
        if fam == "whisper":
            out["caches0"] = jwhisper.prefill(p, inp["frames"], jcfg, B, MAX_SEQ)
        return out
    return jax.jit(f)


def _jax_decode(jcfg):
    """One cached decode step as jitted fn(params, caches, token, pos) ->
    (logits or None, next token, caches)."""
    fam = jcfg.family
    if fam in ("dense", "moe", "vlm", "hybrid"):
        mod = jtr if fam != "hybrid" else jzamba

        def f(p, c, tok, pos):
            positions = jnp.broadcast_to(pos[None, None], (tok.shape[0], 1)).astype(jnp.int32)
            h, c2, _ = mod.forward(p, tok, jcfg, caches=c, positions=positions)
            logits = jnn.lm_logits(p, h, jcfg)
            return logits, jnp.argmax(logits, -1).astype(jnp.int32), c2
    elif fam == "rwkv":
        def f(p, c, tok, pos):
            h, c2 = jrwkv.forward(p, tok, jcfg, state=c)
            logits = jnn.lm_logits(p, h, jcfg)
            return logits, jnp.argmax(logits, -1).astype(jnp.int32), c2
    else:
        def f(p, c, tok, pos):
            nxt, c2 = jwhisper.decode_step(p, c, tok, jcfg, pos)
            return None, nxt, c2
    return jax.jit(f)


def jax_reference(arch: str, dtype: str) -> dict:
    """Everything the port is held to, for one arch and dtype: the JAX
    parameters and inputs (numpy), full-sequence logits, loss_fn's value
    and parts, STEPS teacher-forced decode steps (logits, tokens, caches
    after each), and prefill's logits and caches (transformer families;
    whisper's prefill makes the decode's first caches)."""
    jcfg, _ = configs(arch, dtype)
    params = jax_get_model(jcfg).init_params(jax.random.PRNGKey(PARAM_SEED))
    inp = make_inputs(jcfg)
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    full = _jax_full(jcfg)(params, jinp)
    ref = {"params": to_numpy(params), "inputs": inp, "logits": np.asarray(full["logits"]),
           "loss": float(full["loss"]),
           "loss_parts": {k: float(v) for k, v in full["loss_parts"].items()}}
    if "prefill" in full:
        ref["prefill"] = to_numpy(full["prefill"])
    fam = jcfg.family
    caches = (full["caches0"] if fam == "whisper"
              else jrwkv.init_state(jcfg, B) if fam == "rwkv"
              else jzamba.init_caches(jcfg, B, MAX_SEQ) if fam == "hybrid"
              else jtr.init_caches(jcfg, B, MAX_SEQ))
    ref["caches0"] = to_numpy(caches)
    step = _jax_decode(jcfg)
    steps = []
    for t in range(STEPS):
        logits, nxt, caches = step(params, caches, jinp["tokens"][:, t:t + 1],
                                   jnp.asarray(t, jnp.int32))
        steps.append({"logits": None if logits is None
                      else np.asarray(logits.astype(jnp.float32)),
                      "token": np.asarray(nxt), "caches": to_numpy(caches)})
    ref["steps"] = steps
    return ref


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------
_DECODE = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "hybrid": zamba, "rwkv": rwkv_model, "whisper": whisper}


def port_logits(cfg, params, inp):
    tokens = torch.from_numpy(inp["tokens"][:, :-1])
    fam = cfg.family
    with torch.no_grad():
        if fam in ("dense", "moe", "vlm"):
            img = inp.get("img_embeds")
            h, _, _ = transformer.forward(
                params, tokens, cfg,
                img_embeds=None if img is None else torch.from_numpy(img))
        elif fam == "rwkv":
            h, _ = rwkv_model.forward(params, tokens, cfg)
        elif fam == "hybrid":
            h, _, _ = zamba.forward(params, tokens, cfg)
        else:
            enc = whisper.encode(params, torch.from_numpy(inp["frames"]), cfg)
            h = whisper.decode_train(params, tokens, enc, cfg)
        return nn.lm_logits(params, h, cfg)


def port_loss(cfg, params, inp):
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        loss, parts = get_model(cfg).loss_fn(params, batch)
    return float(loss), {k: float(v) for k, v in parts.items()}


def port_decode(cfg, params, caches, inp):
    """STEPS teacher-forced steps through the family's ``decode_logits``;
    per step (logits, token, a numpy copy of the caches)."""
    mod = _DECODE[cfg.family]
    tokens = torch.from_numpy(inp["tokens"])
    out = []
    with torch.no_grad():
        for t in range(STEPS):
            logits, caches = mod.decode_logits(params, caches, tokens[:, t:t + 1], cfg, t)
            out.append({"logits": as_numpy(logits),
                        "token": torch.argmax(logits, -1).to(torch.int32).numpy(),
                        "caches": base.tree_map(lambda a: as_numpy(a).copy(), caches)})
    return out


def _f32(a):
    return np.asarray(a).astype(np.float32)


def check_tree(got, ref, ref32, what: str):
    """Every leaf of a numpy cache tree within its bound (ints equal)."""
    leaves32 = dict(base.named_leaves(ref32)) if ref32 is not None else {}
    names = [n for n, _ in base.named_leaves(ref)]
    assert [n for n, _ in base.named_leaves(got)] == names, what
    for (name, g), (_, r) in zip(base.named_leaves(got), base.named_leaves(ref)):
        r = np.asarray(r)
        if r.dtype.kind in "iu":
            np.testing.assert_array_equal(np.asarray(g), r, err_msg=f"{what} {name}")
        else:
            r32 = _f32(leaves32[name]) if ref32 is not None else None
            assert_close(g, _f32(r), r32, f"{what} {name}")


class References:
    """JAX references per (arch, dtype), computed on first use (one per
    test module, held by a module-scoped fixture)."""

    def __init__(self):
        self._refs = {}

    def __call__(self, arch: str, dtype: str) -> dict:
        if (arch, dtype) not in self._refs:
            self._refs[arch, dtype] = jax_reference(arch, dtype)
        return self._refs[arch, dtype]

    def pair(self, arch: str, dtype: str):
        """(reference, its f32 twin or None for f32)."""
        return self(arch, dtype), (self(arch, "float32") if dtype != "float32" else None)


def _get(ref, *keys):
    for k in keys:
        ref = None if ref is None else ref[k]
    return ref


def check_logits(refs: References, arch: str, dtype: str):
    ref, ref32 = refs.pair(arch, dtype)
    _, cfg = configs(arch, dtype)
    got = as_numpy(port_logits(cfg, to_torch(ref["params"]), ref["inputs"]))
    assert_close(got, ref["logits"], _get(ref32, "logits"), f"{arch} {dtype} logits")


def check_loss(refs: References, arch: str, dtype: str):
    ref, ref32 = refs.pair(arch, dtype)
    _, cfg = configs(arch, dtype)
    loss, parts = port_loss(cfg, to_torch(ref["params"]), ref["inputs"])
    assert parts.keys() == ref["loss_parts"].keys()
    assert_close(loss, ref["loss"], _get(ref32, "loss"), f"{arch} {dtype} loss")
    for k, v in parts.items():
        assert_close(v, ref["loss_parts"][k], _get(ref32, "loss_parts", k),
                     f"{arch} {dtype} loss {k}")


def check_decode(refs: References, arch: str, dtype: str) -> int:
    """STEPS teacher-forced cached decode steps from JAX's first caches:
    each step's logits, tokens (where the margin allows) and caches.
    Returns the token positions under the margin."""
    ref, ref32 = refs.pair(arch, dtype)
    _, cfg = configs(arch, dtype)
    steps = port_decode(cfg, to_torch(ref["params"]), to_torch(ref["caches0"]),
                        ref["inputs"])
    under = 0
    for t, (got, want) in enumerate(zip(steps, ref["steps"])):
        want32 = _get(ref32, "steps", t)
        what = f"{arch} {dtype} step {t}"
        if want["logits"] is None:       # whisper: JAX's decode_step gives tokens
            if dtype == "float32":
                np.testing.assert_array_equal(got["token"], want["token"], err_msg=what)
        else:
            assert_close(got["logits"], want["logits"], _get(want32, "logits"), what)
            under += assert_tokens(got["token"], want["logits"],
                                   bound(want["logits"], _get(want32, "logits")), what)
        check_tree(got["caches"], want["caches"], _get(want32, "caches"),
                   f"{what} caches")
    return under


def check_prefill(refs: References, arch: str, dtype: str):
    ref, ref32 = refs.pair(arch, dtype)
    _, cfg = configs(arch, dtype)
    with torch.no_grad():
        logits, caches = transformer.prefill(
            to_torch(ref["params"]), torch.from_numpy(ref["inputs"]["tokens"][:, :S]),
            cfg, MAX_SEQ)
    want = ref["prefill"]
    assert_close(as_numpy(logits), want["logits"], _get(ref32, "prefill", "logits"),
                 f"{arch} {dtype} prefill logits")
    check_tree(base.tree_map(as_numpy, caches), want["caches"],
               _get(ref32, "prefill", "caches"), f"{arch} {dtype} prefill caches")
