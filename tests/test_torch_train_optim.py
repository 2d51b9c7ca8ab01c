"""The port's AdamW (``repro_torch.optim.adamw``) and int8 gradient
compression (``repro_torch.parallel.compress``) against the JAX package's
on the CPU, from the same numpy inputs.

AdamW: three updates from the same params, grads and state, with and
without clipping, under the cosine and constant schedules: params, m, v,
``lr`` and ``grad_norm`` within 1e-6 relative (max|got - ref| over
max|ref|, leaf by leaf); ``lr_at`` over steps 0..200; the four ways JAX's
formula is not ``torch.optim.AdamW``'s.  Compression: fed JAX's own
uniforms, ``_quantize_with`` gives JAX's int8 values and scales; the port's
own noise is unbiased and within one quantum per element."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.parallel import compress as jcompress
from repro_torch.models import base
from repro_torch.optim import adamw
from repro_torch.parallel import compress
from torch_threads import one_intra_op_thread  # noqa: F401

REL = 1e-6


def _tree(rng, scale=1.0):
    """A nested parameter-like tree of float32 leaves (stacked, matrix,
    vector), keys out of sorted order."""
    return {"w_out": (scale * rng.normal(size=(6, 5))).astype(np.float32),
            "blocks": {"wq": (scale * rng.normal(size=(3, 4, 5))).astype(np.float32),
                       "ln": (1.0 + scale * rng.normal(size=(3, 4))).astype(np.float32)},
            "bias": (scale * rng.normal(size=(7,))).astype(np.float32)}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, ref, what, rel=REL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rel * max(scale, 1e-30), f"{what}: max|diff| {err:.3e} > {rel} * {scale:.3e}"


def _close_tree(got, ref, what):
    names = [n for n, _ in base.named_leaves(ref)]
    assert [n for n, _ in base.named_leaves(got)] == names
    for (name, g), (_, r) in zip(base.named_leaves(got), base.named_leaves(ref)):
        _close(g.numpy() if isinstance(g, torch.Tensor) else g, r, f"{what} {name}")


CONFIGS = {
    "cosine-clip": jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5),
    "cosine-noclip": jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                                        clip_norm=None),
    "constant-clip": jadamw.AdamWConfig(lr=3e-3, warmup_steps=4, schedule="constant"),
    "constant-noclip": jadamw.AdamWConfig(lr=3e-3, warmup_steps=4, schedule="constant",
                                          clip_norm=None),
}


def _port_cfg(jcfg):
    return adamw.AdamWConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("start", ["init", "state"])
def test_apply_matches_jax(name, start):
    """Three updates; the grads' global norm (~6-9) is above clip_norm 1,
    so the clipped configs clip every update.  ``start="state"`` starts
    both from the same nonzero moments at step 7."""
    jcfg = CONFIGS[name]
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    if start == "init":
        jstate = jadamw.init(_jtree(params))
    else:
        m, v = _tree(rng, 0.1), jax.tree.map(np.abs, _tree(rng, 0.01))
        jstate = jadamw.AdamWState(jnp.asarray(7, jnp.int32), _jtree(m), _jtree(v))
    state = adamw.state_from_numpy(jax.tree.map(np.asarray, tuple(jstate)), "cpu")
    jp, p = _jtree(params), base.params_from_numpy(params, "cpu")
    for i in range(3):
        grads = _tree(rng)
        jp, jstate, jm = jadamw.apply(jcfg, _jtree(grads), jstate, jp)
        p, state, m = adamw.apply(cfg, base.params_from_numpy(grads, "cpu"), state, p)
        what = f"{name} {start} update {i}"
        assert int(state.step) == int(jstate.step)
        assert state.step.dtype == torch.int32 and state.step.device.type == "cpu"
        _close(m["lr"], float(jm["lr"]), f"{what} lr")
        _close(float(m["grad_norm"]), float(jm["grad_norm"]), f"{what} grad_norm")
        _close_tree(p, jax.tree.map(np.asarray, jp), f"{what} params")
        _close_tree(state.m, jax.tree.map(np.asarray, jstate.m), f"{what} m")
        _close_tree(state.v, jax.tree.map(np.asarray, jstate.v), f"{what} v")


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("warmup,total", [(0, 100), (1, 50), (10, 200), (100, 150)])
def test_lr_at_matches_jax(schedule, warmup, total):
    jcfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total,
                              schedule=schedule)
    cfg = _port_cfg(jcfg)
    steps = np.arange(0, 201)
    want = np.asarray(jax.vmap(lambda s: jadamw.lr_at(jcfg, s))(jnp.asarray(steps, jnp.int32)))
    got = np.array([adamw.lr_at(cfg, int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert adamw.lr_at(cfg, torch.tensor(5, dtype=torch.int32)) == got[5]


def test_first_update_runs_at_twice_the_first_warmup_rate():
    """``apply`` raises the step to 1 before the schedule, whose warm-up
    reads step + 1: the first update runs at lr * 2 / warmup_steps."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=10, schedule="constant")
    p = {"w": torch.ones(3)}
    _, state, m = adamw.apply(cfg, {"w": torch.ones(3)}, adamw.init(p), p)
    assert m["lr"] == pytest.approx(1e-2 * 2 / 10, rel=1e-6)
    assert int(state.step) == 1


def test_weight_decay_joins_the_adam_direction_on_every_leaf():
    """With zero grads the Adam direction is 0 and each leaf (a norm's
    ones included) moves by -lr * wd * p; ``torch.optim.AdamW`` decays by
    lr * wd too, but with its own step count and bias corrections it moves
    a nonzero-grad leaf differently (checked on the same update)."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.1, clip_norm=None,
                            schedule="constant")
    p = {"ln": torch.ones(4), "w": torch.full((2, 2), 3.0)}
    adamw.apply(cfg, {"ln": torch.zeros(4), "w": torch.zeros(2, 2)}, adamw.init(p), p)
    np.testing.assert_allclose(p["ln"].numpy(), 1.0 - 1e-2 * 0.1, rtol=1e-6)
    np.testing.assert_allclose(p["w"].numpy(), 3.0 - 1e-2 * 0.1 * 3.0, rtol=1e-6)
    # the same one update against torch.optim.AdamW: different numbers
    g = torch.linspace(-1, 1, 5)
    ours = {"w": torch.ones(5)}
    cfg2 = adamw.AdamWConfig(lr=1e-2, warmup_steps=10, clip_norm=None, schedule="constant")
    adamw.apply(cfg2, {"w": g}, adamw.init(ours), ours)
    theirs = torch.ones(5, requires_grad=True)
    opt = torch.optim.AdamW([theirs], lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    theirs.grad = g.clone()
    opt.step()
    assert np.abs(ours["w"].numpy() - theirs.detach().numpy()).max() > 1e-3


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    g = _tree(rng, 4.0)
    jg, jn = jadamw.clip_by_global_norm(_jtree(g), 1.0)
    pg, pn = adamw.clip_by_global_norm(base.params_from_numpy(g, "cpu"), 1.0)
    _close(float(pn), float(jn), "norm")
    _close_tree(pg, jax.tree.map(np.asarray, jg), "clipped")
    _close(float(adamw.global_norm(pg)), 1.0, "norm after clipping", rel=1e-5)
    # below the limit nothing moves
    small = base.params_from_numpy(jax.tree.map(lambda a: 1e-3 * a, _tree(rng)), "cpu")
    same, _ = adamw.clip_by_global_norm(small, 1.0)
    for (_, a), (_, b) in zip(base.named_leaves(same), base.named_leaves(small)):
        assert torch.equal(a, b)


def test_apply_is_in_place_and_keeps_grads():
    """``apply`` writes params, m and v in place (JAX donates them) and
    leaves the grads as they were; the moments are float32 for a bf16 leaf."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    p = {"a": torch.ones(4), "b": torch.ones(3, dtype=torch.bfloat16)}
    state = adamw.init(p)
    assert state.m["b"].dtype == torch.float32 and state.v["b"].dtype == torch.float32
    grads = {"a": torch.full((4,), 5.0), "b": torch.full((3,), 5.0, dtype=torch.bfloat16)}
    keep = {k: v.clone() for k, v in grads.items()}
    ptr = {k: v.data_ptr() for k, v in p.items()}
    out, state2, _ = adamw.apply(cfg, grads, state, p)
    assert all(out[k].data_ptr() == ptr[k] for k in p) and out["b"].dtype == torch.bfloat16
    assert state2.m is state.m and float(state.m["a"].abs().max()) > 0
    assert all(torch.equal(grads[k], keep[k]) for k in grads)
    assert float((p["a"] - 1).abs().max()) > 0


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------
SHAPES = [(17,), (4, 33), (3, 8, 9), (2, 2, 2, 50)]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("scale", [1e-4, 1.0, 300.0])
def test_quantize_with_jax_uniforms_matches_jax(seed, scale):
    """JAX's ``_quantize`` on its split keys against the port's
    ``_quantize_with`` fed ``jax.random.uniform`` of the same keys."""
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(SHAPES))
    for key, shape in zip(keys, SHAPES):
        x = (scale * rng.normal(size=shape)).astype(np.float32)
        jq, js = jcompress._quantize(jnp.asarray(x), key)
        rnd = np.array(jax.random.uniform(key, shape))
        q, s = compress._quantize_with(torch.from_numpy(x), torch.from_numpy(rnd))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        deq = compress._dequantize(q, s).numpy()
        np.testing.assert_array_equal(deq, np.asarray(jcompress._dequantize(jq, js)))


def test_fake_quantize_tree_within_one_quantum_like_jax():
    rng = np.random.default_rng(2)
    g = _tree(rng, 0.5)
    port = compress.fake_quantize_tree(base.params_from_numpy(g, "cpu"))
    jax_out = jcompress.fake_quantize_tree(_jtree(g))
    for (name, a), (_, b), (_, ref) in zip(base.named_leaves(port),
                                           base.named_leaves(jax.tree.map(np.asarray, jax_out)),
                                           base.named_leaves(g)):
        quantum = (np.abs(ref).max() + 1e-12) / 127.0
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - ref).max() <= quantum * (1 + 1e-6), name
        assert np.abs(b - ref).max() <= quantum * (1 + 1e-6), name
        # both land on the grid of multiples of the quantum
        np.testing.assert_allclose(a.numpy() / quantum, np.round(a.numpy() / quantum),
                                   atol=1e-3)


def test_fake_quantize_tree_same_noise_every_call_and_dtype_kept():
    g = {"a": torch.linspace(-1, 1, 101), "b": torch.linspace(0, 3, 50).to(torch.bfloat16)}
    one, two = compress.fake_quantize_tree(g), compress.fake_quantize_tree(g)
    other = compress.fake_quantize_tree(g, seed=1)
    assert all(torch.equal(one[k], two[k]) for k in g)
    assert not torch.equal(one["a"], other["a"])
    assert one["b"].dtype == torch.bfloat16


def test_fake_quantize_tree_is_unbiased():
    """Over 400 seeds the mean of the rounded values approaches the input:
    each element's rounding error has mean 0 and std <= quantum / 2."""
    n = 400
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(256,)).astype(np.float32))
    quantum = float((x.abs().max() + 1e-12) / 127.0)
    acc = torch.zeros_like(x, dtype=torch.float64)
    for seed in range(n):
        acc += compress.fake_quantize_tree({"g": x}, seed=seed)["g"].double()
    err = (acc / n - x.double()).numpy()
    sigma = quantum / 2 / np.sqrt(n)
    assert np.abs(err).max() <= 5 * sigma
    assert abs(err.mean()) <= 5 * sigma / np.sqrt(x.numel())
