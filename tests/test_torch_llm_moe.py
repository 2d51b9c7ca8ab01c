"""The port's MoE layer and MoE transformers (``repro_torch.models.moe``)
against the JAX package's on the CPU: top-k ties broken toward the lower
index (``lax.top_k``), tokens over capacity dropped (``jax.nn.one_hot``
gives a zero row for a slot >= cap, where ``F.one_hot`` would raise), the
grouped dispatch, then per SMOKE arch and dtype the logits, ``loss_fn`` (the
Switch aux loss included), four cached decode steps and ``prefill`` from
JAX's parameters (bounds: ``llm_parity``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro.models import moe as jmoe
from repro_torch.models import moe
from torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b"]
CASES = [(a, d) for a in ARCHS for d in lp.DTYPES]


@pytest.fixture(scope="module")
def refs():
    return lp.References()


def _layer(cfg, seed=0, router=None):
    r = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": r.normal(size=(D, E)).astype(np.float32) * 0.1 / np.sqrt(D),
         "wg": r.normal(size=(E, D, F)).astype(np.float32) / np.sqrt(D),
         "wu": r.normal(size=(E, D, F)).astype(np.float32) / np.sqrt(D),
         "wd": r.normal(size=(E, F, D)).astype(np.float32) / np.sqrt(F)}
    if router is not None:
        p["router"] = router
    return p


def _both(cfg, p, x):
    want_y, want_aux = jmoe.moe_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), cfg)
    got_y, got_aux = moe.moe_mlp(lp.to_torch(p), torch.from_numpy(x), cfg)
    return (got_y.numpy(), float(got_aux)), (np.asarray(want_y), float(want_aux))


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25] * 4 + [0.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_a_zero_router_routes_every_token_alike():
    """A zero router gives uniform gate probabilities, every token ties
    across all experts and goes to experts 0..K-1, as in JAX."""
    jcfg, cfg = lp.configs("olmoe-1b-7b", "float32")
    p = _layer(cfg, router=np.zeros((cfg.d_model, cfg.moe.num_experts), np.float32))
    x = np.random.default_rng(1).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    (y, aux), (want_y, want_aux) = _both(jcfg, p, x)
    lp.assert_close(y, want_y, what="zero router y")
    lp.assert_close(aux, want_aux, what="zero router aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_over_capacity_are_dropped(arch):
    """A router that sends every token to the same top-k experts: with
    capacity int(1.25 * S * K / E) most tokens overflow, their slots reach
    past cap and get no dispatch row; the kept ones match JAX."""
    jcfg, cfg = lp.configs(arch, "float32")
    D, E, K = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    S = 16
    cap = max(1, int(cfg.moe.capacity_factor * S * K / E))
    assert cap < S
    router = np.zeros((D, E), np.float32)
    router[:, :K] = np.linspace(1.0, 2.0, K)           # every token prefers experts 0..K-1
    x = np.abs(np.random.default_rng(2).normal(size=(2, S, D))).astype(np.float32)
    p = _layer(cfg, router=router)
    (y, aux), (want_y, want_aux) = _both(jcfg, p, x)
    lp.assert_close(y, want_y, what="over capacity y")
    lp.assert_close(aux, want_aux, what="over capacity aux")
    # tokens past the capacity of every expert they chose come out zero
    dropped = np.abs(y).sum(-1) == 0
    assert dropped[:, cap:].all() and not dropped[:, :cap].any()


def test_slot_mask_past_capacity_is_a_zero_row():
    slot = np.array([[0, 1, 2, 5]], np.int32)
    want = np.asarray(jax.nn.one_hot(slot, 3, dtype=jnp.float32))
    got = (torch.from_numpy(slot).long()[..., None] == torch.arange(3)).float().numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.from_numpy(slot).long(), 3)


@pytest.mark.parametrize("group", [4, 8])
def test_grouped_dispatch(group):
    """``moe_group`` routes within groups of the sequence (S = 16)."""
    jcfg, cfg = (dataclasses.replace(c, moe_group=group)
                 for c in lp.configs("qwen3-moe-235b-a22b", "float32"))
    x = np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    (y, aux), (want_y, want_aux) = _both(jcfg, _layer(cfg, seed=4), x)
    lp.assert_close(y, want_y, what="grouped y")
    lp.assert_close(aux, want_aux, what="grouped aux")


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
