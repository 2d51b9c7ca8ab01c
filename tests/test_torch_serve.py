"""The port's serving drivers on the CPU: ``repro_torch.launch.serve``'s
arguments (mirrored from ``tests/test_serve.py``), its ``stencil``
subcommand, the LLM driver (``--device cpu``: the dense ``--check``, rwkv,
JAX's prompts and greedy stream, the refusal to fall back to the CPU), the
serving benchmark at a tiny size, and the timing plumbing of
``repro_torch.benchmarks.timing``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as JAX_SMOKE
from repro.models.api import get_model as jax_get_model
from repro_torch.benchmarks import serving, timing
from repro_torch.configs import SMOKE
from repro_torch.launch.serve import (build_parser, consistency, main,
                                      parse_args, serve_llm, serve_stencil)
from repro_torch.models import base
from repro_torch.models.api import get_model
from torch_threads import one_intra_op_thread  # noqa: F401


class TestServeArgValidation:
    @pytest.mark.parametrize("flag,value", [
        ("--batch", "0"), ("--batch", "-1"),
        ("--prompt-len", "0"), ("--prompt-len", "-3"),
        ("--gen", "0"), ("--gen", "-2"),
    ])
    def test_non_positive_bounds_exit_with_usage_error(self, flag, value,
                                                       capsys):
        with pytest.raises(SystemExit) as ei:
            parse_args([flag, value])
        assert ei.value.code == 2
        err = capsys.readouterr().err
        assert "must be >= 1" in err and flag in err

    def test_valid_bounds_parse(self):
        args = parse_args(["--batch", "2", "--prompt-len", "4", "--gen", "8"])
        assert (args.batch, args.prompt_len, args.gen) == (2, 4, 8)
        assert args.arch == "llama3.2-1b"

    def test_non_integer_rejected_by_argparse(self):
        with pytest.raises(SystemExit) as ei:
            parse_args(["--batch", "two"])
        assert ei.value.code == 2

    def test_parser_has_no_side_effects(self):
        ap = build_parser()
        flags = {a.option_strings[0] for a in ap._actions
                 if a.option_strings}
        assert {"--batch", "--prompt-len", "--gen",
                "--arch", "--check"} <= flags

    @pytest.mark.parametrize("argv,flag", [
        (["stencil", "--requests", "0"], "--requests"),
        (["stencil", "--window", "-1"], "--window"),
        (["stencil", "--t", "0"], "--t"),
        (["stencil", "--max-batch", "0"], "--max-batch"),
        (["stencil", "--timeout-ms", "-1"], "--timeout-ms"),
        (["stencil", "--grid", "4,x"], "--grid"),
        (["stencil", "--grid", "1,2,3,4"], "--grid")])
    def test_stencil_flags_validated(self, argv, flag, capsys):
        with pytest.raises(SystemExit) as ei:
            parse_args(argv)
        assert ei.value.code == 2 and flag in capsys.readouterr().err

    def test_arch_takes_the_registry_names(self, capsys):
        assert parse_args(["--arch", "rwkv6-1.6b"]).arch == "rwkv6-1.6b"
        with pytest.raises(SystemExit) as ei:
            parse_args(["--arch", "gpt-2"])
        assert ei.value.code == 2 and "invalid choice" in capsys.readouterr().err
        choices = next(a for a in build_parser()._actions if "--arch" in a.option_strings).choices
        assert choices == sorted(JAX_SMOKE)


def test_llm_driver_dense_check_on_the_cpu(capsys):
    main(["--device", "cpu", "--check"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=llama3.2-1b B=4 prompt=16 gen=32"
    assert out[1].startswith("prefill: ") and out[2].startswith("decode : ")
    assert out[3].startswith("sample completions (first 8 ids): ")
    assert out[-1] == "greedy consistency vs uncached forward: OK"


def test_llm_driver_rwkv_on_the_cpu(capsys):
    main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--batch", "2",
          "--prompt-len", "5", "--gen", "6", "--check"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-1.6b B=2 prompt=5 gen=6" in out
    assert "greedy consistency" not in out          # --check is dense-only, as in JAX


def test_llm_driver_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--batch", "1", "--prompt-len", "1", "--gen", "1"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_llm_stream_matches_jax(arch):
    """JAX's driver loop (``repro.launch.serve.main``) on its own
    parameters, in float32: the same prompts from
    ``np.random.default_rng(0)``, and the port's greedy stream from the same
    parameters equals JAX's token for token."""
    B, P, G = 2, 6, 5
    jcfg = dataclasses.replace(JAX_SMOKE[arch], dtype="float32")
    jm = jax_get_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab, size=(B, P)).astype(np.int32)
    serve = jax.jit(jm.decode_step)
    caches = jm.init_caches(B, P + G + 1)
    for i in range(P):
        nxt, caches = serve(params, caches, jnp.asarray(prompts[:, i:i + 1]),
                            jnp.asarray(i, jnp.int32))
    out = [np.asarray(nxt)]
    for i in range(P, P + G - 1):
        nxt, caches = serve(params, caches, jnp.asarray(out[-1]), jnp.asarray(i, jnp.int32))
        out.append(np.asarray(nxt))
    want = np.concatenate(out, axis=1)

    cfg = dataclasses.replace(SMOKE[arch], dtype="float32")
    got = serve_llm(cfg, B, P, G, device="cpu",
                    params=base.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    np.testing.assert_array_equal(got["prompts"], prompts)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["tokens"].dtype == np.int32 and got["check"] is None


def test_llm_check_holds_cached_logits_to_the_forward():
    """serve_llm's check: the kept logits equal the uncached forward's
    within the stated tolerance; a float32 config gets the float32 floor."""
    cfg = dataclasses.replace(SMOKE["glm4-9b"], dtype="float32")
    r = serve_llm(cfg, 2, 4, 5, check=True, device="cpu", keep_logits=True)
    c = r["check"]
    assert r["logits"].shape == (2, 4 + 5 - 1, cfg.vocab)
    assert c["ok"] and c["tokens_ok"] and c["positions"] == 2 * 5
    assert c["tol"] == pytest.approx(1e-4 * c["ref_max"]) and c["max_abs_err"] < c["tol"]
    assert c["under_margin"] < c["positions"]


def test_stencil_subcommand_runs_on_the_cpu(capsys):
    args = parse_args(["stencil", "--requests", "24", "--window", "8",
                       "--grid", "16,16", "--device", "cpu"])
    assert args.device == "cpu" and args.grid_shape == (16, 16)
    snap = serve_stencil(args)
    assert snap["responded"] == snap["submitted"] == 24
    assert snap["failed"] == 0 and snap["degraded_batches"] == 0
    out = capsys.readouterr().out
    assert "requests   : 24/24" in out and "device=cpu" in out


def test_llm_check_on_a_prefix_of_the_stream():
    """The factored WKV scan runs 16-position chunks: a stream of 8 + 40 - 1
    = 47 positions splits into 2 chunks of 23 and one left over, which it
    refuses (as JAX's reshape does); its first 32 positions scan, and the
    tokens compared are the ones those positions produce."""
    cfg = dataclasses.replace(SMOKE["rwkv6-1.6b"], dtype="float32", wkv_factored=True)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    r = serve_llm(cfg, 2, 8, 40, device="cpu", params=params, keep_logits=True)
    with pytest.raises(ValueError, match="cannot split"):
        consistency(cfg, params, r["prompts"], r["tokens"], r["logits"])
    c = consistency(cfg, params, r["prompts"], r["tokens"], r["logits"], length=32)
    assert c["ok"] and c["positions"] == 2 * (32 - 8 + 1)


def test_serving_benchmark_tiny_on_the_cpu(tmp_path):
    path = tmp_path / "bench.json"
    payload = serving.run(True, grid=(16, 16), device="cpu",
                          requests_per_signature=serving.WINDOW,
                          passes=1, json_path=path)
    assert json.loads(path.read_text())["bitwise_match"] is True
    assert payload["device"] == "cpu" and payload["grid"] == [16, 16]
    n = serving.WINDOW * len(serving.SIGS_QUICK)
    assert payload["sequential"]["requests"] == n
    assert payload["batched"]["responded"] == n
    assert payload["batched"]["degraded_batches"] == 0
    # the plan-sharing contract: every sequential lookup after the first
    # of each signature hits the plan cache
    assert payload["plan_cache"]["hits_delta"] >= n - len(serving.SIGS_QUICK)
    lines = serving.summary(payload)
    assert lines[1].startswith("serving.quick,cpu,") and "OK" in lines[1]


def test_time_us_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.time_us(lambda: None)


def test_case_budget_raises_and_disables(monkeypatch):
    import time
    with pytest.raises(timing.CaseTimeout):
        with timing.case_budget(1):
            time.sleep(3)
    with timing.case_budget(0):          # disabled
        pass
    monkeypatch.setenv("REPRO_BENCH_BUDGET_S", "7")
    assert timing.bench_budget_s() == 7
