"""The port's serving drivers on the CPU: ``repro_torch.launch.serve``'s
arguments (mirrored from ``tests/test_serve.py``), its ``stencil``
subcommand, the LLM path's refusal, the serving benchmark at a tiny size,
and the timing plumbing of ``repro_torch.benchmarks.timing``."""
import json

import pytest
import torch

from repro_torch.benchmarks import serving, timing
from repro_torch.launch.serve import (build_parser, main, parse_args,
                                      serve_stencil)


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

    def test_llm_path_names_its_item(self):
        with pytest.raises(NotImplementedError, match="item 18"):
            main(["--batch", "2"])


def test_stencil_subcommand_runs_on_the_cpu(capsys):
    args = parse_args(["stencil", "--requests", "24", "--window", "8",
                       "--grid", "16,16", "--device", "cpu"])
    assert args.device == "cpu" and args.grid_shape == (16, 16)
    snap = serve_stencil(args)
    assert snap["responded"] == snap["submitted"] == 24
    assert snap["failed"] == 0 and snap["degraded_batches"] == 0
    out = capsys.readouterr().out
    assert "requests   : 24/24" in out and "device=cpu" in out


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
