"""The port's dry run (``repro_torch.launch.dryrun``), its per-rank counter
(``core.hlo_cost`` on DTensor programs), its roofline
(``core.hlo_roofline``) and the readers of its records
(``benchmarks.roofline_report``, ``benchmarks.scaling``), on the CPU.

  * On a fake world of 4 ranks, SMOKE llama3.2-1b's forward-only
    (``prefill``) cell with ``pure_dp`` (JAX's ``extra_opts``) counts
    per-rank FLOPs equal to the single-device count / 4 within 1% (a train
    cell would also count AdamW on replicated leaves, which does not divide
    by 4).
  * A tensor-parallel matmul counts its analytic local FLOPs and an
    all-reduce of the analytic payload, and not the run of the op on the
    global shapes that DTensor's sharding propagation makes.
  * Records have JAX's keys, a failing cell is ``ok: false`` with its
    error, and ``model_flops_for`` equals JAX's for every arch and cell.
  * ``roofline_report.render`` and ``scaling.run`` print JAX's text from
    the same records; only the mesh labels differ.
The JAX side is skipped where JAX is absent."""
import dataclasses
import importlib.util
import json
import math
import pathlib

import pytest
import torch

from repro_torch.configs import SMOKE
from repro_torch.configs.registry import ARCHS, SHAPES, ShapeCell, cells_for
from repro_torch.core import hlo_roofline
from repro_torch.core.hlo_cost import analyze_program
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.benchmarks import roofline_report, scaling
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.parallel import sharding
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: JAX's record keys (``src/repro/launch/dryrun.py``: ``run_cell``).
JAX_KEYS = {"arch", "cell", "mesh", "tag", "ok", "lower_s", "compile_s",
            "n_chips", "memory", "roofline", "collectives"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


def _jax_file(rel: str):
    """A module of the JAX package's ``benchmarks/``, loaded from its file."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "jax_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prefill_flops_per_rank_are_a_quarter():
    cfg = dataclasses.replace(SMOKE["llama3.2-1b"], pure_dp=True)
    cell = ShapeCell("prefill_8k", 8192, 8, "prefill")
    model = get_model(cfg)
    params = base.shape_tree(model.param_defs())
    batch = model.input_specs(cell)
    with torch.no_grad():
        single = analyze_program(model.loss_fn, params, batch)
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        cost, memory = dryrun.trace_cell(cfg, cell, mesh, pure_dp=True)
    assert abs(cost.flops - single.flops / 4) <= 0.01 * single.flops / 4
    assert cost.coll == {}      # pure DP: the forward needs no collective
    # every rank holds the replicated weights and 4 token rows (JAX's
    # batch_pspecs shards the inputs over `data` alone)
    assert memory["argument_bytes"] == (
        base.param_count(model.param_defs()) * 4 + 4 * (8192 + 1) * 4)


def test_tp_matmul_counts_local_flops_and_the_all_reduce():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    M, K, N = 64, 512, 256
    with dryrun.fake_world(4):
        mesh = make_mesh((4,), ("model",), "cuda")
        x = distribute_tensor(torch.empty(M, K, device="meta"), mesh, [Shard(1)])
        w = distribute_tensor(torch.empty(K, N, device="meta"), mesh, [Shard(0)])
        cost = analyze_program(
            lambda a, b: (a @ b).redistribute(mesh, [Replicate()]), x, w)
    # the local (M, K/4) @ (K/4, N): not the global product the sharding
    # propagation runs once on fake tensors
    assert cost.flops == 2 * M * (K // 4) * N
    assert cost.coll == {"all-reduce": M * N * 4}
    assert cost.coll_counts == {"all-reduce": 1}


def test_production_meshes_need_their_worlds():
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (16, 16)
        with pytest.raises(ValueError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True)
    with dryrun.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cuda")
        assert tuple(mesh.shape) == (2, 16, 16)
    with pytest.raises(ValueError, match="no torch.distributed world"):
        make_production_mesh()


def test_records_have_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", False, force=True)
    assert rec["ok"], rec.get("error")
    assert set(rec) == JAX_KEYS and set(rec["memory"]) == JAX_MEMORY
    pytest.importorskip("jax")
    from repro.core import hlo_roofline as jr
    assert set(rec["roofline"]) == {f.name for f in dataclasses.fields(jr.RooflineTerms)}
    assert set(rec["collectives"]) == set(jr.parse_collective_bytes(""))
    assert rec["n_chips"] == 256 and rec["roofline"]["bottleneck"] == "memory"
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    on_disk = json.loads((tmp_path / "llama3.2-1b__decode_32k__single.json").read_text())
    assert on_disk == rec


def test_a_failing_cell_records_its_error(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))

    def boom(*args, **kwargs):
        raise RuntimeError("no sharding rule")
    monkeypatch.setattr(dryrun, "trace_cell", boom)
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", False, force=True)
    assert rec["ok"] is False and rec["error"] == "RuntimeError: no sharding rule"
    assert "no sharding rule" in rec["tb"]
    assert set(rec) == {"arch", "cell", "mesh", "tag", "ok", "error", "tb"}


def test_roofline_terms_use_the_h100_data_sheet():
    from repro_torch.core.hlo_cost import ProgramCost

    cost = ProgramCost(flops=989e12, bytes_major=3.35e12 / 2,
                       coll={"all-gather": 450e9 / 4})
    t = hlo_roofline.roofline_from_cost(cost, model_flops=989e12 * 8, n_chips=16)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 0.5, 0.25)
    assert t.bottleneck == "compute" and t.useful_fraction == 0.5
    d = hlo_roofline.collective_dict(cost)
    assert d["all-gather"] == 450e9 / 4 and d["n_all-gather"] == 0


def test_model_flops_equal_jax():
    pytest.importorskip("jax")
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.configs.registry import SHAPES as JAX_SHAPES
    from repro.core import hlo_roofline as jr

    for arch in ARCHS:
        for cell in cells_for(arch):
            got = hlo_roofline.model_flops_for(ARCHS[arch], SHAPES[cell])
            assert got == jr.model_flops_for(JAX_ARCHS[arch], JAX_SHAPES[cell]), (arch, cell)


def _records(tmp: pathlib.Path):
    """A few records: ok cells on both meshes, a failed one, a stencil."""
    def rec(arch, cell, mesh, dom, ok=True):
        n = 256 if mesh == "single" else 512
        r = {"arch": arch, "cell": cell, "mesh": mesh, "tag": "", "ok": ok}
        if not ok:
            r["error"] = "RuntimeError: no sharding rule"
            return r
        r.update(n_chips=n, memory={"peak_bytes": 3 * 2**30},
                 roofline={"compute_s": dom, "memory_s": dom / 2,
                           "collective_s": dom / 3, "bottleneck": "compute",
                           "model_flops": 1e15, "useful_fraction": 0.4567})
        return r
    recs = [rec("llama3.2-1b", "train_4k", "single", 0.2),
            rec("llama3.2-1b", "train_4k", "multi", 0.12),
            rec("olmoe-1b-7b", "train_4k", "single", 0.5),
            rec("rwkv6-1.6b", "decode_32k", "multi", 0, ok=False)]
    st = rec("stencil-Box-2D1R", "t4", "single", 0.01)
    del st["tag"]
    recs.append(st)
    for i, r in enumerate(recs):
        (tmp / f"r{i}.json").write_text(json.dumps(r))


#: The port's labels -> JAX's: ranks of H100s, not TPU chips.
LABELS = [("cells traced OK", "cells compiled OK"),
          ("H100 ranks)", "chips)"),
          ("| ranks |", "| chips |"),
          ("MODEL_FLOPs/rank", "MODEL_FLOPs/chip"),
          ("peak HBM/rank", "peak HBM/dev")]


def test_report_and_scaling_print_jax_text(tmp_path, monkeypatch):
    jrep = _jax_file("benchmarks/roofline_report.py")
    jscal = _jax_file("benchmarks/scaling.py")
    _records(tmp_path)
    for mod in (jrep, jscal, roofline_report, scaling):
        monkeypatch.setattr(mod, "DRY", str(tmp_path))
    text = roofline_report.render()
    assert "256 H100 ranks" in text and "chips" not in text
    for ours, theirs in LABELS:
        text = text.replace(ours, theirs)
    assert text == jrep.render()
    assert scaling.run() == jscal.run()
    assert len(scaling.run()) == 2          # the header and llama's pair


def test_scaling_without_records_prints_its_header(tmp_path, monkeypatch):
    monkeypatch.setattr(scaling, "DRY", str(tmp_path))
    assert scaling.run() == ["scaling.arch,cell,dom_single_ms,dom_multi_ms,"
                             "speedup,ideal,parallel_efficiency"]


def test_stencil_cells_trace_the_plain_local_update(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    recs = dryrun.run_stencil(False, force=True)
    assert [r["arch"] for r in recs] == ["stencil-Box-2D1R", "stencil-Star-2D3R",
                                         "stencil-Box-3D1R"]
    for r in recs:
        assert r["ok"], r.get("error")
        assert r["local_update"] == dryrun.PLAIN_LOCAL_UPDATE
        assert r["roofline"]["collective_bytes"] > 0     # the halo exchange
        assert 0.9 < r["roofline"]["useful_fraction"] <= 1.0
    # one fused exchange of depth t*r: the sends are the stepper's halo bytes
    from repro_torch.stencil.distributed import halo_bytes_per_step
    assert recs[0]["roofline"]["collective_bytes"] == halo_bytes_per_step(
        (640, 640), ("data", "model"), 1, 4, "fused", 4)
    assert recs[2]["roofline"]["collective_bytes"] == halo_bytes_per_step(
        (64, 64, 1024), ("data", "model", None), 1, 2, "fused", 4)


def test_folded_multi_pod_specs_equal_jax():
    import types
    from jax.sharding import PartitionSpec as P  # noqa: F401  (JAX side)
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models.api import get_model as jax_get_model
    from repro.parallel import sharding as jsh

    full = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                 axis_names=("pod", "data", "model"))
    folded = types.SimpleNamespace(shape={"pod_data": 32, "model": 16},
                                   axis_names=("pod_data", "model"))

    def fold(e):
        return "pod_data" if e == ("pod", "data") else e
    for arch in ARCHS:
        cfg = ARCHS[arch]
        got = sharding.param_pspecs(get_model(cfg).param_defs(), folded, cfg.fsdp)
        want = jsh.param_pspecs(jax_get_model(JAX_ARCHS[arch]).param_defs(), full, cfg.fsdp)
        flat = {".".join(str(k.key) for k in p): tuple(fold(e) for e in s)
                for p, s in __import__("jax").tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(x, P))[0]}
        assert dict(base.named_leaves(got)) == flat, arch
    assert math.prod(folded.shape.values()) == math.prod(full.shape.values())


def test_temp_peak_tracks_live_storages():
    """The counter's high-water mark: outputs live until freed; views and
    writes into an input add nothing."""
    def f(x):
        a = x * 2                   # 4 KiB
        b = a + 1                   # 4 KiB, both alive
        del a
        b.add_(1)                   # in place: nothing new
        v = b[:10]                  # a view: nothing new
        return (v.sum() + b.sum()).item()
    cost = analyze_program(f, torch.ones(1024))
    assert cost.temp_peak_bytes == 2 * 4096
