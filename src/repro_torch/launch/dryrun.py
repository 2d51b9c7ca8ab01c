"""Multi-pod dry run of the port (the counterpart of ``repro.launch.dryrun``):
trace every (arch x shape x mesh) cell as ONE rank of a fake world, with no
card and no allocation, and record its per-rank roofline and memory.

JAX compiles each cell with XLA against 512 fake host devices.  The port
has no compiler to ask, so it runs the real step instead -- the train,
prefill or serve step of ``train.steps`` under ``sharding.use_mesh`` -- on
rank 0 of a fake ``torch.distributed`` world
(``init_process_group("fake", world_size=256 or 512)``, torn down after
each cell), on a ``make_production_mesh`` mesh:

  * the mesh is a card mesh (``device_type="cuda"``: DTensor plans its
    redistributions as for NCCL, all-to-all included) and the parameters,
    AdamW state and batch are DTensors of ``meta`` tensors: shapes and
    placements, no storage, no card;
  * ``core.hlo_cost.analyze_program`` counts this rank's local aten ops and
    the collectives of its redistributions (FLOPs, bytes, collective bytes
    by kind), not DTensor's sharding propagation;
  * ``core.hlo_roofline.roofline_from_cost`` turns them into the three
    terms with H100 data-sheet constants, and MODEL_FLOPS into the useful
    fraction.

Memory: ``argument_bytes`` is exact (this rank's shards of the parameters,
state and batch), ``output_bytes`` the local bytes of what the step returns
(as JAX's), ``temp_bytes`` the counter's high-water mark of live bytes the
step's ops allocated, and ``peak_bytes`` argument + temp: the last two are
ESTIMATES from tracked storages, not an allocator's measurement.

A cell that cannot be traced writes ``ok: false`` with its error, as JAX's
does.  Results are cached as JSON under ``results/dryrun_torch/`` (rerun
with ``--force``).  Usage:

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --cell train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
  python -m repro_torch.launch.dryrun --stencil            # paper-workload cells

The stencil cells trace one rank's fused distributed step
(``stencil.distributed``) with the PLAIN local update: no kernel of the
port can launch on a fake tensor.  Their records say so
(``local_update``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.registry import ARCHS, SHAPES, cells_for
from repro_torch.core import hlo_roofline
from repro_torch.core.hlo_cost import analyze_program
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.train.steps import make_serve_step, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch")

#: What the stencil records say of their local update.
PLAIN_LOCAL_UPDATE = ("plain (apply_stencil_valid): no kernel of the port "
                      "launches on a fake tensor")


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a fake ``torch.distributed`` world of ``n`` ranks, torn
    down on exit.  Its collectives move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _distributed(tree, mesh, specs):
    """``tree`` of meta tensors as DTensors of meta shards with ``specs``."""
    pl = base.tree_map(lambda s: sharding.placements(s, mesh), specs)
    return sharding.distribute(tree, mesh, pl)


def _local_bytes(tree) -> int:
    """This rank's bytes of the tensors in ``tree`` (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            loc = x.to_local() if isinstance(x, DTensor) else x
            total += loc.numel() * loc.element_size()
    return total


def trace_cell(cfg, cell, mesh, pure_dp: bool = False):
    """Trace one step of ``cell`` for ``cfg`` as this rank of ``mesh``'s
    (fake) world.  Returns (ProgramCost, memory dict)."""
    model = get_model(cfg)
    pdefs = model.param_defs()
    pspecs = sharding.param_pspecs(pdefs, mesh, cfg.fsdp, pure_dp)
    inputs = model.input_specs(cell)
    out = []
    params = _distributed(base.shape_tree(pdefs), mesh, pspecs)
    if cell.kind in ("train", "prefill"):
        batch = _distributed(inputs, mesh, sharding.batch_pspecs(inputs, mesh))
        args = (params, batch)
    else:
        caches = _distributed(inputs["caches"], mesh,
                              sharding.cache_pspecs(inputs["caches"], mesh))
        token = _distributed({"t": inputs["token"]}, mesh,
                             sharding.batch_pspecs({"t": inputs["token"]}, mesh))["t"]
        pos = _distributed({"p": inputs["pos"]}, mesh, {"p": ()})["p"]
        args = (params, caches, token, pos)
    if cell.kind == "train":
        # moments with the parameters' placements; the step counter stays
        # a real host tensor, as on the card
        step = make_train_step(model, adamw.AdamWConfig())
        args = (params, adamw.init(params), batch)
    elif cell.kind == "prefill":
        # the loss-bearing full-sequence pass without the optimizer
        # (forward only == serving prefill cost)
        def step(params, batch):
            with torch.no_grad():
                return model.loss_fn(params, batch)[0]
    else:
        step = make_serve_step(model)

    with sharding.use_mesh(mesh, cfg.fsdp, pure_dp):
        cost = analyze_program(lambda *a: out.append(step(*a)), *args)
    arg_bytes = _local_bytes(args)
    temp = int(cost.temp_peak_bytes)
    memory = {"argument_bytes": arg_bytes, "output_bytes": _local_bytes(out),
              "temp_bytes": temp, "peak_bytes": arg_bytes + temp}
    return cost, memory


def trace_mesh(multi_pod: bool):
    """The mesh a cell is traced on, over the current world.  One pod: the
    (16, 16) production mesh.  Two pods: the (2, 16, 16) production mesh
    folded to its (pod_data = 32, model = 16) view over the same ranks in
    the same order.  JAX's multi-pod rules always shard over pod and data
    together, so the folded view gives the same shardings; on the 3D mesh
    DTensor's redistribution planner searches a graph per op shape (20
    minutes for one rwkv6 cell, over an hour for llama's)."""
    if not multi_pod:
        return make_production_mesh(device_type="cuda")
    return make_mesh((32, 16), (sharding.POD_DATA, "model"), "cuda")


def lower_cell(arch: str, cell_name: str, multi_pod: bool,
               extra_opts: dict | None = None):
    """The config, cell, mesh and sharding policy of one cell (the mesh on
    the current world).  JAX's pure-DP policy: pure DP only fills the
    machine while batch >= chips -- fall back to TP otherwise."""
    cfg = ARCHS[arch]
    if extra_opts:
        cfg = dataclasses.replace(cfg, **extra_opts)
    cell = SHAPES[cell_name]
    mesh = trace_mesh(multi_pod)
    pure_dp = getattr(cfg, "pure_dp", False)
    n_chips = math.prod(mesh.shape)
    if pure_dp and cell.global_batch < n_chips:
        pure_dp = False
    return cfg, cell, mesh, pure_dp


def _write(out_path: str, rec: dict) -> None:
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, cell_name: str, multi_pod: bool, force=False,
             tag: str = "", extra_opts=None):
    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out_path = os.path.join(
        RESULTS_DIR, f"{arch}__{cell_name}__{mesh_name}{tag}.json")
    if os.path.exists(out_path) and not force:
        print(f"[skip] {out_path} exists")
        with open(out_path) as f:
            return json.load(f)
    t0 = time.time()
    rec = {"arch": arch, "cell": cell_name, "mesh": mesh_name, "tag": tag}
    try:
        with fake_world(512 if multi_pod else 256):
            cfg, cell, mesh, pure_dp = lower_cell(arch, cell_name, multi_pod,
                                                  extra_opts)
            t_lower = time.time() - t0
            cost, memory = trace_cell(cfg, cell, mesh, pure_dp)
            t_trace = time.time() - t0 - t_lower
        mf = hlo_roofline.model_flops_for(cfg, cell)
        n_chips = math.prod(mesh.shape)
        terms = hlo_roofline.roofline_from_cost(cost, mf, n_chips)
        rec.update(
            ok=True,
            lower_s=round(t_lower, 1), compile_s=round(t_trace, 1),
            n_chips=n_chips,
            memory=memory,
            roofline=terms.as_dict(),
            collectives=hlo_roofline.collective_dict(cost),
        )
        print(f"[ok] {arch} {cell_name} {mesh_name}{tag}: "
              f"compute={terms.compute_s*1e3:.2f}ms mem={terms.memory_s*1e3:.2f}ms "
              f"coll={terms.collective_s*1e3:.2f}ms bottleneck={terms.bottleneck} "
              f"useful={terms.useful_fraction and round(terms.useful_fraction,3)} "
              f"peak~{memory['peak_bytes'] / 2**30:.2f}GiB/rank "
              f"(setup {t_lower:.0f}s trace {t_trace:.0f}s)")
    except Exception as e:  # noqa: BLE001 -- recorded, the sweep goes on
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-2000:])
        print(f"[FAIL] {arch} {cell_name} {mesh_name}{tag}: {e}")
    _write(out_path, rec)
    return rec


#: JAX's three stencil cells: (name, grid, single-pod dims, t).
STENCIL_CASES = (
    ("Box-2D1R", (10240, 10240), ("data", "model"), 4),
    ("Star-2D3R", (10240, 10240), ("data", "model"), 2),
    ("Box-3D1R", (1024, 1024, 1024), ("data", "model", None), 2),
)


def _stencil_mesh(multi_pod: bool, ndim: int):
    """The mesh and per-dim axis names of a stencil cell.  JAX shards a
    multi-pod 2D grid's first dim over (pod, data); the port's stepper
    names one mesh dim per grid dim, so that dim is the folded 32-wide
    ``pod_data`` dim.  The 3D grid shards over all three mesh dims."""
    mesh = trace_mesh(multi_pod)
    if not multi_pod:
        return mesh, ("data", "model", None)[:ndim]
    if ndim == 2:
        return mesh, (sharding.POD_DATA, "model")
    return make_production_mesh(multi_pod=True, device_type="cuda"), ("pod", "data", "model")


def _local_shape(shape, mesh, dims):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return tuple(n // (sizes[d] if d is not None else 1) for n, d in zip(shape, dims))


def run_stencil(multi_pod: bool, force=False):
    """Dry-run the paper's own workload: distributed 2D/3D stencil steps."""
    from repro_torch.stencil import StencilSpec, make_weights
    from repro_torch.stencil.distributed import make_distributed_stepper

    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out = []
    for name, shape, _, t in STENCIL_CASES:
        out_path = os.path.join(
            RESULTS_DIR, f"stencil-{name}__t{t}__{mesh_name}.json")
        if os.path.exists(out_path) and not force:
            print(f"[skip] {out_path}")
            continue
        rec = {"arch": f"stencil-{name}", "cell": f"t{t}", "mesh": mesh_name,
               "local_update": PLAIN_LOCAL_UPDATE}
        try:
            spec = StencilSpec.from_name(name)
            w = make_weights(spec, seed=0)
            with fake_world(512 if multi_pod else 256):
                mesh, dims = _stencil_mesh(multi_pod, len(shape))
                step = make_distributed_stepper(mesh, dims, w, t=t, mode="fused")
                # a fake CPU tensor: point-to-point ops need a real
                # device type, which meta tensors do not have; the
                # stepper's weights meet it as constants
                from torch._subclasses.fake_tensor import FakeTensorMode
                with FakeTensorMode(allow_non_fake_inputs=True):
                    x = torch.empty(_local_shape(shape, mesh, dims))
                res = []
                cost = analyze_program(lambda a: res.append(step(a)), x)
            n_chips = math.prod(mesh.shape)
            K = spec.num_points
            mf = 2.0 * K * t * float(math.prod(shape))
            terms = hlo_roofline.roofline_from_cost(cost, mf, n_chips)
            arg = x.numel() * x.element_size()
            rec.update(ok=True, roofline=terms.as_dict(),
                       memory={"peak_bytes": arg + int(cost.temp_peak_bytes)})
            print(f"[ok] stencil {name} t={t} {mesh_name}: "
                  f"bottleneck={terms.bottleneck} useful={terms.useful_fraction}")
        except Exception as e:  # noqa: BLE001 -- recorded, the sweep goes on
            rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                       tb=traceback.format_exc()[-2000:])
            print(f"[FAIL] stencil {name}: {e}")
        _write(out_path, rec)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--stencil", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.stencil:
        for mp in meshes:
            run_stencil(mp, force=args.force)
        return
    if args.all:
        for arch in ARCHS:
            for cell in cells_for(arch):
                for mp in meshes:
                    run_cell(arch, cell, mp, force=args.force)
        return
    for mp in meshes:
        run_cell(args.arch, args.cell, mp, force=args.force)


if __name__ == "__main__":
    main()
