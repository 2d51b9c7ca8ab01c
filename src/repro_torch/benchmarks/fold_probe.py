"""A short check of the folded kernels on one card: build them, hold them
to the kernel they replace or their plain version, bit for bit where the
arithmetic is the same, then time them.

    python src/repro_torch/benchmarks/fold_probe.py [banded | tapsum]
    python src/repro_torch/benchmarks/fold_probe.py slab [--src CHECKOUT/src]
        [--save HASHES.json | --against HASHES.json]

``banded`` (or no argument) builds the two folded banded kernels and the
two lifted ones they are compared with, runs 320 calls (2^20 + 3, 2^20,
67 and 1000 points; Box-1D with (r, t) in {(1, 1), (1, 4), (3, 1), (3,
4), (2, 4)}; periodic, zero, reflect and replicate; every grid and
operand dtype pair) and prints each call that differs, then the
milliseconds per call of ``stencil_matmul`` / ``stencil_sparse_matmul``
at t=4, the composed kernel and t=1 on 2^26 float32 points, beside the
lifted kernel doing the same call.  ``tapsum`` (or no argument) builds
the folded tap-sum ``stencil_direct1d`` and the lifted 2D tap-sum, prints
the new kernel's ptxas lines, runs the tap-sum's 320 calls (the same
lines, radii, depths and boundaries; float32 and bfloat16 lines; the Box
weights and the same weights with every other tap zero, which the kernel
skips), then the milliseconds of ``stencil_direct`` at t=4 (one launch)
and t=1 and of four launches at t=1 (the ``direct`` regime) on 2^26
float32 points, periodic and ``reflect``, beside the lifted kernel doing
the same calls and F.conv1d (one step of the composed kernel, periodic;
4 x (F.pad + F.conv1d) under ``reflect``).  Times are the mean over 10
calls after 3, CUDA events.

``slab`` builds the two 3D banded kernels (``stencil_banded3d``,
``stencil_sparse3d``) and prints their ptxas lines, registers and CTAs
per SM, runs chip_smoke.py's phase-2 3D calls (60x70x130 and 40x72x100;
Box/Star-3D with (r, t) in {(1, 1), (1, 4), (2, 2), (3, 1)} and Box-3D2R
at t=4; periodic, zero, reflect, replicate and (replicate, reflect,
periodic); every grid and operand dtype pair), and prints each call
outside its plain version's limit (chip_smoke.py's ``kernel_limit``) and
each compacted call that differs from the dense kernel's, then times the
five regimes on 512^3 Box-3D1R and the compacted two (beside the dense
reuse form) on 512^3 Star-3D1R, f32, t=4, through ``stencil_plan``.
``--src`` imports ``repro_torch`` from another checkout (the calls use
only the public wrappers); ``--save`` writes a hash of every call's
output, and ``--against`` counts the calls whose output differs from
such a file's, so two checkouts' kernels can be compared bit for bit.
Exits 1 if a call differs.  ``chip_smoke.py`` runs the same checks among
all others; this is the quick one for a kernel change.
"""
from __future__ import annotations

import hashlib
import importlib
import json
import os
import subprocess
import sys
import time


LINES = (2**20, 2**20 + 3, 67, 1000)
DEPTHS = ((1, 1), (1, 4), (3, 1), (3, 4), (2, 4))
BOUNDARIES = (None, "zero", "reflect", "replicate")


def ms(torch, fn, reps=10):
    """Mean milliseconds of ``fn()`` over ``reps`` calls after 3, from CUDA
    events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv) -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    opts = dict(zip(argv[1::2], argv[2::2])) if argv[:1] == ["slab"] else {}
    if (argv not in ([], ["banded"], ["tapsum"]) and argv[:1] != ["slab"]
            or len(argv) % 2 == 0 and argv[:1] == ["slab"]
            or not set(opts) <= {"--src", "--save", "--against"}):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(opts.get("--src", root)))
    import torch
    if not torch.cuda.is_available():
        print("fold_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["slab"]:
        return 1 if probe_slab(torch, os.path.dirname(root), opts) else 0
    bad = 0
    if argv != ["tapsum"]:
        bad += probe_banded(torch)
    if argv != ["banded"]:
        bad += probe_tapsum(torch)
    return 1 if bad else 0


def probe_banded(torch) -> int:
    """The folded banded kernels: 320 calls against the lift, the dense
    kernel and the plain version, then their times; returns the calls
    that differ."""
    import numpy as np
    from repro_torch.kernels import _build, common
    from repro_torch.stencil import StencilSpec, fuse_weights, make_weights
    sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
    ss = importlib.import_module("repro_torch.kernels.stencil_sparse")
    t0 = time.perf_counter()
    _build.build_all(("stencil_banded1d", "stencil_sparse1d",
                      "stencil_banded", "stencil_sparse"))
    print(f"build {time.perf_counter() - t0:.1f} s")

    def lifted(mod, x, w, t, cdt, bc):
        r = (w.shape[0] - 1) // 2
        geom = common.launch_geom(x.shape, t * r)
        codes = common.kernel_mode_codes(common.resolve_boundary(bc, 1))
        return mod._launch2d(x.view(1, 1, -1), common.lift_weights(w), t, r,
                             cdt, geom, codes).view(x.shape)

    bad = calls = 0
    pairs = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32))
    for n in LINES:
        for r, t in DEPTHS:
            for bc in BOUNDARIES:
                if bc == "reflect" and n < t * r + 1:
                    continue
                w = make_weights(StencilSpec("box", 1, r), seed=1)
                for dt, cdt in pairs:
                    x = torch.from_numpy(np.random.default_rng(2).normal(
                        size=n).astype(np.float32)).cuda().to(dt)
                    y = sm.stencil_matmul(x, w, t, compute_dtype=cdt,
                                          boundary=bc)
                    d_lift = float((y.float() - lifted(sm, x, w, t, cdt, bc)
                                    .float()).abs().max())
                    d_sparse = float((y.float() - ss.stencil_sparse_matmul(
                        x, w, t, compute_dtype=cdt, boundary=bc).float())
                        .abs().max())
                    e_plain = float((y.float() - sm.stencil_matmul_plain(
                        x, w, t, compute_dtype=cdt, boundary=bc).float())
                        .abs().max())
                    calls += 1
                    if d_lift or d_sparse or not e_plain < 0.05 * t:
                        bad += 1
                        print(f"n={n} r={r} t={t} bc={bc} {dt} {cdt}: vs lift "
                              f"{d_lift:.3e}, vs compacted {d_sparse:.3e}, "
                              f"vs plain {e_plain:.3e}")
    print(f"banded: {calls} calls, {bad} differ")

    x = torch.from_numpy(np.random.default_rng(0).normal(size=2**26)
                         .astype(np.float32)).cuda()
    w = make_weights(StencilSpec("box", 1, 1), seed=0)
    wf = fuse_weights(w, 4)
    f32 = torch.float32
    for bc in (None, "reflect"):
        print(f"2^26 Box-1D1R f32, boundary {bc}: ms per call (lifted kernel)")
        cases = [("fused_matmul_reuse", lambda: sm.stencil_matmul(x, w, 4, boundary=bc),
                  lambda: lifted(sm, x, w, 4, f32, bc)),
                 ("fused_sparse_matmul", lambda: ss.stencil_sparse_matmul(x, w, 4, boundary=bc),
                  lambda: lifted(ss, x, w, 4, f32, bc)),
                 ("t=1", lambda: sm.stencil_matmul(x, w, 1, boundary=bc),
                  lambda: lifted(sm, x, w, 1, f32, bc))]
        if bc is None:
            cases.append(("composed R=4", lambda: sm.stencil_matmul(x, wf, 1),
                          lambda: lifted(sm, x, wf, 1, f32, None)))
        for name, fold, lift in cases:
            print(f"  {name:20s} {ms(torch, fold):.4f} ({ms(torch, lift, 3):.4f})")
    return bad


def probe_tapsum(torch) -> int:
    """The folded tap-sum: 320 calls against the lift and the plain
    version, then its times beside the lift's and F.conv1d's; returns the
    calls that differ."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import _build, common
    from repro_torch.stencil import (StencilSpec, fuse_weights, make_weights,
                                     resolve_boundary)
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    t0 = time.perf_counter()
    _build.build_all(("stencil_direct1d", "stencil_direct"))
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in _build.build_logs.get("stencil_direct1d", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    def lifted(x, w, t, bc):
        r = (w.shape[0] - 1) // 2
        geom = common.launch_geom(tuple(x.shape), t * r)
        codes = common.kernel_mode_codes(resolve_boundary(bc, 1))
        return sd._launch2d(x.view(1, 1, -1), common.lift_weights(w), t, r,
                            geom, codes).view(x.shape)

    bad = calls = 0
    for n in LINES:
        for r, t in DEPTHS:
            for bc in BOUNDARIES:
                box = make_weights(StencilSpec("box", 1, r), seed=1)
                gaps = box.copy()
                gaps[1::2] = 0.0
                for w in (box, gaps):
                    w = np.asarray(w, np.float32)
                    for dt in (torch.float32, torch.bfloat16):
                        x = torch.from_numpy(np.random.default_rng(2).normal(
                            size=n).astype(np.float32)).cuda().to(dt)
                        y = sd.stencil_direct(x, w, t, boundary=bc)
                        d_lift = float((y.float() - lifted(x, w, t, bc).float())
                                       .abs().max())
                        e_plain = float((y.float() - sd.stencil_direct_plain(
                            x, w, t, bc).float()).abs().max())
                        calls += 1
                        if d_lift or not e_plain < 0.05 * t:
                            bad += 1
                            print(f"n={n} r={r} t={t} bc={bc} {dt} taps "
                                  f"{np.count_nonzero(w)}: vs lift {d_lift:.3e}, "
                                  f"vs plain {e_plain:.3e}")
    print(f"tap-sum: {calls} calls, {bad} differ from the lift or the plain version")

    x = torch.from_numpy(np.random.default_rng(0).normal(size=2**26)
                         .astype(np.float32)).cuda()
    w = np.asarray(make_weights(StencilSpec("box", 1, 1), seed=0), np.float32)
    wt = torch.from_numpy(w).cuda()[None, None]
    wf = torch.from_numpy(np.asarray(fuse_weights(w, 4), np.float32)).cuda()[None, None]

    def conv(bc):
        if bc is None:
            return lambda: F.conv1d(F.pad(x[None, None], (4, 4), mode="circular"), wf)
        def run():
            y = x[None, None]
            for _ in range(4):
                y = F.conv1d(F.pad(y, (1, 1), mode=bc), wt)
            return y
        return run

    def four(fn):
        def run():
            y = x
            for _ in range(4):
                y = fn(y)
            return y
        return run

    for bc in (None, "reflect"):
        print(f"2^26 Box-1D1R f32, boundary {bc}: ms per call (lifted kernel)")
        for name, fold, lift in (
                ("fused_direct (t=4)", lambda: sd.stencil_direct(x, w, 4, boundary=bc),
                 lambda: lifted(x, w, 4, bc)),
                ("t=1", lambda: sd.stencil_direct(x, w, 1, boundary=bc),
                 lambda: lifted(x, w, 1, bc)),
                ("direct (4 x t=1)", four(lambda v: sd.stencil_direct(v, w, 1, boundary=bc)),
                 four(lambda v: lifted(v, w, 1, bc)))):
            print(f"  {name:20s} {ms(torch, fold):.4f} ({ms(torch, lift, 3):.4f})")
        print(f"  {'F.conv1d':20s} {ms(torch, conv(bc)):.4f}"
              + (" (composed, one step)" if bc is None else " (4 x (F.pad + F.conv1d))"))
    return bad


#: The slab probe's grids, cases ((kind, r, t)) and boundaries: those of
#: chip_smoke.py's phase 2 on 3D grids.
SLAB_GRIDS = ((60, 70, 130), (40, 72, 100))
SLAB_CASES = tuple((k, r, t) for k in ("box", "star")
                   for r, t in ((1, 1), (1, 4), (2, 2), (3, 1))) + (("box", 2, 4),)
SLAB_BOUNDARIES = (None, "zero", "reflect", "replicate",
                   ("replicate", "reflect", "periodic"))


def slab_occupancy(name: str, dtype: int, compute: int, fill: bool,
                   smem: int):
    """CTAs per SM of a 3D banded instantiation, as the runtime counts them
    (the library's ``<name>_ctas_per_sm``), or None where the checkout's
    library has no such entry."""
    import ctypes
    from repro_torch.kernels import _build
    fn = getattr(_build.library(name), f"{name}_ctas_per_sm", None)
    if fn is None:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return fn(dtype, compute, int(fill), smem)


def probe_slab(torch, repo: str, opts) -> int:
    """The 3D banded kernels: the phase-2 3D calls against the plain
    version's limit and (compacted) the dense kernel, optionally hashed
    against another checkout's outputs, then their 512^3 times; returns
    the calls that differ."""
    import numpy as np
    sys.path.insert(1, repo)
    from chip_smoke import kernel_limit, plain_chain
    from repro_torch.kernels import _build, common, stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights
    sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
    ss = importlib.import_module("repro_torch.kernels.stencil_sparse")
    names = ("stencil_banded3d", "stencil_sparse3d")
    t0 = time.perf_counter()
    _build.build_all(names)
    print(f"build {time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
        try:
            from repro_torch.kernels import sass
            for fn, n in sorted(sass.registers(_build._target(name)).items()):
                print(f"  {name}: {fn}: {n} registers")
        except RuntimeError as e:              # no cuobjdump beside nvcc
            print(f"  {name}: registers not read ({e})")
    main = common.launch_geom((512,) * 3, 4)
    if hasattr(common, "slab_fold_layout"):
        for cb, compute in ((4, 0), (2, 1)):
            lay = common.slab_fold_layout(main.z_slab, main.strip_m,
                                          main.w_tile, 1, 4, cb, 9)
            for name in names:
                ctas = [slab_occupancy(name, 0, compute, fill, lay.smem_bytes)
                        for fill in (False, True)]
                print(f"  {name} at {main.z_slab}x{main.strip_m}x"
                      f"{main.w_tile}, h=4, {lay.smem_bytes} bytes, compute "
                      f"{'f32' if cb == 4 else 'bf16'}: CTAs per SM {ctas[0]}, "
                      f"{ctas[1]} with the fill")

    hashes, bad, calls = {}, 0, 0
    pairs = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32))
    for shape in SLAB_GRIDS:
        for kind, r, t in SLAB_CASES:
            w = make_weights(StencilSpec(kind, 3, r), seed=1)
            for bc in SLAB_BOUNDARIES:
                for dt, cdt in pairs:
                    x = torch.from_numpy(np.random.default_rng(2).normal(
                        size=shape).astype(np.float32)).cuda().to(dt)
                    ops = "bf16" if cdt == torch.bfloat16 else "tf32"
                    maxima, _ = plain_chain(
                        lambda v: sm.stencil_matmul_plain(
                            v, w, 1, compute_dtype=cdt, boundary=bc), x, t)
                    tol = kernel_limit(ops, float(np.abs(w).sum()),
                                       int(np.count_nonzero(w)), maxima,
                                       dt == torch.bfloat16)
                    ys = {}
                    for label, run, plain in (
                            ("dense", sm.stencil_matmul, sm.stencil_matmul_plain),
                            ("compacted", ss.stencil_sparse_matmul,
                             ss.stencil_sparse_matmul_plain)):
                        y = run(x, w, t, compute_dtype=cdt, boundary=bc)
                        err = float((y.float() - plain(
                            x, w, t, compute_dtype=cdt, boundary=bc).float())
                            .abs().max())
                        key = (f"{shape} {kind} r={r} t={t} {bc} "
                               f"{str(dt)[6:]} {str(cdt)[6:]} {label}")
                        hashes[key] = hashlib.sha256(
                            y.contiguous().view(torch.uint8).cpu().numpy()
                            .tobytes()).hexdigest()
                        ys[label] = y
                        calls += 1
                        if not err <= tol:
                            bad += 1
                            print(f"{key}: max|err| vs plain {err:.3e} > "
                                  f"limit {tol:.3e}")
                    diff = float((ys["dense"].float() - ys["compacted"]
                                  .float()).abs().max())
                    if diff:
                        bad += 1
                        print(f"{key}: compacted differs from dense by "
                              f"{diff:.3e}")
    print(f"slab: {calls} calls, {bad} outside the limit or compacted != dense")
    if "--save" in opts:
        with open(opts["--save"], "w") as f:
            json.dump(hashes, f, indent=0)
    if "--against" in opts:
        with open(opts["--against"]) as f:
            other = json.load(f)
        same = [k for k in hashes if other.get(k) == hashes[k]]
        print(f"slab: {len(same)} of {len(hashes)} outputs bit for bit those "
              f"of {opts['--against']}")
        for k in hashes:
            if other.get(k) != hashes[k]:
                print(f"  differs: {k}")
        bad += len(hashes) - len(same)

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(512,) * 3)
                         .astype(np.float32)).cuda()
    for kind, backends in (("box", ("direct", "fused_direct", "matmul",
                                    "fused_matmul", "fused_matmul_reuse")),
                           ("star", ("fused_matmul_reuse", "sparse_matmul",
                                     "fused_sparse_matmul"))):
        w = make_weights(StencilSpec(kind, 3, 1), seed=0)
        print(f"512^3 {kind.capitalize()}-3D1R f32, t=4: ms per call")
        for b in backends:
            plan = stencil_plan(w, x.shape, torch.float32, 4, backend=b,
                                use_sparse_unit="sparse" in b)
            print(f"  {b:20s} {ms(torch, lambda: plan(x), 5):.4f}")
    return bad


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
