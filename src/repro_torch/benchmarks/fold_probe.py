"""A short check of the folded kernels on one card: build them, hold them
to the kernel they replace or their plain version, bit for bit where the
arithmetic is the same, then time them.

    python src/repro_torch/benchmarks/fold_probe.py [banded | tapsum]
    python src/repro_torch/benchmarks/fold_probe.py slab|tile [--src CHECKOUT/src]
        [--save HASHES.json | --against HASHES.json]
    python src/repro_torch/benchmarks/fold_probe.py tile-times [--src CHECKOUT/src]
    python src/repro_torch/benchmarks/fold_probe.py tapsum2d [--src CHECKOUT/src]
        [--save HASHES.json | --against HASHES.json]
    python src/repro_torch/benchmarks/fold_probe.py tapsum2d-times [--src CHECKOUT/src]
    python src/repro_torch/benchmarks/fold_probe.py tapsum2d-wide|tapsum2d-wide-times
        [--src CHECKOUT/src]
    python src/repro_torch/benchmarks/fold_probe.py tapsum2d-sweep
    python src/repro_torch/benchmarks/fold_probe.py tapsum3d [--src CHECKOUT/src]
        [--save HASHES.json | --against HASHES.json]
    python src/repro_torch/benchmarks/fold_probe.py tapsum3d-times|tapsum3d-quick [--src CHECKOUT/src]
    python src/repro_torch/benchmarks/fold_probe.py tapsum3d-sweep

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

``tile`` does the same for the two 2D banded kernels (``stencil_banded``,
``stencil_sparse``, and the foil build ``stencil_banded_foil``): their
ptxas lines, registers and CTAs per SM at the main tile, then
chip_smoke.py's phase-2 2D calls (1024^2 and 1000x1030; Box/Star-2D
with (r, t) in {(1, 1), (1, 4), (3, 1), (3, 4)} periodic, with the
composed kernel at t=4, and (r, t) in {(1, 1), (1, 4), (2, 1), (2, 4)}
under zero, reflect, replicate, (reflect, periodic) and (periodic,
zero); every grid and operand dtype pair, dense and compacted), the 2D
kernels on the lifted (1, N) view of phase 2's 1D lines (each held to
the folded 1D kernel of the same call, bit for bit), the whole-strip and
9-tile foils (each held to the default kernel of the same call and
tile) and batches of 3 grids (held to the unbatched calls), then times
the regimes on 8192^2 Box- and Star-2D1R, f32, t=4, periodic and
``zero``, the kernels on a resolved tile, the K8 / K10 foil plans and
16 x 2048^2 batches.  ``tile-times`` prints the same resources and times
without the calls (for variants of the kernel source in another
checkout).

``tapsum2d`` does the same for the 2D tap-sum (``stencil_direct`` and
its foil build ``stencil_direct_foil``): their ptxas lines, registers
and stack frames (spills), the CTAs per SM of the radius-1
instantiations at the main tile (64 x 64, h = 4; the library's
``stencil_direct_ctas_per_sm``), then chip_smoke.py's phase-2 2D tap-sum
calls (the grids, cases and boundaries of ``tile``, float32 and bfloat16
grids, each held to the plain version with chip_smoke.py's limit), three
grids with an axis shallower than the halo, the 2D kernel on the lifted
(1, N) view of phase 2's 1D lines (each held to the folded 1D tap-sum
bit for bit), the whole-strip (K8) and 9-tile (K9) foils (each held to
the default kernel of the same call and tile) and batches of 3 grids
(held to the unbatched calls), hashed for ``--save`` / ``--against``;
then the times at 8192^2 Box- and Star-2D1R, f32, t=4, periodic and
``zero``: the kernel through the plan entry on a resolved tile
(``stencil_direct_at``: one launch at t=4, and the ``direct`` regime's
four at t=1), the plans of the regimes it is weighed against, the plain
version, F.conv2d, the K8 and K9 foil plans and 16 x 2048^2 batches.
``tapsum2d-times`` prints the resources and times alone (for variants of
the kernel source in another checkout).

``tapsum2d-wide`` holds the wide 2D tap-sum (r = 3..7) on the tiles the
rule gives it (``WIDE2D_CELLS``, 8192^2), at the CTA width its library
reports, to itself on the 2D reserve's old tile and on 32 x 32 pinned,
bit for bit, and times each (``probe_tapsum2d_wide``);
``tapsum2d-wide-times`` the times alone (with ``--src``, a parent's
checkout's kernels and rule: parent, change, change, parent), and
``tapsum2d-sweep`` runs that on copies of the package whose wide CTA has
512 or 1024 threads (``TAPSUM2D_SWEEP``).

``tapsum3d`` does the same for the 3D tap-sum (``stencil_direct3d`` and
its foil build ``stencil_direct3d_foil``): their ptxas lines, registers
and stack frames, the CTAs per SM of the radius-1 instantiations at the
main tile (16 x 16 x 32, h = 4; ``stencil_direct3d_ctas_per_sm``), then
chip_smoke.py's phase-2 3D tap-sum calls (the grids, cases and boundaries
of ``slab``, float32 and bfloat16 grids, each held to the plain version
with chip_smoke.py's limit), three grids with an axis shallower than the
halo, pinned tile depths (z_slab 4 and 8), the whole-slab foil (K8, held
to the default kernel of the same call and tile) and batches of 3 grids
(held to the unbatched calls), hashed for ``--save`` / ``--against``;
then the times at 512^3 Box- and Star-3D1R, f32, t=4, periodic and
(replicate, reflect, periodic): the kernel through the plan entry (one
launch at t=4, and the ``direct`` regime's four at t=1), the plans of the
regimes it is weighed against, the K8 foil plan, the plain version,
F.conv3d and 8 x 256^3 batches.  ``tapsum3d-times`` prints the resources
and these times alone (for parent, change, change, parent on one card),
``tapsum3d-quick`` the resources and the plan entry's times of Box-3D1R,
periodic, and ``tapsum3d-sweep`` runs that on copies of the package whose
3D tap-sum has
each patch height V in {2, 4, 5, 8} and CTA minimum N in {2, 3, 4},
and planes staged ahead A in {2, 3, 4, 6} (TAPSUM3D_SWEEP).  Exits 1 if a call differs.  ``chip_smoke.py`` runs
the same checks among all others; this is the quick one for a kernel
change.
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
    optioned = argv[:1] in (["slab"], ["tile"], ["tile-times"], ["tapsum2d"],
                            ["tapsum2d-times"], ["tapsum2d-wide"], ["tapsum2d-wide-times"],
                            ["tapsum3d"], ["tapsum3d-times"], ["tapsum3d-quick"])
    opts = dict(zip(argv[1::2], argv[2::2])) if optioned else {}
    if (argv not in ([], ["banded"], ["tapsum"], ["tapsum2d-sweep"], ["tapsum3d-sweep"])
            and not optioned
            or len(argv) % 2 == 0 and optioned
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
    if argv[:1] in (["tile"], ["tile-times"]):
        return 1 if probe_tile(torch, os.path.dirname(root), opts,
                               calls=argv[:1] == ["tile"]) else 0
    if argv[:1] in (["tapsum2d"], ["tapsum2d-times"]):
        return 1 if probe_tapsum2d(torch, os.path.dirname(root), opts,
                                   calls=argv[:1] == ["tapsum2d"]) else 0
    if argv[:1] in (["tapsum2d-wide"], ["tapsum2d-wide-times"]):
        return 1 if probe_tapsum2d_wide(torch, os.path.dirname(root), opts,
                                        calls=argv[:1] == ["tapsum2d-wide"]) else 0
    if argv == ["tapsum2d-sweep"]:
        return 1 if tapsum2d_sweep(root) else 0
    if argv[:1] in (["tapsum3d"], ["tapsum3d-times"], ["tapsum3d-quick"]):
        return 1 if probe_tapsum3d(torch, os.path.dirname(root), opts,
                                   calls=argv[:1] == ["tapsum3d"],
                                   full=argv[:1] != ["tapsum3d-quick"]) else 0
    if argv == ["tapsum3d-sweep"]:
        return 1 if tapsum3d_sweep(root) else 0
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


def digest(torch, y) -> str:
    """A hash of a call's output bits."""
    return hashlib.sha256(y.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def save_against(hashes: dict, opts, mode: str) -> int:
    """Writes ``hashes`` to ``--save``, and counts the calls whose output
    differs from ``--against``'s; returns that count (0 without it)."""
    if "--save" in opts:
        with open(opts["--save"], "w") as f:
            json.dump(hashes, f, indent=0)
    if "--against" not in opts:
        return 0
    with open(opts["--against"]) as f:
        other = json.load(f)
    same = [k for k in hashes if other.get(k) == hashes[k]]
    print(f"{mode}: {len(same)} of {len(hashes)} outputs bit for bit those "
          f"of {opts['--against']}")
    for k in hashes:
        if other.get(k) != hashes[k]:
            print(f"  differs: {k}")
    return len(hashes) - len(same)


def occupancy(name: str, dtype: int, compute: int, fill: bool, smem: int):
    """CTAs per SM of a banded instantiation, as the runtime counts them
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


def print_resources(names) -> None:
    """The ptxas lines (each kernel's name, spills and registers) of the
    libraries ``names`` built in this process, and the registers and stack
    frame (spills) of each of their kernels (cuobjdump)."""
    from repro_torch.kernels import _build
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "properties for" in line:
                print(f"  ptxas {name}: {line.strip()}")
        try:
            from repro_torch.kernels import sass
            lib = _build._target(name)
            # a checkout from before stack_bytes (--src) shows registers alone
            stack = getattr(sass, "stack_bytes", lambda _: {})(lib)
            for fn, n in sorted(sass.registers(lib).items()):
                print(f"  {name}: {fn}: {n} registers, {stack.get(fn, '?')} bytes "
                      "of stack frame")
        except RuntimeError as e:              # no cuobjdump beside nvcc
            print(f"  {name}: registers not read ({e})")


#: The slab probe's grids, cases ((kind, r, t)) and boundaries: those of
#: chip_smoke.py's phase 2 on 3D grids.
SLAB_GRIDS = ((60, 70, 130), (40, 72, 100))
SLAB_CASES = tuple((k, r, t) for k in ("box", "star")
                   for r, t in ((1, 1), (1, 4), (2, 2), (3, 1))) + (("box", 2, 4),)
SLAB_BOUNDARIES = (None, "zero", "reflect", "replicate",
                   ("replicate", "reflect", "periodic"))


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
    print_resources(names)
    main = common.launch_geom((512,) * 3, 4)
    if hasattr(common, "slab_fold_layout"):
        for cb, compute in ((4, 0), (2, 1)):
            lay = common.slab_fold_layout(main.z_slab, main.strip_m,
                                          main.w_tile, 1, 4, cb, 9)
            for name in names:
                ctas = [occupancy(name, 0, compute, fill, lay.smem_bytes)
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
                        hashes[key] = digest(torch, y)
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
    bad += save_against(hashes, opts, "slab")

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



#: The tile probe's grids, cases ((kind, r, t)) and boundaries: those of
#: chip_smoke.py's phase 2 on 2D grids and on the 1D lines the 2D kernels
#: run on the lifted view, and of its 2D foil checks.
TILE_GRIDS = ((1024, 1024), (1000, 1030))
TILE_CASES = tuple((k, r, t) for k in ("box", "star") for r in (1, 3) for t in (1, 4))
TILE_BC_CASES = tuple((k, r, t) for k in ("box", "star") for r in (1, 2) for t in (1, 4))
TILE_BOUNDARIES = ("zero", "reflect", "replicate", ("reflect", "periodic"),
                   ("periodic", "zero"))
TILE_LINES = ((2**20,), (2**20 + 3,), (67,), (1000,), (3 * 64 * 64 + 3,))
TILE_BC_LINES = ((2**20 + 3,), (67,), (1000,))


def probe_tile(torch, repo: str, opts, calls: bool = True) -> int:
    """The 2D banded kernels: their registers and CTAs per SM; with
    ``calls``, every call against the plain version's limit, the compacted
    kernel against the dense one, the lifted calls against the folded 1D
    kernels, the foils against the default kernel and the batches against
    the unbatched calls, optionally hashed against another checkout's
    outputs; then their 8192^2 times.  Returns the calls that differ."""
    import numpy as np
    sys.path.insert(1, repo)
    from chip_smoke import kernel_limit, lifted_call, plain_chain
    from repro_torch.kernels import _build, common, legacy, stencil_plan
    from repro_torch.stencil import StencilSpec, fuse_weights, make_weights
    sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
    ss = importlib.import_module("repro_torch.kernels.stencil_sparse")
    names = ("stencil_banded", "stencil_sparse", "stencil_banded_foil")
    t0 = time.perf_counter()
    _build.build_all(names + ("stencil_banded1d", "stencil_sparse1d"))
    print(f"build {time.perf_counter() - t0:.1f} s")
    print_resources(names[:2])
    if hasattr(common, "tile_fold_layout"):
        for cb, compute in ((4, 0), (2, 1)):
            lay = common.tile_fold_layout(64, 64, 1, 4, cb, 3)
            for name in names[:2]:
                ctas = [occupancy(name, 0, compute, fill, lay.smem_bytes)
                        for fill in (False, True)]
                print(f"  {name} at 64x64, h=4, {lay.smem_bytes} bytes, compute "
                      f"{'f32' if cb == 4 else 'bf16'}: CTAs per SM {ctas[0]}, "
                      f"{ctas[1]} with the fill")

    if not calls:
        tile_times(torch, sm, ss, common, legacy, stencil_plan, make_weights, StencilSpec)
        return 0

    def grid(shape, dt, seed=2):
        return torch.from_numpy(np.random.default_rng(seed).normal(
            size=shape).astype(np.float32)).cuda().to(dt)

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    hashes, bad = {}, 0
    pairs = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32))

    def held(key, y, x, wk, tk, cdt, bc, plain):
        """Hashes ``y`` and holds it to the plain version's limit; returns
        whether it is outside."""
        hashes[key] = digest(torch, y)
        maxima, _ = plain_chain(lambda v: plain(v, wk, 1, compute_dtype=cdt,
                                                boundary=bc), x, tk)
        tol = kernel_limit("bf16" if cdt == torch.bfloat16 else "tf32",
                           float(np.abs(wk).sum()), int(np.count_nonzero(wk)),
                           maxima, x.dtype == torch.bfloat16)
        err = diff(y, plain(x, wk, tk, compute_dtype=cdt, boundary=bc))
        if not err <= tol:
            print(f"{key}: max|err| vs plain {err:.3e} > limit {tol:.3e}")
        return not err <= tol

    kernels = (("dense", sm.stencil_matmul, sm.stencil_matmul_plain),
               ("compacted", ss.stencil_sparse_matmul, ss.stencil_sparse_matmul_plain))
    runs = [(shape, c, None) for shape in TILE_GRIDS for c in TILE_CASES] + \
        [((1000, 1030), c, bc) for c in TILE_BC_CASES for bc in TILE_BOUNDARIES]
    for shape, (kind, r, t), bc in runs:
        w = np.asarray(make_weights(StencilSpec(kind, 2, r), seed=1), np.float32)
        ops = [(w, t, "")] + ([(fuse_weights(w, t), 1, " composed")]
                              if t > 1 and bc is None else [])
        for dt, cdt in pairs:
            x = grid(shape, dt)
            for wk, tk, what in ops:
                ys = {}
                for label, run, plain in kernels:
                    key = (f"{shape} {kind} r={r} t={t}{what} {bc} "
                           f"{str(dt)[6:]} {str(cdt)[6:]} {label}")
                    ys[label] = run(x, wk, tk, compute_dtype=cdt, boundary=bc)
                    bad += held(key, ys[label], x, wk, tk, cdt, bc, plain)
                d = diff(ys["dense"], ys["compacted"])
                if d and not what:
                    bad += 1
                    print(f"{key}: compacted differs from dense by {d:.3e}")
    n2d = len(hashes)
    lines = [(n, c, None) for n in TILE_LINES for c in TILE_CASES] + \
        [(n, c, bc) for n in TILE_BC_LINES for c in TILE_BC_CASES
         for bc in ("zero", "reflect", "replicate")]
    for shape, (kind, r, t), bc in lines:
        w = np.asarray(make_weights(StencilSpec(kind, 1, r), seed=1), np.float32)
        for dt, cdt in pairs:
            x = grid(shape, dt)
            for label, run, plain in kernels:
                mod = sm if label == "dense" else ss
                key = (f"{shape} {kind} r={r} t={t} {bc} {str(dt)[6:]} "
                       f"{str(cdt)[6:]} {label} lifted")
                y = lifted_call(mod, x, w, t, cdt, bc)
                bad += held(key, y, x, w, t, cdt, bc, plain)
                d = diff(y, run(x, w, t, compute_dtype=cdt, boundary=bc))
                if d:
                    bad += 1
                    print(f"{key}: the folded 1D kernel differs by {d:.3e}")
    nlift = len(hashes) - n2d
    for (kind, r, t), bc in ((c, bc) for c in TILE_BC_CASES for bc in (None, "zero")):
        w = np.asarray(make_weights(StencilSpec(kind, 2, r), seed=1), np.float32)
        geom = common.launch_geom((1000, 1030), t * r)
        for dt in (torch.float32, torch.bfloat16):
            x = grid((1000, 1030), dt)
            key = f"(1000, 1030) {kind} r={r} t={t} {bc} {str(dt)[6:]} wholestrip"
            y = sm.stencil_matmul_at(x, w, t, geom, boundary=bc, staging="wholestrip")
            bad += held(key, y, x, w, t, dt, bc, sm.stencil_matmul_plain)
            d = diff(y, sm.stencil_matmul_at(x, w, t, geom, boundary=bc))
            if d:
                bad += 1
                print(f"{key}: differs from the default kernel by {d:.3e}")
    for kind, r, t in TILE_BC_CASES:
        wf = np.asarray(fuse_weights(make_weights(StencilSpec(kind, 2, r), seed=1), t),
                        np.float32)
        geom = legacy.tile_geom((1024, 1024), 128, 128, t * r)
        for dt in (torch.float32, torch.bfloat16):
            x = grid((1024, 1024), dt)
            key = f"(1024, 1024) {kind} r={r} t={t} {str(dt)[6:]} 9tile"
            y = legacy.stencil_matmul_9pt(x, wf)
            bad += held(key, y, x, wf, 1, dt, None, sm.stencil_matmul_plain)
            d = diff(y, sm.stencil_matmul_at(x, wf, 1, geom))
            if d:
                bad += 1
                print(f"{key}: differs from the default kernel by {d:.3e}")
    for kind, bc in (("box", None), ("star", ("reflect", "periodic"))):
        w = np.asarray(make_weights(StencilSpec(kind, 2, 1), seed=1), np.float32)
        geom = common.launch_geom((1000, 1030), 4)
        for dt, cdt in pairs:
            xb = grid((3, 1000, 1030), dt)
            for label, at in (("dense", sm.stencil_matmul_at),
                              ("compacted", ss.stencil_sparse_matmul_at)):
                key = f"3 x (1000, 1030) {kind} r=1 t=4 {bc} {str(dt)[6:]} {str(cdt)[6:]} {label}"
                yb = at(xb, w, 4, geom, compute_dtype=cdt, boundary=bc, batched=True)
                hashes[key] = digest(torch, yb)
                d = max(diff(yb[i], at(xb[i], w, 4, geom, compute_dtype=cdt, boundary=bc))
                        for i in range(3))
                if d:
                    bad += 1
                    print(f"{key}: differs from the unbatched calls by {d:.3e}")
    print(f"tile: {len(hashes)} calls ({n2d} 2D, {nlift} lifted 1D, "
          f"{len(hashes) - n2d - nlift} foil and batched), {bad} outside the "
          "limit or unequal where they must be equal")
    bad += save_against(hashes, opts, "tile")
    tile_times(torch, sm, ss, common, legacy, stencil_plan, make_weights, StencilSpec)
    return bad


def tile_times(torch, sm, ss, common, legacy, stencil_plan, make_weights, StencilSpec):
    """The 2D banded kernels' times at 8192^2, f32, t=4: through
    ``stencil_plan`` for every regime, periodic and ``zero``; the kernels
    on a tile resolved once (``stencil_matmul_at`` /
    ``stencil_sparse_matmul_at``); the K8 and K10 foil plans; and 16 x
    2048^2 batches."""
    import numpy as np
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8192, 8192))
                         .astype(np.float32)).cuda()
    geom = common.launch_geom((8192, 8192), 4)
    for kind in ("box", "star"):
        w = np.asarray(make_weights(StencilSpec(kind, 2, 1), seed=0), np.float32)
        for bc in (None, "zero"):
            print(f"8192^2 {kind.capitalize()}-2D1R f32, t=4, boundary {bc}: ms per call")
            for b in ("direct", "fused_direct", "matmul", "fused_matmul",
                      "fused_matmul_reuse", "sparse_matmul", "fused_sparse_matmul", None):
                if b == "fused_matmul" and bc is not None:
                    continue                # the composed kernel is periodic only
                plan = stencil_plan(w, x.shape, torch.float32, 4, backend=b, boundary=bc,
                                    use_sparse_unit=b is not None and "sparse" in b)
                print(f"  {str(b or 'auto'):20s} {ms(torch, lambda: plan(x), 5):.4f}"
                      + (f" ({plan.backend})" if b is None else ""))
            for label, at in (("stencil_banded", sm.stencil_matmul_at),
                              ("stencil_sparse", ss.stencil_sparse_matmul_at)):
                print(f"  kernel {label} on a resolved tile "
                      f"{ms(torch, lambda: at(x, w, 4, geom, boundary=bc), 5):.4f}")
        for b in ("fused_matmul_reuse_wholestrip", "legacy_matmul"):
            plan = stencil_plan(w, x.shape, torch.float32, 4, backend=b)
            print(f"  {kind} {b:30s} {ms(torch, lambda: plan(x), 5):.4f}")
    del x
    xb = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 2048, 2048))
                          .astype(np.float32)).cuda()
    for kind, b, bc in (("box", "fused_matmul_reuse", None),
                        ("star", "fused_sparse_matmul", None),
                        ("star", "fused_sparse_matmul", "zero")):
        w = np.asarray(make_weights(StencilSpec(kind, 2, 1), seed=0), np.float32)
        plan = stencil_plan(w, (2048, 2048), torch.float32, 4, backend=b, boundary=bc,
                            batch=16, use_sparse_unit="sparse" in b)
        print(f"  16 x 2048^2 {kind} {b} {bc}: {ms(torch, lambda: plan(xb), 5):.4f}")


#: The 2D tap-sum probe's grids with an axis shallower than the halo
#: (which the port runs and JAX refuses), with the boundaries each runs.
TAPSUM2D_SHALLOW = (((5, 1030), (None, "zero", "replicate")),
                    ((1000, 6), (None, ("reflect", "zero"))),
                    ((3, 7), (None, "zero")))


def probe_tapsum2d(torch, repo: str, opts, calls: bool = True) -> int:
    """The 2D tap-sum: its registers and CTAs per SM; with ``calls``, every
    call against the plain version's limit, the lifted calls against the
    folded 1D kernel, the foils against the default kernel and the
    batches against the unbatched calls, optionally hashed against
    another checkout's outputs; then its 8192^2 times.  Returns the calls
    that differ."""
    import numpy as np
    sys.path.insert(1, repo)
    from chip_smoke import kernel_limit, lifted_call, plain_chain
    from repro_torch.kernels import _build, common, legacy
    from repro_torch.stencil import StencilSpec, make_weights
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    names = ("stencil_direct", "stencil_direct_foil")
    t0 = time.perf_counter()
    _build.build_all(names + (("stencil_direct1d",) if calls else ()))
    print(f"build {time.perf_counter() - t0:.1f} s")
    print_resources(names)
    fn = getattr(_build.library("stencil_direct"), "stencil_direct_ctas_per_sm", None)
    smem = common.direct_layout(64, 64, 4).smem_bytes
    if fn is None:
        print("  stencil_direct: no stencil_direct_ctas_per_sm in this checkout")
    else:
        import ctypes
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 3
        for dtype, label in ((0, "f32"), (1, "bf16")):
            print(f"  stencil_direct r=1 {label} at 64x64, h=4, {smem} bytes: CTAs per "
                  f"SM {fn(dtype, 0, smem)}, {fn(dtype, 1, smem)} with the fill")
    if not calls:
        tapsum2d_times(torch, sd, common, make_weights, StencilSpec, full=False)
        return 0

    def grid(shape, dt, seed=2):
        return torch.from_numpy(np.random.default_rng(seed).normal(
            size=shape).astype(np.float32)).cuda().to(dt)

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    hashes, bad = {}, 0

    def held(key, y, x, w, t, bc):
        """Hashes ``y`` and holds it to the plain version with chip_smoke.py's
        tap-sum limit (1e-5 max|x| for a float32 grid); returns whether it
        is outside."""
        hashes[key] = digest(torch, y)
        maxima, _ = plain_chain(lambda v: sd.stencil_direct_plain(v, w, 1, bc), x, t)
        tol = (kernel_limit("bf16", float(np.abs(w).sum()), int(np.count_nonzero(w)),
                            maxima, True) if x.dtype == torch.bfloat16 else 1e-5 * maxima[0])
        err = diff(y, sd.stencil_direct_plain(x, w, t, bc))
        if not err <= tol:
            print(f"{key}: max|err| vs plain {err:.3e} > limit {tol:.3e}")
        return not err <= tol

    dtypes = (torch.float32, torch.bfloat16)
    runs = [(shape, c, None) for shape in TILE_GRIDS for c in TILE_CASES] + \
        [((1000, 1030), c, bc) for c in TILE_BC_CASES for bc in TILE_BOUNDARIES] + \
        [(shape, ("box", r, t), bc) for shape, bcs in TAPSUM2D_SHALLOW
         for r, t in ((1, 4), (2, 4)) for bc in bcs]
    for shape, (kind, r, t), bc in runs:
        w = np.asarray(make_weights(StencilSpec(kind, 2, r), seed=1), np.float32)
        for dt in dtypes:
            x = grid(shape, dt)
            key = f"{shape} {kind} r={r} t={t} {bc} {str(dt)[6:]}"
            bad += held(key, sd.stencil_direct(x, w, t, boundary=bc), x, w, t, bc)
    n2d = len(hashes)
    lines = [(n, c, None) for n in TILE_LINES for c in TILE_CASES] + \
        [(n, c, bc) for n in TILE_BC_LINES for c in TILE_BC_CASES
         for bc in ("zero", "reflect", "replicate")]
    for shape, (kind, r, t), bc in lines:
        w = np.asarray(make_weights(StencilSpec(kind, 1, r), seed=1), np.float32)
        for dt in dtypes:
            x = grid(shape, dt)
            key = f"{shape} {kind} r={r} t={t} {bc} {str(dt)[6:]} lifted"
            y = lifted_call(sd, x, w, t, None, bc)
            bad += held(key, y, x, w, t, bc)
            d = diff(y, sd.stencil_direct(x, w, t, boundary=bc))
            if d:
                bad += 1
                print(f"{key}: the folded 1D kernel differs by {d:.3e}")
    nlift = len(hashes) - n2d
    for (kind, r, t), bc in ((c, bc) for c in TILE_BC_CASES for bc in (None, "zero")):
        w = np.asarray(make_weights(StencilSpec(kind, 2, r), seed=1), np.float32)
        geom = common.launch_geom((1000, 1030), t * r)
        for dt in dtypes:
            x = grid((1000, 1030), dt)
            key = f"(1000, 1030) {kind} r={r} t={t} {bc} {str(dt)[6:]} wholestrip"
            y = sd.stencil_direct_at(x, w, t, geom, boundary=bc, staging="wholestrip")
            bad += held(key, y, x, w, t, bc)
            d = diff(y, sd.stencil_direct_at(x, w, t, geom, boundary=bc))
            if d:
                bad += 1
                print(f"{key}: differs from the default kernel by {d:.3e}")
    for kind, r, t in TILE_BC_CASES:
        w = np.asarray(make_weights(StencilSpec(kind, 2, r), seed=1), np.float32)
        geom = legacy.tile_geom((1024, 1024), 128, 128, t * r)
        for dt in dtypes:
            x = grid((1024, 1024), dt)
            key = f"(1024, 1024) {kind} r={r} t={t} {str(dt)[6:]} 9tile"
            y = legacy.stencil_direct_9pt(x, w, t)
            bad += held(key, y, x, w, t, None)
            d = diff(y, sd.stencil_direct_at(x, w, t, geom))
            if d:
                bad += 1
                print(f"{key}: differs from the default kernel by {d:.3e}")
    for kind, bc in (("box", None), ("star", ("reflect", "periodic"))):
        w = np.asarray(make_weights(StencilSpec(kind, 2, 1), seed=1), np.float32)
        for t in (1, 4):
            geom = common.launch_geom((1000, 1030), t)
            for dt in dtypes:
                xb = grid((3, 1000, 1030), dt)
                key = f"3 x (1000, 1030) {kind} r=1 t={t} {bc} {str(dt)[6:]}"
                yb = sd.stencil_direct_at(xb, w, t, geom, boundary=bc, batched=True)
                hashes[key] = digest(torch, yb)
                d = max(diff(yb[i], sd.stencil_direct_at(xb[i], w, t, geom, boundary=bc))
                        for i in range(3))
                if d:
                    bad += 1
                    print(f"{key}: differs from the unbatched calls by {d:.3e}")
    print(f"tapsum2d: {len(hashes)} calls ({n2d} 2D, {nlift} lifted 1D, "
          f"{len(hashes) - n2d - nlift} foil and batched), {bad} outside the "
          "limit or unequal where they must be equal")
    bad += save_against(hashes, opts, "tapsum2d")
    tapsum2d_times(torch, sd, common, make_weights, StencilSpec)
    return bad


def tapsum2d_times(torch, sd, common, make_weights, StencilSpec, full=True):
    """The 2D tap-sum's times at 8192^2, f32, t=4, periodic and ``zero``:
    the kernel through the plan entry on a tile resolved once (one launch
    at t=4; four at t=1, the ``direct`` regime), the K8 and K9 foil plans
    and 16 x 2048^2 batches; with ``full`` also the plans of ``direct``,
    ``fused_direct``, auto and the banded regimes, the plain version and
    F.conv2d (chip_smoke.py's yardstick: one step of the composed kernel,
    periodic; 4 x (F.pad + F.conv2d) under ``zero``)."""
    import numpy as np
    from chip_smoke import conv_yardstick
    from repro_torch.kernels import stencil_plan
    from repro_torch.stencil import fuse_weights, resolve_boundary
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8192, 8192))
                         .astype(np.float32)).cuda()
    geom4 = common.launch_geom((8192, 8192), 4)
    geom1 = common.launch_geom((8192, 8192), 1)
    print(f"bound: {2 * x.numel() * 4 / 3.35e12 * 1e3:.4f} ms (one read and one write "
          "of the grid at 3.35 TB/s)")
    for kind in ("box", "star"):
        w = np.asarray(make_weights(StencilSpec(kind, 2, 1), seed=0), np.float32)
        for bc in (None, "zero"):
            print(f"8192^2 {kind.capitalize()}-2D1R f32, t=4, boundary {bc}: ms per call")

            def four(bc=bc, w=w):
                y = x
                for _ in range(4):
                    y = sd.stencil_direct_at(y, w, 1, geom1, bc)
                return y
            print(f"  kernel, plan entry, t=4 (fused_direct) "
                  f"{ms(torch, lambda: sd.stencil_direct_at(x, w, 4, geom4, bc), 10):.4f}")
            print(f"  kernel, plan entry, 4 x t=1 (direct)  {ms(torch, four, 5):.4f}")
            if not full:
                continue
            for b in ("direct", "fused_direct", None, "fused_matmul", "fused_matmul_reuse"):
                if b == "fused_matmul" and bc is not None:
                    continue                # the composed kernel is periodic only
                plan = stencil_plan(w, x.shape, torch.float32, 4, backend=b, boundary=bc)
                print(f"  plan {str(b or 'auto'):20s} {ms(torch, lambda: plan(x), 5):.4f}"
                      + (f" ({plan.backend})" if b is None else ""))
            print(f"  plain version              "
                  f"{ms(torch, lambda: sd.stencil_direct_plain(x, w, 4, bc), 3):.4f}")
            conv = (conv_yardstick(x, fuse_weights(w, 4), False) if bc is None else
                    conv_yardstick(x, w, False, resolve_boundary(bc, 2), 4))
            print(f"  F.conv2d                   {ms(torch, conv, 3):.4f}"
                  + (" (composed, one step)" if bc is None else " (4 x (F.pad + F.conv2d))"))
        for b in ("fused_direct_wholestrip", "legacy_direct"):
            plan = stencil_plan(w, x.shape, torch.float32, 4, backend=b)
            print(f"  {kind} foil plan {b:26s} {ms(torch, lambda: plan(x), 5):.4f}")
    del x
    xb = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 2048, 2048))
                          .astype(np.float32)).cuda()
    for kind, bc in (("box", None), ("star", "zero")):
        w = np.asarray(make_weights(StencilSpec(kind, 2, 1), seed=0), np.float32)
        plan = stencil_plan(w, (2048, 2048), torch.float32, 4, backend="fused_direct",
                            boundary=bc, batch=16)
        print(f"  16 x 2048^2 {kind} fused_direct {bc}: {ms(torch, lambda: plan(xb), 5):.4f}")


#: The wide 2D tap-sum's cells on 8192^2, f32: (pattern, t, the tile the
#: 2D reserve took where the rule moved it, else None).  Box-2D7R t = 3 /
#: 4 and Box-2D3R t = 8 moved to 64 x 64; t = 5 (64 x 64) and t = 8 (32 x
#: 32) did not move; t = 1 and 2, radii 4-6 at t = 1 (their smallest
#: halos) and Box-2D4R t = 4 stay on 64 x 64, where the layout leaves
#: three to five CTAs a SM by shared memory; Box-2D4R t = 6 and Box-2D5R
#: t = 4 moved from 32 x 32.
WIDE2D_CELLS = (("Box-2D7R", 3, 32), ("Box-2D7R", 4, 16), ("Box-2D3R", 8, 32),
                ("Box-2D7R", 5, None), ("Box-2D7R", 8, None), ("Box-2D7R", 1, None),
                ("Box-2D7R", 2, None), ("Box-2D4R", 1, None), ("Box-2D5R", 1, None),
                ("Box-2D6R", 1, None), ("Box-2D4R", 4, None), ("Box-2D4R", 6, 32),
                ("Box-2D5R", 4, 32))
#: The plans timed on the moved cells on the rule's tile and on the tile
#: the reserve took, pinned (None: auto).
WIDE2D_REGIMES = ("fused_direct", "fused_matmul", "fused_matmul_reuse",
                  "fused_sparse_matmul", None)
#: The probe's grid, and the grid of its checks against the plain version.
WIDE2D_GRID = (8192, 8192)
WIDE2D_CHECK_GRID = (1000, 1030)
#: The 1D lift the 2D rule moved (16 x 32 to 16 x 64 at h = 25..32): Box-1D7R
#: at t = 4 on a line of 2^26 points, f32, and the lift's old width.
WIDE1D_CELL, WIDE1D_LINE, WIDE1D_OLD = (("box", 7, 4), 2**26, 32)
#: The sweep's copies: the default build's CTA width for radii 4..7
#: (DIRECT_WIDE_THREADS).
TAPSUM2D_SWEEP = (512, 1024)


def probe_tapsum2d_wide(torch, repo: str, opts, calls: bool = True) -> int:
    """The wide 2D tap-sum on the tiles the rule gives it: the registers and
    stack frames of the library's instantiations, then on each
    WIDE2D_CELLS cell (8192^2, f32) the kernel through the plan entry on
    the rule's tile, at the CTA width its launch recorded
    (``kernels.launch_tiles``; a checkout without it launches every
    radius on 256 threads), and on the reserve's old tile and 32 x 32
    pinned: every output bit for bit the rule's, each timed.  With
    ``--src`` the checkout's own rule and kernels, so a parent and a
    change time the same cells in one call.  With ``calls``, also each
    cell's output against the plain version, Box-2D7R t = 5 under
    ``zero`` and in bfloat16 on 1000 x 1030 against the plain version,
    and every WIDE2D_REGIMES plan of the moved cells on the rule's tile
    and on the old tile pinned (outputs compared, times).  Then the three
    folded 1D kernels on WIDE1D_CELL on the rule's lift and on the old
    width pinned (bit for bit, times).  Returns the calls that differ."""
    import numpy as np
    sys.path.insert(1, repo)
    from repro_torch import kernels
    from repro_torch.kernels import _build, common, stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    names = ("stencil_direct", "stencil_direct1d", "stencil_banded1d", "stencil_sparse1d") + (
        ("stencil_banded", "stencil_sparse") if calls else ())
    t0 = time.perf_counter()
    _build.build_all(names)
    print(f"build {time.perf_counter() - t0:.1f} s")
    print_resources(("stencil_direct",))
    tiles = getattr(kernels, "launch_tiles", dict)
    shape, bad = WIDE2D_GRID, 0

    def differs(tag, y, ref):
        d = float((y.float() - ref.float()).abs().max())
        if d != 0.0:
            print(f"  {tag}: differs from the rule's launch by {d:.3e}")
        return d != 0.0

    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                         .astype(np.float32)).cuda()
    for pattern, t, old in WIDE2D_CELLS:
        spec = StencilSpec.from_name(pattern)
        w = np.asarray(make_weights(spec, seed=0), np.float32)
        r, h = spec.radius, t * spec.radius
        need = sd.tile_need(shape, r, t, x.dtype)
        geom = common.launch_geom(shape, h, need=need)
        smem = common.direct_layout(geom.strip_m, geom.w_tile, h).smem_bytes
        runs = {f"rule {geom.strip_m}x{geom.w_tile}": geom}
        for pin in sorted({32, old} - {None} - {geom.strip_m}, reverse=True):
            # the reserve's old tile, and 32 x 32 beside the rule's 64 x 64
            what = "old" if pin == old else "pinned"
            runs[f"{what} {pin}x{pin}"] = common.launch_geom(shape, h, pin, pin, need=need)
        ref = sd.stencil_direct_at(x, w, t, geom)
        width = tiles().get("stencil_direct", "/256").split("/")[-1]
        print(f"{pattern} t={t} (h = {h}) on {shape} f32: {smem} bytes, {width} threads")
        if calls:
            err = float((ref - sd.stencil_direct_plain(x, w, t)).abs().max())
            tol = 1e-5 * t * float(x.abs().max())
            bad += not err <= tol
            print(f"  max|err| vs plain {err:.3e} (limit {tol:.3e})")
        for tag, g in runs.items():
            bad += differs(f"{pattern} t={t} {tag}", sd.stencil_direct_at(x, w, t, g), ref)
            print(f"  {tag:28s} "
                  f"{ms(torch, lambda: sd.stencil_direct_at(x, w, t, g), 5):9.4f} ms")
        del ref
    del x
    bad += wide1d_times(torch, np, StencilSpec, make_weights)
    if not calls:
        return bad
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                         .astype(np.float32)).cuda()
    spec = StencilSpec.from_name("Box-2D7R")
    w = np.asarray(make_weights(spec, seed=1), np.float32)
    for dt in (torch.float32, torch.bfloat16):
        for bc in (None, "zero", ("reflect", "periodic")):
            xs = torch.from_numpy(np.random.default_rng(2).normal(size=WIDE2D_CHECK_GRID)
                                  .astype(np.float32)).cuda().to(dt)
            geom = common.launch_geom(xs.shape, 35, need=sd.tile_need(xs.shape, 7, 5, dt))
            y = sd.stencil_direct_at(xs, w, 5, geom, bc)
            err = float((y.float() - sd.stencil_direct_plain(xs, w, 5, bc).float())
                        .abs().max())
            tol = (1e-5 if dt == torch.float32 else 2**-6) * 5 * float(xs.float().abs().max())
            bad += not err <= tol
            print(f"  {WIDE2D_CHECK_GRID} Box-2D7R t=5 {bc} {str(dt)[6:]}: max|err| vs plain "
                  f"{err:.3e} (limit {tol:.3e})")
    for pattern, t, old in WIDE2D_CELLS:
        if old is None:
            continue
        w = np.asarray(make_weights(StencilSpec.from_name(pattern), seed=0), np.float32)
        print(f"{pattern} t={t} plans on {shape} f32, rule's tile / {old}x{old} pinned, ms")
        for b in WIDE2D_REGIMES:
            new = stencil_plan(w, shape, torch.float32, t, backend=b)
            was = stencil_plan(w, shape, torch.float32, t, backend=b, tile_m=old,
                               w_tile=old)
            d = float((new(x) - was(x)).abs().max())
            print(f"  {str(b or 'auto'):20s} {new.backend:20s} {ms(torch, lambda: new(x), 5):9.4f}"
                  f" / {was.backend:20s} {ms(torch, lambda: was(x), 5):9.4f}  max|diff| {d:.3e}")
            bad += d != 0.0 and new.backend == was.backend == "fused_direct"
    print(f"tapsum2d-wide: {bad} launches differ where they must be equal")
    return bad


def wide1d_times(torch, np, StencilSpec, make_weights) -> int:
    """The folded 1D tap-sum, banded and compacted reuse kernels (f32
    operands) on WIDE1D_CELL: on the lift the rule gives, and on
    WIDE1D_OLD pinned, bit for bit, each timed; the launch's recorded
    tile where the checkout records it.  Returns the calls that differ."""
    from repro_torch import kernels
    from repro_torch.kernels import stencil_matmul, stencil_sparse_matmul
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    (kind, r, t), n = WIDE1D_CELL, WIDE1D_LINE
    w = np.asarray(make_weights(StencilSpec(kind, 1, r), seed=0), np.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n,))
                         .astype(np.float32)).cuda()
    tiles = getattr(kernels, "launch_tiles", dict)
    bad = 0
    print(f"Box-1D{r}R t={t} (h = {r * t}) on ({n},) f32: rule's lift / w_tile "
          f"{WIDE1D_OLD} pinned, ms")
    for name, fn, counter in (
            ("tap-sum", sd.stencil_direct, "stencil_direct1d"),
            ("banded reuse", stencil_matmul, "stencil_banded1d"),
            ("compacted reuse", stencil_sparse_matmul, "stencil_sparse1d")):
        y = fn(x, w, t)
        tile = tiles().get(counter, "-")
        y0 = fn(x, w, t, w_tile=WIDE1D_OLD)
        tile0 = tiles().get(counter, "-")
        d = float((y - y0).abs().max())
        bad += d != 0.0
        print(f"  {name:16s} {ms(torch, lambda: fn(x, w, t), 10):9.4f} / "
              f"{ms(torch, lambda: fn(x, w, t, w_tile=WIDE1D_OLD), 10):9.4f}  max|diff| {d:.3e}"
              f"  tiles {tile} / {tile0}")
    return bad


def tapsum2d_sweep(root: str) -> int:
    """The sweep of the wide 2D tap-sum's CTA width over TAPSUM2D_SWEEP: a
    copy of the package per point under build/tapsum2d_sweep/ with
    DIRECT_WIDE_THREADS edited, all built at once, then
    ``tapsum2d-wide-times`` on each copy in turn.  Returns the copies that
    failed."""
    import re
    import shutil
    repo = os.path.dirname(root)
    base = os.path.join(repo, "build", "tapsum2d_sweep")
    shutil.rmtree(base, ignore_errors=True)
    copies = {}
    for a in TAPSUM2D_SWEEP:
        dst = os.path.join(base, f"A{a}", "src")
        shutil.copytree(os.path.join(root, "repro_torch"), os.path.join(dst, "repro_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(dst, "repro_torch", "kernels", "csrc", "stencil_direct.cu")
        with open(path) as f:
            text = f.read()
        text, hits = re.subn(r"#define DIRECT_WIDE_THREADS \d+",
                             f"#define DIRECT_WIDE_THREADS {a}", text)
        if hits != 1:
            raise RuntimeError(f"sweep: DIRECT_WIDE_THREADS matched {hits} times")
        with open(path, "w") as f:
            f.write(text)
        copies[a] = dst
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels "
             "import _build; _build.build_all(('stencil_direct',))")
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-c", build, d])
             for k, d in copies.items()}
    failed = [k for k, p in procs.items() if p.wait() != 0]
    print(f"sweep: {len(copies)} builds in {time.perf_counter() - t0:.1f} s, "
          f"{len(failed)} failed {failed}", flush=True)
    for k, d in copies.items():
        if k in failed:
            continue
        print(f"sweep point DIRECT_WIDE_THREADS={k}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "tapsum2d-wide-times", "--src", d]).returncode
        failed += [k] if rc else []
    return len(failed)


#: The 3D tap-sum probe's grids with an axis shallower than the halo
#: (which the port runs and JAX refuses), with the boundaries each runs.
TAPSUM3D_SHALLOW = (((3, 40, 50), (None, "zero")),
                    ((30, 5, 50), (None, ("periodic", "replicate", "zero"))),
                    ((30, 40, 6), (None, ("zero", "periodic", "periodic"))))
#: The sweep's points: patch height V (DIRECT3D_ROWS), CTAs per SM N at
#: radius 1 (DIRECT3D_MIN_BLOCKS) and planes staged ahead A
#: (DIRECT3D_AHEAD): V x N at A = 4, then A at V = 4, N = 3.
TAPSUM3D_SWEEP = tuple((v, n, 4) for v in (2, 4, 5, 8) for n in (2, 3, 4)) + \
    tuple((4, 3, a) for a in (2, 3, 6))


def tapsum3d_ctas(common, lib) -> None:
    """CTAs per SM of the 3D tap-sum's radius-1 instantiations at the main
    tile (16 x 16 x 32, h = 4; the library's ``stencil_direct3d_ctas_per_sm``
    at the rings' shared memory), where the library has that entry."""
    import ctypes
    fn = getattr(lib, "stencil_direct3d_ctas_per_sm", None)
    if fn is None or not hasattr(common, "Direct3dLayout"):
        print("  stencil_direct3d: no stencil_direct3d_ctas_per_sm in this checkout")
        return
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 4
    smem = common.direct3d_layout(16, 32, 1, 4).smem_bytes
    for dtype, label in ((0, "f32"), (1, "bf16")):
        print(f"  stencil_direct3d r=1 {label} at 16x16x32, h=4, {smem} bytes: CTAs per "
              f"SM {fn(dtype, 1, 0, smem)}, {fn(dtype, 1, 1, smem)} with the fill")


def probe_tapsum3d(torch, repo: str, opts, calls: bool = True, full: bool = True) -> int:
    """The 3D tap-sum: its registers and CTAs per SM; with ``calls``, every
    call against the plain version's limit, the whole-slab foil against
    the default kernel and the batches against the unbatched calls,
    optionally hashed against another checkout's outputs; then its 512^3
    times (``full``: every row of tapsum3d_times).  Returns the calls that
    differ."""
    import numpy as np
    sys.path.insert(1, repo)
    from chip_smoke import kernel_limit, plain_chain
    from repro_torch.kernels import _build, common
    from repro_torch.stencil import StencilSpec, make_weights
    sd = importlib.import_module("repro_torch.kernels.stencil_direct")
    names = ("stencil_direct3d",) + (("stencil_direct3d_foil",) if calls else ())
    t0 = time.perf_counter()
    _build.build_all(names)
    print(f"build {time.perf_counter() - t0:.1f} s")
    print_resources(names)
    tapsum3d_ctas(common, _build.library("stencil_direct3d"))
    if not calls:
        tapsum3d_times(torch, sd, common, make_weights, StencilSpec, full=full)
        return 0

    def grid(shape, dt, seed=2):
        return torch.from_numpy(np.random.default_rng(seed).normal(
            size=shape).astype(np.float32)).cuda().to(dt)

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    hashes, bad = {}, 0

    def held(key, y, x, w, t, bc):
        """Hashes ``y`` and holds it to the plain version with chip_smoke.py's
        tap-sum limit (1e-5 max|x| for a float32 grid); returns whether it
        is outside."""
        hashes[key] = digest(torch, y)
        maxima, _ = plain_chain(lambda v: sd.stencil_direct_plain(v, w, 1, bc), x, t)
        tol = (kernel_limit("bf16", float(np.abs(w).sum()), int(np.count_nonzero(w)),
                            maxima, True) if x.dtype == torch.bfloat16 else 1e-5 * maxima[0])
        err = diff(y, sd.stencil_direct_plain(x, w, t, bc))
        if not err <= tol:
            print(f"{key}: max|err| vs plain {err:.3e} > limit {tol:.3e}")
        return not err <= tol

    dtypes = (torch.float32, torch.bfloat16)
    runs = [(shape, c, bc) for shape in SLAB_GRIDS for c in SLAB_CASES
            for bc in SLAB_BOUNDARIES] + \
        [(shape, ("box", r, t), bc) for shape, bcs in TAPSUM3D_SHALLOW
         for r, t in ((1, 4), (2, 4)) for bc in bcs]
    for shape, (kind, r, t), bc in runs:
        w = np.asarray(make_weights(StencilSpec(kind, 3, r), seed=1), np.float32)
        for dt in dtypes:
            x = grid(shape, dt)
            key = f"{shape} {kind} r={r} t={t} {bc} {str(dt)[6:]}"
            bad += held(key, sd.stencil_direct(x, w, t, boundary=bc), x, w, t, bc)
    for z_slab in (4, 8):                   # pinned tile depths, held to the rule's tile
        for kind, r, t, bc in (("box", 1, 4, None), ("star", 2, 2, "reflect"),
                               ("box", 1, 4, ("replicate", "reflect", "periodic"))):
            w = np.asarray(make_weights(StencilSpec(kind, 3, r), seed=1), np.float32)
            shape = (60, 70, 130)
            geom = common.launch_geom(shape, t * r, None, None, z_slab)
            for dt in dtypes:
                x = grid(shape, dt)
                key = f"{shape} {kind} r={r} t={t} {bc} {str(dt)[6:]} z_slab={z_slab}"
                y = sd.stencil_direct_at(x, w, t, geom, boundary=bc)
                bad += held(key, y, x, w, t, bc)
    n3d = len(hashes)
    for (kind, r, t), bc in ((c, bc) for c in SLAB_CASES[:3] + SLAB_CASES[5:7]
                             for bc in (None, ("replicate", "reflect", "periodic"))):
        w = np.asarray(make_weights(StencilSpec(kind, 3, r), seed=1), np.float32)
        geom = common.launch_geom((60, 70, 130), t * r)
        for dt in dtypes:
            x = grid((60, 70, 130), dt)
            key = f"(60, 70, 130) {kind} r={r} t={t} {bc} {str(dt)[6:]} wholeslab"
            y = sd.stencil_direct_at(x, w, t, geom, boundary=bc, staging="wholestrip")
            bad += held(key, y, x, w, t, bc)
            d = diff(y, sd.stencil_direct_at(x, w, t, geom, boundary=bc))
            if d:
                bad += 1
                print(f"{key}: differs from the default kernel by {d:.3e}")
    for kind, bc in (("box", None), ("star", ("replicate", "reflect", "periodic"))):
        w = np.asarray(make_weights(StencilSpec(kind, 3, 1), seed=1), np.float32)
        for t in (1, 4):
            geom = common.launch_geom((40, 72, 100), t)
            for dt in dtypes:
                xb = grid((3, 40, 72, 100), dt)
                key = f"3 x (40, 72, 100) {kind} r=1 t={t} {bc} {str(dt)[6:]}"
                yb = sd.stencil_direct_at(xb, w, t, geom, boundary=bc, batched=True)
                hashes[key] = digest(torch, yb)
                d = max(diff(yb[i], sd.stencil_direct_at(xb[i], w, t, geom, boundary=bc))
                        for i in range(3))
                if d:
                    bad += 1
                    print(f"{key}: differs from the unbatched calls by {d:.3e}")
    print(f"tapsum3d: {len(hashes)} calls ({n3d} 3D, {len(hashes) - n3d} foil and "
          f"batched), {bad} outside the limit or unequal where they must be equal")
    bad += save_against(hashes, opts, "tapsum3d")
    tapsum3d_times(torch, sd, common, make_weights, StencilSpec)
    return bad


def tapsum3d_times(torch, sd, common, make_weights, StencilSpec, full=True):
    """The 3D tap-sum's times at 512^3, f32, t=4: the kernel through the
    plan entry on a tile resolved once (one launch at t=4; four at t=1,
    the ``direct`` regime), Box-3D1R periodic; with ``full`` also Star-3D1R
    and (replicate, reflect, periodic), the plans of ``direct``,
    ``fused_direct``, auto and the banded regimes, the K8 whole-slab foil
    plan, the plain version, F.conv3d (chip_smoke.py's yardstick) and 8 x
    256^3 batches."""
    import numpy as np
    from chip_smoke import conv_yardstick
    from repro_torch.kernels import stencil_plan
    from repro_torch.stencil import fuse_weights, resolve_boundary
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(512, 512, 512))
                         .astype(np.float32)).cuda()
    geom4 = common.launch_geom((512,) * 3, 4)
    geom1 = common.launch_geom((512,) * 3, 1)
    print(f"bound: {2 * x.numel() * 4 / 3.35e12 * 1e3:.4f} ms (one read and one write "
          "of the grid at 3.35 TB/s); Box-3D1R's FMAs at 67 TFLOP/s "
          f"{4 * 2 * 27 * x.numel() / 67e12 * 1e3:.4f} ms")
    boundaries = (None, ("replicate", "reflect", "periodic")) if full else (None,)
    for kind in ("box", "star") if full else ("box",):
        w = np.asarray(make_weights(StencilSpec(kind, 3, 1), seed=0), np.float32)
        for bc in boundaries:
            print(f"512^3 {kind.capitalize()}-3D1R f32, t=4, boundary {bc}: ms per call")

            def four(bc=bc, w=w):
                y = x
                for _ in range(4):
                    y = sd.stencil_direct_at(y, w, 1, geom1, bc)
                return y
            print(f"  kernel, plan entry, t=4 (fused_direct) "
                  f"{ms(torch, lambda: sd.stencil_direct_at(x, w, 4, geom4, bc), 10):.4f}")
            print(f"  kernel, plan entry, 4 x t=1 (direct)  {ms(torch, four, 5):.4f}")
            if not full:
                continue
            for b in ("direct", "fused_direct", None, "matmul", "fused_matmul",
                      "fused_matmul_reuse"):
                if b == "fused_matmul" and bc is not None:
                    continue                # the composed kernel is periodic only
                plan = stencil_plan(w, x.shape, torch.float32, 4, backend=b, boundary=bc)
                print(f"  plan {str(b or 'auto'):20s} {ms(torch, lambda: plan(x), 5):.4f}"
                      + (f" ({plan.backend})" if b is None else ""))
            if kind == "box":
                plan = stencil_plan(w, x.shape, torch.float32, 4,
                                    backend="fused_direct_wholestrip", boundary=bc)
                print(f"  foil plan fused_direct_wholestrip {ms(torch, lambda: plan(x), 5):.4f}")
            print(f"  plain version              "
                  f"{ms(torch, lambda: sd.stencil_direct_plain(x, w, 4, bc), 3):.4f}")
            conv = (conv_yardstick(x, fuse_weights(w, 4), False) if bc is None else
                    conv_yardstick(x, w, False, resolve_boundary(bc, 3), 4))
            print(f"  F.conv3d                   {ms(torch, conv, 3):.4f}"
                  + (" (composed, one step)" if bc is None else " (4 x (F.pad + F.conv3d))"))
    del x
    xb = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 256, 256, 256))
                          .astype(np.float32)).cuda()
    w = np.asarray(make_weights(StencilSpec("box", 3, 1), seed=0), np.float32)
    plan = stencil_plan(w, (256,) * 3, torch.float32, 4, backend="fused_direct", batch=8)
    print(f"  8 x 256^3 box fused_direct: {ms(torch, lambda: plan(xb), 5):.4f}")
    if full:
        plan1 = stencil_plan(w, (256,) * 3, torch.float32, 4, backend="fused_direct")
        print(f"  the same 8 grids unbatched: "
              f"{ms(torch, lambda: [plan1(g) for g in xb], 3):.4f}")


def tapsum3d_sweep(root: str) -> int:
    """The sweep of the 3D tap-sum's V, N and A over TAPSUM3D_SWEEP: a copy
    of the package per point under build/tapsum3d_sweep/ with the defines
    edited (and the host's DIRECT3D_AHEAD, which sizes the rings), all
    built at once, then ``tapsum3d-quick`` on each copy in turn (its
    registers, stack frame, CTAs per SM, and the t=4 and 4 x t=1
    plan-entry times of Box-3D1R, periodic).  Returns the copies that
    failed."""
    import re
    import shutil
    repo = os.path.dirname(root)
    base = os.path.join(repo, "build", "tapsum3d_sweep")
    shutil.rmtree(base, ignore_errors=True)
    copies = {}
    for v, n, a in TAPSUM3D_SWEEP:
        dst = os.path.join(base, f"V{v}N{n}A{a}", "src")
        shutil.copytree(os.path.join(root, "repro_torch"), os.path.join(dst, "repro_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        kdir = os.path.join(dst, "repro_torch", "kernels")
        for name, edits in (("csrc/stencil_direct3d.cu",
                             ((r"#define DIRECT3D_ROWS \d+", f"#define DIRECT3D_ROWS {v}"),
                              (r"#define DIRECT3D_MIN_BLOCKS \d+",
                               f"#define DIRECT3D_MIN_BLOCKS {n}"),
                              (r"#define DIRECT3D_AHEAD \d+", f"#define DIRECT3D_AHEAD {a}"))),
                            ("common.py", ((r"\nDIRECT3D_AHEAD = \d+", f"\nDIRECT3D_AHEAD = {a}"),))):
            path = os.path.join(kdir, name)
            with open(path) as f:
                text = f.read()
            for pattern, repl in edits:
                text, hits = re.subn(pattern, repl, text)
                if hits != 1:
                    raise RuntimeError(f"sweep: {pattern!r} matched {hits} times in {name}")
            with open(path, "w") as f:
                f.write(text)
        copies[(v, n, a)] = dst
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels "
             "import _build; _build.build_all(('stencil_direct3d',))")
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-c", build, d])
             for k, d in copies.items()}
    failed = [k for k, p in procs.items() if p.wait() != 0]
    print(f"sweep: {len(copies)} builds in {time.perf_counter() - t0:.1f} s, "
          f"{len(failed)} failed {failed}", flush=True)
    for k, d in copies.items():
        if k in failed:
            continue
        print(f"sweep point V={k[0]} N={k[1]} A={k[2]}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "tapsum3d-quick",
                             "--src", d]).returncode
        failed += [k] if rc else []
    return len(failed)

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
