#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), then the build of all
     CUDA libraries from src/repro_torch/kernels/csrc (the nine
     kernels -- among them the folded 1D kernels stencil_direct1d,
     stencil_banded1d and stencil_sparse1d, and the 3D banded kernels
     stencil_banded3d and stencil_sparse3d, one body, csrc/slab_fold.cuh,
     which folds each step's (plane, row) pairs into the MMA rows, reads
     its A operands straight from the f32 region and its bands as Toeplitz
     rows staged once per CTA, and fits two CTAs per SM at the main tile,
     and the 2D banded kernels stencil_banded and stencil_sparse, one body,
     csrc/tile_fold.cuh, its 2D form, which runs a step's 16-row tiles of
     every chunk in passes held in registers, and the 2D tap-sum
     stencil_direct, which stages its region in 16-byte granules and
     keeps every cell in place across its steps, each thread a patch of
     rows x 4 columns, and the 3D tap-sum stencil_direct3d, which streams
     its region plane by plane through a ring of planes per fused step in
     the same cell coordinates -- the traffic foils' second build of four
     of them, and the cluster and workspace forms' builds of the 3D and
     2D ones; one nvcc per library, started together), each one's build
     time, and the
     global load instructions of every foil instantiation in its SASS
     (cuobjdump, which must be there), which must not fall below its
     default twin's; then it starts this script with --count-loads in a
     child process, which builds the foils' libraries once more with
     REPRO_COUNT_LOADS=1, launches every foil kernel on the foil paths'
     grids and two ragged grids, and requires every CTA of each launch to
     have loaded exactly the analytic count of cells; then, in the same
     child, the phase ``audit``: on each rank's main cell (Box, t=4) the
     plans of fused_direct, fused_matmul_reuse and fused_sparse_matmul,
     and direct at 512^3, and one boundary row per rank, built with
     ``audit=True`` (the static auditor, ``repro_torch.audit``: zero
     violations required) and run on the card in the counting build of the
     default kernels, whose least and most cells per CTA must equal the
     auditor's staged cells per CTA (3D: each plane of the stream once);
     it prints the priced and launched read amplification and the
     executed / useful FLOPs of each (its output is printed, and its exit
     checked, after phase 2);
  2. each kernel against its plain PyTorch version on the card, each limit
     built from the plain version's step-by-step maxima and shown to reject
     the plain version one step short: the 2D kernels at 1024^2 and a
     ragged 1000x1030 grid (box/star, r in {1, 3}, t in {1, 4}); the 3D
     kernels at 128^3 and a ragged 60x70x130 grid (box/star, (r, t) in
     {(1,1), (1,4), (2,2), (3,1)}, and Box-3D2R at t=4); the folded 1D
     kernels (tap-sum, banded, compacted) at 2^20, 2^20+3, 67, 1000 and
     3 * 4096 + 3 points (the last three: shorter than one tap-sum
     segment, and three segments and 3 points; box/star, r in {1, 3}, t
     in {1, 4}); float32 and
     bfloat16 grids, the banded kernels with either operand dtype and on
     the composed kernel; then every kernel under non-periodic boundaries
     (zero, reflect, replicate, and the mixed specs ("reflect",
     "periodic") and ("periodic", "zero") in 2D, ("replicate", "reflect",
     "periodic") in 3D) on the ragged 1000x1030 and 40x72x100 grids and
     the 1D kernels at 2^20+3, 67 and 1000 points, box/star, r in {1, 2},
     t in {1, 4} (r=2,
     t=4 runs the 3D kernels on their 8-deep tile at h = 8), each against
     its plain version under the same boundary; the compacted (sparse)
     kernels on every one of these configurations beside the banded ones,
     and on base weights each against the dense banded kernel of the same
     call (the largest difference printed; equal sums required); every
     folded 1D call (the tap-sum's too) also
     against the 2D kernel on the lifted (1, N) view with the same call
     and tile, which it must equal bit for bit (the largest difference
     printed); then the
     traffic foils (K8 whole-strip / whole-slab on the tap-sum and banded
     kernels, 1000x1030 and 60x70x130, periodic and under one boundary
     spec; K9 / K10, the seed 9-tile kernels, on 1024^2 with 128x128
     tiles) with the same limits, and each against the default kernel of
     the same call and tile, which it must equal; then the batch (K11):
     every kernel and foil build at B in {1, 3, 8} on 1000x1030,
     60x70x130 and 2^20+3 (the 9-tile foils on 1024^2), f32 and bf16,
     periodic and under one boundary spec per rank, one launch per
     batched call and every grid bit for bit its unbatched launch; a
     pinned 3D tile depth (z_slab 4 and 8) equal to the rule's tile bit
     for bit; B = 65537 grids of 32x32 in two launches; and batches past
     2^31 cells (33 x 8192^2, 17 x 512^3, 33 x 2^26) whose first and last
     grids equal their unbatched launches;
  3. the main paths, ``stencil_plan(...)(x)`` for each of the five regimes
     and ``auto`` against the ``reference`` backend, with every kernel's
     launches counted from 0 just before each path and read just after:
     2D, 8192^2 float32 (256 MiB per field), Box-2D1R and Star-2D1R; 3D,
     512^3 float32 (512 MiB per field), Box-3D1R and Star-3D1R; 1D, 2^26
     float32 points, Box-1D1R; all at t=4; then the boundary paths, the
     same grids and stencils under "zero" (2D, a Dirichlet-zero smoother),
     ("replicate", "reflect", "periodic") (3D) and "reflect" (1D), with
     every regime but fused_matmul at t=4, fused_matmul at t=1, and the
     check that a fused_matmul plan at t=4 refuses; then on each grid the
     sparse path, ``stencil_plan(..., use_sparse_unit=True)`` with
     sparse_matmul and fused_sparse_matmul at t=4 (and auto at t=4 and
     t=1 on the periodic 2D and 3D grids, beside direct and matmul at t=1:
     Star-2D1R at t=1 is the model's tie that picks sparse_matmul), its
     own launches counted; then the foil paths (FOIL_PATHS: the 9-tile,
     whole-strip / whole-slab foils and the regimes they mirror on
     8192^2 and 512^3) with their own launch counts, and the guarded
     path: ``guarded_stencil_plan`` under REPRO_FAULTS=compile:3 must land
     on fused_direct_wholestrip with the expected events and launches,
     a clean guarded call must return the cached plan object, and under
     REPRO_FAULTS=compile:inf the ladder must raise after its last kernel
     rung (no plain rung on the card); then the batched main paths, as
     many cells per batch as the unbatched path beside them (16 x 2048^2
     Box/Star-2D1R, 8 x 256^3 Box-3D1R, 16 x 2^22 Box-1D1R; every regime
     and auto, batch_mode "auto" = "vmap", with exact launch counts; and
     16 x 2048^2 under "zero" with use_sparse_unit), and the guarded
     batched path (REPRO_FAULTS=compile:3 lands the bucket on
     fused_direct_wholestrip);
  4. times from CUDA events (median of 15 after 3 warm-ups; 5 for the
     slow 3D plain versions and yardsticks): each regime's milliseconds
     per call and microseconds per step beside the model's choice, its
     read amplification and its bound, each kernel on each path (through
     the plan entries on a tile resolved once; the public wrapper's time
     on a host line of its own) beside its
     plain version and an F.conv1d / F.conv2d / F.conv3d yardstick the
     port never calls (on a boundary path: t x (F.pad in the boundary's
     modes, axis by axis, + one F.conv of the base kernel)), on the 1D
     paths each regime beside the 2D kernel on the lifted view doing the
     same calls ("lift_ms") and the folded kernels' entries with their
     registers (cuobjdump), the compacted
     kernel on the Star stencil (1D: Box) beside the dense banded kernel of
     the same call, the kept-row fraction S and the MMA k-steps of both,
     the traffic table of each foil path (bytes requested per launch, ms,
     requested GB/s, for the 9-tile, whole-strip / whole-slab and default
     stagings), each wrapper's host time per launch, the batched paths'
     regime times beside their unbatched twins', and the batch table:
     Box-2D1R at t=4 on 256^2 grids, B in {1, 8, 64, 512}, device and host
     us per grid of the batched ("vmap") and "map" plans beside F.conv2d
     with N = B;
  5. serving: StencilServer on the card under closed-loop traffic
     (Box/Star-2D1R, 256^2, t=1, 2048 requests each, windows of 128),
     every response bit for bit the unbatched plan's, plan-cache hits >=
     requests - signatures, no degraded batch; then the quick run of
     ``python -m repro_torch.benchmarks.serving`` (printed, not gated);
  6. paper: the port's benchmark harness (``python -m
     repro_torch.benchmarks.run``, in-process) prints table2, table3,
     table4, fig10, fig16 and halo; fig16 times fused_direct and
     fused_matmul at 8192^2 (2D) and 512^3 (Box-3D1R), each plan first
     held against ``reference``, and the manifest must list no failed
     module; table2's aten count on CUDA inputs must equal the CPU's bit
     for bit; the cost counter over a fused_direct plan call at 1024^2 must
     report the plan's one kernel launch as ``opaque_launches``; every
     quickstart backend must lie within its tolerance;
  7. distributed: ``stencil_plan(mesh=, shard_spec=, dist_mode=)`` on a
     gloo world of four ranks (child processes, every shard on this card,
     the halos staged through pinned host memory): 8192^2 Box-2D1R at t=4
     over a 2x2 mesh (stepwise, fused) and a 4x1 mesh (stepwise, fused,
     overlap),
     each with fused_direct, fused_matmul_reuse and auto as the local
     update, and under ("reflect", "periodic") with fused_direct; 512^3
     Box-3D1R over four ranks along z (fused; auto, fused_matmul_reuse):
     each plan's launches per shard, exchange rounds and halo bytes
     against its halo plan, the gathered grid against the undistributed
     plan of the same backend, overlap equal to stepwise bit for bit on
     the tap-sum; ms per call across a barrier of the ranks beside the
     undistributed plan's; then REPRO_FAULTS=halo landing every rank on
     the same rung;
  8. llm: the LLM serving path (``repro_torch.launch.serve.serve_llm``, no
     hand-written kernel: the models' ops are PyTorch's) at full width,
     random weights from seed 0 stored in bf16 once, batch 4: llama3.2-1b
     and rwkv6-1.6b (factored WKV) at JAX's serve defaults (prompt 16, gen
     32), every other arch of the registry on a prompt of 8 and 4 generated
     tokens, qwen3-moe-235b-a22b with n_layers cut 94 -> 2 (printed); each
     with finite logits, tokens in the vocabulary, prefill and decode tok/s
     and ms per decode step beside the weight-byte bound; the cached decode
     against the uncached forward pass (``consistency``) on the dense, vlm,
     hybrid and rwkv archs at full depth in bf16 (tolerance twice the
     uncached pass's own bf16 error) and at full width and one layer in
     float32 (1e-4 * max|logit|) and bf16, MoE exempt (its capacity
     depends on S); then every SMOKE arch on the card against the port on
     the CPU (loss_fn and 4 decode steps, float32 and bf16);
  9. train: the LLM training path (``repro_torch.train.loop.train``: the
     models under autograd with remat, AdamW in place; no hand-written
     kernel): llama3.2-1b as registered (16 layers, bf16 compute on f32
     masters) for 4 steps at B=4, S=1024 on SyntheticLM batches, finite
     losses and grad_norm, ms per step (median of steps 2-4), tok/s, peak
     memory, the share of 6 * N * tokens at 989 TFLOP/s, a profile of one
     step, then one step with remat off whose peak must be the higher;
     every other arch at full width, 2 steps at B=2, S=256 (n_layers cut
     where 16 bytes per parameter pass 56 GiB, printed) and one without
     remat; ``examples.train_lm`` at preset 30m with and without int8
     gradients (the loss must fall); crash and resume at preset 30m (10
     steps, checkpoint, resume to 20 against 20 straight: final losses
     within rel 1e-4), with the checkpoint's size and save time; every
     SMOKE arch's train step on the card against the port on the CPU
     (loss, gradients, updated parameters; float32 and bf16).
 10. mesh: the mesh half of the LLM scaffold (``repro_torch.parallel``,
     ``launch.mesh``, ``launch.dryrun``; no hand-written kernel): (a)
     llama3.2-1b as registered, 3 train steps at B=4, S=1024 as DTensors
     on a (1, 1) ("data", "model") mesh of a one-rank NCCL world, which
     must equal 3 plain steps from the same parameters and batches bit
     for bit (losses and every updated leaf), with ms per step of both;
     (b) the GPipe pipeline (``parallel.pipeline``) of its 16 full-width
     blocks over 2 ranks of a gloo world that time-slice the card, 8
     blocks per stage, 4 microbatches of B=4, S=1024 in bf16: 5 ticks and
     5 ring shifts per call and rank, bubble fraction 0.2, the output
     equal to the sequential stack on the same microbatches bit for bit,
     ms per call against it, peak memory per rank; (c) the dry run
     (``python -m repro_torch.launch.dryrun``: one rank of a fake world
     of 256 or 512 ranks traced on meta tensors) of llama3.2-1b train_4k
     and decode_32k, olmoe-1b-7b train_4k and rwkv6-1.6b train_4k on
     both production meshes and JAX's three stencil cells, in three child
     processes started with the run (no card): every record ok, its three
     terms, bottleneck, useful fraction and estimated peak per rank
     printed; (d) the same estimator on (a)'s step (a fake world of one
     rank): its FLOPs against 6 * N * tokens, its compute term against
     (a)'s ms and its estimated peak against (a)'s measured one.
 11. wide (run after the batched paths, before phase 4's host table;
     ``python3 chip_smoke.py --wide`` runs the build and this phase alone):
     the JAX package's own wide stencils and deep halos.  Each kernel
     against its plain version with phase 2's limit, which must reject the
     plain version one step short: the tap-sums at r = 5 and 7 in 1D, 2D
     and 3D, the dense and compacted reuse forms, and the composed
     contraction 72 and 128 deep (2D and 1D; f32 and bf16 operands), 2D
     halos 35 and 56, 3D halos 10, 12 and 14, on phase 2's grids periodic
     and under one non-periodic spec per rank; the launches whose own
     layout fits no tile (the 3D tap-sum's rings and the composed slab past
     h = 10) must raise "too deep", and no other may; one batched call at
     r = 7 bit for bit the loop of its calls.  Then the main paths:
     Box-2D7R on 8192^2 at t = 1..8 and Box-3D2R and Star-3D2R on 512^3
     at t = 5..8, all seven regimes and auto, each against ``reference``
     with exact launch counts, timed with CUDA events, a plan that cannot
     launch raising "too deep" naming its regime when built (3D only);
     Figure 16's Box-2D7R row on both paths; and the phase's JSON entries
     ("stencil_direct (r=7)", "stencil_banded (depth 128)",
     "stencil_direct3d (h=10)", "stencil_banded3d (h=10)"), with the tile
     each ran on as "tile".  Then the tile rule's fourth rung, the
     workspace forms (the 2D and 3D tap-sums and folds built with
     -DREPRO_WORKSPACE: a layout no CTA and no cluster holds, in a device
     workspace, persistent CTAs walking the tiles): each form at the
     deepest cell of its kind on 128^3 / 1024^2 against its plain version
     with phase 2's limit, rejecting the plain version one step short;
     each forced onto the rung (budget=1) on a cell one CTA holds, bit for
     bit its one-CTA launch; at 512^3 auto on Box-3D3R t = 5..8,
     Star-3D3R t = 6..8 and Box-3D7R t = 2, the four fused regimes on
     Box-3D3R t = 8 and the compacted reuse fold on Box-3D7R t = 2, and
     on 1024^2 Box-2D7R at t = 16 and 29, each against ``reference`` with
     its one launch, timed beside its bound and the fastest t-launch
     regime, with its workspace's MiB; more cells at r = 4..7 on 128^3;
     and the forms' JSON entries ("stencil_direct3d (workspace, Box-3D3R
     t=8)", ...), with "workspace_mib" and "grid".
The line before the last is the JSON kernel report, one entry per kernel
and path (the folded 1D kernels as "stencil_direct1d", "stencil_banded1d"
and "stencil_sparse1d", and their boundary and batched forms, with the
lifted 2D kernel's time on the same call as "lift_ms" and their registers
as "registers"; the 2D and 3D banded kernels, "stencil_banded",
"stencil_sparse", "stencil_banded3d" and "stencil_sparse3d" and their
boundary and batched forms, and the 2D and 3D tap-sums, "stencil_direct"
and "stencil_direct3d" and their boundary and batched forms, with the
registers and the CTAs per SM of the
instantiation the call launches as "registers" and "ctas_per_sm"; every
main, boundary and sparse entry with the same call's time through the
public wrapper as "wrapper_ms"; the boundary
paths' as "stencil_direct (zero)" and so on), each with the launches of
its own path's run (the compacted kernels' from the sparse path, with the
dense banded kernel's time as "dense_ms"; the foils' from the foil path,
as "stencil_direct (wholestrip)", "legacy_direct (9-tile)" and so on, with
the default kernel's time as "default_ms" and the bytes one launch
requests as "read_bytes"; the batched kernels' from the batched paths, as
"stencil_direct (batched)" and so on, with the batch as "batch", the
plain loop over the grids as "plain_ms" and F.conv with N = B as
"library_ms"); the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks (NVIDIA; dense): HBM bytes/s, fp32 CUDA-core
#: and TF32 tensor-core FLOP/s.
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12

MAIN_T = 4
#: The main paths: grid shape and the stencils each drives.
PATHS = {
    "2D": ((8192, 8192), (("box", 1), ("star", 1))),
    "3D": ((512, 512, 512), (("box", 1), ("star", 1))),
    "1D": ((2**26,), (("box", 1),)),
}
#: The boundary paths: the same grids and stencils under non-periodic
#: boundaries (a Dirichlet-zero smoother, JAX's test_3d_mixed_modes layout
#: at full size, the 1D kernels under reflect).
BOUNDARY_PATHS = {
    "2D": ((8192, 8192), (("box", 1), ("star", 1)), "zero"),
    "3D": ((512, 512, 512), (("box", 1), ("star", 1)),
           ("replicate", "reflect", "periodic")),
    "1D": ((2**26,), (("box", 1),), "reflect"),
}
#: F.pad's name for each boundary mode.
PAD_MODES = {"periodic": "circular", "zero": "constant", "reflect": "reflect",
             "replicate": "replicate"}
HOST_SHAPES = {2: (256, 256), 3: (32, 32, 32)}
HOST_CALLS = 500
REGIMES = ("direct", "fused_direct", "matmul", "fused_matmul",
           "fused_matmul_reuse", None)          # None = auto
#: The sparse path on each grid: (backend, t), run with use_sparse_unit.
SPARSE_RUNS = [("sparse_matmul", MAIN_T), ("fused_sparse_matmul", MAIN_T)]
#: ... and on the periodic 2D and 3D grids auto at t=MAIN_T and t=1, with
#: the t=1 regimes auto weighs against sparse_matmul (the model prices
#: Star-2D1R at t=1 as a tie), timed in the same run.
SPARSE_AUTO = [(None, MAIN_T), (None, 1), ("direct", 1), ("matmul", 1)]
KERNEL_SOURCES = {
    "stencil_direct": ("src/repro_torch/kernels/csrc/stencil_direct.cu",
                       "src/repro/kernels/stencil_direct.py:102"),
    "stencil_banded": ("src/repro_torch/kernels/csrc/stencil_banded.cu",
                       "src/repro/kernels/stencil_matmul.py:202"),
    "stencil_direct3d": ("src/repro_torch/kernels/csrc/stencil_direct3d.cu",
                         "src/repro/kernels/common.py:1525"),
    "stencil_banded3d": ("src/repro_torch/kernels/csrc/stencil_banded3d.cu",
                         "src/repro/kernels/common.py:1525"),
    # The 1D kernels fold the line the JAX package lifts to a (1, N) grid:
    # the tap-sum into contiguous segments, the banded ones into MMA rows.
    "stencil_direct1d": ("src/repro_torch/kernels/csrc/stencil_direct1d.cu",
                         "src/repro/kernels/stencil_direct.py:139"),
    "stencil_banded1d": ("src/repro_torch/kernels/csrc/stencil_banded1d.cu",
                         "src/repro/kernels/stencil_matmul.py:248"),
    "stencil_sparse": ("src/repro_torch/kernels/csrc/stencil_sparse.cu",
                       "src/repro/kernels/stencil_sparse.py:201"),
    "stencil_sparse3d": ("src/repro_torch/kernels/csrc/stencil_sparse3d.cu",
                         "src/repro/kernels/stencil_sparse.py:201"),
    "stencil_sparse1d": ("src/repro_torch/kernels/csrc/stencil_sparse1d.cu",
                         "src/repro/kernels/stencil_sparse.py:229"),
}
#: The foil paths (K8-K10), at t=MAIN_T against the reference backend, each
#: with its own launch counts: the seed 9-tile foils, the whole-strip /
#: whole-slab foils and the regimes they mirror.
FOIL_PATHS = {
    "2D": ((8192, 8192), (("box", 1), ("star", 1)),
           ("legacy_direct", "fused_direct_wholestrip", "fused_direct",
            "legacy_matmul", "fused_matmul_reuse_wholestrip",
            "fused_matmul_reuse", "direct_wholestrip", "matmul_wholestrip",
            "fused_matmul_wholestrip", "fused_matmul")),
    "3D": ((512, 512, 512), (("box", 1),),
           ("fused_direct_wholestrip", "fused_direct",
            "fused_matmul_reuse_wholestrip", "fused_matmul_reuse",
            "direct_wholestrip", "matmul_wholestrip",
            "fused_matmul_wholestrip", "fused_matmul")),
}
#: The traffic table's rows on each foil path: (group, what reads, backend
#: or "default@9tile" for the default kernel launched on the 9-tile foil's
#: tile, so the seed's bytes compare at one tile).
TRAFFIC_ROWS = {
    2: (("tap-sum", "9-tile", "legacy_direct"),
        ("tap-sum", "region, 9-tile's tile", "default@9tile:direct"),
        ("tap-sum", "whole-strip", "fused_direct_wholestrip"),
        ("tap-sum", "region", "fused_direct"),
        ("banded, composed", "9-tile", "legacy_matmul"),
        ("banded, composed", "region, 9-tile's tile", "default@9tile:matmul"),
        ("banded, composed", "whole-strip", "fused_matmul_wholestrip"),
        ("banded, composed", "region", "fused_matmul"),
        ("banded, reuse", "whole-strip", "fused_matmul_reuse_wholestrip"),
        ("banded, reuse", "region", "fused_matmul_reuse")),
    3: (("tap-sum", "whole-slab", "fused_direct_wholestrip"),
        ("tap-sum", "region", "fused_direct"),
        ("banded, composed", "whole-slab", "fused_matmul_wholestrip"),
        ("banded, composed", "region", "fused_matmul"),
        ("banded, reuse", "whole-slab", "fused_matmul_reuse_wholestrip"),
        ("banded, reuse", "region", "fused_matmul_reuse")),
}
#: The guarded path: auto at t=MAIN_T on 8192^2 under a fault spec that
#: fails every rung above rank 55 (auto, auto+degraded and direct), so the
#: ladder lands on fused_direct_wholestrip.
GUARD_FAULTS = "compile:3"
GUARD_LANDS = "fused_direct_wholestrip"
#: The TPU kernels the foils replace: K8 the whole-strip / whole-slab
#: launch kinds (_assemble_foil), K9 and K10 the seed 9-tile kernels.
FOIL_REPLACES = {"wholestrip": "src/repro/kernels/common.py:1333",
                 "9tile_direct": "src/repro/kernels/legacy.py:102",
                 "9tile_matmul": "src/repro/kernels/legacy.py:155"}
#: The seed 9-tile foils' tile (the JAX default).
LEGACY_TILE = 128
#: What the kernels replace on a boundary path: the per-step fills (K6);
#: for the compacted kernels, the JAX compacted steps with their fills.
FILL_REPLACES = "src/repro/kernels/common.py:309"
SPARSE_FILL_REPLACES = "src/repro/kernels/stencil_sparse.py:181"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn) -> float:
    """Host microseconds per call of ``fn``: wall clock over HOST_CALLS
    calls issued back to back, the card drained before and after."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


def grid(shape, dtype, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda").to(dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def conv_yardstick(x: torch.Tensor, w: np.ndarray, tf32: bool, modes=None,
                   t: int = 1, batched: bool = False):
    """``t`` times: pad the grid by r in each axis's mode (F.pad, axis by
    axis in ascending order; circular by default), then one F.conv1d /
    F.conv2d / F.conv3d of ``w``; ``batched``: ``x`` is a batch of grids,
    the convolution's N."""
    r = (w.shape[0] - 1) // 2
    nd = x.ndim - batched
    wt = torch.from_numpy(np.ascontiguousarray(w)).to(x.device, x.dtype)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]

    def run():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            y = x[:, None] if batched else x[None, None]
            for _ in range(t):
                if modes is None:
                    y = F.pad(y, (r,) * (2 * nd), mode="circular")
                else:
                    for ax, m in enumerate(modes):
                        pad = [0] * (2 * nd)
                        k = 2 * (nd - 1 - ax)  # F.pad lists the last axis first
                        pad[k] = pad[k + 1] = r
                        y = F.pad(y, pad, mode=PAD_MODES[m])
                y = conv(y, wt[None, None])
            return y[:, 0] if batched else y[0, 0]
    return run


def boundary_label(b) -> str:
    return b if isinstance(b, str) else "×".join(b)


def phase_build(kernels, sass: bool = True) -> str:
    """Build every library (one nvcc each, together) and print the card,
    the build times and ptxas's register lines; then, where ``sass``, the
    foils' SASS check (``sass_loads``; the full run starts the counting
    child first and runs the check beside that child's build)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    kernels.build_all()
    from repro_torch.kernels import _build
    print(f"build: all {len(_build.KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.1f} s; each "
          + ", ".join(f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()))
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    if sass:
        sass_loads(_build)
    return card


def sass_loads(_build) -> None:
    """Global load instructions in the SASS of every kernel instantiation
    (cuobjdump, ``repro_torch.kernels.sass``): each foil instantiation must
    keep at least the load instructions of the default instantiation of
    the same kernel, types, radius and fill -- its load loop issues one
    predicated load per window cell and lane, and the volatile sink store
    keeps every load whose value the foil drops.  This counts
    instructions in the binary, not the loads a CTA issues at run time
    (no profiler counter is available)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import sass
    t0 = time.perf_counter()
    loads, foils = {}, set()
    # the workspace forms' libraries instantiate some templates of the
    # main ones under the same names (their bodies in device memory): no
    # twin of a foil's there
    libs = [n for n in _build.KERNELS if not n.endswith("_workspace")]
    with ThreadPoolExecutor(len(libs)) as pool:    # one cuobjdump each
        dumps = pool.map(lambda n: sass.functions(_build._target(n)), libs)
        for name, fns in zip(libs, dumps):
            for fn, instrs in fns.items():
                loads[fn] = sum("LDG" in i for i in instrs)
                if name.endswith("_foil"):
                    foils.add(fn)
    # mangled template arguments end in the staging code, then the void
    # return type: ...Li0EEv... (the tap-sums' argument type names its
    # rank, tap_slots(R, 2), as Li2EE too)
    pairs = {}
    for fn, n in loads.items():
        if fn not in foils:
            continue
        for code, st in ((1, "wholestrip"), (2, "9tile")):
            tail = f"Li{code}EEv"
            if tail in fn:
                base = fn.replace(tail, "Li0EEv", 1)
                check(base in loads, f"sass: no default twin of {fn}")
                check(n >= loads[base], f"sass: {fn} has {n} global loads, "
                                        f"its default twin {loads[base]}")
                pairs.setdefault(st, set()).add((n, loads[base]))
    print("  sass global loads per instantiation, foil vs default twin: "
          + "; ".join(f"{st} {sorted(v)}" for st, v in pairs.items())
          + f" ({time.perf_counter() - t0:.1f} s)")


def plain_chain(step, x: torch.Tensor, t: int):
    """The plain version one step at a time from ``x`` in f32: max|y_s| for
    s = 0..t, and y_{t-1}."""
    v = x.float()
    maxima, prev = [float(v.abs().max())], v
    for _ in range(t):
        prev, v = v, step(v)
        maxima.append(float(v.abs().max()))
    return maxima, prev


def kernel_limit(operands: str, sw: float, n_taps: int, maxima, out_bf16: bool) -> float:
    """Limit on max|kernel - plain| over t = len(maxima) - 1 steps, where
    maxima[s] is the plain version's max|y_s| (the input of step s, and for
    s = t the output).  A difference d in a step's input is at most Σ|w|·d
    in its output.  Each step adds, times Σ|w|·max|y_s|: the f32
    accumulation of either side in its own order, 2·n_taps·2⁻²³; for
    operands "tf32" the kernel's rounding of grid and weights against the
    plain version's exact f32, 2⁻¹⁰ (2⁻¹¹ each); for "bf16", rounded alike
    on both sides, one bf16 ulp, 2⁻⁷, where a differing f32 intermediate
    rounds to the neighbouring value (from s = 1 on: at s = 0 both round
    the same grid).  A bf16 output adds one ulp of max|y_t|."""
    tol = 0.0
    for s in range(len(maxima) - 1):
        e = 2 * n_taps * 2**-23
        if operands == "tf32":
            e += 2**-10
        elif operands == "bf16" and s > 0:
            e += 2**-7
        tol = sw * (tol + e * maxima[s])
    return tol + (2**-7 * maxima[-1] if out_bf16 else 0.0)


def hold_to_plain(tag, key, y, x, plain, step, tk, ops, wk, short, worst,
                  margin) -> None:
    """Hold a kernel's output ``y`` on ``x`` against its plain version with
    the step-wise limit (``kernel_limit``; the f32 tap-sum 1e-5·max|x|),
    and show that the limit rejects the plain version one step short
    (``short``, or the plain chain's step t-1); ``worst`` and ``margin``
    collect err/tol and tol/err(t-1) under ``key``."""
    torch.cuda.synchronize()
    bf = x.dtype == torch.bfloat16
    err = max_err(y, plain())
    maxima, prev = plain_chain(step, x, tk)
    if tag.startswith(("stencil_direct", "legacy_direct")) and not bf:
        tol = 1e-5 * maxima[0]
    else:
        tol = kernel_limit(ops, float(np.abs(wk).sum()),
                           int(np.count_nonzero(wk)), maxima, bf)
    wrong = max_err(y, prev if short is None else short())
    check(y.shape == x.shape and y.dtype == x.dtype,
          f"{tag}: shape/dtype {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
    check(err <= tol, f"{tag}: max|err| {err:.3e} > tol {tol:.3e}")
    check(wrong > tol, f"{tag}: the limit {tol:.3e} also passes the "
                       f"plain version one step short ({wrong:.3e})")
    worst[key] = max(worst.get(key, 0.0), err / tol)
    margin[key] = max(margin.get(key, 0.0), tol / wrong)


def kernel_name(base: str, dim: int) -> str:
    """The kernel a wrapper launches for a grid of rank ``dim``: the 3D
    kernels for 3D grids, the 2D kernels for 2D grids and the folded 1D
    kernels (``...1d``) for 1D grids."""
    return base + {1: "1d", 3: "3d"}.get(dim, "")


def lifted_call(mod, x, w, t, cdt=None, boundary=None):
    """A folded 1D call done by the 2D kernel of ``mod`` (stencil_direct,
    stencil_matmul or stencil_sparse) on the lifted (1, N) view, on the
    same tile: what the port launched for 1D grids before the fold, kept
    for comparison.  ``x`` is one line or a batch of lines (one launch for
    all, each on its own (1, N) view)."""
    from repro_torch.kernels import common
    from repro_torch.stencil import resolve_boundary
    r = (w.shape[0] - 1) // 2
    n = x.shape[-1]
    geom = common.launch_geom((n,), t * r)
    codes = common.kernel_mode_codes(resolve_boundary(boundary, 1))
    dtype = () if mod.__name__.endswith("stencil_direct") else (
        x.dtype if cdt is None else cdt,)
    return mod._launch2d(x.reshape(-1, 1, n), common.lift_weights(np.asarray(w, np.float32)),
                         t, r, *dtype, geom, codes).view(x.shape)


def check_kernels(mods, shapes, cases, worst, margin, vs_dense,
                  boundaries=(None,), vs_lift=None) -> None:
    """Every kernel against its plain version on ``shapes``, for each
    ``(kind, r, t)`` of ``cases`` and each boundary of ``boundaries`` (both
    sides under the same one), the banded and compacted kernels also with
    the other operand dtype (f32 grid, bf16 operands and the reverse) and,
    at t > 1 on a periodic grid, on the composed kernel.  Each limit must
    also reject the plain version one step short, so a kernel that skipped
    a step (or a fill) could not pass.  On base weights each compacted
    kernel is also held against the dense banded kernel of the same call:
    ``vs_dense`` gets the largest difference, which must be 0.  A
    folded 1D call is also held against the 2D kernel on the lifted view
    with the same call and tile (``lifted_call``), which it must equal
    bit for bit; ``vs_lift`` gets the largest difference."""
    _, sm, sd, weights, ss = mods
    from repro_torch.stencil import StencilSpec
    for shape, (kind, r, t), bc in itertools.product(shapes, cases, boundaries):
        dim = len(shape)
        w = weights.make_weights(StencilSpec(kind, dim, r), seed=1)
        wf = weights.fuse_weights(w, t)
        for dtype in (torch.float32, torch.bfloat16):
            x = grid(shape, dtype, seed=2)
            bf = dtype == torch.bfloat16
            other = torch.float32 if bf else torch.bfloat16

            def banded(wk, tk, cdt, short=None, sparse=False):
                ops = "bf16" if cdt == torch.bfloat16 else "tf32"
                base, run, pv = (
                    ("stencil_sparse", ss.stencil_sparse_matmul, ss.stencil_sparse_matmul_plain)
                    if sparse else
                    ("stencil_banded", sm.stencil_matmul, sm.stencil_matmul_plain))
                dense = (lambda: sm.stencil_matmul(x, wk, tk, compute_dtype=cdt, boundary=bc)
                         ) if sparse and wk is w else None
                lift = (lambda: lifted_call(ss if sparse else sm, x, wk, tk, cdt, bc)
                        ) if dim == 1 else None
                return (f"{kernel_name(base, dim)}[{str(cdt)[6:]} operands]",
                        lambda: run(x, wk, tk, compute_dtype=cdt, boundary=bc),
                        lambda: pv(x, wk, tk, compute_dtype=cdt, boundary=bc),
                        lambda v: pv(v, wk, 1, compute_dtype=cdt, boundary=bc),
                        tk, ops, wk, short, dense, lift)
            cases_ = [
                (kernel_name("stencil_direct", dim),
                 lambda: sd.stencil_direct(x, w, t, boundary=bc),
                 lambda: sd.stencil_direct_plain(x, w, t, bc),
                 lambda v: sd.stencil_direct_plain(v, w, 1, bc), t, "f32", w, None, None,
                 (lambda: lifted_call(sd, x, w, t, None, bc)) if dim == 1 else None)]
            for sparse in (False, True):
                cases_ += [banded(w, t, dtype, sparse=sparse), banded(w, t, other, sparse=sparse)]
                if t > 1 and bc is None:
                    # One step short of the composed kernel: depth t-1.
                    cases_.append(banded(wf, 1, dtype, lambda: sm.stencil_matmul_plain(
                        x, weights.fuse_weights(w, t - 1), 1, compute_dtype=dtype),
                        sparse=sparse))
            for name, kern, plain, step, tk, ops, wk, short, dense, lift in cases_:
                y = kern()
                tag = (f"{name} {kind} r={r} t={t} {shape} {str(dtype)[6:]}"
                       + ("" if tk == t else " composed")
                       + ("" if bc is None else f" boundary={boundary_label(bc)}"))
                kname = name.split("[")[0]
                key = kname + ("" if bc is None else " (boundaries)")
                hold_to_plain(tag, key, y, x, plain, step, tk, ops, wk, short,
                              worst, margin)
                if dense is not None:
                    diff = max_err(y, dense())
                    check(diff == 0.0, f"{tag}: differs from the dense kernel of the "
                                       f"same call by {diff:.3e}")
                    vs_dense[key] = max(vs_dense.get(key, 0.0), diff)
                if lift is not None:
                    diff = max_err(y, lift())
                    check(diff == 0.0, f"{tag}: differs from the 2D kernel on the lifted "
                                       f"view by {diff:.3e}")
                    vs_lift[key] = max(vs_lift.get(key, 0.0), diff)


#: Phase 2's 1D lines: 2^20 and 2^20 + 3 points, two lines shorter than
#: one CTA segment of the folded tap-sum (64 tiles of 64 points), and one
#: of three segments and 3 points.
SHORT_LINES = ((67,), (1000,))
LINE_SHAPES = ((2**20,), (2**20 + 3,)) + SHORT_LINES + ((3 * 64 * 64 + 3,),)


def phase_kernels_vs_plain(mods) -> None:
    worst, margin, vs_dense, vs_lift = {}, {}, {}, {}
    check_kernels(mods, ((1024, 1024), (1000, 1030)),
                  [(k, r, t) for k in ("box", "star") for r in (1, 3) for t in (1, 4)],
                  worst, margin, vs_dense)
    check_kernels(mods, ((128, 128, 128), (60, 70, 130)),
                  [(k, r, t) for k in ("box", "star")
                   for r, t in ((1, 1), (1, 4), (2, 2), (3, 1))] + [("box", 2, 4)],
                  worst, margin, vs_dense)
    check_kernels(mods, LINE_SHAPES,
                  [(k, r, t) for k in ("box", "star") for r in (1, 3) for t in (1, 4)],
                  worst, margin, vs_dense, vs_lift=vs_lift)
    # Non-periodic boundaries: every uniform mode and one mixed spec per
    # rank, on ragged grids; r = 2, t = 4 runs the 3D kernels on their
    # 8-deep tile at h = 8, and the 1D kernels fill the line's ends only.
    uniform = ("zero", "reflect", "replicate")
    bc_cases = [(k, r, t) for k in ("box", "star") for r in (1, 2) for t in (1, 4)]
    check_kernels(mods, ((1000, 1030),), bc_cases, worst, margin, vs_dense,
                  uniform + (("reflect", "periodic"), ("periodic", "zero")))
    check_kernels(mods, ((40, 72, 100),), bc_cases, worst, margin, vs_dense,
                  uniform + (("replicate", "reflect", "periodic"),))
    check_kernels(mods, ((2**20 + 3,),) + SHORT_LINES, bc_cases, worst, margin, vs_dense,
                  uniform, vs_lift=vs_lift)
    print("kernels vs plain: all configurations within tolerance; worst err/tol "
          + ", ".join(f"{k}={v:.3f}" for k, v in worst.items()))
    print("  and every limit rejects the plain version one step short; worst "
          "tol/err(t-1) " + ", ".join(f"{k}={v:.3f}" for k, v in margin.items()))
    print("  compacted vs dense banded kernel, same call, base weights: max|diff| "
          + ", ".join(f"{k}={v:.3e}" for k, v in vs_dense.items()))
    print("  folded 1D kernels vs the 2D kernel on the lifted (1, N) view, same call and "
          "tile: max|diff| " + ", ".join(f"{k}={v:.3e}" for k, v in vs_lift.items()))


def check_foils(mods, shapes, cases, boundaries, worst, margin, vs_default):
    """Each whole-strip / whole-slab foil kernel (the tap-sum and banded
    kernels with the foils' staging) against its plain version with the
    phase-2 limit, rejecting the plain version one step short, and against
    the default kernel of the same call: same tile, same body, only the
    bytes read differ, so the sums must be equal (``vs_default`` gets the
    largest difference)."""
    _, sm, sd, weights, _ = mods
    from repro_torch.kernels import common
    from repro_torch.stencil import StencilSpec
    for shape, (kind, r, t), bc in itertools.product(shapes, cases, boundaries):
        dim = len(shape)
        w = weights.make_weights(StencilSpec(kind, dim, r), seed=1)
        geom = common.launch_geom(shape, t * r)
        for dtype in (torch.float32, torch.bfloat16):
            x = grid(shape, dtype, seed=2)
            ops = "bf16" if dtype == torch.bfloat16 else "tf32"
            for base, run, plain, step, kops in (
                    ("stencil_direct",
                     lambda st: sd.stencil_direct_at(x, w, t, geom, boundary=bc, staging=st),
                     lambda: sd.stencil_direct_plain(x, w, t, bc),
                     lambda v: sd.stencil_direct_plain(v, w, 1, bc), "f32"),
                    ("stencil_banded",
                     lambda st: sm.stencil_matmul_at(x, w, t, geom, boundary=bc,
                                                  staging=st),
                     lambda: sm.stencil_matmul_plain(x, w, t, boundary=bc),
                     lambda v: sm.stencil_matmul_plain(v, w, 1, compute_dtype=dtype,
                                                       boundary=bc), ops)):
                name = (f"{kernel_name(base, dim)} "
                        f"({'wholeslab' if dim == 3 else 'wholestrip'})")
                y = run("wholestrip")
                tag = (f"{name} {kind} r={r} t={t} {shape} {str(dtype)[6:]}"
                       + ("" if bc is None else f" boundary={boundary_label(bc)}"))
                key = name + ("" if bc is None else " (boundaries)")
                hold_to_plain(tag, key, y, x, plain, step, t, kops, w, None,
                              worst, margin)
                diff = max_err(y, run("region"))
                check(diff == 0.0, f"{tag}: differs from the default kernel "
                                   f"of the same call by {diff:.3e}")
                vs_default[key] = max(vs_default.get(key, 0.0), diff)


def check_9tile(mods, shape, cases, worst, margin, vs_default):
    """The seed 9-tile foils (K9 ``stencil_direct_9pt``, K10
    ``stencil_matmul_9pt`` on the composed kernel, 128 x 128 tiles) against
    their regimes' plain versions with the phase-2 limit, and against the
    default kernels launched on the same tile (equal sums required)."""
    _, sm, sd, weights, _ = mods
    from repro_torch.kernels import legacy
    from repro_torch.stencil import StencilSpec
    for kind, r, t in cases:
        w = weights.make_weights(StencilSpec(kind, 2, r), seed=1)
        wf = weights.fuse_weights(w, t)
        geom = legacy.tile_geom(shape, LEGACY_TILE, LEGACY_TILE, t * r)
        for dtype in (torch.float32, torch.bfloat16):
            x = grid(shape, dtype, seed=2)
            for name, run, default, plain, step, tk, kops, wk, short in (
                    ("legacy_direct (9-tile)",
                     lambda: legacy.stencil_direct_9pt(x, w, t),
                     lambda: sd.stencil_direct_at(x, w, t, geom),
                     lambda: sd.stencil_direct_plain(x, w, t),
                     lambda v: sd.stencil_direct_plain(v, w, 1), t, "f32", w, None),
                    ("legacy_matmul (9-tile)",
                     lambda: legacy.stencil_matmul_9pt(x, wf),
                     lambda: sm.stencil_matmul_at(x, wf, 1, geom),
                     lambda: sm.stencil_matmul_plain(x, wf, 1),
                     lambda v: sm.stencil_matmul_plain(v, wf, 1, compute_dtype=dtype),
                     1, "bf16" if dtype == torch.bfloat16 else "tf32", wf,
                     (lambda: sm.stencil_matmul_plain(
                         x, weights.fuse_weights(w, t - 1), 1)) if t > 1 else None)):
                y = run()
                tag = f"{name} {kind} r={r} t={t} {shape} {str(dtype)[6:]}"
                hold_to_plain(tag, name, y, x, plain, step, tk, kops, wk, short,
                              worst, margin)
                diff = max_err(y, default())
                check(diff == 0.0, f"{tag}: differs from the default kernel on "
                                   f"its tile by {diff:.3e}")
                vs_default[name] = max(vs_default.get(name, 0.0), diff)


#: The argument that runs only the load count (COUNT_LOADS), in the child
#: process phase 1 starts.
COUNT_FLAG = "--count-loads"
#: The load count's grids: the foil paths' and the ragged phase-2 grids
#: under a boundary spec (Box at t=MAIN_T; the 9-tile foils on the
#: periodic 8192^2 only, where their tile divides the grid).
COUNT_SHAPES = (((8192, 8192), None), ((1000, 1030), "zero"),
                ((512, 512, 512), None),
                ((60, 70, 130), ("replicate", "reflect", "periodic")))


def start_count_loads() -> subprocess.Popen:
    """Start this script with COUNT_FLAG in a child process whose
    libraries count loads (REPRO_COUNT_LOADS=1: they build anew, beside
    the uncounted ones); it runs while phase 2 checks the kernels."""
    env = dict(os.environ, REPRO_COUNT_LOADS="1")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), COUNT_FLAG],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_count_loads(child: subprocess.Popen) -> None:
    t0 = time.perf_counter()
    out, _ = child.communicate(timeout=600)
    print(f"load count: waited {time.perf_counter() - t0:.1f} s for the counting child")
    for line in out.splitlines():
        print(f"  {line}")
    check(child.returncode == 0,
          f"load count: the counting process exited {child.returncode}")


def phase_count_loads(mods) -> None:
    """Loads per CTA of every foil kernel, counted at run time by the
    counting build of the libraries (REPRO_COUNT_LOADS=1): the least
    and the most cells a CTA of the launch loaded must both equal the
    analytic count, ``common.staged_read_bytes`` over the CTAs of the
    launch, on COUNT_SHAPES."""
    import ctypes
    _, sm, sd, weights, _ = mods
    from repro_torch.kernels import _build, common, legacy
    from repro_torch.stencil import StencilSpec
    check(os.environ.get("REPRO_COUNT_LOADS") == "1",
          "load count: REPRO_COUNT_LOADS=1 is not set")
    t0 = time.perf_counter()
    # every library this child launches: all but the cluster forms of the
    # 3D tap-sum and the compacted slab and the workspace forms, which no
    # counted run takes
    names = tuple(k for k in _build.KERNELS
                  if k not in ("stencil_direct3d_cluster", "stencil_sparse3d_cluster")
                  and not k.endswith("_workspace"))
    _build.build_all(names)
    print(f"load count: the counting builds of {len(names)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")

    def counts(lib):
        fn = _build.library(lib).repro_load_counts
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_uint)], ctypes.c_int
        out = (ctypes.c_uint * 2)()
        _build.check(fn(out), lib)
        return out[0], out[1]

    for shape, bc in COUNT_SHAPES:
        dim = len(shape)
        w = weights.make_weights(StencilSpec("box", dim, 1), seed=0)
        x = grid(shape, torch.float32, seed=0)
        geom = common.launch_geom(shape, MAIN_T)
        runs = [(kernel_name("stencil_direct", dim), "wholestrip", geom,
                 lambda: sd.stencil_direct_at(x, w, MAIN_T, geom, boundary=bc,
                                              staging="wholestrip")),
                (kernel_name("stencil_banded", dim), "wholestrip", geom,
                 lambda: sm.stencil_matmul_at(x, w, MAIN_T, geom, boundary=bc,
                                              staging="wholestrip"))]
        if dim == 2 and bc is None:
            lgeom = legacy.tile_geom(shape, LEGACY_TILE, LEGACY_TILE, MAIN_T)
            wf = weights.fuse_weights(w, MAIN_T)
            runs += [("stencil_direct", "9tile", lgeom,
                      lambda: legacy.stencil_direct_9pt(x, w, MAIN_T)),
                     ("stencil_banded", "9tile", lgeom,
                      lambda: legacy.stencil_matmul_9pt(x, wf))]
        for kern, st, g, run in runs:
            lib = f"{kern}_foil"
            torch.cuda.synchronize()
            counts(lib)                               # start afresh
            run()
            torch.cuda.synchronize()
            lo, hi = counts(lib)
            ctas = int(np.prod(common.launch_grid(shape, g)))
            want = common.staged_read_bytes(shape, g, st, 1) // ctas
            tile = "x".join(str(n) for n in ((g.z_slab,) if dim == 3 else ())
                            + (g.strip_m, g.w_tile))
            what = "wholeslab" if dim == 3 else st
            tag = (f"{kern} ({what}) {shape} tile {tile}"
                   + ("" if bc is None else f" boundary={boundary_label(bc)}"))
            check(lo == hi == want, f"load count {tag}: a CTA loaded {lo}..{hi} "
                                    f"cells, the analytic count is {want}")
            print(f"load count {tag}: every one of {ctas} CTAs loaded {want} cells "
                  f"(least {lo}, most {hi}; analytic {want})")
        del x


#: The audit phase's plans (COUNT_FLAG child): the fused regimes on each
#: rank's main cell at t=MAIN_T, direct on 512^3, and one boundary row per
#: rank (fused_direct under the boundary path's spec), each a box of
#: radius 1; then phase wide's deep cells: Box-2D7R at t = 8 composed
#: (the 2D fold 128 deep, h = 56) and Box-3D2R at t = 5 (h = 10) on the
#: 3D tap-sum's rings, and at t = 6 (h = 12) the composed slab over a
#: cluster of 8 CTAs split by dz, whose CTAs each stage the planes their
#: bands read and count as one (csrc/cluster.cuh).  Rows: (path, backend,
#: boundary, radius, t).
AUDIT_RUNS = ("fused_direct", "fused_matmul_reuse", "fused_sparse_matmul")
AUDIT_EXTRA = (("3D", "direct", None, 1, MAIN_T),
               ("2D", "fused_direct", BOUNDARY_PATHS["2D"][2], 1, MAIN_T),
               ("3D", "fused_direct", BOUNDARY_PATHS["3D"][2], 1, MAIN_T),
               ("1D", "fused_direct", BOUNDARY_PATHS["1D"][2], 1, MAIN_T),
               ("2D", "fused_matmul", None, 7, 8),
               ("3D", "fused_direct", None, 2, 5),
               ("3D", "fused_matmul", None, 2, 6))


def phase_audit(mods) -> None:
    """The static auditor's measured witness (COUNT_FLAG child, counting
    build of every library): each AUDIT_RUNS / AUDIT_EXTRA plan is built
    with ``audit=True`` and must carry zero violations; run once on the
    card, the least and the most cells a CTA of its kernel staged must
    equal the auditor's (``blocks/staged-cells``: the windows, in whole
    16-byte granules where the kernel copies granules; in 3D each plane of
    the stream once, as ``staged_read_bytes`` charges it; the persistent 1D
    kernels per segment or CTA tile)."""
    import ctypes
    kernels, sm, sd, weights, ss = mods
    wrappers = {"direct": sd, "matmul": sm, "sparse_matmul": ss}
    from repro_torch.audit.scratch import launch_layout
    from repro_torch.kernels import _build, common, registry
    from repro_torch.stencil import StencilSpec

    def counts(lib):
        fn = _build.library(lib).repro_load_counts
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_uint)], ctypes.c_int
        out = (ctypes.c_uint * 2)()
        _build.check(fn(out), lib)
        return out[0], out[1]

    rows = [(label, b, None, 1, MAIN_T) for label in PATHS for b in AUDIT_RUNS]
    rows += list(AUDIT_EXTRA)
    for label, backend, bc, r, t in rows:
        shape = PATHS[label][0]
        dim = len(shape)
        w = weights.make_weights(StencilSpec("box", dim, r), seed=0)
        plan = kernels.stencil_plan(w, shape, torch.float32, t,
                                    backend=backend, boundary=bc, audit=True,
                                    use_sparse_unit="sparse" in backend,
                                    use_cache=False)
        rep = plan.audit_report
        tag = (f"{backend} {shape} r={r} t={t}"
               + ("" if bc is None else f" boundary={boundary_label(bc)}"))
        check(rep is not None and rep.exempt is None,
              f"audit {tag}: no report attached")
        check(rep.ok, f"audit {tag}: {rep.summary()}")
        launch = registry.get_backend(backend).audit(plan.ctx).launches[0]
        lib = wrappers[launch.engine].kernel_source(dim)
        if isinstance(launch_layout(launch), common.ClusterLayout):
            lib += "_cluster"                   # the cluster form's library
        staged = rep.check("blocks/staged-cells").actual
        want = (staged["per_cta_least"], staged["per_cta_most"])
        x = grid(shape, torch.float32, seed=0)
        torch.cuda.synchronize()
        counts(lib)                                   # start afresh
        plan(x)
        torch.cuda.synchronize()
        got = counts(lib)
        check(got == want, f"audit {tag}: {lib} CTAs staged {got[0]}..{got[1]} "
                           f"cells, the auditor counts {want[0]}..{want[1]}")
        pvl = rep.check("blocks/priced-vs-launched")
        fl = rep.flops
        print(f"audit {tag}: {len(rep.checks)} checks, 0 violations; {lib} "
              f"staged {got[0]}..{got[1]} cells per CTA on the card = the "
              f"auditor's {want[0]}..{want[1]} (windows x "
              f"{staged['excess']:.4f})")
        print(f"audit {tag}: read_amp priced {pvl.expected['priced_amp']:.4f} "
              f"launched {pvl.actual['launched_amp']:.4f} (grid-free strip "
              f"{pvl.actual['grid_free_amp']:.4f})")
        print(f"audit {tag}: {fl['unit']} FLOPs executed {fl['executed']} / "
              f"useful {fl['useful']} = {fl['redundancy']:.4f}"
              + ("" if fl["unit"] != "matrix" else
                 f" (real tiles {fl['redundancy_tiles']:.4f}; "
                 f"{fl['mma_sync']} mma.sync, {fl['zero_k4']} over zero "
                 "band rows)"))
        del x


def phase_foils_vs_plain(mods) -> None:
    worst, margin, vs_default = {}, {}, {}
    cases = [(k, r, t) for k in ("box", "star") for r in (1, 2) for t in (1, 4)]
    check_foils(mods, ((1000, 1030),), cases, (None, "zero"), worst, margin,
                vs_default)
    check_foils(mods, ((60, 70, 130),),
                [(k, r, t) for k in ("box", "star") for r, t in ((1, 1), (1, 4), (2, 2))],
                (None, ("replicate", "reflect", "periodic")), worst, margin, vs_default)
    check_9tile(mods, (1024, 1024), cases, worst, margin, vs_default)
    print("foil kernels vs plain: all configurations within tolerance; worst err/tol "
          + ", ".join(f"{k}={v:.3f}" for k, v in worst.items()))
    print("  and every limit rejects the plain version one step short; worst "
          "tol/err(t-1) " + ", ".join(f"{k}={v:.3f}" for k, v in margin.items()))
    print("  foil vs the default kernel of the same call and tile: max|diff| "
          + ", ".join(f"{k}={v:.3e}" for k, v in vs_default.items()))


def expected_launches(backend: str, t: int, dim: int):
    """The counter a plan of ``backend`` launches and how often per call:
    a foil counts under ``<kernel> (<staging>)`` (1D: the lift's own)."""
    if backend.startswith("legacy_"):
        return f"stencil_{'direct' if backend == 'legacy_direct' else 'banded'} (9tile)", 1
    regime = backend[:-len("_wholestrip")] if backend.endswith("_wholestrip") else backend
    base, n = {"direct": ("stencil_direct", t), "fused_direct": ("stencil_direct", 1),
               "matmul": ("stencil_banded", t), "fused_matmul": ("stencil_banded", 1),
               "fused_matmul_reuse": ("stencil_banded", 1),
               "sparse_matmul": ("stencil_sparse", t),
               "fused_sparse_matmul": ("stencil_sparse", 1)}[regime]
    name = kernel_name(base, dim)
    if regime != backend and dim > 1:
        name += " (wholeslab)" if dim == 3 else " (wholestrip)"
    return name, n


def phase_main_path(mods, label, x, ws, boundary=None, runs=None, sparse=False,
                    batch=None):
    """Drive every regime and auto through stencil_plan on one path, the
    launch counts set to 0 just before and read just after; returns the
    plans, the outputs' errors and the counts.  Under a non-periodic
    ``boundary``, fused_matmul runs at t=1 (its plan at t=MAIN_T must
    refuse) and every other regime and auto at t=MAIN_T.  With ``runs``,
    a list of (backend, t), those plans only (``sparse``: built with
    ``use_sparse_unit=True``, the sparse path).  ``batch``: ``x`` holds that
    many grids and every plan is a batched one (batch_mode "auto", which is
    "vmap" on the card: each kernel call one launch for the whole batch,
    so the expected launches are the unbatched plan's).  Every kernel a
    plan of the path runs must have launched."""
    kernels = mods[0]
    from repro_torch.kernels import stencil_plan
    shape = tuple(x.shape[1:] if batch else x.shape)
    dim = len(shape)
    mx = float(x.abs().max())
    periodic = boundary is None
    listed = runs is not None
    if not listed:
        runs = [(b, MAIN_T) for b in REGIMES if periodic or b != "fused_matmul"]
        if not periodic:
            runs.append(("fused_matmul", 1))
    results, launched = {}, set()
    kernels.reset_launch_counts()
    for name, w in ws.items():
        refs = {}
        sw = float(np.abs(w).sum())
        for backend, t in runs:
            if t not in refs:
                refs[t] = stencil_plan(w, shape, torch.float32, t, backend="reference",
                                       boundary=boundary, batch=batch)(x)
            plan = stencil_plan(w, shape, torch.float32, t, backend=backend,
                                boundary=boundary, use_sparse_unit=sparse,
                                batch=batch)
            check(batch is None or plan.batch_mode == "vmap",
                  f"{name} {plan.backend}: batch_mode {plan.batch_mode}")
            before = kernels.launch_counts()
            y = plan(x)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            kname, n = expected_launches(plan.backend, t, dim)
            launched.add(kname)
            delta = {k: after[k] - before[k] for k in after}
            check(delta[kname] == n and sum(delta.values()) == n,
                  f"{name} {plan.backend}: launches {delta}, expected {n} "
                  f"of {kname}")
            check(tuple(y.shape) == tuple(x.shape) and y.dtype == torch.float32,
                  f"{name} {plan.backend}: shape/dtype")
            check(bool(torch.isfinite(y).all()), f"{name} {plan.backend}: non-finite")
            err = max_err(y, refs[t])
            tol = (1e-5 * t * mx if kname.startswith("stencil_direct")
                   else t * 2**-10 * sw * mx)
            check(err <= tol, f"{name} {plan.backend} t={t}: max|err| vs reference "
                              f"{err:.3e} > tol {tol:.3e}")
            regime = (backend or "auto") + ("" if t == MAIN_T else f" (t={t})")
            results[(name, regime)] = (plan, err, tol)
            del y
        del refs
        if not periodic and not listed:
            try:
                stencil_plan(w, shape, torch.float32, MAIN_T, backend="fused_matmul",
                             boundary=boundary)
            except ValueError as e:
                check("monolithic fusion" in str(e), f"{name} fused_matmul: {e}")
            else:
                raise SmokeFailure(f"{name}: a fused_matmul plan at t={MAIN_T} "
                                   f"under boundary={boundary!r} did not refuse")
    counts = kernels.launch_counts()
    for k in sorted(launched):
        check(counts[k] > 0, f"kernel {k} was not launched on the {label} path")
    print(f"main path {label}: {', '.join(dict.fromkeys(r for _, r in results))} x "
          f"{list(ws)} on {tuple(x.shape)} float32 match the reference"
          + ("" if periodic or listed else f", fused_matmul at t={MAIN_T} refuses")
          + f"; launches {counts}")
    return results, counts


def lifted_plan(mods, plan, w, x, boundary=None):
    """The calls a 1D plan makes, done by the 2D kernels on the lifted
    (1, N) view (``lifted_call``)."""
    _, sm, sd, weights, ss = mods
    t, backend = plan.t, plan.backend
    mod = sd if backend.endswith("direct") else ss if "sparse" in backend else sm
    if backend in ("direct", "matmul", "sparse_matmul"):
        def run():
            y = x
            for _ in range(t):
                y = lifted_call(mod, y, w, 1, None, boundary)
            return y
        return run
    if backend == "fused_matmul":
        wf = weights.fuse_weights(w, t)
        return lambda: lifted_call(sm, x, wf, 1, None, boundary)
    if backend in ("fused_direct", "fused_matmul_reuse", "fused_sparse_matmul"):
        return lambda: lifted_call(mod, x, w, t, None, boundary)
    return None


def phase_regime_times(label, x, ws, results, card, twins=None, lift=None):
    """Each plan's ms per call on ``x`` beside the model's choice, its read
    amplification, its bound and its error; returns the ms by (stencil,
    regime).  ``twins``: another path's returned times (the unbatched path
    of the same cells), printed beside as the ratio.  ``lift``: ``(mods,
    boundary)`` on an unbatched 1D path, where each regime is also timed
    doing its calls by the 2D kernels on the lifted view (``lift_ms``,
    returned under (stencil, regime + " lift"))."""
    n = x.numel()
    print(f"times on {card}, {label} path ({tuple(x.shape)} float32, t={MAIN_T} unless "
          "named; bound = max(bytes / 3.35 TB/s, useful FLOPs / unit peak)):")
    print("  stencil    regime              predicted           read_amp  "
          "ms/call    us/step    bound_ms   max|err|"
          + ("   twin_ms  ms/twin" if twins else "")
          + ("   lift_ms  lift/ms" if lift else ""))
    times = {}
    for (name, regime), (plan, err, _) in results.items():
        ms = cuda_ms(lambda: plan(x))
        times[(name, regime)] = ms
        lifted = lift and lifted_plan(lift[0], plan, ws[name], x, lift[1])
        if lifted:
            times[(name, regime + " lift")] = cuda_ms(lifted, reps=5, warmup=1)
        kname, launches = expected_launches(plan.backend, plan.t,
                                            len(plan.grid_shape))
        k_taps = int(np.count_nonzero(ws[name]))
        peak = FP32_FLOPS if kname.startswith("stencil_direct") else TF32_FLOPS
        bound = max(launches * 2 * n * 4 / HBM_BPS,
                    plan.t * 2 * k_taps * n / peak) * 1e3
        twin = (twins or {}).get((name, regime))
        print(f"  {name:10s} {regime:19s} {plan.decision.backend:19s} "
              f"{plan.geom.read_amp:8.4f}  {ms:9.4f}  {ms * 1e3 / plan.t:9.2f}  "
              f"{bound:9.4f}  {err:.3e}"
              + ("" if twin is None else f"  {twin:8.4f}  {ms / twin:.3f}")
              + (f"  {times[(name, regime + ' lift')]:8.4f}  "
                 f"{times[(name, regime + ' lift')] / ms:7.1f}" if lifted else ""))
    return times


def kernel_report(mods, x, w, counts, reps_slow, boundary=None, sparse=False):
    """Each kernel at its fused main-path call on ``w`` (``stencil_direct(x,
    w, t)`` and the reuse form ``stencil_matmul(x, w, t)``, under the
    path's boundary), timed through the plan entries (``stencil_*_at``) on
    the tile ``launch_geom`` resolves once, outside the timed call, as a
    plan launches it (``wrapper_ms``: the same call through the public
    wrapper, which resolves the tile on every call; a host cost), held
    against its plain version with the phase-3 limit, beside a yardstick:
    one F.conv of the composed kernel on a
    periodic path, t x (F.pad in the boundary's modes + one F.conv of the
    base kernel) on a boundary path; ``launches`` is the count of this
    path's run.  The bound counts the FLOPs the stencil needs (2 per
    nonzero tap, point and step), not the band MACs the banded kernel
    does (nor the compacted kernel's; both run dense MMAs, so the peak is
    TF32's); the fill moves no HBM bytes.  ``sparse``: the compacted
    kernel's reuse form ``stencil_sparse_matmul(x, w, t)`` only, its
    ``launches`` from the sparse path and the dense banded kernel's time
    on the same call beside it as ``dense_ms``.  On a 1D path the folded
    kernels' entries (``stencil_direct1d``, ``stencil_banded1d``,
    ``stencil_sparse1d``) also carry the 2D kernel on the lifted view
    doing the same call (``lift_ms``) and their registers
    (``fold_registers``); the 2D and 3D banded entries their registers
    and CTAs per SM (``fold_resources``)."""
    _, sm, sd, weights, ss = mods
    from repro_torch.kernels import common
    n, dim = x.numel(), x.ndim
    geom = common.launch_geom(tuple(x.shape), MAIN_T * ((w.shape[0] - 1) // 2))
    ops = MAIN_T * 2 * int(np.count_nonzero(w)) * n
    mx, sw = float(x.abs().max()), float(np.abs(w).sum())
    if boundary is None:
        wf = weights.fuse_weights(w, MAIN_T)
        yardstick = lambda tf32: conv_yardstick(x, wf, tf32)  # noqa: E731
        what = f"F.conv{dim}d of the composed kernel"
    else:
        from repro_torch.stencil import resolve_boundary
        modes = resolve_boundary(boundary, dim)
        yardstick = lambda tf32: conv_yardstick(x, w, tf32, modes, MAIN_T)  # noqa: E731
        what = f"{MAIN_T} x (F.pad + F.conv{dim}d)"
    report = []
    dense = lambda: sm.stencil_matmul_at(x, w, MAIN_T, geom, boundary=boundary)  # noqa: E731
    kernels_ = (
        ("stencil_direct", lambda: sd.stencil_direct_at(x, w, MAIN_T, geom, boundary),
         lambda: sd.stencil_direct(x, w, MAIN_T, boundary=boundary),
         lambda: sd.stencil_direct_plain(x, w, MAIN_T, boundary), FP32_FLOPS,
         False, 1e-5 * MAIN_T * mx),
        ("stencil_banded", dense, lambda: sm.stencil_matmul(x, w, MAIN_T, boundary=boundary),
         lambda: sm.stencil_matmul_plain(x, w, MAIN_T, boundary=boundary), TF32_FLOPS,
         True, MAIN_T * 2**-10 * sw * mx))
    if sparse:
        kernels_ = (
            ("stencil_sparse",
             lambda: ss.stencil_sparse_matmul_at(x, w, MAIN_T, geom, boundary=boundary),
             lambda: ss.stencil_sparse_matmul(x, w, MAIN_T, boundary=boundary),
             lambda: ss.stencil_sparse_matmul_plain(x, w, MAIN_T, boundary=boundary),
             TF32_FLOPS, True, MAIN_T * 2**-10 * sw * mx),)
    for base, kern, public, plain, peak, tf32, tol in kernels_:
        kname = kernel_name(base, dim)
        if boundary is None:
            entry = kname
            src, replaces = KERNEL_SOURCES[entry]
        else:
            entry = f"{kname} ({boundary_label(boundary)})"
            src = KERNEL_SOURCES[kname][0]
            replaces = SPARSE_FILL_REPLACES if sparse else FILL_REPLACES
        y = kern()
        err = max_err(y, plain())
        del y
        check(err <= tol, f"kernel report {entry}: max|err| vs plain {err:.3e} "
                          f"> tol {tol:.3e}")
        bytes_ms = 2 * n * 4 / HBM_BPS * 1e3
        ops_ms = ops / peak * 1e3
        report.append({
            "name": entry, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": err, "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain, reps=reps_slow),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": cuda_ms(yardstick(tf32), reps=reps_slow),
            "wrapper_ms": cuda_ms(public)})
        if sparse:
            report[-1]["dense_ms"] = cuda_ms(dense)
        if dim == 1:
            mod = {"stencil_direct": sd, "stencil_banded": sm, "stencil_sparse": ss}[base]
            report[-1]["lift_ms"] = cuda_ms(
                lambda: lifted_call(mod, x, w, MAIN_T, None, boundary), reps=5, warmup=1)
            report[-1]["registers"] = fold_registers(kname, boundary is not None)
        if kname in SLAB_KERNELS + TILE_KERNELS:
            report[-1].update(fold_resources(kname, x, w, boundary is not None))
        elif kname in ("stencil_direct", "stencil_direct3d"):
            report[-1].update(direct_resources(kname, x, w, boundary is not None))
    for k in report:
        print(f"  kernel {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms "
              f"by {k['bound_by']}), plain {k['plain_ms']:.4f} ms, "
              f"{what} {k['library_ms']:.4f} ms, "
              f"max|err| vs plain {k['max_abs_err']:.3e}"
              + (f"; dense banded kernel, same call, {k['dense_ms']:.4f} ms"
                 if "dense_ms" in k else "")
              + (f"; the 2D kernel on the lifted view, same call, {k['lift_ms']:.4f} ms; "
                 f"{k['registers']} registers" if "lift_ms" in k else "")
              + (f"; {k['registers']} registers, {k['ctas_per_sm']} CTAs per SM"
                 if "ctas_per_sm" in k else ""))
        print(f"    host: the same call through the public wrapper, which resolves the "
              f"tile on every call, {k['wrapper_ms']:.4f} ms")
    return report


#: The 3D banded kernels: one body, csrc/slab_fold.cuh.
SLAB_KERNELS = ("stencil_banded3d", "stencil_sparse3d")
#: The 2D banded kernels: one body, csrc/tile_fold.cuh.
TILE_KERNELS = ("stencil_banded", "stencil_sparse")


def fold_resources(kname: str, x: torch.Tensor, w: np.ndarray, fill: bool) -> dict:
    """Registers per thread (cuobjdump) and CTAs per SM of the 2D or 3D
    banded instantiation a float32 call of ``w`` (radius 1, t=MAIN_T) on
    the grid(s) ``x`` launches (``csrc/tile_fold.cuh::tile_fold_kernel``,
    ``csrc/slab_fold.cuh::slab_fold_kernel``, each ``<float, float, FILL,
    3, STAGE_REGION>``): the CTAs as the runtime counts them at that
    call's shared memory (the library's ``<kernel>_ctas_per_sm``,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes
    from repro_torch.kernels import _build, common, sass
    dim = 3 if kname in SLAB_KERNELS else 2
    shape = tuple(x.shape[-dim:])
    r = (w.shape[0] - 1) // 2
    geom = common.launch_geom(shape, MAIN_T * r)
    n_rows = int(np.count_nonzero(np.abs(w).sum(axis=-1)))   # the nonzero x-rows
    smem = (common.slab_fold_layout(geom.z_slab, geom.strip_m, geom.w_tile, r, MAIN_T, 4,
                                    n_rows) if dim == 3 else
            common.tile_fold_layout(geom.strip_m, geom.w_tile, r, MAIN_T, 4, n_rows)).smem_bytes
    tag = f"{'slab' if dim == 3 else 'tile'}_fold_kernelIffLb{int(fill)}ELi3ELi0EE"
    regs = [n for f, n in sass.registers(_build._target(kname)).items() if tag in f]
    check(len(regs) == 1, f"registers: {len(regs)} instantiations {tag} in {kname}")
    fn = getattr(_build.library(kname), f"{kname}_ctas_per_sm")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    ctas = fn(0, 0, int(fill), smem)
    check(ctas >= 1, f"{kname}: {ctas} CTAs per SM at {smem} bytes")
    return {"registers": regs[0], "ctas_per_sm": ctas}


def direct_resources(kname: str, x: torch.Tensor, w: np.ndarray, fill: bool) -> dict:
    """Registers per thread (cuobjdump) and CTAs per SM of the 2D or 3D
    tap-sum instantiation a float32 call of ``w`` (radius 1, t=MAIN_T) on
    the grid(s) ``x`` launches (``csrc/stencil_direct.cu::
    stencil_direct_kernel`` / ``csrc/stencil_direct3d.cu::
    stencil_direct3d_kernel``, each ``<float, 1, FILL, STAGE_REGION>``):
    the CTAs as the runtime counts them at that call's shared memory (the
    library's ``<kernel>_ctas_per_sm``; the 3D one takes the radius too)."""
    import ctypes
    from repro_torch.kernels import _build, common, sass
    dim = 3 if kname == "stencil_direct3d" else 2
    r = (w.shape[0] - 1) // 2
    geom = common.launch_geom(tuple(x.shape[-dim:]), MAIN_T * r)
    fn = getattr(_build.library(kname), f"{kname}_ctas_per_sm")
    fn.restype = ctypes.c_int
    if dim == 3:
        smem = common.direct3d_layout(geom.strip_m, geom.w_tile, r, MAIN_T).smem_bytes
        fn.argtypes = [ctypes.c_int] * 4
        ctas = fn(0, r, int(fill), smem)
    else:
        smem = common.direct_layout(geom.strip_m, geom.w_tile, geom.h_block).smem_bytes
        fn.argtypes = [ctypes.c_int] * 3
        ctas = fn(0, int(fill), smem)
    tag = f"{kname}_kernelIfLi1ELb{int(fill)}ELi0EE"
    regs = [n for f, n in sass.registers(_build._target(kname)).items() if tag in f]
    check(len(regs) == 1, f"registers: {len(regs)} instantiations {tag} in {kname}")
    check(ctas >= 1, f"{kname}: {ctas} CTAs per SM at {smem} bytes")
    return {"registers": regs[0], "ctas_per_sm": ctas}


def fold_registers(kname: str, fill: bool) -> int:
    """Registers per thread (cuobjdump) of the folded kernel's
    instantiation a float32 call of radius 1 launches, with or without the
    fill: the banded ones' f32 grid and operands and small band register
    set (``csrc/line_fold.cuh::line_fold_kernel<float, float, FILL, 3>``),
    the tap-sum's f32 line at R = 1
    (``csrc/stencil_direct1d.cu::stencil_direct1d_kernel<float, 1, FILL>``)."""
    from repro_torch.kernels import _build, sass
    tag = (f"stencil_direct1d_kernelIfLi1ELb{int(fill)}EE" if kname == "stencil_direct1d"
           else f"line_fold_kernelIffLb{int(fill)}ELi3EE")
    regs = [n for f, n in sass.registers(_build._target(kname)).items() if tag in f]
    check(len(regs) == 1, f"registers: {len(regs)} instantiations {tag} in {kname}")
    return regs[0]


def phase_traffic(mods, label, x, ws, results, card, reps):
    """The three-way traffic comparison on one foil path: for each stencil
    and row of TRAFFIC_ROWS, the bytes one launch requests (every CTA reads
    its staging's cells once, ``common.staged_read_bytes``; the L2 may serve
    part of them, which no counter here can see), the ms per call and the
    requested rate, bytes / time.  A foil and the default kernel of the
    same row group compute the same function on the same tile but for the
    9-tile rows, whose default twin runs on the 9-tile foil's tile."""
    _, sm, sd, weights, _ = mods
    from repro_torch.kernels import common, legacy
    shape, dim = tuple(x.shape), x.ndim
    print(f"traffic on {card}, {label} foil path ({shape} float32, t={MAIN_T}, one "
          "launch per call): bytes requested per launch, ms per call, requested GB/s:")
    for name, w in ws.items():
        r = (w.shape[0] - 1) // 2
        lgeom = (legacy.tile_geom(shape, LEGACY_TILE, LEGACY_TILE, MAIN_T * r)
                 if dim == 2 else None)
        wf = weights.fuse_weights(w, MAIN_T)
        base = {}
        for group, what, backend in TRAFFIC_ROWS[dim]:
            if backend.startswith("default@9tile"):
                geom, staging = lgeom, "region"
                fn = ((lambda: sd.stencil_direct_at(x, w, MAIN_T, lgeom))
                      if backend.endswith("direct") else
                      (lambda: sm.stencil_matmul_at(x, wf, 1, lgeom)))
            else:
                plan = results[(name, backend)][0]
                staging = ("9tile" if backend.startswith("legacy_") else
                           "wholestrip" if backend.endswith("_wholestrip") else "region")
                geom = lgeom if staging == "9tile" else plan.geom
                fn = (lambda p=plan: p(x))
            nbytes = common.staged_read_bytes(shape, geom, staging, 4)
            ms = cuda_ms(fn, reps=reps)
            base.setdefault(group, ms)
            tile = "x".join(map(str, ((geom.z_slab,) if dim == 3 else ())
                                + (geom.strip_m, geom.w_tile)))
            print(f"  {name:10s} {group:16s} {what:22s} tile {tile:9s} "
                  f"{nbytes / 1e6:10.1f} MB ({common.staged_read_amp(geom, staging):6.3f}x) "
                  f"{ms:9.4f} ms  {nbytes / ms / 1e6:8.1f} GB/s  "
                  f"{ms / base[group]:.3f}x the group's first row")


def foil_report(mods, x, w, counts, reps_slow):
    """The foil kernels' JSON entries at the foil path's call on ``w``
    (t=MAIN_T, float32): 2D the whole-strip tap-sum and banded (reuse form)
    kernels and the 9-tile K9 / K10 (on the composed kernel), 3D the
    whole-slab tap-sum and banded kernels; each held against its plain
    version with the phase-3 limit, beside the default kernel of the same
    call (``default_ms``, on the 9-tile foil's own tile for K9 / K10) and
    the F.conv yardstick of kernel_report; ``launches`` is the count of the
    foil path's run, ``read_bytes`` what one launch requests.  A foil does
    the default kernel's useful work, so its bound is the default's."""
    _, sm, sd, weights, _ = mods
    from repro_torch.kernels import common, legacy
    n, dim, shape = x.numel(), x.ndim, tuple(x.shape)
    r = (w.shape[0] - 1) // 2
    mx, sw = float(x.abs().max()), float(np.abs(w).sum())
    wf = weights.fuse_weights(w, MAIN_T)
    ops = MAIN_T * 2 * int(np.count_nonzero(w)) * n
    geom = common.launch_geom(shape, MAIN_T * r)
    st = "wholeslab" if dim == 3 else "wholestrip"
    src = "src/repro_torch/kernels/csrc/"
    rows = [
        (f"{kernel_name('stencil_direct', dim)} ({st})",
         f"{kernel_name('stencil_direct', dim)} ({st})",
         src + kernel_name("stencil_direct", dim) + ".cu", FOIL_REPLACES["wholestrip"],
         lambda: sd.stencil_direct_at(x, w, MAIN_T, geom, staging="wholestrip"),
         lambda: sd.stencil_direct_at(x, w, MAIN_T, geom),
         lambda: sd.stencil_direct_plain(x, w, MAIN_T), FP32_FLOPS,
         1e-5 * MAIN_T * mx, geom, "wholestrip"),
        (f"{kernel_name('stencil_banded', dim)} ({st})",
         f"{kernel_name('stencil_banded', dim)} ({st})",
         src + kernel_name("stencil_banded", dim) + ".cu", FOIL_REPLACES["wholestrip"],
         lambda: sm.stencil_matmul_at(x, w, MAIN_T, geom, staging="wholestrip"),
         lambda: sm.stencil_matmul_at(x, w, MAIN_T, geom),
         lambda: sm.stencil_matmul_plain(x, w, MAIN_T), TF32_FLOPS,
         MAIN_T * 2**-10 * sw * mx, geom, "wholestrip")]
    if dim == 2:
        lgeom = legacy.tile_geom(shape, LEGACY_TILE, LEGACY_TILE, MAIN_T * r)
        rows += [
            ("legacy_direct (9-tile)", "stencil_direct (9tile)",
             src + "stencil_direct.cu", FOIL_REPLACES["9tile_direct"],
             lambda: legacy.stencil_direct_9pt(x, w, MAIN_T),
             lambda: sd.stencil_direct_at(x, w, MAIN_T, lgeom),
             lambda: sd.stencil_direct_plain(x, w, MAIN_T), FP32_FLOPS,
             1e-5 * MAIN_T * mx, lgeom, "9tile"),
            ("legacy_matmul (9-tile)", "stencil_banded (9tile)",
             src + "stencil_banded.cu", FOIL_REPLACES["9tile_matmul"],
             lambda: legacy.stencil_matmul_9pt(x, wf),
             lambda: sm.stencil_matmul_at(x, wf, 1, lgeom),
             lambda: sm.stencil_matmul_plain(x, wf, 1), TF32_FLOPS,
             MAIN_T * 2**-10 * sw * mx, lgeom, "9tile")]
    # one F.conv of the composed kernel, in f32 beside the tap-sum kernels
    # and in TF32 beside the banded ones, as in kernel_report
    library_ms = {tf32: cuda_ms(conv_yardstick(x, wf, tf32), reps=reps_slow)
                  for tf32 in (False, True)}
    report = []
    for entry, counter, source, replaces, kern, default, plain, peak, tol, g, stg in rows:
        y = kern()
        err = max_err(y, plain())
        del y
        check(err <= tol, f"kernel report {entry}: max|err| vs plain {err:.3e} "
                          f"> tol {tol:.3e}")
        bytes_ms = 2 * n * 4 / HBM_BPS * 1e3
        ops_ms = ops / peak * 1e3
        report.append({
            "name": entry, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[counter],
            "max_abs_err": err, "ms": cuda_ms(kern, reps=reps_slow),
            "plain_ms": cuda_ms(plain, reps=reps_slow),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms[peak == TF32_FLOPS],
            "default_ms": cuda_ms(default, reps=reps_slow),
            "read_bytes": common.staged_read_bytes(shape, g, stg, 4)})
    for k in report:
        print(f"  kernel {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms "
              f"by {k['bound_by']}; the default kernel of the same call "
              f"{k['default_ms']:.4f} ms), plain {k['plain_ms']:.4f} ms, F.conv{dim}d "
              f"of the composed kernel {k['library_ms']:.4f} ms, max|err| vs plain "
              f"{k['max_abs_err']:.3e}, {k['read_bytes'] / 1e6:.1f} MB requested "
              f"per launch, {k['launches']} launches on the foil path")
    return report


def phase_guarded(mods, x, w) -> None:
    """``guarded_stencil_plan`` (auto at t=MAIN_T) on the foil path's grid
    under REPRO_FAULTS=GUARD_FAULTS: every rung above rank 55 fails at its
    first launch (auto, auto+degraded, direct), the ladder lands on
    GUARD_LANDS, which must match the reference with one launch of the
    whole-strip kernel and the expected events; then, the plan cache
    cleared, a clean guarded call must return the cached plan object and
    record nothing."""
    kernels = mods[0]
    from repro_torch.core import events
    from repro_torch.kernels import (clear_plan_cache, guarded_stencil_plan,
                                     plan_cache_stats, stencil_plan)
    from repro_torch.testing import faults
    shape = tuple(x.shape)
    ref = stencil_plan(w, shape, torch.float32, MAIN_T, backend="reference")(x)
    tol = 1e-5 * MAIN_T * float(x.abs().max())
    clear_plan_cache()
    events.clear()
    os.environ["REPRO_FAULTS"] = GUARD_FAULTS
    faults.reset_faults()
    try:
        kernels.reset_launch_counts()
        g = guarded_stencil_plan(w, shape, torch.float32, MAIN_T)
        y = g(x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
    finally:
        os.environ.pop("REPRO_FAULTS", None)
        faults.reset_faults()
    kinds = [e["kind"] for e in events.events()]
    stats = plan_cache_stats()
    check(g.rung == GUARD_LANDS and g.backend == GUARD_LANDS,
          f"guarded path: landed on {g.rung!r}, expected {GUARD_LANDS!r}")
    check([h["cause"] for h in g.history] == ["compile"] * 3,
          f"guarded path: history {g.history}")
    check(kinds == ["guard_failure", "guard_fallback"] * 3,
          f"guarded path: events {kinds}")
    check((stats["exec_failures"], stats["fallbacks"], stats["negative_size"])
          == (3, 3, 3), f"guarded path: counters {stats}")
    check(counts == {"stencil_direct (wholestrip)": 1},
          f"guarded path: launches {counts}")
    err = max_err(y, ref)
    check(err <= tol, f"guarded path: max|err| vs reference {err:.3e} > {tol:.3e}")
    print(f"guarded path {shape}: REPRO_FAULTS={GUARD_FAULTS} fails "
          f"{', '.join(h['rung'] for h in g.history)}; lands on {g.rung} "
          f"(events {kinds}; launches {counts}; max|err| vs reference {err:.3e})")
    clear_plan_cache()
    events.clear()
    p0 = stencil_plan(w, shape, torch.float32, MAIN_T)
    kernels.reset_launch_counts()
    g2 = guarded_stencil_plan(w, shape, torch.float32, MAIN_T)
    y2 = g2(x)
    torch.cuda.synchronize()
    counts2 = {k: v for k, v in kernels.launch_counts().items() if v}
    check(g2.plan is p0 and not g2.degraded and events.events() == [],
          "guarded path: a clean guarded call did not return the cached plan")
    check(counts2 == {"stencil_direct": 1}, f"guarded path: clean launches {counts2}")
    err2 = max_err(y2, ref)
    check(err2 <= tol, f"guarded path: clean max|err| {err2:.3e} > {tol:.3e}")
    print(f"  then a clean guarded call returns the cached plan object "
          f"({p0.backend}, launches {counts2}, no events, max|err| {err2:.3e})")
    # Under compile:inf every kernel rung fails; on the card the ladder
    # ends at the last kernel rung and raises: no plain rung runs.
    from repro_torch.kernels.guard import GuardedExecutionError
    clear_plan_cache()
    events.clear()
    os.environ["REPRO_FAULTS"] = "compile:inf"
    faults.reset_faults()
    raised = None
    try:
        kernels.reset_launch_counts()
        g3 = guarded_stencil_plan(w, shape, torch.float32, MAIN_T)
        g3(x)
        torch.cuda.synchronize()
    except GuardedExecutionError as e:
        raised = e
    finally:
        os.environ.pop("REPRO_FAULTS", None)
        faults.reset_faults()
        clear_plan_cache()
    counts3 = {k: v for k, v in kernels.launch_counts().items() if v}
    check(raised is not None, "guarded path: compile:inf did not raise on the card")
    rungs = [h["rung"] for h in raised.history]
    check(rungs[-1] == "direct_wholestrip" and "reference" not in rungs
          and counts3 == {}, f"guarded path: compile:inf walked {rungs}, "
                             f"launches {counts3}")
    print(f"  and under REPRO_FAULTS=compile:inf the ladder fails {len(rungs)} "
          f"kernel rungs down to {rungs[-1]} and raises {type(raised).__name__}")


def phase_host(mods, w2, w3):
    """Host cost of one wrapper call (argument checks, operand caches,
    ctypes, launch) on a grid small enough that the card keeps up: on the
    tile a plan resolved when built (what each of a plan's launches costs),
    and through the public wrapper, which resolves the tile on every
    call."""
    kernels, sm, sd, _, ss = mods
    for dim, w in ((2, w2), (3, w3)):
        xs = grid(HOST_SHAPES[dim], torch.float32, seed=3)
        geom = kernels.common.launch_geom(xs.shape, 1)
        for base, at, public in (
                ("stencil_direct", lambda: sd.stencil_direct_at(xs, w, 1, geom),
                 lambda: sd.stencil_direct(xs, w, 1)),
                ("stencil_banded", lambda: sm.stencil_matmul_at(xs, w, 1, geom),
                 lambda: sm.stencil_matmul(xs, w, 1)),
                ("stencil_sparse", lambda: ss.stencil_sparse_matmul_at(xs, w, 1, geom),
                 lambda: ss.stencil_sparse_matmul(xs, w, 1))):
            print(f"  kernel {kernel_name(base, dim)}: host {host_us(at):.2f} us per "
                  f"launch on a plan's resolved tile, {host_us(public):.2f} us through "
                  f"the public wrapper ({'x'.join(map(str, xs.shape))} float32, t=1, "
                  f"wall clock over {HOST_CALLS} calls)")


def band_sparsity_lines(mods, ws):
    """Structural S of the band operands, S over the K the MMAs run
    (BAND_N + 2R padded to the TF32 / bf16 K step), and the compacted
    operand's kept-row fraction S with the MMA k-steps per 16x16 output
    tile and step of the base kernel, dense against compacted."""
    _, sm, _, weights, ss = mods
    common = mods[0].common
    for name, w in ws.items():
        r = (w.shape[0] - 1) // 2
        wk = common.lift_weights(w) if w.ndim == 1 else w
        steps = []
        for cdt in (torch.float32, torch.bfloat16):
            rows = ss.band_meta(wk, cdt).rows
            k = common.mma_k_step(cdt.itemsize)
            dense = common.tile_fold_layout(64, 64, r, 1, cdt.itemsize, 1).kpad // k
            steps.append(f"{len(rows) * dense} -> {sum(row[-1] for row in rows)}")
        print(f"  {name:10s} compacted operand (base): kept-row S "
              f"{ss.kept_row_fraction(w, 16):.4f}; MMA k-steps per 16x16 tile and step, "
              f"dense -> compacted: TF32 {steps[0]}, bf16 {steps[1]}")
        for label, wop in (("base", w), (f"fused t={MAIN_T}", weights.fuse_weights(w, MAIN_T))):
            r_op = (wop.shape[0] - 1) // 2
            s = sm.band_sparsity(wop, 16)
            padded = [s * (16 + 2 * r_op) / common.tile_fold_layout(64, 64, r_op, 1, cb, 1).kpad
                      for cb in (4, 2)]
            print(f"  {name:10s} band S ({label}, R={r_op}): {s:.4f}; over padded K: "
                  f"TF32 {padded[0]:.4f}, bf16 {padded[1]:.4f}")


def phase_sparse_path(mods, label, x, ws, card, reps_slow, boundary=None):
    """The sparse path on one grid, its launches counted from 0: both
    compacted regimes at t=MAIN_T (and on a periodic 2D or 3D grid auto at
    t=MAIN_T and t=1, direct and matmul at t=1) with
    ``use_sparse_unit=True``, against the
    reference; their times; and the compacted kernel's report entry on the
    Star stencil (1D: Box)."""
    from repro_torch.stencil import StencilSpec
    runs = SPARSE_RUNS + (SPARSE_AUTO if boundary is None and x.ndim > 1 else [])
    tag = f"{label} sparse" + ("" if boundary is None else f" boundary={boundary_label(boundary)}")
    results, counts = phase_main_path(mods, tag, x, ws, boundary, runs=runs, sparse=True)
    phase_regime_times(tag, x, ws, results, card,
                       lift=(mods, boundary) if x.ndim == 1 else None)
    w = ws[StencilSpec("star" if x.ndim > 1 else "box", x.ndim, 1).name]
    return kernel_report(mods, x, w, counts, reps_slow, boundary, sparse=True)


# ---------------------------------------------------------------------------
# K11: the batch.  Phase 2 holds every batched launch to B unbatched
# launches, phase 3 drives the batched main paths and the guarded batched
# path, phase 4 times the batch, phase 5 serves requests.
# ---------------------------------------------------------------------------
#: Phase 2's batch sizes, and its ragged grids with one boundary spec each.
BATCH_SIZES = (1, 3, 8)
BATCH_GRIDS = (((1000, 1030), ("reflect", "periodic")),
               ((60, 70, 130), ("replicate", "reflect", "periodic")),
               ((2**20 + 3,), "reflect"))
#: The 9-tile foils' batched grid (their 128 x 128 tiles divide it).
BATCH_NINE_GRID = (1024, 1024)
#: Phase 2's batch limits: (grid, B, launches per batched call) -- past
#: gridDim.z's 65535, and past 2^31 cells in 2D and in 3D.
BATCH_LIMITS = (((32, 32), 65537, 2), ((8192, 8192), 33, 1),
                ((512, 512, 512), 17, 1), ((2**26,), 33, 1))
#: The batched main paths: as many cells per batch as the unbatched path
#: beside it (grid, batch, stencils), and the batched sparse path.
BATCH_PATHS = {
    "2D": ((2048, 2048), 16, (("box", 1), ("star", 1))),
    "3D": ((256, 256, 256), 8, (("box", 1),)),
    "1D": ((2**22,), 16, (("box", 1),)),
}
BATCH_SPARSE = ((2048, 2048), 16, "zero")
#: Phase 4's batch table: Box-2D1R at t=MAIN_T on 256^2 grids.
BATCH_TABLE = ((256, 256), (1, 8, 64, 512))
BATCH_HOST_CALLS = 200
#: The TPU kernel K11 replaces: fold_batch, mode vmap (jax.vmap).
BATCH_REPLACES = "src/repro/kernels/common.py:1583"


def batched_calls(mods, w, t, geom, bc, dim, foils=True):
    """``(counter, f(x, batched))`` of every kernel (and foil build) on
    ``geom``: the tap-sum, banded and compacted kernels' fused calls and
    the whole-strip / whole-slab foils of the first two."""
    _, sm, sd, _, ss = mods
    out = [(kernel_name("stencil_direct", dim),
            lambda x, bt: sd.stencil_direct_at(x, w, t, geom, bc, "region", bt)),
           (kernel_name("stencil_banded", dim),
            lambda x, bt: sm.stencil_matmul_at(x, w, t, geom, None, bc, "region", bt)),
           (kernel_name("stencil_sparse", dim),
            lambda x, bt: ss.stencil_sparse_matmul_at(x, w, t, geom, None, bc, bt))]
    if foils and dim > 1:
        st = "wholeslab" if dim == 3 else "wholestrip"
        out += [(f"{kernel_name('stencil_direct', dim)} ({st})",
                 lambda x, bt: sd.stencil_direct_at(x, w, t, geom, bc, "wholestrip", bt)),
                (f"{kernel_name('stencil_banded', dim)} ({st})",
                 lambda x, bt: sm.stencil_matmul_at(x, w, t, geom, None, bc, "wholestrip",
                                                    bt))]
    return out


def hold_batch(kernels, counter, f, xb, tag, grids=None, launches=1) -> None:
    """One batched call of ``f`` on ``xb``: exactly ``launches`` launches of
    ``counter`` and nothing else, and each grid of ``grids`` (default all)
    bit for bit its own unbatched launch."""
    kernels.reset_launch_counts()
    yb = f(xb, True)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    check(counts == {counter: launches},
          f"{tag}: launches {counts}, expected {launches} of {counter}")
    check(tuple(yb.shape) == tuple(xb.shape) and yb.dtype == xb.dtype,
          f"{tag}: shape/dtype {tuple(yb.shape)} {yb.dtype}")
    for b in (range(xb.shape[0]) if grids is None else grids):
        y1 = f(xb[b], False)
        torch.cuda.synchronize()
        check(torch.equal(yb[b], y1), f"{tag}: grid {b} differs from its unbatched "
                                      f"launch by {max_err(yb[b], y1):.3e}")
    del yb


def phase_batch_kernels(mods) -> None:
    """Phase 2, K11: every kernel and foil build at B in BATCH_SIZES on the
    ragged grids, f32 and bf16, periodic and under the grid's boundary
    spec, and the 9-tile foils on 1024^2: one launch per batched call, each
    grid bit for bit its unbatched launch; then a pinned 3D tile depth
    (``z_slab``) against the rule's, on every 3D kernel."""
    kernels, sm, sd, weights, _ = mods
    from repro_torch.kernels import common, legacy
    from repro_torch.stencil import StencilSpec
    n = 0
    for shape, bspec in BATCH_GRIDS:
        dim = len(shape)
        w = weights.make_weights(StencilSpec("box", dim, 1), seed=1)
        geom = common.launch_geom(shape, MAIN_T)
        for bc, dtype, b in itertools.product((None, bspec), (torch.float32, torch.bfloat16),
                                              BATCH_SIZES):
            xb = grid((b,) + shape, dtype, seed=5)
            for counter, f in batched_calls(mods, w, MAIN_T, geom, bc, dim):
                tag = (f"{counter} batch {b} x {shape} {str(dtype)[6:]}"
                       + ("" if bc is None else f" boundary={boundary_label(bc)}"))
                hold_batch(kernels, counter, f, xb, tag)
                n += 1
            del xb
    w = weights.make_weights(StencilSpec("box", 2, 1), seed=1)
    wf = weights.fuse_weights(w, MAIN_T)
    for dtype, b in itertools.product((torch.float32, torch.bfloat16), BATCH_SIZES):
        xb = grid((b,) + BATCH_NINE_GRID, dtype, seed=5)
        for counter, f in (
                ("stencil_direct (9tile)", lambda x, bt: legacy.stencil_direct_9pt(
                    x, w, MAIN_T, LEGACY_TILE, LEGACY_TILE, bt)),
                ("stencil_banded (9tile)", lambda x, bt: legacy.stencil_matmul_9pt(
                    x, wf, LEGACY_TILE, LEGACY_TILE, None, bt))):
            hold_batch(kernels, counter, f, xb, f"{counter} batch {b} x "
                                                f"{BATCH_NINE_GRID} {str(dtype)[6:]}")
            n += 1
        del xb
    print(f"batched kernels (K11): {n} batched calls on {[s for s, _ in BATCH_GRIDS]} "
          f"and {BATCH_NINE_GRID}, B in {BATCH_SIZES}, f32/bf16, periodic and one boundary spec "
          "per rank: each one launch, every grid bit for bit its unbatched launch")
    # z_slab: a pinned tile depth is a tile, not a function
    shape, bspec = BATCH_GRIDS[1]
    w = weights.make_weights(StencilSpec("box", 3, 1), seed=1)
    free = common.launch_geom(shape, MAIN_T)
    for zs in (4, 8):
        pinned = common.launch_geom(shape, MAIN_T, z_slab=zs)
        check(pinned.z_slab == zs and free.z_slab != zs,
              f"z_slab: pinned {pinned}, free {free}")
        for bc, dtype in itertools.product((None, bspec), (torch.float32, torch.bfloat16)):
            x = grid(shape, dtype, seed=6)
            for (counter, fp), (_, ff) in zip(
                    batched_calls(mods, w, MAIN_T, pinned, bc, 3),
                    batched_calls(mods, w, MAIN_T, free, bc, 3)):
                yp, yf = fp(x, False), ff(x, False)
                check(torch.equal(yp, yf), f"z_slab={zs}: {counter} {str(dtype)[6:]} "
                                           f"boundary={bc} differs from the rule's "
                                           f"tile by {max_err(yp, yf):.3e}")
    print(f"z_slab pin: 3D kernels and foils on {shape} at TZ = 4 and 8 (the rule's "
          f"TZ = {free.z_slab}) equal the rule's tile bit for bit, f32/bf16, periodic "
          f"and {boundary_label(bspec)}")


def phase_batch_limits(mods) -> None:
    """Phase 2, K11 limits: B = 65537 grids of 32x32 launch twice (the
    gridDim.z limit) with the last grid bit for bit its unbatched launch;
    and a batch past 2^31 cells in 2D (33 x 8192^2), 3D (17 x 512^3) and
    1D (33 x 2^26, the folded kernels' persistent CTAs walking it),
    whose last grid starts at cell 2^31, each grid checked against its own
    unbatched launch, for the tap-sum, banded and compacted kernels."""
    kernels, sm, sd, weights, ss = mods
    wrappers = {"direct": sd, "matmul": sm, "sparse_matmul": ss}
    from repro_torch.kernels import common
    from repro_torch.stencil import StencilSpec
    gen = torch.Generator(device="cuda").manual_seed(11)
    for shape, b, launches in BATCH_LIMITS:
        dim = len(shape)
        w = weights.make_weights(StencilSpec("box", dim, 1), seed=1)
        geom = common.launch_geom(shape, MAIN_T)
        xb = torch.empty((b,) + shape, device="cuda").normal_(generator=gen)
        last = b - 1
        for counter, f in batched_calls(mods, w, MAIN_T, geom, None, dim, foils=False):
            hold_batch(kernels, counter, f, xb, f"{counter} batch {b} x {shape}",
                       grids=(0, last), launches=launches)
        print(f"batch limit: {b} x {shape} float32 ({xb.numel()} cells, last grid at "
              f"cell {last * xb[0].numel()}): {launches} launch(es) of each kernel, the "
              "first and last grids bit for bit their unbatched launches")
        del xb
        torch.cuda.empty_cache()


def batch_report(mods, xb, w, counts, reps_slow, boundary=None, sparse=False):
    """The K11 entries at a batched main path's call on ``w`` (the fused
    calls of kernel_report, ``batched=True`` on the path's tile): each
    batched kernel against the loop of its plain version over the grids,
    beside one F.conv with N = B; ``launches`` is the batched path's count,
    the bound B grids' bytes or FLOPs.  On a 1D path each entry also
    carries the batched 2D kernel on the lifted views doing the same call
    (``lift_ms``) and its registers, as kernel_report's."""
    _, sm, sd, weights, ss = mods
    from repro_torch.kernels import common
    b, shape = xb.shape[0], tuple(xb.shape[1:])
    dim, n = len(shape), xb.numel()
    r = (w.shape[0] - 1) // 2
    geom = common.launch_geom(shape, MAIN_T * r)
    ops = MAIN_T * 2 * int(np.count_nonzero(w)) * n
    mx, sw = float(xb.abs().max()), float(np.abs(w).sum())
    if boundary is None:
        wf = weights.fuse_weights(w, MAIN_T)
        yardstick = lambda tf32: conv_yardstick(xb, wf, tf32, batched=True)  # noqa: E731
    else:
        from repro_torch.stencil import resolve_boundary
        modes = resolve_boundary(boundary, dim)
        yardstick = lambda tf32: conv_yardstick(  # noqa: E731
            xb, w, tf32, modes, MAIN_T, batched=True)
    loop = lambda plain, *a: (lambda: torch.stack([plain(x, *a) for x in xb]))  # noqa: E731
    rows = [("stencil_direct",
             lambda: sd.stencil_direct_at(xb, w, MAIN_T, geom, boundary, batched=True),
             loop(sd.stencil_direct_plain, w, MAIN_T, boundary), FP32_FLOPS, False,
             1e-5 * MAIN_T * mx),
            ("stencil_banded",
             lambda: sm.stencil_matmul_at(xb, w, MAIN_T, geom, None, boundary, batched=True),
             loop(sm.stencil_matmul_plain, w, MAIN_T, 16, None, boundary), TF32_FLOPS, True,
             MAIN_T * 2**-10 * sw * mx)]
    if sparse:
        rows = [("stencil_sparse",
                 lambda: ss.stencil_sparse_matmul_at(xb, w, MAIN_T, geom, None, boundary,
                                                     batched=True),
                 loop(ss.stencil_sparse_matmul_plain, w, MAIN_T, 16, None, boundary),
                 TF32_FLOPS, True, MAIN_T * 2**-10 * sw * mx)]
    report = []
    for base, kern, plain, peak, tf32, tol in rows:
        kname = kernel_name(base, dim)
        what = ", ".join(["batched"] + ([] if boundary is None else [boundary_label(boundary)]))
        entry = f"{kname} ({what})"
        y = kern()
        err = max_err(y, plain())
        del y
        check(err <= tol, f"kernel report {entry}: max|err| vs the plain loop {err:.3e} "
                          f"> tol {tol:.3e}")
        bytes_ms = 2 * n * 4 / HBM_BPS * 1e3
        ops_ms = ops / peak * 1e3
        report.append({
            "name": entry, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + kname + ".cu",
            "replaces": BATCH_REPLACES, "launches": counts[kname],
            "max_abs_err": err, "ms": cuda_ms(kern, reps=reps_slow),
            "plain_ms": cuda_ms(plain, reps=reps_slow, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": cuda_ms(yardstick(tf32), reps=reps_slow), "batch": b})
        if dim == 1:
            mod = {"stencil_direct": sd, "stencil_banded": sm, "stencil_sparse": ss}[base]
            report[-1]["lift_ms"] = cuda_ms(
                lambda: lifted_call(mod, xb, w, MAIN_T, None, boundary),
                reps=5, warmup=1)
            report[-1]["registers"] = fold_registers(kname, boundary is not None)
        if kname in SLAB_KERNELS + TILE_KERNELS:
            report[-1].update(fold_resources(kname, xb, w, boundary is not None))
        elif kname in ("stencil_direct", "stencil_direct3d"):
            report[-1].update(direct_resources(kname, xb, w, boundary is not None))
    for k in report:
        print(f"  kernel {k['name']}: {k['ms']:.4f} ms for {b} x {shape} (bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}), the plain loop "
              f"{k['plain_ms']:.4f} ms, F.conv{dim}d with N={b} {k['library_ms']:.4f} ms, "
              f"max|err| vs the plain loop {k['max_abs_err']:.3e}, {k['launches']} "
              "launches on the batched path"
              + (f"; the 2D kernel on the lifted view, same call, {k['lift_ms']:.4f} ms; "
                 f"{k['registers']} registers" if "lift_ms" in k else "")
              + (f"; {k['registers']} registers, {k['ctas_per_sm']} CTAs per SM"
                 if "ctas_per_sm" in k else ""))
    return report


def phase_guarded_batched(mods, xb, w) -> None:
    """The guarded batched path: ``guarded_stencil_plan(..., batch=B)``
    (auto at t=MAIN_T) under REPRO_FAULTS=GUARD_FAULTS lands the whole
    bucket on GUARD_LANDS, as the unbatched guarded path does: one launch
    of the whole-strip kernel for the batch, matching the reference."""
    kernels = mods[0]
    from repro_torch.core import events
    from repro_torch.kernels import clear_plan_cache, guarded_stencil_plan, stencil_plan
    from repro_torch.testing import faults
    b, shape = xb.shape[0], tuple(xb.shape[1:])
    ref = stencil_plan(w, shape, torch.float32, MAIN_T, backend="reference", batch=b)(xb)
    tol = 1e-5 * MAIN_T * float(xb.abs().max())
    clear_plan_cache()
    events.clear()
    os.environ["REPRO_FAULTS"] = GUARD_FAULTS
    faults.reset_faults()
    try:
        kernels.reset_launch_counts()
        g = guarded_stencil_plan(w, shape, torch.float32, MAIN_T, batch=b)
        y = g(xb)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
    finally:
        os.environ.pop("REPRO_FAULTS", None)
        faults.reset_faults()
        clear_plan_cache()
    kinds = [e["kind"] for e in events.events()]
    check(g.rung == GUARD_LANDS and g.batch == b,
          f"guarded batched path: landed on {g.rung!r}, expected {GUARD_LANDS!r}")
    check([h["cause"] for h in g.history] == ["compile"] * 3,
          f"guarded batched path: history {g.history}")
    check(kinds == ["guard_failure", "guard_fallback"] * 3,
          f"guarded batched path: events {kinds}")
    check(counts == {"stencil_direct (wholestrip)": 1},
          f"guarded batched path: launches {counts}")
    err = max_err(y, ref)
    check(err <= tol, f"guarded batched path: max|err| {err:.3e} > {tol:.3e}")
    print(f"guarded batched path {tuple(xb.shape)}: REPRO_FAULTS={GUARD_FAULTS} fails "
          f"{', '.join(h['rung'] for h in g.history)}; the bucket lands on {g.rung} "
          f"(events {kinds}; launches {counts}; max|err| vs reference {err:.3e})")


def host_wall_us(fn, calls: int = BATCH_HOST_CALLS) -> float:
    """Host wall microseconds per call of ``fn`` over ``calls`` calls issued
    back to back with one sync at the end (the card drained before)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def profiled_us(fn, calls: int = 20):
    """Device microseconds per call of ``fn`` spent in CUDA kernels, from
    torch.profiler's CUDA activity over ``calls`` calls (the kernels' own
    time, without the idle gaps a host-bound call leaves between them);
    None ("not measured") when the profiler cannot trace the card or the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as e:
        print(f"  profiler: no device trace ({type(e).__name__}: {e})")
        return None
    total = sum(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) for e in prof.key_averages())
    return total / calls if total > 0 else None


def phase_batch_times(mods, card):
    """Phase 4, K11: Box-2D1R at t=MAIN_T on 256^2 grids for each B of
    BATCH_TABLE, per grid: device us from CUDA events around each call
    (which include the card's idle wait for a host-bound launch), kernel
    us from the profiler, and host wall us over BATCH_HOST_CALLS calls,
    for the batched plan ("vmap": one launch per call) and the "map" plan
    (B launches per call, each grid the unbatched plan's work), beside one
    F.conv2d of the composed kernel with N = B; the two folds must agree
    bit for bit."""
    _, _, _, weights, _ = mods
    from repro_torch.kernels import stencil_plan
    from repro_torch.stencil import StencilSpec
    shape, sizes = BATCH_TABLE
    w = weights.make_weights(StencilSpec("box", 2, 1), seed=0)
    wf = weights.fuse_weights(w, MAIN_T)
    print(f"batch times on {card}: Box-2D1R {shape} float32, t={MAIN_T}, auto; us per "
          f"grid: events = CUDA events around each call, kernel = the profiler's "
          f"kernel time, host = wall clock over {BATCH_HOST_CALLS} calls, one sync:")
    print("     B   vmap: events  kernel     host |  map: events  kernel     host | "
          "F.conv2d(N=B): events  kernel")
    rows = []

    def per_grid(us, b):
        return float("nan") if us is None else us / b
    for b in sizes:
        xb = grid((b,) + shape, torch.float32, seed=7)
        pv = stencil_plan(w, shape, torch.float32, MAIN_T, batch=b)
        pm = stencil_plan(w, shape, torch.float32, MAIN_T, batch=b, batch_mode="map")
        check(pv.batch_mode == "vmap" and torch.equal(pv(xb), pm(xb)),
              f"batch times B={b}: vmap and map plans differ")
        conv = conv_yardstick(xb, wf, False, batched=True)
        row = (b, cuda_ms(lambda: pv(xb)) * 1e3 / b, per_grid(profiled_us(lambda: pv(xb)), b),
               host_wall_us(lambda: pv(xb)) / b,
               cuda_ms(lambda: pm(xb)) * 1e3 / b, per_grid(profiled_us(lambda: pm(xb)), b),
               host_wall_us(lambda: pm(xb)) / b,
               cuda_ms(conv) * 1e3 / b, per_grid(profiled_us(conv), b))
        rows.append(row)
        print(f"  {row[0]:4d}  {row[1]:12.3f} {row[2]:7.3f} {row[3]:8.3f} | {row[4]:11.3f} "
              f"{row[5]:7.3f} {row[6]:8.3f} | {row[7]:20.3f} {row[8]:7.3f}")
        del xb
    return rows


def phase_serving(card) -> None:
    """Phase 5: StencilServer on the card under closed-loop traffic, two
    signatures (Box-2D1R and Star-2D1R, 256^2, t=1, f32), 2048 requests
    each in windows of 128: every response bit for bit the unbatched
    plan's output on the card, plan-cache hits >= requests - signatures,
    no failed or degraded batch; then the quick serving benchmark (printed,
    not gated)."""
    from repro_torch.benchmarks import serving
    payload = serving.run(True, grid=(256, 256), requests_per_signature=2048,
                          passes=1, json_path=None)
    n = payload["requests_per_signature"] * len(payload["signatures"])
    b, pc = payload["batched"], payload["plan_cache"]
    check(payload["bitwise_match"], "serving: a response differs from the unbatched plan")
    check(b["responded"] == b["submitted"] == n and b["failed"] == 0,
          f"serving: {b['responded']}/{b['submitted']} answered, {b['failed']} failed")
    check(b["degraded_batches"] == 0, f"serving: {b['degraded_batches']} degraded batches")
    check(pc["hits_delta"] >= n - len(payload["signatures"]),
          f"serving: plan-cache hits {pc['hits_delta']} < {n} - signatures")
    lat = b["latency"]
    print(f"serving on {card}: {payload['signatures']} {tuple(payload['grid'])} t=1 "
          f"float32, {n} "
          f"requests in windows of {serving.WINDOW}: every response bit for bit the "
          f"unbatched plan's; {b['requests_per_s']:.0f} req/s, p50 {lat['p50_ms']:.3f} ms, "
          f"p99 {lat['p99_ms']:.3f} ms, occupancy {b['batch_occupancy']:.2f}, "
          f"{b['batches']} batches, 0 degraded; plan-cache hits +{pc['hits_delta']}; "
          f"sequential {payload['sequential']['requests_per_s']:.0f} req/s")
    quick = serving.run(True)
    for line in serving.summary(quick):
        print(f"  {line}")


#: The grid of the cost counter's check on the card (phase ``paper``, b).
PAPER_COUNT_GRID = (1024, 1024)


def phase_paper() -> None:
    """Phase ``paper``: the paper's tables and Figure 16 through the port's
    harness on the card (``python -m repro_torch.benchmarks.run``
    in-process, its lines printed), failing on any of: (a) ``table2``'s
    counted C on CUDA inputs not equal to the CPU's bit for bit; (b) the
    aten cost counter over a ``fused_direct`` plan call at 1024^2 not
    reporting the plan's kernel launches as ``opaque_launches``; (c) a
    ``fig16`` plan outside its tolerance against ``reference`` (checked
    inside ``fig16`` before it times the plan); (d) a quickstart backend
    outside its tolerance against the oracle; (e) a failed module in the
    harness's manifest."""
    from repro_torch import kernels
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks import table2
    from repro_torch.core.hlo_cost import analyze_program
    from repro_torch.examples import quickstart
    from repro_torch.stencil import StencilSpec, make_weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    manifest = os.path.join(REPO, bench_run.MANIFEST_PATH)
    rc = bench_run.main(["--manifest", manifest])
    with open(manifest) as f:
        failed = json.load(f)["failed"]
    check(rc == 0 and not failed, f"paper: harness exit {rc}, failed modules {failed}")
    card_c = [r["c_meas"] for r in table2.rows("cuda")]
    cpu_c = [r["c_meas"] for r in table2.rows("cpu")]
    check(card_c == cpu_c, f"paper: table2 C_measured on the card {card_c} != on the CPU "
                           f"{cpu_c}")
    print(f"paper: table2 C_measured on CUDA inputs = on the CPU, bit for bit: {card_c}")
    w = make_weights(StencilSpec("box", 2, 1), seed=0)
    x = grid(PAPER_COUNT_GRID, torch.float32, seed=0)
    plan = kernels.stencil_plan(w, x.shape, torch.float32, MAIN_T, backend="fused_direct")
    plan(x)                                        # builds the plan outside the count
    torch.cuda.synchronize()
    kname, n = expected_launches("fused_direct", MAIN_T, 2)
    before = kernels.launch_counts()[kname]
    cost = analyze_program(plan, x)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()[kname] - before
    check(cost.opaque_launches == launched == n,
          f"paper: the cost counter saw {cost.opaque_launches} opaque launches, the "
          f"plan launched {launched} of {kname} (expected {n})")
    print(f"paper: analyze_program over fused_direct {PAPER_COUNT_GRID} t={MAIN_T}: "
          f"opaque_launches {cost.opaque_launches} = the plan's {launched} {kname} launch; "
          f"aten flops {cost.flops:.0f}, bytes {cost.bytes:.0f}")
    rows = quickstart.backend_errors("cuda")
    bad = [r for r in rows if not r[1] <= r[2]]
    check(not bad, f"paper: quickstart backends outside their tolerance: {bad}")
    print("paper: quickstart 256^2 Box-2D1R t=4, max|err| vs the oracle (tol): "
          + ", ".join(f"{b}={e:.2e} ({t:.1e})" for b, e, t in rows))
    del x, plan
    torch.cuda.empty_cache()
    print(f"paper: phase in {time.perf_counter() - t0:.1f} s")


#: Phase ``wide``: the JAX package's own wide stencils and deep halos.
#: Kernel checks by rank: (grids, (kind, r, t) cases, non-periodic spec):
#: the tap-sums at r = 5 and 7, the composed contraction 72 deep (r = 7,
#: t = 4) and 128 deep (t = 8), 2D halos 35 and 56, 3D halos 10, 12, 14.
WIDE_KERNELS = {
    2: (((1024, 1024), (1000, 1030)),
        (("box", 5, 1), ("box", 7, 1), ("star", 7, 4), ("box", 7, 5), ("box", 7, 8)),
        ("reflect", "periodic")),
    3: (((128, 128, 128), (60, 70, 130)),
        (("box", 5, 1), ("box", 7, 1), ("box", 2, 5), ("star", 2, 6), ("box", 2, 7),
         ("box", 2, 8)),
        ("replicate", "reflect", "periodic")),
    1: (((2**20 + 3,),), (("box", 5, 1), ("box", 7, 4), ("box", 7, 8)), "reflect"),
}
#: The kernel checks whose launch must refuse, by (rank, kernel, halo,
#: operands): none.  The 3D tap-sum's rings past h = 10, the composed slab
#: past it and the reuse slabs at h = 16, which fit no one CTA, launch
#: over a thread-block cluster (csrc/cluster.cuh).
WIDE_REFUSED = set()
#: The main paths: (label, grid, pattern, fusion depths); every regime,
#: and auto, of each (pattern, t) against ``reference``.
WIDE_PATHS = (("2D", (8192, 8192), "Box-2D7R", tuple(range(1, 9))),
              ("3D", (512, 512, 512), "Box-3D2R", (5, 6, 7, 8)),
              ("3D", (512, 512, 512), "Star-3D2R", (5, 6, 7, 8)))
WIDE_REGIMES = ("direct", "fused_direct", "matmul", "fused_matmul",
                "fused_matmul_reuse", "sparse_matmul", "fused_sparse_matmul", None)
#: The JSON entries of the phase: (name, path label, pattern, t, kernel);
#: "composed" is one contraction of the composed kernel.
#: The F.conv yardstick of a WIDE_REPORT entry runs on the entry's grid,
#: but for the 2D composed contraction 128 deep: one F.conv2d of its 113^2
#: kernel over 8192^2 takes 51 s on an H100, so it runs on 4096^2 and the
#: entry says so (``library_grid``).
WIDE_LIBRARY_GRID = {("2D", "Box-2D7R", 8): (4096, 4096)}
WIDE_REPORT = (("stencil_direct (r=7)", "2D", "Box-2D7R", 4, "tap-sum"),
               ("stencil_banded (depth 128)", "2D", "Box-2D7R", 8, "composed"),
               ("stencil_direct3d (h=10)", "3D", "Box-3D2R", 5, "tap-sum"),
               ("stencil_banded3d (h=10)", "3D", "Box-3D2R", 5, "reuse"),
               ("stencil_direct3d (cluster, h=12)", "3D", "Box-3D2R", 6, "tap-sum"),
               ("stencil_banded3d (cluster, composed h=12)", "3D", "Box-3D2R", 6,
                "composed"),
               ("stencil_direct3d (cluster, h=16)", "3D", "Box-3D2R", 8, "tap-sum"),
               ("stencil_banded3d (cluster, composed h=16)", "3D", "Box-3D2R", 8,
                "composed"),
               ("stencil_banded3d (cluster, reuse h=16)", "3D", "Box-3D2R", 8, "reuse"),
               ("stencil_sparse3d (cluster, h=16)", "3D", "Box-3D2R", 8, "sparse"))


#: ``python3 chip_smoke.py --wide`` runs the build and phase ``wide`` alone.
WIDE_FLAG = "--wide"


def wide_calls(mods, x, w, t, bc, dim):
    """``(kernel, kname, call, plain, step, tk, operands, weights, short)``
    of every kernel check of one case: the tap-sum, the dense and the
    compacted reuse form with either operand dtype, and on a periodic grid
    at t > 1 the composed contraction (dense: the compacted one stays
    within MAX_KPAD) with the plain version one step short on the
    depth-(t-1) composed kernel.  ``call`` resolves the launch's tile as
    a plan does (``launch_geom`` held to the kernel's own layout, which
    raises "too deep" where it fits none) and launches the plan entry
    (``stencil_*_at``) on it."""
    _, sm, sd, weights, ss = mods
    from repro_torch.kernels import common
    shape, dt = tuple(x.shape), x.dtype
    bf = dt == torch.bfloat16

    def at(entry, wk, tk, need, cdt=None):
        def call():
            rk = (wk.shape[0] - 1) // 2
            geom = common.launch_geom(shape, tk * rk, need=need)
            if entry is sd.stencil_direct_at:
                return entry(x, wk, tk, geom, bc)
            return entry(x, wk, tk, geom, cdt, bc)
        return call
    out = [("tap-sum", kernel_name("stencil_direct", dim),
            at(sd.stencil_direct_at, w, t, sd.tile_need(shape, (w.shape[0] - 1) // 2, t, dt)),
            lambda: sd.stencil_direct_plain(x, w, t, bc),
            lambda v: sd.stencil_direct_plain(v, w, 1, bc), t, "f32", w, None)]
    for cdt in (dt, torch.float32 if bf else torch.bfloat16):
        ops = "bf16" if cdt == torch.bfloat16 else "tf32"
        for base, mod, entry, pv in (
                ("stencil_banded", sm, sm.stencil_matmul_at, sm.stencil_matmul_plain),
                ("stencil_sparse", ss, ss.stencil_sparse_matmul_at,
                 ss.stencil_sparse_matmul_plain)):
            out.append(("reuse", f"{kernel_name(base, dim)}[{str(cdt)[6:]}]",
                        at(entry, w, t, mod.tile_need(shape, w, t, dt, cdt), cdt),
                        lambda pv=pv, cdt=cdt: pv(x, w, t, compute_dtype=cdt, boundary=bc),
                        lambda v, pv=pv, cdt=cdt: pv(v, w, 1, compute_dtype=cdt, boundary=bc),
                        t, ops, w, None))
        if t > 1 and bc is None:
            wf = weights.fuse_weights(w, t)
            out.append(("composed", f"{kernel_name('stencil_banded', dim)}[{str(cdt)[6:]}]",
                        at(sm.stencil_matmul_at, wf, 1, sm.tile_need(shape, wf, 1, dt, cdt),
                           cdt),
                        lambda wf=wf, cdt=cdt: sm.stencil_matmul_plain(x, wf, 1,
                                                                        compute_dtype=cdt),
                        lambda v, wf=wf, cdt=cdt: sm.stencil_matmul_plain(
                            v, wf, 1, compute_dtype=cdt),
                        1, ops, wf,
                        lambda cdt=cdt: sm.stencil_matmul_plain(
                            x, weights.fuse_weights(w, t - 1), 1, compute_dtype=cdt)))
    return out


#: The share of phase wide's kernel-check weights on one tap, the x
#: neighbour of the centre (``wide_weights``).
WIDE_SHIFT = 0.75


def wide_weights(weights, kind: str, dim: int, r: int) -> np.ndarray:
    """``make_weights(seed=1)`` of the spec, scaled to 1 - WIDE_SHIFT, plus
    WIDE_SHIFT on the tap one cell right of the centre: still positive
    and summing to 1, but a step now mostly moves the grid by one cell
    instead of averaging it.  A normalized wide kernel alone damps a noise
    grid so fast that, 7 or 8 steps deep, one step more or less moves the
    output by less than the limit's own accumulation and bf16 terms
    (about 2^-7 of max|y| per step), so no limit could reject the plain
    version one step short; a moving grid keeps that step the size of the
    grid's own differences."""
    from repro_torch.stencil import StencilSpec
    w = (1 - WIDE_SHIFT) * weights.make_weights(StencilSpec(kind, dim, r), seed=1)
    w[(r,) * (dim - 1) + (r + 1,)] += WIDE_SHIFT
    return w.astype(np.float32)


def wide_kernels(mods) -> None:
    """Phase ``wide``'s kernel checks: each kernel of every WIDE_KERNELS
    case against its plain version with phase 2's limit, which must reject
    the plain version one step short; on each rank's first grid periodic
    and on its ragged grid under the rank's non-periodic spec, each in
    float32 and bfloat16.  A launch in WIDE_REFUSED
    must raise "too deep", and no other may.  The weights mostly move the
    grid (``wide_weights``).  Then one batched call at r = 7 against the
    loop of its unbatched calls, bit for bit."""
    _, sm, sd, weights, ss = mods
    from repro_torch.kernels import common
    from repro_torch.stencil import StencilSpec
    worst, margin, refused, n = {}, {}, set(), 0
    for dim, (shapes, cases, spec) in WIDE_KERNELS.items():
        runs = [(shapes[0], None, torch.float32), (shapes[0], None, torch.bfloat16),
                (shapes[-1], spec, torch.float32), (shapes[-1], spec, torch.bfloat16)]
        for (shape, bc, dtype), (kind, r, t) in itertools.product(dict.fromkeys(runs),
                                                                   cases):
            w = wide_weights(weights, kind, dim, r)
            x = grid(shape, dtype, seed=2)
            for what, kname, call, plain, step, tk, ops, wk, short in wide_calls(
                    mods, x, w, t, bc, dim):
                tag = (f"{kname} {what} {kind} r={r} t={t} {shape} {str(dtype)[6:]}"
                       + ("" if bc is None else f" boundary={boundary_label(bc)}")
                       + " (wide)")
                key = (dim, what, t * r, ops)
                try:
                    y = call()
                except ValueError as e:
                    check(key in WIDE_REFUSED and "too deep" in str(e), f"{tag}: refused: {e}")
                    refused.add(key)
                    continue
                check(key not in WIDE_REFUSED, f"{tag}: did not refuse")
                hold_to_plain(tag, kname.split("[")[0] + f" {what}", y, x, plain, step, tk,
                              ops, wk, short, worst, margin)
                n += 1
                del y
            del x
    check(refused == WIDE_REFUSED, f"wide: refused {sorted(refused)}, expected "
                                   f"{sorted(WIDE_REFUSED)}")
    print(f"wide kernels vs plain: {n} calls within their limits; worst err/tol "
          + ", ".join(f"{k}={v:.3f}" for k, v in worst.items()))
    print("  and every limit rejects the plain version one step short; worst "
          "tol/err(t-1) " + ", ".join(f"{k}={v:.3f}" for k, v in margin.items()))
    print(f"  refused as expected (rank, kernel, halo, operands): {sorted(refused)}")
    # one batched call at r = 7: the tap-sum at t = 4 and the composed
    # contraction 128 deep, three grids in one launch = three launches
    shape = (1000, 1030)
    w = weights.make_weights(StencilSpec("box", 2, 7), seed=1)
    wf = weights.fuse_weights(w, 8)
    xb = grid((3,) + shape, torch.float32, seed=3)
    for tag, at, wk, tk in (
            ("stencil_direct r=7 t=4", sd.stencil_direct_at, w, 4),
            ("stencil_banded composed depth 128", sm.stencil_matmul_at, wf, 1)):
        r_ = (wk.shape[0] - 1) // 2
        need = (sd.tile_need(shape, r_, tk, xb.dtype) if at is sd.stencil_direct_at
                else sm.tile_need(shape, wk, tk, xb.dtype, xb.dtype))
        geom = common.launch_geom(shape, tk * r_, need=need)
        yb = at(xb, wk, tk, geom, batched=True)
        loop = torch.stack([at(xi, wk, tk, geom) for xi in xb])
        diff = max_err(yb, loop)
        check(diff == 0.0, f"wide batched {tag}: differs from the loop by {diff:.3e}")
        print(f"wide batched {tag}, 3 x {shape}: = the loop of unbatched calls bit for bit")


def wide_path(mods, label, shape, pattern, ts, card):
    """One WIDE_PATHS path: every regime and auto of ``pattern`` at each
    fusion depth of ``ts`` through ``stencil_plan``, the launch counts set
    to 0 just before the run and read just after it; each plan held
    against ``reference`` (the phase-3 limits; the reference one step at a
    time) with its exact launches, a 3D fused plan whose layout fits no
    one CTA (the tap-sum's rings and the composed slab past h = 10, the
    reuse slabs at h = 16) as one launch of its kernel's cluster form
    (``<kernel> (cluster)``); a plan that cannot launch would raise "too
    deep" naming its regime when built (none does).  Then every plan that
    ran is timed with CUDA events (a plan slower than 0.2 s a call, or a
    cluster form's, once: the reuse slabs at h = 14 take over a second).
    Returns the run's counts and the times by (t, regime)."""
    kernels = mods[0]
    from repro_torch.kernels import stencil_plan
    from repro_torch.kernels.plan import auto_decision
    from repro_torch.stencil import StencilSpec, make_weights
    spec = StencilSpec.from_name(pattern)
    w = make_weights(spec, seed=0)
    x = grid(shape, torch.float32, seed=0)
    dim, mx, sw = len(shape), float(x.abs().max()), float(np.abs(w).sum())
    ran, refused = [], []
    step = stencil_plan(w, shape, torch.float32, 1, backend="reference")
    ref, done = x, 0
    kernels.reset_launch_counts()
    for t in ts:
        while done < t:                # the reference, one step at a time
            ref, done = step(ref), done + 1
        for backend in WIDE_REGIMES:
            regime = backend or auto_decision(spec, shape, torch.float32, t)[1].backend
            tag = f"wide {label} {pattern} t={t} {backend or 'auto'}"
            try:
                plan = stencil_plan(w, shape, torch.float32, t, backend=backend)
            except ValueError as e:
                check(dim == 3 and "too deep" in str(e) and f"{regime}'s own" in str(e),
                      f"{tag}: refused: {e}")
                refused.append(f"t={t} {backend or 'auto'}")
                continue
            before = kernels.launch_counts()
            t1 = time.perf_counter()
            y = plan(x)
            torch.cuda.synchronize()
            first = time.perf_counter() - t1
            after = kernels.launch_counts()
            kname, n = expected_launches(plan.backend, t, dim)
            delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if dim == 3 and n == 1 and delta == {f"{kname} (cluster)": 1}:
                kname += " (cluster)"
            check(delta == {kname: n}, f"{tag}: launches {delta}, expected {n} of {kname}")
            check(tuple(y.shape) == shape and bool(torch.isfinite(y).all()),
                  f"{tag}: shape or non-finite")
            err = max_err(y, ref)
            tol = (1e-5 * t * mx if kname.startswith("stencil_direct")
                   else t * 2**-10 * sw * mx)
            check(err <= tol, f"{tag}: max|err| vs reference {err:.3e} > tol {tol:.3e}")
            ran.append((t, backend, plan, kname, n, first, err, tol))
            del y
    counts = kernels.launch_counts()
    for k in {r[3] for r in ran}:
        check(counts[k] > 0, f"wide: kernel {k} was not launched on the {label} path")
    check(not refused, f"wide: {label} {pattern} refused {refused}")
    del ref, step
    times = {}
    for t, backend, plan, kname, n, first, err, tol in ran:
        ms = (cuda_ms(lambda: plan(x), reps=3, warmup=1)
              if first < 0.2 and not kname.endswith("(cluster)")
              else cuda_ms(lambda: plan(x), reps=1, warmup=0))
        times[(t, backend or "auto")] = ms
        print(f"  {pattern} t={t:<2d} {backend or 'auto':20s} {plan.backend:20s} "
              f"{kname:18s} x{n}  read_amp {plan.geom.read_amp:7.4f}  {ms:9.4f} ms  "
              f"max|err| {err:.3e} (tol {tol:.3e})")
    print(f"wide path {label} {pattern} on {shape} float32, t in {list(ts)}: every "
          f"regime that builds matches the reference; launches "
          f"{ {k: v for k, v in counts.items() if v} }; refused (too deep, naming the "
          f"regime): {refused or 'none'}; on {card}")
    del x
    return counts, times


def wide_report(mods, counts, card) -> list:
    """The WIDE_REPORT entries: each kernel's call on its path's grid at
    that path's tile (``stencil_*_at``), held against its plain version,
    timed beside the plain version and one F.conv of the composed kernel
    (TF32), with the bound of the FLOPs the stencil needs (2 per nonzero
    tap, point and step; the composed kernel's taps, one step) at the
    unit's peak, or the bytes of one read and one write at 3.35 TB/s.  The
    plain version (0.24-3.2 s a call) is timed in its checked call, and
    the F.conv of a 57^2, 113^2 or 21^3 to 33^3 kernel (4-52 s) once, with
    no warm-up, once for the 3D entries of one (pattern, t), which share
    its call; the kernels' calls over 5 after one, the cluster forms' over
    3."""
    kernels, sm, sd, weights, ss = mods
    from repro_torch.stencil import StencilSpec, make_weights
    report, library = [], {}
    for name, label, pattern, t, what in WIDE_REPORT:
        spec = StencilSpec.from_name(pattern)
        shape = next(g for lb, g, _, _ in WIDE_PATHS if lb == label)
        dim = len(shape)
        w = make_weights(spec, seed=0)
        x = grid(shape, torch.float32, seed=0)
        n, mx = x.numel(), float(x.abs().max())
        wf = weights.fuse_weights(w, t)
        if what == "tap-sum":
            from repro_torch.kernels import common
            geom = common.launch_geom(shape, t * spec.radius,
                                      need=sd.tile_need(shape, spec.radius, t, x.dtype))
            kern = lambda: sd.stencil_direct_at(x, w, t, geom)  # noqa: E731
            plain = lambda: sd.stencil_direct_plain(x, w, t)  # noqa: E731
            peak, tol = FP32_FLOPS, 1e-5 * t * mx
            ops, base = t * 2 * int(np.count_nonzero(w)) * n, "stencil_direct"
        else:
            from repro_torch.kernels import common
            wk, tk = (wf, 1) if what == "composed" else (w, t)
            rk = (wk.shape[0] - 1) // 2
            mod, at = ((ss, ss.stencil_sparse_matmul_at) if what == "sparse"
                       else (sm, sm.stencil_matmul_at))
            geom = common.launch_geom(shape, tk * rk,
                                      need=mod.tile_need(shape, wk, tk, x.dtype, x.dtype))
            kern = lambda: at(x, wk, tk, geom)  # noqa: E731
            plain = lambda: sm.stencil_matmul_plain(x, wk, tk)  # noqa: E731
            peak, tol = TF32_FLOPS, t * 2**-10 * float(np.abs(w).sum()) * mx
            ops = (2 * int(np.count_nonzero(wf)) * n if what == "composed"
                   else t * 2 * int(np.count_nonzero(w)) * n)
            base = "stencil_sparse" if what == "sparse" else "stencil_banded"
        kname = kernel_name(base, dim)
        kernels.reset_launch_counts()
        y = kern()
        torch.cuda.synchronize()
        moved = {k: v for k, v in kernels.launch_counts().items() if v}
        check(len(moved) == 1 and next(iter(moved)) in (kname, f"{kname} (cluster)")
              and next(iter(moved.values())) == 1,
              f"wide report {name}: launches {moved}, expected one of {kname} or its "
              "cluster form")
        counter = next(iter(moved))
        ctas = kernels.cluster_ctas().get(counter, 1)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ref = plain()
        b.record()
        b.synchronize()
        plain_ms = a.elapsed_time(b)
        err = max_err(y, ref)
        del y, ref
        check(err <= tol, f"wide report {name}: max|err| vs plain {err:.3e} > tol {tol:.3e}")
        bytes_ms, ops_ms = 2 * n * 4 / HBM_BPS * 1e3, ops / peak * 1e3
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCES[kname][0],
                 "replaces": KERNEL_SOURCES[kname][1], "launches": counts[label][counter],
                 "max_abs_err": err, "ms": cuda_ms(kern, reps=3 if ctas > 1 else 5,
                                                   warmup=1),
                 "plain_ms": plain_ms,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "library_ms": library.get((label, pattern, t)),
                 "tile": f"{geom.z_slab}x{geom.strip_m}x{geom.w_tile}" if dim == 3
                         else f"{geom.strip_m}x{geom.w_tile}", "cluster_ctas": ctas}
        lshape = WIDE_LIBRARY_GRID.get((label, pattern, t), shape)
        if entry["library_ms"] is None:
            lx = x if lshape == shape else grid(lshape, torch.float32, seed=0)
            entry["library_ms"] = library[(label, pattern, t)] = cuda_ms(
                conv_yardstick(lx, wf, True), reps=1, warmup=0)
            del lx
        if lshape != shape:
            entry["library_grid"] = "x".join(map(str, lshape))
        report.append(entry)
        print(f"  kernel {name} ({pattern} t={t}, tile {entry['tile']}, {ctas} CTA"
              f"{'s' if ctas > 1 else ''} a tile): {entry['ms']:.4f} ms "
              f"(bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}), plain "
              f"{entry['plain_ms']:.4f} ms, F.conv{dim}d of the composed kernel (TF32) "
              f"{entry['library_ms']:.4f} ms on {'x'.join(map(str, lshape))}, "
              f"max|err| vs plain {err:.3e}, "
              f"launches {entry['launches']}; on {card}")
        del x
        torch.cuda.empty_cache()
    return report


#: Phase wide's foils (K8-K10) at the wide radii and past contraction
#: depth 64: (name, rank, radius, t, staging, what), each a Box stencil,
#: periodic, on the reserves' tile (the 128-deep composed contraction on
#: its own layout's 64 x 64, whose whole strips cover h = 56): checked and
#: timed on WIDE_FOIL_GRIDS, whose plain versions and F.conv yardsticks
#: are short, and held bit for bit to the default kernel on the main
#: paths' grids (WIDE_PATHS: 8192^2, 512^3), where the guard's ladder
#: reaches them.
WIDE_FOILS = (("stencil_direct (wholestrip, r=5)", 2, 5, 1, "wholestrip", "tap-sum"),
              ("stencil_direct (wholestrip, r=7)", 2, 7, 1, "wholestrip", "tap-sum"),
              ("stencil_direct (9tile, r=5)", 2, 5, 1, "9tile", "tap-sum"),
              ("stencil_direct (9tile, r=7)", 2, 7, 1, "9tile", "tap-sum"),
              ("stencil_direct3d (wholeslab, r=5)", 3, 5, 1, "wholestrip", "tap-sum"),
              ("stencil_direct3d (wholeslab, r=7)", 3, 7, 1, "wholestrip", "tap-sum"),
              ("stencil_banded (wholestrip, depth 128)", 2, 7, 8, "wholestrip",
               "composed"))
WIDE_FOIL_GRIDS = {2: (1024, 1024), 3: (128, 128, 128)}
#: The guarded wide plans: auto (matmul) of (pattern, the card's grid, the
#: CPU's grid) at t=1 under a fault spec that fails auto, auto+degraded,
#: fused_direct and direct, so the ladder lands on the whole-strip (2D) or
#: whole-slab (3D) tap-sum foil at r = 7.  The CPU runs the plain rungs on a
#: grid whose auto decision, and so whose ladder, is the card grid's.
WIDE_GUARDS = (("Box-2D7R", (8192, 8192), (1024, 1024)),
               ("Box-3D7R", (512, 512, 512), (32, 32, 32)))
WIDE_GUARD_SPEC = "compile:4"


def wide_foil_call(mods, dim, r, t, staging, what, shape):
    """One WIDE_FOILS call on ``shape``: ``(x, w, run, plain, tol, counter,
    kname, ops_ms, wf, geom)``, ``run(staging)`` the launch on the foil's
    tile with that staging ("region": the default kernel)."""
    _, sm, sd, weights, _ = mods
    from repro_torch.kernels import common
    from repro_torch.stencil import StencilSpec
    w = weights.make_weights(StencilSpec("box", dim, r), seed=0)
    x = grid(shape, torch.float32, seed=0)
    n, mx, sw = x.numel(), float(x.abs().max()), float(np.abs(w).sum())
    if what == "tap-sum":
        geom = common.launch_geom(shape, t * r)
        run = lambda st: sd.stencil_direct_at(x, w, t, geom, staging=st)  # noqa: E731
        plain = lambda: sd.stencil_direct_plain(x, w, t)  # noqa: E731
        tol, base, wf = 1e-5 * t * mx, "stencil_direct", w
        ops = t * 2 * int(np.count_nonzero(w)) * n / FP32_FLOPS
    else:
        wf = weights.fuse_weights(w, t)
        geom = common.launch_geom(shape, t * r, need=sm.tile_need(
            shape, wf, 1, x.dtype, x.dtype))
        run = lambda st: sm.stencil_matmul_at(x, wf, 1, geom, staging=st)  # noqa: E731
        plain = lambda: sm.stencil_matmul_plain(x, wf, 1)  # noqa: E731
        tol, base = t * 2**-10 * sw * mx, "stencil_banded"
        ops = 2 * int(np.count_nonzero(wf)) * n / TF32_FLOPS
    kname = kernel_name(base, dim)
    counter = f"{kname} ({'wholeslab' if dim == 3 else staging})"
    return x, w, run, plain, tol, counter, kname, ops * 1e3, wf, geom


def wide_foils(mods, card) -> list:
    """The WIDE_FOILS calls: each foil's launch (``stencil_*_at`` with the
    foil's staging) against the default kernel of the same call and tile,
    bit for bit, and against the plain version and the ``reference``
    backend (phase wide's reference limits: the tap-sum 1e-5 t max|x|, the
    composed contraction t 2^-10 sum|w| max|x| against t reference steps);
    then timed beside the default kernel, the plain version and
    one F.conv of the composed kernel (TF32): the plain version once, the
    foil's and the default's 5 calls and the F.conv's 3 after one (on these small
    grids cuDNN's first call is mostly its set-up).  Returns their JSON
    entries, launches counted over the checked calls."""
    kernels = mods[0]
    from repro_torch.kernels import stencil_plan
    report = []
    for name, dim, r, t, staging, what in WIDE_FOILS:
        shape = WIDE_FOIL_GRIDS[dim]
        x, w, run, plain, tol, counter, kname, ops_ms, wf, geom = wide_foil_call(
            mods, dim, r, t, staging, what, shape)
        kernels.reset_launch_counts()
        y = run(staging)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()[counter]
        diff = max_err(y, run("region"))
        err = max_err(y, plain())
        err_ref = max_err(y, stencil_plan(w, shape, torch.float32, t,
                                          backend="reference")(x))
        tag = f"wide foil {name} {shape}, tile {geom.strip_m}x{geom.w_tile}"
        check(launches == 1, f"{tag}: {launches} launches of {counter}")
        check(diff == 0.0, f"{tag}: differs from the default kernel by {diff:.3e}")
        check(err <= tol, f"{tag}: max|err| vs plain {err:.3e} > tol {tol:.3e}")
        check(err_ref <= tol, f"{tag}: max|err| vs reference {err_ref:.3e} > tol {tol:.3e}")
        del y
        bytes_ms = 2 * x.numel() * 4 / HBM_BPS * 1e3
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCES[kname][0],
                 "replaces": FOIL_REPLACES["9tile_direct" if staging == "9tile"
                                           else "wholestrip"],
                 "launches": launches, "max_abs_err": err,
                 "ms": cuda_ms(lambda: run(staging), reps=5, warmup=1),
                 "plain_ms": cuda_ms(plain, reps=1, warmup=0),
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "library_ms": cuda_ms(conv_yardstick(x, wf, True), reps=3, warmup=1),
                 "default_ms": cuda_ms(lambda: run("region"), reps=5, warmup=1)}
        report.append(entry)
        print(f"  {tag}: = the default kernel bit for bit, max|err| vs plain {err:.3e}, "
              f"vs reference {err_ref:.3e} (tol {tol:.3e}); {entry['ms']:.4f} ms (default "
              f"{entry['default_ms']:.4f}, "
              f"bound {entry['bound_ms']:.4f} by {entry['bound_by']}, plain "
              f"{entry['plain_ms']:.4f}, F.conv{dim}d {entry['library_ms']:.4f}); on {card}")
        del x
    return report


def wide_foils_full(mods, report, card) -> None:
    """Each WIDE_FOILS call on its main path's grid (WIDE_PATHS), the
    launch counts set to 0 just before it: one launch of the foil, equal
    to the default kernel's call on the same tile bit for bit; the two
    calls' times (CUDA events, one call each after one) go into the foil's
    JSON entry of ``report`` as ``full_grid``, ``full_ms`` and
    ``full_default_ms``."""
    kernels = mods[0]
    grids = {len(g): g for _, g, _, _ in WIDE_PATHS}
    for entry, (name, dim, r, t, staging, what) in zip(report, WIDE_FOILS):
        shape = grids[dim]
        x, _, run, _, _, counter, _, _, _, geom = wide_foil_call(
            mods, dim, r, t, staging, what, shape)
        kernels.reset_launch_counts()
        y = run(staging)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        diff = max_err(y, run("region"))
        del y
        tile = (f"{geom.z_slab}x" if dim == 3 else "") + f"{geom.strip_m}x{geom.w_tile}"
        tag = f"wide foil {name} {shape}, tile {tile}"
        check(launches == {counter: 1}, f"{tag}: launches {launches}")
        check(diff == 0.0, f"{tag}: differs from the default kernel by {diff:.3e}")
        entry.update(full_grid="x".join(map(str, shape)),
                     full_ms=cuda_ms(lambda: run(staging), reps=1, warmup=1),
                     full_default_ms=cuda_ms(lambda: run("region"), reps=1, warmup=1))
        print(f"  {tag}: one launch, = the default kernel bit for bit; "
              f"{entry['full_ms']:.4f} ms (default {entry['full_default_ms']:.4f}); on {card}")
        del x
        torch.cuda.empty_cache()


def wide_guarded(mods) -> None:
    """WIDE_GUARDS: each guarded plan on the card, on its main path's grid,
    under WIDE_GUARD_SPEC must fail the rungs the same guarded plan fails
    on the CPU (JAX's ladder) and land where it lands, on a whole-strip or
    whole-slab foil, with one launch of its kernel, the launch counts set
    to 0 just before its call; and match the reference."""
    kernels = mods[0]
    from repro_torch.kernels import (clear_plan_cache, guarded_stencil_plan,
                                     stencil_plan)
    from repro_torch.stencil import StencilSpec, make_weights
    from repro_torch.testing import faults
    spec = WIDE_GUARD_SPEC
    for pattern, shape, cpu_shape in WIDE_GUARDS:
        w = make_weights(StencilSpec.from_name(pattern), seed=0)
        rungs = {}
        for device, sh in (("cpu", cpu_shape), ("cuda", shape)):
            x = grid(sh, torch.float32, seed=0)
            clear_plan_cache()
            os.environ["REPRO_FAULTS"] = spec
            faults.reset_faults()
            try:
                g = guarded_stencil_plan(w, sh, torch.float32, 1, device=device)
                kernels.reset_launch_counts()
                y = g(x.cpu() if device == "cpu" else x)
                if device == "cuda":
                    torch.cuda.synchronize()
                counts = {k: v for k, v in kernels.launch_counts().items() if v}
            finally:
                os.environ.pop("REPRO_FAULTS", None)
                faults.reset_faults()
                clear_plan_cache()
            rungs[device] = (g.rung, [h["rung"] for h in g.history], counts)
        rung, history, counts = rungs["cuda"]
        check((rung, history) == rungs["cpu"][:2] and rung.endswith("_wholestrip"),
              f"wide guarded {pattern}: the card fails {history} and lands on "
              f"{rung!r}, the CPU fails {rungs['cpu'][1]} and lands on {rungs['cpu'][0]!r}")
        kname, n = expected_launches(rung, 1, len(shape))
        check(counts == {kname: n}, f"wide guarded {pattern}: launches {counts}")
        ref = stencil_plan(w, shape, torch.float32, 1, backend="reference")(x)
        err, tol = max_err(y, ref), 1e-5 * float(x.abs().max())
        check(err <= tol, f"wide guarded {pattern}: max|err| {err:.3e} > {tol:.3e}")
        print(f"wide guarded {pattern} t=1 {shape}: REPRO_FAULTS={spec} fails "
              f"{', '.join(history)}; lands on {rung} as on the CPU ({cpu_shape}) "
              f"(launches {counts}, max|err| vs reference {err:.3e})")
        del x, y, ref
        torch.cuda.empty_cache()


#: Phase wide's fourth rung (the workspace forms, csrc/*.cu built with
#: -DREPRO_WORKSPACE; common.WorkspaceLayout): each form's kernel check at
#: the deepest cell of its kind the phase can afford, on WS_GRIDS: (name,
#: rank, kind, r, t, what).  The composed contraction 72 deep (r = 4, t =
#: 7, past MAX_KPAD; its kernel composed on the card, ``compose_on_card``),
#: where the limit still rejects the plain version one step short; at its
#: deepest see WS_DEEPEST; the 2D folds at t = 16 (h = 112):
#: at t = 29 their TF32 limit, 2^-10 a step, passes a field smoothed 28
#: times one step short; float32 grids (a bf16 fold 8 to 29 steps deep
#: moves by less than its limit's bf16 terms in one step).
WS_GRIDS = {3: (128, 128, 128), 2: (1024, 1024)}
WS_KERNELS = (("stencil_direct3d (workspace)", 3, "box", 7, 8, "tap-sum"),
              ("stencil_banded3d (workspace)", 3, "box", 7, 8, "reuse"),
              ("stencil_sparse3d (workspace)", 3, "star", 7, 8, "sparse"),
              ("stencil_banded3d (workspace)", 3, "box", 4, 7, "composed"),
              ("stencil_direct (workspace)", 2, "box", 7, 29, "tap-sum"),
              ("stencil_banded (workspace)", 2, "box", 7, 16, "reuse"),
              ("stencil_sparse (workspace)", 2, "star", 7, 16, "sparse"))
#: The composed contraction at its deepest, 128 (r = 7, t = 8: a 113^3
#: kernel, 12,769 bands), on WS_GRIDS: ``kernel_limit``'s accumulation term
#: (2 n_taps 2^-23 a step, 1.44 M taps) passes the plain version one step
#: short there, so beside that limit its output must lie nearer the plain
#: version at t steps than at t - 1.
WS_DEEPEST = ("stencil_banded3d (workspace)", 3, "box", 7, 8, "composed")
#: The forced workspace launches (``budget=1``) held bit for bit to the
#: one-CTA launch of the same call: (rank, kind, r, t, what) on a ragged
#: grid one CTA holds.
WS_FORCED = ((3, "box", 3, 2, "tap-sum"), (3, "box", 2, 3, "composed"),
             (3, "box", 1, 4, "reuse"), (3, "star", 2, 3, "sparse"),
             (2, "box", 7, 2, "tap-sum"), (2, "box", 3, 3, "reuse"),
             (2, "box", 7, 8, "composed"))
WS_FORCED_GRIDS = {3: (60, 70, 130), 2: (1000, 1030)}
#: The main paths' fourth-rung cells at full width (512^3): auto on the
#: refused cells whose picks are fused_direct and fused_matmul_reuse, the
#: compacted reuse fold at Box-3D7R t = 2, and the four fused regimes on
#: Box-3D3R at t = 8 (its reuse folds, dense and compacted, fit a cluster
#: there): (pattern, t, backends).
WS_PATHS = (("Box-3D3R", 5, (None,)), ("Box-3D3R", 6, (None,)),
            ("Box-3D3R", 7, (None,)),
            ("Box-3D3R", 8, (None, "fused_direct", "fused_matmul",
                             "fused_matmul_reuse", "fused_sparse_matmul")),
            ("Star-3D3R", 6, (None,)), ("Star-3D3R", 7, (None,)),
            ("Star-3D3R", 8, (None,)), ("Box-3D7R", 2, (None, "fused_sparse_matmul")))
WS_SHAPE = (512, 512, 512)
#: The other fourth-rung cells, on 128^3: radii 4..7 at the shallowest
#: depth past any CTA and cluster (r = 4: t = 5; r >= 5: t = 3) and at t =
#: 8, the reuse regimes and the tap-sum (the composed contraction past them
#: needs the host to compose for tens of seconds a cell).
WS_CELLS = tuple((f"{k}-3D{r}R", t, b) for r in (4, 5, 6, 7)
                 for t in ((5, 8) if r == 4 else (3, 8)) for k in ("Box", "Star")
                 for b in ("fused_direct", "fused_matmul_reuse", "fused_sparse_matmul"))
WS_CELLS_SHAPE = (128, 128, 128)
#: The JSON entries of the fourth rung: (name, path, pattern, t, backend:
#: a cell of WS_PATHS or WS_2D_PATHS, None its auto).
WS_REPORT = (("stencil_direct3d (workspace, Box-3D3R t=8)", "3D", "Box-3D3R", 8, "fused_direct"),
             ("stencil_banded3d (workspace, composed Box-3D3R t=8)", "3D", "Box-3D3R", 8,
              "fused_matmul"),
             ("stencil_banded3d (workspace, reuse Box-3D7R t=2)", "3D", "Box-3D7R", 2,
              None),
             ("stencil_sparse3d (workspace, Box-3D7R t=2)", "3D", "Box-3D7R", 2,
              "fused_sparse_matmul"),
             ("stencil_direct (workspace, Box-2D7R t=16)", "2D", "Box-2D7R", 16, "fused_direct"),
             ("stencil_banded (workspace, reuse Box-2D7R t=16)", "2D", "Box-2D7R", 16,
              "fused_matmul_reuse"),
             ("stencil_sparse (workspace, Box-2D7R t=16)", "2D", "Box-2D7R", 16,
              "fused_sparse_matmul"))
#: The F.conv yardstick of a WS_REPORT cell runs on the cell's own grid,
#: but for Box-3D3R t = 8: one F.conv3d of its 49^3 composed kernel over
#: 512^3 takes 51 s on an H100, so it runs on 256^3 and the entry says so
#: (``library_grid``).
WS_LIBRARY_GRID = {("Box-3D3R", 8): (256, 256, 256)}
WS_2D_SHAPE = (1024, 1024)
#: The 2D cells past one CTA, on WS_2D_SHAPE: (pattern, t, backends).
WS_2D_PATHS = (("Box-2D7R", 16, ("fused_direct", "fused_matmul_reuse", "fused_sparse_matmul")),
               ("Box-2D7R", 29, ("fused_direct", "fused_matmul_reuse")))


def compose_on_card(w: np.ndarray, t: int) -> np.ndarray:
    """``w`` composed ``t`` times (the full convolution of ``fuse_weights``)
    in float64 on the card, for the F.conv yardsticks only: the same kernel
    up to float64 rounding, in a second where the host composes a 113^3
    kernel in minutes."""
    nd = w.ndim
    conv = {2: F.conv2d, 3: F.conv3d}[nd]
    r = (w.shape[0] - 1) // 2
    k = torch.from_numpy(np.ascontiguousarray(w, np.float64)).cuda()
    out = k
    for _ in range(t - 1):
        y = F.pad(out[None, None], (2 * r,) * (2 * nd))
        out = conv(y, torch.flip(k, tuple(range(nd)))[None, None])[0, 0]
    return out.float().cpu().numpy()


def ws_call(mods, x, w, t, what, cdt=None, budget=None):
    """``(call, plain, step, tk, ops, wk, short)`` of one fourth-rung kernel
    check: the plan entry on the tile the rule resolves (its fourth rung
    past any CTA and cluster), ``budget`` as the entries take it; the
    composed contraction's kernel composed on the card."""
    _, sm, sd, weights, ss = mods
    from repro_torch.kernels import common
    shape, dt = tuple(x.shape), x.dtype
    cdt = dt if cdt is None else cdt
    r = (w.shape[0] - 1) // 2
    if what == "tap-sum":
        geom = common.launch_geom(shape, t * r, need=sd.tile_need(shape, r, t, dt))
        return (lambda: sd.stencil_direct_at(x, w, t, geom, budget=budget),
                lambda: sd.stencil_direct_plain(x, w, t),
                lambda v: sd.stencil_direct_plain(v, w, 1), t, "f32", w, None)
    ops = "bf16" if cdt == torch.bfloat16 else "tf32"
    if what == "composed":
        wf = compose_on_card(w, t)
        geom = common.launch_geom(shape, t * r, need=sm.tile_need(shape, wf, 1, dt, cdt))
        return (lambda: sm.stencil_matmul_at(x, wf, 1, geom, cdt, budget=budget),
                lambda: sm.stencil_matmul_plain(x, wf, 1, compute_dtype=cdt),
                lambda v: sm.stencil_matmul_plain(v, wf, 1, compute_dtype=cdt), 1, ops, wf,
                lambda: sm.stencil_matmul_plain(x, compose_on_card(w, t - 1), 1,
                                                compute_dtype=cdt))
    mod, at, plain = ((ss, ss.stencil_sparse_matmul_at, ss.stencil_sparse_matmul_plain)
                      if what == "sparse" else
                      (sm, sm.stencil_matmul_at, sm.stencil_matmul_plain))
    geom = common.launch_geom(shape, t * r, need=mod.tile_need(shape, w, t, dt, cdt))
    return (lambda: at(x, w, t, geom, cdt, budget=budget),
            lambda: plain(x, w, t, compute_dtype=cdt),
            lambda v: plain(v, w, 1, compute_dtype=cdt), t, ops, w, None)


def ws_kernels(mods) -> None:
    """The fourth rung's kernel checks: each workspace form at WS_KERNELS'
    cell against its plain version within phase 2's limit, which must
    reject the plain version one step short, one launch of the form; then
    each WS_FORCED call forced onto the fourth rung (``budget=1``) bit for
    bit its one-CTA launch."""
    kernels, _, _, weights, _ = mods
    worst, margin = {}, {}
    for name, dim, kind, r, t, what in WS_KERNELS:
        shape = WS_GRIDS[dim]
        w = wide_weights(weights, kind, dim, r)
        x = grid(shape, torch.float32, seed=2)
        call, plain, step, tk, ops, wk, short = ws_call(mods, x, w, t, what)
        kernels.reset_launch_counts()
        y = call()
        torch.cuda.synchronize()
        moved = {k: v for k, v in kernels.launch_counts().items() if v}
        tag = f"{name} {what} {kind} r={r} t={t} {shape}"
        check(moved == {name: 1}, f"{tag}: launches {moved}")
        hold_to_plain(tag, f"{name} {what}", y, x, plain, step, tk, ops, wk, short, worst,
                      margin)
        del x, y
    name, dim, kind, r, t, what = WS_DEEPEST
    w = wide_weights(weights, kind, dim, r)
    x = grid(WS_GRIDS[dim], torch.float32, seed=2)
    call, plain, _, _, ops, wk, short = ws_call(mods, x, w, t, what)
    kernels.reset_launch_counts()
    y = call()
    torch.cuda.synchronize()
    moved = {k: v for k, v in kernels.launch_counts().items() if v}
    tag = f"{name} {what} {kind} r={r} t={t} {tuple(x.shape)}"
    check(moved == {name: 1}, f"{tag}: launches {moved}")
    p = plain()
    tol = kernel_limit(ops, float(np.abs(wk).sum()), int(np.count_nonzero(wk)),
                       [float(x.abs().max()), float(p.abs().max())], False)
    err, wrong = max_err(y, p), max_err(y, short())
    check(bool(torch.isfinite(y).all()) and err <= tol and err < wrong,
          f"{tag}: max|err| {err:.3e} (limit {tol:.3e}), vs t-1 {wrong:.3e}")
    print(f"workspace {tag} ({wk.shape[0]}^3 kernel, {t * r * 2 + 16} deep): max|err| vs plain "
          f"{err:.3e} (limit {tol:.3e}), vs the plain version one step short {wrong:.3e}")
    del x, y, p
    print("workspace kernels vs plain: worst err/tol "
          + ", ".join(f"{k}={v:.3f}" for k, v in worst.items()))
    print("  and every limit rejects the plain version one step short; worst tol/err(t-1) "
          + ", ".join(f"{k}={v:.3f}" for k, v in margin.items()))
    n = 0
    for dim, kind, r, t, what in WS_FORCED:
        shape = WS_FORCED_GRIDS[dim]
        w = wide_weights(weights, kind, dim, r)
        for dt in (torch.float32, torch.bfloat16):
            x = grid(shape, dt, seed=3)
            one = ws_call(mods, x, w, t, what)[0]
            forced = ws_call(mods, x, w, t, what, budget=1)[0]
            kernels.reset_launch_counts()
            y1 = one()
            yw = forced()
            torch.cuda.synchronize()
            moved = {k: v for k, v in kernels.launch_counts().items() if v}
            forms = [k for k in moved if k.endswith("(workspace)")]
            tag = f"forced workspace {dim}D {what} {kind} r={r} t={t} {shape} {str(dt)[6:]}"
            check(len(moved) == 2 and len(forms) == 1 and set(moved.values()) == {1}
                  and all("(" not in k for k in moved if k not in forms),
                  f"{tag}: launches {moved}, expected one CTA's and the workspace form's")
            diff = max_err(yw, y1)
            check(diff == 0.0, f"{tag}: differs from the one-CTA kernel by {diff:.3e}")
            n += 1
            del x, y1, yw
    print(f"workspace forms forced onto the fourth rung: {n} calls, each bit for bit its "
          "one-CTA launch")


def ws_bound_ms(x: torch.Tensor, w: np.ndarray, t: int, backend: str) -> tuple:
    """``(bound_ms, bound_by)`` of ``t`` steps of ``w`` on ``x``: one read
    and one write of the grid at 3.35 TB/s, or 2 FLOPs per nonzero tap,
    point and step at the unit's peak (the composed kernel's taps, one
    step, for the composed contraction)."""
    from repro_torch.kernels.plan import spec_from_weights
    from repro_torch.stencil.weights import fused_num_points
    n = x.numel()
    if backend == "fused_matmul":
        ops = 2 * fused_num_points(spec_from_weights(w), t) * n
    else:
        ops = t * 2 * int(np.count_nonzero(w)) * n
    peak = FP32_FLOPS if backend.endswith("direct") else TF32_FLOPS
    bytes_ms, ops_ms = 2 * n * x.element_size() / HBM_BPS * 1e3, ops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def ws_path(mods, shape, cells, card, timed: bool, report=()) -> tuple:
    """Plans of the fourth rung through ``stencil_plan``: each ``(pattern,
    t, backends)`` of ``cells`` on ``shape``, the launch counts set to 0
    just before the run and read just after; every plan one launch of its
    kernel's workspace form where its layout fits no CTA and no cluster
    (``plan.fn.workspace``; else of its one-CTA or cluster form), against
    ``reference`` stepped t times (the wide paths' limits).  ``timed``:
    each workspace plan's ms beside its bound, the fastest t-launch
    regime's (direct, matmul, sparse_matmul) ms and its workspace; the
    ``report`` cells (name, pattern, t, backend) also their JSON entries
    (``ws_entry``) and, once a (pattern, t), one F.conv of the composed
    kernel on the same grid.  Returns the run's counts and the entries."""
    kernels = mods[0]
    from repro_torch.kernels import stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights
    x = grid(shape, torch.float32, seed=0)
    mx, dim = float(x.abs().max()), len(shape)
    plans, entries, fastest, library = {}, [], {}, {}
    kernels.reset_launch_counts()
    for pattern in dict.fromkeys(p for p, _, _ in cells):
        spec = StencilSpec.from_name(pattern)
        w = make_weights(spec, seed=0)
        sw = float(np.abs(w).sum())
        step = stencil_plan(w, shape, torch.float32, 1, backend="reference")
        ref, done = x, 0
        for t in sorted({t for p, t, _ in cells if p == pattern}):
            while done < t:
                ref, done = step(ref), done + 1
            for backend in next(b for p, tt, b in cells if p == pattern and tt == t):
                plan = stencil_plan(w, shape, torch.float32, t, backend=backend)
                tag = f"workspace {pattern} t={t} {backend or 'auto'} on {shape}"
                lay = plan.fn.workspace
                before = kernels.launch_counts()
                y = plan(x)
                torch.cuda.synchronize()
                after = kernels.launch_counts()
                kname, n = expected_launches(plan.backend, t, dim)
                delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                want = ([f"{kname} (workspace)"] if lay is not None
                        else [kname, f"{kname} (cluster)"])
                check(n == 1 and len(delta) == 1 and next(iter(delta)) in want
                      and next(iter(delta.values())) == 1,
                      f"{tag}: launches {delta}, expected one of {want}")
                kname = next(iter(delta))
                err = max_err(y, ref)
                tol = (1e-5 * t * mx if kname.startswith("stencil_direct")
                       else t * 2**-10 * sw * mx)
                check(bool(torch.isfinite(y).all()) and err <= tol,
                      f"{tag}: max|err| vs reference {err:.3e} > tol {tol:.3e}")
                plans[(pattern, t, backend)] = (plan if timed and lay is not None else None,
                                                plan.backend, w, kname, lay, err, tol)
                del y, plan
        del ref, step
    counts = kernels.launch_counts()     # the run's; the timings below add
    for (pattern, t, backend), (plan, picked, w, kname, lay, err, tol) in plans.items():
        line = (f"  workspace {pattern} t={t} {backend or 'auto'} on {shape}: {picked} "
                f"x1 {kname}, "
                + ("no workspace" if lay is None else
                   f"{lay.total_bytes / 2**20:.1f} MiB ({lay.ctas} x {lay.slice_bytes} B)")
                + f", max|err| {err:.3e} (tol {tol:.3e})")
        if plan is not None:
            ms = cuda_ms(lambda: plan(x), reps=1, warmup=0)
            bound, by = ws_bound_ms(x, w, t, picked)
            if (pattern, t) not in fastest:
                fast = {}
                for b in ("direct", "matmul", "sparse_matmul"):
                    p2 = stencil_plan(w, shape, torch.float32, t, backend=b)
                    fast[b] = cuda_ms(lambda: p2(x), reps=1, warmup=1)
                fastest[(pattern, t)] = min(fast.items(), key=lambda kv: kv[1])
            best, best_ms = fastest[(pattern, t)]
            line += (f"; {ms:.3f} ms (bound {bound:.3f} by {by}), fastest t-launch "
                     f"{best} {best_ms:.3f} ms; on {card}")
            for name, p, tt, b in report:
                if (p, tt, b) == (pattern, t, backend):
                    if (p, tt) not in library:
                        lx = (grid(WS_LIBRARY_GRID[(p, tt)], torch.float32, seed=0)
                              if (p, tt) in WS_LIBRARY_GRID else x)
                        library[(p, tt)] = (cuda_ms(conv_yardstick(
                            lx, compose_on_card(w, t), True), reps=1, warmup=0),
                            tuple(lx.shape))
                        del lx
                    print(line)
                    line = None
                    entries.append(ws_entry(mods, name, x, w, t, picked, plan, ms, counts,
                                            library.get((p, tt))))
        if line is not None:
            print(line)
        plans[(pattern, t, backend)] = None
    del x, plans
    torch.cuda.empty_cache()
    return counts, entries


def ws_entry(mods, name, x, w, t, backend, plan, ms, counts, library) -> dict:
    """The JSON entry of a WS_REPORT cell from its timed run in
    ``ws_path``: the plan's output held to its plain version (timed once,
    CUDA events), the bound, ``library_ms`` one F.conv of the composed
    kernel (composed on the card, TF32; ``library``: the time and the grid
    it ran on, shared by the cells of one (pattern, t), WS_LIBRARY_GRID))."""
    _, sm, sd, weights, ss = mods
    y = plan(x)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wk, tk = (weights.fuse_weights(w, t), 1) if backend == "fused_matmul" else (w, t)
    a.record()
    if backend == "fused_direct":
        ref = sd.stencil_direct_plain(x, w, t)
    elif backend == "fused_sparse_matmul":
        ref = ss.stencil_sparse_matmul_plain(x, w, t)
    else:
        ref = sm.stencil_matmul_plain(x, wk, tk)
    b.record()
    b.synchronize()
    err = max_err(y, ref)
    del y, ref
    mx = float(x.abs().max())
    tol = (1e-5 * t * mx if backend == "fused_direct"
           else t * 2**-10 * float(np.abs(w).sum()) * mx)
    check(err <= tol, f"workspace report {name}: max|err| vs plain {err:.3e} > {tol:.3e}")
    bound, by = ws_bound_ms(x, w, t, backend)
    kname = name.split(" (")[0]
    entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCES[kname][0],
             "replaces": KERNEL_SOURCES[kname][1],
             "launches": counts[f"{kname} (workspace)"], "max_abs_err": err, "ms": ms,
             "plain_ms": a.elapsed_time(b), "bound_ms": bound, "bound_by": by,
             "library_ms": library[0],
             "workspace_mib": plan.fn.workspace.total_bytes / 2**20,
             "grid": "x".join(map(str, x.shape))}
    if library[1] != tuple(x.shape):
        entry["library_grid"] = "x".join(map(str, library[1]))
    print(f"  kernel {name}: plain {entry['plain_ms']:.3f} ms, library {library[0]:.3f} ms "
          f"on {'x'.join(map(str, library[1]))}, "
          f"launches {entry['launches']}, max|err| vs plain {err:.3e}, workspace "
          f"{entry['workspace_mib']:.1f} MiB")
    return entry


def wide_workspace_checks(mods, card) -> None:
    """The fourth rung's checks that time nothing, which ``main`` runs
    while the counting child builds: the kernel checks and the forced
    launches (``ws_kernels``), then the cells WS_CELLS on 128^3."""
    t0 = time.perf_counter()
    ws_kernels(mods)
    print(f"wide: workspace kernel checks in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    cells = {}
    for p, t, b in WS_CELLS:
        cells.setdefault((p, t), []).append(b)
    ws_path(mods, WS_CELLS_SHAPE, tuple((p, t, tuple(b)) for (p, t), b in cells.items()),
            card, timed=False)
    print(f"wide: {len(WS_CELLS)} more workspace cells on {WS_CELLS_SHAPE} in "
          f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()


def wide_workspace(mods, card) -> list:
    """Phase wide's fourth rung (its untimed checks run earlier,
    ``wide_workspace_checks``): the full-width cells (WS_PATHS on 512^3,
    timed), the 2D cells (WS_2D_PATHS on 1024^2, timed), with the JSON
    entries of the WS_REPORT cells (``ws_entry``).  Each launch allocates
    its workspace: no plan holds device memory."""
    torch.cuda.empty_cache()
    t0 = t1 = time.perf_counter()
    report = []
    for shape, cells, label in ((WS_SHAPE, WS_PATHS, "3D"), (WS_2D_SHAPE, WS_2D_PATHS, "2D")):
        report += ws_path(mods, shape, cells, card, timed=True,
                          report=[(n, p, t, b) for n, lb, p, t, b in WS_REPORT
                                  if lb == label])[1]
    print(f"wide: workspace paths on {WS_SHAPE} and {WS_2D_SHAPE} in "
          f"{time.perf_counter() - t1:.1f} s")
    print(f"wide: fourth rung's timed paths in {time.perf_counter() - t0:.1f} s")
    return report


def phase_wide(mods, card) -> list:
    """Phase ``wide``: the kernel checks (``wide_kernels``), the main
    paths (``wide_path``), Figure 16's Box-2D7R row on both paths, the
    foils at r = 5 and 7 and 128 deep on small grids (``wide_foils``) and
    on the main paths' grids (``wide_foils_full``), the guarded plans
    landing on a foil rung (``wide_guarded``), and the phase's JSON
    entries (``wide_foils``, ``wide_report``)."""
    from repro_torch.benchmarks import fig16
    t0 = time.perf_counter()
    wide_kernels(mods)
    print(f"wide: kernel checks in {time.perf_counter() - t0:.1f} s")
    counts = {}
    for label, shape, pattern, ts in WIDE_PATHS:
        t1 = time.perf_counter()
        c, _ = wide_path(mods, label, shape, pattern, ts, card)
        counts.setdefault(label, {k: 0 for k in c})
        for k, v in c.items():
            counts[label][k] += v
        torch.cuda.empty_cache()
        print(f"wide: path {label} {pattern} in {time.perf_counter() - t1:.1f} s")
    head, row = fig16.run("cuda", patterns=["Box-2D7R"])
    check("refused" not in row, f"wide: fig16 Box-2D7R: {row}")
    print(f"wide: {head}\nwide: {row}")
    t1 = time.perf_counter()
    report = wide_foils(mods, card)
    wide_foils_full(mods, report, card)
    wide_guarded(mods)
    print(f"wide: foils and the guarded plan in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    report += wide_report(mods, counts, card)
    print(f"wide: report in {time.perf_counter() - t1:.1f} s")
    report += wide_workspace(mods, card)
    print(f"wide: phase in {time.perf_counter() - t0:.1f} s")
    return report


#: The distributed phase: a gloo world of DIST_RANKS ranks, every shard on
#: the card (one card: the ranks time-slice it; the halos pass through
#: pinned host memory).  Rows: (label, grid, stencil, mesh shape, mesh dim
#: names, shard_spec, modes, local backends (None = auto), boundary).
DIST_RANKS = 4
DIST_CASES = (
    ("2D 2x2", (8192, 8192), ("box", 1), (2, 2), ("x", "y"), ("x", "y"),
     ("stepwise", "fused"), ("fused_direct", "fused_matmul_reuse", None), None),
    ("2D 4x1", (8192, 8192), ("box", 1), (4, 1), ("x", "y"), ("x", None),
     ("stepwise", "fused", "overlap"), ("fused_direct", "fused_matmul_reuse", None),
     None),
    ("2D 4x1", (8192, 8192), ("box", 1), (4, 1), ("x", "y"), ("x", None),
     ("stepwise", "overlap"), ("fused_direct",), ("reflect", "periodic")),
    ("3D 4 along z", (512, 512, 512), ("box", 1), (4,), ("z",),
     ("z", None, None), ("fused",), (None, "fused_matmul_reuse"), None),
)
#: Timed calls per case (the wall time across a barrier of every rank).
DIST_REPS = 5


def _dist_wall_ms(fn, reps: int = DIST_REPS) -> float:
    """Median wall milliseconds of ``fn()`` on every rank at once: a
    barrier, the call, the card drained, a barrier."""
    import torch.distributed as dist
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _distributed_rank(mesh, rank, cases):
    """One rank of the distributed phase: every case's plans on this rank's
    shard; returns its checks' lines (rank 0: with the comparison against
    the undistributed plan and the times)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels
    from repro_torch.kernels import guarded_stencil_plan, stencil_plan
    from repro_torch.stencil import StencilSpec, make_weights
    from repro_torch.stencil.distributed import gather_shards, shard_of
    from repro_torch.testing import faults

    meshes, lines = {}, []
    for label, shape, (kind, r), mshape, names, spec, modes, backends, bc in cases:
        key = (mshape, names)
        if key not in meshes:               # every rank builds them in order
            meshes[key] = init_device_mesh("cpu", mshape, mesh_dim_names=names)
        m = meshes[key]
        dim = len(shape)
        w = make_weights(StencilSpec(kind, dim, r), seed=0)
        x = grid(shape, torch.float32, seed=0)
        xl = shard_of(x, m, spec)
        mx, sw = float(x.abs().max()), float(np.abs(w).sum())
        stepwise_out = {}
        for backend in backends:
            for mode in modes:
                plan = stencil_plan(w, shape, torch.float32, MAIN_T, mesh=m,
                                    shard_spec=spec, dist_mode=mode,
                                    backend=backend, boundary=bc)
                hp = plan.halo_plan
                tag = (f"{label} {kind} {mode} {backend or 'auto'}->{plan.backend}"
                       + ("" if bc is None else f" boundary={boundary_label(bc)}"))
                plan(xl)                          # warm-up: builds the local plans
                torch.cuda.synchronize()
                dist.barrier()
                kernels.reset_launch_counts()
                plan.fn.reset_stats()
                y = plan(xl)
                torch.cuda.synchronize()
                counts = {k: v for k, v in kernels.launch_counts().items() if v}
                st = plan.fn.stats
                local_t = MAIN_T if mode == "fused" else 1
                kname, n = expected_launches(plan.backend, local_t, dim)
                n *= 1 if mode == "fused" else MAIN_T * (3 if mode == "overlap" else 1)
                check(counts == {kname: n}, f"distributed {tag} rank {rank}: launches "
                                            f"{counts}, expected {n} of {kname}")
                check(st["rounds"] == hp["exchanges_per_call"]
                      == (1 if mode == "fused" else MAIN_T),
                      f"distributed {tag} rank {rank}: {st['rounds']} exchange rounds, "
                      f"halo plan {hp['exchanges_per_call']}")
                check(st["halo_bytes"] == hp["halo_bytes_per_call"],
                      f"distributed {tag} rank {rank}: halo bytes {st['halo_bytes']} "
                      f"against the plan's {hp['halo_bytes_per_call']}")
                check(tuple(y.shape) == tuple(xl.shape) and bool(torch.isfinite(y).all()),
                      f"distributed {tag} rank {rank}: shape or non-finite")
                full = gather_shards(y, m, spec, shape)
                ms = _dist_wall_ms(lambda: plan(xl))
                if rank == 0:
                    ref_plan = stencil_plan(w, shape, torch.float32, MAIN_T,
                                            backend=plan.backend, boundary=bc)
                    ref = ref_plan(x)
                    full = full.to(x.device)
                    err = max_err(full, ref)
                    tol = (1e-5 * MAIN_T * mx if kname.startswith("stencil_direct")
                           else MAIN_T * 2**-10 * sw * mx)
                    check(err <= tol, f"distributed {tag}: max|diff| vs the undistributed "
                                      f"plan {err:.3e} > tol {tol:.3e}")
                    ms_u = cuda_ms(lambda: ref_plan(x), reps=5 if dim == 3 else 15)
                    extra = ""
                    if mode == "stepwise":
                        stepwise_out[backend] = full
                    elif mode == "overlap":
                        diff = max_err(full, stepwise_out[backend])
                        if kname.startswith("stencil_direct"):
                            check(diff == 0, f"distributed {tag}: overlap differs from "
                                             f"stepwise by {diff:.3e}")
                        extra = f"; max|overlap - stepwise| {diff:.3e}"
                    lines.append(
                        f"distributed {tag} {shape}: {ms:.4f} ms per call (wall across a "
                        f"barrier of {DIST_RANKS} ranks, median of {DIST_REPS}); "
                        f"undistributed plan {ms_u:.4f} ms; halo {hp['halo_bytes_per_call']} "
                        f"B per shard per call, {st['rounds']} exchange rounds, "
                        f"{st['p2p_ops']} P2P ops; launches per shard {counts}; "
                        f"max|diff| vs undistributed {err:.3e} (tol {tol:.3e}){extra}")
                    del ref, full
                dist.barrier()
        del x, xl, stepwise_out
        torch.cuda.empty_cache()
    # The guard on a distributed plan: REPRO_FAULTS=halo fails the first
    # exchange on every rank; every rank lands on the same rung.
    label, shape, (kind, r), mshape, names, spec = cases[1][:6]
    m = meshes[(mshape, names)]
    w = make_weights(StencilSpec(kind, len(shape), r), seed=0)
    xl = shard_of(grid(shape, torch.float32, seed=0), m, spec)
    os.environ["REPRO_FAULTS"] = "halo"
    faults.reset_faults()
    try:
        g = guarded_stencil_plan(w, shape, torch.float32, MAIN_T, mesh=m,
                                 shard_spec=spec, dist_mode="fused",
                                 backend="fused_direct")
        g(xl)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("REPRO_FAULTS", None)
        faults.reset_faults()
    check([h["cause"] for h in g.history] == ["halo"] and g.rung == "fused_direct+degraded",
          f"distributed guard rank {rank}: {g.rung}, history {g.history}")
    rungs = [None] * dist.get_world_size()
    dist.all_gather_object(rungs, g.rung)
    check(len(set(rungs)) == 1, f"distributed guard: ranks landed on {rungs}")
    if rank == 0:
        lines.append(f"distributed guard {label} {shape}: REPRO_FAULTS=halo fails the "
                     f"first exchange on every rank; all {len(rungs)} ranks land on "
                     f"{rungs[0]} (cause halo); transport: {g.plan.halo_plan['transport']}")
    return lines


def phase_distributed() -> None:
    """The distributed stepper (``stencil_plan(mesh=, shard_spec=,
    dist_mode=)``) on a gloo world of DIST_RANKS ranks (child processes,
    so a process-group fault cannot reach the main process's context),
    each with its shard on the card: every DIST_CASES plan's launches per
    shard equal to ``expected_launches`` (fused: one local plan call of
    depth t; stepwise: t calls of depth 1; overlap: 3 t calls, interior
    and two edge strips), its exchange rounds and halo bytes equal to its
    halo plan, the gathered grid within the phase-3 tolerance of the
    undistributed plan of the same backend, overlap equal to stepwise bit
    for bit on the tap-sum backends (the largest difference printed on the
    banded ones); then REPRO_FAULTS=halo landing every rank on the same
    rung."""
    from repro_torch.launch.world import run_world
    print(f"distributed: {DIST_RANKS} gloo ranks time-slice this one card and their "
          "halos pass through pinned host memory: these numbers measure transport "
          "and interleaving, not scaling")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = run_world(_distributed_rank, DIST_RANKS, args=(DIST_CASES,),
                      mesh_shape=(DIST_RANKS,), mesh_dim_names=("world",),
                      device="cuda", timeout_s=600)[0]
    for line in lines:
        print(line)
    print(f"distributed: phase in {time.perf_counter() - t0:.1f} s, the world's "
          "start included")


#: The LLM phase (``phase_llm``).  Every arch of the port's registry at its
#: full width (random weights from seed 0, stored in bf16 once), batch 4:
#: LLM_LONG at JAX's serve defaults (prompt 16, gen 32), the others on a
#: prompt of 8 and 4 generated tokens; LLM_DEPTH cuts n_layers where the
#: full depth does not fit one card.
LLM_BATCH = 4
LLM_LONG = ("llama3.2-1b", "rwkv6-1.6b")
LLM_LONG_RUN = (16, 32)
LLM_SHORT_RUN = (8, 4)
LLM_DEPTH = {"qwen3-moe-235b-a22b": 2}
#: Families whose cached decode is held to the uncached forward pass
#: (``launch.serve.consistency``); MoE is not: its capacity depends on S.
LLM_CONSISTENT = ("dense", "vlm", "hybrid", "rwkv")
#: Depth of the well-conditioned consistency check at full width: with the
#: models' random init (q, k scaled by the heads' fan-in) attention is
#: saturated and f32 rounding grows with depth (the phase prints the sweep over
#: LLM_SWEEP_DEPTHS), so only one layer can be held to 1e-4.
LLM_CHECK_DEPTH = 1
#: The SMOKE runs, card against CPU: B x S tokens, decode steps.
LLM_SMOKE = (2, 8, 4)
LLM_F32_TOL = 1e-4
LLM_BF16_UNIT = 2.0 ** -8


def decode_weight_bytes(cfg, params, batch: int) -> tuple:
    """Bytes of the weights one decode step reads, as stored, and the same
    with each MoE layer's experts cut to the ones a step can route to
    (min(E, batch * top_k)): every leaf but the token embedding (of which
    ``batch`` rows), whisper's encoder and the VLM projector, which decode
    does not run."""
    from repro_torch.models import base
    total = active = 0
    for name, leaf in base.named_leaves(params):
        if name.startswith(("encoder.", "enc_ln_post", "img_proj")):
            continue
        nbytes = leaf.numel() * leaf.element_size()
        if name == "tok_embed":
            nbytes = batch * leaf.shape[1] * leaf.element_size()
        total += nbytes
        if cfg.moe is not None and ".moe.w" in name:
            E = cfg.moe.num_experts
            nbytes = nbytes * min(E, batch * cfg.moe.top_k) // E
        active += nbytes
    return total, active


def _gib(nbytes: float) -> float:
    return nbytes / 2**30


def _smoke_pass(model, params, inputs, device):
    """loss_fn and LLM_SMOKE[2] teacher-forced decode steps' logits of the
    port on ``device`` (numpy, float64)."""
    B, S, steps = LLM_SMOKE
    batch = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    with torch.no_grad():
        loss, _ = model.loss_fn(params, batch)
        caches = model.init_caches(B, S + steps, device)
        out = [loss.double().cpu().numpy()]
        for t in range(steps):
            logits, caches = model.decode_logits(params, caches, batch["tokens"][:, t:t + 1], t)
            out.append(logits.double().cpu().numpy())
    return out


def llm_smoke_card_vs_cpu(arch: str, device) -> str:
    """A SMOKE arch on the card against the port on the CPU, from the same
    parameters (float32, from a CPU generator seeded 0) and inputs: loss_fn
    and LLM_SMOKE[2] decode steps' logits.  float32 (TF32 off): within
    LLM_F32_TOL * max(1, max|cpu|); bf16: within twice bf16's own error on
    the CPU (max|cpu bf16 - cpu f32|: both sides round at bf16), at least
    LLM_BF16_UNIT * max(1, max|cpu|); greedy tokens equal where the CPU's
    top-2 margin exceeds the bound."""
    import dataclasses
    from repro_torch.configs import SMOKE
    from repro_torch.models import base
    from repro_torch.models.api import get_model
    B, S, _ = LLM_SMOKE
    cfg = SMOKE[arch]
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)}
    if cfg.family == "whisper":
        inputs["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        inputs["img_embeds"] = rng.normal(size=(B, cfg.n_img_patches, cfg.d_model)).astype(np.float32)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    on_card = base.tree_map(lambda a: a.to(device), params)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model = get_model(dataclasses.replace(cfg, dtype=dtype))
        runs[dtype] = (_smoke_pass(model, params, inputs, "cpu"),
                       _smoke_pass(model, on_card, inputs, device))
    worst = []
    for dtype, (cpu, card) in runs.items():
        cpu32 = runs["float32"][0]
        for i, (a, b) in enumerate(zip(card, cpu)):
            scale = max(1.0, float(np.max(np.abs(b))))
            lim = LLM_F32_TOL * scale if dtype == "float32" else max(
                2.0 * float(np.max(np.abs(b - cpu32[i]))), LLM_BF16_UNIT * scale)
            err = float(np.max(np.abs(a - b)))
            what = "loss" if i == 0 else f"step {i - 1} logits"
            check(np.isfinite(a).all() and err <= lim,
                  f"llm smoke {arch} {dtype} {what}: card vs CPU max|diff| {err:.3e} > {lim:.3e}")
            if i:
                top2 = np.sort(b, axis=-1)[..., -2:]
                sure = (top2[..., 1] - top2[..., 0]) > lim
                check(np.array_equal(a.argmax(-1)[sure], b.argmax(-1)[sure]),
                      f"llm smoke {arch} {dtype} step {i - 1}: tokens differ")
            worst.append((err / lim, dtype, what, err, lim))
    r, dtype, what, err, lim = max(worst)
    return f"{arch} worst {dtype} {what} {err:.3e} / {lim:.3e}"


#: Depths of the float32 cached-vs-uncached sweep (printed, not gated) at
#: full width on the first LLM_LONG arch.
LLM_SWEEP_DEPTHS = (1, 2, 4, 8)
LLM_PROFILE_STEPS = 5


def llm_profile(model, params, device):
    """Where a decode step's time goes: ``torch.profiler`` over
    LLM_PROFILE_STEPS steps after 3 warm-ups (B = LLM_BATCH, caches of 64):
    device kernel ms per step, kernel launches per step and the four aten
    ops with the most device time (the profiler's own start-up lands in
    the host's time, so the step time is ``serve_llm``'s); returns the
    device ms per step and the line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    caches = model.init_caches(LLM_BATCH, 64, device)
    tok = torch.zeros((LLM_BATCH, 1), dtype=torch.int32, device=device)
    with torch.no_grad():
        for i in range(3):
            _, caches = model.decode_logits(params, caches, tok, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(3, 3 + LLM_PROFILE_STEPS):
                _, caches = model.decode_logits(params, caches, tok, i)
            torch.cuda.synchronize()
    rows = prof.key_averages()
    n = LLM_PROFILE_STEPS
    device_us = sum(r.self_device_time_total for r in rows if r.device_type == DeviceType.CUDA)
    launches = sum(r.count for r in rows
                   if r.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    ops = sorted((r for r in rows if r.key.startswith("aten::") and r.self_device_time_total),
                 key=lambda r: -r.self_device_time_total)[:4]
    top = ", ".join(f"{r.key} {r.self_device_time_total / n / 1e3:.3f} ms ({r.count // n})"
                    for r in ops)
    return device_us / n / 1e3, (
        f"device kernels {device_us / n / 1e3:.3f} ms per step, {launches / n:.0f} "
        f"launches per step; most device time: {top}")


def llm_consistency(arch, cfg, params, r, gated: bool) -> str:
    """``launch.serve.consistency`` of a ``serve_llm`` run kept with its
    logits, as one printed line; a gated check that fails fails the run.
    Under ``wkv_factored`` the uncached scan runs 16-position chunks, so the
    stream is cut to a multiple of 16 (JAX's reshape needs that too)."""
    from repro_torch.launch.serve import consistency
    n = r["logits"].shape[1]
    length = n - n % 16 if getattr(cfg, "wkv_factored", False) and n > 16 else None
    c = consistency(cfg, params, r["prompts"], r["tokens"], r["logits"], length)
    if gated:
        check(c["ok"], f"llm {arch} {cfg.dtype} at {cfg.n_layers} layers: the cached "
                       f"decode disagrees with the uncached forward: {c}")
    return (f"cached vs uncached logits max|diff| {c['max_abs_err']:.4e} (tol "
            f"{c['tol']:.4e}; the uncached pass's own error against f32 "
            f"{c['bf16_err']:.4e}, max|logit| {c['ref_max']:.3f}); greedy tokens "
            f"compared at {c['positions'] - c['under_margin']} of {c['positions']} "
            f"positions{'' if c['ok'] else ' -- OUTSIDE the tolerance'}")


def phase_llm(device="cuda") -> None:
    """Phase ``llm``: the LLM serving path (``repro_torch.launch.serve.
    serve_llm``) at full width on the card, arch by arch, each freed before
    the next: finite logits and tokens in the vocabulary; prefill and
    decode tok/s, ms per decode step beside the weight-byte bound (bytes of
    the stored weights one step reads over 3.35 TB/s); on LLM_CONSISTENT
    families the cached decode against the uncached forward pass
    (``consistency``): at full depth as served (gated), for LLM_LONG also in
    float32 (printed: random weights amplify rounding with depth) with a
    profile of its decode step (``llm_profile``), on the first of them the
    float32 check at LLM_SWEEP_DEPTHS layers (printed), and at full width
    and LLM_CHECK_DEPTH layers in float32 and the served dtype (gated);
    then every SMOKE arch on the card against the port on the CPU
    (``llm_smoke_card_vs_cpu``)."""
    import dataclasses
    from repro_torch.configs import ARCHS, SMOKE
    from repro_torch.launch.serve import serve_llm
    from repro_torch.models import base
    from repro_torch.models.api import get_model
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    order = list(LLM_LONG) + [a for a in ARCHS if a not in LLM_LONG]
    for arch in order:
        cfg = ARCHS[arch]
        full_params = get_model(cfg).param_count()
        if arch in LLM_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=LLM_DEPTH[arch])
            print(f"llm: {arch}: full width, n_layers cut {ARCHS[arch].n_layers} -> "
                  f"{cfg.n_layers}: the full depth holds {full_params / 1e9:.1f} B "
                  f"parameters, {_gib(4 * full_params):.1f} GiB in f32, past one card")
        model = get_model(cfg)
        P, G = LLM_LONG_RUN if arch in LLM_LONG else LLM_SHORT_RUN
        params = base.serving_params(
            model.init_params(torch.Generator(device).manual_seed(0)), cfg)
        r = serve_llm(cfg, LLM_BATCH, P, G, device=device, params=params, keep_logits=True)
        logits = r["logits"]
        check(bool(torch.isfinite(logits).all()), f"llm {arch}: non-finite logits")
        check(((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab)).all(),
              f"llm {arch}: tokens outside the vocabulary")
        total, active = decode_weight_bytes(cfg, params, LLM_BATCH)
        step_ms = 1e3 * r["decode_s"] / (G - 1)
        bound_ms = 1e3 * total / HBM_BPS
        moe = (f", routed experts only {1e3 * active / HBM_BPS:.4f} ms"
               if cfg.moe is not None else "")
        print(f"llm: {arch}: {model.param_count() / 1e9:.3f} B params, "
              f"{_gib(sum(v.numel() * v.element_size() for _, v in base.named_leaves(params))):.2f} GiB "
              f"stored; B={LLM_BATCH} prompt={P} gen={G}: prefill {r['prefill_tok_s']:.1f} tok/s, "
              f"decode {r['decode_tok_s']:.1f} tok/s, {step_ms:.3f} ms per decode step; "
              f"bound {bound_ms:.4f} ms ({_gib(total):.2f} GiB of weights per step at 3.35 TB/s)"
              f"{moe}; step / bound {step_ms / bound_ms:.1f}")
        if cfg.family in LLM_CONSISTENT:
            line = llm_consistency(arch, cfg, params, r, gated=True)
            print(f"llm: {arch} full depth, {cfg.dtype} as served: {line}")
            if arch in LLM_LONG:
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                r32 = serve_llm(cfg32, LLM_BATCH, P, G, device=device, params=params,
                                keep_logits=True)
                line = llm_consistency(arch, cfg32, params, r32, gated=False)
                print(f"llm: {arch} full depth, float32 (not gated: random weights "
                      f"amplify rounding with depth): {line}")
                del r32
                if device != "cpu":
                    dev_ms, line = llm_profile(model, params, device)
                    print(f"llm: {arch} profile: {line}; against the {step_ms:.3f} ms "
                          f"step the device idles {1 - dev_ms / step_ms:.1%}")
            if arch == LLM_LONG[0]:
                for depth in LLM_SWEEP_DEPTHS:
                    cfg_d = dataclasses.replace(cfg, n_layers=depth, dtype="float32")
                    p_d = get_model(cfg_d).init_params(torch.Generator(device).manual_seed(0))
                    r_d = serve_llm(cfg_d, LLM_BATCH, P, G, device=device, params=p_d,
                                    keep_logits=True)
                    print(f"llm: {arch} full width, {depth} layers, float32 (sweep, not "
                          f"gated): {llm_consistency(arch, cfg_d, p_d, r_d, gated=False)}")
                    del p_d, r_d
            for dtype in ("float32", cfg.dtype):
                cfg1 = dataclasses.replace(cfg, n_layers=LLM_CHECK_DEPTH, dtype=dtype)
                p1 = base.serving_params(get_model(cfg1).init_params(
                    torch.Generator(device).manual_seed(0)), cfg1)
                r1 = serve_llm(cfg1, LLM_BATCH, P, G, device=device, params=p1,
                               keep_logits=True)
                line = llm_consistency(arch, cfg1, p1, r1, gated=True)
                print(f"llm: {arch} full width, {LLM_CHECK_DEPTH} layer, {dtype}: {line}")
                del p1, r1
        elif cfg.family == "moe":
            print(f"llm: {arch}: cached vs uncached not compared: the MoE capacity "
                  "int(1.25 * S * K / E) depends on S, so a one-token decode and a "
                  "full forward may drop different tokens")
        else:
            print(f"llm: {arch}: cached vs uncached not compared: whisper's decode "
                  "attends to its encoder caches (zeros in the serve loop, as in JAX)")
        del params, r, logits
        torch.cuda.empty_cache()
    for arch in SMOKE:
        print(f"llm: SMOKE card vs CPU: {llm_smoke_card_vs_cpu(arch, device)}")
    print(f"llm: phase in {time.perf_counter() - t0:.1f} s")


#: The training phase (``phase_train``).  llama3.2-1b as registered at
#: TRAIN_MAIN (B, S, steps); every other arch at TRAIN_OTHER (B, S, steps)
#: with n_layers cut where 16 bytes per parameter (f32 weights, grads and
#: two moments) pass TRAIN_BUDGET_GIB; the example's preset and steps; the
#: crash/resume run (preset, straight steps, checkpoint step).
TRAIN_MAIN = (4, 1024, 4)
TRAIN_OTHER = (2, 256, 2)
TRAIN_BUDGET_GIB = 56.0
TRAIN_EXAMPLE = ("30m", 40)
TRAIN_RESUME = ("30m", 20, 10)
#: Dense bf16 tensor-core peak of the H100 SXM (data sheet), FLOP/s.
BF16_PEAK = 989e12


def model_flops(cfg, tokens: int) -> float:
    """JAX's MODEL_FLOPS of a train step (``repro.core.hlo_roofline.
    model_flops_for``): 6 * N * tokens, N counting each MoE layer's experts
    at top_k / E."""
    from repro_torch.models.api import get_model
    n = get_model(cfg).param_count()
    if cfg.moe is not None:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        expert = 3 * cfg.d_model * cfg.d_ff * e * cfg.n_layers
        n = n - expert + expert * (k / e)
    return 6.0 * n * tokens


def train_depth(cfg) -> int:
    """The most layers (at most the registered depth, at least 1) whose
    16 bytes per parameter fit TRAIN_BUDGET_GIB."""
    import dataclasses
    from repro_torch.models.api import get_model
    count = lambda n: get_model(dataclasses.replace(cfg, n_layers=n)).param_count()
    per = count(2) - count(1)
    fixed = count(1) - per
    fit = int((TRAIN_BUDGET_GIB * 2**30 / 16 - fixed) // per)
    return max(1, min(cfg.n_layers, fit))


def _train_batch(data, step, device):
    return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}


def _peak_step(step_fn, params, state, batch):
    """One train step from a reset peak: (params, state, metrics, ms on the
    host clock around it, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, m = step_fn(params, state, batch)
    loss = float(m["loss"])
    ms = 1e3 * (time.perf_counter() - t0)
    check(np.isfinite(loss) and bool(torch.isfinite(m["grad_norm"])),
          f"train: non-finite loss {loss} or grad_norm")
    return params, state, m, ms, _gib(torch.cuda.max_memory_allocated())


def train_profile(step_fn, params, state, batch):
    """``torch.profiler`` over one train step (after the loop's warm
    steps): device kernel ms, kernel launches and the four aten ops with the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, m = step_fn(params, state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device_us = sum(r.self_device_time_total for r in rows if r.device_type == DeviceType.CUDA)
    launches = sum(r.count for r in rows
                   if r.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    ops = sorted((r for r in rows if r.key.startswith("aten::") and r.self_device_time_total),
                 key=lambda r: -r.self_device_time_total)[:4]
    top = ", ".join(f"{r.key} {r.self_device_time_total / 1e3:.3f} ms ({r.count})" for r in ops)
    return params, state, device_us / 1e3, (
        f"device kernels {device_us / 1e3:.3f} ms, {launches} launches; most device "
        f"time: {top}")


def train_arch(cfg, B: int, S: int, steps: int, device, profile_step: bool = False) -> dict:
    """``train.loop.train`` of ``cfg`` for ``steps`` steps at B x S, then
    one step with remat on (grad_norm, peak) and one with remat off (peak;
    an out-of-memory is reported, not raised); ms per step is the median of
    the loop's steps after the first."""
    import dataclasses
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import data_config
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.steps import make_train_step
    model = get_model(cfg)
    data = SyntheticLM(data_config(cfg, S, B))
    opt = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    torch.cuda.reset_peak_memory_stats()
    params, state, hist = train(model, data, opt, LoopConfig(steps=steps, ckpt_dir=None,
                                                             log_every=10**9), device=device)
    losses = [r["loss"] for r in hist]
    check(all(np.isfinite(losses)), f"train {cfg.name}: non-finite losses {losses}")
    out = {"losses": losses, "loop_peak": _gib(torch.cuda.max_memory_allocated()),
           "ms": statistics.median(1e3 * r["dt"] for r in hist[1:])}
    batch = _train_batch(data, steps, device)
    params, state, m, out["remat_ms"], out["remat_peak"] = _peak_step(
        make_train_step(model, opt), params, state, batch)
    out["grad_norm"] = float(m["grad_norm"])
    if profile_step:
        params, state, out["device_ms"], out["profile"] = train_profile(
            make_train_step(model, opt), params, state, batch)
    try:
        step_off = make_train_step(get_model(dataclasses.replace(cfg, remat=False)), opt)
        params, state, _, out["plain_ms"], out["plain_peak"] = _peak_step(
            step_off, params, state, batch)
    except torch.cuda.OutOfMemoryError:
        out["plain_ms"] = out["plain_peak"] = None
    del params, state, batch, m
    torch.cuda.empty_cache()
    out["flops_share"] = model_flops(cfg, B * S) / (out["ms"] / 1e3) / BF16_PEAK
    return out


def train_line(arch, cfg, B, S, r) -> str:
    plain = ("out of memory" if r["plain_peak"] is None else
             f"{r['plain_ms']:.1f} ms, peak {r['plain_peak']:.2f} GiB")
    return (f"train: {arch} ({cfg.n_layers} layers): B={B} S={S}: losses "
            f"{', '.join(f'{x:.4f}' for x in r['losses'])}; {r['ms']:.1f} ms per step, "
            f"{B * S / (r['ms'] / 1e3):,.0f} tok/s, MODEL_FLOPS share {r['flops_share']:.1%} "
            f"of {BF16_PEAK / 1e12:.0f} TFLOP/s; loop peak {r['loop_peak']:.2f} GiB; one step "
            f"remat on {r['remat_ms']:.1f} ms, peak {r['remat_peak']:.2f} GiB, grad_norm "
            f"{r['grad_norm']:.4f}; remat off {plain}")


def train_smoke_card_vs_cpu(arch: str, device) -> str:
    """One train step of a SMOKE arch on the card against the port on the
    CPU from the same parameters (float32, a CPU generator seeded 0) and
    inputs, at lr 1e-3 (warm-up 1: the first step runs at lr): the loss and
    every gradient within the CPU tests' bounds (float32 with TF32 off:
    LLM_F32_TOL * max(1, max|cpu|); bf16: twice bf16's own error on the CPU,
    at least LLM_BF16_UNIT * max(1, max|cpu|)), and the updated parameters
    within LLM_F32_TOL * max(1, max|p|) wherever the CPU's gradient exceeds
    its bound (elsewhere Adam's first step, ~lr * sign(g), may flip: 2 * lr
    more)."""
    import dataclasses
    from repro_torch.configs import SMOKE
    from repro_torch.models import base
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import value_and_grad
    B, S, _ = LLM_SMOKE
    cfg = SMOKE[arch]
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)}
    if cfg.family == "whisper":
        inputs["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        inputs["img_embeds"] = rng.normal(size=(B, cfg.n_img_patches, cfg.d_model)).astype(np.float32)
    params0 = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model = get_model(dataclasses.replace(cfg, dtype=dtype))
        for where in ("cpu", device):
            p = base.tree_map(lambda a: a.clone().to(where), params0)
            batch = {k: torch.from_numpy(v).to(where) for k, v in inputs.items()}
            (loss, _), grads = value_and_grad(model, p, batch)
            p, _, _ = adamw.apply(opt, grads, adamw.init(p), p)
            flat = lambda t: {n: v.double().cpu().numpy() for n, v in base.named_leaves(t)}
            runs[dtype, where] = (float(loss), flat(grads), flat(p))
    worst = []
    for dtype in ("float32", "bfloat16"):
        (l0, g0, p0), (l1, g1, p1) = runs[dtype, "cpu"], runs[dtype, device]
        l32, g32 = runs["float32", "cpu"][:2]

        def lim(ref, ref32):
            scale = max(1.0, float(np.max(np.abs(ref))))
            if dtype == "float32":
                return LLM_F32_TOL * scale
            return max(2.0 * float(np.max(np.abs(ref - ref32))), LLM_BF16_UNIT * scale)
        err, tol = abs(l1 - l0), lim(np.asarray(l0), np.asarray(l32))
        check(np.isfinite(l1) and err <= tol,
              f"train smoke {arch} {dtype} loss: card vs CPU {err:.3e} > {tol:.3e}")
        worst.append((err / tol, dtype, "loss", err, tol))
        for name in g0:
            gl = lim(g0[name], g32[name])
            err = float(np.max(np.abs(g1[name] - g0[name])))
            check(np.isfinite(g1[name]).all() and err <= gl,
                  f"train smoke {arch} {dtype} grad {name}: card vs CPU {err:.3e} > {gl:.3e}")
            worst.append((err / gl, dtype, f"grad {name}", err, gl))
            pl = LLM_F32_TOL * max(1.0, float(np.max(np.abs(p0[name]))))
            allowed = pl + np.where(np.abs(g0[name]) > gl, 0.0, 2 * opt.lr)
            perr = np.abs(p1[name] - p0[name])
            check(np.isfinite(p1[name]).all() and bool((perr <= allowed).all()),
                  f"train smoke {arch} {dtype} updated {name}: card vs CPU "
                  f"{float(perr.max()):.3e} outside its bound")
            firm = np.abs(g0[name]) > gl
            if firm.any():
                e = float(perr[firm].max())
                worst.append((e / pl, dtype, f"updated {name}", e, pl))
    r, dtype, what, err, tol = max(worst)
    return f"{arch} worst {dtype} {what} {err:.3e} / {tol:.3e}"


def phase_train(device="cuda") -> None:
    """Phase ``train``: the LLM training path (``repro_torch.train``,
    ``optim``, ``data``, ``checkpoint``) on the card (see the module's
    docstring, item 9)."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ARCHS, SMOKE
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.examples import train_lm
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import LoopConfig, train
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # (a) the main path: llama3.2-1b as registered
    arch = "llama3.2-1b"
    cfg = ARCHS[arch]
    B, S, steps = TRAIN_MAIN
    r = train_arch(cfg, B, S, steps, device, profile_step=True)
    print(train_line(arch, cfg, B, S, r))
    bound_ms = 1e3 * model_flops(cfg, B * S) / BF16_PEAK
    print(f"train: {arch} profile of one step: {r['profile']}; against the "
          f"{r['remat_ms']:.1f} ms step the device idles {1 - r['device_ms'] / r['remat_ms']:.1%}; "
          f"bound {bound_ms:.1f} ms (6 N tokens at {BF16_PEAK / 1e12:.0f} TFLOP/s), "
          f"{1e3 * 7 * 4 * get_model(cfg).param_count() / HBM_BPS:.1f} ms of AdamW's f32 "
          f"state traffic at 3.35 TB/s")
    check(r["plain_peak"] is None or r["remat_peak"] < r["plain_peak"],
          f"train {arch}: remat's peak {r['remat_peak']:.2f} GiB is not below "
          f"{r['plain_peak']:.2f} GiB without it")
    # (b) every other arch at full width
    B, S, steps = TRAIN_OTHER
    for arch in (a for a in ARCHS if a != "llama3.2-1b"):
        cfg = ARCHS[arch]
        depth = train_depth(cfg)
        if depth < cfg.n_layers:
            full = get_model(cfg).param_count()
            print(f"train: {arch}: full width, n_layers cut {cfg.n_layers} -> {depth}: the "
                  f"full depth holds {full / 1e9:.3f} B parameters, {_gib(16 * full):.1f} GiB "
                  f"at 16 bytes each (f32 weights, grads, two moments), past "
                  f"{TRAIN_BUDGET_GIB:.0f} GiB")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        print(train_line(arch, cfg, B, S, train_arch(cfg, B, S, steps, device)))
    # (c) the example at preset 30m, with and without int8 gradients
    preset, n = TRAIN_EXAMPLE
    tmp = tempfile.mkdtemp(prefix="train_smoke_")
    try:
        for extra in ([], ["--grad-compression", "int8"]):
            hist = train_lm.main(["--preset", preset, "--steps", str(n), "--ckpt-every", "0",
                                  "--ckpt-dir", os.path.join(tmp, "ex"), "--device", device]
                                 + extra)
            first, last = hist[0]["loss"], hist[-1]["loss"]
            check(last < first, f"train_lm {preset} {extra}: loss {first} -> {last} did not fall")
            print(f"train: train_lm {preset} {' '.join(extra) or '(f32 grads)'}: loss "
                  f"{first:.4f} -> {last:.4f} over {n} steps, "
                  f"{statistics.median(1e3 * h['dt'] for h in hist[1:]):.1f} ms per step")
        # (d) crash and resume
        preset, total, at = TRAIN_RESUME
        cfg = train_lm.PRESETS[preset]
        model = get_model(cfg)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0))
        opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=total)
        _, _, straight = train(model, data, opt, LoopConfig(steps=total, ckpt_dir=None,
                                                            log_every=10**9), device=device)
        ck = os.path.join(tmp, "ck")
        train(model, data, opt, LoopConfig(steps=at, ckpt_every=at, ckpt_dir=ck,
                                           log_every=10**9), device=device)
        params, state, resumed = train(model, data, opt, LoopConfig(
            steps=total, ckpt_every=10**9, ckpt_dir=ck, log_every=10**9), device=device)
        check(resumed[0]["step"] == at + 1, f"train resume: restarted at {resumed[0]['step']}")
        a, b = straight[-1]["loss"], resumed[-1]["loss"]
        check(abs(a - b) <= 1e-4 * abs(a), f"train resume: {a} (straight) against {b}")
        t1 = time.perf_counter()
        path = CheckpointManager(os.path.join(tmp, "size")).save(
            total, {"params": params, "opt": state._asdict()})
        save_s = time.perf_counter() - t1
        print(f"train: crash/resume {preset}: {at} steps, checkpoint, resume to {total}: "
              f"final loss {b:.6f} against {a:.6f} straight (rel {abs(a - b) / abs(a):.2e}); "
              f"checkpoint {os.path.getsize(path) / 2**20:.1f} MiB "
              f"({model.param_count() / 1e6:.1f} M params + two moments), saved in "
              f"{save_s:.2f} s")
        del params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    # (e) every SMOKE arch, card against CPU
    for arch in SMOKE:
        print(f"train: SMOKE step card vs CPU: {train_smoke_card_vs_cpu(arch, device)}")
    print(f"train: phase in {time.perf_counter() - t0:.1f} s")


#: The mesh phase (``phase_mesh``).  (a) llama3.2-1b as registered, one
#: DTensor train step on a (1, 1) ("data", "model") mesh of a one-rank NCCL
#: world against the plain step, MESH_STEPS steps each from the same
#: parameters and batches at TRAIN_MAIN's B x S; (b) the GPipe pipeline of
#: its full-width blocks over MESH_PIPE_RANKS ranks that time-slice the
#: card, MESH_PIPE_MICRO microbatches of TRAIN_MAIN's B x S in bf16; (c) the
#: dry run of MESH_DRYRUN_CELLS on fake worlds of 256 and 512 ranks and of
#: JAX's three stencil cells, in MESH_DRYRUN_CHAINS child processes started
#: with the run (they need no card); (d) the dry-run estimator on (a)'s
#: step, on a fake world of one rank, in the last chain.
MESH_STEPS = 3
MESH_PIPE_RANKS = 2
MESH_PIPE_MICRO = 4
MESH_DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("llama3.2-1b", "decode_32k"),
                     ("olmoe-1b-7b", "train_4k"), ("rwkv6-1.6b", "train_4k"))
#: The chains of dry-run calls (``repro_torch.launch.dryrun.main`` argv),
#: one child process each; rwkv6's 24 layers of 256 WKV chunks trace longest.
MESH_DRYRUN_CHAINS = (
    (["--arch", "rwkv6-1.6b", "--cell", "train_4k", "--mesh", "single"],),
    (["--arch", "rwkv6-1.6b", "--cell", "train_4k", "--mesh", "multi"],),
    (["--arch", "llama3.2-1b", "--cell", "train_4k", "--mesh", "both"],
     ["--arch", "llama3.2-1b", "--cell", "decode_32k", "--mesh", "both"],
     ["--arch", "olmoe-1b-7b", "--cell", "train_4k", "--mesh", "both"],
     ["--stencil", "--mesh", "both"],
     "witness"),
)
DRYRUN_FLAG = "--dryrun"
#: How long phase ``mesh`` waits for the dry-run children (seconds).
MESH_DRYRUN_WAIT_S = 900


def dryrun_child(chain: int, witness_path: str) -> int:
    """One dry-run chain (a child of this script, the card hidden): each
    call with --force, so no record of another run is read; the witness
    writes its estimate to ``witness_path``."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    for call in MESH_DRYRUN_CHAINS[chain]:
        if call == "witness":
            B, S, _ = TRAIN_MAIN
            cfg = ARCHS["llama3.2-1b"]
            t0 = time.perf_counter()
            try:
                with dryrun.fake_world(1):
                    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
                    cost, memory = dryrun.trace_cell(cfg, ShapeCell("witness", S, B, "train"),
                                                     mesh)
                w = {"flops": cost.flops, "bytes_major": cost.bytes_major,
                     "collective_bytes": cost.collective_bytes, "memory": memory,
                     "trace_s": time.perf_counter() - t0}
            except Exception as e:  # noqa: BLE001 -- reported by phase_mesh
                import traceback
                w = {"error": f"{type(e).__name__}: {e}", "tb": traceback.format_exc()[-3000:]}
            with open(witness_path, "w") as f:
                json.dump(w, f)
        else:
            dryrun.main(call + ["--force"])
    return 0


def start_dryrun() -> list:
    """Start the dry-run chains; returns [(process, log path, witness path)]."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mesh_dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = []
    for i in range(len(MESH_DRYRUN_CHAINS)):
        log = os.path.join(tmp, f"chain{i}.log")
        wit = os.path.join(tmp, "witness.json")
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, os.path.abspath(__file__), DRYRUN_FLAG,
                                  str(i), wit], env=env, stdout=f,
                                 stderr=subprocess.STDOUT, cwd=REPO)
        out.append((p, log, wit))
    return out


def stop_dryrun(children) -> None:
    """Stop the chains still running and remove their logs."""
    for p, _, _ in children or ():
        if p.poll() is None:
            p.kill()
            p.wait()
    if children:
        shutil.rmtree(os.path.dirname(children[0][1]), ignore_errors=True)


def mesh_dtensor_step(device="cuda") -> dict:
    """(a): MESH_STEPS train steps of llama3.2-1b, plain and as DTensors on
    a (1, 1) mesh, from the same parameters and batches."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import data_config
    from repro_torch.models import base
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import make_train_step
    cfg = ARCHS["llama3.2-1b"]
    B, S, _ = TRAIN_MAIN
    model = get_model(cfg)
    data = SyntheticLM(data_config(cfg, S, B))
    step_fn = make_train_step(model, adamw.AdamWConfig(lr=1e-4, warmup_steps=2,
                                                       total_steps=100))
    p0 = base.tree_map(lambda t: t.cpu(),
                       model.init_params(torch.Generator(device).manual_seed(0)))
    batches = [_train_batch(data, i, device) for i in range(MESH_STEPS)]
    torch.cuda.empty_cache()

    def run(params, state, wrap=lambda b: b):
        losses, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, wrap(b))
            loss = m["loss"]
            losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return params, losses, ms

    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = base.tree_map(lambda t: t.to(device, copy=True), p0)
    params, plain_losses, plain_ms = run(params, adamw.init(params))
    out = {"plain_peak": torch.cuda.max_memory_allocated() - base_bytes,
           "plain_peak_raw": torch.cuda.max_memory_allocated(),
           "plain_losses": plain_losses, "plain_ms": plain_ms}
    plain = {n: t.cpu() for n, t in base.named_leaves(params)}
    del params
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mesh_nccl_")
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method="file://" + os.path.join(tmp, "store"),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        pl = sharding.param_shardings(model.param_defs(), mesh, cfg.fsdp)
        dparams = sharding.distribute(base.tree_map(lambda t: t.to(device, copy=True), p0),
                                      mesh, pl)
        bpl = base.tree_map(lambda s: sharding.placements(s, mesh),
                            sharding.batch_pspecs(batches[0], mesh))
        with sharding.use_mesh(mesh, cfg.fsdp):
            dparams, out["mesh_losses"], out["mesh_ms"] = run(
                dparams, adamw.init(dparams), lambda b: sharding.distribute(b, mesh, bpl))
        differ, worst, wname = 0, 0.0, ""
        for name, d in base.named_leaves(dparams):
            a, b = d.to_local(), plain[name].to(device)
            if not torch.equal(a, b):
                differ += 1
                e = float((a.float() - b.float()).abs().max())
                if e >= worst:
                    worst, wname = e, name
        out.update(mesh=str(mesh), leaves=len(plain), differ=differ, worst=worst,
                   worst_leaf=wname)
        del dparams
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def _mesh_pipe_rank(mesh, rank, micro, device):
    """(b), one rank: llama3.2-1b's full-width blocks (bf16) over the
    pipeline; rank 0 also runs the sequential stack on the same
    microbatches and compares."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import base, transformer
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import seq_positions
    from repro_torch.parallel.pipeline import bubble_fraction, make_pipelined_step
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = ARCHS["llama3.2-1b"]
    B, S, _ = TRAIN_MAIN
    gen = torch.Generator(device).manual_seed(0)
    blocks = base.serving_params(get_model(cfg).init_params(gen)["blocks"], cfg)
    torch.cuda.empty_cache()
    x = torch.randn((micro * B, S, cfg.d_model), generator=gen, device=device,
                    dtype=torch.bfloat16)
    pos = seq_positions(B, S, device)

    def layer_fn(lp, h):
        return transformer._block(cfg, h, lp, pos)[0]
    step = make_pipelined_step(layer_fn, cfg.n_layers, mesh, axis="pod", microbatches=micro)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        y = step(blocks, x)                               # warm
        torch.cuda.synchronize()
        step.reset_stats()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            y = step(blocks, x)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        out = {"stats": dict(step.stats), "ms": ms,
               "peak": _gib(torch.cuda.max_memory_allocated()),
               "bubble": bubble_fraction(mesh.size(0), micro)}
        if rank == 0:
            def sequential():
                outs = []
                for mb in x.split(B):
                    h = mb
                    for lp in base.layers_of(blocks):
                        h = layer_fn(lp, h)
                    outs.append(h)
                return torch.cat(outs)
            ref = sequential()
            torch.cuda.synchronize()
            seq_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                sequential()
                torch.cuda.synchronize()
                seq_ms.append(1e3 * (time.perf_counter() - t0))
            out.update(equal=bool(torch.equal(y, ref)), seq_ms=seq_ms,
                       max_diff=float((y.float() - ref.float()).abs().max()),
                       finite=bool(torch.isfinite(y).all()))
    return out


def _dryrun_line(r) -> str:
    if not r.get("ok"):
        return f"mesh: dry run {r['arch']} {r['cell']} {r['mesh']}: FAILED: {r.get('error')}"
    t = r["roofline"]
    uf = t.get("useful_fraction")
    peak = (r.get("memory") or {}).get("peak_bytes")
    return (f"mesh: dry run {r['arch']} {r['cell']} {r['mesh']} ({r.get('n_chips', '-')} ranks): "
            f"compute {1e3 * t['compute_s']:.3f} ms, memory {1e3 * t['memory_s']:.3f} ms, "
            f"collective {1e3 * t['collective_s']:.3f} ms, bottleneck {t['bottleneck']}, "
            f"useful fraction {uf if uf is None else round(uf, 4)}, peak~ "
            f"{'-' if peak is None else f'{_gib(peak):.2f} GiB'} per rank (estimate)"
            + (f"; local update {r['local_update']}" if "local_update" in r else ""))


def phase_mesh(children, device="cuda") -> None:
    """Phase ``mesh``: the mesh half of the LLM scaffold (see the module's
    docstring, item 10)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import RESULTS_DIR, STENCIL_CASES
    from repro_torch.launch.world import run_world
    from repro_torch.models.api import get_model
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = ARCHS["llama3.2-1b"]
    B, S, _ = TRAIN_MAIN
    # (a) the DTensor step on a (1, 1) mesh against the plain step
    a = mesh_dtensor_step(device)
    check(all(np.isfinite(a["mesh_losses"])), f"mesh (a): losses {a['mesh_losses']}")
    print(f"mesh: (a) llama3.2-1b ({cfg.n_layers} layers) B={B} S={S}, {MESH_STEPS} train "
          f"steps on {a['mesh']} against the plain step: losses "
          f"{', '.join(f'{x:.6f}' for x in a['mesh_losses'])} (DTensor) and "
          f"{', '.join(f'{x:.6f}' for x in a['plain_losses'])} (plain); "
          f"{a['differ']} of {a['leaves']} updated leaves differ"
          + (f" (largest {a['worst']:.3e}, {a['worst_leaf']})" if a["differ"] else
             ", every one equal bit for bit"))
    check(a["mesh_losses"] == a["plain_losses"] and a["differ"] == 0,
          f"mesh (a): the (1, 1) mesh's step is not the plain step bit for bit "
          f"({a['differ']} leaves differ, largest {a['worst']:.3e} in {a['worst_leaf']})")
    dt_ms, pl_ms = statistics.median(a["mesh_ms"][1:]), statistics.median(a["plain_ms"][1:])
    print(f"mesh: (a) ms per step (host clock, steps after the first): DTensor "
          f"{dt_ms:.1f} ({', '.join(f'{x:.1f}' for x in a['mesh_ms'])}), plain {pl_ms:.1f} "
          f"({', '.join(f'{x:.1f}' for x in a['plain_ms'])}): DTensor's host cost "
          f"{dt_ms - pl_ms:.1f} ms per step; plain peak {_gib(a['plain_peak']):.2f} GiB above "
          f"the {_gib(a['plain_peak_raw'] - a['plain_peak']):.2f} GiB held before it "
          f"(max_memory_allocated {_gib(a['plain_peak_raw']):.2f} GiB)")
    # (b) the pipeline over ranks that time-slice the card
    rs = run_world(_mesh_pipe_rank, MESH_PIPE_RANKS, args=(MESH_PIPE_MICRO, device),
                   mesh_shape=(MESH_PIPE_RANKS,), mesh_dim_names=("pod",),
                   device=device, timeout_s=600)
    r0 = rs[0]
    for i, r in enumerate(rs):
        st = r["stats"]
        print(f"mesh: (b) pipeline rank {i}: {st['calls']} calls, {st['ticks']} ticks, "
              f"{st['p2p_ops']} ring shifts ({_gib(st['bytes_sent']) * 1024:.1f} MiB sent), "
              f"{statistics.median(r['ms']):.1f} ms per call "
              f"({', '.join(f'{x:.1f}' for x in r['ms'])}), peak {r['peak']:.2f} GiB")
        check(st["ticks"] == 3 * (MESH_PIPE_MICRO + MESH_PIPE_RANKS - 1)
              and st["p2p_ops"] == st["ticks"], f"mesh (b): rank {i}'s schedule {st}")
    print(f"mesh: (b) {MESH_PIPE_RANKS} stages x {cfg.n_layers // MESH_PIPE_RANKS} llama3.2-1b "
          f"blocks, {MESH_PIPE_MICRO} microbatches of B={B} S={S} bf16: bubble fraction "
          f"{r0['bubble']:.4f}; sequential stack on the same microbatches "
          f"{statistics.median(r0['seq_ms']):.1f} ms ({', '.join(f'{x:.1f}' for x in r0['seq_ms'])}); "
          f"output equal to it bit for bit: {r0['equal']} (max |diff| {r0['max_diff']:.3e})")
    check(r0["finite"] and r0["equal"], "mesh (b): the pipeline's output is not the "
          f"sequential stack's bit for bit (max |diff| {r0['max_diff']:.3e})")
    check(abs(r0["bubble"] - 0.2) < 1e-12, f"mesh (b): bubble fraction {r0['bubble']}")
    # (c) the dry run's records, from the children started with the run
    deadline = time.monotonic() + MESH_DRYRUN_WAIT_S
    for p, log, _ in children:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            stop_dryrun(children)
            raise SmokeFailure(f"mesh (c): a dry-run chain outlived {MESH_DRYRUN_WAIT_S} s")
        with open(log) as f:
            tail = [ln for ln in f.read().splitlines() if ln.startswith("[")]
        check(p.returncode == 0, f"mesh (c): a dry-run chain exited {p.returncode}: {tail[-3:]}")
    names = [f"{a_}__{c}__{m}.json" for a_, c in MESH_DRYRUN_CELLS for m in ("single", "multi")]
    names += [f"stencil-{n}__t{t}__{m}.json" for n, _, _, t in STENCIL_CASES
              for m in ("single", "multi")]
    failed = []
    for name in names:
        with open(os.path.join(RESULTS_DIR, name)) as f:
            r = json.load(f)
        print(_dryrun_line(r))
        if not r.get("ok"):
            failed.append(name)
    # a cell this torch cannot trace is a record (ok: false, its error), as
    # JAX's failed compiles are; the run fails only on a missing record
    print(f"mesh: (c) {len(names) - len(failed)} of {len(names)} cells traced"
          + (f"; ok: false: {', '.join(failed)}" if failed else ""))
    # (d) the witness: the estimator on (a)'s step
    with open(children[-1][2]) as f:
        w = json.load(f)
    check("error" not in w, f"mesh (d): the estimator failed: {w.get('error')}\n{w.get('tb')}")
    mf = model_flops(cfg, B * S)
    est_ms = 1e3 * w["flops"] / BF16_PEAK
    print(f"mesh: (d) the dry-run estimator on (a)'s step (one rank, (1, 1) mesh, traced in "
          f"{w['trace_s']:.0f} s): {w['flops']:.4e} FLOPs against 6 N tokens {mf:.4e} "
          f"(x{w['flops'] / mf:.3f}); compute term {est_ms:.1f} ms at "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s against (a)'s measured {pl_ms:.1f} ms "
          f"({est_ms / pl_ms:.1%}); memory term {1e3 * w['bytes_major'] / HBM_BPS:.1f} ms; "
          f"peak~ {_gib(w['memory']['peak_bytes']):.2f} GiB (arguments "
          f"{_gib(w['memory']['argument_bytes']):.2f} + temp {_gib(w['memory']['temp_bytes']):.2f}) "
          f"against (a)'s measured {_gib(a['plain_peak']):.2f} GiB")
    print(f"mesh: phase in {time.perf_counter() - t0:.1f} s")

def main() -> int:
    if sys.argv[1:2] == [DRYRUN_FLAG]:          # a dry-run chain's child
        sys.path.insert(0, os.path.join(REPO, "src"))
        return dryrun_child(int(sys.argv[2]), sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch import kernels
        from repro_torch.stencil import StencilSpec, make_weights, weights
        # The package re-exports the wrapper functions under the modules'
        # names, so the modules come from importlib.
        sd = importlib.import_module("repro_torch.kernels.stencil_direct")
        sm = importlib.import_module("repro_torch.kernels.stencil_matmul")
        ss = importlib.import_module("repro_torch.kernels.stencil_sparse")
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 1
    # The plain versions are the f32 references: no TF32 anywhere in them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = (kernels, sm, sd, weights, ss)
    if sys.argv[1:] == [COUNT_FLAG]:
        try:
            phase_count_loads(mods)
            phase_audit(mods)
        except (SmokeFailure, RuntimeError, ValueError, TypeError) as e:
            print(f"load count: FAIL: {type(e).__name__}: {e}")
            return 1
        return 0
    if sys.argv[1:] == [WIDE_FLAG]:                # phase wide alone
        try:
            card = phase_build(kernels)
            wide_workspace_checks(mods, card)
            report = phase_wide(mods, card)
        except (SmokeFailure, RuntimeError, ValueError, TypeError) as e:
            print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        print(card)
        print(json.dumps({"kernels": report}))
        return 0
    child = dry = None
    try:
        # the dry run needs no card: its chains run beside every phase
        dry = start_dryrun()
        card = phase_build(kernels, sass=False)
        child = start_count_loads()
        from repro_torch.kernels import _build
        sass_loads(_build)
        phase_kernels_vs_plain(mods)
        phase_foils_vs_plain(mods)
        phase_batch_kernels(mods)
        phase_batch_limits(mods)
        wide_workspace_checks(mods, card)
        finish_count_loads(child)
        report, twins = [], {}
        for label, (shape, specs) in PATHS.items():
            x = grid(shape, torch.float32, seed=0)
            ws = {s.name: make_weights(s, seed=0)
                  for s in (StencilSpec(k, len(shape), r) for k, r in specs)}
            results, counts = phase_main_path(mods, label, x, ws)
            twins[label] = phase_regime_times(label, x, ws, results, card,
                                              lift=(mods, None) if x.ndim == 1 else None)
            # 15 repetitions of everything; in 3D the plain versions and
            # yardsticks are slow, 5.
            reps = 5 if label == "3D" else 15
            for name, wk in ws.items():
                for tf32 in (False, True):
                    ms = cuda_ms(conv_yardstick(x, wk, tf32), reps=reps)
                    print(f"  {name:10s} F.conv{x.ndim}d one step (tf32={tf32}): "
                          f"{ms:.4f} ms")
            band_sparsity_lines(mods, ws)
            w = ws[StencilSpec("box", len(shape), 1).name]
            report += kernel_report(mods, x, w, counts, reps)
            report += phase_sparse_path(mods, label, x, ws, card, reps)
            del x, results
        for label, (shape, specs, boundary) in BOUNDARY_PATHS.items():
            x = grid(shape, torch.float32, seed=0)
            ws = {s.name: make_weights(s, seed=0)
                  for s in (StencilSpec(k, len(shape), r) for k, r in specs)}
            tag = f"{label} boundary={boundary_label(boundary)}"
            results, counts = phase_main_path(mods, tag, x, ws, boundary)
            phase_regime_times(tag, x, ws, results, card,
                               lift=(mods, boundary) if x.ndim == 1 else None)
            w = ws[StencilSpec("box", len(shape), 1).name]
            report += kernel_report(mods, x, w, counts, 5 if label == "3D" else 15,
                                    boundary)
            report += phase_sparse_path(mods, label, x, ws, card, 5 if label == "3D" else 15,
                                        boundary)
            del x, results
        for label, (shape, specs, backends) in FOIL_PATHS.items():
            x = grid(shape, torch.float32, seed=0)
            ws = {s.name: make_weights(s, seed=0)
                  for s in (StencilSpec(k, len(shape), r) for k, r in specs)}
            results, counts = phase_main_path(mods, f"{label} foil", x, ws,
                                              runs=[(b, MAIN_T) for b in backends])
            reps = 5 if label == "3D" else 15
            phase_traffic(mods, label, x, ws, results, card, reps)
            w = ws[StencilSpec("box", len(shape), 1).name]
            report += foil_report(mods, x, w, counts, reps)
            if label == "2D":
                phase_guarded(mods, x, w)
            del x, results
        for label, (shape, b, specs) in BATCH_PATHS.items():
            xb = grid((b,) + shape, torch.float32, seed=0)
            ws = {s.name: make_weights(s, seed=0)
                  for s in (StencilSpec(k, len(shape), r) for k, r in specs)}
            tag = f"{label} batched {b} x {shape}"
            results, counts = phase_main_path(mods, tag, xb, ws, batch=b)
            phase_regime_times(tag, xb, ws, results, card, twins[label])
            w = ws[StencilSpec("box", len(shape), 1).name]
            report += batch_report(mods, xb, w, counts, 5 if label == "3D" else 15)
            if label == "2D":
                phase_guarded_batched(mods, xb, w)
            del xb, results
        shape, b, boundary = BATCH_SPARSE
        xb = grid((b,) + shape, torch.float32, seed=0)
        ws = {s.name: make_weights(s, seed=0)
              for s in (StencilSpec(k, 2, 1) for k in ("box", "star"))}
        tag = f"2D batched {b} x {shape} sparse boundary={boundary}"
        results, counts = phase_main_path(mods, tag, xb, ws, boundary, runs=SPARSE_RUNS,
                                          sparse=True, batch=b)
        phase_regime_times(tag, xb, ws, results, card)
        report += batch_report(mods, xb, ws["Star-2D1R"], counts, 15, boundary, sparse=True)
        del xb, results
        report += phase_wide(mods, card)
        phase_host(mods, make_weights(StencilSpec("box", 2, 1), seed=0),
                   make_weights(StencilSpec("box", 3, 1), seed=0))
        phase_batch_times(mods, card)
        phase_serving(card)
        phase_paper()
        phase_distributed()
        phase_llm()
        phase_train()
        phase_mesh(dry)
    except (SmokeFailure, RuntimeError, ValueError, TypeError,
            NotImplementedError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired, TimeoutError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        stop_dryrun(dry)
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
