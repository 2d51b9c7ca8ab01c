"""Shared-memory auditor: prove each launch's layout and staging map.

The port's kernels stage a CTA's region into shared memory laid out by
the host (``repro_torch.kernels.common``: :class:`DirectLayout` for the
2D tap-sum, :class:`Direct3dLayout` for the 3D tap-sum's rings,
:class:`SlabLayout` for the tile and slab folds, :class:`LineLayout` and
:class:`Direct1dLayout` for the folded 1D kernels), and address it in
fixed cell coordinates.  This module verifies, statically and per launch:

  * ``scratch/slots-partition`` -- the regions the kernel carves out of
    its dynamic shared memory (input buffers, ring slots, Toeplitz rows
    and headers, per-warp staging buffers), at the offsets the ``.cu``
    computes them, are pairwise disjoint, aligned as the kernel's vector
    accesses need, end within the launch's ``smem_bytes``, which fits the
    227 KB budget (and, in 3D, the tile rule's reserve ``tile_smem_bound``
    on every tile the reserve admits: the tiles past it are the rule's
    second half, held to the layout itself, as every 2D tile is);
  * ``scratch/read-window``     -- the staged region is the tile plus its
    t*r halo on every staged axis (1D: the segment's or row's window from
    its granule), and each ring of the 3D tap-sum holds 2r+1 planes per
    fused step: step 0's ring 2r+1 and the planes in flight, each later
    one 2r+1 and the plane the step before writes, no two live planes of
    an interval in one slot;
  * ``scratch/gather-window``   -- the compacted launches' band metadata,
    as JAX ``scratch.py:57`` proves it, and every band's k-steps covering
    its kept rows inside the copy width ``a_cols``;
  * ``scratch/cluster-split``   -- a launch whose layout is spread over a
    thread-block cluster (``common.ClusterLayout``, the tile rule's third
    rung): 2, 4 or 8 CTAs, the least that fits the budget; every fused
    step's ring, every band and every region plane owned by exactly one
    CTA; every plane a CTA's folds read held in its share (its own and
    the 2R it copies from their owners); each share within the budget
    (``scratch/slots-partition`` walks every CTA's share);
  * ``scratch/coverage-global`` -- for sampled CTAs and region cells, the
    staged cell at each region coordinate is the global cell the kernel's
    fixed cell coordinates name (the staging origin, the buffer offset --
    the tap-sums' ``lead``, the 1D kernels' granule shift), the walk's
    windows hold it exactly once, every out-of-domain cell of a
    non-periodic axis has its fill source staged, and the store reads the
    tile's own cells.  This is the class of halo off-by-one the auditor
    exists to catch.
"""
from __future__ import annotations

import bisect
import itertools
import types
from typing import List

import torch

from repro_torch.kernels import common
from .report import AuditCheck

_TORCH = {4: torch.float32, 2: torch.bfloat16}


def _unlifted(launch):
    return launch.weights[0] if len(launch.grid_shape) == 1 \
        else launch.weights


def _one(lay):
    """The one-CTA layout of a launch's layout (a cluster's or a
    workspace form's ``base``)."""
    return (lay.base if isinstance(lay, (common.ClusterLayout,
                                         common.WorkspaceLayout)) else lay)


def launch_layout(launch):
    """The shared-memory layout the launch's wrapper passes its kernel (3D:
    a :class:`common.ClusterLayout` past one CTA; 2D and 3D: a
    :class:`common.WorkspaceLayout` past any cluster, at the budget now,
    on the plan's device)."""
    from repro_torch.kernels.stencil_direct import (direct2d_layout,
                                                    direct3d_rings)
    from repro_torch.kernels.stencil_matmul import (slab_launch_layout,
                                                    tile_launch_layout)
    from repro_torch.kernels.stencil_sparse import sparse_tile_layout
    g, r, t = launch.geom, launch.radius, launch.t_inner
    h, cb = launch.total_halo, launch.compute_bytes
    fam, dev = launch.family, launch.device
    if fam == "tapsum2d":
        if launch.staging != "region":
            return common.direct_layout(g.strip_m, g.w_tile, h)
        return direct2d_layout(g, h, device=dev)
    if fam == "tapsum3d":
        if launch.staging != "region":
            return common.direct3d_layout(g.strip_m, g.w_tile, r, t)
        return direct3d_rings(g, r, t, device=dev)
    if fam == "tapsum1d":
        return common.direct1d_layout(g.w_tile, h, launch.dtype_bytes)
    if launch.engine == "sparse_matmul":
        return sparse_tile_layout(launch.grid_shape, _unlifted(launch), t,
                                  g, _TORCH[cb], _TORCH[launch.dtype_bytes],
                                  device=dev)
    if fam == "line_fold":
        return common.line_layout(g.w_tile, r, t, launch.dtype_bytes, cb)
    n_rows = len(launch.band_rows)
    if fam == "tile_fold":
        if launch.staging != "region":
            return common.tile_fold_layout(g.strip_m, g.w_tile, r, t, cb,
                                           n_rows)
        return tile_launch_layout(g, r, t, cb, n_rows, "banded", deep=True,
                                  device=dev)
    if launch.staging != "region":
        return common.slab_fold_layout(g.z_slab, g.strip_m, g.w_tile, r, t,
                                       cb, n_rows)
    return slab_launch_layout(g, r, t, cb, tuple(b[0] for b in
                                                 launch.band_rows),
                              "3D banded", device=dev)


# ---------------------------------------------------------------------------
# scratch/slots-partition: the regions the kernel carves, as it carves them
# ---------------------------------------------------------------------------
def cluster_regions(launch, lay) -> list:
    """Per CTA of a cluster launch, :func:`smem_regions` of its share, at
    the offsets the cluster kernels compute: the 3D tap-sum's rings of its
    steps from its first (``stencil_direct3d.cu``, ``slot``); a slab
    fold's planes, then its bands' Toeplitz rows and headers
    (``slab_fold.cuh``)."""
    g, h, base = launch.geom, launch.total_halo, lay.base
    rows0 = g.strip_m + 2 * h
    out = []
    for k, (lo, hi) in enumerate(lay.held):
        regs = []
        if launch.family == "tapsum3d":
            i = 0
            for s in range(lo, hi):
                for _ in range(base.ring0 if s == 0 else base.ring):
                    regs.append((f"CTA {k} step {s} slot {i}",
                                 (common.DIRECT3D_MARGIN + i * base.plane_ld)
                                 * 4, rows0 * base.ld * 4, 16))
                    i += 1
            regs.append((f"CTA {k} end", (common.DIRECT3D_MARGIN
                                          + i * base.plane_ld) * 4, 0, 1))
        else:
            for p in range(hi - lo):
                regs.append((f"CTA {k} region plane {lo + p}",
                             p * base.plane_ld * 4, rows0 * base.ld * 4, 16))
            bands = (lay.rows[k + 1] - lay.rows[k] if lay.kind == "dz"
                     else base.n_rows)
            cb = launch.compute_bytes
            toe = _align128((hi - lo) * base.plane_ld * 4)
            hdr = toe + _align128(bands * base.toe_ld * cb)
            regs += [(f"CTA {k} Toeplitz rows", toe, bands * base.toe_ld * cb,
                      128),
                     (f"CTA {k} headers", hdr, bands * common.SLAB_HEADER_BYTES,
                      16),
                     (f"CTA {k} end", hdr + bands * common.SLAB_HEADER_BYTES,
                      0, 1)]
        out.append(regs)
    return out


def smem_regions(launch, lay) -> list:
    """``(name, byte offset, bytes, alignment)`` of every region the
    launch's kernel addresses, at the offsets the ``.cu`` computes from
    its arguments (the tile, the halo and the layout's strides)."""
    g, h, fam = launch.geom, launch.total_halo, launch.family
    rows0 = g.strip_m + 2 * h
    out = []
    if fam == "tapsum2d":                    # csrc/stencil_direct.cu
        m = common.DIRECT_MARGIN * 4
        buf = rows0 * lay.ld * 4
        out = [("buffer 0", m, buf, 16), ("buffer 1", 2 * m + buf, buf, 16)]
        out.append(("end", 3 * m + 2 * buf, 0, 1))
    elif fam == "tapsum3d":                  # stencil_direct3d.cu, Rings
        r, t = launch.radius, launch.t_inner
        slots = (2 * r + 1 + common.DIRECT3D_AHEAD) + (t - 1) * (2 * r + 2)
        for i in range(slots):
            off = (common.DIRECT3D_MARGIN + i * lay.plane_ld) * 4
            out.append((f"slot {i}", off, rows0 * lay.ld * 4, 16))
        out.append(("end", (common.DIRECT3D_MARGIN + slots * lay.plane_ld)
                    * 4, 0, 1))
    elif fam in ("tile_fold", "slab_fold"):  # tile_fold.cuh, slab_fold.cuh
        planes = g.z_slab + 2 * h if fam == "slab_fold" else 1
        for p in range(planes):
            out.append((f"region plane {p}", p * lay.plane_ld * 4,
                        rows0 * lay.ld * 4, 16))
        toe = _align128(planes * lay.plane_ld * 4)
        cb = launch.compute_bytes
        hdr = toe + _align128(lay.n_rows * lay.toe_ld * cb)
        out += [("Toeplitz rows", toe, lay.n_rows * lay.toe_ld * cb, 128),
                ("headers", hdr, lay.n_rows * common.SLAB_HEADER_BYTES, 16),
                ("end", hdr + lay.n_rows * common.SLAB_HEADER_BYTES, 0, 1)]
    elif fam == "line_fold":                 # line_fold.cuh
        in_b = launch.dtype_bytes
        for w in range(common.LINE_WARPS):
            base = w * lay.warp_bytes
            for k in range(2):
                out.append((f"warp {w} stage {k}", base + k * lay.stage_bytes,
                            common.LINE_TILE_ROWS * lay.lds * in_b, 128))
            if in_b != 4:
                out.append((f"warp {w} region", base + 2 * lay.stage_bytes,
                            common.LINE_TILE_ROWS * lay.ld * 4, 16))
        out.append(("end", common.LINE_WARPS * lay.warp_bytes, 0, 1))
    else:                                    # stencil_direct1d.cu
        in_b = launch.dtype_bytes
        for k in range(2):
            out.append((f"stage {k}", k * lay.stage_bytes + 16,
                        lay.lds * in_b - 16, 16))
        works = 1 if in_b == 4 else 2
        for k in range(works):
            out.append((f"work {k}", 2 * lay.stage_bytes + k * lay.work_bytes
                        + 16, lay.ld * 4 - 16, 16))
        out.append(("end", 2 * lay.stage_bytes + works * lay.work_bytes,
                    0, 1))
    return out


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def workspace_regions(launch, lay) -> list:
    """:func:`smem_regions` of a workspace form's slice
    (:class:`common.WorkspaceLayout`): the one-CTA layout's, a fold's band
    headers where that layout puts its Toeplitz rows, which stay in the
    device array every CTA reads (``slab_fold.cuh``, ``tile_fold.cuh``
    under ``REPRO_WORKSPACE``)."""
    regs = smem_regions(launch, lay.base)
    if launch.family not in ("tile_fold", "slab_fold"):
        return regs
    toe = next(o for name, o, _, _ in regs if name == "Toeplitz rows")
    hdr = lay.base.n_rows * common.SLAB_HEADER_BYTES
    return ([x for x in regs if x[0] not in ("Toeplitz rows", "headers",
                                             "end")]
            + [("headers", toe, hdr, 16), ("end", toe + hdr, 0, 1)])


def _workspace_check(launch, lay) -> AuditCheck:
    """scratch/slots-partition of a workspace form: its slice's regions
    disjoint, aligned and within the slice, the workspace one slice per
    persistent CTA, and no dynamic shared memory asked for."""
    regions = workspace_regions(launch, lay)
    body = [x for x in regions if not x[0].endswith("end")]
    end = max(o + n for _, o, n, _ in regions)
    problems = []
    spans = sorted((o, o + n, name) for name, o, n, _ in body)
    for (a0, a1, an), (b0, b1, bn) in zip(spans, spans[1:]):
        if b0 < a1:
            problems.append(f"{an} [{a0}, {a1}) overlaps {bn} [{b0}, {b1})")
    for name, o, _, al in body:
        if o % al:
            problems.append(f"{name} at byte {o} is not {al}-byte aligned")
    if end > lay.slice_bytes:
        problems.append(f"the kernel addresses {end} bytes of a "
                        f"{lay.slice_bytes}-byte slice")
    if lay.slice_bytes % 128 or lay.total_bytes != lay.ctas * lay.slice_bytes:
        problems.append(f"{lay.total_bytes} workspace bytes are not "
                        f"{lay.ctas} slices of {lay.slice_bytes}")
    if lay.smem_bytes:
        problems.append(f"asks for {lay.smem_bytes} bytes of shared memory")
    return AuditCheck(
        "scratch/slots-partition", not problems,
        expected={"disjoint": True, "within_bytes": lay.slice_bytes,
                  "workspace_bytes": lay.ctas * lay.slice_bytes},
        actual={"regions": len(body), "end": end,
                "workspace_bytes": lay.total_bytes,
                "problems": problems or "none"},
        detail="a layout past one CTA and any cluster lives in a device "
               "workspace: each persistent CTA's slice holds the regions "
               "the kernel carves, disjoint, aligned and within it")


def _slots_check(launch, lay) -> AuditCheck:
    if isinstance(lay, common.WorkspaceLayout):
        return _workspace_check(launch, lay)
    cluster = isinstance(lay, common.ClusterLayout)
    shares = (cluster_regions(launch, lay) if cluster
              else [smem_regions(launch, lay)])
    problems, body, end = [], [], 0
    for regions in shares:
        share = [r for r in regions if not r[0].endswith("end")]
        body += share
        last = max(o + n for _, o, n, _ in regions)
        end = max(end, last)
        spans = sorted((o, o + n, name) for name, o, n, _ in share)
        for (a0, a1, an), (b0, b1, bn) in zip(spans, spans[1:]):
            if b0 < a1:
                problems.append(f"{an} [{a0}, {a1}) overlaps {bn} "
                                f"[{b0}, {b1})")
        if last > lay.smem_bytes:
            problems.append(f"the kernel addresses {last} bytes, the launch "
                            f"asks for {lay.smem_bytes}")
    for name, o, _, al in body:
        if o % al:
            problems.append(f"{name} at byte {o} is not {al}-byte aligned")
    if lay.smem_bytes > common.SMEM_BUDGET_BYTES:
        problems.append(f"{lay.smem_bytes} bytes over the 227 KB budget")
    g = launch.geom
    bound = (common.smem_budget_bytes() if cluster
             else common.SMEM_BUDGET_BYTES)
    what = "budget"
    if not cluster and launch.family in ("tapsum3d", "slab_fold"):
        # a 3D tile the reserve admits holds the layout to it; past it the
        # rule's second half holds the candidates to the layout itself, as
        # the 2D rule holds every 2D candidate, to the budget
        reserve = common.tile_smem_bound(g.strip_m, g.w_tile,
                                         launch.total_halo, g.z_slab)
        if reserve <= bound:
            bound, what = reserve, "reserve"
    if lay.smem_bytes > bound:
        problems.append(f"{lay.smem_bytes} bytes over the tile rule's "
                        f"{what} {bound}")
    return AuditCheck(
        "scratch/slots-partition", not problems,
        expected={"disjoint": True, "within_bytes": lay.smem_bytes},
        actual={"regions": len(body), "end": end,
                "problems": problems or "none"},
        detail="the shared-memory regions the kernel carves must be "
               "disjoint, aligned and within the launch's allocation")


# ---------------------------------------------------------------------------
# scratch/read-window
# ---------------------------------------------------------------------------
def ring_conflicts(radius: int, t: int, planes: int) -> list:
    """The 3D tap-sum's wavefront (``stencil_direct3d.cu``), interval by
    interval: the region planes live in each ring (step 0: the planes its
    output plane reads and those staged ahead; step s >= 1: the planes it
    reads and the one step s - 1 writes) must map to distinct slots of a
    ring of 2r+1+AHEAD (step 0) or 2r+2 (later) slots.  Returns the
    conflicts found (empty when none)."""
    r, ahead = radius, common.DIRECT3D_AHEAD
    ring0, ring = 2 * r + 1 + ahead, 2 * r + 2
    bad = []
    for k in range(planes + t - 1):
        for s in range(t):
            q = k - (s + 1) * r - s             # the step's output plane
            if s == 0:
                live = range(q - r, min(k + ahead, planes - 1) + 1)
                size = ring0
            else:
                live = range(q - r, q + r + 2)  # reads, and s-1's write
                size = ring
            live = [p for p in live if 0 <= p < planes]
            slots = [p % size for p in live]
            if len(set(slots)) != len(slots):
                bad.append({"interval": k, "step": s, "planes": live})
    return bad[:8]


def _window_check(launch, lay) -> AuditCheck:
    lay = _one(lay)
    g, h, r, fam = launch.geom, launch.total_halo, launch.radius, \
        launch.family
    expected, actual, problems = {}, {}, []
    if fam in ("tapsum2d", "tapsum3d"):
        cols = g.w_tile + 2 * h
        expected = {"rows": g.strip_m + 2 * h, "lead": -h % 4,
                    "columns": cols}
        actual = {"rows": lay.rows, "lead": lay.lead,
                  "columns": lay.ld - lay.lead}
        if lay.rows != g.strip_m + 2 * h or lay.lead != -h % 4 \
                or lay.ld - lay.lead < cols or lay.ld % 4:
            problems.append("the staged plane is not the tile + halo")
        if fam == "tapsum3d":
            t = launch.t_inner
            expected["rings"] = (2 * r + 1 + common.DIRECT3D_AHEAD,
                                 2 * r + 2)
            actual["rings"] = (lay.ring0, lay.ring)
            if (lay.ring0, lay.ring) != expected["rings"] or \
                    lay.slots != lay.ring0 + (t - 1) * lay.ring:
                problems.append("rings do not hold 2r+1 planes per step")
            if lay.plane_ld < lay.rows * lay.ld:
                problems.append("ring slots overlap")
            conflicts = ring_conflicts(r, t, g.z_slab + 2 * h)
            if conflicts:
                problems.append(f"live planes share a slot: {conflicts}")
    elif fam in ("tile_fold", "slab_fold"):
        planes = g.z_slab + 2 * h if fam == "slab_fold" else 1
        expected = {"planes": planes, "rows": g.strip_m + 2 * h,
                    "columns": g.w_tile + 2 * h}
        actual = {"planes": lay.planes, "rows": lay.rows,
                  "columns": lay.ld}
        if lay.planes != planes or lay.rows != g.strip_m + 2 * h or \
                lay.ld < g.w_tile + 2 * h or lay.plane_ld < lay.rows * lay.ld:
            problems.append("the staged region is not the tile + halo")
    elif fam == "line_fold":
        from .blocks import line_staged
        win = g.w_tile + 2 * h
        staged = line_staged(launch, win)
        expected = {"window": win, "staged_row": staged}
        actual = {"lds": lay.lds, "ld": lay.ld}
        if staged > lay.lds or (launch.dtype_bytes == 4 and
                                lay.lds < lay.ld) or \
                lay.ld < g.w_tile + 2 * (launch.t_inner - 1) * r:
            problems.append("a row window does not fit its staged row")
    else:
        from .blocks import line_staged
        seg = common.LINE_ROWS * g.w_tile
        staged = line_staged(launch, seg + 2 * h)
        expected = {"window": seg + 2 * h, "staged": staged}
        actual = {"lds": lay.lds, "ld": lay.ld}
        if 16 // launch.dtype_bytes + staged > lay.lds or \
                lay.ld < 4 + seg + 2 * h:
            problems.append("a segment window does not fit its buffers")
    return AuditCheck(
        "scratch/read-window", not problems, expected=expected,
        actual=dict(actual, problems=problems or "none"),
        detail="the staged region must be the tile plus its t*r halo on "
               "every staged axis")


def _gather_window_check(launch, lay) -> AuditCheck:
    """The compacted launch's band metadata (JAX ``scratch.py:57``) and
    its k-steps over the kept rows."""
    r, tile_n = launch.radius, launch.tile_n
    lo, spans = launch.band_lo, launch.band_spans
    problems = []
    if lo is None or spans is None:
        problems.append("missing band_lo/band_spans metadata")
    elif not (len(lo) == len(spans) == launch.n_offsets):
        problems.append(f"{len(lo)} band_lo / {len(spans)} band_spans "
                        f"!= {launch.n_offsets} offsets")
    else:
        for p, (l, s) in enumerate(zip(lo, spans)):
            if not (0 <= l and 0 <= s and l + s <= 2 * r):
                problems.append(f"band {p}: window [lo={l}, lo+span={l+s}) "
                                f"outside dense support [0, {2*r}]")
        kept = sum(tile_n + s for s in spans)
        if launch.bands_shape is None or kept != launch.bands_shape[0]:
            problems.append(f"packed rows {launch.bands_shape} != "
                            f"sum(tile_n + span) = {kept}")
        k_step = common.mma_k_step(launch.compute_bytes)
        for p, ((*_, l, nk), s) in enumerate(zip(launch.band_rows, spans)):
            if nk * k_step < tile_n + s or l != lo[p]:
                problems.append(f"band {p}: {nk} k-steps from {l} do not "
                                f"cover its {tile_n + s} kept rows")
            if len(launch.grid_shape) > 1 and l + nk * k_step > lay.a_cols:
                problems.append(f"band {p} reads past a_cols {lay.a_cols}")
    return AuditCheck(
        "scratch/gather-window", not problems,
        expected="every band gathers [lo, lo + tile + span) inside the "
                 "dense band support; packed rows == sum(tile_n + span); "
                 "k-steps cover the kept rows",
        actual=problems or "ok",
        detail="sparse-compacted gather metadata must cover exactly the "
               "kept contraction rows")


# ---------------------------------------------------------------------------
# scratch/cluster-split
# ---------------------------------------------------------------------------
def cluster_share_bytes(launch, lay, lo: int, hi: int) -> int:
    """The bytes a CTA owning the items [lo, hi) of ``lay.kind`` holds,
    counted from the one-CTA layout's strides as the cluster kernels carve
    them (the cluster's ``shares``, recomputed)."""
    base, cb = lay.base, launch.compute_bytes
    if lay.kind == "steps":
        slots = sum(base.ring0 if s == 0 else base.ring for s in range(lo, hi))
        return (common.DIRECT3D_MARGIN + slots * base.plane_ld) * 4
    if lay.kind == "dz":
        planes = launch.geom.z_slab + hi - lo - 1
        dzs = [b[0] for b in launch.band_rows]
        bands = bisect.bisect_left(dzs, hi) - bisect.bisect_left(dzs, lo)
    else:
        planes = min(hi + 2 * launch.radius, base.planes) - lo
        bands = base.n_rows
    return (_align128(planes * base.plane_ld * 4)
            + _align128(bands * base.toe_ld * cb)
            + bands * common.SLAB_HEADER_BYTES)


def _cluster_check(launch, lay) -> AuditCheck:
    g, r, t = launch.geom, launch.radius, launch.t_inner
    budget = common.smem_budget_bytes()
    n = (t if lay.kind == "steps" else 2 * r + 1 if lay.kind == "dz"
         else lay.base.planes)
    problems = []
    c, split = lay.ctas, lay.split
    if c not in common.CLUSTER_SIZES or len(split) != c + 1 or \
            split[0] != 0 or split[-1] != n or \
            any(b <= a for a, b in zip(split, split[1:])):
        problems.append(f"split {split} is not {c} non-empty ranges of "
                        f"[0, {n})")
    owned = [sum(a <= i < b for a, b in zip(split, split[1:]))
             for i in range(n)]
    if owned != [1] * n:
        problems.append("an item is owned by other than one CTA")
    if lay.kind == "dz":
        rows = [sum(1 for b in launch.band_rows if b[0] < d) for d in split]
        if tuple(rows) != lay.rows:
            problems.append(f"bands {lay.rows} are not those of each dz "
                            f"range ({rows})")
    for k, ((a, b), (lo, hi)) in enumerate(zip(zip(split, split[1:]),
                                               lay.held)):
        if lay.kind == "dz":
            need = (a, b - 1 + g.z_slab)    # planes z + dz its bands read
        elif lay.kind == "planes":
            need = (a, min(b + 2 * r, lay.base.planes))
        else:
            need = (a, b)
        if (lo, hi) != need:
            problems.append(f"CTA {k} holds {(lo, hi)}, reads {need}")
        share = cluster_share_bytes(launch, lay, a, b)
        if share != lay.shares[k] or share > budget:
            problems.append(f"CTA {k}'s share {lay.shares[k]} (recounted "
                            f"{share}) over the {budget}-byte budget")
    # the least CTAs any split into contiguous shares takes: grow each
    # share while the next item still fits (shares only grow with items)
    least, a = 0, 0
    while a < n and least <= n:
        b = a + 1
        while b < n and cluster_share_bytes(launch, lay, a, b + 1) <= budget:
            b += 1
        least, a = least + 1, b
    if any(least <= s < c for s in common.CLUSTER_SIZES):
        problems.append(f"{least} CTAs would hold it, fewer than {c}")
    return AuditCheck(
        "scratch/cluster-split", not problems,
        expected={"ctas": "the least of 2, 4, 8 that fits", "budget": budget},
        actual={"ctas": c, "kind": lay.kind, "split": list(split),
                "shares": list(lay.shares), "problems": problems or "none"},
        detail="a layout past one CTA spread over a cluster: every ring, "
               "band and plane owned once, every read inside a share")


# ---------------------------------------------------------------------------
# scratch/coverage-global
# ---------------------------------------------------------------------------
def fixed_coords(launch, lay) -> list:
    """Per axis of the launch, the kernel's fixed cell coordinates:
    ``(offset, origin, final)`` -- the buffer cell of region cell 0, the
    global cell of buffer cell 0 relative to the tile's first cell (the
    staging call's origin), and the global cell the store reads as the
    tile's first, relative to that origin (tap-sums keep every cell in
    place, so the tile's first cell sits at offset + h; the folds write
    each step's output at the region's origin, which moves R a step)."""
    h, fam, lay = launch.total_halo, launch.family, _one(lay)
    dims = len(launch.grid_shape)
    if fam in ("tapsum2d", "tapsum3d"):
        return [(0, -h, h)] * (dims - 1) + [(lay.lead, -h - lay.lead,
                                             lay.lead + h)]
    if fam in ("tile_fold", "slab_fold"):
        return [(0, -h, launch.t_inner * launch.radius)] * dims
    from .blocks import granule_shift
    sh = granule_shift(0, h, launch.dtype_bytes)
    if fam == "tapsum1d":
        return [(sh, -h - sh, sh + h)]
    return [(sh, -h - sh, sh + launch.t_inner * launch.radius)]


def _sample(n: int) -> list:
    return sorted({0, n // 2, n - 1})


def _source(g: int, n: int, depth: int, mode: str):
    """The in-domain cell a fill at ``depth`` copies into global cell ``g``
    (None under ``zero``, or deeper than the fill reaches)."""
    if mode == "periodic" or 0 <= g < n:
        return g % n
    if g < -depth or g >= n + depth or mode == "zero":
        return None
    if mode == "replicate":
        return 0 if g < 0 else n - 1
    return -g if g < 0 else 2 * (n - 1) - g


def _coverage_check(launch, lay, walk) -> AuditCheck:
    shape, h = launch.grid_shape, launch.total_halo
    modes = launch.boundary or ("periodic",) * len(shape)
    coords = fixed_coords(launch, lay)
    if len(shape) == 1:
        item = (common.LINE_ROWS * launch.geom.w_tile
                if launch.family == "tapsum1d" else launch.geom.w_tile)
        tiles = (item,)
    else:
        tiles = tuple(((launch.geom.z_slab,) if len(shape) == 3 else ())
                      + (launch.geom.strip_m, launch.geom.w_tile))
    bad = []

    def region_cells(ax, out):
        tl = out[1] - out[0] if launch.family == "tapsum1d" else tiles[ax]
        return tl, [p for p in sorted(set(_sample(tl + 2 * h) + [h - 1, h]))
                    if 0 <= p < tl + 2 * h]

    def held(outs, wins):
        """Region cells (sampled, every axis at once) held by other than
        exactly one window."""
        picks = [region_cells(ax, o)[1] for ax, o in enumerate(outs)]
        for cell in itertools.product(*picks):
            g = [o[0] - h + p for o, p in zip(outs, cell)]
            hits = sum(all(lo <= gg < hi for gg, (lo, hi) in zip(g, win))
                       for win in wins)
            if hits != 1 and len(bad) < 8:
                bad.append({"region_cell": cell, "global": tuple(g),
                            "windows_holding_it": hits})

    def axis(ax, out, wins=None):
        a, n = out[0], shape[ax]
        tl, cells = region_cells(ax, out)
        offset, origin, final = coords[ax]
        for p in cells:
            staged = a + origin + offset + p        # global of region cell p
            true = a - h + p
            src = _source(true, n, h, modes[ax])
            ok = staged == true
            if wins is not None:
                ok &= sum(lo <= staged < hi for lo, hi in wins) == 1
            if modes[ax] != "periodic" and not 0 <= true < n and \
                    true < n + h:
                # the fill's source must be a staged cell of the region
                ok &= (src is None and (modes[ax] == "zero")) or (
                    src is not None and a - h <= src < a + tl + h)
            if not ok and len(bad) < 8:
                bad.append({"axis": ax, "tile_start": a, "region_cell": p,
                            "staged_global": staged, "expected": true})
        if a + origin + final != a and len(bad) < 8:
            bad.append({"axis": ax, "tile_start": a,
                        "store_reads_global": a + origin + final})

    if walk.entries is not None:
        n_ent = len(walk.entries)
        picks = sorted({0, n_ent // 2, n_ent - 1, 1 % n_ent})
        for i in picks:
            outs, wins, _ = walk.entries[i]
            if len(shape) == 1 and launch.family == "line_fold":
                for out, win in list(zip(outs, wins))[:2]:
                    axis(0, out, [win[0]])
                continue
            for ax in range(len(shape)):
                axis(ax, outs[ax])
            held(outs, wins)
    elif walk.axes is not None:
        for ax, entries in enumerate(walk.axes):
            for i in _sample(len(entries)):
                out, wins = entries[i]
                axis(ax, out, wins)
    else:
        n, L = shape[0], launch.geom.w_tile
        for count, out, win, _ in walk.classes:
            nominal = out + 2 * h if launch.family == "tapsum1d" else \
                -(-out // L) * (L + 2 * h)
            if count and win != nominal and len(bad) < 8:
                bad.append({"class_out_cells": out, "window_cells": win,
                            "expected": nominal})
        for start in sorted({0, (n - 1) // tiles[0] * tiles[0]}):
            end = min(start + tiles[0], n)
            hi = end if launch.family == "tapsum1d" else start + L
            axis(0, (start, end), [(start - h, hi + h)])
    return AuditCheck(
        "scratch/coverage-global", not bad,
        expected="every staged region cell is its true global cell, held "
                 "by one window; fill sources staged; the store reads the "
                 "tile",
        actual=bad or "ok",
        detail="the staging origin, the buffer offset (lead / granule "
               "shift) and the store position must name the tile's "
               "region (the halo off-by-one class)")


def audit_layout(family: str, geom, radius: int, t: int, layout,
                 dtype_bytes: int = 4, compute_bytes: int = 4,
                 band_rows=None) -> List[AuditCheck]:
    """``scratch/slots-partition`` and ``scratch/read-window`` of a layout
    on its own (and ``scratch/cluster-split`` of a cluster's; a slab's
    split by dz needs its ``band_rows``, each band's (dz, ...)): the
    kernel ``family`` (``registry.FAMILIES``) at ``t`` fused steps of
    radius ``radius`` on the tile ``geom`` (1D: the lifted tile),
    whatever plan would launch it."""
    launch = types.SimpleNamespace(
        family=family, geom=geom, radius=radius, t_inner=t,
        total_halo=t * radius, dtype_bytes=dtype_bytes,
        compute_bytes=compute_bytes,
        engine="direct" if family.startswith("tapsum") else "matmul",
        band_rows=band_rows)
    checks = [_slots_check(launch, layout), _window_check(launch, layout)]
    if isinstance(layout, common.ClusterLayout):
        checks.append(_cluster_check(launch, layout))
    return checks


def audit_scratch(launch, walk=None, layout=None) -> List[AuditCheck]:
    """All shared-memory checks of one launch (``layout``: the layout to
    audit, default the one its wrapper passes; ``walk``: its window walk,
    for the coverage check)."""
    from .blocks import walk_windows
    lay = layout if layout is not None else launch_layout(launch)
    checks = [_slots_check(launch, lay), _window_check(launch, lay)]
    if isinstance(lay, common.ClusterLayout):
        checks.append(_cluster_check(launch, lay))
    if launch.engine == "sparse_matmul":
        checks.append(_gather_window_check(launch, _one(lay)))
    walk = walk if walk is not None else walk_windows(launch)
    checks.append(_coverage_check(launch, lay, walk))
    return checks
