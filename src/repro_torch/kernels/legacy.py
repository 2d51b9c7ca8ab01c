"""The seed 9-tile scheme, kept as a traffic foil: the counterpart of
``repro.kernels.legacy`` (K9 ``stencil_direct_9pt``, K10
``stencil_matmul_9pt``).

In the seed scheme every (tile_m, tile_n) output tile reads its nine
whole neighbour tiles -- 9x the grid -- of which it uses halo-wide edges
only (``assemble_extended``).  On the card both functions launch the main
kernels with the ``"9tile"`` staging (``csrc/common.cuh``: the nine tiles
stream through the same region buffer the default staging fills), so K9
runs the tap-sum body of ``csrc/stencil_direct.cu`` (t fused steps) and
K10 one banded contraction of the composed kernel by the body of
``csrc/stencil_banded.cu``.  2D periodic grids whose tiles divide them
(``_validate_square``, the JAX messages), 128 x 128 tiles by default.  A
tensor on the CPU runs the regime's plain version: a foil computes the
function of the regime it mirrors.  Not a hot path: the foils exist so a
run can measure what the seed's bytes cost against the same compute.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import stencil_direct as _direct
from . import stencil_matmul as _matmul
from .common import BAND_N, SubstrateGeom, batch_grid, check_grid, plain_loop

NEIGHBOR_OFFSETS_2D = [(-1, -1), (-1, 0), (-1, 1),
                       (0, -1), (0, 0), (0, 1),
                       (1, -1), (1, 0), (1, 1)]


def assemble_extended(tiles: Sequence[torch.Tensor],
                      halo: int) -> torch.Tensor:
    """The (tile_m + 2h, tile_n + 2h) halo-extended tile from the nine
    neighbour tiles in ``NEIGHBOR_OFFSETS_2D`` order (the JAX
    ``assemble_extended``): only the needed edges and corners of the
    neighbours are used."""
    tl, t, tr, lf, c, rt, bl, b, br = tiles
    h = halo
    top = torch.cat([tl[-h:, -h:], t[-h:, :], tr[-h:, :h]], dim=1)
    mid = torch.cat([lf[:, -h:], c, rt[:, :h]], dim=1)
    bot = torch.cat([bl[:h, -h:], b[:h, :], br[:h, :h]], dim=1)
    return torch.cat([top, mid, bot], dim=0)


def _validate_square(shape, tile_m, tile_n, halo):
    """Seed-era tiling constraints (both tile dims bounded by the halo)."""
    h, w = shape
    if h % tile_m or w % tile_n:
        raise ValueError(f"grid {shape} not divisible by tiles ({tile_m},{tile_n})")
    if tile_m < halo or tile_n < halo:
        raise ValueError(
            f"halo {halo} exceeds tile ({tile_m},{tile_n}); "
            "lower fusion depth or enlarge tiles"
        )


def tile_geom(shape, tile_m: int, tile_n: int, halo: int) -> SubstrateGeom:
    """The 9-tile launch geometry of a 2D grid: the tiles clamped to the
    grid as in JAX, checked by ``_validate_square``, as the
    ``SubstrateGeom`` the kernels launch on (each CTA one tile, its region
    the tile with ``halo`` cells per side)."""
    if len(shape) != 2:
        raise ValueError(f"the seed 9-tile foil runs 2D grids only, got "
                         f"rank {len(shape)}")
    h, wid = shape
    tile_m, tile_n = min(tile_m, h), min(tile_n, wid)
    _validate_square(tuple(shape), tile_m, tile_n, halo)
    return SubstrateGeom(dim=2, strip_m=tile_m, h_block=halo, w_tile=tile_n,
                         w_block=halo)


def stencil_direct_9pt(x: torch.Tensor, weights, t: int = 1,
                       tile_m: int = 128, tile_n: int = 128,
                       batched: bool = False) -> torch.Tensor:
    """Seed tap-sum kernel (K9): ``t`` fused steps on the 9-tile scheme;
    ``batched``: ``x`` is ``(B,) + grid_shape``, one launch (K11)."""
    if t < 1:
        raise ValueError(f"fusion depth must be >= 1, got {t}")
    w = np.asarray(weights)
    shape = batch_grid(x, batched)
    geom = tile_geom(shape, tile_m, tile_n, t * ((w.shape[0] - 1) // 2))
    r, modes = check_grid(shape, w, t, None, "the 9-tile tap-sum")
    if x.device.type == "cpu":
        return plain_loop(_direct.stencil_direct_plain, x, batched, w, t,
                          modes)
    return _direct._run(x, w, t, r, geom, modes, "9tile", batched)


def stencil_matmul_9pt(x: torch.Tensor, weights, tile_m: int = 128,
                       tile_n: int = 128, compute_dtype=None,
                       batched: bool = False) -> torch.Tensor:
    """Seed banded kernel (K10): one contraction of ``weights`` (the
    composed radius-t*r kernel of a plan) on the 9-tile scheme; operands
    in ``compute_dtype`` (default the grid's), 16-column band chunks;
    ``batched``: ``x`` is ``(B,) + grid_shape``, one launch (K11)."""
    w = np.asarray(weights, dtype=np.float32)
    shape = batch_grid(x, batched)
    geom = tile_geom(shape, tile_m, tile_n, (w.shape[0] - 1) // 2)
    radius, modes = check_grid(shape, w, 1, None, "the 9-tile banded "
                               "contraction")
    cdt = x.dtype if compute_dtype is None else compute_dtype
    if x.device.type == "cpu":
        return plain_loop(_matmul.stencil_matmul_plain, x, batched, w, 1,
                          BAND_N, cdt, modes)
    return _matmul._run(x, w, 1, radius, cdt, geom, modes, "9tile", batched)


def hbm_read_bytes_per_step(shape, tile_m: int, tile_n: int, dtype_bytes: int,
                            bands_shape=None) -> int:
    """Analytic read traffic of one 9-tile launch (the JAX model): every
    output tile reads nine whole (tile_m, tile_n) tiles, so the grid is
    read 9x per step; the banded operand (if any) is charged once per
    output tile."""
    h, w = shape
    gm, gn = h // tile_m, w // tile_n
    total = gm * gn * 9 * tile_m * tile_n * dtype_bytes
    if bands_shape is not None:
        total += gm * gn * int(np.prod(bands_shape)) * dtype_bytes
    return total
