"""K1 at f64 weights: the entry points of csrc/fused_field_f64.cu, and the
Python mirror of its tiles, shared-memory budget and head split.

The kernel computes what `fused_field._field_plain_f64` computes (its
plain version) from the f64 pack of `fused_field.pack_field_weights(...,
dtype=torch.float64)`, the pack K1 at f32 weights takes in another
dtype: the same weight order, the same projection-column table, the
same launch arguments, so `fused_field._launch` launches either and
counts the launches. A block of 8 warps holds TILE (64) points as f64
activations in shared memory, `smem_bytes` in all; the full variant
projects the heads in its epilogues, each projection's rows split over
the warps as `projection_split` says.
"""

from __future__ import annotations

import ctypes
import functools

from ibl_nerf_tpu_torch.kernels import build as _build
from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.models.field import FieldConfig

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
MMA_K = 4            # the k depth of one mma.sync (`kMmaK` in the source)
TILE = 64            # points of a block's tile, both variants (`kTile`)
WARPS = 8            # warps of a block (`kWarps`)
PROJ_COLS = 4        # raw columns one projection may have (`kProjCols`)


def _round_k(v: int) -> int:
    return -(-v // MMA_K) * MMA_K


def smem_bytes(cfg: FieldConfig, density_only: bool) -> int:
    """Dynamic shared memory of one block (`smem_bytes` in the source): the
    embedding plane X and H as f64 rows of the tile's points at a stride of
    tile + 4, and for the full variant two f64 planes of the heads'
    partial sums, WARPS x PROJ_COLS x tile each, whatever the head count."""
    a, b = _round_k(cfg.input_ch), cfg.input_ch + _round_k(cfg.input_ch_views)
    x_rows = a if density_only else max(a, b)
    planes = (x_rows + ff.KERNEL_WIDTH) * (TILE + 4)
    return 8 * (planes + (0 if density_only else 2 * WARPS * PROJ_COLS * TILE))


def projection_split(n_coarse: int) -> list[tuple[int, int]]:
    """(first warp, warps) over which the full variant splits the rows of
    each projection of `fused_field.projection_columns` (A, B, C, then
    D_k), in equal runs of rows in warp order: A, B and C over all 8 warps
    (32 of the 256 rows each); the view_feat tile of heads k, k + 1 puts
    head k's 128 rows in warps 0-3 and head k + 1's in warps 4-7; an odd
    last head takes all 8 warps, 16 rows each. Each warp's f64 partial is
    summed in warp order in f64 and rounded to f32 once."""
    heads = [(0, WARPS) if k == n_coarse - 1 and n_coarse % 2 else
             (WARPS // 2 * (k % 2), WARPS // 2) for k in range(n_coarse)]
    return [(0, WARPS)] * 3 + heads


_i = ctypes.c_int
# argtypes of `fused_field_f64_occupancy`
OCCUPANCY_ARGS = [_i, _i, _i, _i, ctypes.POINTER(_i), ctypes.POINTER(ctypes.c_longlong)]


@functools.cache
def _entries():
    """The entry points of csrc/fused_field_f64.cu, built on first use:
    the launcher and the occupancy query."""
    lib = _build.load("fused_field_f64")
    launch, occ = lib.fused_field_f64_launch, lib.fused_field_f64_occupancy
    launch.restype, launch.argtypes = ctypes.c_int, ff.ENTRY_ARGS
    occ.restype, occ.argtypes = ctypes.c_int, OCCUPANCY_ARGS
    return launch, occ


def occupancy(cfg: FieldConfig, density_only: bool) -> dict[str, int]:
    """Dynamic shared memory per block and the blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), current device."""
    blocks, smem = ctypes.c_int(), ctypes.c_longlong()
    err = _entries()[1](cfg.input_ch, cfg.input_ch_views, cfg.coarse_radiance_number,
                        int(density_only), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"fused_field f64 occupancy query failed: error {err}")
    return {"smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}
