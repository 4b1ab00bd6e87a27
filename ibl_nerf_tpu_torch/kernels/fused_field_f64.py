"""K1 at f64 weights: the entry points of csrc/fused_field_f64.cu, and the
Python mirror of its tiles and shared-memory budget.

The kernel computes what `fused_field._field_plain_f64` computes (its
plain version) from the f64 pack of `fused_field.pack_field_weights(...,
dtype=torch.float64)`, the pack K1 at f32 weights takes in another
dtype: the same weight order, the same projection-column table, the
same launch arguments, so `fused_field._launch` launches either and
counts the launches. A block of 8 warps holds `tile_points` points (64
density, 32 full) as f64 activations in shared memory, `smem_bytes` in
all.
"""

from __future__ import annotations

import ctypes
import functools

from ibl_nerf_tpu_torch.kernels import build as _build
from ibl_nerf_tpu_torch.kernels import fused_field as ff
from ibl_nerf_tpu_torch.models.field import FieldConfig

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
MMA_K = 4            # the k depth of one mma.sync (`kMmaK` in the source)


def tile_points(density_only: bool) -> int:
    """Points of a block's tile (`Tile::kPoints` in the source)."""
    return 64 if density_only else 32


def _round_k(v: int) -> int:
    return -(-v // MMA_K) * MMA_K


def smem_bytes(cfg: FieldConfig, density_only: bool) -> int:
    """Dynamic shared memory of one block (`smem_bytes` in the source): the
    embedding plane X, H (and P for the full variant) as f64 rows of the
    tile's points at a stride of tile + 4, and the full variant's f32 raw
    sums."""
    t = tile_points(density_only)
    a, b = _round_k(cfg.input_ch), cfg.input_ch + _round_k(cfg.input_ch_views)
    x_rows = a if density_only else max(a, b)
    rows = x_rows + ff.KERNEL_WIDTH * (1 if density_only else 2)
    n_out = 9 + 3 * cfg.coarse_radiance_number
    return rows * (t + 4) * 8 + (0 if density_only else n_out * t * 4)


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
