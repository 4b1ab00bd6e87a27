"""K1 at bf16 weights: the launch of csrc/fused_field_bf16.cu, and the
Python mirror of its tiling and shared-memory layout (the kernel body of
csrc/wgmma_field.cuh, which K2 runs too).

The kernel computes what `fused_field_train.field_bf16_plain` computes
(its plain version), from the slab stream of `density_schedule` or
`forward_schedule` (kernels/fused_field_train.py), which its own pack
kernel lays out. A tile holds `TILE` points, two warpgroups of `ROWS`;
each warpgroup keeps its activations in shared memory as k-blocks of
ROWS x SLAB_K bf16 (`act_blocks`: H, then P for the full variant, then
X; vf passes through P 256 columns at a time), in the 64-byte swizzled
layout of `sw64_offset`, which a slab of the ring (SLAB_N rows) shares.
The full variant takes its stream in `stream_order`. The wrappers in
kernels/fused_field.py count its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ibl_nerf_tpu_torch.kernels import build as _build
from ibl_nerf_tpu_torch.kernels import fused_field_train as fft
from ibl_nerf_tpu_torch.kernels.fused_field import KERNEL_WIDTH

ROWS = 64            # points of a consumer warpgroup (wgmma's M)
GROUPS = 2           # consumer warpgroups of a block
TILE = ROWS * GROUPS
BLOCK_BYTES = ROWS * fft.SLAB_K * 2          # one k-block of activations
SLAB_BYTES = fft.SLAB_N * fft.SLAB_K * 2
H_BLOCKS, X_BLOCKS = KERNEL_WIDTH // fft.SLAB_K, 128 // fft.SLAB_K
HEAD_N = fft.NARROW_N  # head columns (wgmma n32): n_out <= 32, K <= 7
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
ALIGN = 1024


def act_blocks(density_only: bool) -> dict[str, tuple[int, int]]:
    """A warpgroup's activation buffers: name -> (first k-block, k-blocks)."""
    if density_only:
        return {"H": (0, H_BLOCKS), "X": (H_BLOCKS, X_BLOCKS)}
    return {"H": (0, H_BLOCKS), "P": (H_BLOCKS, H_BLOCKS), "X": (2 * H_BLOCKS, X_BLOCKS)}


def ring_stages(density_only: bool) -> int:
    return 8 if density_only else 4


def smem_bytes(density_only: bool) -> int:
    """Dynamic shared memory of one block (`smem_bytes` in the source): the
    alignment slack, the ring, both warpgroups' activations and a full and
    an empty barrier per stage."""
    stages = ring_stages(density_only)
    blocks = sum(n for _, n in act_blocks(density_only).values())
    return ALIGN + stages * SLAB_BYTES + GROUPS * blocks * BLOCK_BYTES + 16 * stages


def sw64_offset(r: int, c: int) -> int:
    """Byte offset of bf16 element (row r, column c) in a set of k-blocks of
    64-byte rows (`sw64_offset` in the source): 16-byte chunk (c % 32) // 8
    xor'd with (r // 2) % 4, the 64-byte swizzle of TMA and wgmma. A slab
    in a ring stage is one k-block of SLAB_N rows: (r, c < SLAB_K)."""
    k = fft.SLAB_K
    return (c // k) * ROWS * k * 2 + r * 64 + ((((c % k) // 8) ^ ((r >> 1) & 3)) << 4) \
        + (c % 8) * 2


def stream_order(n_slabs: int, vf_cols: int, density_only: bool) -> list[int]:
    """The stream's slabs in the order the producer copies them in a tile
    (`full_order` in the source). Density: as laid out. Full: the stream
    of `forward_schedule` up to hv, then C's narrow slab, then each vf
    pass's H_BLOCKS slabs followed by its narrow slab of D (which covers
    one pass: NARROW_K == SLAB_N), so vf needs one 256-column buffer."""
    if density_only:
        return list(range(n_slabs))
    passes = -(-vf_cols // fft.SLAB_N)
    vf_first = n_slabs - (H_BLOCKS + 1) * passes - 1
    c = vf_first + H_BLOCKS * passes
    order = list(range(vf_first)) + [c]
    for p in range(passes):
        order += list(range(vf_first + H_BLOCKS * p, vf_first + H_BLOCKS * (p + 1))) + [c + 1 + p]
    return order


def check(x: torch.Tensor, w16: dict, emb: dict, density_only: bool) -> None:
    """Raise ValueError for inputs the kernel does not take: those of K2's
    check, and more than 7 coarse heads (the heads' columns must fit one
    narrow slab)."""
    fft._check(x, w16, emb, w16["bias"].shape[0])
    if w16["bias"].shape[0] > HEAD_N:
        raise ValueError(f"the bf16 kernel takes at most {(HEAD_N - 9) // 3} coarse heads")


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of `fused_field_bf16_launch` and `fused_field_bf16_occupancy`
LAUNCH_ARGS = [_p, _ll, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p, _i, _p, _i, _p, _p]
OCCUPANCY_ARGS = [_i, ctypes.POINTER(_i), ctypes.POINTER(_ll)]


@functools.cache
def _entries():
    """The entry points of csrc/fused_field_bf16.cu, built on first use:
    the launcher and the occupancy query."""
    lib = _build.load("fused_field_bf16")
    launch, occ = lib.fused_field_bf16_launch, lib.fused_field_bf16_occupancy
    launch.restype, launch.argtypes = ctypes.c_int, LAUNCH_ARGS
    occ.restype, occ.argtypes = ctypes.c_int, OCCUPANCY_ARGS
    return launch, occ


def launch(x: torch.Tensor, w16: dict, emb: dict, density_only: bool) -> torch.Tensor:
    """The kernel on CUDA tensors: raw (N, 1) or (N, 9+3K) f32 from the
    (N, 8) input, the bf16 packed weights and the f32 embedding
    constants."""
    check(x, w16, emb, density_only)
    n, n_out = x.shape[0], w16["bias"].shape[0]
    schedule = fft.density_schedule if density_only else fft.forward_schedule
    sched, n_slabs = schedule(fft._shapes(w16))
    out = torch.empty((n, 1 if density_only else n_out), dtype=torch.float32,
                      device=x.device)
    slabs = torch.empty(n_slabs * fft.SLAB_N * fft.SLAB_K, dtype=torch.bfloat16,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = _entries()[0](
            x.data_ptr(), n, emb["E"].data_ptr(), emb["phase"].data_ptr(),
            emb["id"].data_ptr(), fft._ptrs([w16[k].data_ptr() for k in fft._DW_ORDER]),
            len(fft._DW_ORDER), KERNEL_WIDTH, n_out, w16["wcf"].shape[1], int(density_only),
            ctypes.cast(fft._slab_table(sched), ctypes.c_void_p), len(sched),
            slabs.data_ptr(), n_slabs, out.data_ptr(), fft._stream(x.device))
    if err != 0:
        raise RuntimeError(f"fused_field bf16 kernel launch failed: error {err}")
    return out


def occupancy(density_only: bool) -> dict[str, int]:
    """Dynamic shared memory per block and the blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), current device."""
    blocks, smem = ctypes.c_int(), ctypes.c_longlong()
    err = _entries()[1](int(density_only), ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"fused_field bf16 occupancy query failed: error {err}")
    return {"smem_bytes_per_block": smem.value, "blocks_per_sm": blocks.value}
