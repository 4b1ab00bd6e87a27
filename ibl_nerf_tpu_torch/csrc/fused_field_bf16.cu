// K1 at bf16 weights: the fused IBL-NeRF field query (no gradient) with
// bf16 packed weights, for Hopper (sm_90a).
//
// Replaces ibl_nerf_tpu/kernels/fused_field.py::_field_kernel (the Pallas
// TPU kernel reached by pl.pallas_call in _fused_call, :261) when its packed
// weights are bf16 (`dt = w["w0"].dtype`, :209), as the renderer packs them
// for the no-grad sweeps under compute_dtype bfloat16 and mixed. Per point:
//   emb = where(id, t, sin(t + phase)), t = x @ E, rounded to bf16;
//   the 8-layer trunk, layer 5 reading emb and h4;
//   density: raw (N, 1) = h7 @ A[:, 0] + bias[0];
//   full:    pf = relu(h7@wpf + bpf), ft = h7@wfeat + bfeat (no relu),
//            hv = relu(ft@wv_f + emb@wv_d + bv), vf = relu(hv@wcf + bcf),
//            raw (N, 9+3K) = h7@A + pf@B + hv@C + vf@D + bias.
// Each layer sums its bf16 bias and bf16 products in f32, applies relu and
// rounds to bf16; raw stays f32 (the plain version is
// kernels/fused_field_train.field_bf16_plain, which adds the bias after the
// products).
//
// What bounds it: operations. A point costs 0.98 MFLOP (density) or 1.59
// MFLOP (full, K=3) against 36 or 104 bytes of input and output, ~10^4
// operations a byte, far above the ~295 at which the bf16 tensor cores (989
// TFLOP/s) overtake device memory (3.35 TB/s). The ε sweep of a 2048-ray
// chunk (1,572,864 points) needs at least 1.56 ms.
//
// What the design does about it: the kernel body is the wgmma field chain
// of csrc/wgmma_field.cuh, which K2 (csrc/fused_field_train.cu) runs too:
// the full variant here is K2's variant without residual stores. Every
// product is a warpgroup wgmma (m64nNk16, bf16 in, f32 accumulate, both
// operands from shared memory) over 128-point tiles held by two consumer
// warpgroups; the weights stream slab by slab through a TMA ring tracked
// by mbarriers (laid out by k1_bf16_pack_slabs once a call), fed by a
// producer warpgroup under setmaxnreg; the activations stay in shared
// memory as swizzled K-major bf16; a persistent grid of one block per SM.
// Shared memory per block: density a ring of 8 stages and 2 x 48 KB of
// activations, full 4 stages and 2 x 80 KB: 230,528 and 230,464 B, one
// block per SM; 168 registers a thread, no spills.
//
// On an NVIDIA H100 80GB HBM3 at a 700 W power limit (k3_knockout.py
// k1bf16): density 3.28 ms at 1,572,864 points (48% of the bf16 peak),
// full 0.52 ms at 131,072. The density kernel holds the card at its power
// limit (median 694 W, SM clock 1,845 MHz against 1,980); the weight copies
// are hidden (without them 2% faster), the epilogues and the sines are
// not (PERF.md).
//
// sinf is not the fast-math intrinsic. The ragged last tile is masked;
// offsets are 64-bit. Deterministic: each output is one warp's fixed
// sequence of wgmma sums, no atomics.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "wgmma_field.cuh"

namespace {

using namespace wgfield;

constexpr int kPackThreads = 256;

// The field over the tiles of this block (wgmma_field.cuh's field_block).
template <bool kDensity>
__global__ void __launch_bounds__(kThreads, 1)
    k1_bf16_field(const __grid_constant__ CUtensorMap slab_map, const Params P) {
  field_block<kDensity, false>(&slab_map, nullptr, P);
}

// The weights, slab after slab (1.0 MB density, 1.8 MB full).
__global__ void __launch_bounds__(kPackThreads)
    k1_bf16_pack_slabs(SlabOps ops, bf16_t* __restrict__ slabs) {
  pack_slab(ops.o[blockIdx.y], slabs);
}

// Slabs the density variant consumes: the trunk's, then the head A.
int density_slab_count() { return trunk_slab_count() + narrow_slabs(kWidth); }

template <bool kDensity>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(k1_bf16_field<kDensity>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(kDensity)));
}

}  // namespace

// Launches K1 at bf16 weights on `stream`, two kernels in order:
//   k1_bf16_pack_slabs  the weights into `slabs` (n_slabs slabs), per slab
//                       op {weight index in DwIndex order, trans, n, k,
//                       first, stride}: forward_schedule's stream, or with
//                       density_only density_schedule's;
//   k1_bf16_field       out (n, n_out) f32, or with density_only (n, 1),
//                       one block per SM (at most one per tile).
// wn: kNumDw device pointers in DwIndex order, as packed ([in][out]). Both
// variants take n_out <= 32 (K <= 7), the full one vf_cols a multiple of
// 128.
// Returns 0, a cudaError_t, -1 for arguments the kernels do not take, or -2
// when the driver cannot encode the slab stream's tensor map.
extern "C" int fused_field_bf16_launch(
    const float* x, long long n, const float* emb_E, const float* emb_phase,
    const float* emb_id, const void* const* wn, int n_weights, int width, int n_out,
    int vf_cols, int density_only, const int* slab_ops, int n_slab_ops, void* slabs,
    int n_slabs, float* out, void* stream) {
  const Dims d{n_out, vf_cols};
  SlabOps so;
  int max_slabs;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_weights != kNumDw || width != kWidth || n < 0 || n_tiles > INT_MAX || n_out <= 0 ||
      n_out > kHeadN || (!density_only && (vf_cols <= 0 || vf_cols % 128)) ||
      n_slabs != (density_only ? density_slab_count() : forward_slab_count(d)) ||
      !read_slab_ops(slab_ops, n_slab_ops, wn, n_slabs, so, max_slabs) ||
      reinterpret_cast<uintptr_t>(slabs) % 16 || reinterpret_cast<uintptr_t>(x) % 16)
    return -1;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k1_bf16_pack_slabs<<<dim3(max_slabs, n_slab_ops), kPackThreads, 0, s>>>(
      so, static_cast<bf16_t*>(slabs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap map;
  if (!encode_slab_map(&map, slabs, n_slabs)) return -2;
  const Params P = make_params(x, n, Emb{emb_E, emb_phase, emb_id}, wn, n_out, vf_cols,
                               n_slabs, out);
  unsigned grid;
  if ((err = persistent_grid(n_tiles, &grid)) != cudaSuccess) return static_cast<int>(err);
  err = density_only ? set_smem<true>() : set_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (density_only)
    k1_bf16_field<true><<<grid, kThreads, smem_bytes(true), s>>>(map, P);
  else
    k1_bf16_field<false><<<grid, kThreads, smem_bytes(false), s>>>(map, P);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of one block of the density (or full) variant
// and the blocks of it an SM holds at once, on the current device.
extern "C" int fused_field_bf16_occupancy(int density_only, int* blocks, long long* smem) {
  cudaError_t err = density_only ? set_smem<true>() : set_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = smem_bytes(density_only);
  err = density_only
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k1_bf16_field<true>,
                                                            kThreads, *smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k1_bf16_field<false>,
                                                            kThreads, *smem);
  return static_cast<int>(err);
}
