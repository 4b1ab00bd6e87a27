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
// What the design does about it: every product is a warpgroup wgmma
// (m64nNk16, bf16 in, f32 accumulate, both operands from shared memory),
// the only path to the tensor cores' full rate. A tile holds 128 points; a
// block has two consumer warpgroups of 64 points each and a producer
// warpgroup (one thread at work; setmaxnreg hands its registers to the
// consumers), and walks the tiles: a persistent grid of one block per SM.
// The weights (1.0 MB density, 1.8 MB full, as bf16) do not fit shared
// memory, so they stream through it: the slab stream of slab_stream.cuh
// (density_schedule / forward_schedule, laid out by k1_bf16_pack_slabs once
// a call) is a 2-D tensor of 64-byte rows that the producer copies slab by
// slab (256 x 32 bf16, 16 KB) with TMA into a ring of stages, with the
// 64-byte swizzle, tracked by mbarriers (full: the copy landed; empty: all
// 8 consumer warps' products that read it retired). Every weight byte
// brought to an SM feeds both warpgroups: 128 points. A slab is one K-major
// B operand: a layer's pass reads its 256 (or 128) rows, a head the
// [32][32] blocks of a narrow slab. The activations never leave the SM:
// each warpgroup keeps its own in shared memory as bf16 in the same
// swizzled K-major layout, the A operand of the next layer: H (h, then hv),
// P (pf, then ft, then vf) and X (emb), in k-blocks of 64 rows x 32
// columns. vf (128 K columns) goes through P one 256-column pass at a
// time: the producer copies the full variant's stream in the consumers'
// order (`full_order`), which takes C after hv and each vf pass's slab of
// D right after the pass, so any head count the narrow slabs hold (n_out
// <= 32, K <= 7) fits the same buffers. A layer's accumulators start from
// its bias; its epilogue (relu, bf16 in pairs, stmatrix) writes its output
// in place once every warp of its warpgroup has retired the products (a
// 128-thread named barrier), and fences it to the async proxy before the
// next layer's wgmma reads it. The head accumulators (wgmma n32, or n8 for
// sigma alone) stay in registers from A and B to C and D. Shared memory
// per block: density a ring of 8 stages and 2 x 48 KB of
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

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "slab_stream.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;                        // points of a consumer warpgroup (wgmma's M)
constexpr int kGroups = 2;                       // consumer warpgroups
constexpr int kTile = kRows * kGroups;           // points of a tile
constexpr int kConsumerWarps = 4 * kGroups;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // and the producer warpgroup
// Registers a thread of a consumer / the producer warpgroup holds after
// setmaxnreg: at 384 threads a block starts at 168 each (65,536 / 384);
// the producer gives 144 of them back and each consumer takes 72. ptxas
// reports 168 either way; without setmaxnreg the full variant spills and
// the kernel is 30% slower (k3_knockout.py k1bf16).
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kPackThreads = 256;
constexpr uint32_t kSlabBytes = kSlabElems * 2;            // 16 KB
constexpr uint32_t kBlockBytes = kRows * kSlabK * 2;       // a k-block: 64 rows x 32, 4 KB
constexpr uint32_t kNarrowBlockBytes = kNarrowN * kSlabK * 2;  // [32][32] of a narrow slab
constexpr int kHeadN = kNarrowN;                 // the full variant's head columns (n_out <= 32)
constexpr int kHBlocks = kWidth / kSlabK;        // k-blocks of H and of P
constexpr int kXBlocks = kLane / kSlabK;         // of X
static_assert(kNarrowK == kSlabN, "a narrow slab of D covers one vf pass");
constexpr uint32_t kAlign = 1024;                // of the ring and the activations

// A warpgroup's activations: H, then (full) P, then X.
__host__ __device__ constexpr int region_blocks(bool density) {
  return density ? kHBlocks + kXBlocks : 2 * kHBlocks + kXBlocks;
}
__host__ __device__ constexpr int ring_stages(bool density) { return density ? 8 : 4; }
// Dynamic shared memory a block asks for: the ring, the activations of both
// warpgroups, a full and an empty barrier per stage, and the slack that
// aligns the ring to kAlign.
__host__ __device__ constexpr uint32_t smem_bytes(bool density) {
  return kAlign + ring_stages(density) * kSlabBytes +
         kGroups * region_blocks(density) * kBlockBytes + 2 * 8 * ring_stages(density);
}
static_assert(smem_bytes(true) <= 232448 && smem_bytes(false) <= 232448,
              "a block must fit the card's shared memory");

// The byte offset of element (r, c) in a warpgroup's activations: k-block
// c / 32, row r of 64 bytes, its 16-byte chunks swizzled as TMA's and
// wgmma's 64-byte mode (address bits 4-5 xor bits 7-8) for k-blocks on
// 512-byte boundaries. A slab of the ring has the same layout, 256 rows.
__host__ __device__ constexpr uint32_t sw64_offset(int r, int c) {
  return (c / kSlabK) * kBlockBytes + r * 64 + ((((c % kSlabK) / 8) ^ ((r >> 1) & 3)) << 4) +
         (c % 8) * 2;
}

// A K-major operand with the 64-byte swizzle at shared address `addr`: 8-row
// groups 512 bytes apart (the leading offset is unused in this mode).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{512 >> 4} << 32) | (uint64_t{2} << 62);
}

// Read-only loads that stay where they are written: the embedding's
// constants and the biases are the same for every tile, and the compiler
// may hoist plain __ldg loads of them out of the tile loop (with __ldg the
// kernel is 1-2% slower, k3_knockout.py k1bf16).
__device__ __forceinline__ float4 ldg_here(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ldg_here(const bf16_t* p) {  // two bf16
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ldg_bf16_here(const bf16_t* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return bf2f(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float lo_bf(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  return static_cast<uint32_t>(f2bf(lo)) | (static_cast<uint32_t>(f2bf(hi)) << 16);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Until the phase of `bar` with this parity has completed. A wait that
// outlasts any schedule (2^28 polls, seconds) is a broken pipeline: trap,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}
// One slab (rows row0.. of the stream's tensor map) into shared memory at
// dst; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_slab(uint32_t dst, const CUtensorMap* map, int row0,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row0), "r"(bar)
      : "memory");
}
// The warpgroup's 128 threads (named barrier 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
// Generic-proxy stores to shared memory, ordered before later async-proxy
// (wgmma) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across this
// point (after the wait that retires the products writing them).
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct Params {
  const float* x;  // (n, 8) f32
  long long n, n_tiles;
  Emb emb;
  const bf16_t *tb, *bpf, *bfeat, *bv, *bcf, *bias;
  int n_out, vf_cols, n_slabs;
  int vf_first, vf_passes;  // full: the stream's first vf slab, vf's passes
  float* out;  // (n, 1) or (n, n_out) f32
};

// The stream slab that the full variant's consumers take i-th in a tile.
// The stream (forward_schedule) holds hv's slabs, vf's passes of kHBlocks
// slabs each, C's narrow slab, then D's, one per vf pass. The consumers
// take C after hv, then each vf pass followed by its slab of D.
__device__ __forceinline__ int full_order(int i, int vf_first, int vf_passes) {
  if (i < vf_first) return i;
  const int c = vf_first + kHBlocks * vf_passes;  // C's slab
  if (i == vf_first) return c;
  const int j = i - vf_first - 1, p = j / (kHBlocks + 1), s = j % (kHBlocks + 1);
  return s < kHBlocks ? vf_first + kHBlocks * p + s : c + 1 + p;
}

// The consumers' side of the ring: the stage whose slab comes next, and the
// parity of its full barrier's phase.
struct Ring {
  uint32_t slabs, full, empty;  // shared addresses: stage 0, the barrier arrays
  int stages, stage;
  uint32_t phase;

  // The next slab, once it has landed: (its shared address, its stage).
  __device__ __forceinline__ uint32_t wait(int& st) {
    mbar_wait(full + 8 * stage, phase);
    st = stage;
    const uint32_t s = slabs + stage * kSlabBytes;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
    return s;
  }
  // Stage st may be refilled as far as this warp is concerned.
  __device__ __forceinline__ void release(int st) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * st);
  }
};

// One summand of a layer: A is k_blocks k-blocks of this warpgroup's
// activations from shared address a.
struct Operand {
  uint32_t a;
  int k_blocks;
};

// acc = (acc if accumulate) + sum over the operands of A @ B, with B from
// the ring: a layer's pass takes one slab per k-block (its first N rows), a
// head one narrow slab per kNarrowK / kSlabK k-blocks of an operand, block
// after block. A slab's products form one wgmma group; the slab is released
// once the group after it is issued and it has retired (wait_group 1), the
// last one after wait_group 0.
template <int N, bool kNarrow, int NOPS>
__device__ __forceinline__ void products(float (&acc)[N / 2], const Operand (&ops)[NOPS],
                                         Ring& ring, bool accumulate) {
  constexpr int kPerSlab = kNarrow ? kNarrowK / kSlabK : 1;
  int held = -1;
  int scale = accumulate ? 1 : 0;
#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
#pragma unroll 1
    for (int kb0 = 0; kb0 < ops[o].k_blocks; kb0 += kPerSlab) {
      int st;
      const uint32_t b = ring.wait(st);
      const int kb1 = min(kb0 + kPerSlab, ops[o].k_blocks);
      wgmma_fence();
#pragma unroll 1
      for (int kb = kb0; kb < kb1; ++kb) {
        const uint32_t a = ops[o].a + kb * kBlockBytes;
        const uint32_t bb = kNarrow ? b + (kb - kb0) * kNarrowBlockBytes : b;
        Wgmma<N>::mma(acc, sw64_desc(a), sw64_desc(bb), scale);
        Wgmma<N>::mma(acc, sw64_desc(a + 32), sw64_desc(bb + 32), 1);
        scale = 1;
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0) ring.release(held);
      held = st;
    }
  }
  wgmma_wait<0>();
  ring.release(held);
  fence_acc(acc);
}

// A layer's pass of N columns into dst's first N columns: v = acc (which
// started from the bias), relu unless told not to, rounded to bf16 in
// pairs, each warp its own 16 rows, in place once every warp of the
// warpgroup has retired its products.
template <int N>
__device__ __forceinline__ void store_layer(const float (&acc)[N / 2], uint32_t dst, bool relu,
                                            int wg) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  // stmatrix x4 stores four 8x8 bf16 matrices from the accumulator pairs:
  // rows 0-7 and 8-15 of this warp for the n8 blocks j and j + 1; lane l
  // names row l % 8 of matrix l / 8
  const int m = lane >> 3, r = 16 * warp + (lane & 7) + 8 * (m & 1), mh = m >> 1;
  const int sw = (r >> 1) & 3;  // column 8j of the pass: k-block j / 4, chunk (j % 4) ^ sw
  const uint32_t row = dst + r * 64;
  wg_sync(wg);
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    uint32_t pk[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jj = j + q / 2, h = q % 2;
      const float v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
      if (relu)
        asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(pk[q]) : "f"(v1), "f"(v0));
      else
        asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(pk[q]) : "f"(v1), "f"(v0));
    }
    const uint32_t addr = row + (j / 4) * kBlockBytes + ((((j % 4) + mh) ^ sw) << 4);
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(pk[0]), "r"(pk[1]), "r"(pk[2]), "r"(pk[3])
                 : "memory");
  }
  fence_async_smem();
  wg_sync(wg);
}

// One pass of a layer: the accumulators start from the pass's bias, take
// the products, and the epilogue stores them.
template <int N, int NOPS>
__device__ __forceinline__ void layer(const Operand (&ops)[NOPS], Ring& ring, uint32_t dst,
                                      const bf16_t* __restrict__ bias, bool relu, int wg) {
  const int t = threadIdx.x & 3;
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t b2 = ldg_here(bias + 8 * j + 2 * t);
    acc[4 * j] = acc[4 * j + 2] = lo_bf(b2);
    acc[4 * j + 1] = acc[4 * j + 3] = hi_bf(b2);
  }
  products<N, false>(acc, ops, ring, true);
  store_layer<N>(acc, dst, relu, wg);
}

// emb of this warpgroup's 64 points (from base) into X as bf16. Thread i
// takes lanes 8 (i / 8) .. + 7 of rows i % 8 + 8 m (m < 8), so it loads its
// columns of E, id and phase once; t sums x[c] * E[c][l] over c in order,
// as K2 does. Points past n read as 0. A lane whose sine argument is 0 (the
// zero padding) takes it as is: sinf(±0) = ±0.
__device__ __forceinline__ void embed_rows(uint32_t X, const Params& P, long long base) {
  const int tid = threadIdx.x & 127, l0 = (tid >> 3) * 8, r0 = tid & 7;
  float e[kInCols][8], id[8], ph[8];
#pragma unroll
  for (int c = 0; c < kInCols; ++c) {
    const float4 e0 = ldg_here(P.emb.E + c * kLane + l0);
    const float4 e1 = ldg_here(P.emb.E + c * kLane + l0 + 4);
    e[c][0] = e0.x, e[c][1] = e0.y, e[c][2] = e0.z, e[c][3] = e0.w;
    e[c][4] = e1.x, e[c][5] = e1.y, e[c][6] = e1.z, e[c][7] = e1.w;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 a = ldg_here(P.emb.id + l0 + 4 * h);
    const float4 b = ldg_here(P.emb.phase + l0 + 4 * h);
    id[4 * h] = a.x, id[4 * h + 1] = a.y, id[4 * h + 2] = a.z, id[4 * h + 3] = a.w;
    ph[4 * h] = b.x, ph[4 * h + 1] = b.y, ph[4 * h + 2] = b.z, ph[4 * h + 3] = b.w;
  }
#pragma unroll 1
  for (int m = 0; m < kRows / 8; ++m) {
    const int r = r0 + 8 * m;
    const long long p = base + r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (p < P.n) {
      a = __ldg(reinterpret_cast<const float4*>(P.x + p * kInCols));
      b = __ldg(reinterpret_cast<const float4*>(P.x + p * kInCols + 4));
    }
    const float xv[kInCols] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int l = 2 * q + k;
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < kInCols; ++c) u = fmaf(xv[c], e[c][l], u);
        const float arg = u + ph[l];
        v[k] = id[l] > 0.f ? u : (arg == 0.f ? arg : sinf(arg));
      }
      w[q] = pack_bf2(v[0], v[1]);
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(X + sw64_offset(r, l0)),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// A consumer warpgroup: its 64 points of every tile of this block, layer
// after layer in the order of the slab stream (density_schedule in
// kernels/fused_field_train.py; forward_schedule in `full_order`).
template <bool kDensity>
__device__ __forceinline__ void consume(const Params& P, uint32_t region, Ring& ring, int wg) {
  const uint32_t H = region;
  const uint32_t Pf = region + kHBlocks * kBlockBytes;  // P (full only)
  const uint32_t X = region + (kDensity ? kHBlocks : 2 * kHBlocks) * kBlockBytes;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (long long tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const long long base = tile * kTile + wg * kRows;
    wg_sync(wg);  // every warp is past the last tile's products: X may be rewritten
    embed_rows(X, P, base);
    fence_async_smem();
    wg_sync(wg);

    {
      const Operand ops[1] = {{X, kXBlocks}};
      layer<256>(ops, ring, H, P.tb, true, wg);
    }
#pragma unroll 1
    for (int i = 1; i <= 7; ++i) {
      if (i == 5) {
        const Operand ops[2] = {{X, kXBlocks}, {H, kHBlocks}};
        layer<256>(ops, ring, H, P.tb + i * kWidth, true, wg);
      } else {
        const Operand ops[1] = {{H, kHBlocks}};
        layer<256>(ops, ring, H, P.tb + i * kWidth, true, wg);
      }
    }
    const Operand h7[1] = {{H, kHBlocks}};
    if (kDensity) {
      float o[4];
      products<8, true>(o, h7, ring, false);  // h7 @ A[:, 0:8]
      if (t == 0) {                           // column 0: o[0] (row g), o[2] (row g + 8)
        const float b = ldg_bf16_here(P.bias);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long p = base + 16 * warp + g + 8 * h;
          if (p < P.n) P.out[p] = o[2 * h] + b;
        }
      }
      continue;
    }
    layer<256>(h7, ring, Pf, P.bpf, true, wg);  // pf
    float o[kHeadN / 2];
    {
      const Operand ops[2] = {{H, kHBlocks}, {Pf, kHBlocks}};
      products<kHeadN, true>(o, ops, ring, false);  // h7 @ A + pf @ B
    }
    layer<256>(h7, ring, Pf, P.bfeat, false, wg);  // ft, no relu
    {
      const Operand ops[2] = {{Pf, kHBlocks}, {X, kXBlocks}};
      layer<256>(ops, ring, H, P.bv, true, wg);  // hv
    }
    const Operand hv[1] = {{H, kHBlocks}};
    products<kHeadN, true>(o, hv, ring, true);  // + hv @ C
#pragma unroll 1
    for (int c0 = 0; c0 < P.vf_cols; c0 += kSlabN) {  // vf into P, a pass at a time
      const int cols = min(kSlabN, P.vf_cols - c0);
      if (cols == kSlabN)
        layer<256>(hv, ring, Pf, P.bcf + c0, true, wg);
      else
        layer<128>(hv, ring, Pf, P.bcf + c0, true, wg);
      const Operand vf[1] = {{Pf, cols / kSlabK}};
      products<kHeadN, true>(o, vf, ring, true);  // + vf @ D, the pass's rows
    }
#pragma unroll
    for (int j = 0; j < kHeadN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const long long p = base + 16 * warp + g + 8 * (e >> 1);
        if (c < P.n_out && p < P.n)
          P.out[p * P.n_out + c] = o[4 * j + e] + ldg_bf16_here(P.bias + c);
      }
  }
}

// The field over the tiles of this block: warpgroups 0 and 1 consume, one
// thread of warpgroup 2 produces; the rest of it only hands its registers
// to the consumers.
template <bool kDensity>
__global__ void __launch_bounds__(kThreads, 1)
    k1_bf16_field(const __grid_constant__ CUtensorMap slab_map, const Params P) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kStages = ring_stages(kDensity);
  const uint32_t base = (smem_addr(smem_raw) + kAlign - 1) & ~(kAlign - 1);
  const uint32_t regions = base + kStages * kSlabBytes;
  const uint32_t full = regions + kGroups * region_blocks(kDensity) * kBlockBytes;
  const uint32_t empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kGroups) {  // the producer: one thread streams every tile's slabs
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 32 * kConsumerWarps) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x)
        for (int i = 0; i < P.n_slabs; ++i) {
          const int s = kDensity ? i : full_order(i, P.vf_first, P.vf_passes);
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, kSlabBytes);
          tma_load_slab(base + stage * kSlabBytes, &slab_map, s * kSlabN, full + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Ring ring{base, full, empty, kStages, 0, 0u};
  consume<kDensity>(P, regions + wg * region_blocks(kDensity) * kBlockBytes, ring, wg);
}

// The weights, slab after slab (1.0 MB density, 1.8 MB full).
__global__ void __launch_bounds__(kPackThreads)
    k1_bf16_pack_slabs(SlabOps ops, bf16_t* __restrict__ slabs) {
  pack_slab(ops.o[blockIdx.y], slabs);
}

// Slabs the density variant consumes: the trunk's, then the head A.
int density_slab_count() { return trunk_slab_count() + narrow_slabs(kWidth); }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (nothing
// links the driver library); null if the driver lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

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

  // the stream as a 2-D tensor of 64-byte rows, copied a slab (256 rows)
  // at a time with the 64-byte swizzle that the kernel's descriptors read
  const EncodeTiled encode = encode_tiled();
  if (!encode) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kSlabK),
                              static_cast<cuuint64_t>(n_slabs) * kSlabN};
  const cuuint64_t strides[1] = {kSlabK * sizeof(bf16_t)};
  const cuuint32_t box[2] = {kSlabK, kSlabN};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, slabs, dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -2;

  auto w = [&](int i) { return static_cast<const bf16_t*>(wn[i]); };
  const int vf_passes = passes(vf_cols);
  const Params P{x, n, n_tiles, Emb{emb_E, emb_phase, emb_id}, w(kTb), w(kBpf), w(kBfeat),
                 w(kBv), w(kBcf), w(kBias), n_out, vf_cols, n_slabs,
                 n_slabs - (kHBlocks + 1) * vf_passes - 1, vf_passes, out};
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_tiles < sms ? n_tiles : sms);
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
