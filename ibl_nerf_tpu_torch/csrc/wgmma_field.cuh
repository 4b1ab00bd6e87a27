// The field chain on wgmma: the kernel body that K1 at bf16 weights
// (csrc/fused_field_bf16.cu, density and full) and K2 (csrc/fused_field_train.cu,
// the full chain with or without its residual stores) run. Per point:
//   emb = where(id, t, sin(t + phase)), t = x @ E, rounded to bf16;
//   the 8-layer trunk, layer 5 reading emb and h4;
//   density: raw (N, 1) = h7 @ A[:, 0] + bias[0];
//   full:    pf = relu(h7@wpf + bpf), ft = h7@wfeat + bfeat (no relu),
//            hv = relu(ft@wv_f + emb@wv_d + bv), vf = relu(hv@wcf + bcf),
//            raw (N, 9+3K) = h7@A + pf@B + hv@C + vf@D + bias;
//   with residuals (K2): h0..h7, pf, ft, hv as (11, N, 256) bf16 planes.
// Each layer sums its bf16 bias and bf16 products in f32 (the accumulators
// start from the bias), applies relu and rounds to bf16; raw stays f32 (the
// plain versions, kernels/fused_field_train.train_forward_plain and
// field_bf16_plain, add the bias after the products).
//
// The design: every product is a warpgroup wgmma (m64nNk16, bf16 in, f32
// accumulate, both operands from shared memory), the only path to the
// tensor cores' full rate. A tile holds 128 points; a block has two
// consumer warpgroups of 64 points each and a producer warpgroup (one
// thread at work; setmaxnreg hands its registers to the consumers), and
// walks the tiles: a persistent grid of one block per SM. The weights (1.0
// MB density, 1.8 MB full, as bf16) do not fit shared memory, so they
// stream through it: the slab stream of slab_stream.cuh (density_schedule /
// forward_schedule, laid out by the caller's pack kernel once a call) is a
// 2-D tensor of 64-byte rows that the producer copies slab by slab (256 x
// 32 bf16, 16 KB) with TMA into a ring of stages, with the 64-byte swizzle,
// tracked by mbarriers (full: the copy landed; empty: all 8 consumer warps'
// products that read it retired). Every weight byte brought to an SM feeds
// both warpgroups: 128 points. A slab is one K-major B operand: a layer's
// pass reads its 256 (or 128) rows, a head the [32][32] blocks of a narrow
// slab. The activations never leave the SM but as residuals: each
// warpgroup keeps its own in shared memory as bf16 in the same swizzled
// K-major layout, the A operand of the next layer: H (h, then hv), P (pf,
// then ft, then vf) and X (emb), in k-blocks of 64 rows x 32 columns. vf
// (128 K columns) goes through P one 256-column pass at a time: the
// producer copies the full variant's stream in the consumers' order
// (`full_order`), which takes C after hv and each vf pass's slab of D right
// after the pass, so any head count the narrow slabs hold (n_out <= 32, K
// <= 7) fits the same buffers. A layer's epilogue (relu, bf16 in pairs,
// stmatrix) writes its output in place once every warp of its warpgroup has
// retired the products (a 128-thread named barrier), and fences it to the
// async proxy before the next layer's wgmma reads it. The head accumulators
// (wgmma n32, or n8 for sigma alone) stay in registers from A and B to C
// and D. Shared memory per block: density a ring of 8 stages and 2 x 48 KB
// of activations, full 4 stages and 2 x 80 KB: 230,528 and 230,464 B, one
// block per SM.
//
// The residual stores (K2's variant with residuals): once an epilogue has
// written h_i, pf, ft or hv and fenced it, lane 0 of each warp of the
// warpgroup sends two k-blocks of the buffer to its plane by TMA bulk
// stores (a tensor map on the (11, N, 256) planes with the buffers' 64-byte
// swizzle, a box of 64 rows x 32 columns per k-block), which run while the
// next layer's products do. An epilogue that overwrites a buffer in place
// first waits until the stores before it have read shared memory
// (wait_group.read), not until they reach device memory; so ft leaves P
// before vf's passes overwrite it, and hv's store, a tile's last, is read
// before the first vf pass's epilogue. The tensor map clips the ragged
// last tile's rows.
//
// sinf is not the fast-math intrinsic. The ragged last tile is masked;
// offsets are 64-bit. Deterministic: each output is one warp's fixed
// sequence of wgmma sums, no atomics; the variant without residual stores
// computes the same sums, so its raw equals the other's bit for bit.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "slab_stream.cuh"
#include "wgmma.cuh"

namespace {
namespace wgfield {

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
constexpr uint32_t kSlabBytes = kSlabElems * 2;            // 16 KB
constexpr uint32_t kBlockBytes = kRows * kSlabK * 2;       // a k-block: 64 rows x 32, 4 KB
constexpr uint32_t kNarrowBlockBytes = kNarrowN * kSlabK * 2;  // [32][32] of a narrow slab
constexpr int kHeadN = kNarrowN;                 // the full variant's head columns (n_out <= 32)
constexpr int kHBlocks = kWidth / kSlabK;        // k-blocks of H and of P
constexpr int kXBlocks = kLane / kSlabK;         // of X
constexpr int kNumRes = 11;                      // residual planes: h0..h7, pf, ft, hv
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
// (wgmma, TMA store) reads.
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

// The residual planes' side of a warpgroup: with kOn, the tensor map of the
// (11, n, 256) bf16 planes; without, nothing (the variants that store
// none). It holds no more than the map's address: every register counts
// where a layer's 128 accumulators and the heads' are live.
template <bool kOn>
struct Residuals {
  const CUtensorMap* map;

  // Before an epilogue overwrites a buffer: the stores issued so far have
  // read their shared memory (they may still be writing device memory).
  // Every thread waits, for its own stores: those that issued none pass at
  // once, and the epilogue's barrier holds them for the others.
  __device__ __forceinline__ void reads_done() const {
    if (kOn) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  // The 64 x 256 bf16 that an epilogue just wrote to `buf` (fenced to the
  // async proxy, every warp past the epilogue's barrier) into plane
  // `plane` from point `row` on, a k-block a box: lane 0 of warp w sends
  // k-blocks 2w and 2w + 1, so no warp waits long for one that issues.
  // The tensor map clips the rows past the last point (a box wholly past
  // it writes nothing).
  __device__ __forceinline__ void store(uint32_t buf, int plane, long long row) const {
    if (!kOn || (threadIdx.x & 31)) return;
    const int kb0 = (kHBlocks / 4) * ((threadIdx.x >> 5) & 3);
#pragma unroll 1
    for (int kb = kb0; kb < kb0 + kHBlocks / 4; ++kb)
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
              reinterpret_cast<uint64_t>(map)),
          "r"(kb * kSlabK), "r"(static_cast<int>(row)), "r"(plane), "r"(buf + kb * kBlockBytes)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
};

// One pass of a layer: the accumulators start from the pass's bias, take
// the products, and the epilogue stores them (once the residual stores
// before it have read their buffers).
template <int N, int NOPS, bool kRes>
__device__ __forceinline__ void layer(const Operand (&ops)[NOPS], Ring& ring, uint32_t dst,
                                      const bf16_t* __restrict__ bias, bool relu, int wg,
                                      const Residuals<kRes>& res) {
  const int t = threadIdx.x & 3;
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t b2 = ldg_here(bias + 8 * j + 2 * t);
    acc[4 * j] = acc[4 * j + 2] = lo_bf(b2);
    acc[4 * j + 1] = acc[4 * j + 3] = hi_bf(b2);
  }
  products<N, false>(acc, ops, ring, true);
  res.reads_done();
  store_layer<N>(acc, dst, relu, wg);
}

// emb of this warpgroup's 64 points (from base) into X as bf16. Thread i
// takes lanes 8 (i / 8) .. + 7 of rows i % 8 + 8 m (m < 8), so it loads its
// columns of E, id and phase once; t sums x[c] * E[c][l] over c in order.
// Points past n read as 0. A lane whose sine argument is 0 (the zero
// padding) takes it as is: sinf(±0) = ±0.
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

// The residual planes, in the order of _RES_ORDER in
// kernels/fused_field_train.py.
enum ResPlane { kResH0 = 0, kResPf = 8, kResFt = 9, kResHv = 10 };

// A consumer warpgroup: its 64 points of every tile of this block, layer
// after layer in the order of the slab stream (density_schedule in
// kernels/fused_field_train.py; forward_schedule in `full_order`). With
// kRes (full only) each of h0..h7, pf, ft and hv leaves for its residual
// plane as soon as its epilogue has written it.
template <bool kDensity, bool kRes>
__device__ __forceinline__ void consume(const Params& P, uint32_t region, Ring& ring, int wg,
                                        const CUtensorMap* res_map) {
  static_assert(!(kDensity && kRes), "the density variant stores no residuals");
  const uint32_t H = region;
  const uint32_t Pf = region + kHBlocks * kBlockBytes;  // P (full only)
  const uint32_t X = region + (kDensity ? kHBlocks : 2 * kHBlocks) * kBlockBytes;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Residuals<kRes> res{res_map};
  for (long long tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const long long base = tile * kTile + wg * kRows;
    wg_sync(wg);  // every warp is past the last tile's products: X may be rewritten
    embed_rows(X, P, base);
    fence_async_smem();
    wg_sync(wg);

    {
      const Operand ops[1] = {{X, kXBlocks}};
      layer<256>(ops, ring, H, P.tb, true, wg, res);
      res.store(H, kResH0, base);
    }
#pragma unroll 1
    for (int i = 1; i <= 7; ++i) {
      if (i == 5) {
        const Operand ops[2] = {{X, kXBlocks}, {H, kHBlocks}};
        layer<256>(ops, ring, H, P.tb + i * kWidth, true, wg, res);
      } else {
        const Operand ops[1] = {{H, kHBlocks}};
        layer<256>(ops, ring, H, P.tb + i * kWidth, true, wg, res);
      }
      res.store(H, kResH0 + i, base);
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
    layer<256>(h7, ring, Pf, P.bpf, true, wg, res);  // pf
    res.store(Pf, kResPf, base);
    float o[kHeadN / 2];
    {
      const Operand ops[2] = {{H, kHBlocks}, {Pf, kHBlocks}};
      products<kHeadN, true>(o, ops, ring, false);  // h7 @ A + pf @ B
    }
    layer<256>(h7, ring, Pf, P.bfeat, false, wg, res);  // ft, no relu
    res.store(Pf, kResFt, base);
    {
      const Operand ops[2] = {{Pf, kHBlocks}, {X, kXBlocks}};
      layer<256>(ops, ring, H, P.bv, true, wg, res);  // hv
      res.store(H, kResHv, base);
    }
    const Operand hv[1] = {{H, kHBlocks}};
    products<kHeadN, true>(o, hv, ring, true);  // + hv @ C
#pragma unroll 1
    for (int c0 = 0; c0 < P.vf_cols; c0 += kSlabN) {  // vf into P, a pass at a time
      const int cols = min(kSlabN, P.vf_cols - c0);
      if (cols == kSlabN)
        layer<256>(hv, ring, Pf, P.bcf + c0, true, wg, res);
      else
        layer<128>(hv, ring, Pf, P.bcf + c0, true, wg, res);
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
  // No store is left reading shared memory here: each tile's last store
  // (hv) is waited for by its first vf pass's epilogue. (A wait after
  // the loop would cost the whole kernel: ptxas then serializes the wgmma
  // and spills.)
}

// A kernel's body: the field over the tiles of this block. Warpgroups 0 and
// 1 consume, one thread of warpgroup 2 produces; the rest of it only hands
// its registers to the consumers. res_map: the residual planes' tensor map
// (kRes only).
template <bool kDensity, bool kRes>
__device__ __forceinline__ void field_block(const CUtensorMap* slab_map,
                                            const CUtensorMap* res_map, const Params& P) {
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
          tma_load_slab(base + stage * kSlabBytes, slab_map, s * kSlabN, full + 8 * stage);
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
  consume<kDensity, kRes>(P, regions + wg * region_blocks(kDensity) * kBlockBytes, ring, wg,
                          res_map);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The launch's parameters: wn holds kNumDw device pointers in DwIndex
// order; the full variant's stream of n_slabs slabs ends with vf's passes,
// C's narrow slab and D's.
inline Params make_params(const float* x, long long n, const Emb& emb, const void* const* wn,
                          int n_out, int vf_cols, int n_slabs, float* out) {
  auto w = [&](int i) { return static_cast<const bf16_t*>(wn[i]); };
  const int vf_passes = passes(vf_cols);
  return Params{x, n, (n + kTile - 1) / kTile, emb, w(kTb), w(kBpf), w(kBfeat),
                w(kBv), w(kBcf), w(kBias), n_out, vf_cols, n_slabs,
                n_slabs - (kHBlocks + 1) * vf_passes - 1, vf_passes, out};
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (nothing
// links the driver library); null if the driver lacks it.
inline EncodeTiled encode_tiled() {
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

// The slab stream as a 2-D tensor of 64-byte rows, copied a slab (256 rows)
// at a time with the 64-byte swizzle that the kernel's descriptors read.
inline bool encode_slab_map(CUtensorMap* map, void* slabs, int n_slabs) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kSlabK),
                              static_cast<cuuint64_t>(n_slabs) * kSlabN};
  const cuuint64_t strides[1] = {kSlabK * sizeof(bf16_t)};
  const cuuint32_t box[2] = {kSlabK, kSlabN};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, slabs, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The residual planes (kNumRes, n, kWidth) bf16 as a 3-D tensor (column,
// row, plane), stored a k-block (32 columns x 64 rows of one plane) at a
// time from the activations' 64-byte swizzled layout. Rows past n are
// clipped. Needs n < 2^31 (the row coordinate is 32-bit).
inline bool encode_res_map(CUtensorMap* map, void* res, long long n) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || n <= 0 || n > INT_MAX) return false;
  const cuuint64_t row = kWidth * sizeof(bf16_t);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kWidth), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(kNumRes)};
  const cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(n)};
  const cuuint32_t box[3] = {kSlabK, kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, res, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One persistent block per SM, at most one per tile.
inline cudaError_t persistent_grid(long long n_tiles, unsigned* grid) {
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  *grid = static_cast<unsigned>(n_tiles < sms ? n_tiles : sms);
  return cudaSuccess;
}

}  // namespace wgfield
}  // namespace
