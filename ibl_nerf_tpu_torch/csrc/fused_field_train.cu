// K2 and K3: the fused IBL-NeRF training field query, forward and backward,
// for Hopper (sm_90a).
//
// Replaces ibl_nerf_tpu/kernels/fused_field_train.py::_fwd_kernel (K2, the
// Pallas TPU kernel reached by pl.pallas_call in _fwd_call) and
// ::_bwd_kernel (K3, pl.pallas_call in _bwd_call), the two halves of the
// custom_vjp fused_field_train. Weights are bf16, the embedding constants
// f32; every product has bf16 operands and f32 accumulation.
//
// K2, per point: emb = where(id, t, sin(t + phase)), t = x @ E, rounded to
// bf16; the 8-layer trunk (layer 5 reads emb and h4); pf = relu(h@wpf+bpf),
// ft = h@wfeat+bfeat, hv = relu(ft@wv_f + emb@wv_d + bv), vf = relu(hv@wcf +
// bcf); each layer sums in f32, adds its bias, applies relu and rounds to
// bf16. raw = h@A + pf@B + hv@C + vf@D + bias stays f32, (N, 9+3K). It also
// writes the 11 residuals h0..h7, pf, ft, hv as bf16 (N, 256) planes.
//
// K3 recomputes emb and vf, replays the reverse chain (relu masks from the
// saved bf16 activations, g rounded to bf16) and reduces the 24 weight and
// bias gradients over the points in f32. It returns no gradient for x.
//
// What bounds them: at 8x256 a point costs ~1.6 MFLOP forward and ~3.3
// MFLOP backward but moves ~5.7 KB (mostly the residuals), ~280 and ~580
// operations per byte: at the bf16 tensor-core rate (989 TFLOP/s) over
// 3.35 TB/s (~295 per byte) K2 sits at the ridge and K3 just above it. At
// the fine pass (98,304 points) K2's bound is 0.169 ms (0.566 GB: x, raw
// and the residuals) and its design floor 0.170 ms (the same bytes, plus
// its weight stream written once and read once).
//
// What the design does about it: every product runs on the tensor cores as
// warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate). A block owns 64
// points and keeps their activations on chip, bf16 in shared memory, rows
// padded by 8 so that the fragment loads of a warp hit 32 distinct banks.
// Weights (1.7 MB bf16, far more than shared memory) are packed once a call
// into slabs laid out in the order a kernel consumes them (k2_pack_slabs,
// k3_pack_slabs) and stream through a ring of slabs in shared memory
// (cp.async), shared by all 8 warps, from which ldmatrix hands the tensor
// cores their B fragments. K2 is one such chain of layers, K3's stage 1
// another. The residuals and deltas leave shared memory as 16-byte row
// stores. What still holds the chains above their floors on this card is
// issuing mma.sync at one block per SM and the cost of each slab (PERF.md).
//
// The TPU kernel accumulated all 24 gradients across a sequential grid in
// VMEM. Blocks here run in parallel, so K3 is split in two stages:
//   k3_pack_slabs   lays the chain's weights out as slabs (~1.7 MB);
//   k3_delta_chain  per 64-point tile: the reverse chain; writes emb, bf16
//                   g, vf and the 12 deltas (bf16, as the TPU kernel rounds
//                   them) to device memory;
//   k3_dw_gemm      dW = act^T @ delta for the 18 weight matrices and the
//                   bias sums in the same pass, 128-wide output tiles, the
//                   points split into `splits` ranges, each range writing
//                   its own f32 partial; operands staged by cp.async;
//   k3_reduce       sums the partials in a fixed order. Deterministic: no
//                   atomics, two runs give the same bits. dW stays f32.
// The two-stage design cannot beat its own traffic in device memory: the
// chain writes 15 delta planes that the dW stage reads back (PERF.md, the
// design floor); what holds each stage above it on this card is noted at
// the stage. The ragged last tile is masked in every kernel; offsets are
// 64-bit; sinf without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "slab_stream.cuh"

namespace {

constexpr int kTile = 64;        // points per block of K2 and the delta chain
constexpr int kThreads = 256;    // 8 warps
constexpr int kPad = 8;          // bf16 of padding per shared-memory row
constexpr int kLdX = kLane + kPad;
constexpr int kLdH = kWidth + kPad;
constexpr int kGCols = 32;       // g (9+3K columns) padded to a k multiple of 16
constexpr int kLdG = kGCols + kPad;

// Same order as _RES_ORDER.
enum ResIndex { kH0 = 0, kH7 = 7, kPf = 8, kFt = 9, kHv = 10 };
// Same order as _DELTA_ORDER.
enum DeltaIndex {
  kX, kG16, kVf, kDvf, kDhv, kDft, kDpf,
  kD7, kD6, kD5, kD4, kD3, kD2, kD1, kD0,
  kNumDeltas
};

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Rows [base, base + 64) of a (n, cols) bf16 plane from a shared tile
// (cols a multiple of 8, rows 16-byte aligned), rows >= n skipped.
__device__ __forceinline__ void store_tile(bf16_t* __restrict__ dst, int cols,
                                           const bf16_t* src, int lds,
                                           long long base, long long n) {
  const int vecs = cols / 8;
  for (int idx = threadIdx.x; idx < kTile * vecs; idx += kThreads) {
    const int r = idx / vecs, v = idx % vecs;
    const long long p = base + r;
    if (p < n)
      *reinterpret_cast<uint4*>(dst + p * cols + v * 8) =
          *reinterpret_cast<const uint4*>(src + r * lds + v * 8);
  }
}

// The reverse of store_tile; rows >= n read as 0.
__device__ __forceinline__ void load_tile(bf16_t* dst, int ldd,
                                          const bf16_t* __restrict__ src,
                                          int cols, long long base,
                                          long long n) {
  const int vecs = cols / 8;
  for (int idx = threadIdx.x; idx < kTile * vecs; idx += kThreads) {
    const int r = idx / vecs, v = idx % vecs;
    const long long p = base + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < n) val = __ldg(reinterpret_cast<const uint4*>(src + p * cols + v * 8));
    *reinterpret_cast<uint4*>(dst + r * ldd + v * 8) = val;
  }
}

// emb(x) for lane l of point p (x = [pts | dirs | 0], f32).
__device__ __forceinline__ float embed(const float* __restrict__ x, long long p,
                                       long long n, int l, const Emb& emb) {
  float t = 0.f;
  if (p < n) {
    const float* xp = x + p * kInCols;
#pragma unroll
    for (int c = 0; c < kInCols; ++c)
      t = fmaf(__ldg(xp + c), __ldg(emb.E + c * kLane + l), t);
  }
  return __ldg(emb.id + l) > 0.f ? t : sinf(t + __ldg(emb.phase + l));
}

// ---------------------------------------------------------------------------
// Asynchronous copies and ldmatrix
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from device to shared memory; zeros, and src not read, when !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8x8 bf16 matrices; lane l names row l%8 of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  return static_cast<uint32_t>(f2bf(lo)) | (static_cast<uint32_t>(f2bf(hi)) << 16);
}
__device__ __forceinline__ float lo_bf(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// ---------------------------------------------------------------------------
// Chains of layers, weights streamed through shared memory (K2, K3 stage 1)
// ---------------------------------------------------------------------------

// A chain's weights come as a slab stream (slab_stream.cuh: k2_pack_slabs,
// k3_pack_slabs; the plain versions are forward_slabs and chain_slabs in
// kernels/fused_field_train.py), kSlabN rows of kSlabK each. A ring of kRing slabs in shared memory is filled by cp.async, kRing - 1
// slabs ahead of the products, across pass and layer boundaries; all 8
// warps share it. What bounds a chain on this card is shared memory's
// bandwidth for the operand fragments and the block barrier each slab
// costs, not the latency of L2 (a deeper ring does not help): so a pass
// covers 256 columns, and each warp a 32 x 64 tile of it, which reads
// 1.7x fewer fragment bytes per product than 16 x 64 and halves the
// barriers.
constexpr int kLdSlab = kSlabK + kPad;         // 80-byte rows: ldmatrix without bank conflicts
constexpr int kSlabSmem = kSlabN * kLdSlab;    // in shared memory
constexpr int kRing = 4;
constexpr int kChainCols = 64;                 // columns of a warp's tile

struct SlabRing {
  bf16_t* buf;
  const bf16_t* src;
  int total, issued, used;

  __device__ void issue() {
    if (issued < total) {
      const bf16_t* s = src + static_cast<long long>(issued) * kSlabElems;
      bf16_t* d = buf + (issued % kRing) * kSlabSmem;
      for (int c = threadIdx.x; c < kSlabElems / 8; c += kThreads)
        cp_async16(d + (c / (kSlabK / 8)) * kLdSlab + (c % (kSlabK / 8)) * 8, s + c * 8, true);
    }
    cp_async_commit();  // an empty group past the end keeps the count
    ++issued;
  }
  __device__ void start() {
    for (int i = 0; i < kRing - 1; ++i) issue();
  }
  // The next slab, once every thread's copies of it have landed; the
  // barrier also frees the slot of the one before, which is refilled.
  __device__ const bf16_t* next() {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    issue();
    return buf + (used++ % kRing) * kSlabSmem;
  }
};

// One summand of a chain layer: A (64 x k_dim bf16 in shared memory, row
// stride lda, k_dim a multiple of kSlabK); its B comes from the ring.
struct ChainOp {
  const bf16_t* a;
  int lda, k_dim;
};

// Where a chain layer's f32 sums go: into dst, rounded to bf16, after
// v + bias, then relu unless told not to (bias set), where(mask > 0, v, 0)
// with the mask from a shared tile (mask_s) or from a residual plane
// (mask_g: (n, 256), rows from base), or as they are.
struct ChainEpi {
  bf16_t* dst;
  int ld;
  const bf16_t* bias;
  const bf16_t* mask_s;
  int ldm;
  const bf16_t* mask_g;
  long long base, n;
  bool relu = true;
};

// out = sum over the operands, for n_cols (a multiple of kChainCols)
// columns, in passes of kSlabN; warp w owns rows 32*(w%2).. and columns
// 64*(w/2).. of a pass (none where those lie past n_cols: it only keeps
// step with the ring). No operand's A may be dst. Ends with
// __syncthreads().
template <int NOPS>
__device__ __forceinline__ void chain_layer(const ChainOp (&ops)[NOPS], int n_cols,
                                            SlabRing& ring, const ChainEpi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 1) * 32, nl = (warp >> 1) * kChainCols;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, rr = lane & 7;
  constexpr int NT = kChainCols / 8;
  for (int c0 = 0; c0 < n_cols; c0 += kSlabN) {
    const bool live = c0 + nl < n_cols;
    // the epilogue's bias or residual mask, fetched before the products
    // so that its latency hides behind them
    uint32_t pre[2][NT][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + nl + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long p = epi.base + row0 + 16 * mt + g + 8 * h;
          uint32_t v = 0u;
          if (live && epi.bias)
            v = __ldg(reinterpret_cast<const unsigned int*>(epi.bias + c));
          else if (live && epi.mask_g && p < epi.n)
            v = __ldg(reinterpret_cast<const unsigned int*>(epi.mask_g + p * kWidth + c));
          pre[mt][j][h] = v;
        }
      }
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
      const ChainOp& op = ops[o];
      for (int k0 = 0; k0 < op.k_dim; k0 += kSlabK) {
        const bf16_t* slab = ring.next();
        if (!live) continue;
#pragma unroll
        for (int kk = 0; kk < kSlabK; kk += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(a[mt], op.a + (row0 + 16 * mt + rr + 8 * (q & 1)) * op.lda + k0 + kk +
                               8 * (q >> 1));
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t b[4];
            ldsm_x4(b, slab + (nl + 8 * j + rr + 8 * (q >> 1)) * kLdSlab + kk + 8 * (q & 1));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma16816(acc[mt][j], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
              mma16816(acc[mt][j + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);
            }
          }
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + nl + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 16 * mt + g + 8 * h;
          float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
          if (epi.bias) {
            v0 += lo_bf(pre[mt][j][h]);
            v1 += hi_bf(pre[mt][j][h]);
            if (epi.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
          } else if (epi.mask_g || epi.mask_s) {
            const uint32_t m = epi.mask_g
                ? pre[mt][j][h]
                : *reinterpret_cast<const uint32_t*>(epi.mask_s + r * epi.ldm + c);
            v0 = lo_bf(m) > 0.f ? v0 : 0.f;
            v1 = hi_bf(m) > 0.f ? v1 : 0.f;
          }
          *reinterpret_cast<uint32_t*>(epi.dst + r * epi.ld + c) = pack_bf2(v0, v1);
        }
      }
  }
  __syncthreads();
}

// K2's output heads: O (64 x n_out f32, row stride ldo, n_out <= kNarrowN)
// = the sum over the operands, plus O as it was when add; B from the ring
// as narrow slabs. Warp w owns rows 16*(w%4).. and columns 16*(w/4)..; each
// sum takes its k-steps of 16 in order, operand after operand, as in
// chain_layer. Ends with __syncthreads().
template <int NOPS>
__device__ __forceinline__ void head_layer(const ChainOp (&ops)[NOPS], SlabRing& ring,
                                           float* O, int ldo, int n_out, bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 16, nl = (warp >> 2) * 16;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, rr = lane & 7;
  float acc[2][4] = {};
#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
    const ChainOp& op = ops[o];
    const bf16_t* slab = nullptr;
    for (int k0 = 0; k0 < op.k_dim; k0 += 16) {
      const int ks = k0 % kNarrowK;
      if (ks == 0) slab = ring.next();
      uint32_t a[4], b[4];
      ldsm_x4(a, op.a + (row0 + rr + 8 * (q & 1)) * op.lda + k0 + 8 * (q >> 1));
      ldsm_x4(b, slab + (ks / kSlabK * kNarrowN + nl + rr + 8 * (q >> 1)) * kLdSlab +
                     ks % kSlabK + 8 * (q & 1));
      mma16816(acc[0], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma16816(acc[1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1), c = nl + 8 * j + 2 * t + (e & 1);
      if (c < n_out) O[r * ldo + c] = add ? O[r * ldo + c] + acc[j][e] : acc[j][e];
    }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K2: forward
// ---------------------------------------------------------------------------

// The forward's biases, bf16 as packed.
struct Biases {
  const bf16_t *tb, *bpf, *bfeat, *bv, *bcf, *bias;
};

// K2: raw (n, n_out) f32 and the 11 residual planes. Layer after layer
// through chain_layer and head_layer, in the order of forward_schedule in
// kernels/fused_field_train.py: every summand's products, k order and
// rounding are those of the plain version. Shared memory: the ring, then
// hv's buffer HB, the embedding X and HA; vf overwrites X and HA, which
// nothing reads after hv.
__global__ void __launch_bounds__(kThreads, 1)
    k2_forward(const float* __restrict__ x, long long n, Emb emb, Biases bs,
               const bf16_t* __restrict__ slabs, int n_slabs, Dims d,
               float* __restrict__ raw, bf16_t* __restrict__ res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_vf = d.vf_cols + kPad;
  const int ld_o = (d.n_out + 7) / 8 * 8;
  bf16_t* R = reinterpret_cast<bf16_t*>(smem);  // the slab ring
  bf16_t* HB = R + kRing * kSlabSmem;            // trunk    [64][kLdH]
  bf16_t* X = HB + kTile * kLdH;                 // emb      [64][kLdX]
  bf16_t* HA = X + kTile * kLdX;                 // trunk    [64][kLdH]
  bf16_t* VF = X;                                // vf       [64][ld_vf]
  float* O = reinterpret_cast<float*>(X + kTile * max(kLdX + kLdH, ld_vf));  // raw [64][ld_o]

  SlabRing ring{R, slabs, n_slabs, 0, 0};
  ring.start();  // the first weight slabs load while the embedding is made

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long plane = n * kWidth;
  for (int idx = threadIdx.x; idx < kTile * kLane; idx += kThreads) {
    const int r = idx / kLane, l = idx % kLane;
    X[r * kLdX + l] = f2bf(embed(x, base + r, n, l, emb));
  }
  __syncthreads();

  auto relu_bias = [](bf16_t* dst, int ld, const bf16_t* bias) {
    return ChainEpi{dst, ld, bias, nullptr, 0, nullptr, 0, 0};
  };
  bf16_t* H[2] = {HA, HB};
  {
    const ChainOp ops[1] = {{X, kLdX, kLane}};
    chain_layer(ops, kWidth, ring, relu_bias(HA, kLdH, bs.tb));
    store_tile(res, kWidth, HA, kLdH, base, n);
  }
  for (int i = 1; i <= 7; ++i) {  // h_i from h_{i-1}: ping-pong HA/HB
    bf16_t* in = H[(i - 1) & 1];
    bf16_t* out = H[i & 1];
    const ChainEpi epi = relu_bias(out, kLdH, bs.tb + i * kWidth);
    if (i == 5) {
      const ChainOp ops[2] = {{X, kLdX, kLane}, {in, kLdH, kWidth}};
      chain_layer(ops, kWidth, ring, epi);
    } else {
      const ChainOp ops[1] = {{in, kLdH, kWidth}};
      chain_layer(ops, kWidth, ring, epi);
    }
    store_tile(res + i * plane, kWidth, out, kLdH, base, n);
  }
  // h7 is in HB
  {
    const ChainOp ops[1] = {{HB, kLdH, kWidth}};
    chain_layer(ops, kWidth, ring, relu_bias(HA, kLdH, bs.bpf));  // pf
    store_tile(res + kPf * plane, kWidth, HA, kLdH, base, n);
  }
  {
    const ChainOp ops[2] = {{HB, kLdH, kWidth}, {HA, kLdH, kWidth}};
    head_layer(ops, ring, O, ld_o, d.n_out, false);  // h7 @ A + pf @ B
  }
  {
    const ChainOp ops[1] = {{HB, kLdH, kWidth}};
    ChainEpi epi = relu_bias(HA, kLdH, bs.bfeat);
    epi.relu = false;
    chain_layer(ops, kWidth, ring, epi);  // ft
    store_tile(res + kFt * plane, kWidth, HA, kLdH, base, n);
  }
  {
    const ChainOp ops[2] = {{HA, kLdH, kWidth}, {X, kLdX, kLane}};
    chain_layer(ops, kWidth, ring, relu_bias(HB, kLdH, bs.bv));  // hv
    store_tile(res + kHv * plane, kWidth, HB, kLdH, base, n);
  }
  {
    const ChainOp ops[1] = {{HB, kLdH, kWidth}};
    chain_layer(ops, d.vf_cols, ring, relu_bias(VF, ld_vf, bs.bcf));  // vf
  }
  {
    const ChainOp ops[2] = {{HB, kLdH, kWidth}, {VF, ld_vf, d.vf_cols}};
    head_layer(ops, ring, O, ld_o, d.n_out, true);  // + hv @ C + vf @ D
  }
  for (int idx = threadIdx.x; idx < kTile * d.n_out; idx += kThreads) {
    const int r = idx / d.n_out, c = idx % d.n_out;
    const long long p = base + r;
    if (p < n) raw[p * d.n_out + c] = O[r * ld_o + c] + bf2f(__ldg(bs.bias + c));
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K3, stage 1: the reverse chain
// ---------------------------------------------------------------------------

struct Deltas {
  bf16_t* p[kNumDeltas];
};

__global__ void __launch_bounds__(kThreads, 1)
    k3_delta_chain(const float* __restrict__ x, long long n,
                   const float* __restrict__ g, const bf16_t* __restrict__ res,
                   Emb emb, const bf16_t* __restrict__ bcf,
                   const bf16_t* __restrict__ slabs, int n_slabs, Dims d,
                   Deltas out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_p = max(d.vf_cols, kWidth) + kPad;
  bf16_t* G = reinterpret_cast<bf16_t*>(smem);  // bf16 g   [64][kLdG]
  bf16_t* HV = G + kTile * kLdG;                 // hv, dhv, d7, d4, d1
  bf16_t* P = HV + kTile * kLdH;                 // vf, dvf, dft, d5, d2 (>= 256 wide)
  bf16_t* Q = P + kTile * ld_p;                  // dpf, d6, d3, d0
  bf16_t* R = Q + kTile * kLdH;                  // the slab ring

  SlabRing ring{R, slabs, n_slabs, 0, 0};
  ring.start();  // the first weight slabs load while the inputs are set up

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long plane = n * kWidth;

  for (int idx = threadIdx.x; idx < kTile * kLane; idx += kThreads) {
    const int r = idx / kLane, l = idx % kLane;
    const long long p = base + r;
    const float v = embed(x, p, n, l, emb);
    if (p < n) out.p[kX][p * kLane + l] = f2bf(v);
  }
  // g16 is written kGCols wide, zero past n_out, so the dW stage reads
  // whole 16-byte rows
  for (int idx = threadIdx.x; idx < kTile * kGCols; idx += kThreads) {
    const int r = idx / kGCols, c = idx % kGCols;
    const long long p = base + r;
    const bf16_t v = p < n && c < d.n_out ? f2bf(__ldg(g + p * d.n_out + c)) : bf16_t(0);
    G[r * kLdG + c] = v;
    if (p < n) out.p[kG16][p * kGCols + c] = v;
  }
  load_tile(HV, kLdH, res + kHv * plane, kWidth, base, n);
  __syncthreads();

  auto relu_bias = [](bf16_t* dst, int ld, const bf16_t* bias) {
    return ChainEpi{dst, ld, bias, nullptr, 0, nullptr, 0, 0};
  };
  auto mask_smem = [](bf16_t* dst, int ld, const bf16_t* m, int ldm) {
    return ChainEpi{dst, ld, nullptr, m, ldm, nullptr, 0, 0};
  };
  auto mask_res = [=](bf16_t* dst, int ld, int slot) {
    return ChainEpi{dst, ld, nullptr, nullptr, 0, res + slot * plane, base, n};
  };

  {  // vf = relu(hv @ wcf + bcf), recomputed
    const ChainOp ops[1] = {{HV, kLdH, kWidth}};
    chain_layer(ops, d.vf_cols, ring, relu_bias(P, ld_p, bcf));
    store_tile(out.p[kVf], d.vf_cols, P, ld_p, base, n);
  }
  {  // dvf = msk(vf, g16 @ D^T)
    const ChainOp ops[1] = {{G, kLdG, kGCols}};
    chain_layer(ops, d.vf_cols, ring, mask_smem(P, ld_p, P, ld_p));
    store_tile(out.p[kDvf], d.vf_cols, P, ld_p, base, n);
  }
  {  // dhv = msk(hv, g16 @ C^T + dvf @ wcf^T)
    const ChainOp ops[2] = {{G, kLdG, kGCols}, {P, ld_p, d.vf_cols}};
    chain_layer(ops, kWidth, ring, mask_smem(HV, kLdH, HV, kLdH));
    store_tile(out.p[kDhv], kWidth, HV, kLdH, base, n);
  }
  {  // dft = dhv @ wv_f^T (ft has no relu)
    const ChainOp ops[1] = {{HV, kLdH, kWidth}};
    chain_layer(ops, kWidth, ring, ChainEpi{P, ld_p, nullptr, nullptr, 0, nullptr, 0, 0});
    store_tile(out.p[kDft], kWidth, P, ld_p, base, n);
  }
  {  // dpf = msk(pf, g16 @ B^T)
    const ChainOp ops[1] = {{G, kLdG, kGCols}};
    chain_layer(ops, kWidth, ring, mask_res(Q, kLdH, kPf));
    store_tile(out.p[kDpf], kWidth, Q, kLdH, base, n);
  }
  {  // d7 = msk(h7, g16 @ A^T + dft @ wfeat^T + dpf @ wpf^T)
    const ChainOp ops[3] = {{G, kLdG, kGCols}, {P, ld_p, kWidth}, {Q, kLdH, kWidth}};
    chain_layer(ops, kWidth, ring, mask_res(HV, kLdH, kH7));
    store_tile(out.p[kD7], kWidth, HV, kLdH, base, n);
  }
  // d_{i-1} = msk(h_{i-1}, d_i @ w_i^T), i = 7..1 (w5h for i = 5), rotating
  // through HV -> Q -> P -> HV.
  bf16_t* buf[3] = {HV, Q, P};
  const int ldb[3] = {kLdH, kLdH, ld_p};
  for (int i = 7, s = 0; i >= 1; --i, s = (s + 1) % 3) {
    const int dst = (s + 1) % 3;
    const ChainOp ops[1] = {{buf[s], ldb[s], kWidth}};
    chain_layer(ops, kWidth, ring, mask_res(buf[dst], ldb[dst], kH0 + i - 1));
    store_tile(out.p[kD7 + 8 - i], kWidth, buf[dst], ldb[dst], base, n);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// The slab streams
// ---------------------------------------------------------------------------

// Slabs the chain consumes: vf (vf_cols, k 256), dvf (vf_cols, k 32),
// dhv (256, k 32 + vf_cols), dft (256, k 256), dpf (256, k 32), d7 (256,
// k 32 + 256 + 256), d6..d0 (256, k 256 each).
int chain_slab_count(const Dims& d) {
  const int w = passes(kWidth);
  return passes(d.vf_cols) * (k_slabs(kWidth) + k_slabs(kGCols)) +
         w * (k_slabs(kGCols) + k_slabs(d.vf_cols)) + w * k_slabs(kWidth) +
         w * k_slabs(kGCols) + w * (k_slabs(kGCols) + 2 * k_slabs(kWidth)) +
         7 * w * k_slabs(kWidth);
}

// The forward's weights, slab after slab (~1.8 MB a call).
__global__ void __launch_bounds__(kThreads)
    k2_pack_slabs(SlabOps ops, bf16_t* __restrict__ slabs) {
  pack_slab(ops.o[blockIdx.y], slabs);
}

// The reverse chain's weights, slab after slab (~1.7 MB a call).
__global__ void __launch_bounds__(kThreads)
    k3_pack_slabs(SlabOps ops, bf16_t* __restrict__ slabs) {
  pack_slab(ops.o[blockIdx.y], slabs);
}

// ---------------------------------------------------------------------------
// K3, stage 2: dW = act^T @ delta and the bias sums, per point range
// ---------------------------------------------------------------------------

// Each block owns one output tile of one gradient (a job of k3_plan in
// kernels/fused_field_train.py) over one point range (blockIdx.y), and
// writes its own f32 partial. The act and delta rows of kDwPts points are
// [point][column] in device memory; a ring of kDwStages stages is filled
// by 16-byte cp.async, and ldmatrix.trans hands the tensor cores both
// operands with the points as the reduction axis. A wide job's tile is
// 128 x 128 (8 warps of 64 x 32), a narrow one's (the output heads, n <=
// 32) 128 x 32 (8 warps of 16 x 32). Blocks are numbered job-fastest, so
// the jobs of one range run together and share its planes in L2.
constexpr int kDwTile = 128;
constexpr int kDwNarrow = 32;
constexpr int kDwPts = 32;
constexpr int kDwStages = 4;
constexpr int kLdDw = kDwTile + kPad;  // 272-byte rows
constexpr int kMaxJobs = 64;
constexpr int kNumPlanes = 26;         // the residuals, then the deltas

// act/delta: plane indices; lda/ldd: their widths; m0, n0: the tile;
// m, n: the gradient's shape; out: its offset in the flat gradient;
// sum_out: offset of the bias sums of delta columns n0.. (sum_src 1: of
// this tile's delta; 2: of the f32 cotangent g, n columns), or unused (0).
struct DwJob {
  int act, delta, lda, ldd, m0, n0, m, n, out, sum_out, sum_src;
};
struct DwJobs {
  DwJob j[kMaxJobs];
};
struct Planes {
  const bf16_t* p[kNumPlanes];
};

size_t dw_smem() { return sizeof(bf16_t) * kDwStages * kDwPts * 2 * kLdDw; }

template <int BN>
__device__ __forceinline__ void dw_tile(const DwJob& J, const bf16_t* __restrict__ act,
                                        const bf16_t* __restrict__ delta, long long p_begin,
                                        long long p_end, float* __restrict__ dst,
                                        bf16_t* smem) {
  constexpr int MT = BN == kDwTile ? 4 : 1;  // m16 tiles of a warp
  constexpr int WN = BN / 32;                // warps along n
  constexpr int LDD = BN + kPad;
  constexpr int kA = kDwPts * kLdDw, kD = kDwPts * LDD;
  bf16_t* As = smem;
  bf16_t* Ds = smem + kDwStages * kA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, mb = wm * MT * 16, nb = (warp % WN) * 32;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, rr = lane & 7;
  const int steps = p_end > p_begin ? static_cast<int>((p_end - p_begin + kDwPts - 1) / kDwPts) : 0;
  const bool sums = J.sum_src == 1 && wm == 0;  // one warp row takes the column sums

  auto load = [&](int stage, int step) {
    const long long p0 = p_begin + static_cast<long long>(step) * kDwPts;
    bf16_t* a_s = As + stage * kA;
    bf16_t* d_s = Ds + stage * kD;
    for (int c = threadIdx.x; c < kDwPts * (kDwTile / 8); c += kThreads) {
      const int r = c / (kDwTile / 8), col = (c % (kDwTile / 8)) * 8;
      const long long p = p0 + r;
      const bool live = p < p_end && J.m0 + col < J.lda;
      cp_async16(a_s + r * kLdDw + col, live ? act + p * J.lda + J.m0 + col : act, live);
    }
    for (int c = threadIdx.x; c < kDwPts * (BN / 8); c += kThreads) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const long long p = p0 + r;
      const bool live = p < p_end && J.n0 + col < J.ldd;
      cp_async16(d_s + r * LDD + col, live ? delta + p * J.ldd + J.n0 + col : delta, live);
    }
  };

  float acc[MT][4][4], sum[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum[j][e] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc[mt][j][e] = 0.f;
    }
  const uint32_t ones = 0x3F803F80u;  // bf16 1.0 twice: the column sums on the tensor cores

#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (i + kDwStages - 1 < steps) load((i + kDwStages - 1) % kDwStages, i + kDwStages - 1);
    cp_async_commit();
    const bf16_t* a_s = As + (i % kDwStages) * kA;
    const bf16_t* d_s = Ds + (i % kDwStages) * kD;
#pragma unroll
    for (int k0 = 0; k0 < kDwPts; k0 += 16) {
      uint32_t a[MT][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_t(a[mt], a_s + (k0 + rr + 8 * (q >> 1)) * kLdDw + mb + 16 * mt + 8 * (q & 1));
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r4[4];
        ldsm_x4_t(r4, d_s + (k0 + rr + 8 * (q & 1)) * LDD + nb + 8 * (j + (q >> 1)));
        b[j][0] = r4[0];
        b[j][1] = r4[1];
        b[j + 1][0] = r4[2];
        b[j + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(acc[mt][j], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[j][0], b[j][1]);
      if (sums) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(sum[j], ones, ones, ones, ones, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = J.m0 + mb + 16 * mt + g + 8 * (e >> 1);
        const int c = J.n0 + nb + 8 * j + 2 * t + (e & 1);
        if (r < J.m && c < J.n) dst[J.out + static_cast<long long>(r) * J.n + c] = acc[mt][j][e];
      }
  if (sums && g == 0) {  // every row of sum holds the column sums
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nb + 8 * j + 2 * t + e;
        if (J.n0 + c < J.n) dst[J.sum_out + c] = sum[j][e];
      }
  }
}

// Column sums of the f32 g (n, cols) over points [p0, p1) into dst, in a
// fixed order: thread i (< per, a multiple of cols) sums every per-th
// element from i, all in column i % cols, in batches of 16 loads.
__device__ __forceinline__ void g_colsum(const float* __restrict__ g, int cols, long long p0,
                                         long long p1, float* __restrict__ dst) {
  __shared__ float red[kThreads];
  const int per = kThreads / cols * cols;
  float s = 0.f;
  if (static_cast<int>(threadIdx.x) < per) {
    const long long end = p1 * cols;
    for (long long e = p0 * cols + threadIdx.x; e < end; e += 16LL * per) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = e + u * per < end ? __ldg(g + e + u * per) : 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) s += v[u];
    }
  }
  red[threadIdx.x] = s;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < cols) {
    float v = 0.f;
    for (int i = threadIdx.x; i < per; i += cols) v += red[i];
    dst[threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    k3_dw_gemm(DwJobs jobs, Planes planes, const float* __restrict__ g, long long n,
               long long chunk, float* __restrict__ partial, long long total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DwJob J = jobs.j[blockIdx.x];
  const long long p_begin = min(n, static_cast<long long>(blockIdx.y) * chunk);
  const long long p_end = min(n, p_begin + chunk);
  float* dst = partial + static_cast<long long>(blockIdx.y) * total;
  const bf16_t* act = planes.p[J.act];
  const bf16_t* delta = planes.p[J.delta];
  bf16_t* s = reinterpret_cast<bf16_t*>(smem);
  if (J.n > kDwNarrow)
    dw_tile<kDwTile>(J, act, delta, p_begin, p_end, dst, s);
  else
    dw_tile<kDwNarrow>(J, act, delta, p_begin, p_end, dst, s);
  if (J.sum_src == 2) g_colsum(g, J.n, p_begin, p_end, dst + J.sum_out);
}

// dw = the sum of the point ranges' partials, in range order.
__global__ void k3_reduce(const float* __restrict__ partial, int splits,
                          long long total, float* __restrict__ dw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * total + i];
  dw[i] = s;
}

size_t forward_smem(const Dims& d) {
  const int ld_o = (d.n_out + 7) / 8 * 8;
  return sizeof(bf16_t) * (kRing * kSlabSmem +
                           kTile * (kLdH + max(kLdX + kLdH, d.vf_cols + kPad))) +
         sizeof(float) * kTile * ld_o;
}

size_t chain_smem(const Dims& d) {
  return sizeof(bf16_t) * (kTile * (kLdG + 2 * kLdH + max(d.vf_cols, kWidth) + kPad) +
                           kRing * kSlabSmem);
}

bool dims_ok(long long n, int n_weights, int width, const Dims& d) {
  return n_weights == kNumDw && width == kWidth && n >= 0 &&
         (n + kTile - 1) / kTile <= INT_MAX && d.n_out > 0 &&
         d.n_out <= kGCols && d.vf_cols > 0 && d.vf_cols % kChainCols == 0;
}

}  // namespace

// Launches K2 on `stream`, two kernels in order:
//   k2_pack_slabs  the forward's weights into `slabs` (n_slabs slabs), per
//                  slab op as for K3's pack (see below);
//   k2_forward     raw (n, n_out) f32 and res (11, n, 256) bf16.
// wn: kNumDw device pointers in DwIndex order, as packed ([in][out]).
// Returns 0, a cudaError_t, or -1 for arguments the kernels do not take.
extern "C" int fused_field_train_fwd_launch(
    const float* x, long long n, const float* emb_E, const float* emb_phase,
    const float* emb_id, const void* const* wn, int n_weights, int width,
    int n_out, int vf_cols, const int* slab_ops, int n_slab_ops, void* slabs, int n_slabs,
    float* raw, void* res, void* stream) {
  const Dims d{n_out, vf_cols};
  SlabOps so;
  int max_slabs;
  if (!dims_ok(n, n_weights, width, d) || n_slabs != forward_slab_count(d) ||
      !read_slab_ops(slab_ops, n_slab_ops, wn, n_slabs, so, max_slabs))
    return -1;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k2_pack_slabs<<<dim3(max_slabs, n_slab_ops), kThreads, 0, s>>>(so, static_cast<bf16_t*>(slabs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto w = [&](int i) { return static_cast<const bf16_t*>(wn[i]); };
  const Biases bs{w(kTb), w(kBpf), w(kBfeat), w(kBv), w(kBcf), w(kBias)};
  const size_t smem = forward_smem(d);
  err = cudaFuncSetAttribute(k2_forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  k2_forward<<<blocks, kThreads, smem, s>>>(x, n, Emb{emb_E, emb_phase, emb_id}, bs,
                                            static_cast<const bf16_t*>(slabs), n_slabs, d, raw,
                                            static_cast<bf16_t*>(res));
  return static_cast<int>(cudaGetLastError());
}

// Launches K3 on `stream`, four kernels in order:
//   k3_pack_slabs   the chain's weights into `slabs` (n_slabs slabs), per
//                   slab op: {weight index in DwIndex order, trans, n, k,
//                   first, stride};
//   k3_delta_chain  the reverse chain into `deltas` (kNumDeltas planes in
//                   DeltaIndex order, g16 kGCols wide);
//   k3_dw_gemm      the jobs (11 ints each, DwJob's fields; act and delta
//                   index `planes`: the 11 residual planes, then the
//                   deltas) over `splits` point ranges of `chunk` points,
//                   into `partial` (splits x total f32);
//   k3_reduce       their fixed-order sum into dw (total f32).
// wn: kNumDw device pointers in DwIndex order, as packed ([in][out]).
// Returns 0, a cudaError_t, or -1 for arguments the kernels do not take.
extern "C" int fused_field_train_bwd_launch(
    const float* x, long long n, const float* g, const void* res,
    const float* emb_E, const float* emb_phase, const float* emb_id,
    const void* const* wn, int n_weights, int width, int n_out, int vf_cols,
    const int* slab_ops, int n_slab_ops, void* slabs, int n_slabs,
    void* const* deltas, int n_deltas, const void* const* planes, int n_planes,
    const int* jobs, int n_jobs, long long chunk, int splits, float* partial,
    long long total, float* dw, void* stream) {
  const Dims d{n_out, vf_cols};
  SlabOps so;
  int max_slabs;
  if (!dims_ok(n, n_weights, width, d) || n_slabs != chain_slab_count(d) ||
      !read_slab_ops(slab_ops, n_slab_ops, wn, n_slabs, so, max_slabs) ||
      n_deltas != kNumDeltas || n_planes != kNumPlanes || n_jobs <= 0 ||
      n_jobs > kMaxJobs || splits <= 0 || total <= 0 || total > INT_MAX || chunk < 0 ||
      chunk * splits < n)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  DwJobs dj;
  for (int i = 0; i < n_jobs; ++i) {
    const int* v = jobs + 11 * i;
    DwJob& J = dj.j[i];
    J = DwJob{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10]};
    const int bn = J.n > kDwNarrow ? kDwTile : kDwNarrow;
    if (J.act < 0 || J.act >= kNumPlanes || J.delta < 0 || J.delta >= kNumPlanes ||
        J.lda % 8 || J.ldd % 8 || J.m0 < 0 || J.m0 >= J.m || J.n0 < 0 || J.n0 >= J.n ||
        J.m > J.lda || J.n > J.ldd || (bn == kDwNarrow && J.ldd > kDwNarrow) ||
        J.out < 0 || static_cast<long long>(J.out) + J.m * J.n > total ||
        J.sum_src < 0 || J.sum_src > 2 ||
        (J.sum_src && (J.sum_out < 0 || J.sum_out + min(bn, J.n - J.n0) > total)))
      return -1;
  }
  Planes pl;
  for (int i = 0; i < kNumPlanes; ++i) pl.p[i] = static_cast<const bf16_t*>(planes[i]);

  cudaError_t err;
  if (n > 0) {
    k3_pack_slabs<<<dim3(max_slabs, n_slab_ops), kThreads, 0, s>>>(
        so, static_cast<bf16_t*>(slabs));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    Deltas out;
    for (int i = 0; i < kNumDeltas; ++i) out.p[i] = static_cast<bf16_t*>(deltas[i]);
    const Emb emb{emb_E, emb_phase, emb_id};
    const size_t smem = chain_smem(d);
    err = cudaFuncSetAttribute(k3_delta_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
    k3_delta_chain<<<blocks, kThreads, smem, s>>>(
        x, n, g, static_cast<const bf16_t*>(res), emb,
        static_cast<const bf16_t*>(wn[kBcf]), static_cast<const bf16_t*>(slabs), n_slabs,
        d, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(k3_dw_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dw_smem()));
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_dw_gemm<<<dim3(n_jobs, splits), kThreads, dw_smem(), s>>>(dj, pl, g, n, chunk, partial,
                                                               total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_reduce<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(partial, splits,
                                                                      total, dw);
  return static_cast<int>(cudaGetLastError());
}
