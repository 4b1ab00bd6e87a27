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
// 3.35 TB/s (~295 per byte) K2 sits at the ridge and K3 just above it.
//
// What the design does about it: every product runs on the tensor cores as
// warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate). A block owns 64
// points and keeps their activations on chip, bf16 in shared memory, rows
// padded by 8 so that the fragment loads of a warp hit 32 distinct banks.
// 8 warps: warp w owns rows 16*(w%4).. and half of the output columns of a
// pass. Weights (1.7 MB bf16, far more than shared memory) are read as
// B fragments through L1/L2, stored [n][k] so that a fragment register is
// two neighbouring k: K2 gets every matrix transposed ([out][in]), K3's
// reverse chain reads them as packed ([in][out]). The residuals leave
// shared memory as 16-byte row stores.
//
// The TPU kernel accumulated all 24 gradients across a sequential grid in
// VMEM. Blocks here run in parallel, so K3 is split in two stages:
//   k3_delta_chain  per 64-point tile: the reverse chain; writes emb, bf16
//                   g, vf and the 12 deltas (bf16, as the TPU kernel rounds
//                   them) to device memory;
//   k3_dw_gemm      dW = act^T @ delta for the 18 weight matrices, 64x64
//                   output tiles, the points split into `splits` ranges,
//                   each range writing its own f32 partial;
//   k3_colsum       the bias gradients, column sums over the same ranges
//                   (the output bias sums the f32 g);
//   k3_reduce       sums the partials in a fixed order. Deterministic: no
//                   atomics, two runs give the same bits. dW stays f32.
// The ragged last tile is masked in every kernel; offsets are 64-bit; sinf
// without fast math. Faster designs (wgmma, TMA-fed weight tiles, warp
// specialisation) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

typedef unsigned short bf16_t;  // bf16 bits

constexpr int kTile = 64;        // points per block of K2 and the delta chain
constexpr int kThreads = 256;    // 8 warps
constexpr int kWidth = 256;      // trunk width the tiling is written for
constexpr int kLane = 128;       // embedding lanes
constexpr int kInCols = 8;
constexpr int kPad = 8;          // bf16 of padding per shared-memory row
constexpr int kLdX = kLane + kPad;
constexpr int kLdH = kWidth + kPad;
constexpr int kGCols = 32;       // g (9+3K columns) padded to a k multiple of 16
constexpr int kLdG = kGCols + kPad;
constexpr int kWide = 8;         // n-tiles per warp for the wide layers
constexpr int kNarrow = 2;       // n-tiles per warp for the output heads

// Same names, same order as _DW_ORDER in kernels/fused_field_train.py.
enum DwIndex {
  kW0, kW1, kW2, kW3, kW4, kW5x, kW5h, kW6, kW7,
  kTb, kWpf, kBpf, kWfeat, kBfeat, kWvF, kWvD, kBv,
  kWcf, kBcf, kA, kB, kC, kD, kBias,
  kNumDw
};
// Same order as _RES_ORDER.
enum ResIndex { kH0 = 0, kH7 = 7, kPf = 8, kFt = 9, kHv = 10 };
// Same order as _DELTA_ORDER.
enum DeltaIndex {
  kX, kG16, kVf, kDvf, kDhv, kDft, kDpf,
  kD7, kD6, kD5, kD4, kD3, kD2, kD1, kD0,
  kNumDeltas
};

struct Weights {
  const bf16_t* p[kNumDw];
};
struct Emb {
  const float* E;      // (8, 128)
  const float* phase;  // (128,)
  const float* id;     // (128,)
};
struct Dims {
  int n_out;    // 9 + 3K
  int vf_cols;  // K * 128
};

__device__ __forceinline__ float bf2f(bf16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ bf16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ bf16_t ldg16(const bf16_t* p) { return __ldg(p); }

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One summand of a layer: A (64 x k_dim, bf16 in shared memory, row stride
// lda, zero beyond its live columns) times B, stored [n][k] in device memory
// with row stride ldb; entries with k >= k_valid or n >= the layer's
// columns read as 0.
struct Operand {
  const bf16_t* a;
  int lda;
  int k_dim;  // multiple of 16
  const bf16_t* b;
  int ldb;
  int k_valid;
};

__device__ __forceinline__ uint32_t load_b(const Operand& op, int n, int k,
                                           bool aligned) {
  const bf16_t* q = op.b + static_cast<size_t>(n) * op.ldb + k;
  if (aligned)  // k even, k_valid even: both or neither are live
    return k < op.k_valid ? __ldg(reinterpret_cast<const unsigned int*>(q)) : 0u;
  const uint32_t lo = k < op.k_valid ? ldg16(q) : 0u;
  const uint32_t hi = k + 1 < op.k_valid ? ldg16(q + 1) : 0u;
  return lo | (hi << 16);
}

// The B fragments of the warp's NT n-tiles at k-step k0.
template <int NT>
__device__ __forceinline__ void load_b_tiles(uint32_t (&b)[NT][2],
                                             const Operand& op, int n0,
                                             int n_cols, int k0, int g, int t,
                                             bool aligned) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + g;
    const bool live = n < n_cols;
    b[j][0] = live ? load_b(op, n, k0 + 2 * t, aligned) : 0u;
    b[j][1] = live ? load_b(op, n, k0 + 8 + 2 * t, aligned) : 0u;
  }
}

// acc[j] += A[row0.., :] @ B[:, n0 + 8j ..] for the warp's NT n-tiles. The
// B fragments of the next k-step are loaded before the products of this
// one, so each warp keeps one L2 round trip in flight behind its mma.
template <int NT>
__device__ __forceinline__ void mma_accumulate(float (&acc)[NT][4],
                                               const Operand& op, int n0,
                                               int n_cols, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool aligned = ((op.ldb | op.k_valid) & 1) == 0;
  uint32_t b[NT][2], next[NT][2];
  load_b_tiles(b, op, n0, n_cols, 0, g, t, aligned);
  for (int k0 = 0; k0 < op.k_dim; k0 += 16) {
    const bool more = k0 + 16 < op.k_dim;
    if (more) load_b_tiles(next, op, n0, n_cols, k0 + 16, g, t, aligned);
    const bf16_t* a = op.a + (row0 + g) * op.lda + k0 + 2 * t;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + 8 * op.lda);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a + 8 * op.lda + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (n0 + 8 * j < n_cols)  // else the whole n-tile is outside
        mma16816(acc[j], a0, a1, a2, a3, b[j][0], b[j][1]);
    if (more) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[j][0] = next[j][0];
        b[j][1] = next[j][1];
      }
    }
  }
}

// out[r][c] = sum over the operands, for every c < n_cols, handed to
// epi(r, c, value) in passes of 2*NT*8 columns. No operand's A may be the
// buffer the epilogue writes (a later pass still reads it); an epilogue may
// read the element it overwrites. Ends with __syncthreads().
template <int NT, int NOPS, class Epi>
__device__ __forceinline__ void run_layer(const Operand (&ops)[NOPS],
                                          int n_cols, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 16, ng = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  for (int c0 = 0; c0 < n_cols; c0 += 2 * NT * 8) {
    const int n0 = c0 + ng * NT * 8;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int o = 0; o < NOPS; ++o)
      mma_accumulate<NT>(acc, ops[o], n0, n_cols, row0, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1), row = row0 + g + 8 * (e >> 1);
        if (col < n_cols) epi(row, col, acc[j][e]);
      }
    }
  }
  __syncthreads();
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
// K2: forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    k2_forward(const float* __restrict__ x, long long n, Emb emb, Weights wt,
               Dims d, float* __restrict__ raw, bf16_t* __restrict__ res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_vf = d.vf_cols + kPad;
  const int ld_o = (d.n_out + 7) / 8 * 8;
  bf16_t* X = reinterpret_cast<bf16_t*>(smem);  // emb      [64][kLdX]
  bf16_t* HA = X + kTile * kLdX;                 // trunk    [64][kLdH]
  bf16_t* HB = HA + kTile * kLdH;                // trunk    [64][kLdH]
  bf16_t* VF = HB + kTile * kLdH;                // vf       [64][ld_vf]
  float* O = reinterpret_cast<float*>(VF + kTile * ld_vf);  // raw [64][ld_o]

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long plane = n * kWidth;
  for (int idx = threadIdx.x; idx < kTile * kLane; idx += kThreads) {
    const int r = idx / kLane, l = idx % kLane;
    X[r * kLdX + l] = f2bf(embed(x, base + r, n, l, emb));
  }
  __syncthreads();

  // act(sum + bias) rounded to bf16 into `out`
  auto to_smem = [](bf16_t* out, int ld, const bf16_t* bias, bool relu) {
    return [=](int r, int c, float v) {
      v += bf2f(ldg16(bias + c));
      out[r * ld + c] = f2bf(relu ? fmaxf(v, 0.f) : v);
    };
  };
  auto wide = [&](const bf16_t* a, int lda, int k, int w) {
    return Operand{a, lda, k, wt.p[w], k, k};
  };
  const bf16_t* tb = wt.p[kTb];
  bf16_t* H[2] = {HA, HB};

  {
    const Operand ops[1] = {wide(X, kLdX, kLane, kW0)};
    run_layer<kWide>(ops, kWidth, to_smem(HA, kLdH, tb, true));
    store_tile(res, kWidth, HA, kLdH, base, n);
  }
  const int mid[4] = {kW1, kW2, kW3, kW4};
  for (int i = 1; i <= 7; ++i) {  // h_i from h_{i-1}: ping-pong HA/HB
    const bf16_t* in = H[(i - 1) & 1];
    bf16_t* out = H[i & 1];
    const bf16_t* bias = tb + i * kWidth;
    if (i == 5) {
      const Operand ops[2] = {wide(X, kLdX, kLane, kW5x),
                              wide(in, kLdH, kWidth, kW5h)};
      run_layer<kWide>(ops, kWidth, to_smem(out, kLdH, bias, true));
    } else {
      const Operand ops[1] = {
          wide(in, kLdH, kWidth, i < 5 ? mid[i - 1] : (i == 6 ? kW6 : kW7))};
      run_layer<kWide>(ops, kWidth, to_smem(out, kLdH, bias, true));
    }
    store_tile(res + i * plane, kWidth, out, kLdH, base, n);
  }
  // h7 is in HB
  {
    const Operand ops[1] = {wide(HB, kLdH, kWidth, kWpf)};
    run_layer<kWide>(ops, kWidth, to_smem(HA, kLdH, wt.p[kBpf], true));  // pf
    store_tile(res + kPf * plane, kWidth, HA, kLdH, base, n);
  }
  auto narrow = [&](const bf16_t* a, int lda, int k, int w) {
    return Operand{a, lda, k, wt.p[w], k, k};
  };
  {
    const Operand ops[2] = {narrow(HB, kLdH, kWidth, kA),
                            narrow(HA, kLdH, kWidth, kB)};
    run_layer<kNarrow>(ops, d.n_out,
                       [=](int r, int c, float v) { O[r * ld_o + c] = v; });
  }
  {
    const Operand ops[1] = {wide(HB, kLdH, kWidth, kWfeat)};
    run_layer<kWide>(ops, kWidth, to_smem(HA, kLdH, wt.p[kBfeat], false));  // ft
    store_tile(res + kFt * plane, kWidth, HA, kLdH, base, n);
  }
  {
    const Operand ops[2] = {wide(HA, kLdH, kWidth, kWvF),
                            wide(X, kLdX, kLane, kWvD)};
    run_layer<kWide>(ops, kWidth, to_smem(HB, kLdH, wt.p[kBv], true));  // hv
    store_tile(res + kHv * plane, kWidth, HB, kLdH, base, n);
  }
  {
    const Operand ops[1] = {wide(HB, kLdH, kWidth, kWcf)};
    run_layer<kWide>(ops, d.vf_cols, to_smem(VF, ld_vf, wt.p[kBcf], true));
  }
  {
    const Operand ops[2] = {narrow(HB, kLdH, kWidth, kC),
                            narrow(VF, ld_vf, d.vf_cols, kD)};
    run_layer<kNarrow>(ops, d.n_out,
                       [=](int r, int c, float v) { O[r * ld_o + c] += v; });
  }
  const bf16_t* bias = wt.p[kBias];
  for (int idx = threadIdx.x; idx < kTile * d.n_out; idx += kThreads) {
    const int r = idx / d.n_out, c = idx % d.n_out;
    const long long p = base + r;
    if (p < n) raw[p * d.n_out + c] = O[r * ld_o + c] + bf2f(ldg16(bias + c));
  }
}

// ---------------------------------------------------------------------------
// K3, part 1: the reverse chain
// ---------------------------------------------------------------------------

struct Deltas {
  bf16_t* p[kNumDeltas];
};

__global__ void __launch_bounds__(kThreads, 1)
    k3_delta_chain(const float* __restrict__ x, long long n,
                   const float* __restrict__ g, const bf16_t* __restrict__ res,
                   Emb emb, Weights w, const bf16_t* __restrict__ wcf_t,
                   Dims d, Deltas out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_p = max(d.vf_cols, kWidth) + kPad;
  bf16_t* G = reinterpret_cast<bf16_t*>(smem);  // bf16 g   [64][kLdG]
  bf16_t* HV = G + kTile * kLdG;                 // hv, dhv, d7, d4, d1
  bf16_t* P = HV + kTile * kLdH;                 // vf, dvf, dft, d5, d2 (>= 256 wide)
  bf16_t* Q = P + kTile * ld_p;                  // dpf, d6, d3, d0

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long plane = n * kWidth;

  for (int idx = threadIdx.x; idx < kTile * kLane; idx += kThreads) {
    const int r = idx / kLane, l = idx % kLane;
    const long long p = base + r;
    const float v = embed(x, p, n, l, emb);
    if (p < n) out.p[kX][p * kLane + l] = f2bf(v);
  }
  for (int idx = threadIdx.x; idx < kTile * kGCols; idx += kThreads) {
    const int r = idx / kGCols, c = idx % kGCols;
    const long long p = base + r;
    const bool live = p < n && c < d.n_out;
    const bf16_t v = live ? f2bf(__ldg(g + p * d.n_out + c)) : bf16_t(0);
    G[r * kLdG + c] = v;
    if (live) out.p[kG16][p * d.n_out + c] = v;
  }
  load_tile(HV, kLdH, res + kHv * plane, kWidth, base, n);
  __syncthreads();

  // d = where(mask > 0, sum, 0) rounded to bf16 into `dst`; the mask from a
  // shared tile (may be dst itself) or from a residual plane.
  auto masked_smem = [](bf16_t* dst, int ld, const bf16_t* mask, int ldm) {
    return [=](int r, int c, float v) {
      dst[r * ld + c] = f2bf(bf2f(mask[r * ldm + c]) > 0.f ? v : 0.f);
    };
  };
  auto masked_res = [=](bf16_t* dst, int ld, int slot) {
    const bf16_t* m = res + slot * plane;
    return [=](int r, int c, float v) {
      const long long p = base + r;
      const bool on = p < n && bf2f(ldg16(m + p * kWidth + c)) > 0.f;
      dst[r * ld + c] = f2bf(on ? v : 0.f);
    };
  };
  // B fragments of the reverse chain: W as packed, [in][out] = [n][k]
  auto rev = [&](const bf16_t* a, int lda, int k_dim, int wi, int k_valid) {
    return Operand{a, lda, k_dim, w.p[wi], k_valid, k_valid};
  };

  {  // vf = relu(hv @ wcf + bcf), recomputed
    const Operand ops[1] = {Operand{HV, kLdH, kWidth, wcf_t, kWidth, kWidth}};
    run_layer<kWide>(ops, d.vf_cols, [=](int r, int c, float v) {
      v += bf2f(ldg16(w.p[kBcf] + c));
      P[r * ld_p + c] = f2bf(fmaxf(v, 0.f));
    });
    store_tile(out.p[kVf], d.vf_cols, P, ld_p, base, n);
  }
  {  // dvf = msk(vf, g16 @ D^T)
    const Operand ops[1] = {rev(G, kLdG, kGCols, kD, d.n_out)};
    run_layer<kWide>(ops, d.vf_cols, masked_smem(P, ld_p, P, ld_p));
    store_tile(out.p[kDvf], d.vf_cols, P, ld_p, base, n);
  }
  {  // dhv = msk(hv, g16 @ C^T + dvf @ wcf^T)
    const Operand ops[2] = {rev(G, kLdG, kGCols, kC, d.n_out),
                            rev(P, ld_p, d.vf_cols, kWcf, d.vf_cols)};
    run_layer<kWide>(ops, kWidth, masked_smem(HV, kLdH, HV, kLdH));
    store_tile(out.p[kDhv], kWidth, HV, kLdH, base, n);
  }
  {  // dft = dhv @ wv_f^T (ft has no relu)
    const Operand ops[1] = {rev(HV, kLdH, kWidth, kWvF, kWidth)};
    run_layer<kWide>(ops, kWidth,
                     [=](int r, int c, float v) { P[r * ld_p + c] = f2bf(v); });
    store_tile(out.p[kDft], kWidth, P, ld_p, base, n);
  }
  {  // dpf = msk(pf, g16 @ B^T)
    const Operand ops[1] = {rev(G, kLdG, kGCols, kB, d.n_out)};
    run_layer<kWide>(ops, kWidth, masked_res(Q, kLdH, kPf));
    store_tile(out.p[kDpf], kWidth, Q, kLdH, base, n);
  }
  {  // d7 = msk(h7, g16 @ A^T + dft @ wfeat^T + dpf @ wpf^T)
    const Operand ops[3] = {rev(G, kLdG, kGCols, kA, d.n_out),
                            rev(P, ld_p, kWidth, kWfeat, kWidth),
                            rev(Q, kLdH, kWidth, kWpf, kWidth)};
    run_layer<kWide>(ops, kWidth, masked_res(HV, kLdH, kH7));
    store_tile(out.p[kD7], kWidth, HV, kLdH, base, n);
  }
  // d_{i-1} = msk(h_{i-1}, d_i @ w_i^T), i = 7..1 (w5h for i = 5), rotating
  // through HV -> Q -> P -> HV.
  bf16_t* buf[3] = {HV, Q, P};
  const int ldb[3] = {kLdH, kLdH, ld_p};
  const int wsrc[8] = {-1, kW1, kW2, kW3, kW4, kW5h, kW6, kW7};
  for (int i = 7, s = 0; i >= 1; --i, s = (s + 1) % 3) {
    const int dst = (s + 1) % 3;
    const Operand ops[1] = {rev(buf[s], ldb[s], kWidth, wsrc[i], kWidth)};
    run_layer<kWide>(ops, kWidth, masked_res(buf[dst], ldb[dst], kH0 + i - 1));
    store_tile(out.p[kD7 + 8 - i], kWidth, buf[dst], ldb[dst], base, n);
  }
}

// ---------------------------------------------------------------------------
// K3, part 2: dW = act^T @ delta over the points, split into point ranges
// ---------------------------------------------------------------------------

constexpr int kMaxGemm = 24;
constexpr int kMaxSum = 24;
constexpr int kGT = 64;          // output tile edge
constexpr int kGP = 64;          // points per shared-memory stage
constexpr int kLdS = kGP + kPad;

struct GemmJob {
  const bf16_t* act;    // (n, lda)
  const bf16_t* delta;  // (n, ldd)
  int lda, ldd, m, n;   // out (m, n) = act[:, :m]^T @ delta[:, :n]
  long long off;        // of out in the flat gradient
  int tiles_n, tile_begin;
};
struct GemmJobs {
  GemmJob j[kMaxGemm];
  int count;
};

__global__ void __launch_bounds__(kThreads)
    k3_dw_gemm(GemmJobs jobs, long long n, long long chunk,
               float* __restrict__ partial, long long total) {
  __shared__ __align__(16) bf16_t As[kGT * kLdS];  // [m][point]
  __shared__ __align__(16) bf16_t Ds[kGT * kLdS];  // [n][point]
  int jb = 0;
  while (jb + 1 < jobs.count && static_cast<int>(blockIdx.x) >= jobs.j[jb + 1].tile_begin)
    ++jb;
  const GemmJob J = jobs.j[jb];
  const int local = blockIdx.x - J.tile_begin;
  const int m0 = (local / J.tiles_n) * kGT, n0 = (local % J.tiles_n) * kGT;
  const long long p_begin = static_cast<long long>(blockIdx.y) * chunk;
  const long long p_end = min(n, p_begin + chunk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 16, col0 = (warp >> 2) * 32;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (long long p0 = p_begin; p0 < p_end; p0 += kGP) {
    for (int idx = threadIdx.x; idx < kGT * kGP; idx += kThreads) {
      const int pp = idx / kGT, mm = idx % kGT;
      const long long p = p0 + pp;
      bf16_t a = 0, dl = 0;
      if (p < p_end) {
        if (m0 + mm < J.m) a = ldg16(J.act + p * J.lda + m0 + mm);
        if (n0 + mm < J.n) dl = ldg16(J.delta + p * J.ldd + n0 + mm);
      }
      As[mm * kLdS + pp] = a;
      Ds[mm * kLdS + pp] = dl;
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kGP; k0 += 16) {
      const bf16_t* a = As + (row0 + g) * kLdS + k0 + 2 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + 8 * kLdS);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a + 8 * kLdS + 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16_t* b = Ds + (col0 + 8 * j + g) * kLdS + k0 + 2 * t;
        mma16816(acc[j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(b),
                 *reinterpret_cast<const uint32_t*>(b + 8));
      }
    }
    __syncthreads();
  }

  float* dst = partial + static_cast<long long>(blockIdx.y) * total + J.off;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + row0 + g + 8 * (e >> 1);
      const int c = n0 + col0 + 8 * j + 2 * t + (e & 1);
      if (r < J.m && c < J.n) dst[static_cast<long long>(r) * J.n + c] = acc[j][e];
    }
}

// Bias gradients: column sums of a delta over the same point ranges.
struct SumJob {
  const void* delta;  // (n, ldd) bf16, or f32 when is_f32
  int ldd, cols, is_f32;
  long long off;
  int col_begin;
};
struct SumJobs {
  SumJob j[kMaxSum];
  int count, total_cols;
};

__global__ void k3_colsum(SumJobs jobs, long long n, long long chunk,
                          float* __restrict__ partial, long long total) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= jobs.total_cols) return;
  int jb = 0;
  while (jb + 1 < jobs.count && col >= jobs.j[jb + 1].col_begin) ++jb;
  const SumJob J = jobs.j[jb];
  const int c = col - J.col_begin;
  const long long p_begin = static_cast<long long>(blockIdx.y) * chunk;
  const long long p_end = min(n, p_begin + chunk);
  float s = 0.f;
  if (J.is_f32) {
    const float* src = static_cast<const float*>(J.delta);
    for (long long p = p_begin; p < p_end; ++p) s += __ldg(src + p * J.ldd + c);
  } else {
    const bf16_t* src = static_cast<const bf16_t*>(J.delta);
    for (long long p = p_begin; p < p_end; ++p) s += bf2f(ldg16(src + p * J.ldd + c));
  }
  partial[static_cast<long long>(blockIdx.y) * total + J.off + c] = s;
}

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
  return sizeof(bf16_t) * kTile * (kLdX + 2 * kLdH + d.vf_cols + kPad) +
         sizeof(float) * kTile * ld_o;
}

size_t chain_smem(const Dims& d) {
  return sizeof(bf16_t) * kTile * (kLdG + 2 * kLdH + max(d.vf_cols, kWidth) + kPad);
}

bool dims_ok(long long n, int n_weights, int width, const Dims& d) {
  return n_weights == kNumDw && width == kWidth && n >= 0 &&
         (n + kTile - 1) / kTile <= INT_MAX && d.n_out > 0 &&
         d.n_out <= kGCols && d.vf_cols > 0 && d.vf_cols % 16 == 0;
}

}  // namespace

// Launches K2 on `stream`: raw (n, n_out) f32 and res (11, n, 256) bf16.
// wt: kNumDw device pointers in DwIndex order, each matrix transposed to
// [out][in], the biases as packed. Returns 0, a cudaError_t, or -1 for
// arguments the kernel does not take.
extern "C" int fused_field_train_fwd_launch(
    const float* x, long long n, const float* emb_E, const float* emb_phase,
    const float* emb_id, const void* const* wt, int n_weights, int width,
    int n_out, int vf_cols, float* raw, void* res, void* stream) {
  const Dims d{n_out, vf_cols};
  if (!dims_ok(n, n_weights, width, d)) return -1;
  if (n == 0) return 0;
  Weights w;
  for (int i = 0; i < kNumDw; ++i) w.p[i] = static_cast<const bf16_t*>(wt[i]);
  const Emb emb{emb_E, emb_phase, emb_id};
  const size_t smem = forward_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      k2_forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  k2_forward<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, emb, w, d, raw, static_cast<bf16_t*>(res));
  return static_cast<int>(cudaGetLastError());
}

// Launches K3 on `stream`: the reverse chain into `deltas` (kNumDeltas
// planes in DeltaIndex order), then the weight products (gemm_*: per job
// the activation and delta planes, {lda, ldd, m, n} and the offset in the
// flat gradient) and the bias sums (sum_*: per job the delta plane, {ldd,
// cols, is_f32} and the offset) over `splits` point ranges into `partial`
// (splits x total f32), then their fixed-order sum into dw (total f32).
// wn: kNumDw device pointers in DwIndex order, as packed ([in][out]);
// wcf_t: wcf transposed. Returns 0, a cudaError_t, or -1 for arguments the
// kernels do not take.
extern "C" int fused_field_train_bwd_launch(
    const float* x, long long n, const float* g, const void* res,
    const float* emb_E, const float* emb_phase, const float* emb_id,
    const void* const* wn, int n_weights, const void* wcf_t, int width,
    int n_out, int vf_cols, void* const* deltas, int n_deltas, int n_gemm,
    const void* const* gemm_act, const void* const* gemm_delta,
    const int* gemm_dims, const long long* gemm_off, int n_sum,
    const void* const* sum_delta, const int* sum_dims,
    const long long* sum_off, int splits, float* partial, long long total,
    float* dw, void* stream) {
  const Dims d{n_out, vf_cols};
  if (!dims_ok(n, n_weights, width, d) || n_deltas != kNumDeltas ||
      n_gemm <= 0 || n_gemm > kMaxGemm || n_sum <= 0 || n_sum > kMaxSum ||
      splits <= 0 || total <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunk = ((n + splits - 1) / splits + kGP - 1) / kGP * kGP;

  GemmJobs gj;
  gj.count = n_gemm;
  int tiles = 0;
  for (int i = 0; i < n_gemm; ++i) {
    GemmJob& J = gj.j[i];
    J.act = static_cast<const bf16_t*>(gemm_act[i]);
    J.delta = static_cast<const bf16_t*>(gemm_delta[i]);
    J.lda = gemm_dims[4 * i];
    J.ldd = gemm_dims[4 * i + 1];
    J.m = gemm_dims[4 * i + 2];
    J.n = gemm_dims[4 * i + 3];
    J.off = gemm_off[i];
    J.tiles_n = (J.n + kGT - 1) / kGT;
    J.tile_begin = tiles;
    tiles += (J.m + kGT - 1) / kGT * J.tiles_n;
  }
  SumJobs sj;
  sj.count = n_sum;
  sj.total_cols = 0;
  for (int i = 0; i < n_sum; ++i) {
    SumJob& J = sj.j[i];
    J.delta = sum_delta[i];
    J.ldd = sum_dims[3 * i];
    J.cols = sum_dims[3 * i + 1];
    J.is_f32 = sum_dims[3 * i + 2];
    J.off = sum_off[i];
    J.col_begin = sj.total_cols;
    sj.total_cols += J.cols;
  }

  if (n > 0) {
    Weights w;
    for (int i = 0; i < kNumDw; ++i) w.p[i] = static_cast<const bf16_t*>(wn[i]);
    Deltas out;
    for (int i = 0; i < kNumDeltas; ++i) out.p[i] = static_cast<bf16_t*>(deltas[i]);
    const Emb emb{emb_E, emb_phase, emb_id};
    const size_t smem = chain_smem(d);
    cudaError_t err = cudaFuncSetAttribute(
        k3_delta_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
    k3_delta_chain<<<blocks, kThreads, smem, s>>>(
        x, n, g, static_cast<const bf16_t*>(res), emb, w,
        static_cast<const bf16_t*>(wcf_t), d, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k3_dw_gemm<<<dim3(tiles, splits), kThreads, 0, s>>>(gj, n, chunk, partial, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_colsum<<<dim3((sj.total_cols + 127) / 128, splits), 128, 0, s>>>(
      sj, n, chunk, partial, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_reduce<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      partial, splits, total, dw);
  return static_cast<int>(cudaGetLastError());
}
