// The weight slab stream shared by K2 (csrc/fused_field_train.cu) and K1's
// bf16-weight variant (csrc/fused_field_bf16.cu): the packed bf16 weights of
// a chain of layers, as B = [n][k] operands, cut into slabs of kSlabN output
// columns (one pass) by kSlabK reduction rows and laid out slab after slab in
// the order a kernel consumes them. A B of at most kNarrowN columns (the
// output heads) takes narrow slabs instead: kNarrowN columns by kNarrowK
// reduction rows, kept as kNarrowK / kSlabK blocks of [kNarrowN][kSlabK], so
// that a slab of either kind is kSlabN rows of kSlabK (64 bytes) in memory.
// The plain versions and the schedules are in kernels/fused_field_train.py
// (`forward_schedule`, `density_schedule`, `forward_slabs`, `density_slabs`).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

typedef unsigned short bf16_t;  // bf16 bits

constexpr int kWidth = 256;  // trunk width the kernels are written for
constexpr int kLane = 128;   // embedding lanes
constexpr int kInCols = 8;   // packed input [pts | dirs | 0-pad]

// Same names, same order as _DW_ORDER in kernels/fused_field_train.py.
enum DwIndex {
  kW0, kW1, kW2, kW3, kW4, kW5x, kW5h, kW6, kW7,
  kTb, kWpf, kBpf, kWfeat, kBfeat, kWvF, kWvD, kBv,
  kWcf, kBcf, kA, kB, kC, kD, kBias,
  kNumDw
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

constexpr int kSlabN = 256;
constexpr int kSlabK = 32;
constexpr int kSlabElems = kSlabN * kSlabK;
constexpr int kNarrowN = 32;
constexpr int kNarrowK = kSlabElems / kNarrowN;

// Output columns and reduction rows of one slab of a B with n columns.
__host__ __device__ constexpr int slab_n(int n) { return n <= kNarrowN ? kNarrowN : kSlabN; }
__host__ __device__ constexpr int slab_k(int n) { return kSlabElems / slab_n(n); }

int passes(int cols) { return (cols + kSlabN - 1) / kSlabN; }
int k_slabs(int k) { return (k + kSlabK - 1) / kSlabK; }
int narrow_slabs(int k) { return (k + kNarrowK - 1) / kNarrowK; }

// Slabs the trunk consumes: h0 (256, k 128), h1..h4 (k 256 each), h5 (k
// 128 + 256), h6, h7 (k 256 each).
int trunk_slab_count() {
  return passes(kWidth) * (k_slabs(kLane) + 4 * k_slabs(kWidth) + k_slabs(kLane) +
                           k_slabs(kWidth) + 2 * k_slabs(kWidth));
}

// Slabs the forward consumes: the trunk's, pf (k 256), the heads A, B
// (narrow, k 256 each), ft (k 256), hv (k 256 + 128), vf (vf_cols, k 256),
// the heads C, D (narrow, k 256 and vf_cols).
int forward_slab_count(const Dims& d) {
  const int w = passes(kWidth);
  return trunk_slab_count() + w * k_slabs(kWidth) + 2 * narrow_slabs(kWidth) +
         w * k_slabs(kWidth) + w * (k_slabs(kWidth) + k_slabs(kLane)) +
         passes(d.vf_cols) * k_slabs(kWidth) + narrow_slabs(kWidth) + narrow_slabs(d.vf_cols);
}

// One weight of a chain, read as B = [n][k] (w itself, or w^T when
// trans), with the slab index of its first pass's first k-slab and the
// slabs of one pass of its layer.
struct SlabOp {
  const bf16_t* w;
  int trans, n, k, first, stride;
};
constexpr int kMaxSlabOps = 24;
struct SlabOps {
  SlabOp o[kMaxSlabOps];
};

// Block (x, y) writes slab x of op y, zero past its n and k; a slab's
// rows are (k-block, column) pairs, kSlabK reduction rows each.
__device__ __forceinline__ void pack_slab(const SlabOp o, bf16_t* __restrict__ slabs) {
  const int sn = slab_n(o.n), sk = slab_k(o.n);
  const int ks = (o.k + sk - 1) / sk, np = (o.n + sn - 1) / sn;
  if (static_cast<int>(blockIdx.x) >= ks * np) return;
  const int p = blockIdx.x / ks, s = blockIdx.x % ks;
  bf16_t* dst = slabs + static_cast<long long>(o.first + p * o.stride + s) * kSlabElems;
  const int cols = o.trans ? o.n : o.k;  // of w
  for (int e = threadIdx.x; e < kSlabElems; e += blockDim.x) {
    const int row = e / kSlabK;
    const int nn = p * sn + row % sn, kk = s * sk + row / sn * kSlabK + e % kSlabK;
    bf16_t v = 0;
    if (nn < o.n && kk < o.k) v = o.trans ? o.w[kk * cols + nn] : o.w[nn * cols + kk];
    dst[e] = v;
  }
}

// The slab op table (6 ints per op: weight index in DwIndex order, trans,
// n, k, first, stride) into `so`; false for an op the stream of n_slabs
// slabs cannot hold. max_slabs: the most slabs of one op (the pack grid).
bool read_slab_ops(const int* slab_ops, int n_ops, const void* const* wn, int n_slabs,
                   SlabOps& so, int& max_slabs) {
  if (n_ops <= 0 || n_ops > kMaxSlabOps) return false;
  max_slabs = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int* v = slab_ops + 6 * i;
    if (v[0] < 0 || v[0] >= kNumDw || v[2] <= 0 || v[3] <= 0 || v[4] < 0 || v[5] <= 0)
      return false;
    const int sn = slab_n(v[2]), sk = slab_k(v[2]);
    const int ks = (v[3] + sk - 1) / sk, np = (v[2] + sn - 1) / sn;
    if (v[4] + (np - 1) * v[5] + ks > n_slabs) return false;
    so.o[i] = SlabOp{static_cast<const bf16_t*>(wn[v[0]]), v[1], v[2], v[3], v[4], v[5]};
    max_slabs = max(max_slabs, ks * np);
  }
  return true;
}

}  // namespace
