// K1: the fused IBL-NeRF field query (no gradient), for Hopper (sm_90a).
//
// Replaces ibl_nerf_tpu/kernels/fused_field.py::_field_kernel (the Pallas
// TPU kernel reached by pl.pallas_call in _fused_call). Per point it computes
//   emb = where(id, t, sin(t + phase)),  t = x @ E          (x = [pts|dirs|0])
//   h   = the 8-layer ReLU trunk, layer 5 as emb@w5x + h@w5h
// and then either the density only, out = h@A[:, 0] + bias[0], or the heads
// of one head set (`HeadSet`, chosen by the march that reads them):
//   pos_feat  = relu(h@wpf + bpf)          feature = h@wfeat + bfeat
//   h2        = relu(feature@wv_f + emb@wv_d + bv)
//   view_feat = relu(h2@wcf + bcf)
//   out = h@A + pos_feat@B + h2@C + view_feat@D + bias  (cols [σ, albedo3, ρ,
//   irr, rad3, coarse3K]).
// `all` computes every column. `reflected` (the split-sum reflected march)
// drops pos_feat and B and projects A onto σ only: out [σ, rad3, coarse3K].
// `incident` (the Monte-Carlo incident march) also drops view_feat and D:
// out [σ, rad3]. A kept column is summed by the same lanes in the same order
// under every set, so it is bit-equal to `all`'s. At 8x256 and K = 3 a point
// costs 795,776 multiply-adds under `all`, 729,472 under `reflected` (-8.3%)
// and 630,016 under `incident` (-20.8%).
//
// What bounds it: the f32 FMA rate. A point brings 32 B and takes at most
// 4(9+3K) B away, but costs ~0.98 MFLOP (density), ~1.26 (`incident`) or
// ~1.59 (`all`) at 8x256: ~10^4 operations per byte, far above the card's
// 67 TFLOP/s f32 over 3.35 TB/s (~20 per byte). The weights (~2.6 MB f32) do
// not fit an SM's 227 KB of shared memory, so every block streams them from
// L2 through L1, and the loads that feed the FMAs (weights and activations)
// compete with them for issue slots and L1 bandwidth. Knocking parts out of
// the density variant's earlier 8x8 tile (k3_knockout.py k1, 1,572,864
// points, 33.7 ms) showed which: with its weight loads replaced by a
// register constant it took 28.1 ms, with its activation loads replaced
// 32.6 ms, with one FMA in 8 (every load kept) 24.5 ms: the weight loads
// held it most (they hit L1 when a co-resident block has just read the same
// rows; loaded past L1, the new tile below takes 5.4 ms longer).
//
// What the full variants do about it: a block owns a tile of 64 points and
// keeps their activations on chip, in shared memory, transposed
// ([feature][point], stride 68 floats). Its 8 warps form 2 quads of 4; a
// quad owns 32 points, and each of its warps a quarter of a layer's
// columns. A lane keeps an 8x8 accumulator tile in registers (8 points x 8
// columns; 8x4 for a lone coarse head): per k it loads its 8 activations as
// two 16-byte shared loads that 8 lanes share, and its 8 weights as two
// 16-byte loads of 4 adjacent columns that 4 lanes share, so a warp reads
// 128 distinct bytes of activations and 256 of weights per 64 FMAs a lane.
// Only the quad's warps read each other's activations, so a layer's
// in-place store sits between two 128-thread named barriers and the block
// never waits as a whole.
//
// What the density variant does about it: more FMAs per loaded operand, on
// a lane tile of its own. A block is one quad (128 threads) owning the
// 64-point tile; each warp owns a quarter of a layer's columns for all 64
// points, and a lane holds 16 points x 8 columns (128 accumulators, 217
// registers, no spill). Per k a lane loads its 16 activations as four
// 16-byte shared loads that 8 lanes share and its 8 weights as two 16-byte
// loads that 4 lanes share: 6 loads for 128 FMAs, where the 8x8 tile took
// 4 for 64, and each weight is loaded once a tile instead of once a quad.
// The next k's operands load while this k's FMAs issue (two fragments in
// registers, the pair loop unrolled twice). Two blocks an SM (8 warps)
// overlap one block's barriers with the other's FMAs. Each trunk activation
// is summed over k in order by one lane with fmaf, then biased and
// rectified, as in the full variants, so it is bit-equal to theirs; only σ's
// 256-term sum differs in order (lane, xor butterfly over the column
// groups, then the 4 warps). Timed and dropped: 8 points x 16 columns (two
// more weight loads a k, 15% slower), the pair loop not unrolled or
// unrolled 4 times, L1 prefetches of the weights 4-16 rows ahead, two quads
// a block (in step or not), the FMAs column-major.
//
// The narrow output heads never reach shared memory. A layer whose output
// feeds a head projects it in its epilogue: per raw column, each lane sums
// its 8 columns' share for its 8 points, a butterfly reduce-scatter over the
// 8 lanes of its point group (7 shuffles) leaves one point's sum in each
// lane, and the lane adds it to its warp's rows of the raw accumulator O
// (one per warp of the quad, summed in a fixed order at the end). So A goes
// into layer 7's epilogue, B into pos_feat's (which is never stored), C into
// h2's, and each D_k into its view_feat tile's (never stored; the K heads
// run as 256-column tiles of two heads and a 128-column tile for an odd last
// one). `feature` and then `h2` overwrite h in place; there is no plane for
// the head features. A projection reads only the raw columns the wrapper
// names for it (`Projs`, from the raw layout): 18 columns at K=3. Only the
// embedding lanes that carry data are read (the packed rows of w0/w5x beyond
// in_ch and of wv_d outside the direction lanes are zero).
//
// Shared memory per block: the full variant X (in_ch + in_views rows) + H
// (256) + O (4 x the kept columns): 418 rows x 68 floats x 4 B = 113,696 B
// for `all` at K=3 (9+3K columns), 398 rows, 108,256 B for `reflected`
// (4+3K), 362 rows, 98,464 B for `incident` (4); the density variant X
// (in_ch) + H: 319 rows, 86,768 B (σ's 4 partial sums go to X, read no more
// by then). Every variant fits two blocks per SM: the full variants' 16
// warps under 128 registers a thread, the density variant's 8 under 255.
// Arithmetic is f32 FMA with f32 accumulation, sinf (not
// __sinf; no fast math) on the full range. The ragged last tile is masked in
// the kernel; offsets are 64-bit.
//
// On an NVIDIA H100 80GB HBM3 at a 700 W power limit (k3_knockout.py k1):
// the full variant takes 4.83 ms at 131,072 points against its 3.11 ms
// bound (67 TFLOP/s f32), the density variant 31.1 ms at 1,572,864 points
// against 23.07 ms (33.7 on the 8x8 tile, in turns); in turns with `all`
// (chip_smoke.py's kernel phase), `reflected` 4.55 ms against `all`'s 4.93
// at 131,072 points (bound 2.85 ms) and `incident` 35.4 ms against 42.1 at
// 1,179,648 (bound 22.18 ms).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTile = 64;           // points per block
constexpr int kThreads = 256;       // 8 warps
constexpr int kStride = kTile + 4;  // floats between two features of a tile
constexpr int kWidth = 256;         // trunk width the tiling is written for
constexpr int kHalf = kWidth / 2;
constexpr int kInCols = 8;
constexpr int kLane = 128;
constexpr int kMaxCoarse = 39;      // n_out = 9 + 3K <= 128, as the JAX kernel's lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDropped = 5;         // albedo3, ρ, irr: raw columns 1..5
// The density variant's lane tile: a block of 4 warps (one quad) owns the
// 64-point tile, each warp a quarter of a layer's columns for all 64
// points, each lane kDPts points x kDCols columns (128 accumulators).
constexpr int kDensityThreads = 128;
constexpr int kDPts = 16;            // points a lane holds
constexpr int kDCols = 128 / kDPts;  // columns a lane holds
constexpr int kDPg = kTile / kDPts;  // lanes along the points (point groups)
constexpr int kDCg = 32 / kDPg;      // lanes along the columns (column groups)

// The heads a full variant computes: every one, those the reflected march
// reads (σ, rad3, coarse3K) or those the incident march reads (σ, rad3).
// The kept columns keep their raw order, so raw column c >= 6 is kept
// column c - kDropped.
enum HeadSet { kAll, kReflected, kIncident };

// The entry points' `variant`: a full head set or the density only.
enum Variant { kVariantAll, kVariantDensity, kVariantReflected, kVariantIncident };

// Same names, same order as _WEIGHT_ORDER in kernels/fused_field.py.
enum WeightIndex {
  kEmbE, kEmbPhase, kEmbId,
  kW0, kW1, kW2, kW3, kW4, kW5x, kW5h, kW6, kW7,
  kTb, kWpf, kBpf, kWfeat, kBfeat, kWvF, kWvD, kBv,
  kWcf, kBcf, kA, kB, kC, kD, kBias,
  kNumWeights
};

struct Weights {
  const float* p[kNumWeights];
};

struct Dims {
  int in_ch;     // position embedding channels (63 at multires 10)
  int in_views;  // direction embedding channels (27 at multires 4)
  int n_coarse;  // K coarse-radiance heads
  int n_out;     // 9 + 3K
};

// The columns of a head set's output (and rows of each warp's O plane).
template <HeadSet H>
__host__ __device__ __forceinline__ int n_kept(const Dims& d) {
  return H == kAll ? d.n_out : H == kReflected ? d.n_out - kDropped : 4;
}

// The raw columns [lo[r], hi[r]) (r < 2) a projection may be nonzero in:
// A, B, C, then D_k for head k (kernels/fused_field.projection_columns).
struct Proj {
  int lo[2], hi[2];
};
struct Projs {
  Proj p[3 + kMaxCoarse];
};

// A block's 8 warps form 2 quads; a quad owns 32 points of the tile and
// splits a layer's columns in 4: warp `wq` of the quad takes a quarter. In
// a warp, lane l takes 8 points (point group pg = l & 3) and 4 adjacent
// columns per 32 (column group cg = l >> 2), so per k a warp loads 4
// distinct 32-byte runs of activations, each shared by 8 lanes, and 2 runs
// of 128 bytes of weights, each 16 bytes shared by 4 lanes, for 64 FMAs a
// lane.
struct Place {
  int lane, wq, quad, cg;
  int prow;  // the first of the lane's 8 points in the tile
};

// The column of a layer's NCOL * 32 that a lane holds in slot j of its tile.
template <int NCOL>
__device__ __forceinline__ int col_of(const Place& t, int j) {
  return t.wq * 8 * NCOL + 4 * t.cg + (j & 3) + 32 * (j >> 2);
}

// Waits for the 4 warps of the quad (named barrier 1 + quad, 128 threads).
__device__ __forceinline__ void quad_sync(int quad) {
  asm volatile("bar.sync %0, 128;" ::"r"(quad + 1) : "memory");
}

// acc[i][j] += sum_k in[k][prow + i] * w[k * ldw + col_of(j)]
template <int NCOL>
__device__ __forceinline__ void mac(float (&acc)[8][NCOL],
                                    const float* __restrict__ in, int k_dim,
                                    const float* __restrict__ w, int ldw,
                                    const Place& t) {
  const float* wl = w + t.wq * 8 * NCOL + 4 * t.cg;
#pragma unroll 4
  for (int k = 0; k < k_dim; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(in + k * kStride + t.prow);
    const float4 a1 =
        *reinterpret_cast<const float4*>(in + k * kStride + t.prow + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float* wk = wl + static_cast<size_t>(k) * ldw;
#pragma unroll
    for (int q = 0; q < NCOL / 4; ++q) {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(wk + 32 * q));
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], b[jj], acc[i][j]);
      }
    }
  }
}

// v = act(in1 @ w1 + in2 @ w2 + bias) for the lane's 8 points and columns,
// every matrix with leading dimension ldw (a multiple of 4, every matrix
// 16-byte aligned).
template <int NCOL>
__device__ __forceinline__ void dense(float (&v)[8][NCOL], const float* in1,
                                      int k1, const float* __restrict__ w1,
                                      const float* in2, int k2,
                                      const float* __restrict__ w2, int ldw,
                                      const float* __restrict__ bias, bool relu,
                                      const Place& t) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NCOL; ++j) v[i][j] = 0.f;
  mac<NCOL>(v, in1, k1, w1, ldw, t);
  if (in2 != nullptr) mac<NCOL>(v, in2, k2, w2, ldw, t);
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    const float b = __ldg(bias + col_of<NCOL>(t, j));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i][j] += b;
      if (relu) v[i][j] = fmaxf(v[i][j], 0.f);
    }
  }
}

// out[col_of(j)][prow + i] = v[i][j]. `out` may be the layer's input: the
// quad's warps finish reading before the first write.
template <int NCOL>
__device__ __forceinline__ void store(float* out, const float (&v)[8][NCOL],
                                      const Place& t) {
  quad_sync(t.quad);
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    float* dst = out + col_of<NCOL>(t, j) * kStride + t.prow;
    *reinterpret_cast<float4*>(dst) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(v[4][j], v[5][j], v[6][j], v[7][j]);
  }
  quad_sync(t.quad);
}

// The sum of s[i] over the 8 lanes of this lane's point group, for its
// point i = lane >> 2: a butterfly reduce-scatter that halves the points at
// offsets 16, 8 and 4 (7 shuffles).
__device__ __forceinline__ float group_sum_scatter(const float (&s)[8],
                                                   int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    a[m] = (b4 ? s[m + 4] : s[m]) +
           __shfl_xor_sync(kFull, b4 ? s[m] : s[m + 4], 16);
#pragma unroll
  for (int m = 0; m < 2; ++m)
    b[m] = (b3 ? a[m + 2] : a[m]) +
           __shfl_xor_sync(kFull, b3 ? a[m] : a[m + 2], 8);
  return (b2 ? b[1] : b[0]) + __shfl_xor_sync(kFull, b2 ? b[0] : b[1], 4);
}

// This warp's share of raw column c of v @ P for the lane's point
// prow + (lane >> 2), where P holds the layer's NCOL * 32 rows
// (leading dimension n_out).
template <int NCOL>
__device__ __forceinline__ float project_col(const float (&v)[8][NCOL],
                                             const float* __restrict__ P,
                                             int n_out, int c, const Place& t) {
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    const float w = __ldg(P + col_of<NCOL>(t, j) * n_out + c);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = fmaf(v[i][j], w, s[i]);
  }
  return group_sum_scatter(s, t.lane);
}

// O[wq][c'][point] += this warp's share of (v @ P)[point][c] for every raw
// column c of the projection, c' its column in head set H's output (n_keep
// of them). Each (wq, c', point) is written by the same lane on every call,
// so O needs no synchronisation until it is read.
template <int NCOL, HeadSet H>
__device__ __forceinline__ void project(float* O, int n_keep,
                                        const float (&v)[8][NCOL],
                                        const float* __restrict__ P,
                                        int n_out, const Proj& pr,
                                        const Place& t) {
  float* o0 = O + t.wq * n_keep * kStride + t.prow + (t.lane >> 2);
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    // a range past the dropped heads sits kDropped columns lower
    float* o = o0 - (H != kAll && pr.lo[r] > 0 ? kDropped * kStride : 0);
#pragma unroll 1
    for (int c = pr.lo[r]; c < pr.hi[r]; ++c) {
      const float s = project_col<NCOL>(v, P, n_out, c, t);
      o[c * kStride] += s;
    }
  }
}

// The density variant's place: warp wq owns columns [64 wq, 64 wq + 64) of
// a layer for the tile's 64 points; lane l is in point group pg = l % kDPg
// and column group cg = l / kDPg. Its points are 4 runs of 4 (16x8) or 2
// (8x16) at 4 pg + 4 kDPg m, so per k a warp's activation loads read
// 4 kDPg adjacent floats each, shared by kDCg lanes (no bank conflict);
// its columns are runs of 4 at 4 cg + 4 kDCg q, 16 bytes shared by kDPg
// lanes.
struct DPlace {
  int wq, pg, cg;
};

// The tile point the lane holds in slot i, and the column in slot j.
__device__ __forceinline__ int dpoint(const DPlace& t, int i) {
  return 4 * t.pg + (i & 3) + 4 * kDPg * (i >> 2);
}
__device__ __forceinline__ int dcol(const DPlace& t, int j) {
  return kWidth / 4 * t.wq + 4 * t.cg + (j & 3) + 4 * kDCg * (j >> 2);
}

// One k's operands of a lane: its activations of row k and weights of row k.
struct DFrag {
  float a[kDPts], b[kDCols];
};

__device__ __forceinline__ void dload(DFrag& f, const float* il,
                                      const float* __restrict__ wl, int k) {
#pragma unroll
  for (int m = 0; m < kDPts / 4; ++m) {
    const float4 a4 =
        *reinterpret_cast<const float4*>(il + k * kStride + 4 * kDPg * m);
    f.a[4 * m] = a4.x;
    f.a[4 * m + 1] = a4.y;
    f.a[4 * m + 2] = a4.z;
    f.a[4 * m + 3] = a4.w;
  }
  const float* wk = wl + static_cast<size_t>(k) * kWidth;
#pragma unroll
  for (int q = 0; q < kDCols / 4; ++q) {
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(wk + 4 * kDCg * q));
    f.b[4 * q] = b4.x;
    f.b[4 * q + 1] = b4.y;
    f.b[4 * q + 2] = b4.z;
    f.b[4 * q + 3] = b4.w;
  }
}

__device__ __forceinline__ void dfma(float (&acc)[kDPts][kDCols],
                                     const DFrag& f) {
#pragma unroll
  for (int i = 0; i < kDPts; ++i)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = fmaf(f.a[i], f.b[j], acc[i][j]);
}

// acc[i][j] += sum_k in[k][dpoint(i)] * w[k * kWidth + dcol(j)], k in order;
// the next k's operands load while this k's FMAs issue (two fragments in
// registers; the last pair reloads row k_dim - 1, unused).
__device__ __forceinline__ void dmac(float (&acc)[kDPts][kDCols],
                                     const float* __restrict__ in, int k_dim,
                                     const float* __restrict__ w,
                                     const DPlace& t) {
  const float* il = in + 4 * t.pg;
  const float* wl = w + kWidth / 4 * t.wq + 4 * t.cg;
  DFrag f0, f1;
  dload(f0, il, wl, 0);
  int k = 0;
#pragma unroll 2
  for (; k + 1 < k_dim; k += 2) {
    dload(f1, il, wl, k + 1);
    dfma(acc, f0);
    dload(f0, il, wl, min(k + 2, k_dim - 1));
    dfma(acc, f1);
  }
  if (k < k_dim) dfma(acc, f0);
}

// v = relu(in1 @ w1 + in2 @ w2 + bias) for the lane's points and columns;
// every matrix kWidth columns wide.
__device__ __forceinline__ void ddense(float (&v)[kDPts][kDCols],
                                       const float* in1, int k1,
                                       const float* __restrict__ w1,
                                       const float* in2, int k2,
                                       const float* __restrict__ w2,
                                       const float* __restrict__ bias,
                                       const DPlace& t) {
#pragma unroll
  for (int i = 0; i < kDPts; ++i)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) v[i][j] = 0.f;
  dmac(v, in1, k1, w1, t);
  if (in2 != nullptr) dmac(v, in2, k2, w2, t);
#pragma unroll
  for (int j = 0; j < kDCols; ++j) {
    const float b = __ldg(bias + dcol(t, j));
#pragma unroll
    for (int i = 0; i < kDPts; ++i) {
      v[i][j] += b;
      v[i][j] = fmaxf(v[i][j], 0.f);
    }
  }
}

// out[dcol(j)][dpoint(i)] = v[i][j], in place of the layer's input once
// every warp of the block has read it (the block is one quad, so the
// quad's named barrier serves).
__device__ __forceinline__ void dstore(float* out,
                                       const float (&v)[kDPts][kDCols],
                                       const DPlace& t) {
  quad_sync(0);
#pragma unroll
  for (int j = 0; j < kDCols; ++j) {
    float* dst = out + dcol(t, j) * kStride + 4 * t.pg;
#pragma unroll
    for (int m = 0; m < kDPts / 4; ++m)
      *reinterpret_cast<float4*>(dst + 4 * kDPg * m) = make_float4(
          v[4 * m][j], v[4 * m + 1][j], v[4 * m + 2][j], v[4 * m + 3][j]);
  }
  quad_sync(0);
}

// The density variant: out = h @ A[:, 0] + bias[0] for the block's 64 points.
__device__ __forceinline__ void density_field(const float* __restrict__ x,
                                              long long n, const Weights& w,
                                              const Dims& d, float* smem,
                                              float* __restrict__ out) {
  float* X = smem;                   // embedding, in_ch features
  float* H = X + d.in_ch * kStride;  // trunk activations
  DPlace t;
  const int lane = threadIdx.x & 31;
  t.wq = threadIdx.x >> 5;
  t.pg = lane % kDPg;
  t.cg = lane / kDPg;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  // Positional encoding of the 64 points, as the full variant's: x staged
  // in H's first 8 rows, t = x @ E, then t or sin(t + phase).
  for (int idx = threadIdx.x; idx < kTile * kInCols; idx += kDensityThreads) {
    const int pt = idx >> 3, c = idx & 7;
    const long long p = base + pt;
    H[c * kStride + pt] = p < n ? __ldg(x + p * kInCols + c) : 0.f;
  }
  quad_sync(0);
  for (int idx = threadIdx.x; idx < d.in_ch * kTile; idx += kDensityThreads) {
    const int l = idx >> 6, pt = idx & (kTile - 1);
    float u = 0.f;
#pragma unroll
    for (int c = 0; c < kInCols; ++c)
      u = fmaf(H[c * kStride + pt], __ldg(w.p[kEmbE] + c * kLane + l), u);
    X[l * kStride + pt] =
        __ldg(w.p[kEmbId] + l) > 0.f ? u : sinf(u + __ldg(w.p[kEmbPhase] + l));
  }
  quad_sync(0);

  float v[kDPts][kDCols];
  const float* tb = w.p[kTb];
  ddense(v, X, d.in_ch, w.p[kW0], nullptr, 0, nullptr, tb, t);
  dstore(H, v, t);
  const int mid[4] = {kW1, kW2, kW3, kW4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ddense(v, H, kWidth, w.p[mid[i]], nullptr, 0, nullptr,
           tb + (i + 1) * kWidth, t);
    dstore(H, v, t);
  }
  ddense(v, X, d.in_ch, w.p[kW5x], H, kWidth, w.p[kW5h], tb + 5 * kWidth, t);
  dstore(H, v, t);
  ddense(v, H, kWidth, w.p[kW6], nullptr, 0, nullptr, tb + 6 * kWidth, t);
  dstore(H, v, t);
  ddense(v, H, kWidth, w.p[kW7], nullptr, 0, nullptr, tb + 7 * kWidth, t);

  // σ, h never stored: each lane sums its columns' share for its points,
  // the warp's column groups add theirs (xor butterfly, so every lane of a
  // point group ends with the same sum), column group 0 writes the warp's
  // share to X row wq (X is read no more), and the 4 shares are added in
  // warp order.
  float s[kDPts];
#pragma unroll
  for (int i = 0; i < kDPts; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kDCols; ++j) {
    const float a = __ldg(w.p[kA] + dcol(t, j) * d.n_out);
#pragma unroll
    for (int i = 0; i < kDPts; ++i) s[i] = fmaf(v[i][j], a, s[i]);
  }
#pragma unroll
  for (int off = kDPg; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < kDPts; ++i) s[i] += __shfl_xor_sync(kFull, s[i], off);
  if (t.cg == 0) {
#pragma unroll
    for (int i = 0; i < kDPts; ++i) X[t.wq * kStride + dpoint(t, i)] = s[i];
  }
  quad_sync(0);
  if (threadIdx.x < kTile) {
    const long long p = base + threadIdx.x;
    const float* xs = X + threadIdx.x;
    if (p < n)
      out[p] = xs[0] + xs[kStride] + xs[2 * kStride] + xs[3 * kStride] +
               __ldg(w.p[kBias]);
  }
}

// A full variant: the heads of head set H for the block's 64 points.
template <HeadSet kHeads>
__device__ __forceinline__ void full_field(const float* __restrict__ x,
                                           long long n, const Weights& w,
                                           const Dims& d, const Projs& ps,
                                           float* smem,
                                           float* __restrict__ out) {
  const int n_emb = d.in_ch + d.in_views;
  float* X = smem;                  // embedding, n_emb features
  float* H = X + n_emb * kStride;   // trunk activations, then feature, h2
  float* O = H + kWidth * kStride;  // kept output sums of each wq (full)
  const int n_keep = n_kept<kHeads>(d);

  Place t;
  t.lane = threadIdx.x & 31;
  t.wq = (threadIdx.x >> 5) & 3;
  t.quad = threadIdx.x >> 7;
  t.cg = t.lane >> 2;
  const int q0 = t.quad * 32;  // the quad's first point in the tile
  t.prow = q0 + 8 * (t.lane & 3);
  const int qt = threadIdx.x & 127;
  const long long base = static_cast<long long>(blockIdx.x) * kTile + q0;

  // Positional encoding of the quad's 32 points. x is staged in H's first
  // 8 rows (free until layer 0 stores); then t = x @ E (one nonzero per
  // column), and the identity lanes pass t while the others take
  // sin(t + phase). A warp's 32 threads share one embedding lane.
  for (int idx = qt; idx < 32 * kInCols; idx += 128) {
    const int pt = idx >> 3, c = idx & 7;
    const long long p = base + pt;
    H[c * kStride + q0 + pt] = p < n ? __ldg(x + p * kInCols + c) : 0.f;
  }
  for (int idx = t.lane; idx < n_keep * 32; idx += 32)
    O[(t.wq * n_keep + (idx >> 5)) * kStride + q0 + (idx & 31)] = 0.f;
  quad_sync(t.quad);
  for (int idx = qt; idx < n_emb * 32; idx += 128) {
    const int l = idx >> 5, pt = idx & 31;
    float u = 0.f;
#pragma unroll
    for (int c = 0; c < kInCols; ++c)
      u = fmaf(H[c * kStride + q0 + pt], __ldg(w.p[kEmbE] + c * kLane + l), u);
    X[l * kStride + q0 + pt] =
        __ldg(w.p[kEmbId] + l) > 0.f ? u : sinf(u + __ldg(w.p[kEmbPhase] + l));
  }
  quad_sync(t.quad);

  float v[8][8];
  const float* tb = w.p[kTb];
  dense<8>(v, X, d.in_ch, w.p[kW0], nullptr, 0, nullptr, kWidth, tb, true, t);
  store<8>(H, v, t);
  const int mid[4] = {kW1, kW2, kW3, kW4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dense<8>(v, H, kWidth, w.p[mid[i]], nullptr, 0, nullptr, kWidth,
             tb + (i + 1) * kWidth, true, t);
    store<8>(H, v, t);
  }
  dense<8>(v, X, d.in_ch, w.p[kW5x], H, kWidth, w.p[kW5h], kWidth,
           tb + 5 * kWidth, true, t);
  store<8>(H, v, t);
  dense<8>(v, H, kWidth, w.p[kW6], nullptr, 0, nullptr, kWidth,
           tb + 6 * kWidth, true, t);
  store<8>(H, v, t);
  dense<8>(v, H, kWidth, w.p[kW7], nullptr, 0, nullptr, kWidth,
           tb + 7 * kWidth, true, t);

  store<8>(H, v, t);
  if (kHeads == kAll) {
    project<8, kHeads>(O, n_keep, v, w.p[kA], d.n_out, ps.p[0], t);
    dense<8>(v, H, kWidth, w.p[kWpf], nullptr, 0, nullptr, kWidth, w.p[kBpf],
             true, t);  // pos_feat, projected and dropped
    project<8, kHeads>(O, n_keep, v, w.p[kB], d.n_out, ps.p[1], t);
  } else {
    const Proj sigma{{0, 0}, {1, 0}};  // A onto σ alone
    project<8, kHeads>(O, n_keep, v, w.p[kA], d.n_out, sigma, t);
  }
  dense<8>(v, H, kWidth, w.p[kWfeat], nullptr, 0, nullptr, kWidth,
           w.p[kBfeat], false, t);
  store<8>(H, v, t);  // feature overwrites h
  // h2 overwrites feature; the direction rows of wv_d sit at lanes
  // [in_ch, in_ch + in_views).
  dense<8>(v, H, kWidth, w.p[kWvF], X + d.in_ch * kStride, d.in_views,
           w.p[kWvD] + static_cast<size_t>(d.in_ch) * kWidth, kWidth,
           w.p[kBv], true, t);
  store<8>(H, v, t);
  project<8, kHeads>(O, n_keep, v, w.p[kC], d.n_out, ps.p[2], t);

  // view_feat, two heads (256 columns) at a time, each tile projected onto
  // its heads' columns of D with the tile's rows of D and dropped; none for
  // the incident march.
  const int n_coarse = kHeads == kIncident ? 0 : d.n_coarse;
  const int ldcf = d.n_coarse * kHalf;
  int k = 0;
#pragma unroll 1
  for (; k + 2 <= n_coarse; k += 2) {
    dense<8>(v, H, kWidth, w.p[kWcf] + k * kHalf, nullptr, 0, nullptr, ldcf,
             w.p[kBcf] + k * kHalf, true, t);
    const float* Dk = w.p[kD] + static_cast<size_t>(k) * kHalf * d.n_out;
    project<8, kHeads>(O, n_keep, v, Dk, d.n_out, ps.p[3 + k], t);
    project<8, kHeads>(O, n_keep, v, Dk, d.n_out, ps.p[4 + k], t);
  }
  if (k < n_coarse) {
    float v4[8][4];
    dense<4>(v4, H, kWidth, w.p[kWcf] + k * kHalf, nullptr, 0, nullptr, ldcf,
             w.p[kBcf] + k * kHalf, true, t);
    project<4, kHeads>(O, n_keep, v4,
                       w.p[kD] + static_cast<size_t>(k) * kHalf * d.n_out,
                       d.n_out, ps.p[3 + k], t);
  }

  // out = the 4 warps' sums + bias of the kept columns; warp wq writes the
  // quad's points 8 wq .. 8 wq + 7.
  quad_sync(t.quad);
  const int ldo = n_keep * kStride;
  for (int idx = t.lane; idx < 8 * n_keep; idx += 32) {
    const int i = idx / n_keep, c = idx % n_keep;
    const int raw = kHeads == kAll || c == 0 ? c : c + kDropped;
    const float* o = O + c * kStride + q0 + 8 * t.wq + i;
    const long long p = base + 8 * t.wq + i;
    if (p < n)
      out[p * n_keep + c] =
          o[0] + o[ldo] + o[2 * ldo] + o[3 * ldo] + __ldg(w.p[kBias] + raw);
  }
}

// The density variant's blocks are one quad, the full variants' two.
template <bool kDensityOnly, HeadSet kHeads>
__global__ void __launch_bounds__(kDensityOnly ? kDensityThreads : kThreads, 2)
    fused_field_kernel(const float* __restrict__ x, long long n, Weights w,
                       Dims d, const __grid_constant__ Projs ps,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kDensityOnly)
    density_field(x, n, w, d, smem, out);
  else
    full_field<kHeads>(x, n, w, d, ps, smem, out);
}

template <bool kDensityOnly, HeadSet kHeads>
size_t smem_bytes(const Dims& d) {
  const int n_emb = kDensityOnly ? d.in_ch : d.in_ch + d.in_views;
  const int rows = n_emb + kWidth + (kDensityOnly ? 0 : 4 * n_kept<kHeads>(d));
  return static_cast<size_t>(rows) * kStride * sizeof(float);
}

template <bool kDensityOnly>
constexpr int threads() {
  return kDensityOnly ? kDensityThreads : kThreads;
}

template <bool kDensityOnly, HeadSet kHeads>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(fused_field_kernel<kDensityOnly, kHeads>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kDensityOnly, HeadSet kHeads>
int launch(const float* x, long long n, const Weights& w, const Dims& d,
           const Projs& ps, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<kDensityOnly, kHeads>(d);
  cudaError_t err = set_smem<kDensityOnly, kHeads>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kTile - 1) / kTile;
  fused_field_kernel<kDensityOnly, kHeads>
      <<<static_cast<unsigned>(blocks), threads<kDensityOnly>(), smem,
         stream>>>(x, n, w, d, ps, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDensityOnly, HeadSet kHeads>
int occupancy(const Dims& d, int* blocks_per_sm, long long* smem) {
  const size_t bytes = smem_bytes<kDensityOnly, kHeads>(d);
  cudaError_t err = set_smem<kDensityOnly, kHeads>(bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_field_kernel<kDensityOnly, kHeads>,
        threads<kDensityOnly>(), bytes);
  *smem = static_cast<long long>(bytes);
  return static_cast<int>(err);
}

bool dims_ok(int in_ch, int in_views, int n_coarse) {
  return in_ch > 0 && in_views >= 0 && in_ch + in_views <= kLane &&
         n_coarse >= 0 && n_coarse <= kMaxCoarse;
}

bool variant_ok(int variant) {
  return variant >= kVariantAll && variant <= kVariantIncident;
}

}  // namespace

// Launches K1 on `stream`. weights: kNumWeights device pointers in the order
// of WeightIndex. variant (`Variant`): 0 every head, 1 the density only, 2
// the reflected march's heads, 3 the incident march's; `out` holds that
// many columns (9+3K, 1, 4+3K, 4). proj: 4 ints (lo0, hi0, lo1, hi1) per
// projection, A, B, C, then D_k for each of the n_coarse heads: the raw
// columns each may be nonzero in. Returns 0, a cudaError_t, or -1 for
// arguments the kernel does not take.
extern "C" int fused_field_launch(const float* x, long long n,
                                  const float* const* weights, int n_weights,
                                  int width, int in_ch, int in_views,
                                  int n_coarse, int variant, const int* proj,
                                  int n_proj, float* out, void* stream) {
  if (n_weights != kNumWeights || width != kWidth ||
      !dims_ok(in_ch, in_views, n_coarse) || !variant_ok(variant) ||
      n_proj != 3 + n_coarse || n < 0 || (n + kTile - 1) / kTile > INT_MAX)
    return -1;
  const Dims d{in_ch, in_views, n_coarse, 9 + 3 * n_coarse};
  Projs ps{};
  for (int i = 0; i < n_proj; ++i)
    for (int r = 0; r < 2; ++r) {
      const int lo = proj[4 * i + 2 * r], hi = proj[4 * i + 2 * r + 1];
      if (lo < 0 || hi < lo || hi > d.n_out) return -1;
      ps.p[i].lo[r] = lo;
      ps.p[i].hi[r] = hi;
    }
  if (n == 0) return 0;
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = weights[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kVariantDensity: return launch<true, kAll>(x, n, w, d, ps, out, s);
    case kVariantReflected:
      return launch<false, kReflected>(x, n, w, d, ps, out, s);
    case kVariantIncident:
      return launch<false, kIncident>(x, n, w, d, ps, out, s);
    default: return launch<false, kAll>(x, n, w, d, ps, out, s);
  }
}

// The dynamic shared memory a block of one variant (as fused_field_launch
// takes it) takes and how many of its blocks an SM holds at once. Returns 0,
// a cudaError_t, or -1.
extern "C" int fused_field_occupancy(int in_ch, int in_views, int n_coarse,
                                     int variant, int* blocks_per_sm,
                                     long long* smem) {
  if (!dims_ok(in_ch, in_views, n_coarse) || !variant_ok(variant)) return -1;
  const Dims d{in_ch, in_views, n_coarse, 9 + 3 * n_coarse};
  switch (variant) {
    case kVariantDensity: return occupancy<true, kAll>(d, blocks_per_sm, smem);
    case kVariantReflected:
      return occupancy<false, kReflected>(d, blocks_per_sm, smem);
    case kVariantIncident:
      return occupancy<false, kIncident>(d, blocks_per_sm, smem);
    default: return occupancy<false, kAll>(d, blocks_per_sm, smem);
  }
}
