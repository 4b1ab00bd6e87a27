// K1 at f64 weights: the fused IBL-NeRF field query (no gradient) of the
// strict-parity mode (compute_dtype "float64"), for Hopper (sm_90a).
//
// Replaces ibl_nerf_tpu/kernels/fused_field.py::_field_kernel (the Pallas
// TPU kernel reached by pl.pallas_call in _fused_call) where the packed
// weights are f64 (`dt = float64`). It computes what csrc/fused_field.cu
// computes, rounding where the JAX kernel rounds at f64 weights:
//   emb = where(id, t, sinf(t + phase)), t = x @ E, all in f32, widened to f64
//   every layer: relu(f64(f32(a @ W)) + b), the product summed in f64 and
//     rounded to f32 (`preferred_element_type=f32`), the bias and relu in f64
//   layer 5 and the view layer: their two f32 products summed in f32 first
//   the heads: out = f32(h@A) + f32(pos_feat@B) + f32(h2@C) + f32(vf@D) +
//     f32(bias), in f32; or the density only, f32(h@A[:, 0]) + f32(bias[0]).
// kernels/fused_field._field_plain_f64 is the same math in PyTorch.
//
// What bounds it: the FP64 rate. At 8x256 a point costs ~0.98 MFLOP
// (density) or ~1.59 MFLOP (full) and brings 32 B: at the H100's 67 TFLOP/s
// of dense FP64 on the tensor cores, 1,572,864 density points take at least
// 23.07 ms and 131,072 full points 3.11 ms. Next comes L2: the f64 weights
// (~3.9 MB for the trunk, ~6.3 MB with every head) never fit an SM's shared
// memory, so every 64-point tile streams them from L2 once, ~61 KB (density)
// or ~99 KB (full) a point.
//
// What the design does about it: the products run as double-precision
// mma.sync (m16n8k4, f64 in and out) on the FP64 tensor cores, twice the rate
// of FP64 FMA on the CUDA cores; m16n8k4 carries twice the work of Ampere's
// m8n8k4 per instruction from the same fragment loads, and needs fewer
// registers than m16n8k8 or m16n8k16 (k3_knockout.py k1f64 times the four
// shapes). A block of 8 warps owns a tile of 64 points and keeps their
// activations on chip, in shared memory, as f64 [feature][point] with a
// stride of 68 doubles (4 mod 16: the A fragments' 64-bit loads are free of
// bank conflicts). Each warp owns 32 of a 256-wide layer's columns for all 64
// points, 4 m16 tiles, so 16 mma.sync share every 4 B fragments, and each
// weight is read from L2 once per tile (B fragments straight from global
// memory into registers). The f64 sums stay in the mma accumulators; the
// epilogue rounds them to f32 (summing a second product's f32 in the
// two-product layers), adds the f64 bias, takes the relu and stores in place
// between two block barriers.
//
// The narrow heads (at most 9 + 3K raw columns) never read a plane of their
// own: the epilogue that makes h, pos_feat, h2 or a view_feat tile projects
// the values it holds in registers. Per raw column of the projection (the
// columns the wrapper names, `Projs`, at most kProjCols), a lane sums its
// columns' share for its 8 points in f64, a butterfly over the 4 lanes of its
// row group leaves 2 points' sums in each lane, and the lane writes them to
// its warp's rows of a partial-sum plane. After a block barrier the partials
// are summed over the contributing warps in warp order, in f64, rounded to
// f32 once and written out with the f32 bias: every raw column belongs to one
// projection, so that is the f32 sum of the four terms. A, B and C take all 8
// warps; a view_feat tile of two heads puts head k in warps 0-3 and head
// k + 1 in warps 4-7; an odd last head is a 128-column tile, 16 columns a
// warp. Two partial planes alternate, so one barrier a projection suffices.
// Nothing uses atomics, so a rerun is bit-identical.
//
// Shared memory per block: density X (round_k(in_ch) = 64 rows) + H (256) at
// 68 doubles: 320 x 68 x 8 B = 174,080 B; full X (in_ch + round_k(in_views) =
// 91) + H, and two partial planes of 8 warps x 4 columns x 64 points:
// 347 x 68 x 8 B + 2 x 16,384 B = 221,536 B at every K. One block an SM. The
// embedding is sinf in f32 (not __sinf, not sin in double; no fast math). The
// ragged last tile is masked in the kernel (its points read x = 0 and are not
// written); offsets are 64-bit; the kernel allocates nothing.
//
// On an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py,
// k3_knockout.py k1f64): density 29.8-30.1 ms at 1,572,864 points against
// its 23.07 ms bound (77% of the FP64 peak); full 4.3-4.6 ms at 131,072
// points against 3.11 (68-72%) and 38.1-38.5 ms at 1,179,648 against 28.02.
// What holds both back is issuing the mma.sync beside their fragment loads
// at 8 warps an SM: with the products cut to one FMA a fragment, the loads,
// epilogues and barriers still take 2.7-3.0 ms (full) and 19.6 ms
// (density), hidden only in part. The head partials cost ~0.1 ms, the sums
// over warps less than the noise.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 256;    // trunk width the tiling is written for
constexpr int kHalf = kWidth / 2;
constexpr int kWarpCols = kWidth / kWarps;  // a warp's columns of a 256-wide layer
constexpr int kInCols = 8;
constexpr int kLane = 128;
constexpr int kMaxCoarse = 39;  // n_out = 9 + 3K <= 128, as the JAX kernel's lanes
constexpr int kTile = 64;       // points of a block's tile
constexpr int kStride = kTile + 4;  // doubles between two features; 4 mod 16
constexpr int kM = kTile / 8;       // m8 tiles of points
constexpr int kProjCols = 4;        // raw columns one projection may have
constexpr int kPartial = kWarps * kProjCols * kTile;  // doubles of a partial plane
constexpr unsigned kFull = 0xffffffffu;

// Same names, same order as _WEIGHT_ORDER in kernels/fused_field.py. The
// embedding constants are f32, every other weight f64.
enum WeightIndex {
  kEmbE, kEmbPhase, kEmbId,
  kW0, kW1, kW2, kW3, kW4, kW5x, kW5h, kW6, kW7,
  kTb, kWpf, kBpf, kWfeat, kBfeat, kWvF, kWvD, kBv,
  kWcf, kBcf, kA, kB, kC, kD, kBias,
  kNumWeights
};

struct Weights {
  const void* p[kNumWeights];
  __device__ const double* d(int i) const {
    return static_cast<const double*>(p[i]);
  }
  __device__ const float* f(int i) const {
    return static_cast<const float*>(p[i]);
  }
};

struct Dims {
  int in_ch;     // position embedding channels (63 at multires 10)
  int in_views;  // direction embedding channels (27 at multires 4)
  int n_coarse;  // K coarse-radiance heads
  int n_out;     // 9 + 3K
};

// The raw columns [lo[r], hi[r]) (r < 2) a projection may be nonzero in:
// A, B, C, then D_k for head k (kernels/fused_field.projection_columns).
struct Proj {
  int lo[2], hi[2];
};
struct Projs {
  Proj p[3 + kMaxCoarse];
};

// The ci-th raw column of a projection.
__device__ __forceinline__ int column(const Proj& pr, int ci) {
  const int n0 = pr.hi[0] - pr.lo[0];
  return ci < n0 ? pr.lo[0] + ci : pr.lo[1] + ci - n0;
}

// The depth of one mma.sync: m16n8k{4,8,16} with f64 operands and sums.
constexpr int kMmaK = 4;

__host__ __device__ constexpr int round_k(int v) {
  return (v + kMmaK - 1) / kMmaK * kMmaK;
}

// Rows of the embedding plane X: the k loops read round_k(in_ch) rows from
// row 0 (layers 0 and 5) and round_k(in_views) rows from row in_ch (the view
// layer); the rows past the embedding are zero, as are the packed weight
// rows they meet.
__host__ __device__ inline int x_rows(const Dims& d, bool density_only) {
  const int a = round_k(d.in_ch);
  const int b = d.in_ch + round_k(d.in_views);
  return density_only || a > b ? a : b;
}

// D(16x8) += A(16xK) B(Kx8) in f64 on the tensor cores. With g = l / 4 and
// t = l % 4, lane l holds a[2j + h] = A[g + 8h][t + 4j], b[j] = B[t + 4j][g]
// and d[2h + e] = D[g + 8h][2t + e].
template <int K>
struct Mma;
template <>
struct Mma<4> {
  static __device__ __forceinline__ void run(double (&d)[4], const double (&a)[2],
                                             const double (&b)[1]) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};
template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(double (&d)[4], const double (&a)[4],
                                             const double (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};
template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(double (&d)[4], const double (&a)[8],
                                             const double (&b)[4]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "{%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

// pre[N0 + n][m][e] (+)= f32(sum_k in[k][8m + l/4] * w[k][8(N0 + n) + 2(l%4) + e])
// for n < NP: one product over k_dim rows (a multiple of kMmaK) of the
// activation plane `in` with the weights `w` (leading dimension ldw), offset
// to the warp's first column. With `add`, the f32 product is added to pre in
// f32. The warp's kM m8 tiles of points pair up into kM / 2 m16 tiles of the
// mma.
template <int NT, int N0, int NP>
__device__ __forceinline__ void product(float (&pre)[NT][kM][2], bool add,
                                        const double* in, int k_dim,
                                        const double* __restrict__ w, int ldw,
                                        int lane) {
  constexpr int M16 = kM / 2, J = kMmaK / 4;
  double acc[NP][M16][4];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int m = 0; m < M16; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][m][i] = 0.0;
  const int g = lane >> 2, t = lane & 3;
  const double* a_ptr = in + t * kStride + g;
  const double* b_ptr = w + static_cast<size_t>(t) * ldw + 8 * N0 + g;
#pragma unroll 2
  for (int k = 0; k < k_dim; k += kMmaK) {
    double a[M16][2 * J], b[NP][J];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int j = 0; j < J; ++j)
        b[n][j] = __ldg(b_ptr + static_cast<size_t>(k + 4 * j) * ldw + 8 * n);
#pragma unroll
    for (int m = 0; m < M16; ++m)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[m][2 * j + h] = a_ptr[(k + 4 * j) * kStride + 16 * m + 8 * h];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int m = 0; m < M16; ++m) Mma<kMmaK>::run(acc[n][m], a[m], b[n]);
  }
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int m = 0; m < M16; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = static_cast<float>(acc[n][m][2 * h + e]);
          float& p = pre[N0 + n][2 * m + h][e];
          p = add ? p + v : v;
        }
}

// v[n][m][e] = act(f64(pre[n][m][e]) + bias[8n + 2(l%4) + e]), the relu
// with `relu`, `bias` offset to the warp's first column.
template <int NT>
__device__ __forceinline__ void activate(double (&v)[NT][kM][2],
                                         const float (&pre)[NT][kM][2],
                                         const double* __restrict__ bias, bool relu,
                                         int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const double b = __ldg(bias + 8 * n + 2 * t + e);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        v[n][m][e] = static_cast<double>(pre[n][m][e]) + b;
        if (relu) v[n][m][e] = fmax(v[n][m][e], 0.0);
      }
    }
}

// out[8n + 2(l%4) + e][8m + l/4] = v[n][m][e], `out` offset to the warp's
// first column; the caller places the block barriers.
template <int NT>
__device__ __forceinline__ void put(double* out, const double (&v)[NT][kM][2],
                                    int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        out[(8 * n + 2 * t + e) * kStride + 8 * m + g] = v[n][m][e];
}

// A layer's epilogue into shared memory: `put` of `activate` between two
// block barriers. Every warp has read the layer's input before any writes
// (out may be the input), and the stores are seen before the next layer
// reads.
template <int NT>
__device__ __forceinline__ void store(double* out, const float (&pre)[NT][kM][2],
                                      const double* __restrict__ bias, bool relu,
                                      int lane) {
  __syncthreads();
  double v[NT][kM][2];
  activate<NT>(v, pre, bias, relu, lane);
  put<NT>(out, v, lane);
  __syncthreads();
}

// The number of raw columns of a projection.
__device__ __forceinline__ int n_cols(const Proj& pr) {
  return pr.hi[0] - pr.lo[0] + pr.hi[1] - pr.lo[1];
}

// part[warp][ci][p] = this warp's f64 share of sum_r v[p][r] Pm[r][c] for
// the ci-th raw column c of `pr` and each point p of the tile, Pm (leading
// dimension n_out) offset to the warp's first row. A lane sums its 2 NT
// columns for its 8 points (8m + l/4) by FMA in column order; a butterfly
// over the 4 lanes of its row group (xor 2, then xor 1) halves the points
// twice and leaves the sums of points 8(4 b1 + 2 b0 + i) + l/4 (i < 2,
// b1 b0 = the bits of l % 4) in the lane.
template <int NT>
__device__ __forceinline__ void partial(double* part, const double (&v)[NT][kM][2],
                                        const double* __restrict__ Pm, int n_out,
                                        const Proj& pr, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool b1 = t & 2, b0 = t & 1;
  const int nc = n_cols(pr);
  double* dst = part + warp * kProjCols * kTile + 8 * (4 * b1 + 2 * b0) + g;
#pragma unroll 1
  for (int ci = 0; ci < nc; ++ci) {
    const int c = column(pr, ci);
    double s[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) s[m] = 0.0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const double wc = __ldg(Pm + static_cast<size_t>(8 * n + 2 * t + e) * n_out + c);
#pragma unroll
        for (int m = 0; m < kM; ++m) s[m] = fma(v[n][m][e], wc, s[m]);
      }
    double a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = (b1 ? s[i + 4] : s[i]) + __shfl_xor_sync(kFull, b1 ? s[i] : s[i + 4], 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      b[i] = (b0 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, b0 ? a[i] : a[i + 2], 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) dst[ci * kTile + 8 * i] = b[i];
  }
}

// out[base + p][c] = f32(sum of part[w][ci][p] over the warps w0 .. w0 + nw
// - 1, in f64, in that order) + f32(bias[c]) for the ci-th raw column c of
// `pr` and the tile's points p below n - base: items i0, i0 + step, ...
__device__ __forceinline__ void finish(float* __restrict__ out, const double* part,
                                       const Proj& pr, int w0, int nw,
                                       const double* __restrict__ bias, int n_out,
                                       long long base, long long n, int i0, int step) {
  const int items = n_cols(pr) * kTile;
  for (int i = i0; i < items; i += step) {
    const int ci = i / kTile, p = i % kTile;
    const double* q = part + (w0 * kProjCols + ci) * kTile + p;
    double s = q[0];
    for (int j = 1; j < nw; ++j) s += q[j * kProjCols * kTile];
    const int c = column(pr, ci);
    if (base + p < n)
      out[(base + p) * n_out + c] =
          static_cast<float>(s) + static_cast<float>(__ldg(bias + c));
  }
}

template <bool kDensityOnly>
__global__ void __launch_bounds__(kThreads, 1)
    fused_field_f64_kernel(const float* __restrict__ x, long long n, Weights w,
                           Dims d, const __grid_constant__ Projs ps,
                           float* __restrict__ out) {
  constexpr int S = kStride;
  extern __shared__ __align__(16) double smem[];
  const int xr = x_rows(d, kDensityOnly);
  double* X = smem;             // embedding, xr features
  double* H = X + xr * S;       // trunk activations, then feature, h2
  double* part0 = H + kWidth * S;  // two planes of the heads' partial sums (full)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cw = warp * kWarpCols;  // the warp's first column
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int n_emb = kDensityOnly ? d.in_ch : d.in_ch + d.in_views;

  // The tile's inputs, staged in H (free until layer 0 stores); the rows
  // of X past the embedding are zero.
  float* xs = reinterpret_cast<float*>(H);
  for (int i = tid; i < kTile * kInCols; i += kThreads)
    xs[i] = base + i / kInCols < n ? __ldg(x + base * kInCols + i) : 0.f;
  for (int i = n_emb * S + tid; i < xr * S; i += kThreads) X[i] = 0.0;
  __syncthreads();
  // Positional encoding in f32: t = x @ E (one nonzero per column), the
  // identity lanes pass t, the others take sinf(t + phase); then f64.
  for (int i = tid; i < n_emb * kTile; i += kThreads) {
    const int l = i / kTile, p = i % kTile;
    float u = 0.f;
#pragma unroll
    for (int c = 0; c < kInCols; ++c)
      u = fmaf(xs[p * kInCols + c], __ldg(w.f(kEmbE) + c * kLane + l), u);
    const float v =
        __ldg(w.f(kEmbId) + l) > 0.f ? u : sinf(u + __ldg(w.f(kEmbPhase) + l));
    X[l * S + p] = static_cast<double>(v);
  }
  __syncthreads();

  const int k_in = round_k(d.in_ch);
  const double* tb = w.d(kTb);
  float pre[4][kM][2];
  product<4, 0, 4>(pre, false, X, k_in, w.d(kW0) + cw, kWidth, lane);
  store<4>(H + cw * S, pre, tb + cw, true, lane);
  const int mid[4] = {kW1, kW2, kW3, kW4};
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    product<4, 0, 4>(pre, false, H, kWidth, w.d(mid[i]) + cw, kWidth, lane);
    store<4>(H + cw * S, pre, tb + (i + 1) * kWidth + cw, true, lane);
  }
  // skip: f32(emb @ w5x) + f32(h @ w5h) in f32, two column halves at a time
  product<4, 0, 2>(pre, false, X, k_in, w.d(kW5x) + cw, kWidth, lane);
  product<4, 0, 2>(pre, true, H, kWidth, w.d(kW5h) + cw, kWidth, lane);
  product<4, 2, 2>(pre, false, X, k_in, w.d(kW5x) + cw, kWidth, lane);
  product<4, 2, 2>(pre, true, H, kWidth, w.d(kW5h) + cw, kWidth, lane);
  store<4>(H + cw * S, pre, tb + 5 * kWidth + cw, true, lane);
  product<4, 0, 4>(pre, false, H, kWidth, w.d(kW6) + cw, kWidth, lane);
  store<4>(H + cw * S, pre, tb + 6 * kWidth + cw, true, lane);
  product<4, 0, 4>(pre, false, H, kWidth, w.d(kW7) + cw, kWidth, lane);

  if (kDensityOnly) {
    store<4>(H + cw * S, pre, tb + 7 * kWidth + cw, true, lane);
    // σ = f32(h @ A[:, 0]) + f32(bias[0]): kThreads / kTile lanes a point,
    // summed by shuffles in a fixed order.
    constexpr int kSplit = kThreads / kTile;
    const int p = tid / kSplit, part = tid % kSplit;
    const double* A = w.d(kA);
    double s = 0.0;
    for (int r = part; r < kWidth; r += kSplit)
      s = fma(H[r * S + p], __ldg(A + static_cast<size_t>(r) * d.n_out), s);
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
    if (part == 0 && base + p < n)
      out[base + p] = static_cast<float>(s) + static_cast<float>(__ldg(w.d(kBias)));
    return;
  }

  // Every head projection from the epilogue's registers into a partial
  // plane (part0, part1 alternating), a block barrier, then `finish`. A
  // plane is written again only after the barrier that follows its last
  // read.
  const int n_out = d.n_out;
  const double* bias = w.d(kBias);
  double* part1 = part0 + kPartial;
  double v[4][kM][2];
  // h: stored, and projected onto A
  activate<4>(v, pre, tb + 7 * kWidth + cw, true, lane);
  __syncthreads();
  put<4>(H + cw * S, v, lane);
  partial<4>(part0, v, w.d(kA) + static_cast<size_t>(cw) * n_out, n_out, ps.p[0], warp,
             lane);
  __syncthreads();
  finish(out, part0, ps.p[0], 0, kWarps, bias, n_out, base, n, tid, kThreads);
  // pos_feat: projected onto B, never stored; B's sums wait for the
  // barriers of feature's store
  product<4, 0, 4>(pre, false, H, kWidth, w.d(kWpf) + cw, kWidth, lane);
  activate<4>(v, pre, w.d(kBpf) + cw, true, lane);
  partial<4>(part1, v, w.d(kB) + static_cast<size_t>(cw) * n_out, n_out, ps.p[1], warp,
             lane);
  product<4, 0, 4>(pre, false, H, kWidth, w.d(kWfeat) + cw, kWidth, lane);
  store<4>(H + cw * S, pre, w.d(kBfeat) + cw, false, lane);  // feature
  finish(out, part1, ps.p[1], 0, kWarps, bias, n_out, base, n, tid, kThreads);
  // h2 = relu(f32(feature @ wv_f) + f32(emb @ wv_d) + bv), the direction
  // rows of wv_d at lanes [in_ch, in_ch + in_views); it overwrites feature
  // and is projected onto C.
  const double* wvd = w.d(kWvD) + static_cast<size_t>(d.in_ch) * kWidth + cw;
  const double* xd = X + d.in_ch * S;
  const int k_views = round_k(d.in_views);
  product<4, 0, 2>(pre, false, H, kWidth, w.d(kWvF) + cw, kWidth, lane);
  product<4, 0, 2>(pre, true, xd, k_views, wvd, kWidth, lane);
  product<4, 2, 2>(pre, false, H, kWidth, w.d(kWvF) + cw, kWidth, lane);
  product<4, 2, 2>(pre, true, xd, k_views, wvd, kWidth, lane);
  activate<4>(v, pre, w.d(kBv) + cw, true, lane);
  __syncthreads();
  put<4>(H + cw * S, v, lane);
  partial<4>(part0, v, w.d(kC) + static_cast<size_t>(cw) * n_out, n_out, ps.p[2], warp,
             lane);
  __syncthreads();
  finish(out, part0, ps.p[2], 0, kWarps, bias, n_out, base, n, tid, kThreads);

  // view_feat, two heads (256 columns) at a time, never stored: head k in
  // warps 0-3 and head k + 1 in warps 4-7, each onto its rows of D (those
  // of column cw of the tile: k * kHalf + cw for both halves).
  const int ldcf = d.n_coarse * kHalf;
  const double* D = w.d(kD);
  const int half = warp / (kWarps / 2);
  double* buf = part1;
  int k = 0;
#pragma unroll 1
  for (; k + 2 <= d.n_coarse; k += 2) {
    product<4, 0, 4>(pre, false, H, kWidth, w.d(kWcf) + k * kHalf + cw, ldcf, lane);
    activate<4>(v, pre, w.d(kBcf) + k * kHalf + cw, true, lane);
    partial<4>(buf, v, D + static_cast<size_t>(k * kHalf + cw) * n_out, n_out,
               ps.p[3 + k + half], warp, lane);
    __syncthreads();
    finish(out, buf, ps.p[3 + k + half], half * kWarps / 2, kWarps / 2, bias, n_out, base,
           n, tid % (kThreads / 2), kThreads / 2);
    buf = buf == part0 ? part1 : part0;
  }
  if (k < d.n_coarse) {  // the odd last head: 16 columns a warp, all 8 warps
    float pre2[2][kM][2];
    double v2[2][kM][2];
    const int c16 = warp * (kHalf / kWarps);
    product<2, 0, 2>(pre2, false, H, kWidth, w.d(kWcf) + k * kHalf + c16, ldcf, lane);
    activate<2>(v2, pre2, w.d(kBcf) + k * kHalf + c16, true, lane);
    partial<2>(buf, v2, D + static_cast<size_t>(k * kHalf + c16) * n_out, n_out,
               ps.p[3 + k], warp, lane);
    __syncthreads();
    finish(out, buf, ps.p[3 + k], 0, kWarps, bias, n_out, base, n, tid, kThreads);
  }
}

template <bool kDensityOnly>
size_t smem_bytes(const Dims& d) {
  const size_t planes = static_cast<size_t>(x_rows(d, kDensityOnly) + kWidth) * kStride;
  return (planes + (kDensityOnly ? 0 : 2 * kPartial)) * sizeof(double);
}

template <bool kDensityOnly>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(fused_field_f64_kernel<kDensityOnly>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kDensityOnly>
int launch(const float* x, long long n, const Weights& w, const Dims& d,
           const Projs& ps, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<kDensityOnly>(d);
  cudaError_t err = set_smem<kDensityOnly>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kTile - 1) / kTile;
  fused_field_f64_kernel<kDensityOnly>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(x, n, w, d,
                                                                   ps, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDensityOnly>
int occupancy(const Dims& d, int* blocks_per_sm, long long* smem) {
  const size_t bytes = smem_bytes<kDensityOnly>(d);
  cudaError_t err = set_smem<kDensityOnly>(bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_field_f64_kernel<kDensityOnly>, kThreads, bytes);
  *smem = static_cast<long long>(bytes);
  return static_cast<int>(err);
}

// The k loops read packed rows up to round_k(in_ch) (w0, w5x) and
// in_ch + round_k(in_views) (wv_d), all within the 128 embedding lanes.
bool dims_ok(int in_ch, int in_views, int n_coarse) {
  return in_ch > 0 && in_views > 0 && in_ch + in_views <= kLane &&
         in_ch + round_k(in_views) <= kLane && n_coarse >= 0 &&
         n_coarse <= kMaxCoarse;
}

}  // namespace

// Launches K1 at f64 weights on `stream`. weights: kNumWeights device
// pointers in the order of WeightIndex (the embedding constants f32, the
// rest f64). proj: 4 ints (lo0, hi0, lo1, hi1) per projection, A, B, C,
// then D_k for each of the n_coarse heads: the raw columns each may be
// nonzero in, at most kProjCols a projection, each raw column in one.
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int fused_field_f64_launch(const float* x, long long n,
                                      const void* const* weights,
                                      int n_weights, int width, int in_ch,
                                      int in_views, int n_coarse,
                                      int density_only, const int* proj,
                                      int n_proj, float* out, void* stream) {
  if (n_weights != kNumWeights || width != kWidth ||
      !dims_ok(in_ch, in_views, n_coarse) || n_proj != 3 + n_coarse || n < 0 ||
      (n + kTile - 1) / kTile > INT_MAX)
    return -1;
  const Dims d{in_ch, in_views, n_coarse, 9 + 3 * n_coarse};
  Projs ps{};
  for (int i = 0; i < n_proj; ++i) {
    int cols = 0;
    for (int r = 0; r < 2; ++r) {
      const int lo = proj[4 * i + 2 * r], hi = proj[4 * i + 2 * r + 1];
      if (lo < 0 || hi < lo || hi > d.n_out) return -1;
      ps.p[i].lo[r] = lo;
      ps.p[i].hi[r] = hi;
      cols += hi - lo;
    }
    if (cols > kProjCols) return -1;
  }
  if (n == 0) return 0;
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = weights[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return density_only ? launch<true>(x, n, w, d, ps, out, s)
                      : launch<false>(x, n, w, d, ps, out, s);
}

// The dynamic shared memory a block of one variant takes and how many of its
// blocks an SM holds at once. Returns 0, a cudaError_t, or -1.
extern "C" int fused_field_f64_occupancy(int in_ch, int in_views, int n_coarse,
                                         int density_only, int* blocks_per_sm,
                                         long long* smem) {
  if (!dims_ok(in_ch, in_views, n_coarse)) return -1;
  const Dims d{in_ch, in_views, n_coarse, 9 + 3 * n_coarse};
  return density_only ? occupancy<true>(d, blocks_per_sm, smem)
                      : occupancy<false>(d, blocks_per_sm, smem);
}
