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
// memory, so every tile streams them from L2 once, ~61 KB (density, 64-point
// tiles) or ~199 KB (full, 32-point tiles) a point.
//
// What the design does about it: the products run as double-precision
// mma.sync (m16n8k4, f64 in and out) on the FP64 tensor cores, twice the rate
// of FP64 FMA on the CUDA cores; m16n8k4 carries twice the work of Ampere's
// m8n8k4 per instruction from the same fragment loads, and needs fewer
// registers than m16n8k8 or m16n8k16 (k3_knockout.py k1f64 times the four
// shapes). A block of 8 warps owns a tile of points
// (64 for the density variant, 32 for the full one) and keeps their
// activations on chip, in shared memory, as f64 [feature][point] with a
// stride of tile + 4 doubles (4 mod 16: the A fragments' 64-bit loads are
// free of bank conflicts). Each warp owns 32 of a 256-wide layer's columns
// for every point of the tile, so each weight is read from L2 once per tile
// (B fragments straight from global memory into registers), and the tile's
// activations are read from shared memory once per warp. The f64 sums stay in
// the mma accumulators; the epilogue rounds them to f32 (summing a second
// product's f32 in the two-product layers), adds the f64 bias, takes the relu
// and stores in place between two block barriers. The narrow heads (at most
// 9 + 3K raw columns, 2-3% of the work) are f64 FMA dot products from shared
// memory, 8 lanes a (point, column) pair reduced by shuffles in a fixed
// order, only over the raw columns the wrapper names for each projection
// (`Projs`), each rounded to f32 and added into an f32 tile of raw sums.
// Nothing uses atomics, so a rerun is bit-identical.
//
// Shared memory per block: density X (round_k(in_ch) = 64 rows) + H (256) at
// 64 points: 320 x 68 x 8 B = 174,080 B; full X (in_ch + round_k(in_views) =
// 91) + H + P (256 each) at 32 points plus the raw tile: 603 x 36 x 8 B +
// 4 (9+3K) x 32 B = 175,968 B at K=3. One block an SM. The embedding is sinf
// in f32 (not __sinf, not sin in double; no fast math). The ragged last
// tile is masked in the kernel (its points read x = 0 and are not written);
// offsets are 64-bit; the kernel allocates nothing.

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
constexpr int kParts = 8;       // lanes that share one head dot product
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

template <bool kDensityOnly>
struct Tile {
  static constexpr int kPoints = kDensityOnly ? 64 : 32;
  static constexpr int kStride = kPoints + 4;  // doubles; 4 mod 16
  static constexpr int kM = kPoints / 8;       // m8 tiles of points
};

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
// activation plane `in` (stride S) with the weights `w` (leading dimension
// ldw), offset to the warp's first column. With `add`, the f32 product is
// added to pre in f32. The warp's MT m8 tiles of points pair up into
// MT / 2 m16 tiles of the mma.
template <int S, int MT, int NT, int N0, int NP>
__device__ __forceinline__ void product(float (&pre)[NT][MT][2], bool add,
                                        const double* in, int k_dim,
                                        const double* __restrict__ w, int ldw,
                                        int lane) {
  constexpr int M16 = MT / 2, J = kMmaK / 4;
  double acc[NP][M16][4];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int m = 0; m < M16; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][m][i] = 0.0;
  const int g = lane >> 2, t = lane & 3;
  const double* a_ptr = in + t * S + g;
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
          a[m][2 * j + h] = a_ptr[(k + 4 * j) * S + 16 * m + 8 * h];
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

// out[8n + 2(l%4) + e][8m + l/4] = act(f64(pre[n][m][e]) + bias[8n + 2(l%4) + e]),
// `out` and `bias` offset to the warp's first column, between two block
// barriers: every warp has read the layer's input before any writes (out
// may be the input), and the stores are seen before the next layer reads.
template <int S, int MT, int NT>
__device__ __forceinline__ void store(double* out, const float (&pre)[NT][MT][2],
                                      const double* __restrict__ bias, bool relu,
                                      int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * n + 2 * t + e;
      const double b = __ldg(bias + c);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        double v = static_cast<double>(pre[n][m][e]) + b;
        if (relu) v = fmax(v, 0.0);
        out[c * S + 8 * m + g] = v;
      }
    }
  __syncthreads();
}

// O[c][p] += f32(sum_r act[r][p] * Pm[r][c]) for every point p of the tile
// and every raw column c of the projection `pr`: rows r < `rows` of the plane
// `act` (stride S) and of Pm (leading dimension n_out). kParts lanes share a
// (column, point) pair, each summing every kParts-th row, and a butterfly over
// them, in a fixed order, leaves the sum in the first; that lane alone writes
// O, so (column, point) pairs never collide within a projection.
template <int S, int T>
__device__ __forceinline__ void project(float* O, const double* act, int rows,
                                        const double* __restrict__ Pm, int n_out,
                                        const Proj& pr) {
  const int n0 = pr.hi[0] - pr.lo[0];
  const int items = (n0 + pr.hi[1] - pr.lo[1]) * T * kParts;
  // items is a multiple of T * kParts = 256 or 512, so whole warps iterate
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int part = item % kParts, pair = item / kParts;
    const int ci = pair / T, p = pair % T;
    const int c = ci < n0 ? pr.lo[0] + ci : pr.lo[1] + ci - n0;
    double s = 0.0;
    for (int r = part; r < rows; r += kParts)
      s = fma(act[r * S + p], __ldg(Pm + static_cast<size_t>(r) * n_out + c), s);
#pragma unroll
    for (int o = 1; o < kParts; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
    if (part == 0) O[c * T + p] += static_cast<float>(s);
  }
}

template <bool kDensityOnly>
__global__ void __launch_bounds__(kThreads, 1)
    fused_field_f64_kernel(const float* __restrict__ x, long long n, Weights w,
                           Dims d, const __grid_constant__ Projs ps,
                           float* __restrict__ out) {
  constexpr int T = Tile<kDensityOnly>::kPoints;
  constexpr int S = Tile<kDensityOnly>::kStride;
  constexpr int MT = Tile<kDensityOnly>::kM;
  extern __shared__ __align__(16) double smem[];
  const int xr = x_rows(d, kDensityOnly);
  double* X = smem;             // embedding, xr features
  double* H = X + xr * S;       // trunk activations, then feature, h2
  double* P = H + kWidth * S;   // pos_feat, then view_feat (full)
  float* O = reinterpret_cast<float*>(P + kWidth * S);  // raw sums (full)

  const int tid = threadIdx.x, lane = tid & 31;
  const int cw = (tid >> 5) * kWarpCols;  // the warp's first column
  const long long base = static_cast<long long>(blockIdx.x) * T;
  const int n_emb = kDensityOnly ? d.in_ch : d.in_ch + d.in_views;

  // The tile's inputs, staged in H (free until layer 0 stores); the rows
  // of X past the embedding are zero; the raw sums start at zero.
  float* xs = reinterpret_cast<float*>(H);
  for (int i = tid; i < T * kInCols; i += kThreads)
    xs[i] = base + i / kInCols < n ? __ldg(x + base * kInCols + i) : 0.f;
  for (int i = n_emb * S + tid; i < xr * S; i += kThreads) X[i] = 0.0;
  if (!kDensityOnly)
    for (int i = tid; i < d.n_out * T; i += kThreads) O[i] = 0.f;
  __syncthreads();
  // Positional encoding in f32: t = x @ E (one nonzero per column), the
  // identity lanes pass t, the others take sinf(t + phase); then f64.
  for (int i = tid; i < n_emb * T; i += kThreads) {
    const int l = i / T, p = i % T;
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
  float pre[4][MT][2];
  product<S, MT, 4, 0, 4>(pre, false, X, k_in, w.d(kW0) + cw, kWidth, lane);
  store<S, MT, 4>(H + cw * S, pre, tb + cw, true, lane);
  const int mid[4] = {kW1, kW2, kW3, kW4};
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    product<S, MT, 4, 0, 4>(pre, false, H, kWidth, w.d(mid[i]) + cw, kWidth, lane);
    store<S, MT, 4>(H + cw * S, pre, tb + (i + 1) * kWidth + cw, true, lane);
  }
  // skip: f32(emb @ w5x) + f32(h @ w5h) in f32, two column halves at a time
  product<S, MT, 4, 0, 2>(pre, false, X, k_in, w.d(kW5x) + cw, kWidth, lane);
  product<S, MT, 4, 0, 2>(pre, true, H, kWidth, w.d(kW5h) + cw, kWidth, lane);
  product<S, MT, 4, 2, 2>(pre, false, X, k_in, w.d(kW5x) + cw, kWidth, lane);
  product<S, MT, 4, 2, 2>(pre, true, H, kWidth, w.d(kW5h) + cw, kWidth, lane);
  store<S, MT, 4>(H + cw * S, pre, tb + 5 * kWidth + cw, true, lane);
  product<S, MT, 4, 0, 4>(pre, false, H, kWidth, w.d(kW6) + cw, kWidth, lane);
  store<S, MT, 4>(H + cw * S, pre, tb + 6 * kWidth + cw, true, lane);
  product<S, MT, 4, 0, 4>(pre, false, H, kWidth, w.d(kW7) + cw, kWidth, lane);
  store<S, MT, 4>(H + cw * S, pre, tb + 7 * kWidth + cw, true, lane);

  if (kDensityOnly) {
    // σ = f32(h @ A[:, 0]) + f32(bias[0]): kThreads / T lanes a point, summed
    // by shuffles in a fixed order.
    constexpr int kSplit = kThreads / T;
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

  project<S, T>(O, H, kWidth, w.d(kA), d.n_out, ps.p[0]);
  product<S, MT, 4, 0, 4>(pre, false, H, kWidth, w.d(kWpf) + cw, kWidth, lane);
  store<S, MT, 4>(P + cw * S, pre, w.d(kBpf) + cw, true, lane);  // pos_feat
  project<S, T>(O, P, kWidth, w.d(kB), d.n_out, ps.p[1]);
  product<S, MT, 4, 0, 4>(pre, false, H, kWidth, w.d(kWfeat) + cw, kWidth, lane);
  store<S, MT, 4>(H + cw * S, pre, w.d(kBfeat) + cw, false, lane);  // feature
  // h2 = relu(f32(feature @ wv_f) + f32(emb @ wv_d) + bv), the direction
  // rows of wv_d at lanes [in_ch, in_ch + in_views); it overwrites feature.
  const double* wvd = w.d(kWvD) + static_cast<size_t>(d.in_ch) * kWidth + cw;
  const double* xd = X + d.in_ch * S;
  const int k_views = round_k(d.in_views);
  product<S, MT, 4, 0, 2>(pre, false, H, kWidth, w.d(kWvF) + cw, kWidth, lane);
  product<S, MT, 4, 0, 2>(pre, true, xd, k_views, wvd, kWidth, lane);
  product<S, MT, 4, 2, 2>(pre, false, H, kWidth, w.d(kWvF) + cw, kWidth, lane);
  product<S, MT, 4, 2, 2>(pre, true, xd, k_views, wvd, kWidth, lane);
  store<S, MT, 4>(H + cw * S, pre, w.d(kBv) + cw, true, lane);
  project<S, T>(O, H, kWidth, w.d(kC), d.n_out, ps.p[2]);

  // view_feat, two heads (256 columns) at a time into P, each head's 128
  // columns projected onto its raw columns with its rows of D.
  const int ldcf = d.n_coarse * kHalf;
  const double* D = w.d(kD);
  int k = 0;
#pragma unroll 1
  for (; k + 2 <= d.n_coarse; k += 2) {
    product<S, MT, 4, 0, 4>(pre, false, H, kWidth, w.d(kWcf) + k * kHalf + cw,
                            ldcf, lane);
    store<S, MT, 4>(P + cw * S, pre, w.d(kBcf) + k * kHalf + cw, true, lane);
    project<S, T>(O, P, kHalf, D + static_cast<size_t>(k) * kHalf * d.n_out,
                  d.n_out, ps.p[3 + k]);
    project<S, T>(O, P + kHalf * S, kHalf,
                  D + static_cast<size_t>(k + 1) * kHalf * d.n_out, d.n_out,
                  ps.p[4 + k]);
  }
  if (k < d.n_coarse) {  // the odd last head: 16 columns a warp
    float pre2[2][MT][2];
    const int c16 = (tid >> 5) * (kHalf / kWarps);
    product<S, MT, 2, 0, 2>(pre2, false, H, kWidth, w.d(kWcf) + k * kHalf + c16,
                            ldcf, lane);
    store<S, MT, 2>(P + c16 * S, pre2, w.d(kBcf) + k * kHalf + c16, true, lane);
    project<S, T>(O, P, kHalf, D + static_cast<size_t>(k) * kHalf * d.n_out,
                  d.n_out, ps.p[3 + k]);
  }

  // raw = the f32 sums + f32(bias), row by row (coalesced)
  __syncthreads();
  const double* bias = w.d(kBias);
  for (int i = tid; i < T * d.n_out; i += kThreads) {
    const int p = i / d.n_out, c = i % d.n_out;
    if (base + p < n)
      out[(base + p) * d.n_out + c] = O[c * T + p] + static_cast<float>(__ldg(bias + c));
  }
}

template <bool kDensityOnly>
size_t smem_bytes(const Dims& d) {
  constexpr int T = Tile<kDensityOnly>::kPoints, S = Tile<kDensityOnly>::kStride;
  const int rows = x_rows(d, kDensityOnly) + kWidth * (kDensityOnly ? 1 : 2);
  return static_cast<size_t>(rows) * S * sizeof(double) +
         (kDensityOnly ? 0 : static_cast<size_t>(d.n_out) * T * sizeof(float));
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
  constexpr int T = Tile<kDensityOnly>::kPoints;
  const long long blocks = (n + T - 1) / T;
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
// nonzero in. Returns 0, a cudaError_t, or -1 for arguments the kernel does
// not take.
extern "C" int fused_field_f64_launch(const float* x, long long n,
                                      const void* const* weights,
                                      int n_weights, int width, int in_ch,
                                      int in_views, int n_coarse,
                                      int density_only, const int* proj,
                                      int n_proj, float* out, void* stream) {
  if (n_weights != kNumWeights || width != kWidth ||
      !dims_ok(in_ch, in_views, n_coarse) || n_proj != 3 + n_coarse || n < 0 ||
      (n + 31) / 32 > INT_MAX)
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
