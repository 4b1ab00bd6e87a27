// K1: the fused IBL-NeRF field query (no gradient), for Hopper (sm_90a).
//
// Replaces ibl_nerf_tpu/kernels/fused_field.py::_field_kernel (the Pallas
// TPU kernel reached by pl.pallas_call in _fused_call). Per point it computes
//   emb = where(id, t, sin(t + phase)),  t = x @ E          (x = [pts|dirs|0])
//   h   = the 8-layer ReLU trunk, layer 5 as emb@w5x + h@w5h
// and then either the density only, out = h@A[:, 0] + bias[0], or every head:
//   pos_feat  = relu(h@wpf + bpf)          feature = h@wfeat + bfeat
//   h2        = relu(feature@wv_f + emb@wv_d + bv)
//   view_feat = relu(h2@wcf + bcf)
//   out = h@A + pos_feat@B + h2@C + view_feat@D + bias  (cols [σ, albedo3, ρ,
//   irr, rad3, coarse3K]).
//
// What bounds it: the f32 FMA rate. A point brings 32 B and takes at most
// 4(9+3K) B away, but costs ~0.98 MFLOP (density) or ~1.59 MFLOP (full) at
// 8x256: ~10^4 operations per byte, far above the card's 67 TFLOP/s f32 over
// 3.35 TB/s (~20 per byte). The weights (~2.6 MB f32) do not fit an SM's
// 227 KB of shared memory, so every block streams them from L2.
//
// What the design does about it: a block owns a tile of 64 points and keeps
// all of their activations on chip, in shared memory, transposed
// ([feature][point], stride 68 floats) so the 8 points of a thread are two
// 16-byte loads that the whole warp shares (a broadcast). 256 threads = 8 warps;
// warp w owns points 8w..8w+7 and lane l owns output columns l + 32j, so one
// weight row is one coalesced 128-byte load per j for the warp, served by L1/L2.
// Each thread keeps an 8x8 (or 8x4) accumulator tile in registers: 64 FMAs per
// 10 loads. Only the embedding lanes that carry data are read (the packed
// rows of w0/w5x beyond in_ch and of wv_d outside the direction lanes are
// zero). The density variant needs 87 KB of shared memory, so two blocks
// share an SM; the full variant needs 165 KB, one block. Arithmetic is f32 FMA
// with f32 accumulation, sinf (not __sinf; no fast math) on the full range.
// The ragged last tile is masked in the kernel; offsets are 64-bit.
// Faster designs (wgmma on split-TF32 or bf16 operands, TMA-fed weight
// tiles) are later work.

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

// acc[i][j] += sum_k in[k][row0 + i] * w[k * ldw + lane + 32 j]
template <int NCOL>
__device__ __forceinline__ void mac(float (&acc)[8][NCOL],
                                    const float* __restrict__ in, int k_dim,
                                    const float* __restrict__ w, int ldw,
                                    int row0, int lane) {
#pragma unroll 4
  for (int k = 0; k < k_dim; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(in + k * kStride + row0);
    const float4 a1 =
        *reinterpret_cast<const float4*>(in + k * kStride + row0 + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float* wk = w + static_cast<size_t>(k) * ldw + lane;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const float b = __ldg(wk + 32 * j);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
    }
  }
}

// out[:, 0:32*NCOL] = act(in1 @ w1 + in2 @ w2 + bias), every matrix with
// leading dimension ldw. `out` may be one of the inputs: all reads finish
// before the first write.
template <int NCOL>
__device__ __forceinline__ void layer(float* out, const float* in1, int k1,
                                      const float* __restrict__ w1,
                                      const float* in2, int k2,
                                      const float* __restrict__ w2, int ldw,
                                      const float* __restrict__ bias, bool relu,
                                      int row0, int lane) {
  float acc[8][NCOL];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[i][j] = 0.f;
  mac<NCOL>(acc, in1, k1, w1, ldw, row0, lane);
  if (in2 != nullptr) mac<NCOL>(acc, in2, k2, w2, ldw, row0, lane);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    const int col = lane + 32 * j;
    const float b = __ldg(bias + col);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = acc[i][j] + b;
      if (relu) v[i] = fmaxf(v[i], 0.f);
    }
    float* dst = out + col * kStride + row0;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
}

// o[c][r] += sum_k in[k][r] * w[k * n_out + c] for every c < n_out: the
// narrow output projections. A thread owns the same (c, r) on every call.
__device__ __forceinline__ void project(float* o, const float* in, int k_dim,
                                        const float* __restrict__ w,
                                        int n_out) {
  for (int idx = threadIdx.x; idx < n_out * kTile; idx += kThreads) {
    const int c = idx / kTile, r = idx % kTile;
    float s = 0.f;
    for (int k = 0; k < k_dim; ++k)
      s = fmaf(in[k * kStride + r], __ldg(w + k * n_out + c), s);
    o[c * kStride + r] += s;
  }
}

template <bool kDensityOnly>
__global__ void __launch_bounds__(kThreads, 2)
    fused_field_kernel(const float* __restrict__ x, long long n, Weights w,
                       Dims d, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int n_emb = kDensityOnly ? d.in_ch : d.in_ch + d.in_views;
  float* X = smem;                  // embedding, n_emb features
  float* H = X + n_emb * kStride;   // trunk activations, then h2
  float* T = H + kWidth * kStride;  // head features (full variant)
  float* O = T + kWidth * kStride;  // raw output accumulator (full variant)

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 8;

  // Positional encoding: t = x @ E (one nonzero per column), then the
  // identity lanes pass t and the others take sin(t + phase).
  const float* E = w.p[kEmbE];
  for (int idx = threadIdx.x; idx < n_emb * kTile; idx += kThreads) {
    const int l = idx / kTile, r = idx % kTile;
    const long long p = base + r;
    float t = 0.f;
    if (p < n) {
      const float* xp = x + p * kInCols;
#pragma unroll
      for (int c = 0; c < kInCols; ++c)
        t = fmaf(__ldg(xp + c), __ldg(E + c * kLane + l), t);
    }
    X[l * kStride + r] =
        __ldg(w.p[kEmbId] + l) > 0.f ? t : sinf(t + __ldg(w.p[kEmbPhase] + l));
  }
  if (!kDensityOnly)
    for (int idx = threadIdx.x; idx < d.n_out * kStride; idx += kThreads)
      O[idx] = 0.f;
  __syncthreads();

  const float* tb = w.p[kTb];
  layer<8>(H, X, d.in_ch, w.p[kW0], nullptr, 0, nullptr, kWidth, tb, true,
           row0, lane);
  const int mid[4] = {kW1, kW2, kW3, kW4};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    layer<8>(H, H, kWidth, w.p[mid[i]], nullptr, 0, nullptr, kWidth,
             tb + (i + 1) * kWidth, true, row0, lane);
  layer<8>(H, X, d.in_ch, w.p[kW5x], H, kWidth, w.p[kW5h], kWidth,
           tb + 5 * kWidth, true, row0, lane);
  layer<8>(H, H, kWidth, w.p[kW6], nullptr, 0, nullptr, kWidth,
           tb + 6 * kWidth, true, row0, lane);
  layer<8>(H, H, kWidth, w.p[kW7], nullptr, 0, nullptr, kWidth,
           tb + 7 * kWidth, true, row0, lane);

  if (kDensityOnly) {
    const float* A = w.p[kA];
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const long long p = base + r;
      if (p >= n) continue;
      float s = 0.f;
      for (int k = 0; k < kWidth; ++k)
        s = fmaf(H[k * kStride + r], __ldg(A + k * d.n_out), s);
      out[p] = s + __ldg(w.p[kBias]);
    }
    return;
  }

  project(O, H, kWidth, w.p[kA], d.n_out);
  layer<8>(T, H, kWidth, w.p[kWpf], nullptr, 0, nullptr, kWidth, w.p[kBpf],
           true, row0, lane);  // pos_feat
  project(O, T, kWidth, w.p[kB], d.n_out);
  layer<8>(T, H, kWidth, w.p[kWfeat], nullptr, 0, nullptr, kWidth,
           w.p[kBfeat], false, row0, lane);  // feature
  // h2 overwrites h; the direction rows of wv_d sit at lanes [in_ch, ...).
  layer<8>(H, T, kWidth, w.p[kWvF], X + d.in_ch * kStride, d.in_views,
           w.p[kWvD] + static_cast<size_t>(d.in_ch) * kWidth, kWidth,
           w.p[kBv], true, row0, lane);
  project(O, H, kWidth, w.p[kC], d.n_out);
  const int ldcf = d.n_coarse * kHalf;
  for (int k = 0; k < d.n_coarse; ++k) {
    layer<4>(T, H, kWidth, w.p[kWcf] + k * kHalf, nullptr, 0, nullptr, ldcf,
             w.p[kBcf] + k * kHalf, true, row0, lane);  // view_feat, head k
    project(O, T, kHalf,
            w.p[kD] + static_cast<size_t>(k) * kHalf * d.n_out, d.n_out);
    __syncthreads();
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kTile * d.n_out; idx += kThreads) {
    const int r = idx / d.n_out, c = idx % d.n_out;
    const long long p = base + r;
    if (p < n) out[p * d.n_out + c] = O[c * kStride + r] + __ldg(w.p[kBias] + c);
  }
}

template <bool kDensityOnly>
int launch(const float* x, long long n, const Weights& w, const Dims& d,
           float* out, cudaStream_t stream) {
  const int n_emb = kDensityOnly ? d.in_ch : d.in_ch + d.in_views;
  const int rows = n_emb + kWidth + (kDensityOnly ? 0 : kWidth + d.n_out);
  const size_t smem = static_cast<size_t>(rows) * kStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_field_kernel<kDensityOnly>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kTile - 1) / kTile;
  fused_field_kernel<kDensityOnly>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(x, n, w, d,
                                                                   out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream`. weights: kNumWeights device pointers in the order
// of WeightIndex. Returns 0, a cudaError_t, or -1 for arguments the kernel
// does not take.
extern "C" int fused_field_launch(const float* x, long long n,
                                  const float* const* weights, int n_weights,
                                  int width, int in_ch, int in_views,
                                  int n_coarse, int density_only, float* out,
                                  void* stream) {
  if (n_weights != kNumWeights || width != kWidth || in_ch <= 0 ||
      in_views < 0 || in_ch + in_views > kLane || n_coarse < 0 || n < 0 ||
      (n + kTile - 1) / kTile > INT_MAX)
    return -1;
  if (n == 0) return 0;
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = weights[i];
  const Dims d{in_ch, in_views, n_coarse, 9 + 3 * n_coarse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return density_only ? launch<true>(x, n, w, d, out, s)
                      : launch<false>(x, n, w, d, out, s);
}
