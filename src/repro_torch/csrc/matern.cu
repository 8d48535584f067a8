// Matérn-5/2 kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/matern/matern.py:58 matern52_pallas
// (body _matern52_kernel :33): k(a, b) = s (1 + sqrt5 r + 5 r^2 / 3)
// exp(-sqrt5 r) for inputs already divided by the ARD lengthscales.  Two
// entry points share one element function:
//   * matern52       the kernel matrix (n, m), for the GP's posterior
//                    variance;
//   * matern52_mean  the GP's posterior mean (B, p) at raw query points: the
//                    Matérn row of each query, its products with alpha, the
//                    sum over the training points and the affine step back
//                    to output units, in one launch.  On the TPU, XLA fused
//                    this contraction (repro core/gp.py:102) around the
//                    Pallas kernel; eager PyTorch on the card does not, and
//                    issued it as ~15 small launches a level-0 call.
//
// What bounds them on the H100: at the main path's shapes (B <= 8 query rows
// against n = 512 training points, d = 2, p = 4 outputs) a call reads ~12 KB
// and writes 16 KB (the matrix) or 128 bytes (the mean), so it is bound by
// its launch, not by bytes or flops.  At large n and m the matrix kernel is
// bound by the output write: each element costs ~3d + 15 flops for 4 bytes.
//
// What the designs do about it.  The matrix kernel: one thread per output
// element, rows of threads along m so the store is coalesced.  The mean
// kernel: one block per query row and tile of outputs, the row's products
// k(a_i, X_j) alpha[j, q] in shared memory (zero-padded to W = the next
// power of two >= n), summed by pairwise halving s[j] += s[j + W/2], ...,
// s[0] += s[1]: the order of the plain version's fixed_order_sum, so the
// mean keeps the bits of the matrix kernel followed by PyTorch's multiply,
// halving adds and affine step.
// A call is a chain of latencies (loads, then the element, then log2 W
// levels of the tree), so the block is as wide as the main path's n (512
// threads, one training point each), the training rows are loaded before
// the first barrier, the tree's levels down to 32 terms spread their (q, j)
// pairs over all threads behind barriers, and its last five levels run in
// one warp an output by shuffles (lane j adds lane j + half: the same
// pairs, no barrier).
// Every (n, p) fits the block's 48 KiB of shared memory by two means, which
// the wrapper plans (ops.mean_plan) and which change no bit.  Tiles of
// outputs: a block holds the trees of qt of the p outputs, the grid has a
// block for each (row, tile); each output's tree is independent.  Top levels
// in registers: where W x qt floats still do not fit (large n; then qt <= 4),
// each thread first sums the 2^levels terms of its slot j < W / 2^levels,
// j + m W / 2^levels, as the tree's first `levels` levels pair them (level
// 1 m with m + 2^(levels-1), ...): a pairwise sum over m in bit-reversed
// order, kept on a stack of partial sums.  At the main path's shape (n =
// 512, p = 4) there is one tile and no register level: the kernel's
// instance without register levels, whose work is the single-tile design's.
// Both take the distance from direct differences over d, not from
// |a|^2 + |b|^2 - 2 a.b: the TPU kernel used the expanded form to put the
// work on its matrix unit; at d = 2 that buys nothing here and costs
// cancellation near r = 0.  Row i depends only on a[i] (x[i] for the mean),
// whatever the number of rows in the call: the batch-invariance contract of
// the level-0 server.
//
// Built with --fmad=false (kernels/build.py): no product is contracted into
// an add, so every operation rounds as its PyTorch counterpart does.
#include <cuda_runtime.h>

namespace {

constexpr float kSqrt5 = 2.2360679775f;
constexpr int kThreads = 128;
constexpr int kMeanThreads = 512;
// The register levels: at most this many outputs a block (the plan's qt
// whenever levels > 0; ops.MEAN_REG_TILE), and the partial sums of up to 30
// levels a thread (2^levels terms a slot, counted in an int).
constexpr int kRegTile = 4;
constexpr int kMaxLevels = 30;

// k(a, b) for one pair of pre-scaled points of dimension d; a(k) gives the
// first point's coordinates.
template <class A>
__device__ __forceinline__ float matern52_element(A a, const float* b, int d,
                                                  float outputscale) {
  float d2 = 0.f;
  for (int k = 0; k < d; ++k) {
    const float diff = a(k) - b[k];
    d2 += diff * diff;
  }
  // Safe sqrt, as in the reference: r = 0 at (numerically) zero distance.
  const float r = d2 > 1e-24f ? sqrtf(d2) : 0.f;
  const float s = kSqrt5 * r;
  return outputscale * (1.f + s + s * s / 3.f) * expf(-s);
}

__global__ void matern52_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ out, int n, int m, int d,
                                float outputscale) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const float* ai = a + (size_t)i * d;
    out[(size_t)i * m + j] =
        matern52_element([=](int k) { return ai[k]; }, b + (size_t)j * d, d, outputscale);
  }
}

// One block per query row i = blockIdx.x and tile of outputs q0 .. q0 + nq
// - 1, tile blockIdx.z * gridDim.y + blockIdx.y (a grid's y extent stops at
// 65535).  Dynamic shared memory: the tree s[q][0..width) of each output q
// of the tile, width = W / 2^levels.  kRegLevels: whether the first
// `levels` (> 0) levels run in registers; the instance without them keeps
// the whole tree in shared memory, as at the main path's shape.
template <bool kRegLevels>
__global__ void __launch_bounds__(kMeanThreads) matern52_mean_kernel(
    const float* __restrict__ x, const float* __restrict__ ls,
    const float* __restrict__ xs, const float* __restrict__ alpha,
    const float* __restrict__ y_scale, const float* __restrict__ y_mean,
    float* __restrict__ out, int n, int d, int p, int width, int qt, int levels,
    float outputscale) {
  extern __shared__ float s[];
  const int i = blockIdx.x, q0 = (blockIdx.z * gridDim.y + blockIdx.y) * qt;
  if (q0 >= p) return;
  const int nq = min(qt, p - q0), tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* xi = x + (size_t)i * d;
  const float* a = alpha + q0;  // a[j * p + q] = alpha[j, q0 + q]
  // The affine step's constants of output q0 + warp, loaded now so that
  // their latency hides behind the rest.
  const bool first = lane == 0 && warp < nq;
  const float ys0 = first ? y_scale[q0 + warp] : 0.f, ym0 = first ? y_mean[q0 + warp] : 0.f;
  const auto element = [=](int j) {
    return matern52_element([=](int k) { return xi[k] / ls[k]; }, xs + (size_t)j * d, d,
                            outputscale);
  };
  if constexpr (!kRegLevels) {
    // Each thread its training points j: k(x[i] / ls, xs[j]) alpha[j, q].
    for (int j = tid; j < width; j += blockDim.x) {
      if (j < n) {
        const float kj = element(j);
        for (int q = 0; q < nq; ++q) s[q * width + j] = kj * a[(size_t)j * p + q];
      } else {
        for (int q = 0; q < nq; ++q) s[q * width + j] = 0.f;
      }
    }
  } else {
    // The register levels: slot j's terms j + m width in the order r = 0,
    // 1, ... of m = bit-reverse(r), each pushed on the stack, and after the
    // r-th the two top partial sums merged once for each trailing one bit
    // of r: the pairwise tree of the first `levels` levels.
    const int count = 1 << levels;
    for (int j = tid; j < width; j += blockDim.x) {
      float st[kRegTile][kMaxLevels + 1];
      int top = 0;
      for (int r = 0; r < count; ++r) {
        const int jj = j + (int)(__brev(r) >> (32 - levels)) * width;
        const float kj = jj < n ? element(jj) : 0.f;
#pragma unroll
        for (int q = 0; q < kRegTile; ++q)
          st[q][top] = jj < n && q < nq ? kj * a[(size_t)jj * p + q] : 0.f;
        ++top;
        for (int c = r + 1; (c & 1) == 0; c >>= 1) {
          --top;
#pragma unroll
          for (int q = 0; q < kRegTile; ++q) st[q][top - 1] += st[q][top];
        }
      }
      for (int q = 0; q < nq; ++q) s[q * width + j] = st[q][0];
    }
  }
  __syncthreads();
  // The halving levels down to 32 terms, each over its nq x half pairs (q, j).
  for (int lg = 31 - __clz(width) - 1; lg >= 5; --lg) {
    const int half = 1 << lg;
    for (int k = tid; k < (nq << lg); k += blockDim.x) {
      const int q = k >> lg, j = k & (half - 1);
      s[q * width + j] += s[q * width + j + half];
    }
    __syncthreads();
  }
  // The last levels in one warp an output, then two rounded operations, as
  // PyTorch's `* y_scale + y_mean`.
  const int rest = min(width, 32);
  for (int q = warp; q < nq; q += blockDim.x >> 5) {
    float v = lane < rest ? s[q * width + lane] : 0.f;
    for (int half = rest >> 1; half > 0; half >>= 1) v += __shfl_down_sync(~0u, v, half);
    if (lane == 0) {
      const float ys = q == warp ? ys0 : y_scale[q0 + q];
      const float ym = q == warp ? ym0 : y_mean[q0 + q];
      out[(size_t)i * p + q0 + q] = __fadd_rn(__fmul_rn(v, ys), ym);
    }
  }
}

}  // namespace

extern "C" {

// out (n, m) = k(a (n, d), b (m, d)); all row-major fp32 on the device.
int matern52(const float* a, const float* b, float* out, int n, int m, int d,
             float outputscale, void* stream) {
  if (n == 0 || m == 0) return 0;
  dim3 grid((m + kThreads - 1) / kThreads, n < 65535 ? n : 65535);
  matern52_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, out, n, m,
                                                                d, outputscale);
  return (int)cudaGetLastError();
}

// out (B, p) = posterior mean at the raw points x (B, d): lengthscales ls
// (d,), scaled training inputs xs (n, d), alpha (n, p), y_scale and y_mean
// (p,); width = the next power of two >= max(n, 1).  The caller's plan:
// tiles of qt outputs, the first `levels` levels of each tree in registers,
// so that (width >> levels) * qt floats fit 48 KiB of shared memory.
int matern52_mean(const float* x, const float* ls, const float* xs, const float* alpha,
                  const float* y_scale, const float* y_mean, float* out, int B, int n,
                  int d, int p, int width, int qt, int levels, float outputscale,
                  void* stream) {
  if (B == 0 || p == 0) return 0;
  if (qt < 1 || levels < 0 || levels > kMaxLevels || (levels > 0 && qt > kRegTile))
    return (int)cudaErrorInvalidValue;
  const int tiles = (p + qt - 1) / qt, slots = width >> levels;
  const size_t smem = sizeof(float) * (size_t)slots * qt;
  const dim3 grid(B, min(tiles, 65535), (tiles + 65534) / 65535);
  if (levels == 0)
    matern52_mean_kernel<false><<<grid, kMeanThreads, smem, (cudaStream_t)stream>>>(
        x, ls, xs, alpha, y_scale, y_mean, out, n, d, p, slots, qt, levels, outputscale);
  else
    matern52_mean_kernel<true><<<grid, kMeanThreads, smem, (cudaStream_t)stream>>>(
        x, ls, xs, alpha, y_scale, y_mean, out, n, d, p, slots, qt, levels, outputscale);
  return (int)cudaGetLastError();
}

}  // extern "C"
