// Matérn-5/2 kernel matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/matern/matern.py:58 matern52_pallas
// (body _matern52_kernel :33): k(a, b) = s (1 + sqrt5 r + 5 r^2 / 3)
// exp(-sqrt5 r) for inputs already divided by the ARD lengthscales.
//
// What bounds it on the H100: at the main path's shapes (n = B <= 8 query
// rows against m = 512 training points, d = 2) the whole matrix is ~16 KB
// written and ~4 KB read, so a call is bound by its launch, not by bytes or
// flops.  At large n and m the kernel is bound by the output write: each
// element costs ~3d + 15 flops for 4 bytes stored.
//
// What the design does about it: one thread per output element, rows of
// threads along m so the store is coalesced; the distance is summed from
// direct differences over d, not from |a|^2 + |b|^2 - 2 a.b.  The TPU kernel
// used the expanded form to put the work on its matrix unit; at d = 2 that
// buys nothing here and costs cancellation near r = 0.  Row i depends only
// on a[i], so a row is the same whatever the number of rows in the call
// (the batch-invariance contract of the level-0 server).
#include <cuda_runtime.h>

namespace {

constexpr float kSqrt5 = 2.2360679775f;
constexpr int kThreads = 128;

__global__ void matern52_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ out, int n, int m, int d,
                                float outputscale) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    float d2 = 0.f;
    for (int k = 0; k < d; ++k) {
      float diff = __ldg(a + (size_t)i * d + k) - __ldg(b + (size_t)j * d + k);
      d2 += diff * diff;
    }
    // Safe sqrt, as in the reference: r = 0 at (numerically) zero distance.
    float r = d2 > 1e-24f ? sqrtf(d2) : 0.f;
    float s = kSqrt5 * r;
    out[(size_t)i * m + j] = outputscale * (1.f + s + s * s / 3.f) * expf(-s);
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

}  // extern "C"
