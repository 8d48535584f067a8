// Flash-attention forward for Hopper (sm_90a): causal or not, optional
// sliding window, grouped-query heads.
//
// Replaces the Pallas TPU kernel kernels/flash_attention/flash_attention.py:113
// flash_attention_pallas (body _flash_kernel :36).  Same function: for each
// query row, softmax(q k^T * scale) v over the visible keys (col < S, col <=
// row if causal, col > row - window if windowed), with the online-softmax
// statistics (running max m, sum l, accumulator acc) in fp32 and masked
// scores at -1e30; p is rounded to the input type before the PV product, and
// out = acc / (l > 0 ? l : 1) is stored in the input type.  Query head h
// reads kv head h / (H / Hkv): K and V are never repeated.
//
// What bounds it on the H100: operations.  At the LM slice's prefill
// (B = 1, H = 14, Hkv = 2, S = 32768, D = 64, bf16, causal) the visible
// (q, k) pairs need 4 * H * D * S(S+1)/2 = 1.92e12 operations for 134 MB
// of q, k, v and out: ~1.94 ms on bf16 tensor cores at 989 TFLOP/s against
// 0.04 ms of bytes at 3.35 TB/s.
//
// What the design does about it, in this first version: it keeps every
// byte on chip and skips every masked tile, but computes on the CUDA cores
// in fp32 (FMAs), not on the tensor cores, so it stays well above the
// bound; wgmma/mma with TMA loads is a later step.
//   * One block of 128 threads per (64-row query tile, b * H + h); the loop
//     over 64-row kv tiles inside the block replaces the TPU's sequential
//     innermost grid axis and its VMEM scratch.  Heaviest causal tiles are
//     scheduled first (blockIdx.x counts from the last tile).
//   * Each query tile's first and last kv tile follow from causal and the
//     window, so fully masked tiles are never loaded (the TPU kernel could
//     only skip their compute with pl.when).
//   * Ragged rows and columns (S not a multiple of 64) are masked in the
//     kernel; the tail tile is zero-filled in shared memory, no padded copy.
//   * Q, K, V tiles live in shared memory as fp32 (bf16 is widened on load,
//     exactly); a thread owns a 4 x 8 block of scores and a 4 x D/8 block of
//     the accumulator in registers.  A row's 64 scores are spread over 8
//     neighbouring lanes, so its max and sum are two 3-step shuffles; the
//     probabilities go through shared memory to the PV product.
//   * fp32 Q/K/V tiles at D = 128 take 98 KB (118 KB with P), above the
//     48 KB static limit: dynamic shared memory, set per launch with
//     cudaFuncSetAttribute.
// Built without --use_fast_math: expf and the final division are IEEE, so
// fp32 results stay within 3e-5 of the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 lanes (tx)
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ float round(float x) { return x; }
  __device__ static __forceinline__ void store4(float* dst, float a, float b, float c,
                                                float d) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // little endian: the low half comes first
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                                float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
};

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows x D elements of a row-major (., D) tensor into fp32 shared memory with
// row stride `stride`; rows at or past `valid` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int valid,
                                          float* dst, int stride) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBlockK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float f[kVec];
    if (r < valid) {
      Elem<T>::unpack(__ldg(reinterpret_cast<const uint4*>(src + (size_t)r * D + c)), f);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * stride + c + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int S,
                     int causal, int window, float scale) {
  constexpr int kQKStride = D + 4;       // padded: conflict-free float4 column reads
  constexpr int kPStride = kBlockK + 4;
  constexpr int kCols = D / 32;          // float4 accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * kQKStride;
  float* sV = sK + kBlockK * kQKStride;
  float* sP = sV + kBlockK * D;

  const int n_qtiles = (S + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qtiles - 1 - (int)blockIdx.x) * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kv_head = b * Hkv + (bh % H) / (H / Hkv);
  const T* qp = q + ((size_t)bh * S + q0) * D;
  const T* kp = k + (size_t)kv_head * S * D;
  const T* vp = v + (size_t)kv_head * S * D;
  T* op = o + ((size_t)bh * S + q0) * D;
  const int q_rows = min(kBlockQ, S - q0);

  // kv tiles this query tile can see.
  int kt_lo = 0;
  int kt_hi = (S - 1) / kBlockK;
  if (causal) kt_hi = min(kt_hi, (q0 + q_rows - 1) / kBlockK);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBlockK;

  const int tid = threadIdx.x;
  const int ty = tid / 8;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 8;  // score columns tx + 8j; output columns 4tx + 32jj + e

  load_tile<T, D>(qp, q_rows, sQ, kQKStride);

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's sK, sV and sP are no longer read
    load_tile<T, D>(kp + (size_t)k0 * D, S - k0, sK, kQKStride);
    load_tile<T, D>(vp + (size_t)k0 * D, S - k0, sV, D);
    __syncthreads();

    // s = q k^T for this thread's 4 x 8 block.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * kQKStride + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 8 * j) * kQKStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax, one row at a time; a row lives on 8 neighbouring lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty * 4 + i) * kPStride + tx + 8 * j] = Elem<T>::round(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // sP complete

    // acc += p v for this thread's 4 rows and 4 * kCols columns.
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * kPStride + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = sV + (kk + e) * D + 4 * tx;
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 32 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = lane(pv[i], e);
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      Elem<T>::store4(op + (size_t)r * D + 4 * tx + 32 * jj, acc[i][4 * jj] / safe,
                      acc[i][4 * jj + 1] / safe, acc[i][4 * jj + 2] / safe,
                      acc[i][4 * jj + 3] / safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int kSmem = (kBlockQ * (D + 4) + kBlockK * (D + 4) + kBlockK * D +
                         kBlockQ * (kBlockK + 4)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, S, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_head_dim(int D, const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Hkv, int S, int causal,
                                int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, S, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o (B, H, S, D) = attention(q (B, H, S, D), k, v (B, Hkv, S, D)); all
// contiguous on the device, fp32 (bf16 == 0) or bf16 (bf16 == 1); window <= 0
// means no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                        int H, int Hkv, int S, int D, int causal, int window,
                        float scale, int bf16, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch_for_head_dim<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, S, causal,
                                                window, scale, st)
           : launch_for_head_dim<float>(D, q, k, v, o, B, H, Hkv, S, causal, window,
                                        scale, st);
  return (int)err;
}

}  // extern "C"
