// Flash-attention forward for Hopper (sm_90a): causal or not, optional
// sliding window, grouped-query heads.  Two routes, chosen by dtype alone
// (kernels/flash_attention/ops.py, route()):
//   * bf16 -> flash_fwd_wgmma_kernel, on the tensor cores (wgmma + TMA);
//   * fp32 -> flash_fwd_fp32_kernel, on the CUDA cores.  Tensor cores would
//     take fp32 only as TF32, whose 10-bit mantissa cannot hold the
//     reference's 3e-5, so fp32 keeps a kernel of FMAs.
//
// Replaces the Pallas TPU kernel kernels/flash_attention/flash_attention.py:113
// flash_attention_pallas (body _flash_kernel :36).  Same function: for each
// query row, softmax(q k^T * scale) v over the visible keys (col < S, col <=
// row if causal, col > row - window if windowed), with the online-softmax
// statistics (running max m, sum l, accumulator acc) in fp32 and masked
// scores at -1e30; p is rounded to the input type before the PV product, and
// out = acc / (l > 0 ? l : 1) is stored in the input type.  Query head h
// reads kv head h / (H / Hkv): K and V are never repeated.  The loop over kv
// tiles inside a block replaces the TPU's sequential innermost grid axis and
// its VMEM scratch; each query tile's first and last kv tile follow from
// causal and the window, so fully masked tiles are never loaded (the TPU
// kernel could only skip their compute with pl.when), and the heaviest
// causal tiles are scheduled first (blockIdx.x counts from the last tile).
//
// What bounds it on the H100: operations.  At the LM slice's prefill
// (B = 1, H = 14, Hkv = 2, S = 32768, D = 64, bf16, causal) the visible
// (q, k) pairs need 4 * H * D * S(S+1)/2 = 1.92e12 operations for 134 MB
// of q, k, v and out: ~1.94 ms on bf16 tensor cores at 989 TFLOP/s against
// 0.04 ms of bytes at 3.35 TB/s.  On the CUDA cores (67 TFLOP/s) the same
// work cannot take less than ~29 ms, so the bf16 route has to reach the
// tensor cores, and then the softmax's exponentials (16 a clock per SM, one
// per score) cost about as much as the two products at D = 64.
//
// What the bf16 design does about it (flash_fwd_wgmma_kernel):
//   * A block of 288 threads owns 128 query rows of one head: two consumer
//     warpgroups of 64 rows each and one producer warp.  The producer's
//     first lane loads the Q tile once and then K and V tiles of 128 keys
//     by TMA into a ring of two stages, each stage with a "full" mbarrier
//     (TMA completes it by bytes) and an "empty" one (each consumer warp
//     arrives when it has read the stage), so the next tile's load runs
//     under the current tile's products.
//   * S = Q K^T is wgmma m64n128k16 with Q and K both read from shared
//     memory, both K-major (rows contiguous in D), in TMA's 128-byte swizzle
//     (64-byte at D = 32) that the wgmma descriptors name too.  D = 128
//     rows are loaded as two 64-column panels.
//   * The online softmax runs on the accumulator's registers: a thread
//     holds two rows' scores, so a row's max and sum are two shuffles
//     across the 4 lanes that share it.  The mask is evaluated only on
//     tiles that need it (diagonal, window edge, ragged end of S); full
//     tiles take the unmasked path.  exp is ex2.approx of (s - m) * log2 e:
//     its relative error (~2^-22) is far below the bf16 rounding of p.
//   * O += P V is wgmma with P from registers: the fp32 score fragment of
//     m64n128 has the layout of the bf16 A fragment of m64nDk16, so P is
//     rounded to bf16 in place, with no trip through shared memory.  V is
//     read from shared memory as stored, (key, D) row-major, with the
//     transposed-B flag.
//   * Ragged S: Q, K and V are 3-D tensor maps (D, S, heads), so a tile
//     that runs past a head's S is zero-filled by TMA rather than reading
//     the next head's rows; scores with col >= S are masked as before, and
//     output rows >= S are not stored.  Out is stored from registers.
//   * The tensor maps are encoded on the host through
//     cudaGetDriverEntryPoint (no -lcuda) and passed as __grid_constant__.
// Shared memory: Q 128 x D plus two stages of K and V (128 x D each), in
// bf16: 160 KB at D = 128, above the 48 KB static limit, so the launch sets
// the dynamic limit.  At D = 192 (nemotron's heads) a tile is three
// 64-column panels, the ring has one stage (144 KB; two would need 240 KB),
// and O += P V is wgmma m64n192k16.
//
// The fp32 design (flash_fwd_fp32_kernel): one block of 128 threads per
// 64-row query tile, 64-key kv tiles in fp32 shared memory, a thread owning
// a 4 x 8 block of scores and a 4 x D/8 block of the accumulator; products
// are FMAs, expf and the final division are IEEE (no --use_fast_math), so
// results stay within 3e-5 of the plain version.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 lanes (tx)

// rows x D floats of a row-major (., D) tensor into shared memory with row
// stride `stride`; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int valid,
                                          float* dst, int stride) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < kBlockK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    const float4 f = r < valid
                         ? __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D + c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * stride + c) = f;
  }
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o, int H,
                          int Hkv, int S, int causal, int window, float scale) {
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
  const float* qp = q + ((size_t)bh * S + q0) * D;
  const float* kp = k + (size_t)kv_head * S * D;
  const float* vp = v + (size_t)kv_head * S * D;
  float* op = o + ((size_t)bh * S + q0) * D;
  const int q_rows = min(kBlockQ, S - q0);

  // kv tiles this query tile can see.
  int kt_lo = 0;
  int kt_hi = (S - 1) / kBlockK;
  if (causal) kt_hi = min(kt_hi, (q0 + q_rows - 1) / kBlockK);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBlockK;

  const int tid = threadIdx.x;
  const int ty = tid / 8;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 8;  // score columns tx + 8j; output columns 4tx + 32jj + e

  load_tile<D>(qp, q_rows, sQ, kQKStride);

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
    load_tile<D>(kp + (size_t)k0 * D, S - k0, sK, kQKStride);
    load_tile<D>(vp + (size_t)k0 * D, S - k0, sV, D);
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
        sP[(ty * 4 + i) * kPStride + tx + 8 * j] = p;
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
      *reinterpret_cast<float4*>(op + (size_t)r * D + 4 * tx + 32 * jj) =
          make_float4(acc[i][4 * jj] / safe, acc[i][4 * jj + 1] / safe,
                      acc[i][4 * jj + 2] / safe, acc[i][4 * jj + 3] / safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int kSmem = (kBlockQ * (D + 4) + kBlockK * (D + 4) + kBlockK * D +
                         kBlockQ * (kBlockK + 4)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_fp32_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, S, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma), TMA loads, one producer warp
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBlockM = 128;           // query rows per block: two warpgroups of 64
constexpr int kBlockN = 128;           // keys per kv tile
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  // A row of a tile in shared memory is one swizzle span: 64 bf16 (128 B,
  // 128-byte swizzle) or, at D = 32, 32 bf16 (64 B, 64-byte swizzle); a
  // D = 128 or 192 tile is two or three such 64-column panels side by side.
  static constexpr int kPanelCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kPanelCols;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kPanelBytes = 128 * kRowBytes;      // 128 rows of a panel
  static constexpr int kBytes = kPanels * kPanelBytes;     // Q, K or V tile: 128 x D
  static constexpr int kKSteps = kPanelCols / 16;          // k16 steps per panel
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: B128, B64
  // K/V ring depth: two stages of 48 KB K and V tiles at D = 192 would
  // exceed the 227 KB of shared memory a block may have, so D = 192 loads
  // the next tile only once the current one is read.
  static constexpr int kStages = D <= 128 ? 2 : 1;
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete.  A load that never
// lands (a wrong byte count, a bad tensor map) would spin forever; after
// ~2^35 cycles (~20 s, far beyond any tile's wait) the kernel traps instead,
// so the launch fails with an error rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units) and the swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers that an in-flight wgmma reads or writes: the compiler may not
// move their uses across this point.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128, fp32) = A (64 x 16, shared) * B (16 x 128, shared) + (scale_d ? S : 0),
// A and B both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, fp32) += P (64 x 16, bf16 registers) * V (16 x N, shared,
// MN-major), for N = D = 32, 64, 128, 192.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o, int H, int Hkv, int S, int causal,
                           int window, float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // Swizzled tiles must start on 1024-byte boundaries (the swizzle's period).
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = sQ + (1 + 2 * T::kStages) * T::kBytes;
  const uint32_t q_full = bars + 8 * 2 * T::kStages;

  const int n_qtiles = (S + kBlockM - 1) / kBlockM;
  const int q0 = (n_qtiles - 1 - (int)blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int kv_head = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q_rows = min(kBlockM, S - q0);

  // kv tiles this query tile can see.
  int kt_lo = 0;
  int kt_hi = (S - 1) / kBlockN;
  if (causal) kt_hi = min(kt_hi, (q0 + q_rows - 1) / kBlockN);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBlockN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                            // full: the producer + bytes
      mbar_init(bars + 8 * (T::kStages + s), kConsumerWarps);   // empty: every consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer: Q once, then K and V tile by tile into the ring.
    if (lane == 0) {
      mbar_expect_tx(q_full, T::kBytes);
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(sQ + p * T::kPanelBytes, &tq, q_full, p * T::kPanelCols, q0, bh);
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int it = kt - kt_lo;
        const int st = it % T::kStages;
        const uint32_t sK = sQ + (1 + 2 * st) * T::kBytes;
        const uint32_t sV = sK + T::kBytes;
        mbar_wait(bars + 8 * (T::kStages + st), ((it / T::kStages) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * st, 2 * T::kBytes);
        for (int p = 0; p < T::kPanels; ++p) {
          tma_load(sK + p * T::kPanelBytes, &tk, bars + 8 * st, p * T::kPanelCols,
                   kt * kBlockN, kv_head);
          tma_load(sV + p * T::kPanelBytes, &tv, bars + 8 * st, p * T::kPanelCols,
                   kt * kBlockN, kv_head);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows wq0 .. wq0 + 63.  In the wgmma
  // fragments this thread holds rows r_lo and r_lo + 8 of them, and in
  // every 8-column group of S or O the columns c_lane and c_lane + 1.
  const int wg = warp / 4;
  const int wq0 = q0 + 64 * wg;
  const int r_lo = (warp % 4) * 16 + lane / 4;
  const int c_lane = 2 * (lane % 4);
  const uint32_t sQw = sQ + wg * 64 * T::kRowBytes;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // S stays in registers across kv tiles: the first k16 step of each tile
  // overwrites it (scale_d = 0), and the register budget is then fixed.
  float s[64];
  uint32_t p16[32];
  mbar_wait(q_full, 0);
  __syncwarp();

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int it = kt - kt_lo;
    const int st = it % T::kStages;
    const int k0 = kt * kBlockN;
    const uint32_t sK = sQ + (1 + 2 * st) * T::kBytes;
    const uint32_t sV = sK + T::kBytes;
    mbar_wait(bars + 8 * st, (it / T::kStages) & 1);
    __syncwarp();  // wgmma wants the warp converged

    // S = Q K^T over D in k16 steps.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / T::kKSteps) * T::kPanelBytes + (kk % T::kKSteps) * 32;
      const uint64_t da = smem_desc(sQw + off, 16, 8 * T::kRowBytes, T::kLayout);
      const uint64_t db = smem_desc(sK + off, 16, 8 * T::kRowBytes, T::kLayout);
      wgmma_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    // Online softmax.  s[j] is row r_lo + 8 ((j >> 1) & 1), column
    // 8 (j >> 2) + c_lane + (j & 1) of the tile.
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] *= scale;
    const bool edge = k0 + kBlockN > S || (causal && k0 + kBlockN - 1 > wq0) ||
                      (window > 0 && k0 <= wq0 + 63 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const int row = wq0 + r_lo + 8 * ((j >> 1) & 1);
        const int col = k0 + 8 * (j >> 2) + c_lane + (j & 1);
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        if (!ok) s[j] = kNegInf;
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        mx = fmaxf(mx, fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * c + 2 * h + e;
          s[j] = ex2((s[j] - m_new) * kLog2e);
          sum += s[j];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[h] = ex2((m[h] - m_new) * kLog2e);
      l[h] = alpha[h] * l[h] + sum;
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < 32; ++j) p16[j] = pack_bf16(s[2 * j], s[2 * j + 1]);

    // O += P V over the tile's keys in k16 steps; P's k16 slice kk is
    // p16[4kk .. 4kk+3].  V is MN-major: LBO steps between 64-column panels,
    // SBO between groups of 8 keys.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {p16[4 * kk], p16[4 * kk + 1], p16[4 * kk + 2], p16[4 * kk + 3]};
      wgmma_rs(acc, a,
               smem_desc(sV + kk * 16 * T::kRowBytes, T::kPanelBytes, 8 * T::kRowBytes,
                         T::kLayout));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(p16);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (T::kStages + st));
  }

  // out = acc / l, rows past S not stored.
  __nv_bfloat16* op = o + (size_t)bh * S * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wq0 + r_lo + 8 * h;
    if (row >= S) continue;
    const float safe = l[h] > 0.f ? l[h] : 1.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row * D + 8 * c + c_lane) =
          __floats2bfloat162_rn(acc[i] / safe, acc[i + 1] / safe);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (D, S, heads) bf16 tensor map with 128-row boxes of one swizzle span.
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, int S, int heads) {
  using T = Tile<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::kPanelCols, (cuuint32_t)kBlockN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int causal, int window, float scale,
                   cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(&tq, q, S, B * H) || !tensor_map<D>(&tk, k, S, B * Hkv) ||
      !tensor_map<D>(&tv, v, S, B * Hkv))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Hkv, S, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

typedef cudaError_t (*Launch)(const void*, const void*, const void*, void*, int, int, int,
                              int, int, int, float, cudaStream_t);

int run(Launch d32, Launch d64, Launch d128, Launch d192, const void* q, const void* k,
        const void* v, void* o, int B, int H, int Hkv, int S, int D, int causal, int window,
        float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  Launch fn = D == 32 ? d32 : D == 64 ? d64 : D == 128 ? d128 : D == 192 ? d192 : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, o, B, H, Hkv, S, causal, window, scale,
                 static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// o (B, H, S, D) = attention(q (B, H, S, D), k, v (B, Hkv, S, D)); all
// contiguous on the device; window <= 0 means no window.  Each returns the
// launch's cudaError_t.

// bf16, on the tensor cores.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                             int H, int Hkv, int S, int D, int causal, int window,
                             float scale, void* stream) {
  return run(tc::launch<32>, tc::launch<64>, tc::launch<128>, tc::launch<192>, q, k, v, o, B,
             H, Hkv, S, D, causal, window, scale, stream);
}

// fp32, on the CUDA cores.
int flash_attention_fwd_fp32(const void* q, const void* k, const void* v, void* o, int B,
                             int H, int Hkv, int S, int D, int causal, int window,
                             float scale, void* stream) {
  return run(fp32::launch<32>, fp32::launch<64>, fp32::launch<128>, fp32::launch<192>, q, k,
             v, o, B, H, Hkv, S, D, causal, window, scale, stream);
}

}  // extern "C"
