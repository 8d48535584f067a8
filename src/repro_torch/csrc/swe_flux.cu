// Well-balanced shallow-water flux kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * swe_fused_step  <- kernels/swe_flux/swe_flux.py:204 swe_fused_step_pallas
//     (body _fused_kernel :160, flux math _sweep_math :55): one forward-Euler
//     step of the whole scheme for a stacked batch, x and y sweeps fused;
//   * swe_sweep       <- kernels/swe_flux/swe_flux.py:108 swe_sweep_pallas
//     (body _sweep_kernel :98): one directional sweep returning the
//     (dh, dhu, dhv)/d tendencies; the Euler update stays in PyTorch.  The
//     main path runs it at 288 x 288 with B = 1, for the single fine solve
//     that makes the synthetic observations.
//
// Scheme (repro swe/solver.py): hydrostatic reconstruction b* = max(bL, bR),
// desingularised velocities, Rusanov flux with the advective momentum flux
// only, and the pressure + bed source assembled per cell in deviation form
// (small difference x large sum), which keeps lake-at-rest exact in fp32.
//
// What bounds the fused step on the H100: instruction issue, not bytes.
// Its compulsory traffic is 28 bytes per cell (read h, hu, hv, b; write h,
// hu, hv): at 288x288 and B = 8 one step moves ~16.3 MB, ~4.9 us at
// 3.35 TB/s.  But the arithmetic is IEEE throughout (--fmad=false, below),
// every sqrt and division is a multi-instruction sequence, and a cell that
// computes its own four faces computes every face twice and its
// neighbours' velocities (one sqrt, one division each) eight times.
//
// What the design does about it: a block owns a 32 x TY tile of one batch
// member, one cell a thread (lane = column, warp = row), and works in three
// phases behind __syncthreads, through shared memory:
//   1. it loads the (TY+2) x (32+2) halo tile of h, hu, hv and b, and
//      computes each cell's velocities u = hu / h, v = hv / h once
//      (the two share their denominator's sqrt);
//   2. it computes each of the tile's TY x 33 x faces and (TY+1) x 32 y
//      faces once (f0, f1, f2, hL, hR): each thread the x face west of its
//      cell and the y face south of it, two warps the faces on the tile's
//      east and north edges;
//   3. each cell takes its two tendencies from its four faces, then the
//      Euler update, the positivity clamp and the wet mask.
// Edge ("outflow") ghost cells are clamped indices, no padded copies.  A
// zero dividend is returned as it is (+-0 / b = +-0 for b > 0), which skips
// the division's slow path; zeros are most dividends on dry land and in the
// ocean before the wave arrives.  The probe gauge eta = h + b of the step
// is written by the block whose tile holds the probe, from shared memory,
// straight into the (B, T, P) series buffer, so a time step is one launch.
// Every operation and its order are those of a cell that computes its own
// faces (face_flux_uv, tendency), so a face computed once has the bits it
// had when two cells computed it.  Two tile shapes: 32 x 8 where the blocks
// fill every SM four times over (the fine level, 288 x 288 x 8), 32 x 4
// below that (the coarse level, 96 x 96 x 8, is 73,728 cells: larger tiles
// would leave SMs idle).  What still bounds the
// step is instruction issue: every sqrt and division is an estimate, its
// refinement and a range check branching to a slow-path subroutine, about
// a third of the kernel's SASS, and the branches cut the code into short
// blocks that the scheduler cannot interleave.
//
// The sweep is the same tile kernel in one-direction mode: it loads the halo
// along its axis only, computes each cell's velocities once and each face
// normal to its axis once, and writes each cell's tendencies from its two
// faces.  At 288 x 288 and B = 1 it has ~20 warps an SM: its launch and the
// tile's latency, not bytes, bound it.
// The TPU design of one program per padded plane (and its 8 MiB VMEM limit
// and strip fallback) has no counterpart: the kernel works at any grid size.
//
// Built with --fmad=false (kernels/build.py): at 7 km depth one ulp of h is
// 0.5 mm of sea surface, and an FMA that rounds h differently from the plain
// version moves the momentum by ~1e-4 of its size within a step.  Without
// contraction every operation rounds as the plain version's does.
#include <cuda_runtime.h>

namespace {

constexpr float kHEps = 1e-3f;           // wet/dry threshold [m]
constexpr float kEps4 = 1e-12f;          // kHEps^4
constexpr float kSqrt2 = 1.41421356237f;  // rounds to sqrt(2) in fp32

struct Face {
  float f0, f1, f2;  // mass, normal- and tangential-momentum fluxes
  float hL, hR;      // reconstructed depths on either side
};

struct Tendency {
  float dh, dn, dt;  // mass, normal- and tangential-momentum tendencies
};

// a / b for b > 0, with a zero dividend returned as it is: +-0 / b is +-0,
// and the IEEE division sends a zero dividend down its slow path.
__device__ __forceinline__ float div_nz(float a, float b) { return a == 0.f ? a : a / b; }

// Rusanov flux through the face between cell l and cell r along the normal
// axis, from each side's depth, velocities along the normal (u) and across
// it (v), and bed.
__device__ __forceinline__ Face face_flux_uv(float hl, float uL, float vL, float bl,
                                             float hr, float uR, float vR, float br,
                                             float g) {
  float bstar = fmaxf(bl, br);
  Face f;
  f.hL = fmaxf(hl + bl - bstar, 0.f);
  f.hR = fmaxf(hr + br - bstar, 0.f);
  float huL = f.hL * uL, hvL = f.hL * vL;
  float huR = f.hR * uR, hvR = f.hR * vR;
  float cL = fabsf(uL) + (f.hL > 0.f ? sqrtf(g * f.hL) : 0.f);
  float cR = fabsf(uR) + (f.hR > 0.f ? sqrtf(g * f.hR) : 0.f);
  float a = fmaxf(cL, cR);
  f.f0 = 0.5f * (huL + huR) - 0.5f * a * (f.hR - f.hL);
  f.f1 = 0.5f * (huL * uL + huR * uR) - 0.5f * a * (huR - huL);
  f.f2 = 0.5f * (hvL * uL + hvR * uR) - 0.5f * a * (hvR - hvL);
  return f;
}

// Flux difference of a cell's two faces plus the deviation-form pressure,
// over the cell width d.
__device__ __forceinline__ Tendency tendency(const Face& l, const Face& r, float g, float d) {
  Tendency t;
  float press = 0.25f * g *
                ((r.hR - r.hL) * (r.hR + r.hL) + (l.hR - l.hL) * (l.hR + l.hL));
  t.dh = div_nz(r.f0 - l.f0, d);
  t.dn = div_nz((r.f1 - l.f1) + press, d);
  t.dt = div_nz(r.f2 - l.f2, d);
  return t;
}

// ---------------------------------------------------------------------------
// Tiles of kTileW x TY cells a block, one cell a thread (lane = column, warp
// = row): the fused step, and the sweep in one direction.
// ---------------------------------------------------------------------------
constexpr int kTileW = 32;

template <int TY>
struct StepTile {
  static constexpr int kW = kTileW + 2, kH = TY + 2;  // halo tile
  float4 cell[kH][kW];  // h, u, v, b (u, v desingularised)
  float hu[kH][kW], hv[kH][kW];
  // x face [r][c] lies west of tile cell (r, c), y face [r][c] south of it;
  // f0, f1, f2, hL in one float4, hR beside it.
  float4 xf[TY][kTileW + 1];
  float xhr[TY][kTileW + 1];
  float4 yf[TY + 1][kTileW];
  float yhr[TY + 1][kTileW];
};

// Halo cell (r, c) of the tile at (i0, j0): load it and compute its
// velocities u = hu / h and v = hv / h without dividing by ~0 in dry cells
// (Kurganov-Petrova desingularisation), which share their sqrt.  Clamped
// rows and columns = zero-gradient (outflow) ghost cells.
template <int TY>
__device__ __forceinline__ void load_halo_cell(StepTile<TY>& s, int r, int c,
                                               const float* __restrict__ h,
                                               const float* __restrict__ hu,
                                               const float* __restrict__ hv,
                                               const float* __restrict__ b, size_t off,
                                               int i0, int j0, int ny, int nx) {
  const int i = min(max(i0 + r - 1, 0), ny - 1);
  const int j = min(max(j0 + c - 1, 0), nx - 1);
  const size_t kb = (size_t)i * nx + j, kc = off + kb;
  const float ch = __ldg(h + kc), chu = __ldg(hu + kc), chv = __ldg(hv + kc);
  const float h2 = ch * ch;
  const float h4 = h2 * h2;
  const float nu = kSqrt2 * ch * chu, nv = kSqrt2 * ch * chv;
  float u = nu, v = nv;
  if (nu != 0.f || nv != 0.f) {
    const float den = sqrtf(h4 + fmaxf(h4, kEps4));
    u = div_nz(nu, den);
    v = div_nz(nv, den);
  }
  s.cell[r][c] = make_float4(ch, u, v, __ldg(b + kb));
  s.hu[r][c] = chu;
  s.hv[r][c] = chv;
}

// The face between halo cells l and q: an x face takes (u, v) as (normal,
// tangential), a y face (v, u).
template <bool kX>
__device__ __forceinline__ void store_face(float4* out, float* out_hr, const float4& l,
                                           const float4& q, float g) {
  const Face f = kX ? face_flux_uv(l.x, l.y, l.z, l.w, q.x, q.y, q.z, q.w, g)
                    : face_flux_uv(l.x, l.z, l.y, l.w, q.x, q.z, q.y, q.w, g);
  *out = make_float4(f.f0, f.f1, f.f2, f.hL);
  *out_hr = f.hR;
}

__device__ __forceinline__ Face face_at(const float4& f, float hR) {
  return Face{f.x, f.y, f.z, f.w, hR};
}

// Every x face of the tile once, from the loaded halo rows 1..TY: each
// thread the face west of its cell, warp TY - 2 the faces east of the tile.
template <int TY>
__device__ __forceinline__ void x_faces(StepTile<TY>& s, int r, int c, float g) {
  store_face<true>(&s.xf[r][c], &s.xhr[r][c], s.cell[r + 1][c], s.cell[r + 1][c + 1], g);
  if (r == TY - 2 && c < TY)
    store_face<true>(&s.xf[c][kTileW], &s.xhr[c][kTileW], s.cell[c + 1][kTileW],
                     s.cell[c + 1][kTileW + 1], g);
}

// Every y face of the tile once, from the loaded halo columns 1..32: each
// thread the face south of its cell, warp TY - 1 the faces north of the tile.
template <int TY>
__device__ __forceinline__ void y_faces(StepTile<TY>& s, int r, int c, float g) {
  store_face<false>(&s.yf[r][c], &s.yhr[r][c], s.cell[r][c + 1], s.cell[r + 1][c + 1], g);
  if (r == TY - 1)
    store_face<false>(&s.yf[TY][c], &s.yhr[TY][c], s.cell[TY][c + 1], s.cell[TY + 1][c + 1], g);
}

// A cell's x and y tendencies from the faces in shared memory.
template <int TY>
__device__ __forceinline__ Tendency x_tendency(const StepTile<TY>& s, int r, int c, float g,
                                               float dx) {
  return tendency(face_at(s.xf[r][c], s.xhr[r][c]), face_at(s.xf[r][c + 1], s.xhr[r][c + 1]),
                  g, dx);
}
template <int TY>
__device__ __forceinline__ Tendency y_tendency(const StepTile<TY>& s, int r, int c, float g,
                                               float dy) {
  return tendency(face_at(s.yf[r][c], s.yhr[r][c]), face_at(s.yf[r + 1][c], s.yhr[r + 1][c]),
                  g, dy);
}

// A block of 32 x TY threads; 2048 threads (64 warps) an SM, so at most 32
// registers a thread.
template <int TY>
__global__ void __launch_bounds__(kTileW * TY, 2048 / (kTileW * TY)) swe_fused_step_kernel(
    const float* __restrict__ h, const float* __restrict__ hu,
    const float* __restrict__ hv, const float* __restrict__ b,
    float* __restrict__ h_out, float* __restrict__ hu_out,
    float* __restrict__ hv_out, float* __restrict__ series,
    const int* __restrict__ pi, const int* __restrict__ pj, int n_probes,
    int t, int n_steps, int ny, int nx, float g, float dx, float dy, float dt) {
  static_assert(TY >= 3 && 2 * (TY + 2) <= kTileW,
                "warps 0-2 load the halo's extra rows, warp 2 its edge columns");
  __shared__ StepTile<TY> s;
  const int c = threadIdx.x, r = threadIdx.y;  // this thread's cell
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * kTileW;
  const size_t off = (size_t)n * ny * nx;

  // 1. The halo tile and its velocities: each thread its own halo column
  //    c + 1 in row r; warps 0 and 1 also rows TY and TY + 1, warp 2 the
  //    two edge columns.
  load_halo_cell(s, r, c + 1, h, hu, hv, b, off, i0, j0, ny, nx);
  if (r < 2) load_halo_cell(s, TY + r, c + 1, h, hu, hv, b, off, i0, j0, ny, nx);
  if (r == 2 && c < 2 * (TY + 2))
    load_halo_cell(s, c >> 1, (c & 1) * (kTileW + 1), h, hu, hv, b, off, i0, j0, ny, nx);
  __syncthreads();

  // 2. Every face of the tile once.
  x_faces(s, r, c, g);
  y_faces(s, r, c, g);
  __syncthreads();

  // 3. The cell from its four faces.
  const Tendency tX = x_tendency(s, r, c, g, dx);
  const Tendency tY = y_tendency(s, r, c, g, dy);
  const float ch = s.cell[r + 1][c + 1].x;
  // x: (dh, dhu, dhv) = (dh, dn, dt);  y: (dh, dhv, dhu) = (dh, dn, dt).
  const float h_new = fmaxf(ch - dt * (tX.dh + tY.dh), 0.f);
  const float hu_new = s.hu[r + 1][c + 1] - dt * (tX.dn + tY.dt);
  const float hv_new = s.hv[r + 1][c + 1] - dt * (tX.dt + tY.dn);
  const int i = i0 + r, j = j0 + c;
  if (i < ny && j < nx) {
    const size_t kc = off + (size_t)i * nx + j;
    const bool wet = h_new > kHEps;
    h_out[kc] = h_new;
    hu_out[kc] = wet ? hu_new : 0.f;
    hv_out[kc] = wet ? hv_new : 0.f;
  }

  // Probe gauge: the block's first threads each take a probe and write
  // eta = h + b of the step if the probe lies in the block's tile.
  if (n_probes > 0) {
    s.cell[r + 1][c + 1].x = h_new;
    __syncthreads();
    for (int p = r * kTileW + c; p < n_probes; p += kTileW * TY) {
      const int pr = pi[p] - i0, pc = pj[p] - j0;
      if (pr >= 0 && pr < TY && pc >= 0 && pc < kTileW && pi[p] < ny && pj[p] < nx) {
        const float4 cp = s.cell[pr + 1][pc + 1];
        series[((size_t)n * n_steps + t) * n_probes + p] = cp.x + cp.w;
      }
    }
  }
}

// One directional sweep (kX: along x, else y) of a 32 x TY tile: the
// fused step's phases 1-3 for one axis, writing the tendencies.
template <bool kX, int TY>
__global__ void __launch_bounds__(kTileW * TY, 2048 / (kTileW * TY)) swe_sweep_kernel(
    const float* __restrict__ h, const float* __restrict__ hu,
    const float* __restrict__ hv, const float* __restrict__ b,
    float* __restrict__ dh, float* __restrict__ dhu, float* __restrict__ dhv,
    int ny, int nx, float g, float d) {
  static_assert(TY >= 2 && 2 * TY <= kTileW, "warp 0 loads the x halo's two columns");
  __shared__ StepTile<TY> s;
  const int c = threadIdx.x, r = threadIdx.y;  // this thread's cell
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * kTileW;
  const size_t off = (size_t)n * ny * nx;

  // 1. The tile's cells and the halo along the axis, with their velocities:
  //    each thread its own cell; for x, warp 0 the two edge columns; for y,
  //    warps 0 and 1 the rows below and above the tile.
  load_halo_cell(s, r + 1, c + 1, h, hu, hv, b, off, i0, j0, ny, nx);
  if (kX) {
    if (r == 0 && c < 2 * TY)
      load_halo_cell(s, 1 + (c >> 1), (c & 1) * (kTileW + 1), h, hu, hv, b, off, i0, j0, ny,
                     nx);
  } else if (r < 2) {
    load_halo_cell(s, r * (TY + 1), c + 1, h, hu, hv, b, off, i0, j0, ny, nx);
  }
  __syncthreads();

  // 2. Every face normal to the axis once.
  if (kX)
    x_faces(s, r, c, g);
  else
    y_faces(s, r, c, g);
  __syncthreads();

  // 3. The cell from its two faces.  x: (dh, dhu, dhv) = (dh, dn, dt);
  //    y: (dh, dhv, dhu) = (dh, dn, dt).
  const int i = i0 + r, j = j0 + c;
  if (i < ny && j < nx) {
    const size_t kc = off + (size_t)i * nx + j;
    const Tendency t = kX ? x_tendency(s, r, c, g, d) : y_tendency(s, r, c, g, d);
    dh[kc] = t.dh;
    dhu[kc] = kX ? t.dn : t.dt;
    dhv[kc] = kX ? t.dt : t.dn;
  }
}

dim3 tile_grid(int B, int ny, int nx, int tx, int ty) {
  return dim3((nx + tx - 1) / tx, (ny + ty - 1) / ty, B);
}

// The tile heights: 32 x 8 where those blocks fill every SM four times over
// (the fused step at the fine level), else 32 x 4 (see the top).
constexpr int kFineTY = 8, kCoarseTY = 4;

template <int TY>
void launch_fused(int B, int ny, int nx, cudaStream_t stream, const float* h,
                  const float* hu, const float* hv, const float* b, float* h_out,
                  float* hu_out, float* hv_out, float* series, const int* pi,
                  const int* pj, int n_probes, int t, int n_steps, float g, float dx,
                  float dy, float dt) {
  swe_fused_step_kernel<TY><<<tile_grid(B, ny, nx, kTileW, TY), dim3(kTileW, TY), 0, stream>>>(
      h, hu, hv, b, h_out, hu_out, hv_out, series, pi, pj, n_probes, t, n_steps, ny, nx, g,
      dx, dy, dt);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

bool fine_tiles(int B, int ny, int nx) {
  const dim3 fine = tile_grid(B, ny, nx, kTileW, kFineTY);
  return (long)fine.x * fine.y * fine.z >= 4L * sm_count();
}

template <bool kX, int TY>
void launch_sweep(int B, int ny, int nx, cudaStream_t stream, const float* h,
                  const float* hu, const float* hv, const float* b, float* dh, float* dhu,
                  float* dhv, float g, float d) {
  swe_sweep_kernel<kX, TY><<<tile_grid(B, ny, nx, kTileW, TY), dim3(kTileW, TY), 0, stream>>>(
      h, hu, hv, b, dh, dhu, dhv, ny, nx, g, d);
}

}  // namespace

extern "C" {

// One fused step for a stacked (B, ny, nx) batch; b is (ny, nx).  When
// n_probes > 0 the step's probe values land in series[(n * n_steps + t) *
// n_probes + p].  Returns the launch's cudaError_t.
int swe_fused_step(const float* h, const float* hu, const float* hv,
                   const float* b, float* h_out, float* hu_out, float* hv_out,
                   float* series, const int* pi, const int* pj, int n_probes,
                   int t, int n_steps, int B, int ny, int nx, float g, float dx,
                   float dy, float dt, void* stream) {
  auto launch = fine_tiles(B, ny, nx) ? launch_fused<kFineTY> : launch_fused<kCoarseTY>;
  launch(B, ny, nx, (cudaStream_t)stream, h, hu, hv, b, h_out, hu_out, hv_out, series,
         pi, pj, n_probes, t, n_steps, g, dx, dy, dt);
  return (int)cudaGetLastError();
}

// One directional sweep (axis 0 = x, 1 = y) for (B, ny, nx) planes; writes
// the (dh, dhu, dhv)/d tendencies of every cell.
int swe_sweep(const float* h, const float* hu, const float* hv, const float* b,
              float* dh, float* dhu, float* dhv, int B, int ny, int nx,
              int axis, float g, float d, void* stream) {
  const bool fine = fine_tiles(B, ny, nx);
  auto launch = axis == 0 ? (fine ? launch_sweep<true, kFineTY> : launch_sweep<true, kCoarseTY>)
                          : (fine ? launch_sweep<false, kFineTY> : launch_sweep<false, kCoarseTY>);
  launch(B, ny, nx, (cudaStream_t)stream, h, hu, hv, b, dh, dhu, dhv, g, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
