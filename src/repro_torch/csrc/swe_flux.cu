// Well-balanced shallow-water flux kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * swe_fused_step  <- kernels/swe_flux/swe_flux.py:204 swe_fused_step_pallas
//     (body _fused_kernel :160, flux math _sweep_math :55): one forward-Euler
//     step of the whole scheme for a stacked batch, x and y sweeps fused;
//   * swe_sweep       <- kernels/swe_flux/swe_flux.py:108 swe_sweep_pallas
//     (body _sweep_kernel :98): one directional sweep returning the
//     (dh, dhu, dhv)/d tendencies; the Euler update stays in PyTorch.
//
// Scheme (repro swe/solver.py): hydrostatic reconstruction b* = max(bL, bR),
// desingularised velocities, Rusanov flux with the advective momentum flux
// only, and the pressure + bed source assembled per cell in deviation form
// (small difference x large sum), which keeps lake-at-rest exact in fp32.
//
// What bounds it on the H100: memory.  Per cell and step the fused kernel
// reads h, hu, hv (and b) and writes h, hu, hv: 28 bytes per cell of
// compulsory traffic for ~150 flops, far below the card's ~20 flop/byte
// balance point.  At 288x288 and B = 8 one step moves ~16.3 MB, ~4.9 us at
// 3.35 TB/s; at 96x96 (~1.8 MB) the step is bound by the launch itself.
//
// What the design does about it: one thread per interior cell on a 2-D tile
// grid with blockIdx.z = batch member, so every plane is read in coalesced
// rows and written once.  Edge ("outflow") ghost cells are clamped-index
// loads instead of padded copies, which removes the padding pass of the
// TPU version; the four neighbour loads of a cell hit L1/L2, not DRAM.  The
// x and y fluxes, the Euler update, the positivity clamp and the wet mask
// stay in registers, and the probe gauge write eta = h + b of the step goes
// straight into the (B, T, P) series buffer, so a time step is one launch.
// The TPU design of one program per padded plane (and its 8 MiB VMEM limit
// and strip fallback) has no counterpart: the kernel works at any grid size.
//
// Built with --fmad=false (kernels/build.py): at 7 km depth one ulp of h is
// 0.5 mm of sea surface, and an FMA that rounds h differently from the plain
// version moves the momentum by ~1e-4 of its size within a step.  Without
// contraction every operation rounds as the plain version's does; the
// flops are free here, since the kernel is bound by bytes.
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

__device__ __forceinline__ float desing(float h, float hq) {
  // u = hq/h without dividing by ~0 in dry cells (Kurganov-Petrova).
  float h2 = h * h;
  float h4 = h2 * h2;
  return kSqrt2 * h * hq / sqrtf(h4 + fmaxf(h4, kEps4));
}

// Rusanov flux through the face between cell l and cell r along the normal
// axis.  qn is the momentum along the normal, qt the one across it.
__device__ __forceinline__ Face face_flux(float hl, float qnl, float qtl, float bl,
                                          float hr, float qnr, float qtr, float br,
                                          float g) {
  float bstar = fmaxf(bl, br);
  Face f;
  f.hL = fmaxf(hl + bl - bstar, 0.f);
  f.hR = fmaxf(hr + br - bstar, 0.f);
  float uL = desing(hl, qnl), vL = desing(hl, qtl);
  float uR = desing(hr, qnr), vR = desing(hr, qtr);
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

// Flux difference of a cell's two faces plus the deviation-form pressure.
__device__ __forceinline__ Tendency tendency(const Face& l, const Face& r,
                                             float g, float d) {
  Tendency t;
  float press = 0.25f * g *
                ((r.hR - r.hL) * (r.hR + r.hL) + (l.hR - l.hL) * (l.hR + l.hL));
  t.dh = (r.f0 - l.f0) / d;
  t.dn = ((r.f1 - l.f1) + press) / d;
  t.dt = (r.f2 - l.f2) / d;
  return t;
}

struct Cell {
  float h, hu, hv, b;
};

__device__ __forceinline__ Cell load(const float* __restrict__ h,
                                     const float* __restrict__ hu,
                                     const float* __restrict__ hv,
                                     const float* __restrict__ b,
                                     size_t k, size_t kb) {
  return Cell{__ldg(h + k), __ldg(hu + k), __ldg(hv + k), __ldg(b + kb)};
}

// x faces take (hu, hv) as (normal, tangential); y faces take (hv, hu).
__device__ __forceinline__ Face x_face(const Cell& l, const Cell& r, float g) {
  return face_flux(l.h, l.hu, l.hv, l.b, r.h, r.hu, r.hv, r.b, g);
}
__device__ __forceinline__ Face y_face(const Cell& l, const Cell& r, float g) {
  return face_flux(l.h, l.hv, l.hu, l.b, r.h, r.hv, r.hu, r.b, g);
}

__global__ void swe_fused_step_kernel(
    const float* __restrict__ h, const float* __restrict__ hu,
    const float* __restrict__ hv, const float* __restrict__ b,
    float* __restrict__ h_out, float* __restrict__ hu_out,
    float* __restrict__ hv_out, float* __restrict__ series,
    const int* __restrict__ pi, const int* __restrict__ pj, int n_probes,
    int t, int n_steps, int ny, int nx, float g, float dx, float dy, float dt) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  int n = blockIdx.z;
  size_t off = (size_t)n * ny * nx;
  const float* H = h + off;
  const float* HU = hu + off;
  const float* HV = hv + off;
  // Clamped neighbours = zero-gradient (outflow) ghost cells.
  int jw = max(j - 1, 0), je = min(j + 1, nx - 1);
  int is = max(i - 1, 0), in = min(i + 1, ny - 1);
  size_t kc = (size_t)i * nx + j;
  Cell c = load(H, HU, HV, b, kc, kc);
  size_t kw = (size_t)i * nx + jw, ke = (size_t)i * nx + je;
  size_t ks = (size_t)is * nx + j, kn = (size_t)in * nx + j;
  Cell w = load(H, HU, HV, b, kw, kw);
  Cell e = load(H, HU, HV, b, ke, ke);
  Cell s = load(H, HU, HV, b, ks, ks);
  Cell nn = load(H, HU, HV, b, kn, kn);

  Tendency tx = tendency(x_face(w, c, g), x_face(c, e, g), g, dx);
  Tendency ty = tendency(y_face(s, c, g), y_face(c, nn, g), g, dy);
  // x: (dh, dhu, dhv) = (dh, dn, dt);  y: (dh, dhv, dhu) = (dh, dn, dt).
  float h_new = fmaxf(c.h - dt * (tx.dh + ty.dh), 0.f);
  float hu_new = c.hu - dt * (tx.dn + ty.dt);
  float hv_new = c.hv - dt * (tx.dt + ty.dn);
  bool wet = h_new > kHEps;
  h_out[off + kc] = h_new;
  hu_out[off + kc] = wet ? hu_new : 0.f;
  hv_out[off + kc] = wet ? hv_new : 0.f;
  for (int p = 0; p < n_probes; ++p) {
    if (pi[p] == i && pj[p] == j) {
      series[((size_t)n * n_steps + t) * n_probes + p] = h_new + c.b;
    }
  }
}

__global__ void swe_sweep_kernel(
    const float* __restrict__ h, const float* __restrict__ hu,
    const float* __restrict__ hv, const float* __restrict__ b,
    float* __restrict__ dh, float* __restrict__ dhu, float* __restrict__ dhv,
    int ny, int nx, int axis, float g, float d) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  size_t off = (size_t)blockIdx.z * ny * nx;
  const float* H = h + off;
  const float* HU = hu + off;
  const float* HV = hv + off;
  size_t kc = (size_t)i * nx + j;
  size_t kl, kr;  // the two neighbours along the sweep axis
  if (axis == 0) {
    kl = (size_t)i * nx + max(j - 1, 0);
    kr = (size_t)i * nx + min(j + 1, nx - 1);
  } else {
    kl = (size_t)max(i - 1, 0) * nx + j;
    kr = (size_t)min(i + 1, ny - 1) * nx + j;
  }
  Cell c = load(H, HU, HV, b, kc, kc);
  Cell l = load(H, HU, HV, b, kl, kl);
  Cell r = load(H, HU, HV, b, kr, kr);
  if (axis == 0) {
    Tendency t = tendency(x_face(l, c, g), x_face(c, r, g), g, d);
    dh[off + kc] = t.dh;
    dhu[off + kc] = t.dn;
    dhv[off + kc] = t.dt;
  } else {
    Tendency t = tendency(y_face(l, c, g), y_face(c, r, g), g, d);
    dh[off + kc] = t.dh;
    dhu[off + kc] = t.dt;
    dhv[off + kc] = t.dn;
  }
}

constexpr int kTileX = 32;
constexpr int kTileY = 8;

dim3 tile_grid(int B, int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, B);
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
  swe_fused_step_kernel<<<tile_grid(B, ny, nx), dim3(kTileX, kTileY), 0,
                          (cudaStream_t)stream>>>(
      h, hu, hv, b, h_out, hu_out, hv_out, series, pi, pj, n_probes, t,
      n_steps, ny, nx, g, dx, dy, dt);
  return (int)cudaGetLastError();
}

// One directional sweep (axis 0 = x, 1 = y) for (B, ny, nx) planes; writes
// the (dh, dhu, dhv)/d tendencies of every cell.
int swe_sweep(const float* h, const float* hu, const float* hv, const float* b,
              float* dh, float* dhu, float* dhv, int B, int ny, int nx,
              int axis, float g, float d, void* stream) {
  swe_sweep_kernel<<<tile_grid(B, ny, nx), dim3(kTileX, kTileY), 0,
                     (cudaStream_t)stream>>>(h, hu, hv, b, dh, dhu, dhv, ny, nx,
                                              axis, g, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
