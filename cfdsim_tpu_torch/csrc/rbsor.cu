// Red-black SOR sweeps of the 5-point Poisson problem for NVIDIA Hopper
// (sm_90a): two kernels that share one update expression.
//
// Replaces the TPU kernels of cfdsim_tpu/ops/pallas/poisson_rb.py:
//   * rbsor_kernel         <- rbsor_pallas (kernel body _kernel)
//   * rbsor_blocked_kernel <- rbsor_pallas_blocked (kernel body _blocked_kernel)
//
// Both run red-black SOR for  lap(phi) = rhs : cells are coloured by the
// parity of (i + j) in global indices; a half-sweep updates one colour,
//
//     star = (nbsum(p) - rhs) * denom_inv
//     p    = (1 - omega) * p + omega * star
//
// with nbsum(p) = ((E + W) * ax + ay * N) + ay * S, the order of the Pallas
// kernel. Every rounding is spelled out (__fadd_rn, __fmul_rn), so nvcc
// contracts nothing into a fused multiply-add: each update is the same
// sequence of IEEE float32 operations as the plain torch version, and the
// two kernels give the same bits as each other and as that version.
//
// Boundary handling, as in the Pallas kernel: "neumann" clamps neighbours at
// the domain edge (ghost = edge value); "dirichlet" never updates the
// one-cell frame; a solid mask (value >= 0.5) freezes phi in those cells.
//
// What bounds them on the H100. One sweep does ~12 float operations per
// cell and, streamed from device memory, would move phi twice and rhs once
// per half-sweep: far below the ridge point, so a sweep loop is bound by
// memory traffic and by the synchronisation between half-sweeps (a red cell
// reads only black cells, so each half-sweep must see the whole previous
// one).
//
// rbsor_kernel is one persistent cooperative launch per call: a grid capped
// at the co-resident block count walks the cells of one colour with a
// grid-stride loop, and cooperative_groups grid sync separates half-sweeps.
// The 180x600 cylinder grid (phi + rhs, 0.86 MB) and every multigrid level
// up to 512^2 (2 MB) stay in the 50 MB L2 for the whole call, so a
// 50-sweep chunk is one launch with no device-memory round trip per sweep.
// phi is updated in place (race-free: a colour reads only the other one)
// and read through __ldcg, so no SM reads a stale line from its L1 after a
// grid sync. With a control block it is the early-exit chunk of
// solve_poisson(method="rbsor_pallas", tol>0): it returns at once when the
// device flag is clear, and after its sweeps it reduces the max residual
// |lap(phi) - rhs| exactly as poisson_residual computes it and clears the
// flag when the residual is <= tol. The host never reads the residual.
//
// rbsor_blocked_kernel is temporal blocking for large unmasked Neumann
// grids: each block loads a (T + 4K)^2 tile of phi and rhs (T = tile edge,
// halo H = 2K per side) into shared memory, runs K full sweeps there with
// __syncthreads between half-sweeps, and writes its T x T centre to a
// second buffer. A tile-rim cell that is not on the domain edge lacks a
// neighbour and is left stale; the staleness moves inwards by one cell per
// half-sweep, so after 2K half-sweeps it has not reached the centre, which
// is exactly K global sweeps. One pass reads phi and rhs once (plus halos,
// mostly from L2) for K sweeps instead of once per half-sweep.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

struct Relax {
  float ax, ay, denom_inv, omega, one_minus_omega;
};

__device__ __forceinline__ float relax(float p, float e, float w, float n,
                                       float s, float r, const Relax& c) {
  float acc = __fmul_rn(__fadd_rn(e, w), c.ax);
  acc = __fadd_rn(acc, __fmul_rn(c.ay, n));
  acc = __fadd_rn(acc, __fmul_rn(c.ay, s));
  const float star = __fmul_rn(__fsub_rn(acc, r), c.denom_inv);
  return __fadd_rn(__fmul_rn(c.one_minus_omega, p), __fmul_rn(c.omega, star));
}

// ---------------------------------------------------------------------------
// kernel A: all sweeps of one call in one cooperative launch
// ---------------------------------------------------------------------------

// ctl (nullable): ctl[0] = active flag, ctl[1] = residual max as uint bits.
// count (nullable): incremented once by every chunk that runs.
__global__ void __launch_bounds__(THREADS)
rbsor_kernel(float* __restrict__ phi, const float* __restrict__ rhs,
             const float* __restrict__ mask, int ny, int nx, int iters,
             Relax c, int dirichlet, int* __restrict__ ctl,
             int* __restrict__ count, float tol, float two_a) {
  cg::grid_group grid = cg::this_grid();
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  if (ctl != nullptr) {
    // every block reads the flag before any block can write it (block 0
    // writes it only after the last grid sync), so all leave together
    if (__ldcg(ctl) == 0) return;
    if (first) ctl[1] = 0;
    grid.sync();
  }
  // 32-bit indices: the wrapper refuses grids of 2^31 cells or more
  const int stride = static_cast<int>(gridDim.x * blockDim.x);
  const int t0 = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const int hw = (nx + 1) / 2;  // cells of one colour in a row, at most
  const int work = ny * hw;

  for (int it = 0; it < iters; ++it) {
    for (int color = 0; color < 2; ++color) {
      for (int k = t0; k < work; k += stride) {
        const int i = k / hw;
        const int j = 2 * (k - i * hw) + ((i + color) & 1);
        if (j >= nx) continue;
        if (dirichlet && (i == 0 || j == 0 || i == ny - 1 || j == nx - 1)) continue;
        const size_t g = static_cast<size_t>(i) * nx + j;
        if (mask != nullptr && __ldg(mask + g) >= 0.5f) continue;
        const float p = __ldcg(phi + g);
        const float e = j + 1 < nx ? __ldcg(phi + g + 1) : p;
        const float w = j > 0 ? __ldcg(phi + g - 1) : p;
        const float n = i + 1 < ny ? __ldcg(phi + g + nx) : p;
        const float s = i > 0 ? __ldcg(phi + g - nx) : p;
        phi[g] = relax(p, e, w, n, s, __ldg(rhs + g), c);
      }
      grid.sync();
    }
  }
  if (ctl == nullptr) return;

  // max |lap(phi) - rhs| over updatable cells, in poisson_residual's order:
  // neumann  (ax*(E+W) + ay*(N+S)) - 2(ax+ay)*p - rhs   (clamped edges)
  // dirichlet ((E - 2p) + W)*ax + ((N - 2p) + S)*ay - rhs  (interior only)
  // As uint bits, the max of non-negative floats orders +inf below NaN, so
  // a NaN residual propagates and clears the flag, as `res > tol` does.
  unsigned int rmax = 0u;
  const int cells = ny * nx;
  for (int k = t0; k < cells; k += stride) {
    const int i = k / nx;
    const int j = k - i * nx;
    const size_t g = static_cast<size_t>(k);
    if (mask != nullptr && __ldg(mask + g) >= 0.5f) continue;
    float lap;
    if (dirichlet) {
      if (i == 0 || j == 0 || i == ny - 1 || j == nx - 1) continue;
      const float p = __ldcg(phi + g);
      const float p2 = __fmul_rn(2.0f, p);
      const float lx = __fmul_rn(__fadd_rn(__fsub_rn(__ldcg(phi + g + 1), p2), __ldcg(phi + g - 1)), c.ax);
      const float ly = __fmul_rn(__fadd_rn(__fsub_rn(__ldcg(phi + g + nx), p2), __ldcg(phi + g - nx)), c.ay);
      lap = __fadd_rn(lx, ly);
    } else {
      const float p = __ldcg(phi + g);
      const float e = j + 1 < nx ? __ldcg(phi + g + 1) : p;
      const float w = j > 0 ? __ldcg(phi + g - 1) : p;
      const float n = i + 1 < ny ? __ldcg(phi + g + nx) : p;
      const float s = i > 0 ? __ldcg(phi + g - nx) : p;
      const float nb = __fadd_rn(__fmul_rn(c.ax, __fadd_rn(e, w)), __fmul_rn(c.ay, __fadd_rn(n, s)));
      lap = __fsub_rn(nb, __fmul_rn(two_a, p));
    }
    const unsigned int r = __float_as_uint(fabsf(__fsub_rn(lap, __ldg(rhs + g))));
    rmax = r > rmax ? r : rmax;
  }
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  __shared__ unsigned int warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = rmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int m = 0u;
    for (int w = 0; w < THREADS / 32; ++w) m = warp_max[w] > m ? warp_max[w] : m;
    atomicMax(reinterpret_cast<unsigned int*>(ctl + 1), m);
  }
  grid.sync();
  if (first) {
    const float res = __uint_as_float(static_cast<unsigned int>(__ldcg(ctl + 1)));
    ctl[0] = res > tol ? 1 : 0;
    if (count != nullptr) *count += 1;
  }
}

// ---------------------------------------------------------------------------
// kernel B: K sweeps per pass on shared-memory tiles with a 2K halo
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
rbsor_blocked_kernel(const float* __restrict__ phi_in,
                     const float* __restrict__ rhs, float* __restrict__ phi_out,
                     int ny, int nx, int sweeps, int tile, Relax c) {
  extern __shared__ float smem[];
  const int h = 2 * sweeps;
  const int S = tile + 2 * h;  // tile edge with its halo
  float* sp = smem;
  float* sr = smem + S * S;
  const int gi0 = static_cast<int>(blockIdx.y) * tile - h;  // global row of local row 0
  const int gj0 = static_cast<int>(blockIdx.x) * tile - h;

  // stage phi and rhs; cells outside the domain are never read (clamping
  // redirects edge reads), so they hold zero
  for (int idx = threadIdx.x; idx < S * S; idx += blockDim.x) {
    const int li = idx / S;
    const int lj = idx - li * S;
    const int gi = gi0 + li;
    const int gj = gj0 + lj;
    const bool in = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
    const size_t g = static_cast<size_t>(gi) * nx + gj;
    sp[idx] = in ? phi_in[g] : 0.0f;
    sr[idx] = in ? rhs[g] : 0.0f;
  }
  __syncthreads();

  const int hw = (S + 1) / 2;
  for (int it = 0; it < sweeps; ++it) {
    for (int color = 0; color < 2; ++color) {
      for (int k = threadIdx.x; k < S * hw; k += blockDim.x) {
        const int li = k / hw;
        const int gi = gi0 + li;
        // (gi + gj) % 2 == color with gj = gj0 + lj; & 1 is the parity of
        // a negative int as well (two's complement)
        const int lj = 2 * (k - li * hw) + ((gi + gj0 + color) & 1);
        if (lj >= S) continue;
        const int gj = gj0 + lj;
        if (gi < 0 || gi >= ny || gj < 0 || gj >= nx) continue;
        // a rim cell lacks a neighbour unless the domain edge clamps it
        const bool whole = (li > 0 || gi == 0) && (li < S - 1 || gi == ny - 1) &&
                           (lj > 0 || gj == 0) && (lj < S - 1 || gj == nx - 1);
        if (!whole) continue;
        const int l = li * S + lj;
        const float p = sp[l];
        const float e = gj == nx - 1 ? p : sp[l + 1];
        const float w = gj == 0 ? p : sp[l - 1];
        const float n = gi == ny - 1 ? p : sp[l + S];
        const float s = gi == 0 ? p : sp[l - S];
        sp[l] = relax(p, e, w, n, s, sr[l], c);
      }
      __syncthreads();
    }
  }

  for (int idx = threadIdx.x; idx < tile * tile; idx += blockDim.x) {
    const int ci = idx / tile;
    const int cj = idx - ci * tile;
    const int gi = gi0 + h + ci;
    const int gj = gj0 + h + cj;
    if (gi < ny && gj < nx) {
      phi_out[static_cast<size_t>(gi) * nx + gj] = sp[(h + ci) * S + h + cj];
    }
  }
}

int cooperative_blocks(int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
  if (cache[dev] > 0) return cache[dev];
  int sms = 0;
  int per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rbsor_kernel, THREADS, 0) !=
      cudaSuccess) {
    return -1;
  }
  cache[dev] = per_sm * sms;
  return cache[dev];
}

}  // namespace

extern "C" {

// Kernel A. phi (updated in place), rhs: device fp32 (ny, nx), contiguous;
// mask: fp32 (ny, nx) or null; ctl: int32[2] or null (early-exit chunk);
// count: int32 or null. Launches on `stream`, returns a cudaError_t code.
int cfd_rbsor(void* phi, const void* rhs, const void* mask, int ny, int nx,
              int iters, float ax, float ay, float denom_inv, float omega,
              float one_minus_omega, int dirichlet, void* ctl, void* count,
              float tol, float two_a, void* stream) {
  static int co_resident[MAX_DEVICES] = {0};
  const int cap = cooperative_blocks(co_resident);
  if (cap <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorCooperativeLaunchTooLarge);
  }
  const int work = ny * ((nx + 1) / 2);
  int want = (work + THREADS - 1) / THREADS;
  if (want < 1) want = 1;
  const int blocks = want < cap ? want : cap;

  float* phi_p = static_cast<float*>(phi);
  const float* rhs_p = static_cast<const float*>(rhs);
  const float* mask_p = static_cast<const float*>(mask);
  Relax c{ax, ay, denom_inv, omega, one_minus_omega};
  int* ctl_p = static_cast<int*>(ctl);
  int* count_p = static_cast<int*>(count);
  void* args[] = {&phi_p, &rhs_p, &mask_p, &ny, &nx, &iters, &c,
                  &dirichlet, &ctl_p, &count_p, &tol, &two_a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rbsor_kernel), dim3(blocks), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B, one pass of `sweeps` sweeps from phi_in to phi_out (distinct
// buffers). Tiles are tile x tile with a 2*sweeps halo; shared memory is
// 2 * (tile + 4*sweeps)^2 floats.
int cfd_rbsor_blocked(const void* phi_in, const void* rhs, void* phi_out,
                      int ny, int nx, int sweeps, int tile, float ax, float ay,
                      float denom_inv, float omega, float one_minus_omega,
                      void* stream) {
  const int S = tile + 4 * sweeps;
  const size_t smem = 2 * static_cast<size_t>(S) * S * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rbsor_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((nx + tile - 1) / tile, (ny + tile - 1) / tile);
  rbsor_blocked_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi_in), static_cast<const float*>(rhs),
      static_cast<float*>(phi_out), ny, nx, sweeps, tile,
      Relax{ax, ay, denom_inv, omega, one_minus_omega});
  return static_cast<int>(cudaGetLastError());
}

const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
