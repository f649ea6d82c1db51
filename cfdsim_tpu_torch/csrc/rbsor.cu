// Red-black SOR sweeps of the 5-point Poisson problem for NVIDIA Hopper
// (sm_90a): four kernels that share one update expression.
//
// Replaces the TPU kernels of cfdsim_tpu/ops/pallas/poisson_rb.py:
//   * rbsor_cluster_kernel, tiled::rbsor_kernel, rbsor_kernel
//                                        <- rbsor_pallas (kernel body _kernel)
//   * rbsor_blocked_kernel               <- rbsor_pallas_blocked (_blocked_kernel)
//
// All run red-black SOR for  lap(phi) = rhs : cells are coloured by the
// parity of (i + j) in global indices; a half-sweep updates one colour,
//
//     star = (nbsum(p) - rhs) * denom_inv
//     p    = (1 - omega) * p + omega * star
//
// with nbsum(p) = ((E + W) * ax + ay * N) + ay * S, the order of the Pallas
// kernel. Every rounding is spelled out (__fadd_rn, __fmul_rn), so nvcc
// contracts nothing into a fused multiply-add: each update is the same
// sequence of IEEE float32 operations as the plain torch version. A red cell
// reads only black cells, so any mapping of cells to threads gives the same
// bits: the kernels equal each other and that version bit for bit.
//
// Boundary handling, as in the Pallas kernel: "neumann" clamps neighbours at
// the domain edge (ghost = edge value); "dirichlet" never updates the
// one-cell frame; a solid mask (value >= 0.5) freezes phi in those cells.
//
// What bounds them on the H100. One sweep does ~11 float operations per
// cell and, streamed from device memory, would move phi twice and rhs once
// per half-sweep: far below the ridge point. A half-sweep must see the whole
// previous one, so a sweep loop is bound by memory traffic or, when the grid
// is small enough to stay on chip, by the synchronisation between
// half-sweeps.
//
// Kernel A, cluster route (rbsor_cluster_kernel): the Hopper counterpart of
// the TPU kernel's whole-grid VMEM residency. One thread-block cluster of C
// CTAs (C <= 16) holds the problem, each CTA one band of rows. Each thread
// owns a column pair over a few rows of its band and keeps their phi, rhs
// and solid/frame flags in registers for the whole solve; it publishes each
// updated value to the band's copy of phi in shared memory (one halo row
// per side), where its neighbours read it. There is no cluster barrier per
// half-sweep: a CTA stores its updated edge cells into its neighbours' halo
// rows with st.async, which counts the bytes on the receiver's mbarrier,
// and each CTA waits for its own halo bytes only before it updates its edge
// rows, after its interior rows. The whole early-exit solve is one launch:
// after every chunk of sweeps the CTAs reduce the max residual (as uint
// bits, in poisson_residual's order) through shared memory, every CTA takes
// the same decision, and phi goes back to device memory once at the end.
// Capacity is bound by registers: at most 8 rows of a column pair per
// thread, 1024 threads per CTA. What bounds its time is instruction throughput:
// a cluster has at most 16 SMs. It keeps the short solves (the multigrid's
// 2-sweep levels) and the grids below 4,096 cells.
//
// Kernel A, tiled route (tiled::rbsor_kernel): long solves on large grids,
// spread over the whole card. One persistent cooperative launch of one CTA
// per tile (at most one per SM, all co-resident); each CTA stages its tile
// with a halo of 2K cells in a window of shared memory (the same segments
// of column pairs in registers as the cluster route) and runs K sweeps on
// its own, with only a CTA barrier between half-sweeps: stale rim cells
// creep one cell inwards per half-sweep, so after 2K half-sweeps every
// owned cell is exact, as in kernel B. Then the tiles exchange their rims
// through double-buffered exchange buffers in L2: each CTA stores the owned
// cells within 2K of its edge, releases a per-tile epoch flag at GPU scope,
// and acquires the flags of its up to 8 neighbours before loading their
// cells. Cross-SM synchronisation is paid once per K sweeps instead of
// once per half-sweep. The early exit is the cluster route's, across all
// CTAs: after each chunk one more exchange, the max residual of each CTA's
// owned cells, a global atomicMax into a slot rotating by chunk, a grid
// sync, and the same decision everywhere. What bounds it is the handoff
// (store, release, poll, load: a few L2 round trips, ~1.5 us on 132 CTAs)
// once a pass, then the half-sweeps over the window: a half-sweep
// updates only the rows that can still reach the owned ones, about 2.1x
// the owned cells at K = 5 on a 64-column window.
//
// Kernel A, cooperative route (rbsor_kernel): for a grid above the cluster's
// capacity (chosen by size before the launch, never after a failure). One
// persistent cooperative launch per chunk: a grid capped at the co-resident
// block count walks the cells of one colour with a grid-stride loop, with a
// grid sync between half-sweeps and phi read through __ldcg (from L2), so no
// SM reads a stale L1 line. With a control block it is one chunk of the
// early exit: it returns at once when the device flag is clear, and after
// its sweeps it reduces the residual and clears the flag when it is <= tol.
//
// Kernel B (rbsor_blocked_kernel) is temporal blocking for large unmasked
// Neumann grids: K sweeps per pass on tiles of tr x tc cells with a halo of
// H = 2K per side (4 * ceil(2K / 4) columns, so that every staged row
// starts on a 16-byte boundary), written to a second buffer. A tile-rim
// cell that is not on the domain edge lacks a neighbour and is left stale;
// the staleness moves inwards by one cell per half-sweep, so after 2K
// half-sweeps it has not reached the centre, which is exactly K global
// sweeps. One block stages one tile: one TMA box per array
// (cp.async.bulk.tensor, out-of-bounds cells filled with zero, completion
// on an mbarrier) where the row pitch is a multiple of 16 bytes, else
// cp.async of 4 bytes with zero fill. Tiles are wide (a 32 x 128 centre by
// default), so with K = 2 a pass reads 1.33x the grid instead of the 1.56x
// of 32 x 32 tiles. What bounds it at 1024^2 is the sweeps over the staged
// tiles, then a load that all blocks make at once (the grid is one wave of
// blocks, so a block has no second tile whose load could overlap them).
// Its colours take a parity offset, the parity of the array's (0, 0) cell in
// the indices of a larger grid, so a rank's block padded by a 2K halo runs
// as one array: K sweeps of that grid on the block (parity 0 is the array's
// own checkerboard).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_CLUSTER = 16;
constexpr int CLUSTER_THREADS = 1024;
constexpr int B_THREADS = 512;
// words between two tiles' epoch flags on the tiled route: one 128-byte
// line each, so a tile's pollers share no L2 line with another tile's
constexpr int FLAG_STRIDE = 32;

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

// Each kernel adds one to its wrapper's launch count, from one thread, once
// per launch: a count kept on the device also counts the launches that a
// CUDA graph replays, which the host never sees.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  atomicAdd(launches, 1ULL);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// |lap(phi) - rhs| in poisson_residual's order:
// neumann   (ax*(E+W) + ay*(N+S)) - 2(ax+ay)*p - rhs   (clamped edges)
// dirichlet ((E - 2p) + W)*ax + ((N - 2p) + S)*ay - rhs  (interior only)
__device__ __forceinline__ float residual(float p, float e, float w, float n,
                                          float s, float r, bool dirichlet,
                                          float ax, float ay, float two_a) {
  float lap;
  if (dirichlet) {
    const float p2 = __fmul_rn(2.0f, p);
    const float lx = __fmul_rn(__fadd_rn(__fsub_rn(e, p2), w), ax);
    const float ly = __fmul_rn(__fadd_rn(__fsub_rn(n, p2), s), ay);
    lap = __fadd_rn(lx, ly);
  } else {
    const float nb = __fadd_rn(__fmul_rn(ax, __fadd_rn(e, w)), __fmul_rn(ay, __fadd_rn(n, s)));
    lap = __fsub_rn(nb, __fmul_rn(two_a, p));
  }
  return fabsf(__fsub_rn(lap, r));
}

// The block's max of non-negative floats as uint bits, valid in thread 0.
// As uint bits +inf orders below NaN, so a NaN residual propagates and stops
// the solve, as `res > tol` does. scratch: blockDim.x / 32 words.
__device__ unsigned int block_max(unsigned int v, unsigned int* scratch) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned int m = 0u;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = scratch[w] > m ? scratch[w] : m;
  }
  return m;
}

// ---------------------------------------------------------------------------
// kernel A, cluster route: the grid resident in one thread-block cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One thread's cells: the column pair (2m, 2m+1) in RT consecutive rows of
// the band, from band row l0. phi and rhs stay in registers for the whole
// solve (p0/p1, r0/r1: the even and the odd column); every update is also
// published to the band's shared-memory copy of phi, where the horizontal
// neighbours, the vertical neighbours beyond the segment and the halo rows
// are read. A shared-memory row of `stride` words holds the even columns at
// [0, hw) and the odd ones at [hw, 2 hw), hw = ceil(nx / 2), so the cells a
// warp reads lie at consecutive words. Everything that depends on the
// thread's place (clamps, which neighbours are in registers, which rows are
// band edges) is worked out once, as bit masks over the rows.
template <int RT>
struct Segment {
  float p0[RT], p1[RT], r0[RT], r1[RT];
  float* cell;          // the even cell of row 0 in shared memory
  int stride, hw;
  unsigned int live;    // bit 2r + parity: the cell exists and is updated
  unsigned int exists;  // bit 2r + parity: the cell exists
  unsigned int rows;    // bit r: row r exists
  unsigned int first, last;  // bit r: row r is the band's first / last row
  unsigned int n_reg;   // bit r: row r + 1 is in this segment
  unsigned int n_clamp;  // bit r: row r is the domain's last row
  bool s_clamp;          // row 0 is the domain's first row
  bool has_w, has_e;    // the even cell has a west neighbour; the odd cell an east one
  bool has_odd;         // the pair has an odd cell (2m + 1 < nx)
  uint32_t up, down;    // this thread's even cell in the neighbours' halo rows (0: none)
};

// The four neighbours of the cell in row r, column parity Q, from registers
// where the segment holds them, else from shared memory; clamped at the
// domain edge.
template <int RT, int Q>
__device__ __forceinline__ void neighbours(const Segment<RT>& s, int r, float p, float& e,
                                           float& w, float& n, float& so) {
  const float* cell = s.cell + r * s.stride;
  if (Q == 0) {
    w = s.has_w ? cell[s.hw - 1] : p;  // the odd cell of the pair to the west
    e = s.has_odd ? s.p1[r] : p;
  } else {
    w = s.p0[r];
    e = s.has_e ? cell[1] : p;  // the even cell of the pair to the east
  }
  // rows inside the segment come from registers; the segment's first and
  // last rows read shared memory (a halo row at the band's edge) unless the
  // domain's edge clamps them
  if (r + 1 < RT && ((s.n_reg >> r) & 1u)) {
    n = Q ? s.p1[r + 1 < RT ? r + 1 : r] : s.p0[r + 1 < RT ? r + 1 : r];
  } else {
    n = (s.n_clamp >> r) & 1u ? p : cell[s.stride + Q * s.hw];
  }
  if (r > 0) {
    so = Q ? s.p1[r > 0 ? r - 1 : 0] : s.p0[r > 0 ? r - 1 : 0];
  } else {
    so = s.s_clamp ? p : cell[Q * s.hw - s.stride];
  }
}

// Where a band's edge cells go: shared::cluster addresses of the band
// above's lower halo row and of the band below's upper one (0: no such
// band), and of each one's pair of halo mbarriers.
struct Halo {
  uint32_t up, down, up_bar, down_bar;
};

__device__ __forceinline__ uint32_t cluster_addr(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(local)), "r"(rank));
  return out;
}

// A store into another CTA's shared memory that counts its 4 bytes on that
// CTA's mbarrier: the receiver learns that the data landed from the
// mbarrier alone, with no cluster barrier and no fence.
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Wait until the neighbours' edge cells of half-sweep k have landed in this
// band's halo rows: `bytes` of them, counted on mbarrier k % 2. Thread 0
// arms the barrier's phase; the phases alternate, so a neighbour that is a
// half-sweep ahead counts on the other barrier.
__device__ __forceinline__ void halo_wait(uint64_t* bars, int k, uint32_t bytes) {
  const uint32_t bar = smem_addr(bars + (k & 1));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(static_cast<uint32_t>((k >> 1) & 1))
        : "memory");
  }
}

// One colour in the segment's `rows` off the band's edge rows (EDGE = false)
// or on them (EDGE = true); Q0 is the column parity of the colour in row 0,
// so every row's parity is known when this is compiled. The row tests are
// uniform over a warp (a warp holds one row segment); the update is computed
// by every lane and kept where the cell is live, so the rows' loads and
// arithmetic interleave without branches (a padding lane reads words inside
// the allocation and keeps nothing). Every existing cell of the colour in an
// edge row, updated or frozen, also goes into the neighbouring bands' halo
// rows, counted on their halo mbarrier `colour` (so each band expects a
// fixed byte count per half-sweep).
template <int RT, int Q0, bool EDGE>
__device__ __forceinline__ void sweep(Segment<RT>& s, const Relax& c, const Halo& h, int colour,
                                      unsigned int rows) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (!((rows >> r) & 1u) || ((((s.first | s.last) >> r) & 1u) != 0u) != EDGE) continue;
    const int q = (Q0 + r) & 1;
    float& p = q ? s.p1[r] : s.p0[r];
    float e, w, n, so;
    if (q == 0) {
      neighbours<RT, 0>(s, r, p, e, w, n, so);
    } else {
      neighbours<RT, 1>(s, r, p, e, w, n, so);
    }
    const float v = relax(p, e, w, n, so, q ? s.r1[r] : s.r0[r], c);
    const bool live = (s.live >> (2 * r + q)) & 1u;
    if (live) s.cell[r * s.stride + q * s.hw] = v;
    if (EDGE && ((s.exists >> (2 * r + q)) & 1u)) {
      const float out = live ? v : p;
      const uint32_t off = 4u * static_cast<uint32_t>(q * s.hw);
      if (s.up != 0u && ((s.first >> r) & 1u)) push(s.up + off, out, h.up_bar + 8u * colour);
      if (s.down != 0u && ((s.last >> r) & 1u)) push(s.down + off, out, h.down_bar + 8u * colour);
    }
    if (live) p = v;
  }
}

// Cells of `colour` in global row gi of an nx-wide grid.
__device__ __forceinline__ uint32_t colour_cells(int gi, int colour, int nx) {
  return ((colour + gi) & 1) == 0 ? (nx + 1) / 2 : nx / 2;
}

// The segment's max residual over the cells of `cells` (bit 2r + parity),
// as uint bits.
template <int RT>
__device__ __forceinline__ unsigned int segment_residual(const Segment<RT>& s, unsigned int cells,
                                                         bool dirichlet, float ax, float ay,
                                                         float two_a) {
  unsigned int rmax = 0u;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (!((s.rows >> r) & 1u)) continue;  // past the band: its words are not allocated
    float e, w, n, so;
    neighbours<RT, 0>(s, r, s.p0[r], e, w, n, so);
    const unsigned int v0 = __float_as_uint(residual(s.p0[r], e, w, n, so, s.r0[r], dirichlet,
                                                     ax, ay, two_a));
    if ((cells >> (2 * r)) & 1u) rmax = v0 > rmax ? v0 : rmax;
    neighbours<RT, 1>(s, r, s.p1[r], e, w, n, so);
    const unsigned int v1 = __float_as_uint(residual(s.p1[r], e, w, n, so, s.r1[r], dirichlet,
                                                     ax, ay, two_a));
    if ((cells >> (2 * r + 1)) & 1u) rmax = v1 > rmax ? v1 : rmax;
  }
  return rmax;
}

// Up to `chunks` chunks of `sweeps` sweeps, stopping after a chunk whose
// max residual is not above tol (the last chunk is not checked: the solve
// ends there anyway, so a solve without an early exit is one chunk). count (nullable) gets the chunks run added.
// Launched as one cluster (gridDim.x == cluster size) of blocks whose
// threads cover every (column pair, RT-row segment) of the largest band.
template <int RT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
rbsor_cluster_kernel(float* __restrict__ phi, const float* __restrict__ rhs,
                     const float* __restrict__ mask, int ny, int nx, int rows_max,
                     int sweeps, int chunks, Relax c, int dirichlet,
                     int* __restrict__ count, float tol, float two_a,
                     unsigned long long* __restrict__ launches) {
  extern __shared__ __align__(16) float band_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (rank == 0 && threadIdx.x == 0) count_launch(launches);
  const bool multi = nranks > 1;

  const int hw = (nx + 1) / 2;
  const int stride = 2 * hw;
  const int row0 = rank * ny / nranks;  // balanced bands of rows_max or rows_max - 1 rows
  const int rows = (rank + 1) * ny / nranks - row0;
  float* sp = band_smem;  // (rows_max + 2) rows: halo, own rows, halo
  // residual slots, [2][MAX_CLUSTER]: one set per chunk parity
  unsigned int* slots = reinterpret_cast<unsigned int*>(sp + (rows_max + 2) * stride);
  unsigned int* scratch = slots + 2 * MAX_CLUSTER;
  uint64_t* bars = reinterpret_cast<uint64_t*>(scratch + 32);  // halo mbarriers
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bars + k)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this thread's segment: column pair m, band rows l0 .. l0 + RT - 1
  const int tx = (hw + 31) / 32 * 32;  // a warp never spans two segments
  const int m = static_cast<int>(threadIdx.x) % tx;
  const int l0 = static_cast<int>(threadIdx.x) / tx * RT;
  Segment<RT> s;
  s.cell = sp + (l0 + 1) * stride + m;
  s.stride = stride;
  s.hw = hw;
  s.live = s.exists = s.rows = s.first = s.last = s.n_reg = s.n_clamp = 0u;
  s.has_w = m > 0;
  s.has_e = 2 * m + 2 < nx;
  s.has_odd = 2 * m + 1 < nx;
  s.s_clamp = row0 + l0 == 0;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    s.p0[r] = s.p1[r] = s.r0[r] = s.r1[r] = 0.0f;
    const int li = l0 + r;
    const int gi = row0 + li;
    if (li >= rows) continue;
    s.rows |= 1u << r;
    if (li == 0) s.first |= 1u << r;
    if (li == rows - 1) s.last |= 1u << r;
    if (li + 1 < rows) s.n_reg |= 1u << r;
    if (gi == ny - 1) s.n_clamp |= 1u << r;
    if (m >= hw) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 2 * m + q;
      if (j >= nx) continue;
      const size_t g = static_cast<size_t>(gi) * nx + j;
      const float v = phi[g];
      if (q) {
        s.p1[r] = v;
        s.r1[r] = rhs[g];
      } else {
        s.p0[r] = v;
        s.r0[r] = rhs[g];
      }
      s.cell[r * stride + q * hw] = v;
      s.exists |= 1u << (2 * r + q);
      const bool frame = gi == 0 || gi == ny - 1 || j == 0 || j == nx - 1;
      const bool frozen = (mask != nullptr && mask[g] >= 0.5f) || (dirichlet && frame);
      if (!frozen) s.live |= 1u << (2 * r + q);
    }
  }
  // the halo rows; cells outside the domain are never read (clamping
  // redirects edge reads)
  for (int j = threadIdx.x; j < nx; j += blockDim.x) {
    const int pos = (j & 1) * hw + (j >> 1);
    if (row0 > 0) sp[pos] = phi[static_cast<size_t>(row0 - 1) * nx + j];
    if (row0 + rows < ny) {
      sp[(rows + 1) * stride + pos] = phi[static_cast<size_t>(row0 + rows) * nx + j];
    }
  }

  Halo h = {0u, 0u, 0u, 0u};
  s.up = s.down = 0u;
  if (rank > 0) {
    const int up_row = rank * ny / nranks - (rank - 1) * ny / nranks + 1;
    h.up_bar = cluster_addr(bars, rank - 1);
    s.up = cluster_addr(sp + up_row * stride + m, rank - 1);
  }
  if (rank + 1 < nranks) {
    h.down_bar = cluster_addr(bars, rank + 1);
    s.down = cluster_addr(sp + m, rank + 1);
  }
  // halo bytes this band receives in a half-sweep of each colour
  uint32_t halo_bytes[2];
  for (int k = 0; k < 2; ++k) {
    halo_bytes[k] = 4u * ((rank > 0 ? colour_cells(row0 - 1, k, nx) : 0u) +
                          (rank + 1 < nranks ? colour_cells(row0 + rows, k, nx) : 0u));
  }
  // every band is staged and its mbarriers initialised before any
  // neighbour stores into it
  if (multi) {
    cluster_arrive();
    cluster_wait();
  }

  const int parity0 = (row0 + l0) & 1;  // row 0's column parity of colour 0
  int done = 0;
  int half = 0;  // half-sweeps run, over all chunks
  for (int chunk = 0; chunk < chunks; ++chunk) {
    for (int hs = 0; hs < 2 * sweeps; ++hs, ++half) {
      const int colour = hs & 1;
      const bool odd = (parity0 ^ colour) != 0;
      __syncthreads();  // this band's previous half-sweep is in shared memory
      if (odd) {
        sweep<RT, 1, false>(s, c, h, colour, s.rows);  // reads no halo
      } else {
        sweep<RT, 0, false>(s, c, h, colour, s.rows);
      }
      // the neighbours' previous edge cells (a chunk's first half-sweep
      // finds them waited for at the end of the chunk before)
      if (multi && hs > 0) halo_wait(bars, half - 1, halo_bytes[(half - 1) & 1]);
      if (odd) {
        sweep<RT, 1, true>(s, c, h, colour, s.rows);
      } else {
        sweep<RT, 0, true>(s, c, h, colour, s.rows);
      }
    }
    if (multi) halo_wait(bars, half - 1, halo_bytes[(half - 1) & 1]);
    __syncthreads();
    ++done;
    if (chunk + 1 == chunks) break;
    // the max residual over the cluster: each CTA stores its max into slot
    // `rank` of every CTA, then every CTA reduces the same slots. The halo
    // waits tie only neighbours, so a CTA may finish the next chunk before
    // a distant one has read this chunk's slots: the next chunk writes the
    // other set. No CTA gets two chunks ahead, since each chunk's cluster
    // barrier waits for every CTA, and every CTA reads before it arrives.
    unsigned int* set = slots + (chunk & 1) * MAX_CLUSTER;
    const unsigned int mx = block_max(
        segment_residual(s, s.live, dirichlet != 0, c.ax, c.ay, two_a), scratch);
    if (threadIdx.x == 0) {
      for (int k = 0; k < nranks; ++k) *cluster.map_shared_rank(set + rank, k) = mx;
    }
    if (multi) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    unsigned int res = 0u;
    for (int k = 0; k < nranks; ++k) res = set[k] > res ? set[k] : res;
    if (!(__uint_as_float(res) > tol)) break;
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const size_t g = static_cast<size_t>(row0 + l0 + r) * nx + 2 * m;
    if ((s.exists >> (2 * r)) & 1u) phi[g] = s.p0[r];
    if ((s.exists >> (2 * r + 1)) & 1u) phi[g + 1] = s.p1[r];
  }
  if (count != nullptr && rank == 0 && threadIdx.x == 0) *count += done;
}

// ---------------------------------------------------------------------------
// kernel A, tiled route: one CTA per tile across the card, K sweeps a pass
// ---------------------------------------------------------------------------

// The tiles of an ny x nx grid: tr x tc owned cells each (the last row and
// column of tiles may own fewer), staged in a window of sh x sw cells that
// reaches h = 2K cells past the owned ones on each side, clipped at the
// domain's first row and column (so the window starts on an even column).
struct TileGrid {
  int ny, nx, tr, tc, h, sh, sw, tiles_x;
};

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// Distance of a row (or column) from the owned span [lo, hi).
__device__ __forceinline__ int span_distance(int i, int lo, int hi) {
  return i < lo ? lo - i : (i >= hi ? i - hi + 1 : 0);
}

// The rows of the segment whose distance from the owned rows (4 bits a row
// in `dist`) is at most lim.
template <int RT>
__device__ __forceinline__ unsigned int rows_within(unsigned int rows, unsigned int dist, int lim) {
  unsigned int on = 0u;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (static_cast<int>((dist >> (4 * r)) & 15u) <= lim) on |= 1u << r;
  }
  return on & rows;
}

// The halo exchange after a pass: each thread stores its owned cells that
// lie within h of the tile's edge (`pub`) into this epoch's buffer `xb` (at
// their global places; the buffers alternate by epoch, so a neighbour one
// pass ahead writes the other one), thread 0 releases the tile's epoch
// flag at GPU scope once the whole CTA has stored (a barrier, then a
// release store, which orders the stores the barrier made visible to it),
// up to 8 threads acquire the neighbours' flags before a barrier, and each
// thread loads its halo cells (`get`) into its registers and the staged
// window. Both sides go through L2 (__stcg, __ldcg): no SM reads a stale
// L1 line of a buffer it read two passes before.
template <int RT>
__device__ __forceinline__ void exchange(Segment<RT>& s, unsigned int pub, unsigned int get,
                                         float* xb, int nx, unsigned int* flag, int watch,
                                         const unsigned int* flags, unsigned int epoch) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if ((pub >> (2 * r)) & 1u) __stcg(xb + r * nx, s.p0[r]);
    if ((pub >> (2 * r + 1)) & 1u) __stcg(xb + r * nx + 1, s.p1[r]);
  }
  __syncthreads();
  if (threadIdx.x == 0) store_release(flag, epoch);
  if (watch >= 0) {
    while (load_acquire(flags + watch * FLAG_STRIDE) < epoch) {
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if ((get >> (2 * r)) & 1u) {
      s.p0[r] = __ldcg(xb + r * nx);
      s.cell[r * s.stride] = s.p0[r];
    }
    if ((get >> (2 * r + 1)) & 1u) {
      s.p1[r] = __ldcg(xb + r * nx + 1);
      s.cell[r * s.stride + s.hw] = s.p1[r];
    }
  }
}

namespace tiled {

// Up to `chunks` chunks of `sweeps` sweeps, as rbsor_cluster_kernel, on a
// cooperative launch of one CTA per tile (all co-resident). A CTA sweeps
// its window in passes of k sweeps (a chunk's last pass takes what is
// left) with only a CTA barrier between half-sweeps; half-sweep t of a
// pass of k updates the rows within 2k - 1 - t of the owned ones (the rest
// cannot reach them before the pass ends). Stale cells creep in from the
// window's rim by one cell a half-sweep, so after the pass every owned cell
// is exact; then the tiles exchange their rims. After a chunk they exchange
// once more, so the residual reads current neighbours, reduce the max over
// their owned updatable cells (uint bits) into a slot by chunk % 3 with
// atomicMax, and take the same decision after a grid sync. `xbuf` holds
// two ny x nx buffers; `flags` one epoch word per tile (FLAG_STRIDE apart),
// then the 3 slots.
template <int RT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
rbsor_kernel(float* __restrict__ phi, const float* __restrict__ rhs,
             const float* __restrict__ mask, TileGrid g, int k, int sweeps, int chunks, Relax c,
             int dirichlet, int* __restrict__ count, float tol, float two_a,
             float* __restrict__ xbuf, unsigned int* __restrict__ flags,
             unsigned long long* __restrict__ launches) {
  extern __shared__ __align__(16) float window_smem[];
  cg::grid_group grid = cg::this_grid();
  const int tile = static_cast<int>(blockIdx.x);
  const int tiles = static_cast<int>(gridDim.x);
  unsigned int* slots = flags + tiles * FLAG_STRIDE;
  if (tile == 0 && threadIdx.x == 0) {
    count_launch(launches);
    slots[0] = slots[1] = slots[2] = 0u;
  }
  unsigned int* flag = flags + tile * FLAG_STRIDE;
  if (threadIdx.x == 0) *flag = 0u;

  const int ty = tile / g.tiles_x;
  const int tx = tile - ty * g.tiles_x;
  const int oi0 = ty * g.tr, oj0 = tx * g.tc;  // the owned cells: [oi0, oi1) x [oj0, oj1)
  const int oi1 = min(oi0 + g.tr, g.ny), oj1 = min(oj0 + g.tc, g.nx);
  const int gi0 = max(oi0 - g.h, 0), gj0 = max(oj0 - g.h, 0);  // the window's origin
  const int hw = g.sw / 2;
  const int stride = g.sw;
  float* sp = window_smem;  // (sh + 2) rows: one spare row per side, never written
  unsigned int* scratch = reinterpret_cast<unsigned int*>(sp + (g.sh + 2) * stride);

  // this thread's segment: window column pair m, window rows l0 .. l0 + RT - 1
  const int txw = (hw + 31) / 32 * 32;
  const int m = static_cast<int>(threadIdx.x) % txw;
  const int l0 = static_cast<int>(threadIdx.x) / txw * RT;
  const int gj = gj0 + 2 * m;  // the pair's even column
  Segment<RT> s;
  s.cell = sp + (l0 + 1) * stride + m;
  s.stride = stride;
  s.hw = hw;
  s.live = s.exists = s.rows = s.first = s.last = s.n_reg = s.n_clamp = 0u;
  s.has_w = gj > 0;
  s.has_e = gj + 2 < g.nx;
  s.has_odd = gj + 1 < g.nx;
  s.s_clamp = gi0 + l0 == 0;
  s.up = s.down = 0u;
  unsigned int own = 0u, pub = 0u, get = 0u, dist = 0u;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    s.p0[r] = s.p1[r] = s.r0[r] = s.r1[r] = 0.0f;
    const int li = l0 + r;
    const int gi = gi0 + li;
    if (li >= g.sh || gi >= g.ny) continue;
    s.rows |= 1u << r;
    if (li + 1 < g.sh && gi + 1 < g.ny) s.n_reg |= 1u << r;
    if (gi == g.ny - 1) s.n_clamp |= 1u << r;
    const int di = span_distance(gi, oi0, oi1);
    dist |= static_cast<unsigned int>(min(di, 15)) << (4 * r);
    if (m >= hw) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int lj = 2 * m + q;
      const int j = gj0 + lj;
      if (j >= g.nx) continue;
      const unsigned int bit = 1u << (2 * r + q);
      const size_t gidx = static_cast<size_t>(gi) * g.nx + j;
      const float v = phi[gidx];
      if (q) {
        s.p1[r] = v;
        s.r1[r] = rhs[gidx];
      } else {
        s.p0[r] = v;
        s.r0[r] = rhs[gidx];
      }
      s.cell[r * stride + q * hw] = v;
      s.exists |= bit;
      const int dj = span_distance(j, oj0, oj1);
      const bool frame = gi == 0 || gi == g.ny - 1 || j == 0 || j == g.nx - 1;
      const bool frozen = (mask != nullptr && mask[gidx] >= 0.5f) || (dirichlet && frame);
      // a cell on the window's rim lacks a neighbour unless the domain's edge clamps it
      const bool whole = (li > 0 || gi == 0) && (li < g.sh - 1 || gi == g.ny - 1) &&
                         (lj > 0 || j == 0) && (lj < g.sw - 1 || j == g.nx - 1);
      if (!frozen && whole) s.live |= bit;
      if (di == 0 && dj == 0) {
        own |= bit;
        if (gi - oi0 < g.h || oi1 - 1 - gi < g.h || j - oj0 < g.h || oj1 - 1 - j < g.h) pub |= bit;
      } else if (di <= g.h && dj <= g.h) {
        get |= bit;
      }
    }
  }
  // thread n < 8 watches the n-th of the 8 tiles around this one, if it exists
  int watch = -1;
  if (threadIdx.x < 8) {
    const int n = static_cast<int>(threadIdx.x) + (threadIdx.x >= 4 ? 1 : 0);  // skip the centre
    const int ny_ = ty + n / 3 - 1, nx_ = tx + n % 3 - 1;
    if (ny_ >= 0 && ny_ < tiles / g.tiles_x && nx_ >= 0 && nx_ < g.tiles_x) {
      watch = ny_ * g.tiles_x + nx_;
    }
  }
  const size_t cells = static_cast<size_t>(g.ny) * g.nx;
  const size_t base = static_cast<size_t>(gi0 + l0) * g.nx + gj;  // the segment's (0, even) cell
  // every flag and slot is reset, and every window staged from phi, before
  // any tile waits on a flag or writes phi
  grid.sync();

  const int parity0 = (gi0 + l0 + gj0) & 1;  // row 0's column parity of colour 0
  const Halo none = {0u, 0u, 0u, 0u};  // sweep() off a band's edge pushes nothing
  unsigned int epoch = 0u;
  bool fresh = true;  // the window holds current cells (phi itself at the start)
  int done = 0;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    for (int swept = 0; swept < sweeps;) {
      const int kp = min(k, sweeps - swept);
      if (!fresh) {
        ++epoch;
        exchange(s, pub, get, xbuf + (epoch & 1u) * cells + base, g.nx, flag, watch, flags,
                 epoch);
      }
      fresh = false;
      for (int hs = 0; hs < 2 * kp; ++hs) {
        const unsigned int on = rows_within<RT>(s.rows, dist, 2 * kp - 1 - hs);
        __syncthreads();  // the window's previous half-sweep is in shared memory
        if ((parity0 ^ (hs & 1)) != 0) {
          sweep<RT, 1, false>(s, c, none, 0, on);
        } else {
          sweep<RT, 0, false>(s, c, none, 0, on);
        }
      }
      swept += kp;
    }
    ++done;
    if (chunk + 1 == chunks) break;
    ++epoch;
    exchange(s, pub, get, xbuf + (epoch & 1u) * cells + base, g.nx, flag, watch, flags, epoch);
    fresh = true;
    __syncthreads();
    const unsigned int mx = block_max(
        segment_residual(s, own & s.live, dirichlet != 0, c.ax, c.ay, two_a), scratch);
    if (threadIdx.x == 0) atomicMax(slots + chunk % 3, mx);
    grid.sync();
    const unsigned int res = __ldcg(slots + chunk % 3);
    // the slot of chunk + 2 was last read before this chunk's grid sync,
    // and is next written after the one of chunk + 1
    if (tile == 0 && threadIdx.x == 0) slots[(chunk + 2) % 3] = 0u;
    if (!(__uint_as_float(res) > tol)) break;
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if ((own >> (2 * r)) & 1u) phi[base + r * g.nx] = s.p0[r];
    if ((own >> (2 * r + 1)) & 1u) phi[base + r * g.nx + 1] = s.p1[r];
  }
  if (count != nullptr && tile == 0 && threadIdx.x == 0) *count += done;
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// kernel A, cooperative route: grids above the cluster's capacity
// ---------------------------------------------------------------------------

// ctl (nullable): ctl[0] = active flag, ctl[1] = residual max as uint bits.
// count (nullable): incremented once by every chunk that runs.
__global__ void __launch_bounds__(THREADS)
rbsor_kernel(float* __restrict__ phi, const float* __restrict__ rhs,
             const float* __restrict__ mask, int ny, int nx, int iters,
             Relax c, int dirichlet, int* __restrict__ ctl,
             int* __restrict__ count, float tol, float two_a,
             unsigned long long* __restrict__ launches) {
  cg::grid_group grid = cg::this_grid();
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  if (first) count_launch(launches);  // an inactive chunk is a launch too
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

  unsigned int rmax = 0u;
  const int cells = ny * nx;
  for (int k = t0; k < cells; k += stride) {
    const int i = k / nx;
    const int j = k - i * nx;
    const size_t g = static_cast<size_t>(k);
    if (mask != nullptr && __ldg(mask + g) >= 0.5f) continue;
    if (dirichlet && (i == 0 || j == 0 || i == ny - 1 || j == nx - 1)) continue;
    const float p = __ldcg(phi + g);
    const float e = j + 1 < nx ? __ldcg(phi + g + 1) : p;
    const float w = j > 0 ? __ldcg(phi + g - 1) : p;
    const float n = i + 1 < ny ? __ldcg(phi + g + nx) : p;
    const float s = i > 0 ? __ldcg(phi + g - nx) : p;
    const unsigned int r = __float_as_uint(
        residual(p, e, w, n, s, __ldg(rhs + g), dirichlet != 0, c.ax, c.ay, two_a));
    rmax = r > rmax ? r : rmax;
  }
  __shared__ unsigned int warp_max[THREADS / 32];
  const unsigned int m = block_max(rmax, warp_max);
  if (threadIdx.x == 0) atomicMax(reinterpret_cast<unsigned int*>(ctl + 1), m);
  grid.sync();
  if (first) {
    const float res = __uint_as_float(static_cast<unsigned int>(__ldcg(ctl + 1)));
    ctl[0] = res > tol ? 1 : 0;
    if (count != nullptr) *count += 1;
  }
}

// ---------------------------------------------------------------------------
// kernel B: K sweeps per pass on wide tiles, one block per tile
// ---------------------------------------------------------------------------

enum LoadRoute { LOAD_TMA = 0, LOAD_CP = 1 };

struct Tiles {
  int ny, nx, sweeps, h;  // h = 2 * sweeps: the halo rows per side
  int hc;                 // halo columns per side: h rounded up to 4, so that
                          // a TMA box starts on a 16-byte boundary
  int tr, tc;             // centre rows and columns
  int sh, sw;             // staged rows and columns: tr + 2h, tc + 2hc
  int arr;                // words per staged array, rounded up to 128 bytes
  int tiles_x;
  int parity0;            // colour parity of cell (0, 0): 0 or 1
};

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Stage the tile whose staged corner is (gi0, gj0) into sp (phi) and sr
// (rhs), cells outside the grid as zero; returns when every thread may
// read it.
template <int ROUTE>
__device__ void load_tile(const CUtensorMap* phi_map, const CUtensorMap* rhs_map,
                          const float* phi_in, const float* rhs, float* sp, float* sr,
                          uint64_t* bar, const Tiles& g, int gi0, int gj0) {
  if constexpr (ROUTE == LOAD_TMA) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // no thread waits on the barrier before it exists
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(bar)), "r"(2 * g.sh * g.sw * 4) : "memory");
      const CUtensorMap* maps[2] = {phi_map, rhs_map};
      float* dst[2] = {sp, sr};
      for (int a = 0; a < 2; ++a) {
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];\n"
            :: "r"(smem_addr(dst[a])), "l"(reinterpret_cast<uint64_t>(maps[a])),
               "r"(gj0), "r"(gi0), "r"(smem_addr(bar))
            : "memory");
      }
    }
    mbar_wait(bar, 0u);
  } else {
    const int rstep = static_cast<int>(blockDim.x) / g.sw;  // sw <= 256 < blockDim.x
    const int t = static_cast<int>(threadIdx.x);
    if (t < rstep * g.sw) {
      const int lj = t % g.sw;
      const int gj = gj0 + lj;
      for (int li = t / g.sw; li < g.sh; li += rstep) {
        const int gi = gi0 + li;
        const bool in = gi >= 0 && gi < g.ny && gj >= 0 && gj < g.nx;
        const size_t off = in ? static_cast<size_t>(gi) * g.nx + gj : 0;
        const int bytes = in ? 4 : 0;  // 0: fill with zero, read nothing
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(smem_addr(sp + li * g.sw + lj)), "l"(phi_in + off), "r"(bytes)
                     : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(smem_addr(sr + li * g.sw + lj)), "l"(rhs + off), "r"(bytes)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
}

template <int ROUTE>
__global__ void __launch_bounds__(B_THREADS)
rbsor_blocked_kernel(const __grid_constant__ CUtensorMap phi_map,
                     const __grid_constant__ CUtensorMap rhs_map,
                     const float* __restrict__ phi_in, const float* __restrict__ rhs,
                     float* __restrict__ phi_out, Tiles g, Relax c,
                     unsigned long long* __restrict__ launches) {
  extern __shared__ __align__(128) float tile_smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) count_launch(launches);
  float* sp = tile_smem;
  const float* sr = sp + g.arr;
  const int tile = static_cast<int>(blockIdx.x);
  const int ty = tile / g.tiles_x;
  const int gi0 = ty * g.tr - g.h;
  const int gj0 = (tile - ty * g.tiles_x) * g.tc - g.hc;
  load_tile<ROUTE>(&phi_map, &rhs_map, phi_in, rhs, sp, sp + g.arr,
                   reinterpret_cast<uint64_t*>(sp + 2 * g.arr), g, gi0, gj0);

  const int t = static_cast<int>(threadIdx.x);
  const int pw = g.sw / 2;  // column pairs of a staged row
  const int prow = static_cast<int>(blockDim.x) / pw;
  const bool sweeper = t < prow * pw;
  for (int it = 0; it < g.sweeps; ++it) {
    for (int colour = 0; colour < 2; ++colour) {
      if (sweeper) {
        // ROWS rows at a time, all loads and arithmetic before the stores,
        // so that the rows' dependent chains overlap (a store to shared
        // memory would keep the next row's loads behind it)
        constexpr int ROWS = 4;
        const int lj_base = 2 * (t % pw);
        for (int li0 = t / pw; li0 < g.sh; li0 += ROWS * prow) {
          float v[ROWS];
          int at[ROWS];
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            at[u] = -1;
            v[u] = 0.0f;
            const int li = li0 + u * prow;
            const int gi = gi0 + li;
            if (li >= g.sh || gi < 0 || gi >= g.ny) continue;
            // (gi + gj + parity0) % 2 == colour with gj = gj0 + lj; & 1 is
            // the parity of a negative int as well (two's complement)
            const int lj = lj_base + ((gi + gj0 + g.parity0 + colour) & 1);
            const int gj = gj0 + lj;
            if (gj < 0 || gj >= g.nx) continue;
            // a rim cell lacks a neighbour unless the domain edge clamps it
            const bool whole = (li > 0 || gi == 0) && (li < g.sh - 1 || gi == g.ny - 1) &&
                               (lj > 0 || gj == 0) && (lj < g.sw - 1 || gj == g.nx - 1);
            if (!whole) continue;
            const int l = li * g.sw + lj;
            const float p = sp[l];
            const float e = gj == g.nx - 1 ? p : sp[l + 1];
            const float w = gj == 0 ? p : sp[l - 1];
            const float n = gi == g.ny - 1 ? p : sp[l + g.sw];
            const float so = gi == 0 ? p : sp[l - g.sw];
            v[u] = relax(p, e, w, n, so, sr[l], c);
            at[u] = l;
          }
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            if (at[u] >= 0) sp[at[u]] = v[u];
          }
        }
      }
      __syncthreads();
    }
  }

  // the centre to phi_out: 16-byte stores where the pitch allows them
  const int ci0 = gi0 + g.h;
  const int cj0 = gj0 + g.hc;
  if constexpr (ROUTE == LOAD_TMA) {
    const int cols = g.tc / 4;
    for (int idx = t; idx < g.tr * cols; idx += blockDim.x) {
      const int ci = idx / cols;
      const int cj = (idx - ci * cols) * 4;
      if (ci0 + ci >= g.ny || cj0 + cj >= g.nx) continue;  // nx % 4 == 0: all 4 or none
      const float* src = sp + (g.h + ci) * g.sw + g.hc + cj;
      *reinterpret_cast<float4*>(phi_out + static_cast<size_t>(ci0 + ci) * g.nx + cj0 + cj) =
          make_float4(src[0], src[1], src[2], src[3]);
    }
  } else {
    for (int idx = t; idx < g.tr * g.tc; idx += blockDim.x) {
      const int ci = idx / g.tc;
      const int cj = idx - ci * g.tc;
      if (ci0 + ci >= g.ny || cj0 + cj >= g.nx) continue;
      phi_out[static_cast<size_t>(ci0 + ci) * g.nx + cj0 + cj] = sp[(g.h + ci) * g.sw + g.hc + cj];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

using ClusterKernel = void (*)(float*, const float*, const float*, int, int, int, int, int,
                              Relax, int, int*, float, float, unsigned long long*);

// the instantiation for `rows_per_thread` rows per thread (1, 2, 4 or 8)
ClusterKernel cluster_kernel(int rows_per_thread) {
  switch (rows_per_thread) {
    case 1: return rbsor_cluster_kernel<1>;
    case 2: return rbsor_cluster_kernel<2>;
    case 4: return rbsor_cluster_kernel<4>;
    case 8: return rbsor_cluster_kernel<8>;
    default: return nullptr;
  }
}

cudaError_t prepare_cluster_kernel(ClusterKernel kernel, int smem_bytes, int cluster) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

cudaLaunchConfig_t cluster_config(int cluster, int threads, int smem_bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool tile_map(CUtensorMap* map, const float* base, const Tiles& g) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.nx), static_cast<cuuint64_t>(g.ny)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.nx) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(g.sw), static_cast<cuuint32_t>(g.sh)};
  const cuuint32_t elem[2] = {1, 1};
  // FLOAT_OOB_FILL_NONE fills the cells outside the grid with zero
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int ROUTE>
cudaError_t launch_blocked(const float* phi_in, const float* rhs, float* phi_out, const Tiles& g,
                           const Relax& c, int tiles, size_t smem, cudaStream_t stream,
                           unsigned long long* launches) {
  const auto kernel = rbsor_blocked_kernel<ROUTE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  CUtensorMap maps[2] = {};
  if (ROUTE == LOAD_TMA && !(tile_map(&maps[0], phi_in, g) && tile_map(&maps[1], rhs, g))) {
    return cudaErrorInvalidValue;
  }
  kernel<<<tiles, B_THREADS, smem, stream>>>(maps[0], maps[1], phi_in, rhs, phi_out, g, c,
                                             launches);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest cluster of rbsor_cluster_kernel that the current device can
// schedule with CLUSTER_THREADS threads of 8 rows each and smem_bytes of
// shared memory per CTA, written to *out. Returns a cudaError_t code.
int cfd_rbsor_max_cluster(int smem_bytes, int* out) {
  *out = 0;
  const ClusterKernel kernel = cluster_kernel(8);
  for (int c = MAX_CLUSTER; c >= 1; --c) {
    cudaError_t err = prepare_cluster_kernel(kernel, smem_bytes, c);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(c, CLUSTER_THREADS, smem_bytes, nullptr, &attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();  // an unschedulable size may report an error: try the next
      continue;
    }
    if (n > 0) {
      *out = c;
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

// Kernel A, cluster route: the whole solve in one launch of one cluster of
// `cluster` CTAs of `threads` threads of rows_per_thread rows, each CTA
// holding rows_max rows or one fewer, with smem_bytes of shared memory (the
// plan of poisson_rb.py).
// phi (updated in place), rhs: device fp32 (ny, nx), contiguous; mask: fp32
// (ny, nx) or null; count: int32 or null; launches: the wrapper's launch
// count on the device, one uint64 (every launcher here takes it last). A
// refused launch returns its error; nothing else is tried.
int cfd_rbsor_cluster(void* phi, const void* rhs, const void* mask, int ny, int nx,
                      int cluster, int rows_max, int threads, int rows_per_thread,
                      int smem_bytes, int sweeps, int chunks, float ax, float ay,
                      float denom_inv, float omega, float one_minus_omega, int dirichlet,
                      void* count, float tol, float two_a, void* stream, void* launches) {
  const ClusterKernel kernel = cluster_kernel(rows_per_thread);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare_cluster_kernel(kernel, smem_bytes, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<float*>(phi),
                           static_cast<const float*>(rhs), static_cast<const float*>(mask), ny, nx,
                           rows_max, sweeps, chunks, Relax{ax, ay, denom_inv, omega, one_minus_omega},
                           dirichlet, static_cast<int*>(count), tol, two_a,
                           static_cast<unsigned long long*>(launches));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A, tiled route: the whole solve in one cooperative launch of one
// CTA per tile of tile_rows x tile_cols owned cells (tile_cols even, both
// at least 2 * sweeps_per_pass, the staged width tile_cols + 4 *
// sweeps_per_pass a multiple of 64), each thread a column pair over
// rows_per_thread (1, 2 or 4) window rows; sweeps and chunks as
// cfd_rbsor_cluster. xbuf: 2 * ny * nx floats of scratch; flags:
// flag_words >= 32 * tiles + 3 words of scratch (the kernel resets them).
int cfd_rbsor_tiled(void* phi, const void* rhs, const void* mask, int ny, int nx, int tile_rows,
                    int tile_cols, int rows_per_thread, int sweeps_per_pass, int sweeps,
                    int chunks, float ax, float ay, float denom_inv, float omega,
                    float one_minus_omega, int dirichlet, void* count, float tol, float two_a,
                    void* xbuf, void* flags, int flag_words, void* stream, void* launches) {
  TileGrid g;
  g.ny = ny;
  g.nx = nx;
  g.tr = tile_rows;
  g.tc = tile_cols;
  g.h = 2 * sweeps_per_pass;
  g.sh = tile_rows + 2 * g.h;
  g.sw = tile_cols + 2 * g.h;
  g.tiles_x = (nx + tile_cols - 1) / tile_cols;
  const int tiles = g.tiles_x * ((ny + tile_rows - 1) / tile_rows);
  const int rt = rows_per_thread;
  const int threads = g.sw / 2 * ((g.sh + rt - 1) / rt);
  if (sweeps_per_pass < 1 || tile_rows < g.h || tile_cols < g.h || tile_cols % 2 != 0 ||
      g.sw % 64 != 0 || threads > CLUSTER_THREADS || tiles * FLAG_STRIDE + 3 > flag_words ||
      (rt != 1 && rt != 2 && rt != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (static_cast<size_t>(g.sh + 2) * g.sw + 32) * sizeof(float);
  float* phi_p = static_cast<float*>(phi);
  const float* rhs_p = static_cast<const float*>(rhs);
  const float* mask_p = static_cast<const float*>(mask);
  Relax c{ax, ay, denom_inv, omega, one_minus_omega};
  int* count_p = static_cast<int*>(count);
  float* xbuf_p = static_cast<float*>(xbuf);
  unsigned int* flags_p = static_cast<unsigned int*>(flags);
  auto* launches_p = static_cast<unsigned long long*>(launches);
  void* args[] = {&phi_p, &rhs_p, &mask_p, &g, &sweeps_per_pass, &sweeps, &chunks, &c,
                  &dirichlet, &count_p, &tol, &two_a, &xbuf_p, &flags_p, &launches_p};
  void* kernel = rt == 1   ? reinterpret_cast<void*>(tiled::rbsor_kernel<1>)
                 : rt == 2 ? reinterpret_cast<void*>(tiled::rbsor_kernel<2>)
                           : reinterpret_cast<void*>(tiled::rbsor_kernel<4>);
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(tiles), dim3(threads), args,
                                                      smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A, cooperative route. phi (updated in place), rhs: device fp32
// (ny, nx), contiguous; mask: fp32 (ny, nx) or null; ctl: int32[2] or null
// (early-exit chunk); count: int32 or null. Launches on `stream`, returns a
// cudaError_t code.
int cfd_rbsor(void* phi, const void* rhs, const void* mask, int ny, int nx,
              int iters, float ax, float ay, float denom_inv, float omega,
              float one_minus_omega, int dirichlet, void* ctl, void* count,
              float tol, float two_a, void* stream, void* launches) {
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
  auto* launches_p = static_cast<unsigned long long*>(launches);
  void* args[] = {&phi_p, &rhs_p, &mask_p, &ny, &nx, &iters, &c,
                  &dirichlet, &ctl_p, &count_p, &tol, &two_a, &launches_p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rbsor_kernel), dim3(blocks), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B, one pass of `sweeps` sweeps from phi_in to phi_out (distinct
// buffers, 16-byte aligned) on tiles of tile_rows x tile_cols with a
// 2*sweeps halo, one block per tile (the plan of poisson_rb.py). route:
// 0 = TMA (nx % 4 == 0), 1 = cp.async of 4 bytes. parity0: the colour
// parity of cell (0, 0) (red cells have (i + j + parity0) even).
int cfd_rbsor_blocked(const void* phi_in, const void* rhs, void* phi_out, int ny, int nx,
                      int sweeps, int tile_rows, int tile_cols, int route, float ax, float ay,
                      float denom_inv, float omega, float one_minus_omega, int parity0,
                      void* stream, void* launches) {
  Tiles g;
  g.ny = ny;
  g.nx = nx;
  g.sweeps = sweeps;
  g.h = 2 * sweeps;
  g.hc = (g.h + 3) / 4 * 4;
  g.tr = tile_rows;
  g.tc = tile_cols;
  g.sh = tile_rows + 2 * g.h;
  g.sw = tile_cols + 2 * g.hc;
  g.arr = (g.sh * g.sw + 31) / 32 * 32;
  g.tiles_x = (nx + tile_cols - 1) / tile_cols;
  g.parity0 = parity0 & 1;
  const int tiles = g.tiles_x * ((ny + tile_rows - 1) / tile_rows);
  if (g.sw > 256 || g.sh > 256 || g.sw % 4 != 0 || (route == LOAD_TMA && nx % 4 != 0) ||
      (parity0 != 0 && parity0 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // phi and rhs, then the TMA route's mbarrier
  const size_t smem = 2 * static_cast<size_t>(g.arr) * sizeof(float) + sizeof(uint64_t);
  const Relax c{ax, ay, denom_inv, omega, one_minus_omega};
  const float* in = static_cast<const float*>(phi_in);
  const float* r = static_cast<const float*>(rhs);
  float* out = static_cast<float*>(phi_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* n = static_cast<unsigned long long*>(launches);
  const cudaError_t err = route == LOAD_TMA
                              ? launch_blocked<LOAD_TMA>(in, r, out, g, c, tiles, smem, s, n)
                              : launch_blocked<LOAD_CP>(in, r, out, g, c, tiles, smem, s, n);
  return static_cast<int>(err);
}

const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
