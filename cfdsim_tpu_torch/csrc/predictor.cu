// Fused central predictor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cfdsim_tpu/ops/pallas/predictor.py
// (fused_predictor_central, kernel body _kernel). It computes, on the
// interior only,
//
//     u* = u + dt * (nu * lap(u) - (u, v) . grad(u))
//     v* = v + dt * (nu * lap(v) - (u, v) . grad(v))
//
// with second-order central differences, and copies the one-point boundary
// frame through unchanged (the wrapper allocates u*, v* with torch.empty, so
// every element is written here).
//
// What bounds it: about 40 flops per cell against 16 bytes of device memory
// traffic (read u, v; write u*, v*), far below the card's ridge point, so it
// is bandwidth-bound, and at 1024² (16.8 MB, ~5 µs at the card's memory
// rate) as much by how fast a launch fills the card with loads in flight.
//
// Design: no shared memory, a register window. A warp owns a strip of
// 32·VEC columns and ROWS rows. Each lane holds VEC consecutive
// columns of a row as one aligned vector (16 bytes for VEC = 4, read with
// ld.global.nc), so every 128-byte line of a row is fetched whole and once
// per strip; rows are read again only at a strip's two ends. The warp
// marches down its strip U rows at a time: it starts the loads of U new
// rows of u and of v (2U vectors per lane, plus the strip's two outer
// columns, one scalar each in lanes 0 and 31) before the first use, then
// updates U rows from the window of U + 2 rows it holds in registers. East
// and west neighbours are the lane's own components or the neighbouring
// lane's edge component (__shfl_up_sync / __shfl_down_sync); north and
// south are the window's rows. Stores are whole vectors; the frame is a
// select inside the vector, so it stays bit-equal to the input.
//
// VEC (4, 2 or 1) is the wrapper's choice
// (ops/kernels/predictor.py::plan_predictor): VEC must divide nx and the
// four field pointers must be aligned to 4·VEC bytes, so a lane's vector is
// aligned and lies wholly inside or wholly outside a row. The strip height,
// the rows per turn and the block size are constants: short strips put the
// most warps, and so the most loads, in flight (PERF.md).
//
// dt is read from a device pointer (the 0-dim tensor the adaptive-dt
// reduction produced), so the launch needs no host synchronisation and
// captures into a CUDA graph.
//
// The arithmetic follows the order of the Pallas kernel:
//     lap  = (e - 2q + w) * (1/dx^2) + (n - 2q + s) * (1/dy^2)
//     conv = u * (e - w) * (0.5/dx) + v * (n - s) * (0.5/dy)
//     out  = q + dt * (nu * lap - conv)
// nvcc may contract pairs of these into fused multiply-adds, which changes
// the last bit of an intermediate but not the result beyond 1e-6 absolute.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 4;       // rows of a warp's strip
constexpr int U = 4;          // rows a warp loads ahead and updates per turn
constexpr int THREADS = 128;  // per block: 4 warps, 4 neighbouring strips

struct Coeffs {
  float nu, inv_dx2, inv_dy2, half_inv_dx, half_inv_dy;
};

__device__ __forceinline__ float predict(float q, float e, float w, float n,
                                         float s, float uc, float vc, float dt,
                                         const Coeffs& k) {
  const float lap =
      (e - 2.0f * q + w) * k.inv_dx2 + (n - 2.0f * q + s) * k.inv_dy2;
  const float conv =
      uc * (e - w) * k.half_inv_dx + vc * (n - s) * k.half_inv_dy;
  return q + dt * (k.nu * lap - conv);
}

// One row's share of a lane: VEC consecutive columns, and in lanes 0 and 31
// the strip's outer column (west of lane 0, east of lane 31).
template <int VEC>
struct Row {
  float a[VEC];
  float edge;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&a)[VEC]);
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float (&a)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float (&a)[2]) {
  const float2 x = __ldg(reinterpret_cast<const float2*>(p));
  a[0] = x.x; a[1] = x.y;
}
template <>
__device__ __forceinline__ void load_vec<1>(const float* p, float (&a)[1]) {
  a[0] = __ldg(p);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&a)[VEC]);
template <>
__device__ __forceinline__ void store_vec<4>(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
template <>
__device__ __forceinline__ void store_vec<2>(float* p, const float (&a)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}
template <>
__device__ __forceinline__ void store_vec<1>(float* p, const float (&a)[1]) {
  *p = a[0];
}

// Row i of field f (i clamped into the array: a clamped row is only ever
// the unused neighbour of a frame row). `j` is the lane's first column
// (inside the row or not: `inside`), `je` its outer column or -1.
template <int VEC>
__device__ __forceinline__ Row<VEC> load_row(const float* __restrict__ f, int i,
                                             int ny, int nx, int j, bool inside,
                                             int je) {
  Row<VEC> r;
  const float* row = f + static_cast<size_t>(min(max(i, 0), ny - 1)) * nx;
  if (inside) {
    load_vec<VEC>(row + j, r.a);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) r.a[c] = 0.0f;
  }
  r.edge = je >= 0 ? __ldg(row + je) : 0.0f;
  return r;
}

// The update of one field's row from the window: q is the field (south,
// centre, north rows), uc/vc the advecting velocity's centre row.
template <int VEC>
__device__ __forceinline__ void update_row(const Row<VEC>& s, const Row<VEC>& q,
                                           const Row<VEC>& n, const Row<VEC>& uc,
                                           const Row<VEC>& vc, int lane, int j,
                                           int nx, bool frame_row, float dt,
                                           const Coeffs& k, float (&out)[VEC]) {
  // the neighbouring lanes' edge components; the strip's outer columns in
  // lanes 0 and 31 (unused where that column is the frame or past it)
  float west = __shfl_up_sync(FULL, q.a[VEC - 1], 1);
  float east = __shfl_down_sync(FULL, q.a[0], 1);
  if (lane == 0) west = q.edge;
  if (lane == 31) east = q.edge;
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    const float w = c == 0 ? west : q.a[c - 1];
    const float e = c == VEC - 1 ? east : q.a[c + 1];
    const int col = j + c;
    const bool pass = frame_row || col == 0 || col == nx - 1;
    const float star =
        predict(q.a[c], e, w, n.a[c], s.a[c], uc.a[c], vc.a[c], dt, k);
    out[c] = pass ? q.a[c] : star;
  }
}

// `launches` is the wrapper's launch count on the device: one thread adds
// one per launch, so the launches that a CUDA graph replays are counted too.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
fused_predictor_central_kernel(const float* __restrict__ u,
                               const float* __restrict__ v,
                               const float* __restrict__ dt_ptr,
                               float* __restrict__ us, float* __restrict__ vs,
                               int ny, int nx, int col_strips, int n_strips,
                               Coeffs k, unsigned long long* __restrict__ launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ULL);
  const int strip = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (strip >= n_strips) return;  // a whole warp at a time
  const int lane = threadIdx.x & 31;
  const int j0 = (strip % col_strips) * (32 * VEC);
  const int i0 = (strip / col_strips) * ROWS;
  const int i1 = min(i0 + ROWS, ny);
  const int j = j0 + lane * VEC;
  const bool inside = j < nx;  // VEC divides nx: the whole vector is in or out
  int je = -1;
  if (lane == 0 && j0 > 0) je = j0 - 1;
  if (lane == 31 && j0 + 32 * VEC < nx) je = j0 + 32 * VEC;
  const float dt = __ldg(dt_ptr);

  // the window: rows i - 1 … i + U of u and of v
  Row<VEC> wu[U + 2], wv[U + 2];
  wu[0] = load_row<VEC>(u, i0 - 1, ny, nx, j, inside, je);
  wv[0] = load_row<VEC>(v, i0 - 1, ny, nx, j, inside, je);
  wu[1] = load_row<VEC>(u, i0, ny, nx, j, inside, je);
  wv[1] = load_row<VEC>(v, i0, ny, nx, j, inside, je);
  for (int i = i0; i < i1; i += U) {
#pragma unroll
    for (int r = 0; r < U; ++r) {  // all loads of the turn before any use
      wu[r + 2] = load_row<VEC>(u, i + r + 1, ny, nx, j, inside, je);
      wv[r + 2] = load_row<VEC>(v, i + r + 1, ny, nx, j, inside, je);
    }
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int row = i + r;
      if (row < i1) {  // uniform over the warp, so the shuffles are whole
        const bool frame_row = row == 0 || row == ny - 1;
        float ou[VEC], ov[VEC];
        update_row<VEC>(wu[r], wu[r + 1], wu[r + 2], wu[r + 1], wv[r + 1], lane,
                        j, nx, frame_row, dt, k, ou);
        update_row<VEC>(wv[r], wv[r + 1], wv[r + 2], wu[r + 1], wv[r + 1], lane,
                        j, nx, frame_row, dt, k, ov);
        if (inside) {
          const size_t g = static_cast<size_t>(row) * nx + j;
          store_vec<VEC>(us + g, ou);
          store_vec<VEC>(vs + g, ov);
        }
      }
    }
    wu[0] = wu[U]; wv[0] = wv[U];
    wu[1] = wu[U + 1]; wv[1] = wv[U + 1];
  }
}

template <int VEC>
int launch(const float* u, const float* v, const float* dt, float* us, float* vs,
           int ny, int nx, const Coeffs& k, cudaStream_t stream,
           unsigned long long* launches) {
  const int col_strips = (nx + 32 * VEC - 1) / (32 * VEC);
  const int n_strips = col_strips * ((ny + ROWS - 1) / ROWS);
  constexpr int warps = THREADS / 32;
  fused_predictor_central_kernel<VEC>
      <<<(n_strips + warps - 1) / warps, THREADS, 0, stream>>>(
          u, v, dt, us, vs, ny, nx, col_strips, n_strips, k, launches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous fp32 (ny, nx) arrays;
// dt points to one fp32 value on the same device, `launches` to the
// wrapper's uint64 launch count there. `vec` (4, 2 or 1) must divide nx with
// every field pointer aligned to 4·vec bytes; another value is refused with
// cudaErrorInvalidValue before any launch.
int cfd_fused_predictor_central(const void* u, const void* v, const void* dt,
                                void* us, void* vs, int ny, int nx, int vec,
                                float nu, float inv_dx2, float inv_dy2,
                                float half_inv_dx, float half_inv_dy,
                                void* stream, void* launches) {
  if ((vec != 1 && vec != 2 && vec != 4) || nx % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Coeffs k{nu, inv_dx2, inv_dy2, half_inv_dx, half_inv_dy};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pu = static_cast<const float*>(u);
  const auto* pv = static_cast<const float*>(v);
  const auto* pdt = static_cast<const float*>(dt);
  auto* pus = static_cast<float*>(us);
  auto* pvs = static_cast<float*>(vs);
  auto* n = static_cast<unsigned long long*>(launches);
  if (vec == 4) return launch<4>(pu, pv, pdt, pus, pvs, ny, nx, k, s, n);
  if (vec == 2) return launch<2>(pu, pv, pdt, pus, pvs, ny, nx, k, s, n);
  return launch<1>(pu, pv, pdt, pus, pvs, ny, nx, k, s, n);
}

const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
