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
// is bandwidth-bound. The unfused torch ops make about ten passes over the
// fields; the Pallas docstring counts the same ~10 against 4 for the fused
// pass. Here each 32x8 thread block stages a (8+2)x(32+2) tile of u and of v
// in shared memory, so every field value is read from device memory once
// (plus a 1-cell halo, ~1.3x for the tile) and both outputs are written once,
// with neighbouring threads on neighbouring addresses.
//
// dt is read from a device pointer (the 0-dim tensor the adaptive-dt
// reduction produced), so the launch needs no host synchronisation and can
// later be captured in a CUDA graph.
//
// The arithmetic follows the order of the Pallas kernel:
//     lap  = (e - 2q + w) * (1/dx^2) + (n - 2q + s) * (1/dy^2)
//     conv = u * (e - w) * (0.5/dx) + v * (n - s) * (0.5/dy)
//     out  = q + dt * (nu * lap - conv)
// nvcc may contract pairs of these into fused multiply-adds, which changes
// the last bit of an intermediate but not the result beyond 1e-6 absolute.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__device__ __forceinline__ float predict(float q, float e, float w, float n,
                                         float s, float uc, float vc, float dt,
                                         float nu, float inv_dx2, float inv_dy2,
                                         float half_inv_dx, float half_inv_dy) {
  const float lap = (e - 2.0f * q + w) * inv_dx2 + (n - 2.0f * q + s) * inv_dy2;
  const float conv = uc * (e - w) * half_inv_dx + vc * (n - s) * half_inv_dy;
  return q + dt * (nu * lap - conv);
}

__global__ void __launch_bounds__(TX * TY)
fused_predictor_central_kernel(const float* __restrict__ u,
                               const float* __restrict__ v,
                               const float* __restrict__ dt_ptr,
                               float* __restrict__ us, float* __restrict__ vs,
                               int ny, int nx, float nu, float inv_dx2,
                               float inv_dy2, float half_inv_dx,
                               float half_inv_dy) {
  __shared__ float su[TY + 2][TX + 2];
  __shared__ float sv[TY + 2][TX + 2];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int j0 = blockIdx.x * TX;
  const int i0 = blockIdx.y * TY;

  // Stage the tile and its 1-cell halo. Cells outside the array are never
  // read by an interior update, so they are filled with zero.
  for (int idx = ty * TX + tx; idx < (TY + 2) * (TX + 2); idx += TX * TY) {
    const int li = idx / (TX + 2);
    const int lj = idx - li * (TX + 2);
    const int gi = i0 + li - 1;
    const int gj = j0 + lj - 1;
    const bool inside = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
    const size_t g = static_cast<size_t>(gi) * nx + gj;
    su[li][lj] = inside ? u[g] : 0.0f;
    sv[li][lj] = inside ? v[g] : 0.0f;
  }
  __syncthreads();

  const int i = i0 + ty;
  const int j = j0 + tx;
  if (i >= ny || j >= nx) return;  // ragged edge of the last blocks
  const size_t g = static_cast<size_t>(i) * nx + j;
  const int li = ty + 1;
  const int lj = tx + 1;
  const float uc = su[li][lj];
  const float vc = sv[li][lj];
  if (i == 0 || j == 0 || i == ny - 1 || j == nx - 1) {
    us[g] = uc;  // boundary frame passes through
    vs[g] = vc;
    return;
  }
  const float dt = *dt_ptr;
  // e/w step along x (dim 1), n/s along y (dim 0): n = row i+1, s = row i-1
  us[g] = predict(uc, su[li][lj + 1], su[li][lj - 1], su[li + 1][lj],
                  su[li - 1][lj], uc, vc, dt, nu, inv_dx2, inv_dy2,
                  half_inv_dx, half_inv_dy);
  vs[g] = predict(vc, sv[li][lj + 1], sv[li][lj - 1], sv[li + 1][lj],
                  sv[li - 1][lj], uc, vc, dt, nu, inv_dx2, inv_dy2,
                  half_inv_dx, half_inv_dy);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// All pointers are device pointers to contiguous fp32 (ny, nx) arrays;
// dt points to one fp32 value on the same device.
int cfd_fused_predictor_central(const void* u, const void* v, const void* dt,
                                void* us, void* vs, int ny, int nx, float nu,
                                float inv_dx2, float inv_dy2,
                                float half_inv_dx, float half_inv_dy,
                                void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
  fused_predictor_central_kernel<<<grid, block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(dt), static_cast<float*>(us),
      static_cast<float*>(vs), ny, nx, nu, inv_dx2, inv_dy2, half_inv_dx,
      half_inv_dy);
  return static_cast<int>(cudaGetLastError());
}

const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
