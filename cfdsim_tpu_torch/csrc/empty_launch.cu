// A launch of one thread that does nothing: the floor under any kernel's
// time in a CUDA graph replay. Only the benchmark launches it
// (bench.py::predictor_ms); it is on no path of the solver.

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int cfd_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
