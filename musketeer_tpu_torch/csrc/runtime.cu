// CUDA error text for the Python wrappers (ops/_build.py::check).
#include <cuda_runtime.h>

extern "C" const char* mk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
