// Error text for the codes the C entry points return (cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* sgl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
