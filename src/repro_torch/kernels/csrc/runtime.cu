// Error text for the codes the launchers return (kernels/_build.py).
#include "common.cuh"

extern "C" const char* rt_error_string(int code) {
  if (code == RT_UNSUPPORTED) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
