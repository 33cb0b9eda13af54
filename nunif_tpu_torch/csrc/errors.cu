// Error text for the codes the kernel entry points return: a cudaError_t,
// or kDriverErrorBase + a CUresult of the driver calls made through the
// runtime's entry points (K7's tensor-map encode).
#include <stdio.h>

#include "common.cuh"

extern "C" const char* nunif_error_string(int code) {
  using nunif::kDriverErrorBase;
  if (code >= kDriverErrorBase) {
    static thread_local char text[96];
    snprintf(text, sizeof(text), "CUresult %d from cuTensorMapEncodeTiled",
             code - kDriverErrorBase);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
