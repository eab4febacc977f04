// Host helpers shared by the kernel launchers' Python bindings.

#include <cuda_runtime.h>

// The CUDA runtime's text for an error code a launcher returned.
extern "C" const char* xmhw_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
