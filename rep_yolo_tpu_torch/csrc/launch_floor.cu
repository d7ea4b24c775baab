// An empty kernel: the yardstick of a launch's floor on this card.
//
// It replaces no TPU kernel, and no path of the port calls it. chip_smoke.py
// times it under the profiler at the grid, block and dynamic shared memory
// of a kernel call (K6 max_pool2_q8 and K8 spp_pools_q8, each in its design
// and in the one before), beside that call's own time: the part of a call
// that no design of its body can remove. It does nothing but return.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// Launches the empty kernel on grid (gx, gy, gz) of blocks (bx, by, bz) with
// smem bytes of dynamic shared memory. Returns a cudaError_t.
extern "C" int launch_floor(int gx, int gy, int gz, int bx, int by, int bz,
                            int smem, void* stream_ptr) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            launch_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return (int)err;
    }
    launch_floor_kernel<<<dim3(gx, gy, gz), dim3(bx, by, bz), smem,
                          (cudaStream_t)stream_ptr>>>();
    return (int)cudaGetLastError();
}
