// Programmatic dependent launch (Hopper), shared by dense_domain.cu and
// compact.cu.
//
// A kernel launched with launch_after may be scheduled once every block of
// the kernel before it on the stream has signalled (allow_dependents) or
// exited. It reads what does not depend on that kernel (what came before it
// on the stream is complete by then: that kernel started after it), then
// waits for that kernel to complete and its writes to be visible
// (await_prerequisites). Its launch and its first loads so overlap the tail
// of the kernel before. A CUDA graph captures the dependency as it is.

#pragma once

#include <cuda_runtime.h>

namespace dependent_launch {

__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void await_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), unsigned grid,
                         unsigned block, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace dependent_launch
