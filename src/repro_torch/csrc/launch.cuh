// Kernel launch helpers shared by every kernel library: the dynamic
// shared-memory opt-in and the launch itself, whose error is returned
// (the C interface hands it to the Python wrapper, which raises).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace klaunch {

// Launch `kern` with `smem` bytes of dynamic shared memory (opt_in: the
// attribute alone).  Above the 48 KB default it opts in with
// cudaFuncSetAttribute once per size
// (`opted_in` is the caller's record for this instantiation), so a launch
// inside a CUDA-graph capture makes no attribute call.  Above the card's
// limit that call fails and its error is returned (and cleared, so the next
// launch does not report it): no launch is skipped silently.
template <typename... KArgs>
int opt_in(void (*kern)(KArgs...), size_t* opted_in, size_t smem) {
  if (smem > *opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    *opted_in = smem;
  }
  return 0;
}
template <typename... KArgs, typename... Args>
int launch_kernel(void (*kern)(KArgs...), size_t* opted_in, dim3 grid,
                  int threads, size_t smem, cudaStream_t st, Args... args) {
  const int rc = opt_in(kern, opted_in, smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The same for a grid of thread block clusters of `cluster` blocks each
// (cluster.x/y/z divide grid.x/y/z).
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kern)(KArgs...), size_t* opted_in, dim3 grid,
                    dim3 cluster, int threads, size_t smem, cudaStream_t st,
                    Args... args) {
  const int rc = opt_in(kern, opted_in, smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kern, static_cast<KArgs>(args)...);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace klaunch
