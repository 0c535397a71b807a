// Build-and-launch check: out[i] = 2 * in[i] over n int32 values.
//
// Replaces spark_rapids_tpu/device_caps.py pallas_mode, the trivial
// kernel the JAX package lowers once to choose a Pallas mode. Here it
// proves that the nvcc build produced code the card runs; the port has
// no mode to fall back to, so a failure raises.
#include <cuda_runtime.h>

__global__ void probe_double(const int* in, int* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2 * in[i];
}

extern "C" int probe_launch(const void* in, void* out, int n,
                            void* stream) {
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  probe_double<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, n);
  return (int)cudaGetLastError();
}
