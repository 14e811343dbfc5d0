// int8 dequantization for Hopper (sm_90a): int8 [n] -> f32 [n].
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_int8_dq_kernel (wrapper
// int8_dequantize, pallas_call at :256). On the parameter-server path the
// device encode (compress/device.py) runs it once per int8 bucket per step
// for the error-feedback residual x - q·s, the same function as the JAX
// encode's q.astype(f32) * scale.
//
// Contract: out = (float) q · s, one correctly rounded multiply
// (__fmul_rn, which the compiler never contracts into an FMA). The
// subtraction x - out stays a separate tensor operation in the wrapper's
// caller, so nothing rounds the residual differently from the host codec.
//
// What bounds it on an H100: 1 byte read and 4 written per element, one
// multiply: device memory. One element per thread, coalesced, the tail
// masked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
int8_dequantize_kernel(const int8_t* __restrict__ q, float* __restrict__ out,
                       long long n, float s) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  out[i] = __fmul_rn(static_cast<float>(q[i]), s);
}

}  // namespace

// Launches on `stream`, allocates nothing (`out` holds n floats); returns
// cudaGetLastError().
extern "C" int bps_int8_dequantize(const void* q, void* out, long long n,
                                   float scale, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  int8_dequantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<float*>(out), n, scale);
  return static_cast<int>(cudaGetLastError());
}
