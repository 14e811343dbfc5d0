// int8 quantization for Hopper (sm_90a): f32 [n] -> int8 [n].
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_int8_q_kernel (wrapper
// int8_quantize, pallas_call at :151), run once per compressed gradient
// bucket per step by the parameter-server path's device encode
// (compress/device.py) under BPS_COMPRESS=int8.
//
// Contract (the codec's, compress/wire.py CODEC_INT8): q = clip(
// round-half-even(x / s), -127, 127), s <= 0 taken as 1.0. The payload must
// be byte-identical to numpy's rint(x / s), so the division is correctly
// rounded (__fdiv_rn; a reciprocal multiply flips round-half-even ties on
// a few elements in ten million) and the rounding is rintf, never roundf.
// The file is never built with fast math. NaN inputs are outside the
// contract (the codec's scale is then meaningless).
//
// What bounds it on an H100: 4 bytes read and 1 written per element and a
// handful of operations: device memory. The design reads each float once,
// coalesced (a warp reads 32 neighbouring floats), and writes its byte;
// the Pallas kernel's (256, 128) tiles and zero padding are TPU layout and
// have no counterpart here: the grid covers n and masks the tail.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
int8_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     long long n, float s) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  float v = rintf(__fdiv_rn(x[i], s));
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  q[i] = static_cast<int8_t>(v);
}

}  // namespace

// Launches on `stream`, allocates nothing (`q` holds n bytes); returns
// cudaGetLastError().
extern "C" int bps_int8_quantize(const void* x, void* q, long long n,
                                 float scale, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float s = scale > 0.0f ? scale : 1.0f;
  const long long blocks = (n + kThreads - 1) / kThreads;
  int8_quantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), n, s);
  return static_cast<int>(cudaGetLastError());
}
