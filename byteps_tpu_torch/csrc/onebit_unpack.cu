// Onebit sign unpacking for Hopper (sm_90a): 32-bit words [m] -> f32 [n],
// n <= 32·m.
//
// Replaces the Pallas kernel
// byteps_tpu/ops/compression/pallas_kernels.py::_unpack_kernel (wrapper
// onebit_unpack, pallas_call at :92), run 1 + world times per compressed
// gradient bucket per step (error feedback's decompress, then one per
// gathered payload).
//
// Contract (the Pallas kernel's): element i is 1 - 2·bit, bit = (word[i / 32]
// >> (31 - i % 32)) & 1, as f32, UNSCALED: the caller multiplies by the
// payload's scale.
//
// What bounds it on an H100: one word read per 32 floats written and a few
// integer operations per float: device memory bounds it. The design gives
// each thread one output element, so the writes are coalesced (a warp
// writes 128 neighbouring bytes); the 32 threads of a warp read the same
// word, which the hardware serves as one broadcast load.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
onebit_unpack_kernel(const uint32_t* __restrict__ words,
                     float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const uint32_t bit = (words[i >> 5] >> (31 - (i & 31))) & 1u;
  out[i] = 1.f - 2.f * static_cast<float>(bit);
}

}  // namespace

// Launches on `stream`, allocates nothing (`words` holds at least
// ceil(n / 32) words, `out` n floats); returns cudaGetLastError().
extern "C" int bps_onebit_unpack(const void* words, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  onebit_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
