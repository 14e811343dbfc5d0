// Shared helpers of the hand-written Hopper attention kernels: bf16
// tensor-core products through mma.sync.m16n8k16 with fp32 accumulation,
// and the fragment loads that feed them from shared memory.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): reg0 = (row g,   k 2t..2t+1)
//                         reg1 = (row g+8, k 2t..2t+1)
//                         reg2 = (row g,   k 2t+8..2t+9)
//                         reg3 = (row g+8, k 2t+8..2t+9)
//   B (16x8, k-major):    reg0 = (k 2t..2t+1,   col g)
//                         reg1 = (k 2t+8..2t+9, col g)
//   C (16x8, fp32):       c0,c1 = (row g,   cols 2t, 2t+1)
//                         c2,c3 = (row g+8, cols 2t, 2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Tile geometry shared by the forward and the backward: one 64-row tile
// of queries (or keys) per CTA, 16 rows per warp, head dim 64. Shared
// memory rows are padded by 8 bf16 so that the fragment loads of the 8
// row groups of a warp fall on distinct banks.
constexpr int kD = 64;
constexpr int kTile = 64;
constexpr int kLD = kD + 8;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Round two fp32 values to bf16 (round to nearest even, as torch's cast).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a [kTile, kD] tile whose rows are `row_stride` elements apart in
// global memory into shared memory [kTile][kLD], 16 bytes per thread.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int tid) {
  constexpr int kChunks = kD / 8;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * kLD + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// A fragment of rows r0.., columns c0.. of a row-major smem tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int r0,
                                       int c0, int g, int t) {
  const bf16* p = s + (r0 + g) * kLD + c0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * kLD);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * kLD + 8);
}

// B fragment (k0.., n0..) from a smem tile that holds B transposed,
// one row per column n (K[key][d] for S = Q·Kᵀ): k pairs are contiguous.
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* s, int n0,
                                          int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * kLD + k0 + 2 * t;
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// B fragment (k0.., n0..) from a smem tile that holds B row-major, one
// row per k (V[key][d] for O = P·V): k pairs are a row apart.
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* s, int k0,
                                          int n0, int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * kLD + n0 + g;
  b[0] = pack_bf16(p[0], p[kLD]);
  b[1] = pack_bf16(p[8 * kLD], p[9 * kLD]);
}

// The C fragments of n-tiles 2j and 2j+1 of a product, rounded to bf16,
// are the A fragment of k-step j of the next product (P·V, dS·K, ...).
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// Sum (or max) over the 4 lanes that share a row of a C fragment.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Element strides of a [b, s, h, kD] tensor whose head stride is kD and
// whose last stride is 1 (the wrapper checks both).
struct BshdStrides {
  long long b;
  long long s;
};
