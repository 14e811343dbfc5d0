// Shared machinery of the hand-written Hopper (sm_90a) attention kernels:
// tiles brought into shared memory by the Tensor Memory Accelerator (TMA)
// with 128-byte swizzle, full/empty mbarriers around a ring of such tiles,
// and bf16 products on the tensor cores through wgmma.mma_async
// (m64n64k16, fp32 accumulation).
//
// CTA shape, the same in every kernel: one consumer warpgroup (warps 0-3,
// 64 rows of the output tile, 16 a warp) and one producer warp (warp 4),
// whose lane 0 issues every TMA load. The producer fills a ring of
// kStages stages; each stage has a `full` barrier (one arrival, the
// producer's expect_tx, plus the bytes TMA delivers) and an `empty` barrier
// (one arrival per consumer thread once its wgmma reads of the stage are
// done). Tile i of a walk sits in stage i % kStages; its barriers are in
// their (i / kStages)-th phase, so the consumers wait `full` on parity
// (i / kStages) & 1 and the producer waits `empty` on the opposite parity
// (a fresh barrier counts its previous phase as complete, so the first
// round passes).
//
// Tiles: a [64 rows][kD] bf16 tile is kD / 64 boxes of [64 rows][64 cols],
// 8 KB each, 1024-byte aligned, each row 128 bytes with its 16-byte chunks
// XOR-swizzled by (row % 8): the layout TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B and the one wgmma's 128B-swizzle descriptors
// read. One stored tile serves as either operand layout:
//   - K-major (rows are M or N, the 64 columns of a box are K): Q, K as
//     the operands of S = Q·Kᵀ, dO, V of dP = dO·Vᵀ, and K, V, Q, dO of
//     the transposed products Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ;
//   - MN-major (rows are K, columns N, the transpose bit set): V of O =
//     P·V, K of dQ = dS·K, dO of dV = Pᵀ·dO, Q of dK = dSᵀ·Q. Each
//     m64n64 product covers one box's 64 columns, so at d 128 it is two
//     products, one per box.
//
// Register layouts (PTX ISA, "Register Fragments and Shared Memory Matrix
// Layouts" of wgmma .m64nNk16), with warp w of the warpgroup, g = lane / 4,
// t = lane % 4:
//   accumulator D (64 x 64 fp32, 32 registers): d[4n + i] is row
//     16w + g + 8·(i / 2), column 8n + 2t + (i % 2);
//   A from registers (64 x 16 bf16, 4 registers of two bf16): a0 = (row
//     16w + g, k 2t..2t+1), a1 = (row 16w + g + 8, k 2t..), a2 = (row
//     16w + g, k 2t+8..2t+9), a3 = (row 16w + g + 8, k 2t+8..).
// So the accumulators of columns 16j..16j+15 (d[8j..8j+7]), rounded to
// bf16, are the A operand of k-step j of the next product (c_to_a): S, P,
// dP and dS never leave registers.
//
// The host encodes one tensor map per [b, s, h, d] operand at every launch
// (the activations move between calls): cuTensorMapEncodeTiled is a driver
// API entry point, fetched once through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the libraries link no driver stub.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

// One 64-row tile of queries (or keys) per CTA; the producer warp after
// the consumer warpgroup.
constexpr int kTile = 64;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;
constexpr int kBoxBytes = kTile * 128;  // one [64][64] bf16 box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// A barrier wait that has not completed after this many cycles (about 9 s
// at the H100's clocks) traps: a fault in the ring becomes a launch error
// that the caller's synchronize reports, never a hung card.
constexpr long long kHangCycles = 1LL << 34;

// Call f(std::integral_constant<int, d>) for a head dim the kernels are
// instantiated for, or return cudaErrorInvalidValue: every entry point
// dispatches its `d` here, so another width is one more case.
template <typename F>
inline cudaError_t with_d(int d, F&& f) {
  switch (d) {
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// A [64][kD] bf16 tile: kD / 64 swizzled boxes.
template <int kD>
struct alignas(1024) Tile {
  bf16 x[kTile * kD];
};
template <int kD>
constexpr uint32_t kTileBytes = sizeof(Tile<kD>);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The kernels' layouts live in dynamic shared memory, rounded up to 1024
// bytes inside the window (swizzled boxes must start on a 1024-byte
// boundary); a launch asks for smem_bytes<T>.
template <typename T>
__device__ __forceinline__ T& dyn_smem() {
  extern __shared__ __align__(1024) unsigned char bps_dyn_smem[];
  const uint32_t pad = (1024u - (smem_u32(bps_dyn_smem) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(bps_dyn_smem + pad);
}
template <typename T>
constexpr int smem_bytes = static_cast<int>(sizeof(T)) + 1024;

// Allow `kernel` `bytes` of dynamic shared memory: above 48 KB a launch
// without it is refused. The attribute belongs to the current device's
// context, so every launch sets it (a cheap host call).
template <typename Kernel>
inline cudaError_t smem_attr(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the inits, before any thread (or TMA) uses the barriers.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` of `bar` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// The consumer warpgroup's own barrier (the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------------ TMA

// Box (c0, c1, c2, c3) of a 4-D tensor map into shared memory, completing
// on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows row0..row0+63 of head hh of batch bb of a [b, s, h, d] map: kD / 64
// boxes of 64 columns. kTileBytes<kD> bytes complete on `bar`.
template <int kD>
__device__ __forceinline__ void load_tile(Tile<kD>* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int hh,
                                          int bb) {
  unsigned char* p = reinterpret_cast<unsigned char*>(dst->x);
#pragma unroll
  for (int c = 0; c < kD / 64; ++c)
    tma_load_4d(p + c * kBoxBytes, map, bar, c * 64, hh, row0, bb);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor of a 128B-swizzled operand: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: k-step kk (columns 16kk..16kk+15) of a tile. Within a
// box the step is a 32-byte advance of the start address (the hardware
// applies the swizzle from the address bits); 8-row groups are 1024 bytes
// apart.
template <int kD>
__device__ __forceinline__ uint64_t desc_k(const Tile<kD>& tile, int kk) {
  return sw128_desc(smem_u32(tile.x) + (kk >> 2) * kBoxBytes + (kk & 3) * 32,
                    16, 1024);
}

// MN-major operand (transposed B): rows 16kk..16kk+15 are K, the 64
// columns of box c are N. Groups of 8 rows are 1024 bytes apart; an N of
// 64 stays inside one box, so the offset between boxes is never read.
template <int kD>
__device__ __forceinline__ uint64_t desc_mn(const Tile<kD>& tile, int c,
                                            int kk) {
  return sw128_desc(smem_u32(tile.x) + c * kBoxBytes + kk * 2048, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A operands held in registers, written before the fence.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

#define BPS_WGMMA_D32                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define BPS_WGMMA_OUT32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A·B, 64 x 64 x 16, both operands K-major in shared memory.
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BPS_WGMMA_OUT32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : BPS_WGMMA_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A·B, 64 x 64 x 16, A from registers (4 of two bf16, the layout
// above), B MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BPS_WGMMA_OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : BPS_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef BPS_WGMMA_D32
#undef BPS_WGMMA_OUT32

// ------------------------------------------------------ fragment helpers

// Round two fp32 values to bf16 (round to nearest even, as torch's cast).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator columns 16j..16j+15 (c = &d[8j]), rounded to bf16: the A
// operand of k-step j of the next product.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float* c) {
  a[0] = pack_f32(c[0], c[1]);
  a[1] = pack_f32(c[2], c[3]);
  a[2] = pack_f32(c[4], c[5]);
  a[3] = pack_f32(c[6], c[7]);
}

// 2^x on the special-function unit (ex2.approx.ftz: a result below
// 2^-126 flushes to 0). The softmax of the forward and the P the backward
// recomputes both take it, so the pair agrees.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sum (or max) over the 4 lanes that share a row of an accumulator.
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

// Element strides of a [b, s, h, d] tensor whose head stride is d and
// whose last stride is 1 (the wrapper checks both).
struct BshdStrides {
  long long b;
  long long s;
};

// ------------------------------------------------------ host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched once per process; null if
// the driver has none.
inline EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// An entry point returns kMapError + the driver's CUresult when it cannot
// encode a tensor map (a code no cudaError_t takes), so the caller can
// tell a refused map from a refused launch.
constexpr int kMapError = 100000;

// The tensor map of a bf16 [b, s, h, d] operand with element strides
// (sb, ss, d, 1), read in [64 rows][64 columns] boxes under 128-byte
// swizzle. TMA needs a 16-byte-aligned base and strides that are
// multiples of 16 bytes (the wrapper copies anything else).
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int b,
                               int s, int h, int d, BshdStrides st) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<cudaError_t>(kMapError - 1);
  // a batch of one never moves along its batch stride, which may then be
  // anything; state the dense one
  const long long sb = b == 1 ? static_cast<long long>(s) * st.s : st.b;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  auto encode_map = [&] {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode_map();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    // No context is current on this thread yet (PyTorch's autograd thread
    // may call before any runtime call there bound one): bind the primary
    // context of the operand's device, as the launch would, and encode.
    cudaPointerAttributes at;
    if (cudaPointerGetAttributes(&at, base) == cudaSuccess &&
        cudaSetDevice(at.device) == cudaSuccess)
      r = encode_map();
  }
  return r == CUDA_SUCCESS ? cudaSuccess
                           : static_cast<cudaError_t>(kMapError + r);
}

// The tensor maps of the backward's operands, q, k, v and dO.
struct QkvoMaps {
  CUtensorMap q, k, v, o;
};

inline cudaError_t encode_qkvo(QkvoMaps& m, const void* q, const void* k,
                               const void* v, const void* dout, int b, int h,
                               int sq, int sk, int d, BshdStrides qs,
                               BshdStrides ks, BshdStrides vs,
                               BshdStrides dos) {
  cudaError_t err = encode_bshd(&m.q, q, b, sq, h, d, qs);
  if (err == cudaSuccess) err = encode_bshd(&m.k, k, b, sk, h, d, ks);
  if (err == cudaSuccess) err = encode_bshd(&m.v, v, b, sk, h, d, vs);
  if (err == cudaSuccess) err = encode_bshd(&m.o, dout, b, sq, h, d, dos);
  return err;
}

