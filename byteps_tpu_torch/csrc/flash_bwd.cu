// Fused flash-attention backward for Hopper (sm_90a): (q, k, v, dO, lse)
// -> (dq, dk, dv), with no `out` input.
//
// Replaces the Pallas kernel
// byteps_tpu/ops/flash_attention.py::_dqkv_fused_kernel (wrapper
// _flash_bwd_fused, pallas_call at :564), the backward the flagship step
// takes when the whole sequence is one block per (batch, head), in both of
// its forms: delta computed in-kernel (`has_delta=False`) and delta given
// (`has_delta=True`), which only ring attention takes
// (byteps_tpu/parallel/ring.py::_ring_flash_vjp_bwd hoists one global
// delta = rowsum(dO∘out) over the whole sequence; a local rowsum(P∘dP)
// would miss the other shards' keys).
//
// Contract (the Pallas kernel's): P = exp(q·kᵀ·scale - lse), zeroed where
// row < col under causal masking; dP = dO·vᵀ; delta = rowsum(P∘dP) over the
// WHOLE key row; dS = P∘(dP - delta) cast to bf16; dq = dS·k·scale,
// dk = dSᵀ·q·scale, dv = bf16(P)ᵀ·dO, each accumulated in fp32 and stored
// as bf16.
//
// What bounds it on an H100: five s×s×d products per (batch, head)
// against seven [s, d] bf16 tensors moved, about 365 FLOP/byte at seq
// 512, above the card's ~295 FLOP/byte ridge: tensor-core throughput
// bounds it.
//
// The TPU kernel holds a head's whole 512x512 S, P and dP in VMEM and
// runs its grid in order. On Hopper CTAs run in parallel and share
// nothing, and two quantities reduce across tiles: delta needs the whole
// key row, and dk/dv sum over every query tile. The design is two
// launches behind one entry point, deterministic and free of atomics:
//   (a) one CTA per (batch, head, 64-query tile) walks the key tiles
//       twice, first for delta (written to a [b, h, sq] fp32 scratch),
//       then for dq;
//   (b) one CTA per (batch, head, 64-key tile) walks the query tiles and
//       accumulates dk and dv in registers, reading delta from (a).
// With delta given, (a) is the dq kernel in its delta-input mode (the
// split backward's, flash_dq.cu): one walk, no delta pass, no scratch;
// (b) reads the given delta. Its outputs are then the split route's dq and
// dk/dv with the same delta, bit for bit: the same kernels.
// Both recompute S and dP from q, k, v, dO on the tensor cores
// (mma.sync.m16n8k16, bf16 x bf16 -> fp32); S, P and dP never reach device
// memory. The recompute costs 9 products where the function needs 5 (7
// with delta given, which skips (a)'s delta walk): the price of needing no
// atomics and no [s, s] buffer. At head dim 128, (b) is two launches, dv
// then dk (the register plan in flash_bwd_dkv.cuh), and the pair
// recomputes 10 products (8 with delta given). The given delta adds 4
// bytes per query row read, next to lse: bounded by tensor-core
// throughput all the same.
#include "flash_bwd_dkv.cuh"
#include "flash_bwd_dq.cuh"

namespace {

template <bool kDeltaIn, int kD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, void* delta,
                       void* dq, void* dk, void* dv, int b, int h, int sq,
                       int sk, BshdStrides qs, BshdStrides ks, BshdStrides vs,
                       BshdStrides dos, float scale, int causal,
                       cudaStream_t st) {
  constexpr int kSmem = sizeof(DqSmem<kD, kBiasNone>);
  const cudaError_t attr =
      smem_attr(flash_bwd_dq_kernel<kDeltaIn, kD, kBiasNone>, kSmem);
  if (attr != cudaSuccess) return attr;
  const long long row = static_cast<long long>(h) * kD;
  flash_bwd_dq_kernel<kDeltaIn, kD, kBiasNone>
      <<<dim3(sq / kTile, h, b), kThreads, kSmem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<float*>(delta),
          static_cast<bf16*>(dq), h, sq, sk, qs, ks, vs, dos,
          BshdStrides{sq * row, row}, scale, causal, BiasArgs{}, nullptr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dkv_all<kD, kBiasNone>(q, k, v, dout, lse, delta, dk, dv, b,
                                       h, sq, sk, qs, ks, vs, dos, scale,
                                       causal, BiasArgs{}, st);
}

}  // namespace

// Launches (a) then (b) on `stream`, allocates nothing (dq is [b, sq, h,
// d] and dk/dv are [b, sk, h, d], all contiguous); returns
// cudaGetLastError(). `delta_in` null: delta is computed in (a) into
// `delta`, the caller's [b, h, sq] fp32 scratch. `delta_in` non-null: the
// caller's [b, h, sq] fp32 delta, read only; `delta` is then unused.
extern "C" int bps_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, void* delta,
                             const void* delta_in, void* dq, void* dk,
                             void* dv, int b, int h, int sq, int sk, int d,
                             long long q_sb, long long q_ss, long long k_sb,
                             long long k_ss, long long v_sb, long long v_ss,
                             long long do_sb, long long do_ss, float scale,
                             int causal, void* stream) {
  if (sq % kTile != 0 || sk % kTile != 0 || b <= 0 || h <= 0 ||
      (delta_in == nullptr && delta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BshdStrides qs{q_sb, q_ss}, ks{k_sb, k_ss}, vs{v_sb, v_ss},
      dos{do_sb, do_ss};
  return static_cast<int>(with_d(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    if (delta_in != nullptr)  // read only: the kDeltaIn kernel never writes it
      return launch_bwd<true, kD>(q, k, v, dout, lse,
                                  const_cast<void*>(delta_in), dq, dk, dv, b,
                                  h, sq, sk, qs, ks, vs, dos, scale, causal,
                                  st);
    return launch_bwd<false, kD>(q, k, v, dout, lse, delta, dq, dk, dv, b, h,
                                 sq, sk, qs, ks, vs, dos, scale, causal, st);
  }));
}
