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
// Both recompute S and dP from q, k, v, dO on the tensor cores (wgmma,
// bf16 x bf16 -> fp32, operands brought by TMA through a ring of tiles:
// hopper.cuh); S, P and dP never reach device memory. The recompute costs
// 9 products where the function needs 5 (7 with delta given, which skips
// (a)'s delta walk), at either head dim: the price of needing no atomics
// and no [s, s] buffer. The tensor maps of q, k, v and dO are encoded once
// per call and serve both launches. The given delta adds 4 bytes per query
// row read, next to lse: bounded by tensor-core throughput all the same.
#include "flash_bwd_dkv.cuh"
#include "flash_bwd_dq.cuh"

// Launches (a) then (b) on `stream`, allocates nothing (dq is [b, sq, h,
// d] and dk/dv are [b, sk, h, d], all contiguous); returns a cudaError_t
// (the tensor maps' encoding, then cudaGetLastError()). `delta_in` null:
// delta is computed in (a) into `delta`, the caller's [b, h, sq] fp32
// scratch. `delta_in` non-null: the caller's [b, h, sq] fp32 delta, read
// only; `delta` is then unused.
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
  return static_cast<int>(with_d(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    QkvoMaps m;
    cudaError_t err = encode_qkvo(m, q, k, v, dout, b, h, sq, sk, kD,
                                  {q_sb, q_ss}, {k_sb, k_ss}, {v_sb, v_ss},
                                  {do_sb, do_ss});
    if (err != cudaSuccess) return err;
    // read only: the kDeltaIn kernel never writes it
    void* dl = delta_in != nullptr ? const_cast<void*>(delta_in) : delta;
    err = delta_in != nullptr
              ? launch_dq<true, kD, kBiasNone>(m, lse, dl, dq, b, h, sq, sk,
                                               scale, causal, BiasArgs{},
                                               nullptr, st)
              : launch_dq<false, kD, kBiasNone>(m, lse, dl, dq, b, h, sq, sk,
                                                scale, causal, BiasArgs{},
                                                nullptr, st);
    if (err != cudaSuccess) return err;
    return launch_dkv<kD, kBiasNone>(m, lse, dl, dk, dv, b, h, sq, sk, scale,
                                     causal, BiasArgs{}, st);
  }));
}

// The dynamic shared memory a launch of `kernel` (0 the forward, 1 dq, 2
// dk/dv) asks for at head dim d in bias form `form`, for the kernels this
// library holds; -1 for the others.
extern "C" int bps_flash_smem(int kernel, int d, int form) {
  if (kernel == 1) return layout_bytes<DqSmem>(d, form);
  return kernel == 2 ? layout_bytes<DkvSmem>(d, form) : -1;
}
