// dk and dv of the split flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// byteps_tpu/ops/flash_attention.py::_dkv_kernel (wrapper _flash_bwd,
// pallas_call at :683), the second half of the backward a sequence longer
// than one 512 block, or any biased call, takes; in its three forms (no
// bias, the additive bias, T5's in-kernel relative-position table).
//
// Contract (the Pallas kernel's): with P and dS as in _dq_kernel (delta
// given, the bias or table entry added to each score before the
// softmax), dv = bf16(P)ᵀ·dO and dk = dSᵀ·q·scale, each accumulated in
// fp32 over every query block and stored as bf16.
//
// What bounds it on an H100: four s×s×d products per (batch, head)
// (Sᵀ, dPᵀ, Pᵀ·dO, dSᵀ·Q) against seven [s, d] bf16 tensors moved, far
// above the card's ~295 FLOP/byte ridge at seq 1024: tensor-core
// throughput bounds it. The dense bias adds 4 bytes read per score, about
// as many as the products need in time at d 64; the table adds nothing
// but a shared-memory read per score. On the TPU the query blocks are the
// carried grid dimension; on Hopper CTAs share nothing, so each CTA owns
// one 64-key tile and walks every query tile itself (flash_bwd_dkv.cuh),
// keeping dk and dv in registers, fed by TMA through a ring of tiles and
// multiplied on the tensor cores (wgmma): deterministic, no atomics. One
// launch at head dim 64 or 128 (the register plan in flash_bwd_dkv.cuh).
#include "flash_bwd_dkv.cuh"

// Launches on `stream`, allocates nothing (dk and dv are [b, sk, h, d]
// contiguous; lse and delta are [b, h, sq] fp32, 16-byte aligned); returns
// a cudaError_t (the tensor maps' encoding, then cudaGetLastError()).
// `form` and the bias arguments as in bps_flash_fwd.
extern "C" int bps_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int b,
                             int h, int sq, int sk, int d, long long q_sb,
                             long long q_ss, long long k_sb, long long k_ss,
                             long long v_sb, long long v_ss, long long do_sb,
                             long long do_ss, float scale, int causal,
                             int form, const void* bias, const void* bucket,
                             const void* table, int nb, void* stream) {
  if (sq % kTile != 0 || sk % kTile != 0 || b <= 0 || h <= 0 ||
      !bias_args_ok(form, bias, bucket, table, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  const BiasArgs ba = bias_args(bias, bucket, table, nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_d(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    QkvoMaps m;
    const cudaError_t err = encode_qkvo(
        m, q, k, v, dout, b, h, sq, sk, kD, {q_sb, q_ss}, {k_sb, k_ss},
        {v_sb, v_ss}, {do_sb, do_ss});
    if (err != cudaSuccess) return err;
    return with_form(form, [&](auto F) {
      return launch_dkv<kD, decltype(F)::value>(m, lse, delta, dk, dv, b, h,
                                                sq, sk, scale, causal, ba, st);
    });
  }));
}

// The dynamic shared memory a launch of `kernel` (0 the forward, 1 dq, 2
// dk/dv) asks for at head dim d in bias form `form`, for the kernels this
// library holds; -1 for the others.
extern "C" int bps_flash_smem(int kernel, int d, int form) {
  return kernel == 2 ? layout_bytes<DkvSmem>(d, form) : -1;
}
