// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the Pallas kernel byteps_tpu/ops/flash_attention.py::_fwd_kernel
// (wrapper _flash_fwd, pallas_call at :284) in its three score forms: no
// bias, the additive bias [h, sq, sk] (`has_bias`) and T5's in-kernel
// relative-position table (`rel`, _bucket_block :61, _table_bias :68,
// _rel_row :78); see flash_bias.cuh. The no-bias form also writes its
// output in fp32 (`out_dtype=float32`, `kF32Out`), which only ring
// attention asks for (byteps_tpu/parallel/ring.py::_flash_blk_fwd): the
// ring merges one partial output per ring step by log-sum-exp, and an fp32
// partial keeps that merge from rounding to bf16 once per step.
//
// Contract (the same as the Pallas kernel's): q [b,sq,h,d], k/v [b,sk,h,d]
// bf16 -> out [b,sq,h,d] bf16 (or fp32) and lse [b,h,sq] fp32. S =
// q·kᵀ·scale (+ B) in fp32; causal masks entries with row < col to -1e30
// and skips kv tiles above the diagonal; online max/sum; P is cast to bf16
// before P·V; out = acc / max(l, 1e-30) and lse = m + log(l). The fp32 out
// is that quotient unrounded: rounded to bf16 it is the bf16 launch's out,
// bit for bit (the two instantiations differ only in the store). The
// softmax runs in log2 units, P = exp2(S·log2(e) - m) on the special-
// function unit (exp2_sfu), as the backward recomputes it from lse
// (flash_bwd_dq.cuh, flash_bwd_dkv.cuh).
//
// What bounds it on an H100: the function reads q, k, v and writes out
// once, 8·s·d bytes per (batch, head), and does 4·s²·d FLOP, so s / 2
// FLOP per byte whatever d: at seq 512 (BERT-large at d 64 and its dh128
// variant at d 128) about 256, just under the card's ~295 FLOP/byte
// ridge, so the least time is set by memory. The dense bias adds
// 4·h·sq·sk bytes (4 bytes per score, more than q, k and v together at
// s 1024, d 64), and so is bounded by memory at every length; the table
// adds h·nb·4 bytes and one shared-memory read per score.
//
// Design (hopper.cuh): one CTA per (batch, head, 64-query tile), a
// consumer warpgroup and a producer warp. The producer loads the Q tile
// once and streams the K and V tiles through a ring of kStages stages by
// TMA, so the next tile's load runs under this tile's math. The consumer
// warpgroup takes S = Q·Kᵀ from shared memory on the tensor cores (wgmma,
// both operands K-major), runs the online softmax on the accumulator in
// registers, and adds P·V with P from registers and V read MN-major from
// the same tile. S and P never leave registers; the running max, sum and
// output accumulator stay there across the walk. Per score the softmax
// costs a multiply, a max, a subtract, one ex2 and an add; the rescale of
// the output accumulator is skipped for a warp whose row maxima did not
// move. (Issuing the next tile's S before this tile's softmax, into a
// second accumulator, was tried and bought nothing measurable on the
// card; it is not kept.)
//
// Head dim kD is a template parameter, instantiated at 64 and 128. Shared
// memory: the Q tile and kStages K/V pairs of [64][kD] bf16 boxes, 40 KB
// at d 64 and 80 KB at d 128 (plus the table form's strip and the
// barriers). Registers of a consumer thread: S (32 fp32), the output
// accumulator (kD / 2 fp32) and P as bf16 A operands (16), under the 168
// that two CTAs of 160 threads leave (five warps each, three on one
// sub-partition): 96 at d 64 without a bias, so four CTAs run per SM, and
// 128 at d 128, where shared memory holds it to two. The fp32 out is
// stored straight from the accumulator registers, 8 bytes a lane where
// the bf16 out stores 4.
#include <chrono>

#include "flash_bias.cuh"

namespace {

constexpr int kStages = 2;

template <int kD, int kForm>
struct FwdSmem {
  Tile<kD> q;
  Tile<kD> k[kStages];
  Tile<kD> v[kStages];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
  BiasSmem<kForm> sb;
};

// kF32Out: `out` is fp32 (the ring's partial output), else bf16.
template <int kD, int kForm, bool kF32Out>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 void* __restrict__ out, float* __restrict__ lse, int h,
                 int sq, int sk, BshdStrides os, float scale, int causal,
                 BiasArgs ba) {
  auto& sm = dyn_smem<FwdSmem<kD, kForm>>();
  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = qt * kTile;
  int nkt = sk / kTile;
  if (causal) nkt = min(nkt, qt + 1);

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: lane 0 issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(&sm.q_full, kTileBytes<kD>);
      load_tile<kD>(&sm.q, &tq, &sm.q_full, q0, hh, bb);
      for (int i = 0; i < nkt; ++i) {
        const int st = i % kStages;
        mbar_wait(&sm.empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * kTileBytes<kD>);
        load_tile<kD>(&sm.k[st], &tk, &sm.full[st], i * kTile, hh, bb);
        load_tile<kD>(&sm.v[st], &tv, &sm.full[st], i * kTile, hh, bb);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  BiasSmem<kForm>& sb = sm.sb;
  load_table_row<kForm>(sb, ba, hh, tid);
  const float* dense = dense_head<kForm>(ba, hh, sq, sk);
  const float scale_l2 = scale * kLog2e;

  float o[kD / 64][32];
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(&sm.q_full, 0);

  for (int i = 0; i < nkt; ++i) {
    const int st = i % kStages, k0 = i * kTile;
    strip_for<kForm>(sb, ba, q0, k0, sq, tid);
    mbar_wait(&sm.full[st], (i / kStages) & 1);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(s, desc_k(sm.q, kk), desc_k(sm.k[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);

    // scores in log2 units; only the diagonal tile has masked entries
    const bool diag = causal && i == nkt - 1;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const int col = k0 + (j >> 2) * 8 + 2 * t + (j & 1);
      float x;
      if constexpr (kForm == kBiasNone) {
        x = s[j] * scale_l2;
      } else {
        x = biased(s[j], scale,
                   bias_at<kForm>(sb, dense, sk, row[r], col, row[r] - q0,
                                  col - k0)) *
            kLog2e;
      }
      if (diag && row[r] < col) x = kNegInf;
      s[j] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_sfu(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = exp2_sfu(s[j] - m[(j >> 1) & 1]);
      s[j] = p;
      rs[(j >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      c_to_a(pa[kk], &s[8 * kk]);
      fence_frag(pa[kk]);
    }
    // a row whose max did not move keeps its scale (alpha 1): the warp
    // skips the multiply when that holds for all its rows
    const bool rescale =
        !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f);
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) {
      if (rescale) {
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= alpha[(j >> 1) & 1];
      }
      fence_acc(o[c]);
    }

    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[c], pa[kk], desc_mn(sm.v[st], c, kk));
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) fence_acc(o[c]);
    mbar_arrive(&sm.empty[st]);
  }

  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = c * 64 + n * 8 + 2 * t;
      const float* a = &o[c][4 * n];
      const float x0 = a[0] / lc[0], x1 = a[1] / lc[0];
      const float x2 = a[2] / lc[1], x3 = a[3] / lc[1];
      if constexpr (kF32Out) {
        float* op = static_cast<float*>(out) + bb * os.b + hh * kD;
        *reinterpret_cast<float2*>(op + row[0] * os.s + col) =
            make_float2(x0, x1);
        *reinterpret_cast<float2*>(op + row[1] * os.s + col) =
            make_float2(x2, x3);
      } else {
        bf16* op = static_cast<bf16*>(out) + bb * os.b + hh * kD;
        *reinterpret_cast<uint32_t*>(op + row[0] * os.s + col) =
            pack_f32(x0, x1);
        *reinterpret_cast<uint32_t*>(op + row[1] * os.s + col) =
            pack_f32(x2, x3);
      }
    }
  }
  if (t == 0) {
    float* lp = lse + ((long long)bb * h + hh) * sq;
    lp[row[0]] = m[0] * kLn2 + logf(lc[0]);
    lp[row[1]] = m[1] * kLn2 + logf(lc[1]);
  }
}

template <int kD, int kForm, bool kF32Out>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* out, void* lse, int b, int h,
                   int sq, int sk, BshdStrides os, float scale, int causal,
                   const BiasArgs& ba, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<FwdSmem<kD, kForm>>;
  const cudaError_t attr =
      smem_attr(flash_fwd_kernel<kD, kForm, kF32Out>, kSmem);
  if (attr != cudaSuccess) return attr;
  flash_fwd_kernel<kD, kForm, kF32Out>
      <<<dim3(sq / kTile, h, b), kThreads, kSmem, stream>>>(
          tq, tk, tv, out, static_cast<float*>(lse), h, sq, sk, os, scale,
          causal, ba);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing; returns a cudaError_t (the
// tensor maps' encoding, then cudaGetLastError()). `form` is a BiasForm: 0
// takes no bias arguments, 1 `bias` ([h, sq, sk] fp32), 2 `bucket` ([sq +
// sk - 1] int32), `table` ([h, nb] fp32) and nb. `out_f32` 1 writes `out`
// as fp32 (no-bias form only), 0 as bf16; the out strides are in elements
// of that type.
extern "C" int bps_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int h, int sq,
                             int sk, int d, long long q_sb, long long q_ss,
                             long long k_sb, long long k_ss, long long v_sb,
                             long long v_ss, long long o_sb, long long o_ss,
                             float scale, int causal, int form,
                             const void* bias, const void* bucket,
                             const void* table, int nb, int out_f32,
                             void* stream) {
  if (sq % kTile != 0 || sk % kTile != 0 || b <= 0 || h <= 0 ||
      !bias_args_ok(form, bias, bucket, table, nb) ||
      (out_f32 && form != kBiasNone))
    return static_cast<int>(cudaErrorInvalidValue);
  const BiasArgs ba = bias_args(bias, bucket, table, nb);
  const BshdStrides os{o_sb, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_d(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    CUtensorMap tq, tk, tv;
    cudaError_t err = encode_bshd(&tq, q, b, sq, h, kD, {q_sb, q_ss});
    if (err == cudaSuccess)
      err = encode_bshd(&tk, k, b, sk, h, kD, {k_sb, k_ss});
    if (err == cudaSuccess)
      err = encode_bshd(&tv, v, b, sk, h, kD, {v_sb, v_ss});
    if (err != cudaSuccess) return err;
    if (out_f32)
      return launch<kD, kBiasNone, true>(tq, tk, tv, out, lse, b, h, sq, sk,
                                         os, scale, causal, ba, st);
    return with_form(form, [&](auto F) {
      return launch<kD, decltype(F)::value, false>(
          tq, tk, tv, out, lse, b, h, sq, sk, os, scale, causal, ba, st);
    });
  }));
}

// The dynamic shared memory a launch of `kernel` (0 the forward, 1 dq, 2
// dk/dv) asks for at head dim d in bias form `form`, for the kernels this
// library holds; -1 for the others.
extern "C" int bps_flash_smem(int kernel, int d, int form) {
  return kernel == 0 ? layout_bytes<FwdSmem>(d, form) : -1;
}

// The host cost of the tensor maps every launch encodes: `n` encodes of a
// BERT-large operand's map ([8, 512, 16, 64] bf16, contiguous) at
// `base`, a device allocation of at least 16 bytes (encoding reads no
// memory); microseconds per encode, or -1 if the driver refuses the map.
extern "C" double bps_tensor_map_us(const void* base, int n) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) {
    if (encode_bshd(&map, base, 8, 512, 16, 64, {512 * 16 * 64, 16 * 64}) !=
        cudaSuccess)
      return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / n;
}
