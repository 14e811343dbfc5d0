// dk and dv of the flash-attention backward for Hopper (sm_90a): one CTA
// per (batch, head, 64-key tile) walks the query tiles and accumulates
// dk = Σ_q dSᵀ·Q·scale and dv = Σ_q bf16(P)ᵀ·dO in registers, reading lse
// and delta ([b, h, sq] fp32) from its inputs. Query tiles wholly above
// the diagonal are skipped under causal masking.
//
// Rows of every product are keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ
// come out of the tensor cores already in the A layout of dv += Pᵀ·dO and
// dk += dSᵀ·Q, and never touch shared or device memory.
//
// Shared by flash_bwd.cu (the fused backward's second launch, delta from
// its first) and flash_dkv.cu (the split backward's `_dkv_kernel`, delta
// from the caller).
//
// kForm is the bias source (flash_bias.cuh; the fused backward takes no
// bias). Because the fragments are transposed, the bias of fragment row
// `key` and column `query` is the offset key - query's (the table form's
// strip entry kl - ql + 63, as in the forward) and the dense form reads
// bias[h, query, key]: the column, not the row, picks the bias row.
//
// Head dim kD is a template parameter (64 and 128). The K, V, Q and dO
// tiles sit in dynamic shared memory, 4 · 64 · (kD + 8) · 2 bytes: 36,864
// at d 64, 69,632 at d 128. Register plan, by width:
//   - d 64 (kOut = kDkDv): one launch; a warp holds its K and V A
//     fragments (kD / 4 registers each), the dk and dv accumulators
//     (kD / 2 fp32 each) and the Sᵀ and dPᵀ tiles (64 fp32): 231
//     registers without a bias.
//   - d 128: the accumulators alone are 128 fp32 and the K and V
//     fragments 64 more, past the 255 a thread may hold once Sᵀ and dPᵀ
//     are live. So the fragments are re-read from the K and V tiles,
//     which stay in shared memory (AFrags), and dk and dv are two
//     launches of this kernel, kDvOnly then kDkOnly, each with one
//     accumulator live. The dv launch needs no dPᵀ; both recompute Sᵀ:
//     5 products per (query, key) tile instead of 4, for no spill.
#pragma once

#include "flash_bias.cuh"

namespace {

// What one launch of the dk/dv kernel computes.
enum DkvOut : int { kDkDv = 0, kDvOnly = 1, kDkOnly = 2 };

// How many launches compute dk and dv at head dim kD.
template <int kD>
constexpr int kDkvPasses = kD <= 64 ? 1 : 2;

template <int kD, int kForm>
struct DkvSmem {
  bf16 k[kTileElems<kD>];
  bf16 v[kTileElems<kD>];
  bf16 q[kTileElems<kD>];
  bf16 o[kTileElems<kD>];
  float l[kTile];
  float dl[kTile];
  BiasSmem<kForm> sb;
};
static_assert(sizeof(DkvSmem<64, kBiasNone>) == 37380 &&
                  sizeof(DkvSmem<64, kBiasTable>) == 38912 &&
                  sizeof(DkvSmem<128, kBiasNone>) == 70148 &&
                  sizeof(DkvSmem<128, kBiasTable>) == 71680,
              "dk/dv's dynamic shared memory at d 64 and d 128");

template <int kD, int kForm, int kOut>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int h, int sq, int sk,
                     BshdStrides qs, BshdStrides ks, BshdStrides vs,
                     BshdStrides dos, BshdStrides dks, float scale,
                     int causal, BiasArgs ba) {
  constexpr bool kDk = kOut != kDvOnly, kDv = kOut != kDkOnly;
  auto& sm = dyn_smem<DkvSmem<kD, kForm>>();
  bf16* sK = sm.k;
  bf16* sV = sm.v;
  bf16* sQ = sm.q;
  bf16* sO = sm.o;
  float* sL = sm.l;
  float* sDl = sm.dl;
  BiasSmem<kForm>& sb = sm.sb;

  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile<kD>(sK, k + bb * ks.b + k0 * ks.s + hh * kD, ks.s, tid);
  if constexpr (kDk)
    load_tile<kD>(sV, v + bb * vs.b + k0 * vs.s + hh * kD, vs.s, tid);
  load_table_row<kForm>(sb, ba, hh, tid);
  __syncthreads();
  constexpr bool kHold = kD <= 64;
  const AFrags<kD, kHold> kf(sK, warp * 16, g, t);
  const AFrags<kD, kHold && kDk> vf(sV, warp * 16, g, t);
  const float* lp = lse + ((long long)bb * h + hh) * sq;
  const float* dlp = delta + ((long long)bb * h + hh) * sq;
  const float* dense = dense_head<kForm>(ba, hh, sq, sk);

  // each launch sizes only the accumulators it writes
  float dka[kDk ? kD / 8 : 1][4], dva[kDv ? kD / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    if constexpr (kDk) dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    if constexpr (kDv) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int nqt = sq / kTile;
  for (int qt = causal ? k0 / kTile : 0; qt < nqt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<kD>(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
    load_tile<kD>(sO, dout + bb * dos.b + q0 * dos.s + hh * kD, dos.s, tid);
    if (tid < kTile) {
      sL[tid] = lp[q0 + tid];
      if constexpr (kDk) sDl[tid] = dlp[q0 + tid];
    }
    load_strip<kForm>(sb, ba, q0, k0, sq, tid);
    __syncthreads();

    float st[kTile / 8][4], dpt[kDk ? kTile / 8 : 1][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      if constexpr (kDk)
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t ka[4], va[4];
      kf.get(ka, kk);
      if constexpr (kDk) vf.get(va, kk);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk<kD>(b, sQ, n * 8, kk * 16, g, t);
        mma16816(st[n], ka, b);
        if constexpr (kDk) {
          load_b_nk<kD>(b, sO, n * 8, kk * 16, g, t);
          mma16816(dpt[n], va, b);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = n * 8 + 2 * t + (i & 1);
        float p;
        if constexpr (kForm == kBiasNone) {
          p = expf(st[n][i] * scale - sL[qi]);
        } else {
          p = expf(biased(st[n][i], scale,
                          bias_at<kForm>(sb, dense, sk, q0 + qi,
                                         key[i >> 1], qi,
                                         key[i >> 1] - k0)) -
                   sL[qi]);
        }
        if (causal && q0 + qi < key[i >> 1]) p = 0.f;
        st[n][i] = p;
        if constexpr (kDk) dpt[n][i] = p * (dpt[n][i] - sDl[qi]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], da[4];
      if constexpr (kDv) c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      if constexpr (kDk) c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        if constexpr (kDv) {
          load_b_kn<kD>(b, sO, kk * 16, n * 8, g, t);
          mma16816(dva[n], pa, b);
        }
        if constexpr (kDk) {
          load_b_kn<kD>(b, sQ, kk * 16, n * 8, g, t);
          mma16816(dka[n], da, b);
        }
      }
    }
  }

  bf16* kp = dk + bb * dks.b + hh * kD;
  bf16* vp = dv + bb * dks.b + hh * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kDk)
        *reinterpret_cast<uint32_t*>(kp + key[r] * dks.s + col) =
            pack_f32(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      if constexpr (kDv)
        *reinterpret_cast<uint32_t*>(vp + key[r] * dks.s + col) =
            pack_f32(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int kD, int kForm, int kOut>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const float* lse,
                       const float* delta, bf16* dk, bf16* dv, int b, int h,
                       int sq, int sk, BshdStrides qs, BshdStrides ks,
                       BshdStrides vs, BshdStrides dos, float scale,
                       int causal, const BiasArgs& ba, cudaStream_t stream) {
  constexpr int kSmem = sizeof(DkvSmem<kD, kForm>);
  const cudaError_t attr =
      smem_attr(flash_bwd_dkv_kernel<kD, kForm, kOut>, kSmem);
  if (attr != cudaSuccess) return attr;
  const long long row = static_cast<long long>(h) * kD;
  flash_bwd_dkv_kernel<kD, kForm, kOut>
      <<<dim3(sk / kTile, h, b), kThreads, kSmem, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, h, sq, sk, qs, ks, vs, dos,
          BshdStrides{sk * row, row}, scale, causal, ba);
  return cudaGetLastError();
}

// dk and dv at head dim kD in bias form kForm: one launch at d 64, the dv
// launch then the dk launch at d 128 (the register plan above).
template <int kD, int kForm>
cudaError_t launch_dkv_all(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int b,
                           int h, int sq, int sk, BshdStrides qs,
                           BshdStrides ks, BshdStrides vs, BshdStrides dos,
                           float scale, int causal, const BiasArgs& ba,
                           cudaStream_t stream) {
  const auto* q_ = static_cast<const bf16*>(q);
  const auto* k_ = static_cast<const bf16*>(k);
  const auto* v_ = static_cast<const bf16*>(v);
  const auto* o_ = static_cast<const bf16*>(dout);
  const auto* l_ = static_cast<const float*>(lse);
  const auto* dl_ = static_cast<const float*>(delta);
  auto* dk_ = static_cast<bf16*>(dk);
  auto* dv_ = static_cast<bf16*>(dv);
  if constexpr (kDkvPasses<kD> == 1) {
    return launch_dkv<kD, kForm, kDkDv>(q_, k_, v_, o_, l_, dl_, dk_, dv_, b,
                                        h, sq, sk, qs, ks, vs, dos, scale,
                                        causal, ba, stream);
  } else {
    const cudaError_t err = launch_dkv<kD, kForm, kDvOnly>(
        q_, k_, v_, o_, l_, dl_, dk_, dv_, b, h, sq, sk, qs, ks, vs, dos,
        scale, causal, ba, stream);
    if (err != cudaSuccess) return err;
    return launch_dkv<kD, kForm, kDkOnly>(q_, k_, v_, o_, l_, dl_, dk_, dv_,
                                          b, h, sq, sk, qs, ks, vs, dos,
                                          scale, causal, ba, stream);
  }
}

}  // namespace
