// dk and dv of the flash-attention backward for Hopper (sm_90a): one CTA
// per (batch, head, 64-key tile) walks the query tiles and accumulates
// dk = Σ_q dSᵀ·Q·scale and dv = Σ_q bf16(P)ᵀ·dO in registers, reading lse
// and delta ([b, h, sq] fp32) from its inputs. Query tiles wholly above
// the diagonal are skipped under causal masking.
//
// Rows of every product are keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ
// come out of the tensor cores already in the register layout of the A
// operand of dv += Pᵀ·dO and dk += dSᵀ·Q, and never touch shared or
// device memory.
//
// Shared by flash_bwd.cu (the fused backward's second launch, delta from
// its first) and flash_dkv.cu (the split backward's `_dkv_kernel`, delta
// from the caller).
//
// Design (hopper.cuh): the producer warp loads the K and V tiles once and
// streams each query tile's Q and dO tiles, with its 64 lse and delta
// values (a bulk copy each), through a ring of kStages stages by TMA. Per
// query tile the consumer warpgroup issues Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// together (wgmma, all operands K-major in shared memory), forms Pᵀ and
// dSᵀ in registers, and adds Pᵀ·dO and dSᵀ·Q with A from registers and
// dO, Q read MN-major from the tiles that fed the scores. No atomics.
//
// kForm is the bias source (flash_bias.cuh; the fused backward takes no
// bias). Because the accumulators are transposed, the bias of row `key`
// and column `query` is the offset key - query's (the table form's strip
// entry kl - ql + 63, as in the forward) and the dense form reads
// bias[h, query, key]: the column, not the row, picks the bias row.
//
// Head dim kD is a template parameter (64 and 128). Shared memory: the K
// and V tiles and kStages Q/dO pairs with their lse and delta, 49 KB at
// d 64 and 97 KB at d 128. Registers of a consumer thread: the dk and dv
// accumulators (kD fp32 together), Sᵀ and dPᵀ (64 fp32) and their bf16 A
// operands (32). The K, V, Q and dO operands stay in shared memory, where
// wgmma reads them, so both accumulators fit at d 128 too and dk and dv
// are one launch at either width; at d 128 the thread needs more than the
// 168 registers two CTAs of 160 threads leave, so one CTA runs per SM.
#pragma once

#include "flash_bias.cuh"

namespace {

constexpr int kDkvStages = 2;

template <int kD, int kForm>
struct DkvSmem {
  Tile<kD> k;
  Tile<kD> v;
  Tile<kD> q[kDkvStages];
  Tile<kD> o[kDkvStages];
  float l[kDkvStages][kTile];
  float dl[kDkvStages][kTile];
  uint64_t kv_full;
  uint64_t full[kDkvStages];
  uint64_t empty[kDkvStages];
  BiasSmem<kForm> sb;
};

// CTAs per SM the register plan allows (see above).
template <int kD>
constexpr int kDkvBlocks = kD <= 64 ? 2 : 1;

template <int kD, int kForm>
__global__ void __launch_bounds__(kThreads, kDkvBlocks<kD>)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int h, int sq, int sk,
                     BshdStrides dks, float scale, int causal, BiasArgs ba) {
  auto& sm = dyn_smem<DkvSmem<kD, kForm>>();
  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int k0 = kt * kTile;
  const int qt0 = causal ? kt : 0, nqt = sq / kTile;
  const long long head_row = ((long long)bb * h + hh) * sq;

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: lane 0 issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(&sm.kv_full, 2 * kTileBytes<kD>);
      load_tile<kD>(&sm.k, &tk, &sm.kv_full, k0, hh, bb);
      load_tile<kD>(&sm.v, &tv, &sm.kv_full, k0, hh, bb);
      for (int i = 0; i < nqt - qt0; ++i) {
        const int st = i % kDkvStages, q0 = (qt0 + i) * kTile;
        mbar_wait(&sm.empty[st], ((i / kDkvStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st],
                       2 * kTileBytes<kD> + 2 * kTile * sizeof(float));
        load_tile<kD>(&sm.q[st], &tq, &sm.full[st], q0, hh, bb);
        load_tile<kD>(&sm.o[st], &tdo, &sm.full[st], q0, hh, bb);
        bulk_load(sm.l[st], lse + head_row + q0, kTile * sizeof(float),
                  &sm.full[st]);
        bulk_load(sm.dl[st], delta + head_row + q0, kTile * sizeof(float),
                  &sm.full[st]);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  BiasSmem<kForm>& sb = sm.sb;
  load_table_row<kForm>(sb, ba, hh, tid);
  const float* dense = dense_head<kForm>(ba, hh, sq, sk);
  const float scale_l2 = scale * kLog2e;

  float dka[kD / 64][32], dva[kD / 64][32];
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
    for (int j = 0; j < 32; ++j) dka[c][j] = dva[c][j] = 0.f;
  }
  mbar_wait(&sm.kv_full, 0);

  for (int i = 0; i < nqt - qt0; ++i) {
    const int st = i % kDkvStages, q0 = (qt0 + i) * kTile;
    strip_for<kForm>(sb, ba, q0, k0, sq, tid);
    mbar_wait(&sm.full[st], (i / kDkvStages) & 1);

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(s, desc_k(sm.k, kk), desc_k(sm.q[st], kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(dp, desc_k(sm.v, kk), desc_k(sm.o[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_acc(s);
    fence_acc(dp);

    const float* sL = sm.l[st];
    const float* sDl = sm.dl[st];
    const bool diag = causal && q0 == k0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const int qi = (j >> 2) * 8 + 2 * t + (j & 1);
      float p;
      if constexpr (kForm == kBiasNone) {
        p = exp2_sfu(s[j] * scale_l2 - sL[qi] * kLog2e);
      } else {
        p = exp2_sfu(biased(s[j], scale,
                         bias_at<kForm>(sb, dense, sk, q0 + qi, key[r], qi,
                                        key[r] - k0)) *
                      kLog2e -
                  sL[qi] * kLog2e);
      }
      if (diag && q0 + qi < key[r]) p = 0.f;
      s[j] = p;
      dp[j] = p * (dp[j] - sDl[qi]);
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      c_to_a(pa[kk], &s[8 * kk]);
      c_to_a(da[kk], &dp[8 * kk]);
      fence_frag(pa[kk]);
      fence_frag(da[kk]);
    }
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) {
      fence_acc(dva[c]);
      fence_acc(dka[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dva[c], pa[kk], desc_mn(sm.o[st], c, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dka[c], da[kk], desc_mn(sm.q[st], c, kk));
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < kD / 64; ++c) {
      fence_acc(dva[c]);
      fence_acc(dka[c]);
    }
    mbar_arrive(&sm.empty[st]);
  }

  bf16* kp = dk + bb * dks.b + hh * kD;
  bf16* vp = dv + bb * dks.b + hh * kD;
#pragma unroll
  for (int c = 0; c < kD / 64; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = c * 64 + n * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* a = &dka[c][4 * n + 2 * r];
        const float* b = &dva[c][4 * n + 2 * r];
        *reinterpret_cast<uint32_t*>(kp + key[r] * dks.s + col) =
            pack_f32(a[0] * scale, a[1] * scale);
        *reinterpret_cast<uint32_t*>(vp + key[r] * dks.s + col) =
            pack_f32(b[0], b[1]);
      }
    }
  }
}

// dk and dv at head dim kD in bias form kForm: one launch at either width
// (the register plan above); dk and dv are [b, sk, h, d] contiguous.
template <int kD, int kForm>
cudaError_t launch_dkv(const QkvoMaps& m, const void* lse,
                       const void* delta, void* dk, void* dv, int b, int h,
                       int sq, int sk, float scale, int causal,
                       const BiasArgs& ba, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DkvSmem<kD, kForm>>;
  const cudaError_t attr = smem_attr(flash_bwd_dkv_kernel<kD, kForm>, kSmem);
  if (attr != cudaSuccess) return attr;
  const long long row = static_cast<long long>(h) * kD;
  flash_bwd_dkv_kernel<kD, kForm>
      <<<dim3(sk / kTile, h, b), kThreads, kSmem, stream>>>(
          m.q, m.k, m.v, m.o, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), h, sq, sk, BshdStrides{sk * row, row},
          scale, causal, ba);
  return cudaGetLastError();
}

}  // namespace
