// Fused flash-attention backward for Hopper (sm_90a): (q, k, v, dO, lse)
// -> (dq, dk, dv), with no `out` input.
//
// Replaces the Pallas kernel
// byteps_tpu/ops/flash_attention.py::_dqkv_fused_kernel (wrapper
// _flash_bwd_fused, pallas_call at :564), the backward the flagship step
// takes when the whole sequence is one block per (batch, head).
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
// Both recompute S and dP from q, k, v, dO on the tensor cores
// (mma.sync.m16n8k16, bf16 x bf16 -> fp32); S, P and dP never reach device
// memory. The recompute costs 9 products where the function needs 5: the
// price of needing no atomics and no [s, s] buffer.
#include "mma_bf16.cuh"

namespace {

// (a): delta and dq for one 64-query tile.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int h, int sq, int sk,
                    BshdStrides qs, BshdStrides ks, BshdStrides vs,
                    BshdStrides dos, BshdStrides dqs, float scale,
                    int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLD];
  __shared__ __align__(16) bf16 sO[kTile * kLD];
  __shared__ __align__(16) bf16 sK[kTile * kLD];
  __shared__ __align__(16) bf16 sV[kTile * kLD];

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
  load_tile(sO, dout + bb * dos.b + q0 * dos.s + hh * kD, dos.s, tid);
  __syncthreads();
  uint32_t qf[kD / 16][4], of[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a(qf[kk], sQ, warp * 16, kk * 16, g, t);
    load_a(of[kk], sO, warp * 16, kk * 16, g, t);
  }
  const float* lp = lse + ((long long)bb * h + hh) * sq;
  const float lse_r[2] = {lp[row[0]], lp[row[1]]};

  int nkt = sk / kTile;
  if (causal) nkt = min(nkt, (q0 + kTile - 1) / kTile + 1);

  float s[kTile / 8][4], dp[kTile / 8][4];
  // S and dP of key tile kt for this warp's 16 rows; P = exp(S - lse)
  // replaces S in place, masked entries 0.
  auto scores = [&](int kt) {
    __syncthreads();
    load_tile(sK, k + bb * ks.b + (long long)kt * kTile * ks.s + hh * kD, ks.s, tid);
    load_tile(sV, v + bb * vs.b + (long long)kt * kTile * vs.s + hh * kD, vs.s, tid);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, sK, n * 8, kk * 16, g, t);
        mma16816(s[n], qf[kk], b);
        load_b_nk(b, sV, n * 8, kk * 16, g, t);
        mma16816(dp[n], of[kk], b);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = kt * kTile + n * 8 + 2 * t + (i & 1);
        float p = expf(s[n][i] * scale - lse_r[r]);
        if (causal && row[r] < col) p = 0.f;
        s[n][i] = p;
      }
    }
  };

  float dsum[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    scores(kt);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dsum[i >> 1] += s[n][i] * dp[n][i];
    }
  }
  const float dl[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};
  if (t == 0) {
    float* dlp = delta + ((long long)bb * h + hh) * sq;
    dlp[row[0]] = dl[0];
    dlp[row[1]] = dl[1];
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    scores(kt);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= dp[n][i] - dl[i >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, sK, kk * 16, n * 8, g, t);
        mma16816(acc[n], da, b);
      }
    }
  }

  bf16* gp = dq + bb * dqs.b + hh * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(gp + row[0] * dqs.s + col) =
        pack_f32(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(gp + row[1] * dqs.s + col) =
        pack_f32(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// (b): dk and dv for one 64-key tile. Rows of every product are keys:
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ come out of the tensor cores
// already in the A layout of dv += Pᵀ·dO and dk += dSᵀ·Q.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int h, int sq, int sk,
                     BshdStrides qs, BshdStrides ks, BshdStrides vs,
                     BshdStrides dos, BshdStrides dks, float scale,
                     int causal) {
  __shared__ __align__(16) bf16 sK[kTile * kLD];
  __shared__ __align__(16) bf16 sV[kTile * kLD];
  __shared__ __align__(16) bf16 sQ[kTile * kLD];
  __shared__ __align__(16) bf16 sO[kTile * kLD];
  __shared__ float sL[kTile], sDl[kTile];

  const int kt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile(sK, k + bb * ks.b + k0 * ks.s + hh * kD, ks.s, tid);
  load_tile(sV, v + bb * vs.b + k0 * vs.s + hh * kD, vs.s, tid);
  __syncthreads();
  uint32_t kf[kD / 16][4], vf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a(kf[kk], sK, warp * 16, kk * 16, g, t);
    load_a(vf[kk], sV, warp * 16, kk * 16, g, t);
  }
  const float* lp = lse + ((long long)bb * h + hh) * sq;
  const float* dlp = delta + ((long long)bb * h + hh) * sq;

  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int nqt = sq / kTile;
  for (int qt = causal ? k0 / kTile : 0; qt < nqt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
    load_tile(sO, dout + bb * dos.b + q0 * dos.s + hh * kD, dos.s, tid);
    if (tid < kTile) {
      sL[tid] = lp[q0 + tid];
      sDl[tid] = dlp[q0 + tid];
    }
    __syncthreads();

    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, sQ, n * 8, kk * 16, g, t);
        mma16816(st[n], kf[kk], b);
        load_b_nk(b, sO, n * 8, kk * 16, g, t);
        mma16816(dpt[n], vf[kk], b);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = n * 8 + 2 * t + (i & 1);
        float p = expf(st[n][i] * scale - sL[qi]);
        if (causal && q0 + qi < key[i >> 1]) p = 0.f;
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - sDl[qi]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, sO, kk * 16, n * 8, g, t);
        mma16816(dva[n], pa, b);
        load_b_kn(b, sQ, kk * 16, n * 8, g, t);
        mma16816(dka[n], da, b);
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
      *reinterpret_cast<uint32_t*>(kp + key[r] * dks.s + col) =
          pack_f32(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vp + key[r] * dks.s + col) =
          pack_f32(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

}  // namespace

// Launches (a) then (b) on `stream`, allocates nothing (`delta` is the
// caller's [b, h, sq] fp32 scratch; dq is [b, sq, h, d] and dk/dv are
// [b, sk, h, d], all contiguous); returns cudaGetLastError().
extern "C" int bps_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, void* delta,
                             void* dq, void* dk, void* dv, int b, int h,
                             int sq, int sk, int d, long long q_sb,
                             long long q_ss, long long k_sb, long long k_ss,
                             long long v_sb, long long v_ss, long long do_sb,
                             long long do_ss, float scale, int causal,
                             void* stream) {
  if (d != kD || sq % kTile != 0 || sk % kTile != 0 || b <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BshdStrides qs{q_sb, q_ss}, ks{k_sb, k_ss}, vs{v_sb, v_ss},
      dos{do_sb, do_ss};
  const long long row = static_cast<long long>(h) * kD;
  flash_bwd_dq_kernel<<<dim3(sq / kTile, h, b), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq), h, sq, sk, qs, ks, vs, dos,
      BshdStrides{sq * row, row}, scale, causal);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<dim3(sk / kTile, h, b), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, sq, sk, qs, ks, vs,
      dos, BshdStrides{sk * row, row}, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
