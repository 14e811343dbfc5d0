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
// bit for bit (the two instantiations differ only in the store).
//
// What bounds it on an H100: the function reads q, k, v and writes out
// once, 8·s·d bytes per (batch, head), and does 4·s²·d FLOP, so s / 2
// FLOP per byte whatever d: at seq 512 (BERT-large at d 64 and its dh128
// variant at d 128) about 256, just under the card's ~295 FLOP/byte
// ridge, so the least time is set by memory. The dense bias adds
// 4·h·sq·sk bytes (4 bytes per score, more than q, k and v together at
// s 1024, d 64), and so is bounded by memory at every length; the table
// adds h·nb·4 bytes and one shared-memory read per score. The design keeps
// S and P out of device memory entirely: one CTA of 4 warps per (batch,
// head, 64-query tile) holds its Q fragments in registers, walks the key
// tiles through shared memory, and keeps the running max, sum and the
// output accumulator in registers. Products run on the tensor cores
// through mma.sync.m16n8k16 (bf16 x bf16 -> fp32). wgmma, TMA and a
// pipelined ring of tiles are later work.
//
// Head dim kD is a template parameter, instantiated at 64 and 128. The
// Q, K and V tiles sit in dynamic shared memory: 3 · 64 · (kD + 8) · 2
// bytes, 27,648 at d 64 and 52,224 at d 128, past the 48 KB a kernel may
// declare statically. Registers: each warp holds its 16 rows of Q as A
// fragments (kD / 4 registers), the output accumulator (kD / 2 fp32) and
// one 16 x 64 tile of scores (32 fp32): about 176 at d 128, under the 255
// a thread may hold, so the design is the same at both widths. The fp32
// out is stored straight from the accumulator registers, 8 bytes a lane
// where the bf16 out stores 4: no shared memory and no register is added,
// and the bytes written double (the fp32 out moves 10·s·d bytes per
// (batch, head) instead of 8·s·d, still bounded by memory at seq 512).
#include "flash_bias.cuh"

namespace {

template <int kD, int kForm>
struct FwdSmem {
  bf16 q[kTileElems<kD>];
  bf16 k[kTileElems<kD>];
  bf16 v[kTileElems<kD>];
  BiasSmem<kForm> sb;
};
static_assert(sizeof(FwdSmem<64, kBiasNone>) == 27650 &&
                  sizeof(FwdSmem<64, kBiasTable>) == 29184 &&
                  sizeof(FwdSmem<128, kBiasNone>) == 52226 &&
                  sizeof(FwdSmem<128, kBiasTable>) == 53760,
              "the forward's dynamic shared memory at d 64 and d 128");

// kF32Out: `out` is fp32 (the ring's partial output), else bf16.
template <int kD, int kForm, bool kF32Out>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, void* __restrict__ out,
                 float* __restrict__ lse, int h, int sq, int sk,
                 BshdStrides qs, BshdStrides ks, BshdStrides vs,
                 BshdStrides os, float scale, int causal, BiasArgs ba) {
  auto& sm = dyn_smem<FwdSmem<kD, kForm>>();
  bf16* sQ = sm.q;
  bf16* sK = sm.k;
  bf16* sV = sm.v;
  BiasSmem<kForm>& sb = sm.sb;

  const int qt = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<kD>(sQ, q + bb * qs.b + q0 * qs.s + hh * kD, qs.s, tid);
  load_table_row<kForm>(sb, ba, hh, tid);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    load_a<kD>(qf[kk], sQ, warp * 16, kk * 16, g, t);

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float* dense = dense_head<kForm>(ba, hh, sq, sk);

  int nkt = sk / kTile;
  if (causal) nkt = min(nkt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<kD>(sK, k + bb * ks.b + (long long)kt * kTile * ks.s + hh * kD,
                  ks.s, tid);
    load_tile<kD>(sV, v + bb * vs.b + (long long)kt * kTile * vs.s + hh * kD,
                  vs.s, tid);
    load_strip<kForm>(sb, ba, q0, kt * kTile, sq, tid);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b[2];
        load_b_nk<kD>(b, sK, n * 8, kk * 16, g, t);
        mma16816(s[n], qf[kk], b);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = kt * kTile + n * 8 + 2 * t + (i & 1);
        float x;
        if constexpr (kForm == kBiasNone) {
          x = s[n][i] * scale;
        } else {
          x = biased(s[n][i], scale,
                     bias_at<kForm>(sb, dense, sk, row[r], col, row[r] - q0,
                                    col - kt * kTile));
        }
        if (causal && row[r] < col) x = kNegInf;
        s[n][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[n][i] - m[i >> 1]);
        s[n][i] = p;
        rs[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        uint32_t b[2];
        load_b_kn<kD>(b, sV, kk * 16, n * 8, g, t);
        mma16816(o[n], pa, b);
      }
    }
  }

  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    const float x0 = o[n][0] / lc[0], x1 = o[n][1] / lc[0];
    const float x2 = o[n][2] / lc[1], x3 = o[n][3] / lc[1];
    if constexpr (kF32Out) {
      float* op = static_cast<float*>(out) + bb * os.b + hh * kD;
      *reinterpret_cast<float2*>(op + row[0] * os.s + col) = make_float2(x0, x1);
      *reinterpret_cast<float2*>(op + row[1] * os.s + col) = make_float2(x2, x3);
    } else {
      bf16* op = static_cast<bf16*>(out) + bb * os.b + hh * kD;
      *reinterpret_cast<uint32_t*>(op + row[0] * os.s + col) = pack_f32(x0, x1);
      *reinterpret_cast<uint32_t*>(op + row[1] * os.s + col) = pack_f32(x2, x3);
    }
  }
  if (t == 0) {
    float* lp = lse + ((long long)bb * h + hh) * sq;
    lp[row[0]] = m[0] + logf(lc[0]);
    lp[row[1]] = m[1] + logf(lc[1]);
  }
}

template <int kD, int kForm, bool kF32Out>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int b, int h, int sq, int sk, BshdStrides qs,
                   BshdStrides ks, BshdStrides vs, BshdStrides os,
                   float scale, int causal, const BiasArgs& ba,
                   cudaStream_t stream) {
  constexpr int kSmem = sizeof(FwdSmem<kD, kForm>);
  const cudaError_t attr =
      smem_attr(flash_fwd_kernel<kD, kForm, kF32Out>, kSmem);
  if (attr != cudaSuccess) return attr;
  flash_fwd_kernel<kD, kForm, kF32Out>
      <<<dim3(sq / kTile, h, b), kThreads, kSmem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), out, static_cast<float*>(lse), h, sq,
          sk, qs, ks, vs, os, scale, causal, ba);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing; returns cudaGetLastError().
// `form` is a BiasForm: 0 takes no bias arguments, 1 `bias` ([h, sq, sk]
// fp32), 2 `bucket` ([sq + sk - 1] int32), `table` ([h, nb] fp32) and nb.
// `out_f32` 1 writes `out` as fp32 (no-bias form only), 0 as bf16; the
// out strides are in elements of that type.
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
  const BshdStrides qs{q_sb, q_ss}, ks{k_sb, k_ss}, vs{v_sb, v_ss},
      os{o_sb, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_d(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    if (out_f32)
      return launch<kD, kBiasNone, true>(q, k, v, out, lse, b, h, sq, sk, qs,
                                         ks, vs, os, scale, causal, ba, st);
    return with_form(form, [&](auto F) {
      return launch<kD, decltype(F)::value, false>(
          q, k, v, out, lse, b, h, sq, sk, qs, ks, vs, os, scale, causal, ba,
          st);
    });
  }));
}
