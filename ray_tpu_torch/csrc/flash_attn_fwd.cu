// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel`, launched by `_flash_fwd`
// (ray_tpu/ops/pallas/flash_attention.py:55-145). It computes the same
// function: causal or full attention over [B, S, H, D] tensors, an online
// softmax with f32 accumulator, running max m and denominator l carried
// across kv tiles, masked logits set to -1e30 and their p forced to 0,
// o = acc / max(l, 1e-37) in q's type and lse = m + log(max(l, 1e-37)) as
// f32 [B, H, S, 1].
//
// What bounds it on an H100: at the serving shape (B=8, S=1024, H=16,
// D=128, bf16, causal) the work is about 34 GFLOP against about 134 MB of
// q/k/v/o, so the least time is set by the bytes (~40 us at 3.35 TB/s) with
// the tensor-core time (~35 us at 989 TFLOP/s) close behind. The kernel must
// read q, k and v about once and keep the [S, S] scores on chip.
//
// What the design does about it:
// - one block per (b*h, 64-row q tile); the kv loop lives inside the block
//   and, when causal, stops at the diagonal instead of predicating dead
//   tiles. The heaviest causal q tiles are scheduled first;
// - scores and probabilities stay in registers; only 64x(D+8) k and v tiles
//   pass through shared memory (padded rows: conflict-free fragment loads);
// - bf16 products run on the tensor cores with mma.sync m16n8k16 and f32
//   accumulation; each of 4 warps owns 16 q rows, whose q fragments stay in
//   registers for the whole kv loop;
// - strides of the [B, S, H, D] tensors are read directly (no transposes);
//   the kv head is h / (H / Hkv), which is what repeat_interleave gives;
// - ragged lengths are masked in the kernel, so any S works.
// The q scale is applied to the f32 scores after the bf16 product: that is
// (q*scale).k computed in f32 without rounding q*scale to bf16.
// f32 inputs take a second, scalar kernel (no tensor cores) that keeps the
// reference's f32 arithmetic; it is not on the serving path.
// Not yet done (later work): cp.async/TMA double buffering, wgmma, exp2.

#include "bf16_mma.cuh"

namespace {

using flash::ld32;
using flash::load_tile;
using flash::mma_bf16;
using flash::pack_bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------- bf16 ----

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_bf16_kernel(const Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;
  constexpr int KC = D / 16;    // 16-wide chunks of the head dim (QK^T depth)
  constexpr int NS = BK / 8;    // 8-wide column tiles of the scores
  constexpr int NO = D / 8;     // 8-wide column tiles of the output
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int wr = warp * 16;               // this warp's first row in the q tile

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // q tile -> registers (staged through the k buffer).
  load_tile<BQ, D, LD, kThreads>(ks, qg, p.q_ss, q0, p.Sq);
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + t * 2;
    qf[kc][0] = ld32(&ks[(wr + g) * LD + c]);
    qf[kc][1] = ld32(&ks[(wr + g + 8) * LD + c]);
    qf[kc][2] = ld32(&ks[(wr + g) * LD + c + 8]);
    qf[kc][3] = ld32(&ks[(wr + g + 8) * LD + c + 8]);
  }
  __syncthreads();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // Rows g and g + 8 of this warp's 16: running max, and this thread's share
  // of the denominator (the 4 threads of a row group are summed at the end).
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int row0 = q0 + wr + g;

  const int kv_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    load_tile<BK, D, LD, kThreads>(ks, kg, p.k_ss, k0, p.Sk);
    load_tile<BK, D, LD, kThreads>(vs, vg, p.v_ss, k0, p.Sk);
    __syncthreads();

    // s = q k^T for this warp's 16 rows x BK columns.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = &ks[(n * 8 + g) * LD + t * 2];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) mma_bf16(s[n], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    const bool edge = (k0 + BK > p.Sk) || (p.causal && k0 + BK - 1 > q0 + wr);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (edge) {
          const int col = k0 + n * 8 + t * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= p.Sk || (p.causal && col > row)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      corr[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float pe = x <= 0.5f * kNegInf ? 0.f : expf(x - m_run[e >> 1]);
        s[n][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p v: the score accumulators of two adjacent 8-column tiles are
    // exactly the A fragment of one 16-deep chunk.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vr = &vs[(kc * 16 + t * 2) * LD + g];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[LD]);
        const uint32_t b1 = pack_bf16(vc[8 * LD], vc[9 * LD]);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-37f);
    const int row = row0 + i * 8;
    if (row < p.Sq) {
      __nv_bfloat16* orow = og + (long long)row * p.o_ss + t * 2;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
      }
      if (t == 0) p.lse[(long long)bh * p.Sq + row] = m_run[i] + logf(l_safe);
    }
  }
}

// ----------------------------------------------------------------- f32 ----

// Scalar f32 kernel: one block per (b*h, 16-row q tile), 16-row kv tiles in
// shared memory, the reference's arithmetic (q pre-scaled in f32).
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_f32_kernel(const Params p) {
  constexpr int BQ = 16, BK = 16;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ss[BQ][BK + 1];
  __shared__ float acc[BQ][D];
  __shared__ float m_s[BQ], l_s[BQ], c_s[BQ];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < p.Sq ? qg[(long long)(q0 + r) * p.q_ss + c] * p.scale : 0.f;
    acc[r][c] = 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int kv_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Sk;
      ks[r][c] = in ? kg[(long long)(k0 + r) * p.k_ss + c] : 0.f;
      vs[r][c] = in ? vg[(long long)(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) x = fmaf(qs[r][d], ks[c][d], x);
      const int col = k0 + c;
      if (col >= p.Sk || (p.causal && col > q0 + r)) x = kNegInf;
      ss[r][c] = x;
    }
    __syncthreads();
    if (tid < BQ) {
      float mx = kNegInf;
      for (int c = 0; c < BK; ++c) mx = fmaxf(mx, ss[tid][c]);
      const float m_new = fmaxf(m_s[tid], mx);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        const float x = ss[tid][c];
        const float pe = x <= 0.5f * kNegInf ? 0.f : expf(x - m_new);
        ss[tid][c] = pe;
        sum += pe;
      }
      const float corr = expf(m_s[tid] - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();
    for (int i = tid; i < BQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float a = acc[r][c] * c_s[r];
      for (int j = 0; j < BK; ++j) a = fmaf(ss[r][j], vs[j][c], a);
      acc[r][c] = a;
    }
  }
  __syncthreads();

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < p.Sq) og[(long long)(q0 + r) * p.o_ss + c] = acc[r][c] / fmaxf(l_s[r], 1e-37f);
  }
  if (tid < BQ && q0 + tid < p.Sq) {
    p.lse[(long long)bh * p.Sq + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-37f));
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch
// (0 on success), or cudaErrorInvalidValue for a type or head dim the
// kernels are not built for. dtype: 0 = bf16, 1 = f32. Strides are in
// elements, for [B, S, H, D] tensors; lse is a contiguous f32 [B, H, Sq].
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              float scale, int causal, void* stream) {
  Params p{q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Sq, Sk,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale, causal};
  if (B == 0 || H == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bq = dtype == 0 ? 64 : 16;
  const dim3 grid(B * H, (Sq + bq - 1) / bq);
  if (dtype == 0 && D == 128) {
    fwd_bf16_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0 && D == 64) {
    fwd_bf16_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 128) {
    fwd_f32_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 64) {
    fwd_f32_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
