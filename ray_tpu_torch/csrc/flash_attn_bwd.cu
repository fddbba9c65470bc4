// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, dq (B2) and dk/dv (B3).
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`, launched
// by `_flash_bwd` (ray_tpu/ops/pallas/flash_attention.py:151-319). They
// compute the same functions from q, k, v, dO (all [B, S, H, D]), lse and
// delta = rowsum(dO * O) (both f32 [B, H, Sq]):
//   P  = exp(q_s k^T - lse), q_s = q * scale, causal entries (k > q) 0;
//   dS = P * (dO v^T - delta);
//   B2: dq = scale * dS k;           one f32 accumulator across kv tiles;
//   B3: dv = P^T dO, dk = dS^T q_s;  two f32 accumulators across q tiles.
// delta is computed outside the kernels, as the JAX package computes it
// outside Pallas. GQA: q head h reads kv head h / (H / Hkv); B3 sums dk and
// dv over the group's q heads inside the block (deterministic, no atomics),
// which is what autodiff of the repeated kv gives.
//
// What bounds them on an H100: at the training shape (B=16, S=1024, H=16,
// D=128, bf16, causal) B2 does three products over the 524,800 visible
// (q, k) pairs of each head (103 GFLOP, ~0.104 ms at 989 TFLOP/s) against
// ~338 MB of traffic (~0.101 ms at 3.35 TB/s); B3 does four (138 GFLOP,
// ~0.139 ms) against ~405 MB (~0.121 ms). Both are bound by operations, so
// the products must run on the tensor cores and the [S, S] matrices P, dP
// and dS must stay on chip.
//
// What the design does about it:
// - B2: one block per (b*h, 64-row q tile), 4 warps of 16 q rows; the q and
//   dO fragments stay in registers for the whole kv loop, 64-row k and v
//   tiles pass through shared memory, and the causal loop stops at the
//   diagonal. The heaviest causal q tiles are scheduled first.
// - B3: one block per (b*h_kv, 64-row kv tile), 4 warps of 16 kv rows; k and
//   v stay in shared memory, 64-row q and dO tiles stream through it (70 KB
//   of dynamic shared memory at D=128), and the causal loop starts at the
//   diagonal. dk and dv are stored once, dk times the scale.
// - Every product (q k^T, dO v^T, dS k, P^T dO, dS^T q) runs on the tensor
//   cores with mma.sync m16n8k16 bf16 and f32 accumulation. The lse is known,
//   so P needs no running max: each warp works through 16-column chunks of
//   the score tile, and a chunk's P and dS go from the score accumulators
//   straight into the next product as A fragments (bf16), never through
//   shared or device memory.
// - The q scale is applied to the f32 scores after the bf16 product, as in
//   the forward kernel; dq takes the scale once at the end, and B3's dk
//   takes it once at the end for q_s.
// - Ragged rows and columns are masked by index, never by the -1e30 trick:
//   rows past Sq have no lse, columns past Sk hold no data.
// f32 inputs take scalar kernels (no tensor cores) that keep the
// reference's f32 arithmetic; they are not on the training path.
// Not yet done (later work): cp.async/TMA pipelining, ldmatrix, wgmma.

#include "bf16_mma.cuh"

namespace {

using flash::load_a;
using flash::load_b_kn;
using flash::load_b_nk;
using flash::load_tile;
using flash::mma_bf16;
using flash::pack_bf16;

constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------- bf16 ----

// B2: dq for one (b*h, 64-row q tile).
template <int D>
__global__ void __launch_bounds__(kThreads) dq_bf16_kernel(const Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;
  constexpr int KC = D / 16;  // 16-deep chunks of the head dim
  constexpr int ND = D / 8;   // 8-wide column tiles of dq
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the q tile

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // q and dO tiles -> registers (staged through the k and v buffers).
  load_tile<BQ, D, LD, kThreads>(ks, qg, p.q_ss, q0, p.Sq);
  load_tile<BQ, D, LD, kThreads>(vs, dog, p.do_ss, q0, p.Sq);
  __syncthreads();
  uint32_t qf[KC][4], dof[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    load_a<LD>(qf[kc], ks, wr, kc * 16, g, t);
    load_a<LD>(dof[kc], vs, wr, kc * 16, g, t);
  }
  __syncthreads();

  // This thread's rows are row0 and row0 + 8.
  const int row0 = q0 + wr + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const long long at = (long long)bh * p.Sq + row;
    lse_r[i] = row < p.Sq ? p.lse[at] : 0.f;
    delta_r[i] = row < p.Sq ? p.delta[at] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int last_row = q0 + wr + 15;  // this warp's last q row
  const bool rows_ragged = q0 + wr + 16 > p.Sq;
  const int kv_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    load_tile<BK, D, LD, kThreads>(ks, kg, p.k_ss, k0, p.Sk);
    load_tile<BK, D, LD, kThreads>(vs, vg, p.v_ss, k0, p.Sk);
    __syncthreads();

    for (int j = 0; j < BK; j += 16) {
      const int c0 = k0 + j;  // first kv column of this chunk
      // Later chunks are past the end too, or above this warp's diagonal.
      if (c0 >= p.Sk || (p.causal && c0 > last_row)) break;
      // s = q k^T and dp = dO v^T for 16 rows x 16 columns.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t b0, b1;
          load_b_nk<LD>(b0, b1, ks, j + n * 8, kc * 16, g, t);
          mma_bf16(s[n], qf[kc], b0, b1);
          load_b_nk<LD>(b0, b1, vs, j + n * 8, kc * 16, g, t);
          mma_bf16(dp[n], dof[kc], b0, b1);
        }
      }
      const bool edge = rows_ragged || c0 + 16 > p.Sk || (p.causal && c0 + 15 > q0 + wr);
      // ds = p * (dp - delta), written over s.
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pe = expf(s[n][e] * p.scale - lse_r[i]);
          if (edge) {
            const int col = c0 + n * 8 + t * 2 + (e & 1);
            const int row = row0 + i * 8;
            if (row >= p.Sq || col >= p.Sk || (p.causal && col > row)) pe = 0.f;
          }
          s[n][e] = pe * (dp[n][e] - delta_r[i]);
        }
      }
      // acc += ds k: the chunk's 16 kv columns are the product's depth.
      uint32_t a[4];
      a[0] = pack_bf16(s[0][0], s[0][1]);
      a[1] = pack_bf16(s[0][2], s[0][3]);
      a[2] = pack_bf16(s[1][0], s[1][1]);
      a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        load_b_kn<LD>(b0, b1, ks, j, n * 8, g, t);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row < p.Sq) {
      __nv_bfloat16* out = dqg + (long long)row * p.dq_ss + t * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            pack_bf16(acc[n][2 * i] * p.scale, acc[n][2 * i + 1] * p.scale);
      }
    }
  }
}

// Dynamic shared memory of dkv_bf16_kernel: k, v, q and dO tiles of 64 rows
// (row stride D + 8), then lse and delta of the q tile.
constexpr int dkv_bf16_smem(int D) { return 4 * 64 * (D + 8) * 2 + 2 * 64 * 4; }

// B3: dk and dv for one (b*h_kv, 64-row kv tile).
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_bf16_kernel(const Params p) {
  constexpr int BK = 64, BQ = 64, LD = D + 8;
  constexpr int KC = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BK * LD;
  __nv_bfloat16* qs = vs + BK * LD;
  __nv_bfloat16* dos = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);
  float* delta_s = lse_s + BQ;

  const int bhk = blockIdx.x;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;  // causal: the first kv tiles see the most q tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the kv tile

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<BK, D, LD, kThreads>(ks, kg, p.k_ss, k0, p.Sk);
  load_tile<BK, D, LD, kThreads>(vs, vg, p.v_ss, k0, p.Sk);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }

  const int krow0 = k0 + wr + g;  // this thread's kv rows: krow0, krow0 + 8
  const bool rows_ragged = k0 + wr + 16 > p.Sk;
  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const __nv_bfloat16* dog =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    const long long stat0 = ((long long)b * p.H + hq) * p.Sq;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BQ) {
      __syncthreads();  // the previous q tile's readers are done
      load_tile<BQ, D, LD, kThreads>(qs, qg, p.q_ss, q0, p.Sq);
      load_tile<BQ, D, LD, kThreads>(dos, dog, p.do_ss, q0, p.Sq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        lse_s[i] = in ? p.lse[stat0 + q0 + i] : 0.f;
        delta_s[i] = in ? p.delta[stat0 + q0 + i] : 0.f;
      }
      __syncthreads();

      for (int j = 0; j < BQ; j += 16) {
        const int c0 = q0 + j;  // first q row of this chunk
        if (c0 >= p.Sq) break;
        // Every q row of the chunk precedes every kv row of this warp.
        if (p.causal && c0 + 15 < k0 + wr) continue;
        // s^T = k q^T and dp^T = v dO^T for 16 kv rows x 16 q columns.
        float s[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t ka[4], va[4];
          load_a<LD>(ka, ks, wr, kc * 16, g, t);
          load_a<LD>(va, vs, wr, kc * 16, g, t);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t b0, b1;
            load_b_nk<LD>(b0, b1, qs, j + n * 8, kc * 16, g, t);
            mma_bf16(s[n], ka, b0, b1);
            load_b_nk<LD>(b0, b1, dos, j + n * 8, kc * 16, g, t);
            mma_bf16(dp[n], va, b0, b1);
          }
        }
        const bool edge = rows_ragged || c0 + 16 > p.Sq || (p.causal && c0 < k0 + wr + 15);
        // p^T into s, ds^T = p^T * (dp^T - delta) into dp.
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = j + n * 8 + t * 2 + (e & 1);  // q row within the tile
            float pe = expf(s[n][e] * p.scale - lse_s[jj]);
            if (edge) {
              const int qrow = q0 + jj;
              const int krow = krow0 + (e >> 1) * 8;
              if (qrow >= p.Sq || krow >= p.Sk || (p.causal && qrow < krow)) pe = 0.f;
            }
            s[n][e] = pe;
            dp[n][e] = pe * (dp[n][e] - delta_s[jj]);
          }
        }
        // dv += p^T dO and dk += ds^T q: the chunk's 16 q rows are the depth.
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(s[0][0], s[0][1]);
        pa[1] = pack_bf16(s[0][2], s[0][3]);
        pa[2] = pack_bf16(s[1][0], s[1][1]);
        pa[3] = pack_bf16(s[1][2], s[1][3]);
        da[0] = pack_bf16(dp[0][0], dp[0][1]);
        da[1] = pack_bf16(dp[0][2], dp[0][3]);
        da[2] = pack_bf16(dp[1][0], dp[1][1]);
        da[3] = pack_bf16(dp[1][2], dp[1][3]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          load_b_kn<LD>(b0, b1, dos, j, n * 8, g, t);
          mma_bf16(dv[n], pa, b0, b1);
          load_b_kn<LD>(b0, b1, qs, j, n * 8, g, t);
          mma_bf16(dk[n], da, b0, b1);
        }
      }
    }
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = krow0 + i * 8;
    if (row < p.Sk) {
      __nv_bfloat16* dko = dkg + (long long)row * p.dk_ss + t * 2;
      __nv_bfloat16* dvo = dvg + (long long)row * p.dv_ss + t * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(dko + n * 8) =
            pack_bf16(dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvo + n * 8) = pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ----

// Scalar f32 B2: one block per (b*h, 16-row q tile), 16-row kv tiles in
// shared memory, the reference's arithmetic (q pre-scaled in f32). Each
// thread owns dq entries tid, tid + 128, ... of the tile.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const Params p) {
  constexpr int BQ = 16, BK = 16, NA = BQ * D / kThreads;
  __shared__ float qs[BQ][D];
  __shared__ float dos[BQ][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float dss[BQ][BK + 1];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < p.Sq;
    qs[r][c] = in ? qg[(long long)(q0 + r) * p.q_ss + c] * p.scale : 0.f;
    dos[r][c] = in ? dog[(long long)(q0 + r) * p.do_ss + c] : 0.f;
  }
  if (tid < BQ) {
    const bool in = q0 + tid < p.Sq;
    lse_s[tid] = in ? p.lse[(long long)bh * p.Sq + q0 + tid] : 0.f;
    delta_s[tid] = in ? p.delta[(long long)bh * p.Sq + q0 + tid] : 0.f;
  }
  float acc[NA];
#pragma unroll
  for (int n = 0; n < NA; ++n) acc[n] = 0.f;

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
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[r][d], ks[c][d], s);
        dp = fmaf(dos[r][d], vs[c][d], dp);
      }
      const int row = q0 + r, col = k0 + c;
      const bool visible = row < p.Sq && col < p.Sk && !(p.causal && col > row);
      const float pe = visible ? expf(s - lse_s[r]) : 0.f;
      dss[r][c] = pe * (dp - delta_s[r]);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const int i = tid + n * kThreads;
      const int r = i / D, c = i % D;
      float a = acc[n];
      for (int j = 0; j < BK; ++j) a = fmaf(dss[r][j], ks[j][c], a);
      acc[n] = a;
    }
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / D, c = i % D;
    if (q0 + r < p.Sq) dqg[(long long)(q0 + r) * p.dq_ss + c] = acc[n] * p.scale;
  }
}

// Scalar f32 B3: one block per (b*h_kv, 16-row kv tile), looping over the
// group's q heads and 16-row q tiles. Each thread owns dk and dv entries
// tid, tid + 128, ... of the tile.
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(const Params p) {
  constexpr int BK = 16, BQ = 16, NA = BK * D / kThreads;
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float qs[BQ][D + 1];  // q * scale
  __shared__ float dos[BQ][D + 1];
  __shared__ float ps[BQ][BK + 1];   // p, [q][kv]
  __shared__ float dss[BQ][BK + 1];  // ds, [q][kv]
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bhk = blockIdx.x;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int i = tid; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < p.Sk;
    ks[r][c] = in ? kg[(long long)(k0 + r) * p.k_ss + c] : 0.f;
    vs[r][c] = in ? vg[(long long)(k0 + r) * p.v_ss + c] : 0.f;
  }
  float dk[NA], dv[NA];
#pragma unroll
  for (int n = 0; n < NA; ++n) dk[n] = dv[n] = 0.f;

  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    const long long stat0 = ((long long)b * p.H + hq) * p.Sq;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BQ) {
      __syncthreads();
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const bool in = q0 + r < p.Sq;
        qs[r][c] = in ? qg[(long long)(q0 + r) * p.q_ss + c] * p.scale : 0.f;
        dos[r][c] = in ? dog[(long long)(q0 + r) * p.do_ss + c] : 0.f;
      }
      if (tid < BQ) {
        const bool in = q0 + tid < p.Sq;
        lse_s[tid] = in ? p.lse[stat0 + q0 + tid] : 0.f;
        delta_s[tid] = in ? p.delta[stat0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < BQ * BK; i += kThreads) {
        const int r = i / BK, c = i % BK;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[r][d], ks[c][d], s);
          dp = fmaf(dos[r][d], vs[c][d], dp);
        }
        const int row = q0 + r, col = k0 + c;
        const bool visible = row < p.Sq && col < p.Sk && !(p.causal && col > row);
        const float pe = visible ? expf(s - lse_s[r]) : 0.f;
        ps[r][c] = pe;
        dss[r][c] = pe * (dp - delta_s[r]);
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < NA; ++n) {
        const int i = tid + n * kThreads;
        const int r = i / D, c = i % D;
        float a = dv[n], e = dk[n];
        for (int j = 0; j < BQ; ++j) {
          a = fmaf(ps[j][r], dos[j][c], a);
          e = fmaf(dss[j][r], qs[j][c], e);
        }
        dv[n] = a;
        dk[n] = e;
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  float* dvg = static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / D, c = i % D;
    if (k0 + r < p.Sk) {
      dkg[(long long)(k0 + r) * p.dk_ss + c] = dk[n];
      dvg[(long long)(k0 + r) * p.dv_ss + c] = dv[n];
    }
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv,
                   int B, int H, int Hkv, int Sq, int Sk, const long long* strides,
                   float scale, int causal) {
  // strides: q, k, v, dO, dq, dk, dv, three each (batch, seq, head).
  const long long* s = strides;
  return Params{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                dq, dk, dv, B, H, Hkv, Sq, Sk,
                s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
                s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20],
                scale, causal};
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() right
// after the launch (0 on success), or cudaErrorInvalidValue for a type or
// head dim the kernels are not built for. dtype: 0 = bf16, 1 = f32. q, k,
// v, dO, dq, dk and dv are [B, S, H, D] with the element strides in
// `strides` (21 values: q, k, v, dO, dq, dk, dv, each batch, seq, head);
// lse and delta are contiguous f32 [B, H, Sq].

// B2: writes dq.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int dtype, int B,
                                 int H, int Hkv, int Sq, int Sk, int D, const long long* strides,
                                 float scale, int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Hkv, Sq, Sk,
                               strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bq = dtype == 0 ? 64 : 16;
  const dim3 grid(B * H, (Sq + bq - 1) / bq);
  if (dtype == 0 && D == 128) {
    dq_bf16_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0 && D == 64) {
    dq_bf16_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 128) {
    dq_f32_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 64) {
    dq_f32_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_dkv_bf16(const Params& p, dim3 grid, cudaStream_t s) {
  constexpr int smem = dkv_bf16_smem(D);
  const cudaError_t err = cudaFuncSetAttribute(
      dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_bf16_kernel<D><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// B3: writes dk and dv.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
                                  const long long* strides, float scale, int causal,
                                  void* stream) {
  if (B == 0 || Hkv == 0 || Sk == 0) return 0;
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv, Sq, Sk,
                               strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bk = dtype == 0 ? 64 : 16;
  const dim3 grid(B * Hkv, (Sk + bk - 1) / bk);
  if (dtype == 0 && D == 128) return launch_dkv_bf16<128>(p, grid, s);
  if (dtype == 0 && D == 64) return launch_dkv_bf16<64>(p, grid, s);
  if (dtype == 1 && D == 128) {
    dkv_f32_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 64) {
    dkv_f32_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
