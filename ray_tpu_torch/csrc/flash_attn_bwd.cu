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
// What the design does about it: both bf16 kernels are warp-specialised
// blocks of 384 threads. A producer warpgroup gives its registers back
// (setmaxnreg to 24); its one working thread loads the block's fixed tiles
// once by TMA and streams 64-row tiles of the other operands through a
// 3-stage ring guarded by mbarriers (full: the bytes have landed; empty:
// every consumer warp is done with the stage), so loads run ahead of the
// products. Two consumer warpgroups take the registers (240 each) and run
// every product on wgmma, 64 rows each. Blocks that share the streamed
// operands are adjacent in a 1-d grid, so they run together and share them
// through L2, and the heaviest causal tiles come first.
// - B2 (dq_wgmma_kernel): one block per (b*h, 128-row q tile), q and dO
//   loaded once, k and v streamed; the causal loop stops at the diagonal
//   and a warpgroup skips (but releases) a tile wholly above its rows.
//   lse and delta are fixed per q row, so each thread keeps its two rows'
//   in registers. Per kv tile: S = q k^T and dP = dO v^T by wgmma from
//   shared memory (K-major); dS = P (dP - delta) with
//   P = exp2(S * scale * log2(e) - lse * log2(e)) (no running max: lse is
//   known), packed to bf16 A fragments straight from the accumulator; then
//   dq += dS k with k read transposed (MN-major) from the same tile. Inside
//   a warpgroup S and dP of the next tile are issued ahead of dS k of this
//   one, so dS is formed while a product runs. dq takes the scale once at
//   the store.
// - B3 (dkv_wgmma_kernel): one block per (b*h_kv, 128-row kv tile), k and
//   v loaded once, q and dO streamed; the causal loop starts at the
//   diagonal; a warpgroup skips a tile wholly above its rows. Each
//   warpgroup copies the next q tile's lse and delta into shared memory by
//   cp.async while it works on this one. Per q tile: S^T = k q^T by wgmma
//   from shared memory (K-major);
//   P^T = exp2(S^T * scale * log2(e) - lse * log2(e)); dP^T = v dO^T and
//   dv += P^T dO issued together; then dS^T = P^T (dP^T - delta) while dv
//   runs, and dk += dS^T q. P^T and dS^T go to bf16 A registers straight
//   from the accumulators, and dO and q are read transposed (MN-major) from
//   the same shared tiles. GQA: the block loops over the group's q heads
//   (deterministic, no atomics). dk takes the scale once at the store.
// - The q scale is applied to the f32 scores after the bf16 product, as in
//   the forward kernel.
// - Ragged rows and columns are masked by index, never by the -1e30 trick:
//   rows past Sq have no lse, columns past Sk hold no data (TMA reads them
//   as zeros).
// f32 inputs take scalar kernels (no tensor cores) that keep the
// reference's f32 arithmetic; they are not on the training path.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // f32 kernels

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

constexpr int kDqBM = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kDqBN = 64;   // kv rows per streamed tile
constexpr int kDqStages = 3;
// Rows of the q, k, v and dO boxes, in the order of the wrapper's maps.
constexpr int kDqBoxRows[4] = {kDqBM, kDqBN, kDqBN, kDqBM};

struct DqTmaParams {
  CUtensorMap q, k, v, dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;
  int H, Hkv, Sq, Sk;
  long long dq_sb, dq_ss, dq_sh;
  float scale, scale_log2;  // scale_log2 = scale * log2(e)
  int causal;
};

// Dynamic shared memory of dq_wgmma_kernel: the q and dO tiles, then the k
// and v tiles of each stage, plus room to align the start to 1024 bytes.
constexpr int dq_smem_bytes(int D) {
  return 2 * kDqBM * D * 2 + kDqStages * 2 * kDqBN * D * 2 + 1024;
}

// B2: dq for one (b*h, 128-row q tile).
template <int D>
__global__ void __launch_bounds__(hopper::kWsThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ DqTmaParams p) {
  using namespace hopper;
  constexpr int BM = kDqBM, BN = kDqBN, ST = kDqStages;
  constexpr int Q_BYTES = BM * D * 2;   // q or dO
  constexpr int KV_BYTES = BN * D * 2;  // one k or v tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[ST], bar_empty[ST];
  uint8_t* const qs = smem_raw + align_1024(smem_u32(smem_raw));
  uint8_t* const dos = qs + Q_BYTES;
  uint8_t* const stages = dos + Q_BYTES;  // k then v, per stage

  // Blocks of one (b, h_kv) are adjacent (the group's q heads, then the q
  // tiles of each), so they share its k and v through L2; within a head the
  // heaviest causal q tiles come first.
  const int q_tiles = (p.Sq + BM - 1) / BM;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * BM;
  const int kv_end = p.causal ? min(p.Sk, q0 + BM) : p.Sk;
  const int n_tiles = (kv_end + BN - 1) / BN;

  // full: the tile's bytes have landed; empty: lane 0 of each of the 8
  // consumer warps is done with it.
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(&bar_full[st], 1);
      mbar_init(&bar_empty[st], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Producer warpgroup: one thread loads q and dO, then k and v tile j into
  // stage j % ST as soon as both consumers have released tile j - ST. It
  // alone waits with a timeout (see mbar_wait_or_trap).
  if (warpgroup() == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar_q, 2 * Q_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(qs + c * BM * 128, &p.q, &bar_q, c * 64, q0, h, b);
        tma_load_4d(dos + c * BM * 128, &p.dout, &bar_q, c * 64, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        uint8_t* const dst = stages + st * 2 * KV_BYTES;
        if (j >= ST) mbar_wait_or_trap(&bar_empty[st], ((j / ST) & 1) ^ 1);  // j - ST released
        mbar_expect_tx(&bar_full[st], 2 * KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(dst + c * BN * 128, &p.k, &bar_full[st], c * 64, j * BN, hk, b);
          tma_load_4d(dst + KV_BYTES + c * BN * 128, &p.v, &bar_full[st], c * 64, j * BN, hk, b);
        }
      }
      // Until the consumers have used every tile, trapping if they never do.
      mbar_wait_or_trap(&bar_q, 0);
      for (int j = max(0, n_tiles - ST); j < n_tiles; ++j)
        mbar_wait_or_trap(&bar_empty[j % ST], (j / ST) & 1);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup cw owns q rows [wq0, wq0 + 64).
  const int cw = warpgroup() - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int wq0 = q0 + 64 * cw;
  const int row0 = wq0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const uint32_t q_base = smem_u32(qs) + cw * 64 * 128;
  const uint32_t do_base = smem_u32(dos) + cw * 64 * 128;
  // The tiles this warpgroup computes: none past its last row when causal,
  // none at all when its rows are past Sq (they are never stored).
  const int n_mine =
      wq0 >= p.Sq ? 0 : p.causal ? min(n_tiles, (wq0 + 63) / BN + 1) : n_tiles;

  // lse (in log2 units) and delta of this thread's two rows; rows past Sq
  // read zeros (their q and dO rows are zeros too).
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = (long long)bh * p.Sq + row;
    lse2[r] = row < p.Sq ? p.lse[at] * 1.4426950408889634f : 0.f;
    del[r] = row < p.Sq ? p.delta[at] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];
  uint32_t da[BN / 16][4];

  auto k_base = [&](int j) { return smem_u32(stages + (j % ST) * 2 * KV_BYTES); };
  // S = q k^T and dP = dO v^T for kv tile j: 64 rows x BN columns each.
  auto issue_s_dp = [&](int j) {
    const uint32_t kb = k_base(j), vb = kb + KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;  // 16-deep step inside a 64-column box
      Wgmma<BN>::template ss<0>(sc, desc_sw128(q_base + (kk / 4) * BM * 128 + step, 16, 1024),
                                desc_sw128(kb + (kk / 4) * BN * 128 + step, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;
      Wgmma<BN>::template ss<0>(dp, desc_sw128(do_base + (kk / 4) * BM * 128 + step, 16, 1024),
                                desc_sw128(vb + (kk / 4) * BN * 128 + step, 16, 1024), kk > 0);
    }
  };
  // dq += dS k for kv tile j, k read transposed (MN-major): 16 kv rows are
  // 2048 bytes, 64-column boxes BN * 128 bytes apart.
  auto issue_dq = [&](int j) {
    const uint32_t kb = k_base(j);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      Wgmma<D>::template rs<1>(dq, da[kk], desc_sw128(kb + kk * 2048, BN * 128, 1024), 1);
    }
  };
  // dS = P (dP - delta) in place of S, P masked by index where tile j
  // crosses the end or the diagonal.
  auto form_ds = [&](int j) {
    const int k0 = j * BN;
    const bool edge = k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > wq0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i / 2) & 1;
      float pe = exp2f(fmaf(sc[i], p.scale_log2, -lse2[r]));
      if (edge) {
        const int col = k0 + 8 * (i / 4) + 2 * c4 + (i & 1);
        if (col >= p.Sk || (p.causal && col > row0 + 8 * r)) pe = 0.f;
      }
      sc[i] = pe * (dp[i] - del[r]);
    }
  };
  // dS as A fragments: columns [16kk, 16kk + 16) of the accumulator.
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) da[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }
  };
  auto wait_full = [&](int j) { mbar_wait(&bar_full[j % ST], (j / ST) & 1); };
  // This warp is done with tile j's k and v.
  auto release = [&](int j) {
    if (lane == 0) mbar_arrive(&bar_empty[j % ST]);
  };

  // Software pipeline inside the warpgroup: S and dP of tile j are issued
  // ahead of dS k of tile j - 1, and dS of tile j is formed while that
  // product runs.
  mbar_wait(&bar_q, 0);
  if (n_mine > 0) {
    wait_full(0);
    wgmma_fence();
    issue_s_dp(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    form_ds(0);
    pack();
    for (int j = 1; j < n_mine; ++j) {
      wait_full(j);
      wgmma_fence();
      issue_s_dp(j);
      wgmma_commit();
      issue_dq(j - 1);
      wgmma_commit();
      fence_regs(dq);
      wgmma_wait<1>();  // S and dP of tile j have landed; dS k of tile j - 1 may still run
      fence_regs(sc);
      fence_regs(dp);
      form_ds(j);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);  // read by the product until here
      release(j - 1);
      pack();
    }
    wgmma_fence();
    issue_dq(n_mine - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    release(n_mine - 1);
  }
  // Tiles wholly above this warpgroup's rows: released unread once landed,
  // so that the producer's accounting of the stage holds.
  for (int j = n_mine; j < n_tiles; ++j) {
    wait_full(j);
    release(j);
  }

  // dq rows past Sq are not written.
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.Sq) {
      __nv_bfloat16* out = dqg + (long long)row * p.dq_ss + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            pack_bf16(dq[4 * n + 2 * r] * p.scale, dq[4 * n + 2 * r + 1] * p.scale);
      }
    }
  }
}

constexpr int kDkvBN = 128;  // kv rows per block: two warpgroups of 64
constexpr int kDkvBM = 64;   // q rows per streamed tile
constexpr int kDkvStages = 3;
// Rows of the q, k, v and dO boxes, in the order of the wrapper's maps.
constexpr int kDkvBoxRows[4] = {kDkvBM, kDkvBN, kDkvBN, kDkvBM};

struct DkvTmaParams {
  CUtensorMap q, k, v, dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sk;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale, scale_log2;
  int causal;
};

// Dynamic shared memory of dkv_wgmma_kernel: k and v tiles, then the q and
// dO tiles of each stage, plus room to align the start to 1024 bytes.
constexpr int dkv_smem_bytes(int D) {
  return 2 * kDkvBN * D * 2 + kDkvStages * 2 * kDkvBM * D * 2 + 1024;
}

// B3: dk and dv for one (b*h_kv, 128-row kv tile).
template <int D>
__global__ void __launch_bounds__(hopper::kWsThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ DkvTmaParams p) {
  using namespace hopper;
  constexpr int BN = kDkvBN, BM = kDkvBM, ST = kDkvStages;
  constexpr int KV_BYTES = BN * D * 2;  // k or v
  constexpr int Q_BYTES = BM * D * 2;   // one q or dO tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_full[ST], bar_empty[ST];
  // lse (natural log) and delta of a q tile, per warpgroup, double buffered.
  __shared__ __align__(16) float stats[2][2][2][BM];  // [warpgroup][buffer][lse, delta][row]
  uint8_t* const ks = smem_raw + align_1024(smem_u32(smem_raw));
  uint8_t* const vs = ks + KV_BYTES;
  uint8_t* const stages = vs + KV_BYTES;  // q then dO, per stage

  // Blocks of one (b, h_kv) are adjacent, so they run together and share
  // its q and dO through L2; within them, the first kv tiles see the most
  // causal q tiles and come first.
  const int kv_tiles = (p.Sk + BN - 1) / BN;
  const int bhk = blockIdx.x / kv_tiles;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = (blockIdx.x % kv_tiles) * BN;
  const int q_begin = p.causal ? (k0 / BM) * BM : 0;
  const int q_tiles = p.Sq > q_begin ? (p.Sq - q_begin + BM - 1) / BM : 0;
  const int n_tiles = group * q_tiles;  // the group's q heads, q tiles within each

  // full: the tile's bytes have landed; empty: lane 0 of each of the 8
  // consumer warps is done with it.
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(&bar_full[st], 1);
      mbar_init(&bar_empty[st], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Producer warpgroup: one thread loads k and v, then q and dO tile `it`
  // into stage it % ST as soon as both consumers have released tile it - ST.
  // It alone waits with a timeout (see mbar_wait_or_trap).
  if (warpgroup() == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar_kv, 2 * KV_BYTES);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(ks + c * BN * 128, &p.k, &bar_kv, c * 64, k0, hk, b);
        tma_load_4d(vs + c * BN * 128, &p.v, &bar_kv, c * 64, k0, hk, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % ST;
        const int hq = hk * group + it / q_tiles;
        const int q0 = q_begin + (it % q_tiles) * BM;
        uint8_t* const dst = stages + st * 2 * Q_BYTES;
        if (it >= ST) mbar_wait_or_trap(&bar_empty[st], ((it / ST) & 1) ^ 1);  // it - ST released
        mbar_expect_tx(&bar_full[st], 2 * Q_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(dst + c * BM * 128, &p.q, &bar_full[st], c * 64, q0, hq, b);
          tma_load_4d(dst + Q_BYTES + c * BM * 128, &p.dout, &bar_full[st], c * 64, q0, hq, b);
        }
      }
      // Until the consumers have used every tile, trapping if they never do.
      mbar_wait_or_trap(&bar_kv, 0);
      for (int it = max(0, n_tiles - ST); it < n_tiles; ++it)
        mbar_wait_or_trap(&bar_empty[it % ST], (it / ST) & 1);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup cw owns kv rows [kv0, kv0 + 64).
  const int cw = warpgroup() - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int kv0 = k0 + 64 * cw;
  const int krow0 = kv0 + 16 * warp + g;  // this thread's kv rows: krow0, krow0 + 8

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_base = smem_u32(ks) + cw * 64 * 128;
  const uint32_t v_base = smem_u32(vs) + cw * 64 * 128;
  // Each warpgroup copies the lse and delta of q tile `it` into its buffer
  // it % 2, a tile ahead (thread t: row t % 64 of lse, then of delta);
  // rows past Sq read as zeros.
  auto fetch_stats = [&](int it) {
    const int hq = hk * group + it / q_tiles;
    const int row = q_begin + (it % q_tiles) * BM + t % BM;
    const float* src = (t < BM ? p.lse : p.delta) + ((long long)b * p.H + hq) * p.Sq;
    cp_async_4(&stats[cw][it % 2][t / BM][t % BM], src + (row < p.Sq ? row : 0),
               row < p.Sq ? 4 : 0);
  };
  if (n_tiles > 0) fetch_stats(0);
  mbar_wait(&bar_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % ST;
    const int q0 = q_begin + (it % q_tiles) * BM;
    const uint32_t q_base = smem_u32(stages + st * 2 * Q_BYTES), do_base = q_base + Q_BYTES;
    // This tile's lse and delta have landed for the whole warpgroup, which
    // is also done reading the other buffer: fetch the next tile's into it.
    cp_async_wait();
    named_barrier(1 + cw, 128);
    if (it + 1 < n_tiles) fetch_stats(it + 1);
    const float* const lse_s = stats[cw][it % 2][0];
    const float* const delta_s = stats[cw][it % 2][1];
    mbar_wait(&bar_full[st], (it / ST) & 1);

    // Every q row of the tile precedes every kv row of this warpgroup.
    if (!(p.causal && q0 + BM - 1 < kv0)) {
      // S^T = k q^T: 64 kv rows x 64 q columns.
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;  // 16-deep step inside a 64-column box
        Wgmma<64>::ss<0>(sc, desc_sw128(k_base + (kk / 4) * BN * 128 + step, 16, 1024),
                         desc_sw128(q_base + (kk / 4) * BM * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // P^T in place, and packed to bf16 A fragments (16 q columns a step).
      const bool edge = q0 + BM > p.Sq || (p.causal && q0 < kv0 + 63);
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        // This thread's q columns 8 (i / 4) + 2 c4 and the next one.
        const float2 lse = *reinterpret_cast<const float2*>(lse_s + 8 * (i / 4) + 2 * c4);
        float p0 = exp2f(fmaf(sc[i], p.scale_log2, -lse.x * 1.4426950408889634f));
        float p1 = exp2f(fmaf(sc[i + 1], p.scale_log2, -lse.y * 1.4426950408889634f));
        if (edge) {
          const int qrow = q0 + 8 * (i / 4) + 2 * c4, krow = krow0 + 8 * ((i / 2) & 1);
          if (qrow >= p.Sq || (p.causal && qrow < krow)) p0 = 0.f;
          if (qrow + 1 >= p.Sq || (p.causal && qrow + 1 < krow)) p1 = 0.f;
        }
        sc[i] = p0;
        sc[i + 1] = p1;
        // Accumulator pair i / 2 is register (i / 2) % 4 of step i / 8.
        pa[i / 8][(i / 2) % 4] = pack_bf16(p0, p1);
      }

      // dP^T = v dO^T and dv += P^T dO: dO read transposed (MN-major), 16 q
      // rows are 2048 bytes, 64-column boxes BM * 128 bytes apart.
      float dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        Wgmma<64>::ss<0>(dp, desc_sw128(v_base + (kk / 4) * BN * 128 + step, 16, 1024),
                         desc_sw128(do_base + (kk / 4) * BM * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        Wgmma<D>::template rs<1>(dv, pa[kk], desc_sw128(do_base + kk * 2048, BM * 128, 1024), 1);
      }
      wgmma_commit();
      fence_regs(dv);
      wgmma_wait<1>();  // dP^T has landed; the dv product may still run
      fence_regs(dp);

      // dS^T = P^T (dP^T - delta), packed; then dk += dS^T q, q transposed.
      uint32_t da[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 del = *reinterpret_cast<const float2*>(delta_s + 8 * (i / 4) + 2 * c4);
        da[i / 8][(i / 2) % 4] =
            pack_bf16(sc[i] * (dp[i] - del.x), sc[i + 1] * (dp[i + 1] - del.y));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        Wgmma<D>::template rs<1>(dk, da[kk], desc_sw128(q_base + kk * 2048, BM * 128, 1024), 1);
      }
      wgmma_commit();
      fence_regs(dk);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);  // read by the products until here
      fence_regs(da);
    }
    if (lane == 0) mbar_arrive(&bar_empty[st]);
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + 8 * r;
    if (row < p.Sk) {
      __nv_bfloat16* dko = dkg + (long long)row * p.dk_ss + 2 * c4;
      __nv_bfloat16* dvo = dvg + (long long)row * p.dv_ss + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dko + n * 8) =
            pack_bf16(dk[4 * n + 2 * r] * p.scale, dk[4 * n + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvo + n * 8) =
            pack_bf16(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
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

// The wrapper's maps of a bf16 kernel (q, k, v and dO, hopper::kMapArgs
// values each, then the block count) encoded into `q`, `k`, `v` and `dout`.
// Returns 0; cudaErrorInvalidValue when the boxes are not the kernel's
// (`rows`) or the count is not the grid it decodes (`blocks`);
// hopper::kEncodeFailed when the CUDA driver refuses a map.
int encode_inputs(const Params& a, const long long* maps, const int* rows, int D,
                  long long blocks, CUtensorMap* q, CUtensorMap* k, CUtensorMap* v,
                  CUtensorMap* dout) {
  using namespace hopper;
  if (maps == nullptr || !boxes_match(maps, rows, 4, D) || maps[4 * kMapArgs] != blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_bf16_map(q, a.q, maps) || encode_bf16_map(k, a.k, maps + kMapArgs) ||
      encode_bf16_map(v, a.v, maps + 2 * kMapArgs) ||
      encode_bf16_map(dout, a.dout, maps + 3 * kMapArgs)) {
    return kEncodeFailed;
  }
  return 0;
}

template <int D>
int launch_dq_bf16(const Params& a, const long long* maps, cudaStream_t stream) {
  using namespace hopper;
  const long long blocks = (long long)a.B * a.H * ((a.Sq + kDqBM - 1) / kDqBM);
  DqTmaParams p;
  const int bad = encode_inputs(a, maps, kDqBoxRows, D, blocks, &p.q, &p.k, &p.v, &p.dout);
  if (bad) return bad;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = a.dq;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.dq_sb = a.dq_sb;
  p.dq_ss = a.dq_ss;
  p.dq_sh = a.dq_sh;
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  constexpr int smem = dq_smem_bytes(D);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = set_smem_once(dq_wgmma_kernel<D>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_wgmma_kernel<D><<<(unsigned)blocks, kWsThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const Params& a, const long long* maps, cudaStream_t stream) {
  using namespace hopper;
  const long long blocks = (long long)a.B * a.Hkv * ((a.Sk + kDkvBN - 1) / kDkvBN);
  DkvTmaParams p;
  const int bad = encode_inputs(a, maps, kDkvBoxRows, D, blocks, &p.q, &p.k, &p.v, &p.dout);
  if (bad) return bad;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dk = a.dk;
  p.dv = a.dv;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.dk_sb = a.dk_sb;
  p.dk_ss = a.dk_ss;
  p.dk_sh = a.dk_sh;
  p.dv_sb = a.dv_sb;
  p.dv_ss = a.dv_ss;
  p.dv_sh = a.dv_sh;
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  constexpr int smem = dkv_smem_bytes(D);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = set_smem_once(dkv_wgmma_kernel<D>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_wgmma_kernel<D><<<(unsigned)blocks, kWsThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() right
// after the launch (0 on success), hopper::kEncodeFailed when the CUDA driver
// refuses a tensor map, or cudaErrorInvalidValue for a type, head dim or
// layout the kernels are not built for. dtype: 0 = bf16, 1 = f32. q, k, v,
// dO, dq, dk and dv are [B, S, H, D] with the element strides in `strides`
// (21 values: q, k, v, dO, dq, dk, dv, each batch, seq, head); lse and
// delta are contiguous f32 [B, H, Sq]. In bf16 both also take `maps`:
// hopper::kMapArgs values for each of q, k, v and dO (dims, byte strides,
// box), as the wrapper computes them, then the block count; f32 ignores it.

// B2: writes dq.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int dtype, int B,
                                 int H, int Hkv, int Sq, int Sk, int D, const long long* strides,
                                 const long long* maps, float scale, int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Hkv, Sq, Sk,
                               strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_dq_bf16<128>(p, maps, s);
  if (dtype == 0 && D == 64) return launch_dq_bf16<64>(p, maps, s);
  const dim3 grid(B * H, (Sq + 15) / 16);
  if (dtype == 1 && D == 128) {
    dq_f32_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 64) {
    dq_f32_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B3: writes dk and dv.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
                                  const long long* strides, const long long* maps, float scale,
                                  int causal, void* stream) {
  if (B == 0 || Hkv == 0 || Sk == 0) return 0;
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv, Sq, Sk,
                               strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_dkv_bf16<128>(p, maps, s);
  if (dtype == 0 && D == 64) return launch_dkv_bf16<64>(p, maps, s);
  const dim3 grid(B * Hkv, (Sk + 15) / 16);
  if (dtype == 1 && D == 128) {
    dkv_f32_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 64) {
    dkv_f32_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the bf16 dq and dk/dv kernels at head dim D, for
// reports.
extern "C" int flash_attn_bwd_dq_smem_bytes(int D) { return dq_smem_bytes(D); }
extern "C" int flash_attn_bwd_dkv_smem_bytes(int D) { return dkv_smem_bytes(D); }

// What the wrapper builds a bf16 kernel's maps and grid from: the rows of
// the q, k, v and dO boxes (for dq the first is the q tile of a block, for
// dk/dv the second is the kv tile of a block), then the boxes' widest
// column count.
extern "C" void flash_attn_bwd_dq_tiles(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = kDqBoxRows[i];
  out[4] = hopper::kBoxCols;
}

extern "C" void flash_attn_bwd_dkv_tiles(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = kDkvBoxRows[i];
  out[4] = hopper::kBoxCols;
}
