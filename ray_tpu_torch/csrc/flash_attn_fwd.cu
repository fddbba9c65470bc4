// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel`, launched by `_flash_fwd`
// (ray_tpu/ops/pallas/flash_attention.py:55-145). It computes the same
// function: causal or full attention over [B, S, H, D] tensors, an online
// softmax with f32 accumulator, running max m and denominator l carried
// across kv tiles, masked entries given p = 0, o = acc / max(l, 1e-37) in
// q's type and lse = m + log(max(l, 1e-37)) as f32 [B, H, S, 1].
//
// What bounds it on an H100: at the serving shape (B=8, S=1024, H=16,
// D=128, bf16, causal) the work is about 34 GFLOP against about 134 MB of
// q/k/v/o, so the least time is set by the bytes (~40 us at 3.35 TB/s) with
// the tensor-core time (~35 us at 989 TFLOP/s) close behind. The kernel must
// read q, k and v about once, keep the [S, S] scores on chip and keep the
// tensor cores fed while tiles load.
//
// What the design does about it (fwd_wgmma_kernel, bf16):
// - one block per (b*h, 128-row q tile), the blocks of one (b, h) adjacent
//   in a 1-d grid so that they run together and share its k and v in L2;
//   within a head the heaviest causal tiles come first. The kv loop lives
//   in the block and, when causal, stops at the diagonal;
//   only tiles that cross the diagonal or the ragged end are masked, by
//   index;
// - warp specialisation: a producer warpgroup, whose one working thread
//   issues TMA loads of the q tile once and of 128-row k and v tiles into
//   3-stage rings guarded by mbarriers (full: bytes landed; empty: every
//   consumer warp done with the tile), refilling a stage as soon as both
//   consumers have released it, so loads run ahead of the products. It
//   gives its registers back (setmaxnreg to 24) and the two consumer
//   warpgroups take them (240 each), which the pipelined products need;
// - two consumer warpgroups of 64 q rows each: S = q k^T by wgmma with both
//   operands in shared memory (K-major), the online softmax on the f32
//   accumulator in registers with exp2 and log2(e) * scale folded into one
//   multiply-add, P packed to bf16 straight into the A registers of
//   O += P v, a register-sourced wgmma reading v transposed (MN-major) by
//   its descriptor. Inside a warpgroup S of the next kv tile is issued
//   before P v of this one, so the softmax overlaps a product;
// - the tensor maps read the [B, S, H, D] strides directly (no transposes;
//   the kv head is h / (H / Hkv), what repeat_interleave gives); rows past
//   S arrive as zeros and are masked by index; o goes out through shared
//   memory by one TMA store per warpgroup, and o and lse rows past Sq are
//   not written.
// The q scale is applied to the f32 scores after the bf16 product: that is
// (q*scale).k computed in f32 without rounding q*scale to bf16.
// f32 inputs take a second, scalar kernel (no tensor cores) that keeps the
// reference's f32 arithmetic; it is not on the serving path.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // f32 kernel

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

constexpr int kFwdBM = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kFwdBN = 128;  // kv rows per tile
constexpr int kFwdStages = 3;
// Rows of the q, k, v and o boxes, in the order of the wrapper's maps: o
// leaves 64 rows (one consumer warpgroup's) a store.
constexpr int kFwdBoxRows[4] = {kFwdBM, kFwdBN, kFwdBN, kFwdBM / 2};

struct TmaParams {
  CUtensorMap q, k, v, o;
  float* lse;
  int H, Hkv, Sq, Sk;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// Dynamic shared memory: the q tile, then the k tiles and the v tiles of
// the stages, plus room to align the start to 1024 bytes.
constexpr int fwd_smem_bytes(int D) {
  return kFwdBM * D * 2 + 2 * kFwdStages * kFwdBN * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(hopper::kWsThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ TmaParams p) {
  using namespace hopper;
  constexpr int BM = kFwdBM, BN = kFwdBN, ST = kFwdStages;
  constexpr int KV_BYTES = BN * D * 2;  // one k or v tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full_k[ST], full_v[ST], empty_k[ST], empty_v[ST];
  uint8_t* const qs = smem_raw + align_1024(smem_u32(smem_raw));
  uint8_t* const ks = qs + BM * D * 2;
  uint8_t* const vs = ks + ST * KV_BYTES;

  // Blocks of one (b, h) are adjacent, so they run together and share its k
  // and v through L2; within them, the heaviest causal q tiles come first.
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
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_k[st], 8);
      mbar_init(&empty_v[st], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Producer warpgroup: one thread loads the q tile, then k and v tile j
  // into stage j % ST as soon as both consumers have released tile j - ST.
  // It alone waits with a timeout (see mbar_wait_or_trap).
  if (warpgroup() == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar_q, BM * D * 2);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(qs + c * BM * 128, &p.q, &bar_q, c * 64, q0, h, b);
      auto load = [&](uint8_t* ring, const CUtensorMap* map, uint64_t* full, int j) {
        const int st = j % ST;
        mbar_expect_tx(&full[st], KV_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(ring + st * KV_BYTES + c * BN * 128, map, &full[st], c * 64, j * BN, hk, b);
      };
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t released = ((j / ST) & 1) ^ 1;  // parity of tile j - ST's release
        if (j >= ST) mbar_wait_or_trap(&empty_k[j % ST], released);
        load(ks, &p.k, full_k, j);
        if (j >= ST) mbar_wait_or_trap(&empty_v[j % ST], released);
        load(vs, &p.v, full_v, j);
      }
      // Until the consumers have used every tile, trapping if they never do.
      mbar_wait_or_trap(&bar_q, 0);
      for (int j = max(0, n_tiles - ST); j < n_tiles; ++j) {
        mbar_wait_or_trap(&empty_k[j % ST], (j / ST) & 1);
        mbar_wait_or_trap(&empty_v[j % ST], (j / ST) & 1);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup cw owns q rows [q0 + 64 cw, q0 + 64 cw + 64).
  const int cw = warpgroup() - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int row0 = q0 + 64 * cw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const uint32_t q_base = smem_u32(qs) + cw * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};  // running max of the scores times scale * log2(e)
  float l[2] = {0.f, 0.f};               // this thread's share of the denominators

  // S = q k^T for kv tile j: 64 rows x BN columns, D / 16 steps.
  auto issue_s = [&](float (&sc)[BN / 2], int j) {
    const uint32_t k_base = smem_u32(ks + (j % ST) * KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;  // 16-deep step inside a 64-column box
      Wgmma<BN>::template ss<0>(sc, desc_sw128(q_base + (kk / 4) * BM * 128 + step, 16, 1024),
                                desc_sw128(k_base + (kk / 4) * BN * 128 + step, 16, 1024), kk > 0);
    }
  };
  // O += P v for kv tile j, v read transposed (MN-major): 16 kv rows are
  // 2048 bytes, 64-column boxes are BN * 128 bytes apart.
  auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], int j) {
    const uint32_t v_base = smem_u32(vs + (j % ST) * KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      Wgmma<D>::template rs<1>(o, pa[kk], desc_sw128(v_base + kk * 2048, BN * 128, 1024), 1);
    }
  };
  auto wait_k = [&](int j) { mbar_wait(&full_k[j % ST], (j / ST) & 1); };
  auto wait_v = [&](int j) { mbar_wait(&full_v[j % ST], (j / ST) & 1); };
  // This warp is done with tile j's k (or v).
  auto release_k = [&](int j) {
    if (lane == 0) mbar_arrive(&empty_k[j % ST]);
  };
  auto release_v = [&](int j) {
    if (lane == 0) mbar_arrive(&empty_v[j % ST]);
  };
  // Mask kv tile j by index where it crosses the end or the diagonal, fold
  // it into the running max and denominators (log2 domain) and turn the
  // scores into P in place. corr is the factor the output takes before P v
  // of this tile is added.
  auto softmax = [&](float (&sc)[BN / 2], int j, float (&corr)[2]) {
    const int k0 = j * BN;
    if (k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > q0 + 64 * cw)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * c4 + (i & 1);
        const int row = row0 + 8 * ((i / 2) & 1);
        if (col >= p.Sk || (p.causal && col > row)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m2[r], mx[r] * p.scale_log2);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
      corr[r] = exp2f(m2[r] - m_use[r]);
      m2[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i / 2) & 1;
      sc[i] = exp2f(fmaf(sc[i], p.scale_log2, -m_use[r]));
      l[r] += sc[i];
    }
  };
  // P as A fragments: columns [16kk, 16kk + 16) of the accumulator.
  auto pack = [&](const float (&sc)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }
  };

  // Software pipeline inside the warpgroup (FlashAttention-3's order): S of
  // tile j is issued ahead of P v of tile j - 1, and the softmax of tile j
  // runs while P v is on the tensor cores. The output takes each tile's
  // rescale just before that tile's P v is issued.
  float sc[BN / 2], corr[2];
  uint32_t pa[BN / 16][4];
  mbar_wait(&bar_q, 0);
  wait_k(0);
  wgmma_fence();
  issue_s(sc, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  release_k(0);
  softmax(sc, 0, corr);
  pack(sc, pa);
  for (int j = 1; j < n_tiles; ++j) {
    wait_k(j);
    wgmma_fence();
    issue_s(sc, j);
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) & 1];
    wait_v(j - 1);
    wgmma_fence();
    issue_pv(pa, j - 1);
    wgmma_commit();
    fence_regs(o);
    wgmma_wait<1>();  // S of tile j has landed; P v of tile j - 1 may still run
    fence_regs(sc);
    release_k(j);
    softmax(sc, j, corr);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);  // read by the product until here
    release_v(j - 1);
    pack(sc, pa);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) & 1];
  wait_v(n_tiles - 1);
  wgmma_fence();
  issue_pv(pa, n_tiles - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  release_v(n_tiles - 1);  // for the producer's last wait

  // The output goes through this warpgroup's rows of the q tile, which its
  // last product has finished reading: each thread writes its bf16 pairs in
  // the tile's 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)),
  // then one thread stores the 64 rows by TMA; rows past Sq are not written.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float l_safe = fmaxf(lr, 1e-37f);
    const float inv = 1.f / l_safe;
    const int tr = 64 * cw + 16 * warp + g + 8 * r;  // row within the q tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint8_t* const row = qs + (n / 8) * BM * 128 + tr * 128;
      *reinterpret_cast<uint32_t*>(row + (((n % 8) ^ (tr % 8)) * 16) + 4 * c4) =
          pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    // lse = m + log(l) in natural log: m2 and log2(l) are in log2 units.
    if (c4 == 0 && q0 + tr < p.Sq) {
      p.lse[(long long)bh * p.Sq + q0 + tr] = (m2[r] + log2f(l_safe)) * 0.69314718055994531f;
    }
  }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (t == 0) {
    for (int c = 0; c < D / 64; ++c)
      tma_store_4d(&p.o, qs + c * BM * 128 + cw * 64 * 128, c * 64, q0 + 64 * cw, h, b);
    tma_store_wait();
  }
}

template <int D>
int launch_fwd_bf16(const Params& a, const long long* maps, cudaStream_t stream) {
  using namespace hopper;
  // maps: q, k, v, o, then the block count; the boxes must be the ones the
  // kernel reads (kFwdBoxRows) and the count the grid it decodes.
  const long long blocks = (long long)a.B * a.H * ((a.Sq + kFwdBM - 1) / kFwdBM);
  if (maps == nullptr || !boxes_match(maps, kFwdBoxRows, 4, D) || maps[4 * kMapArgs] != blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TmaParams p;
  if (encode_bf16_map(&p.q, a.q, maps) || encode_bf16_map(&p.k, a.k, maps + kMapArgs) ||
      encode_bf16_map(&p.v, a.v, maps + 2 * kMapArgs) ||
      encode_bf16_map(&p.o, a.o, maps + 3 * kMapArgs)) {
    return kEncodeFailed;
  }
  p.lse = a.lse;
  p.H = a.H;
  p.Hkv = a.Hkv;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  constexpr int smem = fwd_smem_bytes(D);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = set_smem_once(fwd_wgmma_kernel<D>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_wgmma_kernel<D><<<(unsigned)blocks, kWsThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
// (0 on success), hopper::kEncodeFailed when the CUDA driver refuses a tensor
// map, or cudaErrorInvalidValue for a type, head dim or layout the kernels
// are not built for. dtype: 0 = bf16, 1 = f32. Strides are in elements, for
// [B, S, H, D] tensors; lse is a contiguous f32 [B, H, Sq]. bf16 also takes
// `maps`: hopper::kMapArgs values for each of q, k, v and o (dims, byte
// strides, box), as the wrapper computes them, then the block count; f32
// ignores it.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int dtype, int B, int H, int Hkv, int Sq, int Sk, int D,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              const long long* maps, float scale, int causal, void* stream) {
  Params p{q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Sq, Sk,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale, causal};
  if (B == 0 || H == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_fwd_bf16<128>(p, maps, s);
  if (dtype == 0 && D == 64) return launch_fwd_bf16<64>(p, maps, s);
  const dim3 grid(B * H, (Sq + 15) / 16);
  if (dtype == 1 && D == 128) {
    fwd_f32_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 1 && D == 64) {
    fwd_f32_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the bf16 kernel at head dim D, for reports.
extern "C" int flash_attn_fwd_smem_bytes(int D) { return fwd_smem_bytes(D); }

// What the wrapper builds the bf16 kernel's maps and grid from: the rows of
// the q, k, v and o boxes (the first is the q tile of a block), then the
// boxes' widest column count.
extern "C" void flash_attn_fwd_tiles(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = kFwdBoxRows[i];
  out[4] = hopper::kBoxCols;
}
