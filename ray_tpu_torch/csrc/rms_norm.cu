// RMSNorm forward and backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package leaves the norm to XLA's
// fusion. The port's plain version is `rms_norm_plain` in
// ray_tpu_torch/models/transformer.py, which the CPU runs: an f32 upcast,
// square, mean, rsqrt, two broadcast products and three casts, each a
// full-size pass, with an f32 copy of the input saved for a backward of
// some eighteen more.
//
// Per row of d elements, with x of type T (bf16 or f32) and the weight w of
// type W (f32 or bf16), the kernels keep the plain version's rounding
// points (T() rounds to T and back to f32):
//   r  = rsqrt(sum(x^2) / d + eps)                 (f32, written to rstd)
//   n  = x * r
//   y  = T( T(n) * T(w) )
// and its gradient:
//   dn = T(dy * T(w))
//   dx = T( r * dn - x * r^3 * sum(dn * x) / d )
//   dw = W( sum over rows of dy * T(n) )           (f32, one rounding)
//
// What bounds them on an H100: bytes. The forward reads x and writes y, 4
// bytes an element in bf16, for some 6 operations; the backward reads x and
// dy and writes dx, 6 bytes, for some 12: about 2 operations a byte, far
// below the ~20 a byte at which the f32 arithmetic would set the time. At
// [16384, 2048] bf16 that is 134 MB forward (40 us at 3.35 TB/s) and 201 MB
// backward (60 us).
//
// What the design does about it:
// - each thread loads and stores 16 bytes of each tensor at a time (8 bf16,
//   or 8 f32 as two 16-byte words), neighbouring threads on neighbouring
//   vectors, and a row's threads keep the row in registers between its
//   reduction and its output, so each byte crosses device memory once;
// - both kernels run a persistent grid that fills the SMs, each row group
//   walking the rows with the next row's loads issued before this row's
//   reduction, so a thread keeps two rows' bytes in flight;
// - a thread reads its columns of the weight once, in the weight's own
//   type (the f32 master in training), and keeps them rounded in
//   registers: no cast of the weight is written or read, and no row reads
//   it again;
// - a row's sum is reduced in f32 by warp shuffles and, across the warps
//   of a row, through shared memory, always in the same order;
// - the row's threads adapt to d, one 16-byte vector of the row each: a
//   power of two below 32 threads for a narrow row (several rows a block),
//   else a multiple of 32 up to 512 (d up to 4096); past that each of up to
//   512 threads holds two vectors, t and t + its row's threads, so that
//   neighbouring threads still read neighbouring bytes (d up to 8192, the
//   width of a 70B decoder); no knob;
// - the backward keeps its columns' dw terms in f32 registers across its
//   rows and writes them once as [groups, d] partials, which a second small
//   launch (`rms_norm_dw`) sums over the groups in a fixed order: no
//   atomics, so the gradients are the same from run to run.
// The wrapper (ray_tpu_torch/ops/cuda/rms_norm.py) checks that x and dy are
// contiguous [rows, d], d a multiple of 8 up to 8192, and every pointer
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kChunk = 8;             // elements of a row a thread holds
constexpr int kMaxRowThreads = 512;   // threads of one row at most
constexpr int kMaxVecs = 2;           // 16-byte vectors of a row a thread holds at most
constexpr int kMaxD = kChunk * kMaxRowThreads * kMaxVecs;
constexpr int kBlockThreads = 256;    // a block's threads where a row has fewer
constexpr int kFwdThreadsPerSm = 2048;  // the persistent grids' threads an SM at most
constexpr int kBwdThreadsPerSm = 1024;  // (the backward's also set its dw partials)
constexpr int kDwCols = 32;           // dw's block: 32 columns x kDwSlices
constexpr int kDwSlices = 16;

// 8 elements of T as 16-byte words, loaded or stored at once.
template <typename T>
struct Vec {
  static constexpr int kWords = static_cast<int>(sizeof(T)) * kChunk / 16;
  uint4 w[kWords];
};

template <typename T>
struct Elems;

template <>
struct Elems<float> {
  __device__ static void unpack(const Vec<float>& v, float* f) {
    const float* s = reinterpret_cast<const float*>(v.w);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) f[i] = s[i];
  }
  __device__ static Vec<float> pack(const float* f) {
    Vec<float> v;
    float* s = reinterpret_cast<float*>(v.w);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) s[i] = f[i];
    return v;
  }
  __device__ static float round(float f) { return f; }
  __device__ static float to(float f) { return f; }
};

template <>
struct Elems<__nv_bfloat16> {
  __device__ static void unpack(const Vec<__nv_bfloat16>& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(v.w);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static Vec<__nv_bfloat16> pack(const float* f) {
    Vec<__nv_bfloat16> v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(v.w);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
  __device__ static float round(float f) { return __bfloat162float(__float2bfloat16_rn(f)); }
  __device__ static __nv_bfloat16 to(float f) { return __float2bfloat16_rn(f); }
};

template <typename T>
__device__ __forceinline__ Vec<T> load(const T* p) {
  Vec<T> v;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < Vec<T>::kWords; ++i) v.w[i] = q[i];
  return v;
}

template <typename T>
__device__ __forceinline__ void store(T* p, const Vec<T>& v) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < Vec<T>::kWords; ++i) q[i] = v.w[i];
}

// The first column of thread t's k-th vector of a row of tpr threads.
__device__ __forceinline__ int column(int t, int k, int tpr) { return (t + k * tpr) * kChunk; }

// This thread's V vectors of a row, or zeros past the rows or past d.
template <typename T, int V>
__device__ __forceinline__ void fetch(const T* base, long long row, long long rows, int d, int t,
                                      int tpr, Vec<T> (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int col = column(t, k, tpr);
    if (row < rows && col < d) {
      v[k] = load(base + row * d + col);
    } else {
#pragma unroll
      for (int i = 0; i < Vec<T>::kWords; ++i) v[k].w[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

// This thread's columns of the weight, read once in W and rounded to T;
// zeros past d.
template <typename T, typename W, int V>
__device__ __forceinline__ void weight_in(const W* w, int d, int t, int tpr,
                                          float (&wt)[V][kChunk]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int col = column(t, k, tpr);
    if (col < d) {
      Vec<W> v;
      const uint4* q = reinterpret_cast<const uint4*>(w + col);
#pragma unroll
      for (int i = 0; i < Vec<W>::kWords; ++i) v.w[i] = __ldg(q + i);
      Elems<W>::unpack(v, wt[k]);
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) wt[k][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) wt[k][j] = Elems<T>::round(wt[k][j]);
  }
}

// The sum of v over the tpr consecutive threads of one row, on each of
// them: tpr is a power of two below 32 (rows share a warp, each on an
// aligned group of lanes) or a multiple of 32 (a row's warps meet in
// `smem`). Every thread of the block calls it together.
__device__ __forceinline__ float row_sum(float v, int tpr, float* smem) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tpr <= 32) return v;
  __syncthreads();  // the last call's readers are done with smem
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = v;
  __syncthreads();
  const int warps = tpr / 32;
  const float* mine = smem + (threadIdx.x / tpr) * warps;
  float s = 0.f;
  for (int i = 0; i < warps; ++i) s += mine[i];
  return s;
}

// Both kernels walk the rows the same way: row group g (rpb of them a
// block, gridDim.x * rpb in all) takes rows g, g + groups, ..., thread t of
// a group the V vectors at columns column(t, k, tpr), k < V. Every thread
// of a block runs the same iterations (row_sum syncs them); a row group
// past the last row computes on zeros and stores nothing. The next row's
// loads are issued before this row's reduction.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(kMaxRowThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                    float* __restrict__ rstd, long long rows, int d, int tpr, float eps) {
  __shared__ float smem[kMaxRowThreads / 32];
  const int t = threadIdx.x % tpr;
  const long long step = static_cast<long long>(gridDim.x) * (blockDim.x / tpr);
  const long long group = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                          threadIdx.x / tpr;
  const float inv_d = 1.f / static_cast<float>(d);
  float wt[V][kChunk];
  weight_in<T, W, V>(w, d, t, tpr, wt);
  Vec<T> xr[V];
  fetch<T, V>(x, group, rows, d, t, tpr, xr);
  for (long long row = group; row - threadIdx.x / tpr < rows; row += step) {
    float v[V][kChunk];
#pragma unroll
    for (int k = 0; k < V; ++k) Elems<T>::unpack(xr[k], v[k]);
    fetch<T, V>(x, row + step, rows, d, t, tpr, xr);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) ss += __fmul_rn(v[k][j], v[k][j]);
    }
    ss = row_sum(ss, tpr, smem);
    if (row >= rows) continue;
    const float r = rsqrtf(__fmul_rn(ss, inv_d) + eps);
    if (rstd != nullptr && t == 0) rstd[row] = r;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int col = column(t, k, tpr);
      if (col >= d) continue;
      float o[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        o[j] = __fmul_rn(Elems<T>::round(__fmul_rn(v[k][j], r)), wt[k][j]);
      store(y + row * d + col, Elems<T>::pack(o));
    }
  }
}

template <typename T, typename W, int V>
__global__ void __launch_bounds__(kMaxRowThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ dy,
                    const float* __restrict__ rstd, T* __restrict__ dx,
                    float* __restrict__ partials, long long rows, int d, int tpr) {
  __shared__ float smem[kMaxRowThreads / 32];
  const int t = threadIdx.x % tpr;
  const long long step = static_cast<long long>(gridDim.x) * (blockDim.x / tpr);
  const long long group = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                          threadIdx.x / tpr;
  const float inv_d = 1.f / static_cast<float>(d);
  float wt[V][kChunk], acc[V][kChunk] = {};
  weight_in<T, W, V>(w, d, t, tpr, wt);
  Vec<T> xr[V], gr[V];
  fetch<T, V>(x, group, rows, d, t, tpr, xr);
  fetch<T, V>(dy, group, rows, d, t, tpr, gr);
  float r_next = group < rows ? rstd[group] : 0.f;
  for (long long row = group; row - threadIdx.x / tpr < rows; row += step) {
    float xv[V][kChunk], gv[V][kChunk], dn[V][kChunk];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      Elems<T>::unpack(xr[k], xv[k]);
      Elems<T>::unpack(gr[k], gv[k]);
    }
    const float r = r_next;
    const long long next = row + step;
    fetch<T, V>(x, next, rows, d, t, tpr, xr);
    fetch<T, V>(dy, next, rows, d, t, tpr, gr);
    r_next = next < rows ? rstd[next] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        dn[k][j] = Elems<T>::round(__fmul_rn(gv[k][j], wt[k][j]));
        s += dn[k][j] * xv[k][j];
        acc[k][j] += gv[k][j] * Elems<T>::round(__fmul_rn(xv[k][j], r));
      }
    }
    s = row_sum(s, tpr, smem);
    if (dx == nullptr || row >= rows) continue;
    const float c3 = r * r * r * (s * inv_d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int col = column(t, k, tpr);
      if (col >= d) continue;
      float o[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) o[j] = r * dn[k][j] - xv[k][j] * c3;
      store(dx + row * d + col, Elems<T>::pack(o));
    }
  }
  if (partials == nullptr) return;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int col = column(t, k, tpr);
    if (col < d) store(partials + group * d + col, Elems<float>::pack(acc[k]));
  }
}

// dw[col] = W(sum over parts of partials[part, col]), the parts in a fixed
// order: kDwSlices threads a column each sum every kDwSlices-th part, then
// one sums their totals.
template <typename W>
__global__ void __launch_bounds__(kDwCols * kDwSlices)
rms_norm_dw_kernel(const float* __restrict__ partials, W* __restrict__ dw, int parts, int d) {
  __shared__ float sums[kDwSlices][kDwCols + 1];
  const int col = blockIdx.x * kDwCols + threadIdx.x;
  float a = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += kDwSlices)
      a += partials[static_cast<long long>(p) * d + col];
  }
  sums[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y != 0 || col >= d) return;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kDwSlices; ++i) s += sums[i][threadIdx.x];
  dw[col] = Elems<W>::to(s);
}

// The vectors of a row a thread holds, a row's threads and the rows a
// block holds, from d alone.
struct Layout {
  int vecs;  // 16-byte vectors of a row a thread holds: 1, or 2 past 512 vectors
  int tpr;   // threads of one row
  int rpb;   // rows a block
};

Layout layout(int d) {
  const int vectors = d / kChunk;
  Layout l;
  l.vecs = vectors > kMaxRowThreads ? kMaxVecs : 1;
  const int threads = (vectors + l.vecs - 1) / l.vecs;
  if (threads < 32) {
    l.tpr = 1;
    while (l.tpr < threads) l.tpr *= 2;
  } else {
    l.tpr = (threads + 31) / 32 * 32;
  }
  l.rpb = l.tpr >= kBlockThreads ? 1 : kBlockThreads / l.tpr;
  return l;
}

bool valid(long long rows, int d, int x_dtype, int w_dtype) {
  return rows >= 0 && d >= kChunk && d <= kMaxD && d % kChunk == 0 &&
         (x_dtype == 0 || x_dtype == 1) && (w_dtype == 0 || w_dtype == 1);
}

// A persistent grid's blocks: as many as fit on the SMs by the kernel's
// registers (asked once per kernel and block size), at most
// kFwdThreadsPerSm or kBwdThreadsPerSm threads an SM, no more than the rows
// need, one at least.
template <typename T, typename W, int V, bool kBackward>
int grid_blocks(long long rows, const Layout& l, int sms) {
  static std::atomic<int> fits[kMaxRowThreads / 32 + 1];  // by block size / 32; 0 unknown
  const int threads = l.tpr * l.rpb;
  std::atomic<int>& known = fits[threads / 32];
  int fit = known.load(std::memory_order_relaxed);
  if (fit == 0) {
    const cudaError_t err =
        kBackward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &fit, rms_norm_bwd_kernel<T, W, V>, threads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &fit, rms_norm_fwd_kernel<T, W, V>, threads, 0);
    if (err != cudaSuccess || fit < 1) fit = 1;
    known.store(fit, std::memory_order_relaxed);
  }
  const int cap = (kBackward ? kBwdThreadsPerSm : kFwdThreadsPerSm) / threads;
  const long long most = static_cast<long long>(sms) * (fit < cap ? fit : cap);
  const long long needed = (rows + l.rpb - 1) / l.rpb;
  return static_cast<int>(needed < 1 ? 1 : needed < most ? needed : most);
}

template <typename T, typename W, int V>
struct Launch {
  static int fwd(const void* x, const void* w, void* y, float* rstd, long long rows, int d,
                 float eps, int sms, cudaStream_t s) {
    const Layout l = layout(d);
    const int blocks = grid_blocks<T, W, V, false>(rows, l, sms);
    rms_norm_fwd_kernel<T, W, V><<<blocks, l.tpr * l.rpb, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), rstd, rows, d,
        l.tpr, eps);
    return static_cast<int>(cudaGetLastError());
  }
  static int parts(long long rows, int d, int sms) {
    const Layout l = layout(d);
    return grid_blocks<T, W, V, true>(rows, l, sms) * l.rpb;
  }
  static int bwd(const void* x, const void* w, const void* dy, const float* rstd, void* dx,
                 float* partials, long long rows, int d, int parts, cudaStream_t s) {
    const Layout l = layout(d);
    if (parts % l.rpb != 0) return static_cast<int>(cudaErrorInvalidValue);
    rms_norm_bwd_kernel<T, W, V><<<parts / l.rpb, l.tpr * l.rpb, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(dy), rstd,
        static_cast<T*>(dx), partials, rows, d, l.tpr);
    return static_cast<int>(cudaGetLastError());
  }
};

// Launch<T, W, V> for the dtype codes (0 bf16, 1 f32) and d, which `valid`
// checked.
template <int V, typename F>
int dispatch_types(int x_dtype, int w_dtype, F f) {
  using B = __nv_bfloat16;
  if (x_dtype == 0) return w_dtype == 0 ? f(Launch<B, B, V>()) : f(Launch<B, float, V>());
  return w_dtype == 0 ? f(Launch<float, B, V>()) : f(Launch<float, float, V>());
}

template <typename F>
int dispatch(int x_dtype, int w_dtype, int d, F f) {
  return layout(d).vecs == 1 ? dispatch_types<1>(x_dtype, w_dtype, f)
                             : dispatch_types<kMaxVecs>(x_dtype, w_dtype, f);
}

}  // namespace

// y = rms_norm(x, w) over rows of d elements: x and y [rows, d] of type
// x_dtype (0 bf16, 1 f32), w [d] of type w_dtype, each contiguous and
// 16-byte aligned; rstd, when not null, receives each row's f32 r; sms is
// the device's multiprocessor count. Returns the launch's CUDA error, 0
// when it was queued on `stream` (or there was nothing to do).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, float* rstd, long long rows,
                            int d, float eps, int x_dtype, int w_dtype, int sms, void* stream) {
  if (!valid(rows, d, x_dtype, w_dtype) || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  return dispatch(x_dtype, w_dtype, d, [&](auto k) {
    return k.fwd(x, w, y, rstd, rows, d, eps, sms, static_cast<cudaStream_t>(stream));
  });
}

// The rows of partial dw sums `rms_norm_bwd` writes for this shape on a
// device of `sms` multiprocessors: the [parts, d] f32 buffer the caller
// passes it. Negative for a shape or type the kernels do not take.
extern "C" int rms_norm_bwd_parts(long long rows, int d, int x_dtype, int w_dtype, int sms) {
  if (!valid(rows, d, x_dtype, w_dtype) || sms < 1) return -1;
  return dispatch(x_dtype, w_dtype, d, [&](auto k) { return k.parts(rows, d, sms); });
}

// The gradient of rms_norm_fwd: from x, w, dy ([rows, d], like x) and the
// forward's rstd, dx (when not null) and, when partials is not null, the
// [parts, d] f32 partial sums of dw that rms_norm_dw reduces (zeros where
// there are no rows); parts is rms_norm_bwd_parts' answer for the same
// shape and device.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* dy, const float* rstd,
                            void* dx, float* partials, long long rows, int d, int parts,
                            int x_dtype, int w_dtype, void* stream) {
  if (!valid(rows, d, x_dtype, w_dtype) || parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x_dtype, w_dtype, d, [&](auto k) {
    return k.bwd(x, w, dy, rstd, dx, partials, rows, d, parts, static_cast<cudaStream_t>(stream));
  });
}

// dw [d] of type w_dtype = the sum of the [parts, d] f32 partials over
// parts, in a fixed order.
extern "C" int rms_norm_dw(const float* partials, void* dw, int parts, int d, int w_dtype,
                           void* stream) {
  if (!valid(0, d, 0, w_dtype) || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kDwCols, kDwSlices);
  const unsigned blocks = static_cast<unsigned>((d + kDwCols - 1) / kDwCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) {
    rms_norm_dw_kernel<__nv_bfloat16><<<blocks, block, 0, s>>>(
        partials, static_cast<__nv_bfloat16*>(dw), parts, d);
  } else {
    rms_norm_dw_kernel<float><<<blocks, block, 0, s>>>(partials, static_cast<float*>(dw), parts, d);
  }
  return static_cast<int>(cudaGetLastError());
}
