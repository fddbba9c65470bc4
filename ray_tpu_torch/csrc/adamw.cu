// Global-norm clip and AdamW in one pass a leaf, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package leaves the update to XLA's
// fusion of optax's chain (clip_by_global_norm, scale_by_adam,
// add_decayed_weights, scale_by_learning_rate, apply_updates). The port's
// plain version of the same chain is `_clip_adamw_plain` in
// ray_tpu_torch/models/lm.py, a dozen full-size `_foreach` passes.
//
// It computes, for every element of one leaf, in f32 registers and in
// optax's order, with the gradients' global norm read from the device:
//   scale = max_norm / max(norm, max_norm)       (NaN if the norm is)
//   g'    = g * scale
//   mu    = b1 * mu + (1 - b1) * g'
//   nu    = b2 * nu + (1 - b2) * g'^2
//   u     = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
//   p     = p - lr * u
// and writes p, mu and nu in place. bc1 = 1 - b1^count and bc2 come from
// the host; the moments stay raw, as optax keeps them.
//
// What bounds it on an H100: bytes. An element reads g, p, mu and nu once
// and writes p, mu and nu once, 28 bytes in f32 (14 in bf16), for about 15
// operations: some 0.5 a byte, far below the ~20 a byte (67 TFLOP/s of f32
// over 3.35 TB/s) at which the arithmetic would set the time. At
// InternLM2-1.8B's 1.889 B f32 parameters that is 52.9 GB, 15.8 ms at the
// peak.
//
// What the design does about it:
// - one pass: the clipped gradient, the update and the bias-corrected
//   moments live in registers only, so nothing but the 28 bytes crosses
//   device memory, and nothing is allocated;
// - each thread loads and stores 16 bytes of each tensor at a time (a
//   float4, or 8 bf16), neighbouring threads on neighbouring vectors, so
//   every access is a full 128-byte line a warp;
// - a grid-stride loop over a grid of a few blocks per SM keeps about 64
//   bytes a thread in flight across 1024 threads an SM, several MB over the
//   card, well above what its latency needs to reach the peak rate; no
//   shared memory and no reduction;
// - bf16 leaves are computed in f32 and each stored value is rounded once;
// - where a pointer is not 16-byte aligned, or for the elements past the
//   last whole vector, the same arithmetic runs one element at a time.
// The kernel walks each tensor's storage in order: the wrapper
// (ray_tpu_torch/ops/cuda/adamw.py) checks that the four are contiguous,
// so element i of one is element i of the others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

// The update's constants, as the wrapper passes them (host floats, each
// rounded from the Python double the plain chain uses).
struct Hyper {
  float max_norm, b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, wd, neg_lr;
};
constexpr int kHyperFloats = 10;

__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v,
                                              float scale, const Hyper& h) {
  g *= scale;
  m = h.b1 * m + h.one_minus_b1 * g;
  v = h.b2 * v + h.one_minus_b2 * (g * g);
  const float u = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps) + h.wd * p;
  p = p + h.neg_lr * u;
}

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  using Vec = float4;
  static constexpr int kN = 4;
  __device__ static void unpack(const Vec& x, float* f) {
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ static Vec pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
  __device__ static float load(float x) { return x; }
  __device__ static float store(float f) { return f; }
};

template <>
struct Pack<__nv_bfloat16> {
  using Vec = uint4;
  static constexpr int kN = 8;
  __device__ static void unpack(const Vec& x, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static Vec pack(const float* f) {
    Vec x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return x;
  }
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float f) { return __float2bfloat16_rn(f); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
adamw_kernel(T* __restrict__ p, const T* __restrict__ g, T* __restrict__ mu,
             T* __restrict__ nu, long long n, const float* __restrict__ norm, Hyper h,
             int vectorised) {
  using P = Pack<T>;
  const float gn = *norm;
  const float scale = h.max_norm / (gn < h.max_norm ? h.max_norm : gn);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorised) {
    using Vec = typename P::Vec;
    const long long vectors = n / P::kN;
    Vec* pv = reinterpret_cast<Vec*>(p);
    const Vec* gv = reinterpret_cast<const Vec*>(g);
    Vec* mv = reinterpret_cast<Vec*>(mu);
    Vec* vv = reinterpret_cast<Vec*>(nu);
    for (long long i = first; i < vectors; i += stride) {
      float pf[P::kN], gf[P::kN], mf[P::kN], vf[P::kN];
      P::unpack(pv[i], pf);
      P::unpack(gv[i], gf);
      P::unpack(mv[i], mf);
      P::unpack(vv[i], vf);
#pragma unroll
      for (int j = 0; j < P::kN; ++j) adamw_element(pf[j], gf[j], mf[j], vf[j], scale, h);
      pv[i] = P::pack(pf);
      mv[i] = P::pack(mf);
      vv[i] = P::pack(vf);
    }
    done = vectors * P::kN;
  }
  for (long long i = done + first; i < n; i += stride) {
    float pf = P::load(p[i]), mf = P::load(mu[i]), vf = P::load(nu[i]);
    adamw_element(pf, P::load(g[i]), mf, vf, scale, h);
    p[i] = P::store(pf);
    mu[i] = P::store(mf);
    nu[i] = P::store(vf);
  }
}

template <typename T>
int launch(void* p, const void* g, void* mu, void* nu, long long n, const float* norm,
           const Hyper& h, int sms, cudaStream_t stream) {
  const std::uintptr_t any = reinterpret_cast<std::uintptr_t>(p) |
                             reinterpret_cast<std::uintptr_t>(g) |
                             reinterpret_cast<std::uintptr_t>(mu) |
                             reinterpret_cast<std::uintptr_t>(nu);
  const int vectorised = any % 16 == 0;
  const long long per_block = static_cast<long long>(kThreads) * (vectorised ? Pack<T>::kN : 1);
  const long long needed = (n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < most ? needed : most);
  adamw_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(mu), static_cast<T*>(nu),
      n, norm, h, vectorised);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One leaf's update: p, g, mu and nu hold n elements of one type (dtype 0
// bf16, 1 f32), each contiguous; norm is the gradients' global norm, an
// f32 on the device; hyper holds the kHyperFloats constants of Hyper in
// order; sms is the device's multiprocessor count. Returns the launch's
// CUDA error, 0 when it was queued on `stream`.
extern "C" int adamw_update(void* p, const void* g, void* mu, void* nu, long long n, int dtype,
                            const float* norm, const float* hyper, int sms, void* stream) {
  if (n <= 0) return 0;
  Hyper h;
  static_assert(sizeof(Hyper) == kHyperFloats * sizeof(float), "Hyper is packed floats");
  const float* src = hyper;
  float* dst = reinterpret_cast<float*>(&h);
  for (int i = 0; i < kHyperFloats; ++i) dst[i] = src[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(p, g, mu, nu, n, norm, h, sms, s);
  if (dtype == 1) return launch<float>(p, g, mu, nu, n, norm, h, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
