// Hopper (sm_90a) building blocks of the flash-attention kernels, as inline
// PTX: TMA tensor maps and loads, mbarriers, wgmma shared-memory
// descriptors and products.
//
// Layout conventions (bf16, 128-byte swizzle):
// - a TMA box is at most 64 bf16 columns (128 bytes) wide, so a tile of
//   R rows x D columns lands as D / 64 boxes side by side, box b at byte
//   offset b * R * 128; inside a box row r holds 128 bytes at r * 128, its
//   16-byte chunks permuted by r % 8 (the swizzle atom is 8 rows, 1024
//   bytes). Every box starts 1024-byte aligned;
// - read with the K dim along the row (K-major: q.k^T reads q and k), a
//   wgmma operand has stride 1024 bytes between 8-row groups (SBO) and
//   advances 32 bytes per 16-deep step inside a box;
// - read with the K dim across rows (MN-major, the transposed B: p.v reads
//   v), 8 K-rows of 64 N-columns form one atom, K groups of 8 rows are 1024
//   bytes apart (SBO), 64-column N atoms are one box apart (LBO), and a
//   16-deep step advances 2048 bytes.
// wgmma accumulator layout (m64nN, f32), thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, c = t % 4: d[4j + e] holds row
// 16w + g + 8 (e / 2), column 8j + 2c + (e % 2). Packed to bf16 pairwise,
// the values of columns [16k, 16k + 16) are the A fragment of one 16-deep
// step of a register-sourced (RS) product.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the CUDA driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

// ------------------------------------------------------------- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime already loaded, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Number of values per map in the wrapper's layout arrays: dims (D, S, H,
// B, innermost first), byte strides of S, H and B, box (columns, rows).
constexpr int kMapArgs = 9;

// Columns of a box: the 128-byte swizzle spans 64 bf16 columns.
constexpr int kBoxCols = 64;

// Error code for a tensor map the CUDA driver refused (or could not be reached).
constexpr int kEncodeFailed = 999;

// Whether the wrapper's `n` maps have the boxes a kernel reads: map i
// `rows[i]` rows by min(D, kBoxCols) columns.
inline bool boxes_match(const long long* maps, const int* rows, int n, int D) {
  for (int i = 0; i < n; ++i) {
    const long long* a = maps + i * kMapArgs;
    if (a[7] != (D < kBoxCols ? D : kBoxCols) || a[8] != rows[i]) return false;
  }
  return true;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device once: `done` holds a bit for each device where that is set.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, int bytes, std::atomic<uint64_t>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (done->load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_release);
  return err;
}

// A 4-d tiled map of a strided [B, S, H, D] bf16 tensor with 128-byte
// swizzle; rows past S read as zeros. Returns 0 or kEncodeFailed.
inline int encode_bf16_map(CUtensorMap* map, const void* base, const long long* a) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed;
  const cuuint64_t dims[4] = {(cuuint64_t)a[0], (cuuint64_t)a[1], (cuuint64_t)a[2],
                              (cuuint64_t)a[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)a[4], (cuuint64_t)a[5], (cuuint64_t)a[6]};
  const cuuint32_t box[4] = {(cuuint32_t)a[7], (cuuint32_t)a[8], 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

// ----------------------------------------------------------- device ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA) and to the
// other threads; call after the inits, before __syncthreads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive once and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// The same, but a wait that lasts 10 s traps, so that a broken pipeline
// fails the launch instead of hanging the card. Only a producer calls it:
// a trap anywhere in a consumer's code keeps ptxas from allocating the
// registers setmaxnreg gives it (it spills as if held to the entry count).
// The producer's last waits are for the consumers' releases of the last
// tiles, so a stuck consumer, or bytes that never land, trap here too.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t start = 0;
  while (!mbar_try_wait(addr, parity)) {
    const uint64_t now = global_ns();
    if (start == 0) start = now;
    if (now - start > 10000000000ull) __trap();
  }
}

// TMA: shared memory to the box at (c0, c1, c2, c3) of a 4-d map; rows past
// the tensor's end are not written. Completed by tma_store_wait.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Until this thread's TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Ampere-style asynchronous copy of 4 bytes, global to shared; with
// `bytes` = 0 it reads nothing and writes zeros. Completed by cp_async_wait.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The warpgroup of this thread, read from lane 0 so that the compiler sees
// a value uniform across the warp (setmaxnreg must sit in such a branch).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
}

// Hand registers back to the pool (a producer warpgroup) or take them from
// it (the consumers); every warp of the warpgroup runs it. ptxas allocates
// the code after an increase with the new count, though it reports the
// kernel's count at entry (65536 / threads, rounded down to 8).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Register budgets of a warp-specialised block of 384 threads (one producer
// warpgroup, two consumer warpgroups): ptxas bounds every thread at 168 at
// entry (the pool is 384 x 168 = 64512), the producer gives back down to 24
// and the consumers take up to 240 (128 x 24 + 256 x 240 = 64512).
constexpr int kWsThreads = 384;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Barrier `id` (1-15; 0 is __syncthreads) over the `threads` that reach it.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA: the box at (c0, c1, c2, c3) of a 4-d map into shared memory; the
// barrier counts the bytes as they land.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Descriptor of a wgmma operand in shared memory with 128-byte swizzle.
// lbo and sbo in bytes (see the header comment); K-major operands ignore lbo.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in program order around the asynchronous products: an
// accumulator is not read before wgmma_wait nor written past a wgmma_fence,
// and an A fragment stays untouched until the product reading it is done.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define HOPPER_F8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_F32 HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
#define HOPPER_F64 HOPPER_F32, HOPPER_F8(32), HOPPER_F8(40), HOPPER_F8(48), HOPPER_F8(56)
#define HOPPER_R32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_R64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B for one 64 x N x 16 step, bf16 inputs, f32 accumulator.
// ss: A and B from shared memory (K-major A; B K-major when TB = 0,
// MN-major when TB = 1). rs: A from registers (the fragment above).
// accumulate = 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : HOPPER_F32
        : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_F32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : HOPPER_F64
        : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_F64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
  }
};

#undef HOPPER_F8
#undef HOPPER_F32
#undef HOPPER_F64
#undef HOPPER_R32
#undef HOPPER_R64

// Byte offset of the 1024-aligned start at or after shared address `addr`.
__device__ __forceinline__ uint32_t align_1024(uint32_t addr) {
  return ((addr + 1023u) & ~1023u) - addr;
}

}  // namespace hopper
