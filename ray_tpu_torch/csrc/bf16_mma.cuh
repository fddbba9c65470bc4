// Building blocks of the mma.sync flash-attention kernel B2 (dq_bf16_kernel
// in flash_attn_bwd.cu): bf16 packing, one tensor-core product step
// (mma.sync m16n8k16, f32 accumulation) and the tile copy into shared memory.
// The wgmma kernels (B1, B3) use hopper.cuh.
//
// Fragment layouts of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
// - A, 16x16 row-major, 4 registers of two bf16: (row g, cols 2t..2t+1),
//   (row g+8, cols 2t..), (row g, cols 2t+8..), (row g+8, cols 2t+8..);
// - B, 16x8 column-major, 2 registers: (rows 2t..2t+1, col g),
//   (rows 2t+8..2t+9, col g);
// - C, 16x8 f32, 4 values: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// So the C values of two adjacent 8-column tiles, packed to bf16, are the A
// fragment of one 16-deep chunk: a product's result feeds the next product
// without passing through shared memory.

#pragma once

#include "hopper.cuh"

namespace flash {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

using hopper::pack_bf16;  // two floats, rounded


__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16) and columns [c, c + 16) of a row-major
// tile in shared memory with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * LD + c + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (16 deep, 8 wide) from a tile in shared memory that holds B
// transposed, row-major [n, k]: B[k][n] = tile[n0 + n][k0 + k]. Each
// register is two adjacent values (q.k^T reads k this way).
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* tile,
                                          int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = tile + (n0 + g) * LD + k0 + t * 2;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment from a tile that holds B row-major [k, n]:
// B[k][n] = tile[k0 + k][n0 + n] (p.v reads v this way). The two k-rows of
// each register are not adjacent in memory, so each is two 16-bit loads.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* tile,
                                          int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = tile + (k0 + t * 2) * LD + n0 + g;
  b0 = pack_bf16(p[0], p[LD]);
  b1 = pack_bf16(p[8 * LD], p[9 * LD]);
}

// Copy rows [r0, r0 + ROWS) of a [S, D] slice (row stride ss elements) into
// shared memory with row stride LD, 16 bytes per thread per step; rows at or
// past n are zero-filled.
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int r0, int n) {
  constexpr int kVec = 8;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

}  // namespace flash
