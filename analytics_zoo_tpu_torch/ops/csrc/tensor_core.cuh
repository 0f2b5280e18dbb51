// Tensor-core and asynchronous-copy building blocks for the bf16 flash
// and paged kernels (flash_attention.cu, flash_attention_bwd.cu,
// paged_attention.cu), for Hopper
// (sm_90a; every instruction here exists from sm_80 on).
//
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: one warp
//     multiplies a 16 x 16 bf16 A fragment by a 16 x 8 bf16 B fragment
//     into 16 x 8 f32 accumulators.  With g = lane / 4 and c = lane % 4,
//     a lane holds A rows g and g + 8 at columns 2c, 2c + 1 (a[0], a[1])
//     and 2c + 8, 2c + 9 (a[2], a[3]); B rows (the k index) 2c, 2c + 1
//     (b0) and 2c + 8, 2c + 9 (b1) of column g; accumulators d[0], d[1]
//     at row g, columns 2c, 2c + 1, and d[2], d[3] at row g + 8.  Two
//     neighbouring n8 accumulator blocks, rounded to bf16 and packed,
//     are therefore exactly one k16 A fragment of the next product.
//   ldmatrix.sync.aligned.m8n8.x4(.trans): four 8 x 8 b16 matrices from
//     shared memory, lane l giving the address of row l % 8 of matrix
//     l / 8; without .trans a lane receives row g, columns 2c, 2c + 1 of
//     each matrix, with .trans column g, rows 2c, 2c + 1.
//   cp.async.cg.shared.global: 16 bytes from device memory to shared
//     memory, in flight until cp.async.wait_group; a source size of 0
//     fills the 16 bytes with zeros (cp.async.ca: the same for 4 bytes).
//
// Shared-memory tiles are [rows][D + 8] bf16: the 16-byte pad puts the
// eight rows one ldmatrix phase reads on eight different 4-bank groups,
// so the loads are free of bank conflicts, and keeps every row 16-byte
// aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int kPad = 8;  // bf16 per row of padding in a shared tile
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when src_bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, or zeros when src_bytes == 0 (.ca: the 4-byte form)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// max / sum over the four lanes of a quad (the lanes that share row g)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows t0 .. t0 + R - 1 of one head of a [*, n, H, D] bf16 tensor into a
// [R][D + kPad] shared tile, 16 bytes per cp.async, spread over the
// block's kThreads threads; rows past n are zero-filled.  base points at
// (b, 0, h, 0) and must be 16-byte aligned; tok = H * D.
template <int R, int D, int kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* base,
                                                int t0, int n, size_t tok) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(R * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks, t = t0 + r;
    const bool in = t < n;
    const __nv_bfloat16* src =
        in ? base + static_cast<size_t>(t) * tok + c * 8 : base;
    cp_async16(dst + r * (D + kPad) + c * 8, src, in ? 16 : 0);
  }
}

// The A fragments of rows r0 .. r0 + 15 of a [*][D + kPad] shared tile,
// one per k16 step over D
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const __nv_bfloat16* tile,
                                             int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(a[kk], tile + (r0 + lane % 16) * (D + kPad) + kk * 16 +
                           (lane / 16) * 8);
}

// s[n] += a . rows^T over the k16 step kk of D: one A fragment times
// NB*8 rows of a [*][D + kPad] shared tile, read as the "col" B operand
// (each tile row is one output column)
template <int D, int NB>
__device__ __forceinline__ void mma_abt_step(float (&s)[NB][4],
                                             const uint32_t (&a)[4],
                                             const __nv_bfloat16* tile,
                                             int kk, int lane) {
#pragma unroll
  for (int n2 = 0; n2 < NB / 2; ++n2) {
    uint32_t b[4];
    ldmatrix_x4(b, tile + (n2 * 16 + lane % 8 + (lane / 16) * 8) *
                              (D + kPad) +
                       kk * 16 + ((lane / 8) % 2) * 8);
    mma_bf16(s[2 * n2], a, b[0], b[1]);
    mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
  }
}

// s[n] += a . rows^T over D: a warp's 16 x NB*8 product of its resident
// A fragments with NB*8 rows of a shared tile (see mma_abt_step)
template <int D, int NB>
__device__ __forceinline__ void mma_abt(float (&s)[NB][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_abt_step<D, NB>(s, a[kk], tile, kk, lane);
}

// The same product with the A operand read from rows r0 .. r0 + 15 of a
// [*][D + kPad] shared tile one k16 step at a time, for a kernel that
// has no registers to keep all D / 16 fragments resident
template <int D, int NB>
__device__ __forceinline__ void mma_abt_smem(float (&s)[NB][4],
                                             const __nv_bfloat16* atile,
                                             int r0,
                                             const __nv_bfloat16* tile,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, atile + (r0 + lane % 16) * (D + kPad) + kk * 16 +
                       (lane / 16) * 8);
    mma_abt_step<D, NB>(s, a, tile, kk, lane);
  }
}

// acc[n] += x . tile over K rows: a warp's 16 x K operand x, given as f32
// accumulator blocks x[K / 8][4] and rounded to bf16 here (the A
// fragment), times a [K][D + kPad] shared tile read row-major (.trans)
template <int D, int K>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4],
                                       const float (&x)[K / 8][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + lane % 16) * (D + kPad) +
                               n2 * 16 + (lane / 16) * 8);
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace tc
