// Building blocks of the port's tensor-core kernels (sm_90a): cp.async
// staging, ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 product with
// fp32 sums, and the TF32 mma.sync.m16n8k8 product with the operand split of
// 3xTF32 (fp32 products to about 21 bits on tensor cores). Included by
// fbank.cu, relpos_attention.cu, ffn.cu, rnnt_fused.cu, ctc_lattice.cu and
// rnnt_lattice.cu (the last two cp.async alone); each source is its own
// library, so the helpers sit in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes device memory -> shared memory, in flight until
// cp_async_wait; zero-filled (nothing read) when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (.trans: each matrix transposed)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr))
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr))
               : "memory");
}

// d += a . b, a 16x16 (row-major fragments), b 16x8, bf16 operands, fp32 sums.
// Fragments (g = lane / 4, c = lane % 4): a {(g, 2c..), (g+8, 2c..), (g, 2c+8..),
// (g+8, 2c+8..)}, b {(k 2c.., n g), (k 2c+8.., n g)}, d {(g, 2c), (g, 2c+1),
// (g+8, 2c), (g+8, 2c+1)}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// the A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile
__device__ __forceinline__ const bf16* a_frag(const bf16* tile, int pitch, int r0, int k0,
                                              int lane) {
  return tile + (r0 + (lane & 15)) * pitch + k0 + ((lane >> 4) << 3);
}
// the B fragments of the n-tiles n0 and n0 + 8 at depth k0..k0+15 of a tile
// stored [n][k] (B = tile^T; ldsm4): {b0, b1} of n0, then of n0 + 8
__device__ __forceinline__ const bf16* b_frag(const bf16* tile, int pitch, int n0, int k0,
                                              int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + (((lane >> 3) & 1) << 3);
}
// the same for a tile stored [k][n] (B = tile; ldsm4_t)
__device__ __forceinline__ const bf16* bt_frag(const bf16* tile, int pitch, int n0, int k0,
                                               int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch + n0 + ((lane >> 4) << 3);
}
// the A fragment of rows (m) m0..m0+15, depth k0..k0+15 of a tile stored
// [k][m] (A = tile^T; ldsm4_t)
__device__ __forceinline__ const bf16* at_frag(const bf16* tile, int pitch, int m0, int k0,
                                               int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + m0 + (((lane >> 3) & 1) << 3);
}

// x = hi + lo for 3xTF32: hi is x cut to TF32 (its top 10 mantissa bits:
// one AND), lo = x - hi exactly in fp32; the mma reads lo's top 10 bits, so
// hi + lo keeps about 21 of fp32's 24 bits. Two instructions: a
// round-to-nearest split (cvt.rna.tf32.f32 twice) keeps one bit more but
// costs several more, and the fused joint backward, which splits its
// operands as it loads them, is bound by such instructions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b, a 16x8 (row-major fragments), b 8x8, tf32 operands, fp32 sums.
// Fragments (g = lane / 4, c = lane % 4), one 32-bit element each: a {(g, c),
// (g+8, c), (g, c+4), (g+8, c+4)}, b {(k c, n g), (k c+4, n g)}, d {(g, 2c),
// (g, 2c+1), (g+8, 2c), (g+8, 2c+1)} (d as mma16816's). ldmatrix moves 16-bit
// elements, so these fragments are loaded with plain 32-bit shared loads.
__device__ __forceinline__ void mma1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: d += a . b with a = ah + al and b = bh + bl (split_tf32) is
// al.bh + ah.bl + ah.bh (al.bl, ~2**-20 relative, dropped), the small terms
// first. The three products into one d depend on each other: callers issue
// them pass by pass over many tiles (term = 0, 1, 2), so consecutive mma are
// independent. `term` is a constant of an unrolled loop.
__device__ __forceinline__ void mma1688_3xtf32(float (&d)[4], int term, const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                               const uint32_t (&bl)[2]) {
  const uint32_t(&a)[4] = term == 0 ? al : ah;
  const uint32_t(&b)[2] = term == 1 ? bl : bh;
  mma1688_tf32(d, a, b[0], b[1]);
}

// dynamic shared memory above 48 KB needs the attribute before the launch
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
