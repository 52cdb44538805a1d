// Inline-PTX helpers shared by the port's kernels (sm_80 and later; built
// for sm_90a): cp.async copies into shared memory, ldmatrix, and the
// mma.sync tensor-core products with fp32 accumulators.
//
// Fragment layouts of mma.sync m16n8k16 (bf16/fp16) and m16n8k8 (tf32), per
// lane with g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix fragments"):
//   C/D 16 x 8, fp32:  c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8.
//   A 16 x 16, 16-bit: a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] = (g, 2t+8..),
//                      a[3] = (g+8, 2t+8..), two values per 32-bit register.
//   B 16 x 8, 16-bit:  b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g).
//   A 16 x 8, tf32:    a[0] = (g, t), a[1] = (g+8, t), a[2] = (g, t+4), a[3] = (g+8, t+4).
//   B 8 x 8, tf32:     b[0] = (k t, n g), b[1] = (k t+4, n g).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace xk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with `valid` false the 16 bytes are zeroed
// and nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a @ b, m16n8k16, 16-bit inputs, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values packed into one register of the 16-bit type (lo = x)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// fp32 products on the tensor cores without losing fp32 accuracy ("3xTF32"):
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), so x - hi - lo is
// within 2^-22 |x|; a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b, leaving out only
// lo_a lo_b (about 2^-22 |a b|). Plain TF32 (hi_a hi_b alone) keeps 2^-11.

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a @ b in fp32 accuracy from three tf32 products, small terms first
__device__ __forceinline__ void mma_1688_3xtf32(float (&d)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma_1688_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_1688_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_1688_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

}  // namespace xk
