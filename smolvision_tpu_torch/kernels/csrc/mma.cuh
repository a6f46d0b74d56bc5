// Tensor-core building blocks for sm_90a (plain C interface kernels):
// cp.async copies into shared memory, ldmatrix fragment loads, the bf16
// mma.sync.m16n8k16 product with f32 accumulation, and the bf16 hi / lo
// split that keeps an f32 operand's accuracy through two bf16 products.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A [16 x 16], row-major:  a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                            a2 (row g, k 2t+8..),  a3 (row g+8, k 2t+8..);
//   B [16 x 8], "col":       b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C [16 x 8] f32:          c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sv {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; with `pred` false the
// destination is zero-filled and nothing is read (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(pred ? 16 : 0));
}

// the same for one 4-byte element (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d += a . b, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo to 16 significant bits: hi = bf16(x), lo = bf16(x - hi), both
// for the pair (x0, x1).  A product with hi plus one with lo leaves an
// error of about 2^-17 |x| per term, where bf16(x) alone leaves 2^-9.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi, unsigned& lo) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
    const __nv_bfloat162 h = __halves2bfloat162(h0, h1);
    const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - __bfloat162float(h0),
                                                   x1 - __bfloat162float(h1));
    hi = *reinterpret_cast<const unsigned*>(&h);
    lo = *reinterpret_cast<const unsigned*>(&r);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of rows of
// `chunks` 16-byte chunks (a multiple of 8), XOR-swizzled so that the eight
// rows an ldmatrix reads at one chunk column fall in eight distinct bank
// groups.
__device__ __forceinline__ int swz(int row, int chunk, int chunks) {
    return (row * chunks + (chunk ^ (row & 7))) * 16;
}

}  // namespace sv
