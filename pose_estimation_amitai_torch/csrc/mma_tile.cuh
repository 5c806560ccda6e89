// Tensor-core and asynchronous-copy building blocks shared by the port's
// bf16 kernels (attention.cu, conv_mma.cuh): 16-byte and 8-byte `cp.async`
// with zero fill, bulk asynchronous copies that report to an `mbarrier`,
// `ldmatrix` (plain and transposed) and the bf16 `mma.sync.m16n8k16` with
// f32 accumulation.
//
// Fragment layout of m16n8k16 (lane = 4 * gid + tig, gid 0..7, tig 0..3):
//   A (16 x 16, row major)  a0 (gid, 2tig..+1)   a1 (gid+8, 2tig..+1)
//                           a2 (gid, 2tig+8..+9) a3 (gid+8, 2tig+8..+9)
//   B (16 x 8, "col")       b0 (k 2tig..+1, n gid)  b1 (k 2tig+8..+9, n gid)
//   C (16 x 8, f32)         c0 c1 (gid, 2tig..+1)   c2 c3 (gid+8, 2tig..+1)
// `ldmatrix.x4` reads four 8 x 8 b16 matrices; lane i gives the address of
// row i % 8 of matrix i / 8, and register j of a lane holds matrix j's
// element (lane / 4, 2 (lane % 4) ..+1), or its transpose with `.trans`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pe {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` (0 or 16) are read and
// the rest of the 16 is written as zero. `src` must be a valid address even
// when bytes == 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The same for 8 bytes (`bytes` 0 or 8).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most PENDING of this thread's newest groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ---- mbarrier (a 64-bit word in shared memory, by its shared address) ----

// One thread, before any use; follow with mbar_init_fence and a block barrier.
__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Blocks while the barrier's phase parity equals `parity`: the k-th
// completion (k = 0, 1, ...) is awaited with parity k & 1.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; src and dst 16-byte aligned) global -> shared by
// the copy engine; completion is counted on `bar` as transferred bytes.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b: bf16 x bf16 products summed in f32 on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even, `lo` in the low half of the word.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Transposes a 4 x 4 of words across the four lanes of a quad: w[i] of lane
// tig goes to w[tig] of lane i. Every lane of the warp must call it.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int tig) {
  const bool odd = tig & 1, high = tig & 2;
#pragma unroll
  for (int k = 0; k < 4; k += 2) {  // exchange with lane ^ 1
    const uint32_t got =
        __shfl_xor_sync(0xffffffffu, odd ? w[k] : w[k + 1], 1);
    if (odd) w[k] = got; else w[k + 1] = got;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // exchange with lane ^ 2
    const uint32_t got =
        __shfl_xor_sync(0xffffffffu, high ? w[i] : w[i + 2], 2);
    if (high) w[i] = got; else w[i + 2] = got;
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

}  // namespace pe
