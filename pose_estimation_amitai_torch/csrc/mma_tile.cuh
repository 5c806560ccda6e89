// Tensor-core and asynchronous-copy building blocks shared by the port's
// tensor-core kernels (attention.cu, conv_mma.cuh, deconv_mma.cuh,
// qconv_stage.cu): 16-, 8- and 4-byte `cp.async` with zero fill, bulk
// asynchronous copies and TMA tensor loads that report to an `mbarrier`,
// `ldmatrix` (plain and transposed), the bf16 `mma.sync.m16n8k16` and
// `wgmma.mma_async` m64n64k16 / m64n128k16 with f32 accumulation, the int8
// `mma.sync.m16n8k32` with int32 accumulation, `setmaxnreg`, and the
// swizzled input patch of 32-byte pixels that the `mma.sync` convolution
// kernels stage.
//
// Fragment layout of m16n8k16 (lane = 4 * gid + tig, gid 0..7, tig 0..3):
//   A (16 x 16, row major)  a0 (gid, 2tig..+1)   a1 (gid+8, 2tig..+1)
//                           a2 (gid, 2tig+8..+9) a3 (gid+8, 2tig+8..+9)
//   B (16 x 8, "col")       b0 (k 2tig..+1, n gid)  b1 (k 2tig+8..+9, n gid)
//   C (16 x 8, f32)         c0 c1 (gid, 2tig..+1)   c2 c3 (gid+8, 2tig..+1)
// `ldmatrix.x4` reads four 8 x 8 b16 matrices; lane i gives the address of
// row i % 8 of matrix i / 8, and register j of a lane holds matrix j's
// element (lane / 4, 2 (lane % 4) ..+1), or its transpose with `.trans`.
//
// Fragment layout of the int8 m16n8k32 (same lanes):
//   A (16 x 32, row major)  a0 (gid, 4tig..+3)      a1 (gid+8, 4tig..+3)
//                           a2 (gid, 16+4tig..+3)   a3 (gid+8, 16+4tig..+3)
//   B (32 x 8, "col")       b0 (k 4tig..+3, n gid)  b1 (k 16+4tig..+3, n gid)
//   C (16 x 8, int32)       as for bf16
// A row of 32 int8 is 32 bytes, as a row of 16 bf16 is: `ldmatrix.x4` on the
// same addresses yields the int8 A fragment (a b16 pair is four int8).
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

// The same for 4 bytes (`bytes` 0 or 4).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// mbar_wait that gives up after about 2^34 clock cycles (some 10 s) with a
// trap, which the launch's stream then reports as an error: a pipeline that
// can no longer make progress fails instead of holding the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
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

// TMA: the box of a tiled tensor map at coordinates (c0 innermost, ...)
// -> shared memory at `dst`, counted on `bar` as transferred bytes. Parts of
// the box outside the tensor arrive as zeros (the map's fill), and the whole
// box counts. `map` is the map's generic address (a `__grid_constant__`
// kernel parameter).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Register budget of the calling warpgroup (all 128 threads, together).
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- wgmma: a warpgroup's asynchronous 64 x N x 16 product ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most PENDING of the warpgroup's newest groups run.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Shared-memory matrix descriptor of a tile laid out as TMA's 128-byte
// swizzle leaves it (rows of 128 bytes, their 16-byte pieces XORed with the
// row's index mod 8, from a 1024-byte aligned start): `lbo`, the bytes from
// one 64-element column block to the next (MN-major), `sbo`, from one group
// of 8 rows to the next.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d += a b (`accumulate` 0: d = a b), bf16 operands, f32 sums. A (64 x 16)
// from the warpgroup's registers, warp w holding rows 16 w .. 16 w + 15 in
// the A fragment layout of mma.sync.m16n8k16; B (16 x N) by descriptor,
// MN-major (trans-b). d[4 i + e] is element e of the m16n8 C fragment of
// columns 8 i .. 8 i + 7 of the warp's 16 rows.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
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

// c += a b: int8 x int8 products summed in int32 on the tensor cores.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- a staged input patch of 32-byte pixels (16 bf16 or 32 int8 channels
// of a chunk), unpadded: pixel p keeps its two 16-byte halves in slots
// p * 2 + (half ^ ((p >> 2) & 1)), so that the 8 rows of an `ldmatrix` on
// consecutive pixels fall in distinct banks ----

constexpr int PATCH_PIX_BYTES = 32;

// byte offset of `half` (0, 1) of patch pixel p
__device__ __forceinline__ uint32_t patch_offset(int p, int half) {
  return p * PATCH_PIX_BYTES + ((half ^ ((p >> 2) & 1)) << 4);
}

// pix_of[p] = the image pixel index (row * W + col) of patch pixel p of a
// PH x PW patch whose first pixel is image pixel (y0, x0), or -1 outside
// the H x W image. Every thread of the block calls it; follow with a block
// barrier.
__device__ __forceinline__ void fill_patch_table(int* pix_of, int PH, int PW,
                                                 int y0, int x0, int H, int W) {
  for (int p = threadIdx.x; p < PH * PW; p += blockDim.x) {
    const int pr = p / PW, pc = p - pr * PW;
    const int iy = y0 + pr, ix = x0 + pc;
    pix_of[p] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? iy * W + ix : -1;
  }
}

// One chunk's patch -> shared memory at `sp` by 16-byte `cp.async`, zeros
// outside the image. `chunk` points at the chunk's 32 bytes of image pixel 0
// (16-byte aligned); `pix_stride` is the bytes from a pixel to the next.
__device__ __forceinline__ void stage_patch(uint32_t sp, const int* pix_of,
                                            int npix, const char* chunk,
                                            size_t pix_stride) {
  for (int i = threadIdx.x; i < npix * 2; i += blockDim.x) {
    const int p = i >> 1, half = i & 1;
    const int src = pix_of[p];
    cp_async16(sp + patch_offset(p, half),
               src >= 0 ? chunk + (size_t)src * pix_stride + half * 16 : chunk,
               src >= 0 ? 16 : 0);
  }
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
