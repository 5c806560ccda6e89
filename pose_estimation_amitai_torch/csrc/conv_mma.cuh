// The SAME 3x3 dilated convolution of conv_tile.cuh as an implicit GEMM on
// the bf16 tensor cores (`mma.sync.m16n8k16`, f32 accumulation), with the
// same fused epilogue. bf16 only; float32 keeps conv3x3_kernel (TF32 would
// break its 1e-4 limit). Which kernel a conv takes is the caller's choice
// (ops/hopper_conv.py: conv_kernel_for), passed down as `kind`.
//
// What bounds it. A flagship conv does 2 * 9 * Cin * Cout operations a
// pixel, against 2 (Cin + Cout) bytes or so: 100 to 1000 operations a byte,
// above the tensor cores' ridge (295) from Cin = Cout = 128 on, so the bound
// is the tensor cores' rate, and what stands between the kernel and it is
// feeding them: shared-memory bandwidth for the fragments and the latency of
// staging.
//
// What the design does about it. GEMM view: M = output pixels, N = output
// channels, K = 9 taps x Cin. A block of 8 warps owns 16 x 16 pixels x 64
// channels; a warp owns two tile rows (two m16 tiles) x 64 channels, 64 f32
// accumulators a thread, so one k-step is 6 `ldmatrix.x4` for 16 `mma`.
// K is walked in chunks of 16 input channels: the input patch (tile + `dil`
// halo, channels innermost as NHWC already is, 32 bytes a pixel) and the
// 9 x 16 x 64 weight slab (HWIO as it lies: `ldmatrix.trans` makes the B
// fragments) are staged in bf16 by 16-byte `cp.async` with zero fill outside
// the image and past Cout, unpadded but with their 16-byte pieces swizzled so
// that the 8 rows of an `ldmatrix` fall in distinct banks, into a ring of
// three stages: chunks c + 1 and c + 2 load while chunk c multiplies, one
// block barrier a chunk. (With two stages the copies' latency was in the
// open: staging alone took half the kernel's time.) SAME padding stays a
// property of staging. A tap is an address offset into the patch: the A
// fragments of tap (ky, kx) are `ldmatrix` rows of the pixels shifted by
// (ky dil, kx dil); no im2col buffer exists. Two blocks fit an SM at
// dilation 2 (95 KB each). The output-channel tile is the fastest grid
// index, so the blocks that share a patch run together and find it in L2.
//
// The first conv of the encoder has Cin = 4, K = 36: conv3x3_c4_mma_kernel
// packs the nine taps of a pixel into one row of K = 48 at staging (8-byte
// `cp.async`, 4 channels a tap; columns 36..47 zero) and multiplies by the
// (36, Cout) weight matrix, which is HWIO as it lies, in three k-steps. It
// writes 64 channels a pixel and is bound by those bytes.
//
// Epilogue, both kernels: LReLU(acc + bias) goes as f32 through shared
// memory (the ring is free by then), so that every thread then owns 8
// consecutive channels of one output pixel, or of one 2 x 2 pool window:
// it adds the skip (16-byte loads), takes the NaN-propagating max and the
// post-pool LReLU, rounds once, and stores 16 bytes. Ragged tiles are masked
// there; Cout a multiple of 8 keeps the 16 bytes whole.
#pragma once

#include "conv_tile.cuh"
#include "mma_tile.cuh"

namespace pe {

constexpr int MT = 16;            // output rows and columns of a block
constexpr int MC = 64;            // output channels of a block
constexpr int MKC = 16;           // input channels of a staged chunk
constexpr int MSTAGES = 3;        // ring depth
constexpr int MTHREADS = 256;     // 8 warps, two tile rows each
constexpr int PIX_BYTES = 2 * MKC;           // a staged pixel: 32 bytes
constexpr int W_ROW_BYTES = 2 * MC;          // a staged weight row: 128 bytes
constexpr int W_BYTES = 9 * MKC * W_ROW_BYTES;  // a chunk's weight slab
constexpr int W_LD = MC + 8;      // bf16 a row of the packed conv's weights
constexpr int EPI_LD = MC + 8;    // f32 a pixel of the epilogue tile
constexpr int C4_K = 48;          // 9 taps x 4 channels, padded to 3 k-steps
constexpr int C4_LD = C4_K + 8;   // bf16 a packed pixel row (112 bytes)
constexpr size_t EPI_BYTES = sizeof(float) * MT * MT * EPI_LD;

inline size_t conv3x3_mma_smem_bytes(int dil, int packed) {
  const size_t npix = (size_t)(MT + 2 * dil) * (MT + 2 * dil);
  const size_t ring = MSTAGES * (npix * PIX_BYTES + W_BYTES) + npix * sizeof(int);
  const size_t c4 = 2 * (size_t)(MT * MT * C4_LD + C4_K * W_LD);
  const size_t main = packed ? c4 : ring;
  return main > EPI_BYTES ? main : EPI_BYTES;
}

// acc[mt][nt][4]: this warp's tile rows 2 warp + mt, channels nt * 8 ...
// -> out, through the f32 tile `ep` in shared memory (see the note above).
// Every thread of the block calls it; shared memory must be free for reuse.
__device__ __forceinline__ void mma_epilogue(
    float (&acc)[2][8][4], float* ep, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ skip, __nv_bfloat16* __restrict__ out,
    int bi, int oy0, int ox0, int co0, int H, int W, int Cout, float alpha,
    int pool) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int cl = nt * 8 + tig * 2;
    float b0 = 0.f, b1 = 0.f;
    if (co0 + cl < Cout) {
      b0 = bias[co0 + cl];
      b1 = bias[co0 + cl + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* row = ep + ((2 * warp + mt) * MT + gid) * EPI_LD + cl;
      *reinterpret_cast<float2*>(row) = make_float2(
          lrelu(acc[mt][nt][0] + b0, alpha), lrelu(acc[mt][nt][1] + b1, alpha));
      *reinterpret_cast<float2*>(row + 8 * EPI_LD) = make_float2(
          lrelu(acc[mt][nt][2] + b0, alpha), lrelu(acc[mt][nt][3] + b1, alpha));
    }
  }
  __syncthreads();

  // f[8] = the tile's f32 values of pixel (ty, tx), channels c8.. (+ skip)
  auto pixel = [&](int ty, int tx, int c8, float (&f)[8]) {
    const float4* p =
        reinterpret_cast<const float4*>(ep + (ty * MT + tx) * EPI_LD + c8);
    const float4 lo = p[0], hi = p[1];
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
    if (skip != nullptr) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          skip + (((size_t)bi * H + oy0 + ty) * W + ox0 + tx) * Cout + co0 + c8);
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 s2 = unpack_bf16(w4[i]);
        f[2 * i] += s2.x;
        f[2 * i + 1] += s2.y;
      }
    }
  };
  auto store8 = [&](__nv_bfloat16* dst, const float (&f)[8]) {
    uint4 u;
    u.x = pack_bf16(f[0], f[1]);
    u.y = pack_bf16(f[2], f[3]);
    u.z = pack_bf16(f[4], f[5]);
    u.w = pack_bf16(f[6], f[7]);
    *reinterpret_cast<uint4*>(dst) = u;
  };

  if (!pool) {
    for (int i = threadIdx.x; i < MT * MT * (MC / 8); i += MTHREADS) {
      const int c8 = (i % (MC / 8)) * 8, px = i / (MC / 8);
      const int ty = px / MT, tx = px % MT;
      if (oy0 + ty >= H || ox0 + tx >= W || co0 + c8 >= Cout) continue;
      float f[8];
      pixel(ty, tx, c8, f);
      store8(out + (((size_t)bi * H + oy0 + ty) * W + ox0 + tx) * Cout + co0 + c8,
             f);
    }
    return;
  }
  const int Ho = H / 2, Wo = W / 2;  // H, W even: a window is whole or absent
  for (int i = threadIdx.x; i < (MT / 2) * (MT / 2) * (MC / 8); i += MTHREADS) {
    const int c8 = (i % (MC / 8)) * 8, pp = i / (MC / 8);
    const int ty = 2 * (pp / (MT / 2)), tx = 2 * (pp % (MT / 2));
    if (oy0 + ty >= H || ox0 + tx >= W || co0 + c8 >= Cout) continue;
    float a[8], b[8], c[8], d[8], m[8];
    pixel(ty, tx, c8, a);
    pixel(ty, tx + 1, c8, b);
    pixel(ty + 1, tx, c8, c);
    pixel(ty + 1, tx + 1, c8, d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m[j] = lrelu(nanmax(nanmax(a[j], b[j]), nanmax(c[j], d[j])), alpha);
    store8(out + (((size_t)bi * Ho + (oy0 + ty) / 2) * Wo + (ox0 + tx) / 2) * Cout +
               co0 + c8,
           m);
  }
}

// y = LReLU(conv3x3_dil(x) + b) [+ skip] [-> 2x2 max-pool -> LReLU], as
// conv3x3_kernel. Cin a multiple of 16, Cout a multiple of 8, H * W < 2^31.
// grid = (ceil(Cout/MC) * ceil(H/MT) * ceil(W/MT), B); dynamic shared memory
// conv3x3_mma_smem_bytes(dil, 0).
//
// Shared memory: MSTAGES stages of (patch, weights), then a table with the
// image pixel index of every patch pixel (-1 outside the image), filled once
// so that staging a chunk costs no division. Neither buffer is padded; 16-byte
// pieces are swizzled instead, so that the 8 rows of every `ldmatrix` fall in
// distinct banks: patch pixel p keeps its two 16-byte halves (channels 0-7,
// 8-15) in slots p * 2 + (half ^ ((p >> 2) & 1)); weight row r = tap * 16 + ci
// (128 bytes, 64 channels) keeps piece c in slot c ^ (r & 7).
__global__ void __launch_bounds__(MTHREADS, 2)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ skip,
                   __nv_bfloat16* __restrict__ out, int H, int W, int Cin,
                   int Cout, int dil, float alpha, int pool) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int PW = MT + 2 * dil;
  const int npix = PW * PW;
  const uint32_t patch_bytes = npix * PIX_BYTES;
  const uint32_t stage_bytes = patch_bytes + W_BYTES;
  const uint32_t ring = smem_u32(smem_raw);
  int* pix_of = reinterpret_cast<int*>(smem_raw + MSTAGES * stage_bytes);

  const int n_co = (Cout + MC - 1) / MC;
  const int tiles_w = (W + MT - 1) / MT;
  const int co0 = (blockIdx.x % n_co) * MC;
  const int tile = blockIdx.x / n_co;
  const int oy0 = (tile / tiles_w) * MT;
  const int ox0 = (tile % tiles_w) * MT;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* xb = x + (size_t)bi * H * W * Cin;

  for (int p = threadIdx.x; p < npix; p += MTHREADS) {
    const int pr = p / PW, pc = p - pr * PW;
    const int iy = oy0 - dil + pr, ix = ox0 - dil + pc;
    pix_of[p] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? iy * W + ix : -1;
  }
  __syncthreads();

  // chunk c (input channels 16 c ..) -> stage st of the ring
  auto load_chunk = [&](int c, int st) {
    const uint32_t sp = ring + st * stage_bytes;
    const uint32_t sw = sp + patch_bytes;
    const __nv_bfloat16* xc = xb + c * MKC;
    for (int i = threadIdx.x; i < npix * 2; i += MTHREADS) {
      const int p = i >> 1, half = i & 1;
      const int src = pix_of[p];
      cp_async16(sp + p * PIX_BYTES + ((half ^ ((p >> 2) & 1)) << 4),
                 src >= 0 ? xc + (size_t)src * Cin + half * 8 : xb,
                 src >= 0 ? 16 : 0);
    }
    const __nv_bfloat16* wc = w + (size_t)c * MKC * Cout + co0;
    for (int i = threadIdx.x; i < 9 * MKC * 8; i += MTHREADS) {
      const int r = i >> 3, piece = i & 7;  // r = tap * 16 + ci
      const bool in = co0 + piece * 8 < Cout;
      cp_async16(sw + r * W_ROW_BYTES + ((piece ^ (r & 7)) << 4),
                 in ? wc + ((size_t)(r >> 4) * Cin + (r & 15)) * Cout + piece * 8
                    : w,
                 in ? 16 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // this lane's ldmatrix rows (see mma_tile.cuh): A row = patch pixel
  // a_pix (+ the tap's offset, + PW for the second tile row), half a_half;
  // B row = weight row b_row (+ 16 tap), pieces 2 np + b_piece
  const int a_pix = 2 * warp * PW + (lane & 15);
  const int a_half = lane >> 4;
  const uint32_t b_row = ((lane & 7) + ((lane >> 3) & 1) * 8) * W_ROW_BYTES;
  const int b_piece = lane >> 4, b_swz = lane & 7;

  const int chunks = Cin / MKC;
  load_chunk(0, 0);
  cp_async_commit();
  if (chunks > 1) load_chunk(1, 1);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<1>();  // chunk c is here; chunk c + 1 may still load
    __syncthreads();     // ... for every thread, and chunk c - 1 is consumed
    if (c + 2 < chunks) load_chunk(c + 2, (c + 2) % MSTAGES);
    cp_async_commit();   // (an empty group near the end)
    const uint32_t sp = ring + (c % MSTAGES) * stage_bytes;
    uint32_t pb = sp + patch_bytes + b_row;
    // the taps as rolled loops: unrolled, their offsets (dil is a run-time
    // value) would each hold a register
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      int p0 = a_pix + ky * dil * PW;
#pragma unroll 1
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t a[2][4];
        const int p1 = p0 + PW;
        ldmatrix_x4(a[0], sp + p0 * PIX_BYTES + ((a_half ^ ((p0 >> 2) & 1)) << 4));
        ldmatrix_x4(a[1], sp + p1 * PIX_BYTES + ((a_half ^ ((p1 >> 2) & 1)) << 4));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, pb + (((2 * np + b_piece) ^ b_swz) << 4));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
        p0 += dil;
        pb += MKC * W_ROW_BYTES;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the tile is free
  mma_epilogue(acc, reinterpret_cast<float*>(smem_raw), bias, skip, out, bi,
               oy0, ox0, co0, H, W, Cout, alpha, pool);
}

// The same function for Cin == 4: the nine taps of a pixel packed into one
// K of 48. grid as above; dynamic shared memory conv3x3_mma_smem_bytes(dil, 1).
__global__ void __launch_bounds__(MTHREADS, 2)
conv3x3_c4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ skip,
                      __nv_bfloat16* __restrict__ out, int H, int W, int Cout,
                      int dil, float alpha, int pool) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [256][C4_LD]
  __nv_bfloat16* Ws = As + MT * MT * C4_LD;                        // [48][W_LD]

  const int n_co = (Cout + MC - 1) / MC;
  const int tiles_w = (W + MT - 1) / MT;
  const int co0 = (blockIdx.x % n_co) * MC;
  const int tile = blockIdx.x / n_co;
  const int oy0 = (tile / tiles_w) * MT;
  const int ox0 = (tile % tiles_w) * MT;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* xb = x + (size_t)bi * H * W * 4;

  for (int i = threadIdx.x; i < MT * MT * 9; i += MTHREADS) {
    const int px = i / 9, tap = i % 9;
    const int iy = oy0 + px / MT + (tap / 3 - 1) * dil;
    const int ix = ox0 + px % MT + (tap % 3 - 1) * dil;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const __nv_bfloat16* src = in ? xb + ((size_t)iy * W + ix) * 4 : xb;
    cp_async8(smem_u32(As + px * C4_LD + tap * 4), src, in ? 8 : 0);
  }
  for (int i = threadIdx.x; i < C4_K * (MC / 8); i += MTHREADS) {
    const int row = i / (MC / 8), c8 = (i % (MC / 8)) * 8;  // row = tap*4+ci
    const bool in = row < 36 && co0 + c8 < Cout;
    const __nv_bfloat16* src = in ? w + (size_t)row * Cout + co0 + c8 : w;
    cp_async16(smem_u32(Ws + row * W_LD + c8), src, in ? 16 : 0);
  }
  cp_async_commit();
  for (int px = threadIdx.x; px < MT * MT; px += MTHREADS) {  // K 36..47
    uint2* z = reinterpret_cast<uint2*>(As + px * C4_LD + 36);
    z[0] = z[1] = z[2] = make_uint2(0u, 0u);
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const uint32_t sa = smem_u32(
      As + ((2 * warp) * MT + (lane & 15)) * C4_LD + (lane >> 4) * 8);
  const uint32_t sb = smem_u32(
      Ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * W_LD + (lane >> 4) * 8);
#pragma unroll
  for (int k0 = 0; k0 < C4_K; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], sa + 2 * (mt * MT * C4_LD + k0));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sb + 2 * (k0 * W_LD + np * 16));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every warp has read its fragments: the tile is free
  mma_epilogue(acc, reinterpret_cast<float*>(smem_raw), bias, skip, out, bi,
               oy0, ox0, co0, H, W, Cout, alpha, pool);
}

// kind: 1 = conv3x3_mma_kernel, 2 = conv3x3_c4_mma_kernel. Refuses what the
// kernel does not take; returns cudaGetLastError() after the launch. `static`,
// not `inline`: each library that includes this header has its own copy of
// the kernels, so each needs its own record of where the limit is raised,
// and a local of an inline function would be one object for the whole
// process.
static cudaError_t launch_conv3x3_mma(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
    const __nv_bfloat16* skip, __nv_bfloat16* out, int B, int H, int W,
    int Cin, int Cout, int dil, float alpha, int pool, int kind,
    cudaStream_t stream) {
  const int packed = kind == 2;
  if (Cout < 8 || Cout % 8 || dil < 1 || dil > 8 ||
      (packed ? Cin != 4 : (Cin < MKC || Cin % MKC)) ||
      (pool && (H % 2 || W % 2)) || (long long)H * W > 2147483647LL)
    return cudaErrorInvalidValue;
  const size_t bytes = conv3x3_mma_smem_bytes(dil, packed);
  const dim3 grid(((Cout + MC - 1) / MC) * ((H + MT - 1) / MT) * ((W + MT - 1) / MT),
                  B);
  // The limit on dynamic shared memory is raised to what the widest halo
  // needs, once per host thread and device: the attribute belongs to the
  // device, so one size for every dilation keeps threads out of each
  // other's way, and a launch still occupies only its own `bytes`.
  thread_local int allowed_dev[2] = {-1, -1};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (allowed_dev[packed] != dev) {
    const int most = (int)conv3x3_mma_smem_bytes(8, packed);
    e = packed ? cudaFuncSetAttribute(
                     conv3x3_c4_mma_kernel,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, most)
               : cudaFuncSetAttribute(
                     conv3x3_mma_kernel,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    allowed_dev[packed] = dev;
  }
  if (packed)
    conv3x3_c4_mma_kernel<<<grid, MTHREADS, bytes, stream>>>(
        x, w, b, skip, out, H, W, Cout, dil, alpha, pool);
  else
    conv3x3_mma_kernel<<<grid, MTHREADS, bytes, stream>>>(
        x, w, b, skip, out, H, W, Cin, Cout, dil, alpha, pool);
  return cudaGetLastError();
}

// One conv by the kernel the caller names: kind 0 = conv3x3_kernel (any
// dtype and shape), 1 and 2 = the tensor-core kernels (bf16 only).
template <typename T>
cudaError_t launch_conv3x3_kind(const T* x, const T* w, const float* b,
                                const T* skip, T* out, int B, int H, int W,
                                int Cin, int Cout, int dil, float alpha,
                                int pool, int kind, cudaStream_t stream);

template <>
inline cudaError_t launch_conv3x3_kind<float>(
    const float* x, const float* w, const float* b, const float* skip,
    float* out, int B, int H, int W, int Cin, int Cout, int dil, float alpha,
    int pool, int kind, cudaStream_t stream) {
  if (kind != 0) return cudaErrorInvalidValue;
  return launch_conv3x3<float>(x, w, b, skip, out, B, H, W, Cin, Cout, dil,
                               alpha, pool, stream);
}

template <>
inline cudaError_t launch_conv3x3_kind<__nv_bfloat16>(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
    const __nv_bfloat16* skip, __nv_bfloat16* out, int B, int H, int W,
    int Cin, int Cout, int dil, float alpha, int pool, int kind,
    cudaStream_t stream) {
  if (kind == 0)
    return launch_conv3x3<__nv_bfloat16>(x, w, b, skip, out, B, H, W, Cin,
                                         Cout, dil, alpha, pool, stream);
  if (kind == 1 || kind == 2)
    return launch_conv3x3_mma(x, w, b, skip, out, B, H, W, Cin, Cout, dil,
                              alpha, pool, kind, stream);
  return cudaErrorInvalidValue;
}

}  // namespace pe
