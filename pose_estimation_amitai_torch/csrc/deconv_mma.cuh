// The torch-flavour stride-2 transposed convolution of the decoder
// (decoder.cu: up2) as four phase GEMMs on the bf16 tensor cores
// (`mma.sync.m16n8k16`, f32 accumulation), with the bias, the LReLU, the
// rounding and the phase interleave fused. bf16 only; float32 keeps
// up2_kernel (TF32 would break its 1e-4 limit). Which kernel a layer takes
// is the caller's choice (ops/hopper_deconv.py: up2_kernel_for).
//
// The tap table. Per axis, y[2j] = x[j] W[1] and y[2j+1] = x[j] W[0] +
// x[j+1] W[2]: tap k reads the input at j + up2_shift(k) and writes the
// output of parity up2_parity(k). In two dimensions an input position (j, l)
// and its right, lower and lower-right neighbours feed the four output
// phases y[2j + a, 2l + c] through each of the nine taps once.
//
// What bounds it. Layer 1 of the flagship decoder (48 x 48 x 256 -> 96 x 96
// x 128) does 2 * 9 * 256 * 128 operations an input position against 0.5 KB
// read and 1 KB written: 390 operations a byte, above the tensor cores'
// ridge (295), bound by their rate. The head (96 x 96 x 128 -> 192 x 192 x
// 18) does 41,472 operations a position against 256 bytes read and 144
// written: 104 a byte, bound by memory, so what counts there is reading the
// input once and storing whole lines.
//
// What the design does about it. GEMM view: M = input positions, N = output
// channels, K = Cin for each tap. A block of 8 warps owns 8 x 16 input
// positions x 32 output channels (16 x 32 output pixels); a warp owns two
// input rows (two m16 tiles) x 16 channels x the four phases, 64 f32
// accumulators a thread. The warp tile is set by registers: m16 x n32 x 4
// phases would hold as many accumulators but needs 22 `ldmatrix.x4` for its
// 36 `mma` a k-step where m32 x n16 needs 17, and 128 accumulators leave no
// room for fragments. K is walked in chunks of 16 input channels through a
// ring of three `cp.async` stages, as the int8 conv does: the input
// patch (tile + the row below + the column to the right, zero beyond the
// image, 32 bytes a pixel, swizzled halves) and the chunk's 9 x 16 x 32
// weight slab, HWIO as it lies (64-byte rows, their 16-byte pieces swizzled
// by the row pair so that the 8 rows of an `ldmatrix.trans` fall in distinct
// banks). The A fragment of each of the four neighbours is loaded once and
// multiplied into every phase that uses it (4, 2, 2 and 1 taps). Weight
// columns past Cout are zeroed in shared memory once and their n8 tiles
// skipped, so the head (K = 18: three n8 tiles) is one block for all of N and
// reads its input once; Cout needs no multiple: rows are staged by 16-, 4- or
// 2-byte pieces as Cout's divisibility allows, each thread the same piece of
// every 64th, 16th or 8th row (the head is paced by issuing its copies, not
// by their bytes: staging without a division and without the zero pieces
// took it from 1.5 to 1.0 ms at batch 256). The output goes through shared
// memory (the ring is free by then) rounded to bf16 and laid out as the
// interleaved (B, 2R, 2W, Cout) map lies: where the block holds all of Cout
// a tile row of 32 output pixels is one run in device memory and is stored
// 16 bytes a thread; otherwise each pixel's channels are a run. Ragged ends
// go by element.
#pragma once

#include "conv_tile.cuh"
#include "mma_tile.cuh"

namespace pe {

// tap k of an axis: which input it reads (j + shift) and which output
// parity it writes; ops/hopper_deconv.py mirrors both
__host__ __device__ constexpr int up2_shift(int k) { return k == 2; }
__host__ __device__ constexpr int up2_parity(int k) { return k != 1; }

constexpr int UQH = 8;            // input rows of a block
constexpr int UQW = 16;           // input columns of a block: one m16 tile
constexpr int UNC = 32;           // output channels of a block
constexpr int UKC = 16;           // input channels of a staged chunk
constexpr int USTAGES = 3;        // ring depth
constexpr int UTHREADS = 256;     // 8 warps: 4 (row pairs) x 2 (16 channels)
constexpr int UPH = UQH + 1;      // patch rows: + the row below
constexpr int UPW = UQW + 1;      // patch columns: + the column to the right
constexpr int UPATCH_BYTES = UPH * UPW * PATCH_PIX_BYTES;
constexpr int UW_ROW_BYTES = 2 * UNC;              // a staged weight row
constexpr int UW_BYTES = 9 * UKC * UW_ROW_BYTES;   // a chunk's weight slab
constexpr int USTAGE_BYTES = UPATCH_BYTES + UW_BYTES;
constexpr int UEP_ROW = 2 * UQW;  // output pixels of a tile row
// the output tile in bf16, a pixel padded by 8 channels at most
constexpr size_t UEP_BYTES = 2 * (2 * UQH) * UEP_ROW * (UNC + 8);

constexpr size_t up2_mma_smem_bytes() {
  const size_t ring = USTAGES * USTAGE_BYTES + UPH * UPW * sizeof(int);
  return ring > UEP_BYTES ? ring : UEP_BYTES;
}
static_assert(up2_mma_smem_bytes() <= 48 * 1024,
              "beyond 48 KB the launch must opt in to its shared memory");

// The weight slab of a chunk in shared memory: row r = tap * 16 + ci holds the
// block's 32 output channels (64 bytes), piece q (8 channels) in slot
// q ^ ((r >> 1) & 3). up2_stage_weights copies the rows from `wc` (the HWIO
// weights at the chunk's first input channel and the block's first output
// channel) by pieces of PE channels: 8 and 2 by `cp.async`, 1 by a plain
// store. A thread takes the same piece of every (UTHREADS / pieces a row)th
// row, so its addresses advance by constants and staging costs no division.
// Pieces at or past `n_valid` channels are not copied; with `zero` the call
// writes zeros to exactly those pieces instead (once a stage, before the
// first chunk: nothing overwrites them).
template <int PE>
__device__ __forceinline__ void up2_stage_weights(unsigned char* slab,
                                                  const __nv_bfloat16* wc,
                                                  int Cin, int Cout,
                                                  int n_valid, bool zero) {
  constexpr int PIECES = UNC / PE, ROWS = UTHREADS / PIECES;
  const int co = (threadIdx.x % PIECES) * PE;
  if ((co < n_valid) == zero) return;
  const uint32_t sw = smem_u32(slab);
#pragma unroll
  for (int k = 0; k < (9 * UKC + ROWS - 1) / ROWS; ++k) {
    const int r = threadIdx.x / PIECES + k * ROWS;
    if (r >= 9 * UKC) break;
    const int dst = r * UW_ROW_BYTES + ((((co >> 3) ^ (r >> 1)) & 3) << 4) +
                    (co & 7) * 2;
    const __nv_bfloat16* src = wc + ((r >> 4) * Cin + (r & 15)) * Cout + co;
    if (zero) {
      if constexpr (PE == 8) *reinterpret_cast<uint4*>(slab + dst) = make_uint4(0, 0, 0, 0);
      else if constexpr (PE == 2) *reinterpret_cast<uint32_t*>(slab + dst) = 0u;
      else *reinterpret_cast<__nv_bfloat16*>(slab + dst) = __float2bfloat16_rn(0.f);
    } else {
      if constexpr (PE == 8) cp_async16(sw + dst, src, 16);
      else if constexpr (PE == 2) cp_async4(sw + dst, src, 4);
      else *reinterpret_cast<__nv_bfloat16*>(slab + dst) = *src;
    }
  }
}

// out (B, 2R, 2Wd, Cout) = LReLU(up2(x, w) + b) for x (B, R, Wd, Cin), w HWIO
// (3, 3, Cin, Cout). Cin a multiple of 16, any Cout, R * Wd and the
// weights' element count < 2^31.
// grid = (ceil(Cout/UNC) * ceil(R/UQH) * ceil(Wd/UQW), B); dynamic shared
// memory up2_mma_smem_bytes().
__global__ void __launch_bounds__(UTHREADS, 2)
up2_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int R, int Wd, int Cin, int Cout, float alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  int* pix_of = reinterpret_cast<int*>(smem_raw + USTAGES * USTAGE_BYTES);

  const int n_co = (Cout + UNC - 1) / UNC;
  const int tiles_w = (Wd + UQW - 1) / UQW;
  const int co0 = (blockIdx.x % n_co) * UNC;
  const int tile = blockIdx.x / n_co;
  const int j0 = (tile / tiles_w) * UQH;
  const int l0 = (tile % tiles_w) * UQW;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp >> 1, wn = warp & 1;
  const char* xb = reinterpret_cast<const char*>(x + (size_t)bi * R * Wd * Cin);

  fill_patch_table(pix_of, UPH, UPW, j0, l0, R, Wd);
  __syncthreads();

  // the chunk's weights: by 16-byte, 4-byte or single-element pieces, as
  // Cout's divisibility allows
  const int n_valid = min(UNC, Cout - co0);
  auto stage_weights = [&](bool zero, int c, int st) {
    unsigned char* slab = smem_raw + st * USTAGE_BYTES + UPATCH_BYTES;
    const __nv_bfloat16* wc = w + c * UKC * Cout + co0;
    if (Cout % 8 == 0)
      up2_stage_weights<8>(slab, wc, Cin, Cout, n_valid, zero);
    else if (Cout % 2 == 0)
      up2_stage_weights<2>(slab, wc, Cin, Cout, n_valid, zero);
    else
      up2_stage_weights<1>(slab, wc, Cin, Cout, n_valid, zero);
  };
  auto load_chunk = [&](int c, int st) {
    stage_patch(ring + st * USTAGE_BYTES, pix_of, UPH * UPW,
                xb + c * PATCH_PIX_BYTES, (size_t)Cin * sizeof(__nv_bfloat16));
    stage_weights(false, c, st);
  };
  if (n_valid < UNC)  // the channels past Cout: zeros, written once
    for (int st = 0; st < USTAGES; ++st) stage_weights(true, 0, st);

  // acc[mt][phase][nt]: input row 2 wm + mt, output phase 2 a + c (row
  // parity a, column parity c), channels co0 + 16 wn + 8 nt ..
  float acc[2][4][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][ph][nt][e] = 0.f;

  // n8 tiles that hold a channel below Cout; the others are never multiplied
  const bool on0 = co0 + 16 * wn < Cout, on1 = co0 + 16 * wn + 8 < Cout;
  // this lane's ldmatrix rows (see mma_tile.cuh): A row = patch pixel a_pix
  // (+ the neighbour's offset, + UPW for the second input row), half a_half;
  // B row = weight row (lane & 15) (+ 16 tap), pieces 2 wn + (lane >> 4)
  const int a_pix = 2 * wm * UPW + (lane & 15);
  const int a_half = lane >> 4;
  const uint32_t b_off = (lane & 15) * UW_ROW_BYTES +
                         ((((2 * wn + (lane >> 4)) ^ (lane >> 1)) & 3) << 4);

  const int chunks = Cin / UKC;
#pragma unroll
  for (int c = 0; c < USTAGES - 1; ++c) {
    if (c < chunks) load_chunk(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<USTAGES - 2>();  // chunk c is here; later ones may still load
    __syncthreads();     // ... for every thread, and chunk c - 1 is consumed
    if (c + USTAGES - 1 < chunks)
      load_chunk(c + USTAGES - 1, (c + USTAGES - 1) % USTAGES);
    cp_async_commit();   // (an empty group near the end)
    if (!on0) continue;
    const uint32_t sp = ring + (c % USTAGES) * USTAGE_BYTES;
    const uint32_t sb = sp + UPATCH_BYTES + b_off;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        uint32_t a[2][4];  // the neighbour (dy, dx) of both input rows
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], sp + patch_offset(a_pix + (mt + dy) * UPW + dx, a_half));
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            if (up2_shift(ky) != dy || up2_shift(kx) != dx) continue;
            const int ph = 2 * up2_parity(ky) + up2_parity(kx);
            uint32_t b[4];
            ldmatrix_x4_trans(b, sb + (3 * ky + kx) * UKC * UW_ROW_BYTES);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][ph][0], a[mt], b[0], b[1]);
              if (on1) mma_bf16(acc[mt][ph][1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the tile is free

  // LReLU(acc + bias), rounded, -> the output tile in shared memory:
  // ep[(oy * 32 + ox) * ps + channel]. `runs`: every pixel's channels are
  // whole 16-byte pieces in device memory; the pixel is padded by 8 channels
  // here to spread the banks. Otherwise pixels are packed as they lie in
  // device memory.
  __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const bool runs = n_valid % 8 == 0 && Cout % 8 == 0;
  const int ps = runs ? n_valid + 8 : n_valid;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int cl = 16 * wn + 8 * nt + 2 * tig;
    if (cl >= n_valid) continue;
    const bool pair = cl + 1 < n_valid;
    const float b0 = bias[co0 + cl], b1 = pair ? bias[co0 + cl + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        const int oy = 2 * (2 * wm + mt) + (ph >> 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // accumulator rows gid, gid + 8
          const int ox = 2 * (gid + 8 * h) + (ph & 1);
          const float v0 = lrelu(acc[mt][ph][nt][2 * h] + b0, alpha);
          const float v1 = lrelu(acc[mt][ph][nt][2 * h + 1] + b1, alpha);
          __nv_bfloat16* d = ep + (oy * UEP_ROW + ox) * ps + cl;
          if (ps % 2 == 0) {  // n_valid even: the pair is whole and aligned
            *reinterpret_cast<uint32_t*>(d) = pack_bf16(v0, v1);
          } else {
            d[0] = __float2bfloat16_rn(v0);
            if (pair) d[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
  __syncthreads();

  const int rows = 2 * min(UQH, R - j0), pxs = 2 * min(UQW, Wd - l0);
  const size_t orow = (size_t)2 * Wd * Cout;  // elements of an output row
  __nv_bfloat16* ob =
      out + (((size_t)bi * 2 * R + 2 * j0) * 2 * Wd + 2 * l0) * Cout + co0;
  if (runs) {
    const int cpp = n_valid / 8;  // 16-byte pieces a pixel
    for (int i = threadIdx.x; i < rows * pxs * cpp; i += UTHREADS) {
      const int part = i % cpp, px = (i / cpp) % pxs, oy = i / (cpp * pxs);
      *reinterpret_cast<uint4*>(ob + oy * orow + (size_t)px * Cout + part * 8) =
          *reinterpret_cast<const uint4*>(ep + (oy * UEP_ROW + px) * ps + part * 8);
    }
    return;
  }
  // packed: a tile row is `len` elements; with all of Cout in the block it
  // is one run in device memory, 16-byte aligned when Wd * Cout is a
  // multiple of 4, and goes by 16-byte pieces; the rest by element
  const int len = pxs * n_valid;
  const int nvec = (n_valid == Cout && (Wd * Cout) % 4 == 0) ? len / 8 : 0;
  for (int i = threadIdx.x; i < rows * nvec; i += UTHREADS) {
    const int oy = i / nvec, j = i % nvec;
    *reinterpret_cast<uint4*>(ob + oy * orow + j * 8) =
        *reinterpret_cast<const uint4*>(ep + oy * UEP_ROW * ps + j * 8);
  }
  const int rest = len - nvec * 8;
  for (int i = threadIdx.x; i < rows * rest; i += UTHREADS) {
    const int oy = i / rest, e = nvec * 8 + i % rest;
    ob[oy * orow + (size_t)(e / n_valid) * Cout + e % n_valid] =
        ep[oy * UEP_ROW * ps + e];
  }
}

// Refuses what the kernel does not take; returns cudaGetLastError() after
// the launch.
static cudaError_t launch_up2_mma(const __nv_bfloat16* x,
                                  const __nv_bfloat16* w, const float* b,
                                  __nv_bfloat16* out, int B, int R, int Wd,
                                  int Cin, int Cout, float alpha,
                                  cudaStream_t stream) {
  if (Cin < UKC || Cin % UKC || Cout < 1 ||
      (long long)R * Wd > 2147483647LL || 9LL * Cin * Cout > 2147483647LL)
    return cudaErrorInvalidValue;
  const dim3 grid(((Cout + UNC - 1) / UNC) * ((R + UQH - 1) / UQH) *
                      ((Wd + UQW - 1) / UQW),
                  B);
  up2_mma_kernel<<<grid, UTHREADS, up2_mma_smem_bytes(), stream>>>(
      x, w, b, out, R, Wd, Cin, Cout, alpha);
  return cudaGetLastError();
}

}  // namespace pe
