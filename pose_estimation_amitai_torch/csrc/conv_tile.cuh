// Shared device code of the port's hand-written convolution kernels
// (encoder_stage.cu, decoder.cu): the output tiling, the f32 <-> storage
// conversions, and the SAME 3x3 dilated convolution with its fused epilogue
// as a direct convolution in f32 on the CUDA cores. That arithmetic (67
// TFLOP/s at best) bounds it; it serves float32, where the tensor cores'
// TF32 would break the 1e-4 limit against the plain version, any channel
// counts, and the decoder's stride-2 up2_kernel. The bf16 convs of the
// flagship shapes run on the tensor cores instead: conv_mma.cuh.
//
// Tiling, common to every kernel here: a block of 256 threads owns an output
// tile of TH x TW pixels x TC channels. Thread t owns one 2x2 pixel quad
// (quad q = t / 8, 4 x 8 quads per tile) and CG = 8 consecutive output
// channels (group t % 8), so it keeps a 4 x 8 f32 accumulator in registers.
// Owning whole 2x2 quads lets the encoder's max-pool and the decoder's
// stride-2 phase interleave happen in the epilogue with no second pass.
// The contraction walks the input channels in chunks of CIC, staging the
// input patch (tile + halo) and the 9 x CIC x TC weight slab in shared
// memory as f32; all arithmetic is f32 FMA on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace pe {

constexpr int TH = 8;         // output rows per block
constexpr int TW = 16;        // output cols per block
constexpr int TC = 64;        // output channels per block
constexpr int CIC = 8;        // input channels staged per chunk
constexpr int CG = 8;         // output channels per thread
constexpr int NTHREADS = 256;
constexpr int GROUPS = TC / CG;  // channel groups per tile (8)
constexpr int QW = TW / 2;       // quads per tile row (8)
static_assert((TH / 2) * QW * GROUPS == NTHREADS, "one quad x group per thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype(bf16)
}

__device__ __forceinline__ float lrelu(float v, float alpha) {
  return v >= 0.f ? v : v * alpha;  // where(v >= 0, v, v * alpha): NaN stays
}

// max that propagates NaN, as jnp.max does (fmaxf would drop it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Stages weights w[tap][c0 + ci][co0 + co] (HWIO, 9 taps) into s_w as
// [tap][ci][co] f32, zero outside Cin / Cout.
template <typename T>
__device__ __forceinline__ void stage_weights(
    float* s_w, const T* __restrict__ w, int c0, int co0, int Cin, int Cout) {
  for (int e = threadIdx.x; e < 9 * CIC * TC; e += NTHREADS) {
    const int co = e % TC;
    const int r = e / TC;
    const int ci = r % CIC;
    const int tap = r / CIC;
    float v = 0.f;
    if (c0 + ci < Cin && co0 + co < Cout)
      v = to_f32(w[((size_t)tap * Cin + c0 + ci) * Cout + co0 + co]);
    s_w[e] = v;
  }
}

// Stages input rows y0.., cols x0.. (PH x PW, zero outside the image and
// outside Cin) of one frame into s_in as [ci][row][col] f32.
template <typename T>
__device__ __forceinline__ void stage_patch(
    float* s_in, const T* __restrict__ xb, int y0, int x0, int PH, int PW,
    int c0, int H, int W, int Cin) {
  for (int e = threadIdx.x; e < CIC * PH * PW; e += NTHREADS) {
    const int ci = e % CIC;
    const int pix = e / CIC;
    const int pr = pix / PW;
    const int pc = pix % PW;
    const int iy = y0 + pr;
    const int ix = x0 + pc;
    float v = 0.f;
    if (c0 + ci < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = to_f32(xb[((size_t)iy * W + ix) * Cin + c0 + ci]);
    s_in[(ci * PH + pr) * PW + pc] = v;
  }
}

__device__ __forceinline__ void load_w8(const float* p, float (&wv)[CG]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
  wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
}

// y = LReLU(conv3x3_dil(x) + b) [+ skip] [-> 2x2 max-pool -> LReLU].
//
// x (B, H, W, Cin) NHWC; w (3, 3, Cin, Cout) HWIO; b (Cout,) f32;
// skip (B, H, W, Cout) or nullptr; out (B, H, W, Cout), or (B, H/2, W/2,
// Cout) when pool (H, W even). SAME zero padding of `dil` on every side, so
// no value outside the image is ever evaluated: the zero border comes from
// the staging, never from a previous conv's epilogue.
// grid = (ceil(H/TH) * ceil(W/TW), ceil(Cout/TC), B); dynamic shared memory
// conv3x3_smem_bytes(dil).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, const T* __restrict__ skip,
               T* __restrict__ out, int H, int W, int Cin, int Cout, int dil,
               float alpha, int pool) {
  extern __shared__ __align__(16) float smem[];
  const int PH = TH + 2 * dil;
  const int PW = TW + 2 * dil;
  float* s_w = smem;                  // [9][CIC][TC], 16-byte aligned rows
  float* s_in = smem + 9 * CIC * TC;  // [CIC][PH][PW]

  const int tiles_w = (W + TW - 1) / TW;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const int bi = blockIdx.z;
  const int g = threadIdx.x % GROUPS;
  const int q = threadIdx.x / GROUPS;
  const int qy = q / QW;
  const int qx = q % QW;

  const T* xb = x + (size_t)bi * H * W * Cin;
  float acc[4][CG];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CIC) {
    __syncthreads();  // previous chunk fully consumed
    stage_weights(s_w, w, c0, co0, Cin, Cout);
    stage_patch(s_in, xb, oy0 - dil, ox0 - dil, PH, PW, c0, H, W, Cin);
    __syncthreads();
    const int ncin = min(CIC, Cin - c0);
    for (int ci = 0; ci < ncin; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[CG];
          load_w8(s_w + ((ky * 3 + kx) * CIC + ci) * TC + g * CG, wv);
          const float* ip =
              s_in + (ci * PH + 2 * qy + ky * dil) * PW + 2 * qx + kx * dil;
          const float i00 = ip[0], i01 = ip[1], i10 = ip[PW], i11 = ip[PW + 1];
#pragma unroll
          for (int j = 0; j < CG; ++j) {
            acc[0][j] = fmaf(i00, wv[j], acc[0][j]);
            acc[1][j] = fmaf(i01, wv[j], acc[1][j]);
            acc[2][j] = fmaf(i10, wv[j], acc[2][j]);
            acc[3][j] = fmaf(i11, wv[j], acc[3][j]);
          }
        }
      }
    }
  }

  const int oy = oy0 + 2 * qy;
  const int ox = ox0 + 2 * qx;
  const int cb = co0 + g * CG;
  if (oy >= H || ox >= W || cb >= Cout) return;
  float y[4][CG];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int yy = oy + p / 2;
    const int xx = ox + p % 2;
    const bool in = yy < H && xx < W;
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int c = cb + j;
      float v = 0.f;
      if (c < Cout) {
        v = lrelu(acc[p][j] + bias[c], alpha);
        if (skip != nullptr && in)
          v += to_f32(skip[(((size_t)bi * H + yy) * W + xx) * Cout + c]);
      }
      y[p][j] = v;
    }
  }
  if (pool) {
    const int Ho = H / 2, Wo = W / 2;
    T* o = out + (((size_t)bi * Ho + oy / 2) * Wo + ox / 2) * Cout;
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      if (cb + j < Cout) {
        const float m = nanmax(nanmax(y[0][j], y[1][j]), nanmax(y[2][j], y[3][j]));
        o[cb + j] = from_f32<T>(lrelu(m, alpha));
      }
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int yy = oy + p / 2;
    const int xx = ox + p % 2;
    if (yy >= H || xx >= W) continue;
    T* o = out + (((size_t)bi * H + yy) * W + xx) * Cout;
#pragma unroll
    for (int j = 0; j < CG; ++j)
      if (cb + j < Cout) o[cb + j] = from_f32<T>(y[p][j]);
  }
}

inline size_t conv3x3_smem_bytes(int dil) {
  return sizeof(float) *
         (9 * CIC * TC + CIC * (TH + 2 * dil) * (TW + 2 * dil));
}

inline dim3 conv3x3_grid(int B, int H, int W, int Cout) {
  return dim3(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
              (Cout + TC - 1) / TC, B);
}

// Launches conv3x3_kernel on `stream`; returns cudaGetLastError().
template <typename T>
cudaError_t launch_conv3x3(const T* x, const T* w, const float* b,
                           const T* skip, T* out, int B, int H, int W,
                           int Cin, int Cout, int dil, float alpha, int pool,
                           cudaStream_t stream) {
  conv3x3_kernel<T><<<conv3x3_grid(B, H, W, Cout), NTHREADS,
                      conv3x3_smem_bytes(dil), stream>>>(
      x, w, b, skip, out, H, W, Cin, Cout, dil, alpha, pool);
  return cudaGetLastError();
}

}  // namespace pe
