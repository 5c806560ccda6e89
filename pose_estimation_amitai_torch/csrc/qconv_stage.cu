// Fused int8 encoder stage and single int8 conv for Hopper (sm_90a).
//
// Replaces pose_estimation_amitai_tpu/ops/pallas_qconv.py::fused_quantized_stage
// (Pallas kernel _stage_kernel, helpers _qdot_conv, _mask_rows, _mask_cols)
// and scripts/exp_im2col_pallas.py::make_pallas_conv (Pallas kernel
// _im2col_conv_kernel). Both are built from one device routine, a 3x3
// dilated SAME convolution of int8 activations with int8 weights,
// accumulated exactly in int32, with a fused epilogue:
//
//   stage:  y1 = bf16(LReLU(f32(conv(x))  * m1 + b1))        q1 = quant(y1)
//           y2 = bf16(LReLU(f32(conv(q1)) * m2 + b2)) + y1   q2 = quant(y2)
//           y3 = bf16(LReLU(f32(conv(q2)) * m3 + b3)) + y2   [LReLU if pool]
//           out = quant(y3)
//           quant(v) = int8(clip(rint(f32(bf16(v) * bf16(inv))), -127, 127))
//   single: out = int8(clip(rint(LReLU(f32(conv(x)) * m + b) * inv), +-127))
//
// Every float step rounds on its own (__fmul_rn, __fadd_rn: no FMA
// contraction; bf16 by __float2bfloat16_rn; rintf ties to even), so the
// outputs equal the plain PyTorch versions bit for bit.
//
// What bounds it on this card. The stage's three convs cost 5.6, 6.8 and
// 6.8 GOP a frame at the flagship shapes against 0.9 to 2.5 MB of int8 input
// and output a frame: thousands of operations per byte, compute
// bound on any unit. This kernel multiplies with __dp4a on the CUDA cores
// (four int8 products per lane per instruction), far below the int8 tensor
// cores' rate, so arithmetic bounds it and the workspace round trips of
// q1/y1/q2/y2 cost little. The single conv (2.7 GOP against 4.7 MB a frame at
// 192 x 192 x 64) is compute bound here too; on the tensor cores it would sit
// at the ridge.
//
// What the design does about it. The tiling is conv_tile.cuh's: a block of
// 256 threads owns 8 x 16 pixels x 64 output channels, a thread one 2x2 quad
// x 8 channels in 32 int32 accumulators. Input channels are packed four to a
// 32-bit word, as NHWC int8 already lies in memory; the weights are repacked
// once per call by a small kernel into [tap][channel word][cout] words so
// that one __dp4a takes an activation word and a weight word. Taps outside
// the image are zero at staging time, so the TPU kernel's mask passes, its
// 128-lane slabs, 32-aligned widths and row tiles have no counterpart. As
// in encoder_stage.cu the stage is three launches with q1/y1/q2/y2 in a
// workspace the wrapper allocates; Cin and Cout are arbitrary (words and
// channel groups are masked). Next: mma.sync / wgmma s8 tiles, and the 2x2
// pool fused into the last epilogue.

#include <stdint.h>

#include "conv_tile.cuh"

namespace {

using pe::CG;
using pe::GROUPS;
using pe::NTHREADS;
using pe::QW;
using pe::TC;
using pe::TH;
using pe::TW;

constexpr int CIW = 8;  // input-channel words (4 x int8) staged per chunk

// HWIO int8 weights (9, Cin, Cout) -> packed[tap][cw][co], byte k of a word
// = w[tap][4 * cw + k][co], zero beyond Cin. One thread per word.
__global__ void pack_weights_kernel(const int8_t* __restrict__ w,
                                    int* __restrict__ packed, int Cin,
                                    int Cout) {
  const int CW = (Cin + 3) / 4;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 9 * CW * Cout) return;
  const int co = e % Cout;
  const int cw = (e / Cout) % CW;
  const int tap = e / (Cout * CW);
  unsigned word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ci = 4 * cw + k;
    if (ci < Cin)
      word |= (unsigned)(uint8_t)w[((size_t)tap * Cin + ci) * Cout + co]
              << (8 * k);
  }
  packed[e] = (int)word;
}

struct QEpilogue {
  const float* mult;           // (Cout,) s_x * s_w
  const float* bias;           // (Cout,)
  const __nv_bfloat16* skip;   // (B, H, W, Cout) added in bf16, or nullptr
  __nv_bfloat16* y_out;        // (B, H, W, Cout) pre-quant bf16, or nullptr
  int8_t* q_out;               // (B, H, W, Cout)
  float inv;                   // requant multiplier (a bf16 value if !f32)
  float alpha;
  int post_lrelu;              // LReLU in f32 before the quant (pooled stage)
  int f32_requant;             // the single conv's float32 requant
};

__device__ __forceinline__ float lrelu_rn(float v, float alpha) {
  return v >= 0.f ? v : __fmul_rn(v, alpha);
}

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// q_out = epilogue(conv3x3_dil(x, w)) on int8 x (B, H, W, Cin) and packed
// weights. grid = (ceil(H/TH) * ceil(W/TW), ceil(Cout/TC), B); dynamic
// shared memory qconv_smem_bytes(dil).
__global__ void __launch_bounds__(NTHREADS)
qconv3x3_kernel(const int8_t* __restrict__ x, const int* __restrict__ packed,
                QEpilogue ep, int H, int W, int Cin, int Cout, int dil) {
  extern __shared__ __align__(16) int smem_q[];
  const int PH = TH + 2 * dil;
  const int PW = TW + 2 * dil;
  int* s_w = smem_q;                   // [9][CIW][TC]
  int* s_in = smem_q + 9 * CIW * TC;   // [CIW][PH][PW]

  const int tiles_w = (W + TW - 1) / TW;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const int bi = blockIdx.z;
  const int g = threadIdx.x % GROUPS;
  const int q = threadIdx.x / GROUPS;
  const int qy = q / QW;
  const int qx = q % QW;

  const int CW = (Cin + 3) / 4;
  const int8_t* xb = x + (size_t)bi * H * W * Cin;
  // whole words can be read when every pixel's channels start 4-aligned
  const bool aligned = (Cin % 4 == 0) && (((size_t)x & 3) == 0);

  int acc[4][CG];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[p][j] = 0;

  for (int w0 = 0; w0 < CW; w0 += CIW) {
    __syncthreads();  // previous chunk fully consumed
    for (int e = threadIdx.x; e < 9 * CIW * TC; e += NTHREADS) {
      const int co = e % TC;
      const int cw = (e / TC) % CIW;
      const int tap = e / (TC * CIW);
      int v = 0;
      if (w0 + cw < CW && co0 + co < Cout)
        v = packed[((size_t)tap * CW + w0 + cw) * Cout + co0 + co];
      s_w[e] = v;
    }
    for (int e = threadIdx.x; e < CIW * PH * PW; e += NTHREADS) {
      const int cw = e % CIW;
      const int pix = e / CIW;
      const int pr = pix / PW;
      const int pc = pix % PW;
      const int iy = oy0 - dil + pr;
      const int ix = ox0 - dil + pc;
      const int ci = 4 * (w0 + cw);
      unsigned word = 0;
      if (ci < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const int8_t* p = xb + ((size_t)iy * W + ix) * Cin + ci;
        if (aligned) {
          word = *reinterpret_cast<const unsigned*>(p);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (ci + k < Cin) word |= (unsigned)(uint8_t)p[k] << (8 * k);
        }
      }
      s_in[(cw * PH + pr) * PW + pc] = (int)word;
    }
    __syncthreads();
    const int ncw = min(CIW, CW - w0);
    for (int cw = 0; cw < ncw; ++cw) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int4* wp = reinterpret_cast<const int4*>(
              s_w + ((ky * 3 + kx) * CIW + cw) * TC + g * CG);
          const int4 wa = wp[0], wb = wp[1];
          const int wv[CG] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
          const int* ip =
              s_in + (cw * PH + 2 * qy + ky * dil) * PW + 2 * qx + kx * dil;
          const int i00 = ip[0], i01 = ip[1], i10 = ip[PW], i11 = ip[PW + 1];
#pragma unroll
          for (int j = 0; j < CG; ++j) {
            acc[0][j] = __dp4a(i00, wv[j], acc[0][j]);
            acc[1][j] = __dp4a(i01, wv[j], acc[1][j]);
            acc[2][j] = __dp4a(i10, wv[j], acc[2][j]);
            acc[3][j] = __dp4a(i11, wv[j], acc[3][j]);
          }
        }
      }
    }
  }

  const int oy = oy0 + 2 * qy;
  const int ox = ox0 + 2 * qx;
  const int cb = co0 + g * CG;
  if (oy >= H || ox >= W || cb >= Cout) return;
  // a thread's 8 channels are one 8-byte int8 store and one 16-byte bf16
  // load / store when Cout is a multiple of 8
  const bool vec = (Cout % CG == 0);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int yy = oy + p / 2;
    const int xx = ox + p % 2;
    if (yy >= H || xx >= W) continue;
    const size_t base = (((size_t)bi * H + yy) * W + xx) * Cout + cb;
    __align__(16) __nv_bfloat16 sk[CG];
    __align__(16) __nv_bfloat16 yb[CG];
    __align__(8) int8_t qv[CG];
    if (ep.skip != nullptr) {
      if (vec) {
        *reinterpret_cast<uint4*>(sk) =
            *reinterpret_cast<const uint4*>(ep.skip + base);
      } else {
        for (int j = 0; j < CG; ++j)
          if (cb + j < Cout) sk[j] = ep.skip[base + j];
      }
    }
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int c = min(cb + j, Cout - 1);
      float y = __fadd_rn(
          __fmul_rn(__int2float_rn(acc[p][j]), ep.mult[c]), ep.bias[c]);
      y = lrelu_rn(y, ep.alpha);
      float r;
      if (ep.f32_requant) {
        r = rintf(__fmul_rn(y, ep.inv));
      } else {
        float v = bf16_rn(y);
        if (ep.skip != nullptr)
          v = bf16_rn(__fadd_rn(v, __bfloat162float(sk[j])));
        yb[j] = __float2bfloat16_rn(v);  // exact: v is a bf16 value
        if (ep.post_lrelu) v = bf16_rn(lrelu_rn(v, ep.alpha));
        // two bf16 values multiply exactly in f32; round the product to bf16
        r = rintf(bf16_rn(__fmul_rn(v, ep.inv)));
      }
      qv[j] = (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
    }
    if (vec) {
      *reinterpret_cast<uint2*>(ep.q_out + base) =
          *reinterpret_cast<const uint2*>(qv);
      if (ep.y_out != nullptr)
        *reinterpret_cast<uint4*>(ep.y_out + base) =
            *reinterpret_cast<const uint4*>(yb);
    } else {
      for (int j = 0; j < CG; ++j) {
        if (cb + j >= Cout) break;
        ep.q_out[base + j] = qv[j];
        if (ep.y_out != nullptr) ep.y_out[base + j] = yb[j];
      }
    }
  }
}

size_t qconv_smem_bytes(int dil) {
  return sizeof(int) * (9 * CIW * TC + CIW * (TH + 2 * dil) * (TW + 2 * dil));
}

int packed_words(int Cin, int Cout) { return 9 * ((Cin + 3) / 4) * Cout; }

// Packs w into `packed`, then launches the conv; returns cudaGetLastError().
cudaError_t launch_qconv(const int8_t* x, const int8_t* w, int* packed,
                         const QEpilogue& ep, int B, int H, int W, int Cin,
                         int Cout, int dil, cudaStream_t stream) {
  const int n = packed_words(Cin, Cout);
  pack_weights_kernel<<<(n + 255) / 256, 256, 0, stream>>>(w, packed, Cin,
                                                           Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  qconv3x3_kernel<<<pe::conv3x3_grid(B, H, W, Cout), NTHREADS,
                    qconv_smem_bytes(dil), stream>>>(x, packed, ep, H, W, Cin,
                                                     Cout, dil);
  return cudaGetLastError();
}

}  // namespace

// One int8 encoder stage. x (B, H, W, Cin) int8; wK (3, 3, Cin|Cout, Cout)
// int8; mK, bK (Cout,) f32; packed: int32 workspace of 9 * (ceil(Cin/4) +
// 2 * ceil(Cout/4)) * Cout words; q1, q2 int8 and y1, y2 bf16 workspaces and
// out int8, all (B, H, W, Cout). inv_*: bf16-representable requant
// multipliers. Returns the first nonzero cudaGetLastError().
extern "C" int pe_fused_quantized_stage(
    const void* x, const void* w1, const void* m1, const void* b1,
    const void* w2, const void* m2, const void* b2, const void* w3,
    const void* m3, const void* b3, void* packed, void* q1, void* y1,
    void* q2, void* y2, void* out, int B, int H, int W, int Cin, int Cout,
    int dil, float alpha, float inv_s2, float inv_s3, float inv_out, int pool,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pk1 = static_cast<int*>(packed);
  int* pk2 = pk1 + packed_words(Cin, Cout);
  int* pk3 = pk2 + packed_words(Cout, Cout);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](const void* p) { return static_cast<const int8_t*>(p); };
  __nv_bfloat16* f1 = static_cast<__nv_bfloat16*>(y1);
  __nv_bfloat16* f2 = static_cast<__nv_bfloat16*>(y2);
  int8_t* i1 = static_cast<int8_t*>(q1);
  int8_t* i2 = static_cast<int8_t*>(q2);

  QEpilogue e1{f(m1), f(b1), nullptr, f1, i1, inv_s2, alpha, 0, 0};
  cudaError_t e =
      launch_qconv(w(x), w(w1), pk1, e1, B, H, W, Cin, Cout, dil, s);
  if (e != cudaSuccess) return (int)e;
  QEpilogue e2{f(m2), f(b2), f1, f2, i2, inv_s3, alpha, 0, 0};
  e = launch_qconv(i1, w(w2), pk2, e2, B, H, W, Cout, Cout, dil, s);
  if (e != cudaSuccess) return (int)e;
  QEpilogue e3{f(m3), f(b3), f2, nullptr, static_cast<int8_t*>(out),
               inv_out, alpha, pool, 0};
  e = launch_qconv(i2, w(w3), pk3, e3, B, H, W, Cout, Cout, dil, s);
  return (int)e;
}

// One int8 conv with its dequant, LReLU and float32 requant. packed: int32
// workspace of 9 * ceil(Cin/4) * Cout words.
extern "C" int pe_quantized_conv3x3(
    const void* x, const void* w, const void* mult, const void* bias,
    void* packed, void* out, int B, int H, int W, int Cin, int Cout, int dil,
    float alpha, float inv_out, void* stream) {
  QEpilogue ep{static_cast<const float*>(mult),
               static_cast<const float*>(bias),
               nullptr,
               nullptr,
               static_cast<int8_t*>(out),
               inv_out,
               alpha,
               0,
               1};
  return (int)launch_qconv(static_cast<const int8_t*>(x),
                           static_cast<const int8_t*>(w),
                           static_cast<int*>(packed), ep, B, H, W, Cin, Cout,
                           dil, static_cast<cudaStream_t>(stream));
}
