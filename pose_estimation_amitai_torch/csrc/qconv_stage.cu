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
// and output a frame: thousands of operations per byte when every operand
// moves once, so the yardstick (operands once) is the int8 tensor cores'
// rate, 0.7 to 0.9 ms a stage at batch 256. But the stage is three launches
// and moves its workspace four times (q1 and q2 written and read as int8; y1
// and y2 written and read as bf16 skips): at stage 1 (192 x 192 x 64,
// unpooled) that is about 7.9 GB a call, 2.4 ms at 3.35 TB/s, and 1.2 and
// 0.6 ms at stages 2 and 3. With the products on the tensor cores the stage
// is bound by that workspace traffic at stage 1 and close to it at stage 2.
// The single conv (2.7 GOP against 4.7 MB a frame at 192 x 192 x 64) sits at
// the ridge: 0.36 ms of bytes, 0.35 ms of operations at batch 256.
//
// What the design does about it. Three kernels, and the wrapper names the
// one of each conv (ops/hopper_qconv.py: qconv_kernel_for); nothing here
// falls from one to the other.
//
// qconv3x3_mma_kernel (Cin a multiple of 32, Cout of 8) is an implicit GEMM
// on the int8 tensor cores, `mma.sync.m16n8k32` with int32 accumulation:
// M = output pixels, N = output channels, K = 9 taps x Cin, in chunks of
// 32 int8 channels: a block of 8 warps owns 16 x 16 pixels x 64 channels, a
// warp two tile rows x 64 channels in 64 int32
// accumulators; the input patch (tile + `dil` halo, 32 bytes a pixel, zero
// outside the image, swizzled halves) and the chunk's weights go through a
// ring of three `cp.async` stages; a tap is an address offset into the patch
// and `ldmatrix.x4` on it yields the int8 A fragment. `ldmatrix.trans`
// transposes 16-bit elements, not bytes, so B does not come from HWIO
// weights: the packed layout [tap][channel word][cout] (four input channels a
// 32-bit word) is the B fragment as it lies, b0 = packed[tap][8 chunk +
// tig][n], b1 the same 4 words on, read by plain loads from rows padded to
// 72 words so that the four `tig` rows of a load fall on distinct
// banks. The n8 tiles take their columns from the channels in steps of 4
// (tile nt < 4, column n = channel 4 n + nt; the upper four tiles 32 on), so a
// lane's b0 of four tiles is one 128-bit load, and its accumulators of a
// pixel are 8 consecutive channels: the epilogue runs on the registers, one
// 16-byte bf16 skip load and y store and one 8-byte int8 store, and the int32
// tile never goes through shared memory. The sums are exact in any order,
// and the epilogue is the one routine both kernels call, so the outputs do
// not depend on the kernel.
//
// qconv3x3_c4_mma_kernel (Cin 4, Cout a multiple of 8: the encoder's first
// conv, 43 GOP against 1.8 GB written at batch 256, bound by those bytes)
// takes the nine taps of a pixel as the contraction, 36 int8 padded to two
// k32 steps, with the same tile, channel order and epilogue; on the CUDA
// cores that conv took 1.4 ms of the stage, one staged word a pixel a chunk.
//
// qconv3x3_kernel (every other shape) multiplies with __dp4a on the CUDA
// cores on conv_tile.cuh's tiling: a
// block of 256 threads owns 8 x 16 pixels x 64 output channels, a thread one
// 2x2 quad x 8 channels in 32 int32 accumulators; one __dp4a takes an
// activation word and a packed weight word. Cin and Cout are arbitrary
// (words and channel groups are masked).
//
// Weights are packed once, when a model's layers are moved to the device
// (pe_pack_qconv_weights), not at every launch. Taps outside the image are
// zero at staging time, so the TPU kernel's mask passes, its 128-lane slabs,
// 32-aligned widths and row tiles have no counterpart. As in encoder_stage.cu
// the stage is three launches with q1/y1/q2/y2 in a workspace the wrapper
// allocates. The 2x2 pool stays with the caller (it max-pools the int8
// output): fusing it moves no bound.

#include <stdint.h>

#include "conv_tile.cuh"
#include "mma_tile.cuh"

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

// mult and bias of the 8 output channels cb .. (past Cout: the last one's)
struct QScale {
  float mult[CG];
  float bias[CG];
};

__device__ __forceinline__ QScale load_scale(const QEpilogue& ep, int cb,
                                             int Cout) {
  QScale s;
  if (Cout % CG == 0) {  // cb is a multiple of 8: whole 16-byte pieces
#pragma unroll
    for (int j = 0; j < CG; j += 4) {
      const float4 m = *reinterpret_cast<const float4*>(ep.mult + cb + j);
      const float4 b = *reinterpret_cast<const float4*>(ep.bias + cb + j);
      s.mult[j] = m.x; s.mult[j + 1] = m.y; s.mult[j + 2] = m.z; s.mult[j + 3] = m.w;
      s.bias[j] = b.x; s.bias[j + 1] = b.y; s.bias[j + 2] = b.z; s.bias[j + 3] = b.w;
    }
    return s;
  }
#pragma unroll
  for (int j = 0; j < CG; ++j) {
    const int c = min(cb + j, Cout - 1);
    s.mult[j] = ep.mult[c];
    s.bias[j] = ep.bias[c];
  }
  return s;
}

// a, b rounded to bf16 (one instruction for the pair)
__device__ __forceinline__ __nv_bfloat162 bf16x2_rn(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

// The epilogue of 8 consecutive output channels cb .. of one pixel, whose
// first element in the (B, H, W, Cout) maps is `base`: dequant, bias, LReLU,
// skip (SKIP: ep.skip is not null), requant (F32: the single conv's float32
// one), stores. Every float step rounds on its own, two channels at a time.
// With Cout a multiple of 8 the channels are one 8-byte int8 store and one
// 16-byte bf16 load / store. The clip comes before the rounding to integer:
// the bounds are integers, so the order does not matter.
template <bool SKIP, bool F32>
__device__ __forceinline__ void q_epilogue8(const int (&acc)[CG],
                                            const QScale& sc,
                                            const QEpilogue& ep, size_t base,
                                            int cb, int Cout) {
  const bool vec = (Cout % CG == 0);
  __align__(16) __nv_bfloat162 sk[CG / 2];
  __align__(16) __nv_bfloat162 yb[CG / 2];
  __align__(8) int8_t qv[CG];
  if (SKIP) {
    if (vec) {
      *reinterpret_cast<uint4*>(sk) =
          *reinterpret_cast<const uint4*>(ep.skip + base);
    } else {
      __nv_bfloat16* s1 = reinterpret_cast<__nv_bfloat16*>(sk);
      for (int j = 0; j < CG; ++j)
        s1[j] = cb + j < Cout ? ep.skip[base + j] : __float2bfloat16_rn(0.f);
    }
  }
#pragma unroll
  for (int j = 0; j < CG; j += 2) {
    const float y0 = lrelu_rn(
        __fadd_rn(__fmul_rn(__int2float_rn(acc[j]), sc.mult[j]), sc.bias[j]),
        ep.alpha);
    const float y1 = lrelu_rn(
        __fadd_rn(__fmul_rn(__int2float_rn(acc[j + 1]), sc.mult[j + 1]),
                  sc.bias[j + 1]),
        ep.alpha);
    float2 r;
    if (F32) {
      r = make_float2(__fmul_rn(y0, ep.inv), __fmul_rn(y1, ep.inv));
    } else {
      __nv_bfloat162 vb = bf16x2_rn(y0, y1);
      if (SKIP) {
        const float2 v = __bfloat1622float2(vb);
        const float2 s2 = __bfloat1622float2(sk[j / 2]);
        vb = bf16x2_rn(__fadd_rn(v.x, s2.x), __fadd_rn(v.y, s2.y));
      }
      yb[j / 2] = vb;
      float2 v = __bfloat1622float2(vb);
      if (ep.post_lrelu)
        v = __bfloat1622float2(
            bf16x2_rn(lrelu_rn(v.x, ep.alpha), lrelu_rn(v.y, ep.alpha)));
      // two bf16 values multiply exactly in f32; round the product to bf16
      r = __bfloat1622float2(
          bf16x2_rn(__fmul_rn(v.x, ep.inv), __fmul_rn(v.y, ep.inv)));
    }
    qv[j] = (int8_t)__float2int_rn(fminf(fmaxf(r.x, -127.f), 127.f));
    qv[j + 1] = (int8_t)__float2int_rn(fminf(fmaxf(r.y, -127.f), 127.f));
  }
  if (vec) {
    *reinterpret_cast<uint2*>(ep.q_out + base) =
        *reinterpret_cast<const uint2*>(qv);
    if (!F32 && ep.y_out != nullptr)
      *reinterpret_cast<uint4*>(ep.y_out + base) =
          *reinterpret_cast<const uint4*>(yb);
  } else {
    const __nv_bfloat16* y1 = reinterpret_cast<const __nv_bfloat16*>(yb);
    for (int j = 0; j < CG; ++j) {
      if (cb + j >= Cout) break;
      ep.q_out[base + j] = qv[j];
      if (!F32 && ep.y_out != nullptr) ep.y_out[base + j] = y1[j];
    }
  }
}

// The 2x2 quad of qconv3x3_kernel's thread: pixels (oy.., ox..), channels cb ..
template <bool SKIP, bool F32>
__device__ __forceinline__ void quad_epilogue(const int (&acc)[4][CG],
                                              const QEpilogue& ep, int bi,
                                              int oy, int ox, int cb, int H,
                                              int W, int Cout) {
  const QScale sc = load_scale(ep, cb, Cout);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int yy = oy + p / 2;
    const int xx = ox + p % 2;
    if (yy >= H || xx >= W) continue;
    q_epilogue8<SKIP, F32>(acc[p], sc, ep,
                           (((size_t)bi * H + yy) * W + xx) * Cout + cb, cb,
                           Cout);
  }
}

// The accumulators of qconv3x3_mma_kernel's thread. Accumulator row gid (and
// gid + 8) of tile row mt is pixel (2 warp + mt, gid (+ 8)); its columns
// 2 tig, 2 tig + 1 of the n8 tiles 4 g .. 4 g + 3 are that pixel's channels
// 32 g + 8 tig .. + 7 (Cout is a multiple of 8 there).
template <bool SKIP, bool F32>
__device__ __forceinline__ void mma_epilogue_s8(const int (&acc)[2][8][4],
                                                const QEpilogue& ep, int bi,
                                                int oy0, int ox0, int co0,
                                                int H, int W, int Cout) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int cb = co0 + 32 * g + CG * tig;
    if (cb >= Cout) continue;
    const QScale sc = load_scale(ep, cb, Cout);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int yy = oy0 + 2 * warp + mt, xx = ox0 + gid + 8 * h;
        if (yy >= H || xx >= W) continue;
        int a8[CG];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a8[j] = acc[mt][4 * g + j][2 * h];
          a8[4 + j] = acc[mt][4 * g + j][2 * h + 1];
        }
        q_epilogue8<SKIP, F32>(a8, sc, ep,
                               (((size_t)bi * H + yy) * W + xx) * Cout + cb,
                               cb, Cout);
      }
    }
  }
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
    const int ncw = min(CIW, CW - w0);  // only the words this chunk has
    for (int e = threadIdx.x; e < 9 * ncw * TC; e += NTHREADS) {
      const int co = e % TC;
      const int cw = (e / TC) % ncw;
      const int tap = e / (TC * ncw);
      int v = 0;
      if (co0 + co < Cout)
        v = packed[((size_t)tap * CW + w0 + cw) * Cout + co0 + co];
      s_w[(tap * CIW + cw) * TC + co] = v;
    }
    for (int e = threadIdx.x; e < ncw * PH * PW; e += NTHREADS) {
      const int cw = e % ncw;
      const int pix = e / ncw;
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
  if (ep.f32_requant)
    quad_epilogue<false, true>(acc, ep, bi, oy, ox, cb, H, W, Cout);
  else if (ep.skip != nullptr)
    quad_epilogue<true, false>(acc, ep, bi, oy, ox, cb, H, W, Cout);
  else
    quad_epilogue<false, false>(acc, ep, bi, oy, ox, cb, H, W, Cout);
}

size_t qconv_smem_bytes(int dil) {
  return sizeof(int) * (9 * CIW * TC + CIW * (TH + 2 * dil) * (TW + 2 * dil));
}

// ---- the tensor-core kernel ----

constexpr int QM_T = 16;        // output rows and columns of a block
constexpr int QM_C = 64;        // output channels of a block
constexpr int QM_KC = 32;       // int8 input channels of a staged chunk
constexpr int QM_KW = QM_KC / 4;  // ... as packed words
constexpr int QM_STAGES = 3;    // ring depth
constexpr int QM_THREADS = 256;   // 8 warps, two tile rows each
constexpr int QM_W_LD = QM_C + 8;  // words a staged weight row
constexpr int QM_W_BYTES = 9 * QM_KW * QM_W_LD * 4;  // a chunk's weights

size_t qconv_mma_smem_bytes(int dil) {
  const size_t npix = (size_t)(QM_T + 2 * dil) * (QM_T + 2 * dil);
  return QM_STAGES * (npix * pe::PATCH_PIX_BYTES + QM_W_BYTES) +
         npix * sizeof(int);
}

// The same function as qconv3x3_kernel for Cin a multiple of 32 and Cout a
// multiple of 8, H * W < 2^31. grid = (ceil(Cout/QM_C) * ceil(H/QM_T) *
// ceil(W/QM_T), B); dynamic shared memory qconv_mma_smem_bytes(dil).
//
// Shared memory: QM_STAGES stages of (patch, weights), then the table with
// the image pixel index of every patch pixel (mma_tile.cuh). A staged weight
// row is (tap, channel word): 64 words, one an output channel, padded to 72.
//
// SKIP, F32: the epilogue's form (q_epilogue8), fixed at compile time: with
// the three forms behind run-time branches in one kernel the registers they
// share spilled.
template <bool SKIP, bool F32>
__global__ void __launch_bounds__(QM_THREADS, 2)
qconv3x3_mma_kernel(const int8_t* __restrict__ x,
                    const int* __restrict__ packed, QEpilogue ep, int H, int W,
                    int Cin, int Cout, int dil) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int PW = QM_T + 2 * dil;
  const int npix = PW * PW;
  const uint32_t patch_bytes = npix * pe::PATCH_PIX_BYTES;
  const uint32_t stage_bytes = patch_bytes + QM_W_BYTES;
  const uint32_t ring = pe::smem_u32(smem_raw);
  int* pix_of = reinterpret_cast<int*>(smem_raw + QM_STAGES * stage_bytes);

  const int n_co = (Cout + QM_C - 1) / QM_C;
  const int tiles_w = (W + QM_T - 1) / QM_T;
  const int co0 = (blockIdx.x % n_co) * QM_C;
  const int tile = blockIdx.x / n_co;
  const int oy0 = (tile / tiles_w) * QM_T;
  const int ox0 = (tile % tiles_w) * QM_T;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const char* xb = reinterpret_cast<const char*>(x + (size_t)bi * H * W * Cin);
  const int CW = Cin / 4;

  pe::fill_patch_table(pix_of, PW, PW, oy0 - dil, ox0 - dil, H, W);
  __syncthreads();

  // chunk c (input channels 32 c ..) -> stage st of the ring
  auto load_chunk = [&](int c, int st) {
    const uint32_t sp = ring + st * stage_bytes;
    const uint32_t sw = sp + patch_bytes;
    pe::stage_patch(sp, pix_of, npix, xb + c * pe::PATCH_PIX_BYTES, Cin);
    const int* wc = packed + (size_t)c * QM_KW * Cout + co0;
    for (int i = threadIdx.x; i < 9 * QM_KW * (QM_C / 4); i += QM_THREADS) {
      const int r = i / (QM_C / 4), piece = i % (QM_C / 4);  // r = tap * 8 + cw
      const bool in = co0 + piece * 4 < Cout;
      pe::cp_async16(
          sw + (r * QM_W_LD + piece * 4) * 4,
          in ? wc + ((size_t)(r / QM_KW) * CW + r % QM_KW) * Cout + piece * 4
             : packed,
          in ? 16 : 0);
    }
  };

  // acc[mt][nt][4]: this warp's tile rows 2 warp + mt, channels nt * 8 ...
  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // this lane's ldmatrix rows: A row = patch pixel a_pix (+ the tap's offset,
  // + PW for the second tile row), half a_half. B: the n8 tile nt < 4 takes
  // the output channels 4 n + nt as its columns n, the tile nt >= 4 the
  // channels 32 + 4 n + (nt - 4), so a lane's b0 of four tiles are four
  // consecutive words of the staged row tap * 8 + tig (its b1 of row + 4):
  // one 128-bit load, and the four `tig` rows of a quarter warp fall on
  // distinct banks at a row pitch of 72 words.
  const int a_pix = 2 * warp * PW + (lane & 15);
  const int a_half = lane >> 4;

  const int chunks = Cin / QM_KC;
  load_chunk(0, 0);
  pe::cp_async_commit();
  if (chunks > 1) load_chunk(1, 1);
  pe::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    pe::cp_async_wait<1>();  // chunk c is here; chunk c + 1 may still load
    __syncthreads();         // ... for every thread; chunk c - 1 is consumed
    if (c + 2 < chunks) load_chunk(c + 2, (c + 2) % QM_STAGES);
    pe::cp_async_commit();   // (an empty group near the end)
    const uint32_t st_off = (c % QM_STAGES) * stage_bytes;
    const uint32_t sp = ring + st_off;
    const uint4* pb = reinterpret_cast<const uint4*>(
        smem_raw + st_off + patch_bytes + (tig * QM_W_LD + 4 * gid) * 4);
    // the taps as rolled loops: unrolled, their offsets (dil is a run-time
    // value) would each hold a register
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      int p0 = a_pix + ky * dil * PW;
#pragma unroll 1
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t a[2][4];
        pe::ldmatrix_x4(a[0], sp + pe::patch_offset(p0, a_half));
        pe::ldmatrix_x4(a[1], sp + pe::patch_offset(p0 + PW, a_half));
        // words 4 gid .. + 3 and 32 + 4 gid .. + 3 of rows tig and tig + 4
        const uint4 l0 = pb[0], l1 = pb[QM_W_LD], h0 = pb[8], h1 = pb[QM_W_LD + 8];
        const uint32_t b0[8] = {l0.x, l0.y, l0.z, l0.w, h0.x, h0.y, h0.z, h0.w};
        const uint32_t b1[8] = {l1.x, l1.y, l1.z, l1.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          pe::mma_s8(acc[0][nt], a[0], b0[nt], b1[nt]);
          pe::mma_s8(acc[1][nt], a[1], b0[nt], b1[nt]);
        }
        p0 += dil;
        pb += QM_KW * QM_W_LD / 4;
      }
    }
  }
  pe::cp_async_wait<0>();

  mma_epilogue_s8<SKIP, F32>(acc, ep, bi, oy0, ox0, co0, H, W, Cout);
}

// ---- the tensor-core kernel of a 4-channel input ----

constexpr int QC4_PATCH = (QM_T + 16) * (QM_T + 16);  // words, at dilation 8

// The same function for Cin == 4 (a pixel is one 32-bit word) and Cout a
// multiple of 8: the nine taps of a pixel are the contraction, 36 int8 padded
// to two k32 steps, so that the encoder's first conv runs on the tensor cores
// too and is left with its bytes (it writes 3 bytes a channel, reads 4 a
// pixel). Tiling, accumulators and epilogue are qconv3x3_mma_kernel's; nothing
// is staged in a ring. The patch (tile + halo, a word a pixel, zero outside
// the image) goes to shared memory once; the A fragment of a k step is four
// plain loads from it, since bytes 4 tig .. + 3 of row gid are the word of tap
// tig (+ 4 for a2, a3; tap 8 alone in the second step) of pixel gid; the B
// fragments of all eight n8 tiles, 24 words a lane, are read from the packed
// weights once, as 128-bit loads with qconv3x3_mma_kernel's channel order.
// grid as qconv3x3_mma_kernel; no dynamic shared memory. F32 as there (a
// first conv has no skip).
template <bool F32>
__global__ void __launch_bounds__(QM_THREADS, 2)
qconv3x3_c4_mma_kernel(const int* __restrict__ x,
                       const int* __restrict__ packed, QEpilogue ep, int H,
                       int W, int Cout, int dil) {
  __shared__ int patch[QC4_PATCH];
  const int PW = QM_T + 2 * dil;
  const int n_co = (Cout + QM_C - 1) / QM_C;
  const int tiles_w = (W + QM_T - 1) / QM_T;
  const int co0 = (blockIdx.x % n_co) * QM_C;
  const int tile = blockIdx.x / n_co;
  const int oy0 = (tile / tiles_w) * QM_T;
  const int ox0 = (tile % tiles_w) * QM_T;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int* xb = x + (size_t)bi * H * W;

  for (int p = threadIdx.x; p < PW * PW; p += QM_THREADS) {
    const int pr = p / PW, pc = p - pr * PW;
    const int iy = oy0 - dil + pr, ix = ox0 - dil + pc;
    patch[p] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? xb[iy * W + ix] : 0;
  }

  // b[s][nt]: k step 0 rows 4 tig .. (tap tig), k step 0 rows 16 + 4 tig ..
  // (tap 4 + tig), k step 1 rows 4 tig .. (tap 8 for tig 0, else nothing)
  uint32_t b[3][8];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int tap = 4 * s + tig;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int co = co0 + 32 * g + 4 * gid;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (tap < 9 && co < Cout)
        v = *reinterpret_cast<const uint4*>(packed + (size_t)tap * Cout + co);
      b[s][4 * g] = v.x; b[s][4 * g + 1] = v.y;
      b[s][4 * g + 2] = v.z; b[s][4 * g + 3] = v.w;
    }
  }
  // patch offsets of this lane's taps; a lane without a tap in the second
  // step reads tap 8 too (its B rows are zero)
  const int t1 = 4 + tig;
  const int off0 = (tig / 3) * dil * PW + (tig % 3) * dil;
  const int off1 = (t1 / 3) * dil * PW + (t1 % 3) * dil;
  const int off2 = 2 * dil * PW + 2 * dil;
  __syncthreads();

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    const int* row = patch + (2 * warp + mt) * PW + gid;
    const uint32_t a0[4] = {(uint32_t)row[off0], (uint32_t)row[off0 + 8],
                            (uint32_t)row[off1], (uint32_t)row[off1 + 8]};
    const uint32_t a1[4] = {(uint32_t)row[off2], (uint32_t)row[off2 + 8], 0u, 0u};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      pe::mma_s8(acc[mt][nt], a0, b[0][nt], b[1][nt]);
      pe::mma_s8(acc[mt][nt], a1, b[2][nt], 0u);
    }
  }
  mma_epilogue_s8<false, F32>(acc, ep, bi, oy0, ox0, co0, H, W, Cout);
}

// The grid of both tensor-core kernels.
dim3 qconv_mma_grid(int B, int H, int W, int Cout) {
  return dim3(((Cout + QM_C - 1) / QM_C) * ((H + QM_T - 1) / QM_T) *
                  ((W + QM_T - 1) / QM_T),
              B);
}

// Launches the instantiation for this epilogue form. The limit on dynamic
// shared memory is raised to what the widest halo needs, once per host
// thread and device; a launch still occupies only its own bytes.
template <bool SKIP, bool F32>
cudaError_t launch_qconv_mma(const int8_t* x, const int* packed,
                             const QEpilogue& ep, int B, int H, int W, int Cin,
                             int Cout, int dil, cudaStream_t stream) {
  thread_local int allowed_dev = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (allowed_dev != dev) {
    e = cudaFuncSetAttribute(qconv3x3_mma_kernel<SKIP, F32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)qconv_mma_smem_bytes(8));
    if (e != cudaSuccess) return e;
    allowed_dev = dev;
  }
  qconv3x3_mma_kernel<SKIP, F32>
      <<<qconv_mma_grid(B, H, W, Cout), QM_THREADS, qconv_mma_smem_bytes(dil),
         stream>>>(x, packed, ep, H, W, Cin, Cout, dil);
  return cudaGetLastError();
}

// One conv on packed weights by the kernel the caller names: kind 0 =
// qconv3x3_kernel (any shape), 1 = qconv3x3_mma_kernel, 2 =
// qconv3x3_c4_mma_kernel. Refuses what the kernel does not take; returns
// cudaGetLastError() after the launch.
cudaError_t launch_qconv(int kind, const int8_t* x, const int* packed,
                         const QEpilogue& ep, int B, int H, int W, int Cin,
                         int Cout, int dil, cudaStream_t stream) {
  if (dil < 1 || dil > 8) return cudaErrorInvalidValue;
  if (kind == 0) {
    qconv3x3_kernel<<<pe::conv3x3_grid(B, H, W, Cout), NTHREADS,
                      qconv_smem_bytes(dil), stream>>>(x, packed, ep, H, W,
                                                       Cin, Cout, dil);
    return cudaGetLastError();
  }
  if (Cout < 8 || Cout % 8 || (long long)H * W > 2147483647LL)
    return cudaErrorInvalidValue;
  if (kind == 2) {
    if (Cin != 4 || ep.skip != nullptr || ((size_t)x & 3))
      return cudaErrorInvalidValue;
    const dim3 grid = qconv_mma_grid(B, H, W, Cout);
    const int* x32 = reinterpret_cast<const int*>(x);
    if (ep.f32_requant)
      qconv3x3_c4_mma_kernel<true>
          <<<grid, QM_THREADS, 0, stream>>>(x32, packed, ep, H, W, Cout, dil);
    else
      qconv3x3_c4_mma_kernel<false>
          <<<grid, QM_THREADS, 0, stream>>>(x32, packed, ep, H, W, Cout, dil);
    return cudaGetLastError();
  }
  if (kind != 1 || Cin < QM_KC || Cin % QM_KC) return cudaErrorInvalidValue;
  if (ep.f32_requant)
    return launch_qconv_mma<false, true>(x, packed, ep, B, H, W, Cin, Cout, dil,
                                         stream);
  if (ep.skip != nullptr)
    return launch_qconv_mma<true, false>(x, packed, ep, B, H, W, Cin, Cout, dil,
                                         stream);
  return launch_qconv_mma<false, false>(x, packed, ep, B, H, W, Cin, Cout, dil,
                                        stream);
}

}  // namespace

// HWIO int8 weights w (3, 3, Cin, Cout) -> packed (9, ceil(Cin/4), Cout)
// int32, byte k of a word = w[tap][4 cw + k][co], zero beyond Cin.
extern "C" int pe_pack_qconv_weights(const void* w, void* packed, int Cin,
                                     int Cout, void* stream) {
  const int n = 9 * ((Cin + 3) / 4) * Cout;
  pack_weights_kernel<<<(n + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int*>(packed), Cin, Cout);
  return (int)cudaGetLastError();
}

// One int8 encoder stage. x (B, H, W, Cin) int8; pK: packed weights of conv K
// (pe_pack_qconv_weights); mK, bK (Cout,) f32; q1, q2 int8 and y1, y2 bf16
// workspaces and out int8, all (B, H, W, Cout). inv_*: bf16-representable
// requant multipliers. k1, k2, k3: the kernel of each conv, 0 =
// qconv3x3_kernel, 1 = qconv3x3_mma_kernel (its input channels a multiple of
// 32, Cout of 8), 2 = qconv3x3_c4_mma_kernel (4 input channels, no skip: the
// first conv only; Cout a multiple of 8). Returns the first nonzero
// cudaGetLastError().
extern "C" int pe_fused_quantized_stage(
    const void* x, const void* p1, const void* m1, const void* b1,
    const void* p2, const void* m2, const void* b2, const void* p3,
    const void* m3, const void* b3, void* q1, void* y1, void* q2, void* y2,
    void* out, int B, int H, int W, int Cin, int Cout, int dil, float alpha,
    float inv_s2, float inv_s3, float inv_out, int pool, int k1, int k2, int k3,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto pk = [](const void* p) { return static_cast<const int*>(p); };
  __nv_bfloat16* f1 = static_cast<__nv_bfloat16*>(y1);
  __nv_bfloat16* f2 = static_cast<__nv_bfloat16*>(y2);
  int8_t* i1 = static_cast<int8_t*>(q1);
  int8_t* i2 = static_cast<int8_t*>(q2);

  QEpilogue e1{f(m1), f(b1), nullptr, f1, i1, inv_s2, alpha, 0, 0};
  cudaError_t e = launch_qconv(k1, static_cast<const int8_t*>(x), pk(p1), e1,
                               B, H, W, Cin, Cout, dil, s);
  if (e != cudaSuccess) return (int)e;
  QEpilogue e2{f(m2), f(b2), f1, f2, i2, inv_s3, alpha, 0, 0};
  e = launch_qconv(k2, i1, pk(p2), e2, B, H, W, Cout, Cout, dil, s);
  if (e != cudaSuccess) return (int)e;
  QEpilogue e3{f(m3), f(b3), f2, nullptr, static_cast<int8_t*>(out),
               inv_out, alpha, pool, 0};
  e = launch_qconv(k3, i2, pk(p3), e3, B, H, W, Cout, Cout, dil, s);
  return (int)e;
}

// One int8 conv on packed weights with its dequant, LReLU and float32
// requant, by the kernel `kind` names (as k1 above).
extern "C" int pe_quantized_conv3x3(
    const void* x, const void* packed, const void* mult, const void* bias,
    void* out, int B, int H, int W, int Cin, int Cout, int dil, float alpha,
    float inv_out, int kind, void* stream) {
  QEpilogue ep{static_cast<const float*>(mult),
               static_cast<const float*>(bias),
               nullptr,
               nullptr,
               static_cast<int8_t*>(out),
               inv_out,
               alpha,
               0,
               1};
  return (int)launch_qconv(kind, static_cast<const int8_t*>(x),
                           static_cast<const int*>(packed), ep, B, H, W, Cin,
                           Cout, dil, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block of qconv3x3_mma_kernel is launched with at
// dilation `dil`.
extern "C" long long pe_qconv_mma_smem_bytes(int dil) {
  return (long long)qconv_mma_smem_bytes(dil);
}
