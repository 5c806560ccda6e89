// Fused torch-flavour transposed-conv decoder for Hopper (sm_90a).
//
// Replaces pose_estimation_amitai_tpu/ops/pallas_deconv.py::fused_decoder
// (Pallas kernel _decoder_kernel, tap tables _up_taps, _s1_taps, and the XLA
// phase interleave after the call):
//
//   t1 = LReLU(up2(latent, W1) + b1)           cin -> mid, rounded
//   t2 = LReLU(conv(t1, W2) + b2) + t1         mid -> mid, rounded
//   t3 = LReLU(conv(t2, W3) + b3) + t2         mid -> mid, rounded
//   y  = LReLU(up2(t3, W4) + b4)               mid -> K, in latent's dtype
//
// Weights are flax ConvTranspose HWIO kernels, used as they are. A stride-1
// flax ConvTranspose(SAME) is an unflipped SAME correlation, so t2 and t3
// are the encoder's conv3x3 at dilation 1 (conv_tile.cuh, or in bf16 the
// tensor-core conv3x3_wgmma_kernel of conv_mma.cuh, as the wrapper says). The
// torch-flavour stride-2 layer (ConvTranspose2d p=1, op=1) is, per axis,
//   y[2j] = x[j] . W[1],   y[2j+1] = x[j] . W[0] + x[j+1] . W[2]
// (x beyond the edge is zero), so one input position (j, l) and its three
// right/lower neighbours give the four output phases y[2j+a, 2l+c] using
// each of the 9 taps once. Both up2 kernels write the 2x2 output quads
// straight into the interleaved (B, 2R, 2W, Cout) map, so no separate
// permute pass exists. In bf16 with Cin a multiple of 16 the layer runs
// up2_mma_kernel (deconv_mma.cuh: four phase GEMMs on the tensor cores that
// share their A fragments); in float32, where TF32 would break the 1e-4
// limit, and for every other Cin, up2_kernel below (f32 FMAs on the CUDA
// cores, one input position and 8 channels a thread). The wrapper names the
// kernel of each layer; nothing here falls from one to the other.
//
// What bounds it on this card. At the flagship shape ((B, 48, 48, 256) ->
// (B, 192, 192, 18), mid 128) a frame costs 1.4 + 2.7 + 2.7 + 0.4 GFLOP
// against about 21 MB of bf16 activations moved by the four launches (each
// 96 x 96 x 128 intermediate written once, read twice as conv input and
// skip): some 340 FLOP per byte over the whole decoder, so on the tensor
// cores layers 1 to 3 are bound by their rate and the head (104 operations a
// byte) by memory; on the CUDA cores (float32) every layer is bound by
// operations, and up2_kernel's head issues as if K were 64 (K = 18 fills 3
// of its 8 channel groups).
//
// What the design does about it. The TPU kernel keeps all intermediates of
// a frame in VMEM; at 96 x 96 x 128 they do not fit an SM's 227 KB, so here
// the decoder is four launches with two workspace buffers the wrapper
// allocates (t3 reuses t1's), each with its epilogue (bias, LReLU, skip,
// rounding, interleaved store) fused. It takes any cin, mid and K; the
// Mosaic limits (cin a multiple of 128 up to 256, mid <= 128, K padded to
// 32) do not carry over.

#include <type_traits>

#include "conv_mma.cuh"
#include "deconv_mma.cuh"

namespace {

using pe::CG;
using pe::CIC;
using pe::GROUPS;
using pe::NTHREADS;
using pe::QW;
using pe::TC;

constexpr int QH = pe::TH / 2;  // input rows per block (4)
constexpr int PH = QH + 1;      // + the row below
constexpr int PW = QW + 1;      // + the col to the right

// x (B, R, Wd, Cin) -> out (B, 2R, 2Wd, Cout) = LReLU(up2(x, w) + b).
// grid = (ceil(R/QH) * ceil(Wd/QW), ceil(Cout/TC), B).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
up2_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const float* __restrict__ bias, T* __restrict__ out, int R, int Wd,
           int Cin, int Cout, float alpha) {
  __shared__ __align__(16) float s_w[9 * CIC * TC];
  __shared__ float s_in[CIC * PH * PW];

  const int tiles_w = (Wd + QW - 1) / QW;
  const int j0 = (blockIdx.x / tiles_w) * QH;
  const int l0 = (blockIdx.x % tiles_w) * QW;
  const int co0 = blockIdx.y * TC;
  const int bi = blockIdx.z;
  const int g = threadIdx.x % GROUPS;
  const int q = threadIdx.x / GROUPS;
  const int qy = q / QW;
  const int qx = q % QW;

  const T* xb = x + (size_t)bi * R * Wd * Cin;
  // acc[a][c]: output phase (row parity a, col parity c)
  float acc[2][2][CG];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < CG; ++j) acc[a][c][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CIC) {
    __syncthreads();
    pe::stage_weights(s_w, w, c0, co0, Cin, Cout);
    pe::stage_patch(s_in, xb, j0, l0, PH, PW, c0, R, Wd, Cin);
    __syncthreads();
    const int ncin = min(CIC, Cin - c0);
    for (int ci = 0; ci < ncin; ++ci) {
      const float* ip = s_in + (ci * PH + qy) * PW + qx;
      const float x00 = ip[0], x01 = ip[1], x10 = ip[PW], x11 = ip[PW + 1];
      const float* wp = s_w + ci * TC + g * CG;
      float wv[CG];
      // W[ky][kx] sits at wp + (3 * ky + kx) * CIC * TC
#define PE_TAP(ky, kx, xin, a, c)                           \
  pe::load_w8(wp + (3 * (ky) + (kx)) * CIC * TC, wv);       \
  _Pragma("unroll") for (int j = 0; j < CG; ++j)            \
      acc[a][c][j] = fmaf(xin, wv[j], acc[a][c][j]);
      PE_TAP(1, 1, x00, 0, 0)
      PE_TAP(1, 0, x00, 0, 1)
      PE_TAP(1, 2, x01, 0, 1)
      PE_TAP(0, 1, x00, 1, 0)
      PE_TAP(2, 1, x10, 1, 0)
      PE_TAP(0, 0, x00, 1, 1)
      PE_TAP(0, 2, x01, 1, 1)
      PE_TAP(2, 0, x10, 1, 1)
      PE_TAP(2, 2, x11, 1, 1)
#undef PE_TAP
    }
  }

  const int jj = j0 + qy;
  const int ll = l0 + qx;
  const int cb = co0 + g * CG;
  if (jj >= R || ll >= Wd || cb >= Cout) return;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      T* o = out + (((size_t)bi * 2 * R + 2 * jj + a) * 2 * Wd + 2 * ll + c) *
                       Cout;
#pragma unroll
      for (int j = 0; j < CG; ++j)
        if (cb + j < Cout)
          o[cb + j] = pe::from_f32<T>(
              pe::lrelu(acc[a][c][j] + bias[cb + j], alpha));
    }
  }
}

template <typename T>
cudaError_t launch_up2(const T* x, const T* w, const float* b, T* out, int B,
                       int R, int Wd, int Cin, int Cout, float alpha,
                       cudaStream_t s) {
  const dim3 grid(((R + QH - 1) / QH) * ((Wd + QW - 1) / QW),
                  (Cout + TC - 1) / TC, B);
  up2_kernel<T><<<grid, NTHREADS, 0, s>>>(x, w, b, out, R, Wd, Cin, Cout,
                                           alpha);
  return cudaGetLastError();
}

// One stride-2 layer by the kernel the caller names: kind 0 = up2_kernel
// (any dtype and shape), 1 = up2_mma_kernel (bf16, Cin a multiple of 16).
template <typename T>
cudaError_t launch_up2_kind(const T* x, const T* w, const float* b, T* out,
                            int B, int R, int Wd, int Cin, int Cout,
                            float alpha, int kind, cudaStream_t s) {
  if (kind == 0) return launch_up2<T>(x, w, b, out, B, R, Wd, Cin, Cout, alpha, s);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (kind == 1)
      return pe::launch_up2_mma(x, w, b, out, B, R, Wd, Cin, Cout, alpha, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int decoder(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, const void* w3, const void* b3, const void* w4,
            const void* b4, void* ws1, void* ws2, void* out, int B, int R,
            int Wd, int Cin, int Mid, int K, float alpha, int conv_kind,
            int up2_kind1, int up2_kind4, cudaStream_t s) {
  T* t1 = static_cast<T*>(ws1);
  T* t2 = static_cast<T*>(ws2);
  T* t3 = t1;  // t1 is dead once t2 exists
  const int R2 = 2 * R, W2 = 2 * Wd;
  cudaError_t e = launch_up2_kind<T>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), t1, B, R, Wd, Cin, Mid, alpha, up2_kind1,
      s);
  if (e != cudaSuccess) return (int)e;
  e = pe::launch_conv3x3_kind<T>(t1, static_cast<const T*>(w2),
                                 static_cast<const float*>(b2), t1, t2, B, R2,
                                 W2, Mid, Mid, 1, alpha, 0, conv_kind, s);
  if (e != cudaSuccess) return (int)e;
  e = pe::launch_conv3x3_kind<T>(t2, static_cast<const T*>(w3),
                                 static_cast<const float*>(b3), t2, t3, B, R2,
                                 W2, Mid, Mid, 1, alpha, 0, conv_kind, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_up2_kind<T>(t3, static_cast<const T*>(w4),
                         static_cast<const float*>(b4), static_cast<T*>(out),
                         B, R2, W2, Mid, K, alpha, up2_kind4, s);
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (latent, weights, workspace and out;
// biases are always float32). ws1, ws2: (B, 2R, 2Wd, Mid) each. conv_kind:
// the kernel of the two stride-1 convs, 0 = conv3x3_kernel, 3 =
// conv3x3_wgmma_kernel (bf16, Mid a multiple of 16). up2_kind1, up2_kind4: the
// kernel of the two stride-2 layers, 0 = up2_kernel, 1 = up2_mma_kernel (bf16,
// the layer's input channels a multiple of 16). Returns the first nonzero
// cudaGetLastError().
extern "C" int pe_fused_decoder(int dtype, const void* x, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, const void* w3,
                                const void* b3, const void* w4,
                                const void* b4, void* ws1, void* ws2,
                                void* out, int B, int R, int Wd, int Cin,
                                int Mid, int K, float alpha, int conv_kind,
                                int up2_kind1, int up2_kind4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decoder<float>(x, w1, b1, w2, b2, w3, b3, w4, b4, ws1, ws2, out, B,
                          R, Wd, Cin, Mid, K, alpha, conv_kind, up2_kind1,
                          up2_kind4, s);
  if (dtype == 1)
    return decoder<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, w4, b4, ws1, ws2,
                                  out, B, R, Wd, Cin, Mid, K, alpha, conv_kind,
                                  up2_kind1, up2_kind4, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of up2_mma_kernel is launched with.
extern "C" long long pe_up2_mma_smem_bytes() {
  return (long long)pe::up2_mma_smem_bytes();
}
