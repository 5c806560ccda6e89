// Fused torch-flavour encoder stage for Hopper (sm_90a).
//
// Replaces pose_estimation_amitai_tpu/ops/pallas_conv.py::fused_encoder_stage
// (Pallas kernel _stage_kernel, helpers _conv_chunked, _mask_outside_image):
//
//   x1 = LReLU(conv(x)  + b1)          rounded to x's dtype
//   x2 = LReLU(conv(x1) + b2) + x1     rounded to x's dtype
//   y  = LReLU(conv(x2) + b3) + x2     [-> 2x2 max-pool -> LReLU]
//
// 3x3 convs, dilation `dil`, SAME zero borders, f32 accumulation.
//
// What bounds it on this card. At the flagship shapes (192x192x4 -> 96x96x64,
// 96x96x64 -> 48x48x128, 48x48x128 -> 48x48x256) a frame costs 5.6, 6.8 and
// 6.8 GFLOP in the three stages. The three launches of a stage move about
// 30, 14 and 8 MB of bf16 activations per frame (x read; x1 and x2 each
// written once and read twice, as conv input and as skip; y written): some
// 190, 500 and 880 FLOP per byte. This kernel computes in f32 on the CUDA
// cores (67 TFLOP/s peak, a ridge near 20 FLOP per byte), so it is compute
// bound at every stage and the HBM round trips of x1 and x2 cost little. On
// the bf16 tensor cores (ridge near 295 FLOP per byte) stage 1 would turn
// memory bound, which is when keeping x1/x2 on chip starts to pay.
//
// What the design does about it. x1 and x2 do not fit one SM's 227 KB at
// 192 x 192 x 64 channels, so the stage is three launches of one
// register-tiled direct convolution (conv_tile.cuh) with x1 and x2 in a
// workspace the wrapper allocates. Each launch fuses its whole epilogue:
// bias, LReLU, the residual add and, on the last, the 2x2 max-pool with the
// post-pool LReLU, so nothing else touches HBM. Per-conv zero padding at
// staging time replaces the TPU kernel's halo masking (_mask_outside_image)
// and its row tiles; none of the Mosaic workarounds (128-lane chunks, the
// 8-aligned COL_ORG, the batch-<=8 map) carry over. Next: wgmma on bf16
// tiles with x1/x2 row bands resident in shared memory.

#include "conv_tile.cuh"

namespace {

template <typename T>
int encoder_stage(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* w3,
                  const void* b3, void* ws1, void* ws2, void* out, int B,
                  int H, int W, int Cin, int Cout, int dil, float alpha,
                  int pool, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* x1 = static_cast<T*>(ws1);
  T* x2 = static_cast<T*>(ws2);
  cudaError_t e = pe::launch_conv3x3<T>(
      xt, static_cast<const T*>(w1), static_cast<const float*>(b1), nullptr,
      x1, B, H, W, Cin, Cout, dil, alpha, 0, s);
  if (e != cudaSuccess) return (int)e;
  e = pe::launch_conv3x3<T>(
      x1, static_cast<const T*>(w2), static_cast<const float*>(b2), x1, x2, B,
      H, W, Cout, Cout, dil, alpha, 0, s);
  if (e != cudaSuccess) return (int)e;
  e = pe::launch_conv3x3<T>(
      x2, static_cast<const T*>(w3), static_cast<const float*>(b3), x2,
      static_cast<T*>(out), B, H, W, Cout, Cout, dil, alpha, pool, s);
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights, workspace and out; biases
// are always float32). Returns the first nonzero cudaGetLastError().
extern "C" int pe_fused_encoder_stage(
    int dtype, const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, void* ws1, void* ws2,
    void* out, int B, int H, int W, int Cin, int Cout, int dil, float alpha,
    int pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return encoder_stage<float>(x, w1, b1, w2, b2, w3, b3, ws1, ws2, out, B,
                                H, W, Cin, Cout, dil, alpha, pool, s);
  if (dtype == 1)
    return encoder_stage<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, ws1, ws2,
                                        out, B, H, W, Cin, Cout, dil, alpha,
                                        pool, s);
  return (int)cudaErrorInvalidValue;
}
