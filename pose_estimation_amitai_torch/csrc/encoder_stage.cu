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
// 6.8 GFLOP in the three stages: at batch 256, 1.45, 1.76 and 1.76 ms of
// bf16 tensor-core work. The three launches of a stage move about 30, 14 and
// 8 MB of bf16 activations per frame (x read; x1 and x2 each written once and
// read twice, as conv input and as skip; y written): 2.3, 1.1 and 0.6 ms at
// batch 256. So on the tensor cores stage 1 is bound by those bytes and
// stages 2 and 3 by operations; in float32, on the CUDA cores (67 TFLOP/s),
// every stage is bound by operations.
//
// What the design does about it. x1 and x2 do not fit one SM's 227 KB at
// 192 x 192 x 64 channels, so the stage is three launches with x1 and x2 in a
// workspace the wrapper allocates, and each launch fuses its whole epilogue:
// bias, LReLU, the residual add and, on the last, the 2x2 max-pool with the
// post-pool LReLU, so nothing else touches device memory. In bf16 each conv
// is an implicit GEMM on the tensor cores (conv_mma.cuh): the stride-1 convs
// with Cin a multiple of 16 on conv3x3_wgmma_kernel, persistent and
// warp-specialised (a producer thread's TMA loads of the input patch and the
// per-tap weight tiles into `mbarrier` rings, four consumer warpgroups on
// `wgmma` with the 16 x 16 pixel tile's 64 or 128 output channels at once,
// the epilogue from registers); the Cin = 4 first conv on
// conv3x3_c4_mma_kernel, its nine taps packed into one K of 48. In float32,
// and for bf16 channel counts off the tensor-core tiles, the register-tiled
// direct convolution of conv_tile.cuh. What bounds each flagship conv on the
// card: stage 1's 64 -> 64 convs (192 x 192, dilation 2) sit near the ridge,
// their N = 64 tiles also at shared memory's rate (a k-step of a block reads
// 8 KB of A by `ldmatrix` and 8 KB of B for 128 tensor-core clocks: 128
// bytes a clock); stages 2 and 3 (and the decoder's 128 -> 128) are bound by
// operations, their tiles N = 128. Measured (H100 80GB HBM3, 700 W, batch
// 256): the multiply alone reaches 80% to 88% of the tensor cores' rate at
// N = 128 and 61% at N = 64; the epilogue, which does not overlap it, adds
// 3 to 6 us a tile (the skip's loads about half of it).
// The wrapper names the kernel of each conv (`kinds`); nothing here falls
// from one to the other. SAME padding is TMA's zero fill of the patch box
// (staging-time zeros in the other kernels), which replaces the TPU kernel's
// halo masking (_mask_outside_image) and its row tiles; none of the Mosaic
// workarounds (128-lane chunks, the 8-aligned COL_ORG, the batch-<=8 map)
// carry over. Not done yet: an epilogue that overlaps the next tile's
// multiply (warpgroups in ping-pong, or results staged in shared memory and
// written by TMA stores); the skip of conv2 and conv3 is that conv's own
// input and could come from the staged patch instead of a second read;
// weight tiles multicast to a cluster of two blocks; x1/x2 row bands
// resident in shared memory.

#include "conv_mma.cuh"

namespace {

template <typename T>
int encoder_stage(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* w3,
                  const void* b3, void* ws1, void* ws2, void* out, int B,
                  int H, int W, int Cin, int Cout, int dil, float alpha,
                  int pool, const int* kinds, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* x1 = static_cast<T*>(ws1);
  T* x2 = static_cast<T*>(ws2);
  cudaError_t e = pe::launch_conv3x3_kind<T>(
      xt, static_cast<const T*>(w1), static_cast<const float*>(b1), nullptr,
      x1, B, H, W, Cin, Cout, dil, alpha, 0, kinds[0], s);
  if (e != cudaSuccess) return (int)e;
  e = pe::launch_conv3x3_kind<T>(
      x1, static_cast<const T*>(w2), static_cast<const float*>(b2), x1, x2, B,
      H, W, Cout, Cout, dil, alpha, 0, kinds[1], s);
  if (e != cudaSuccess) return (int)e;
  e = pe::launch_conv3x3_kind<T>(
      x2, static_cast<const T*>(w3), static_cast<const float*>(b3), x2,
      static_cast<T*>(out), B, H, W, Cout, Cout, dil, alpha, pool, kinds[2], s);
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights, workspace and out; biases
// are always float32). k1, k2, k3: the kernel of each conv, 0 =
// conv3x3_kernel, 2 = conv3x3_c4_mma_kernel, 3 = conv3x3_wgmma_kernel (2 and
// 3 bf16 only). Returns the first nonzero cudaGetLastError().
extern "C" int pe_fused_encoder_stage(
    int dtype, const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, void* ws1, void* ws2,
    void* out, int B, int H, int W, int Cin, int Cout, int dil, float alpha,
    int pool, int k1, int k2, int k3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kinds[3] = {k1, k2, k3};
  if (dtype == 0)
    return encoder_stage<float>(x, w1, b1, w2, b2, w3, b3, ws1, ws2, out, B,
                                H, W, Cin, Cout, dil, alpha, pool, kinds, s);
  if (dtype == 1)
    return encoder_stage<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, ws1, ws2,
                                        out, B, H, W, Cin, Cout, dil, alpha,
                                        pool, kinds, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of conv3x3_c4_mma_kernel is launched with.
extern "C" long long pe_conv_c4_smem_bytes() {
  return (long long)pe::conv3x3_c4_smem_bytes();
}
