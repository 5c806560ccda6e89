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
// is an implicit GEMM on the tensor cores (conv_mma.cuh: `mma.sync` fed by
// `ldmatrix` from a three-stage `cp.async` ring of input patch and weight
// slab; the Cin = 4 first conv with its nine taps packed into one K of 48);
// in float32, and for bf16 channel counts off the tensor-core tiles, the
// register-tiled direct convolution of conv_tile.cuh. The wrapper names the
// kernel of each conv (`kinds`); nothing here falls from one to the other.
// Per-conv zero padding at staging time replaces the TPU kernel's halo
// masking (_mask_outside_image) and its row tiles; none of the Mosaic
// workarounds (128-lane chunks, the 8-aligned COL_ORG, the batch-<=8 map)
// carry over. Not done yet: the skip of conv2 and conv3 is that conv's own
// input and could come from the staged patch's centre instead of a second
// read; x1/x2 row bands resident in shared memory; `wgmma` in the main loop.

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
// conv3x3_kernel, 1 = conv3x3_mma_kernel, 2 = conv3x3_c4_mma_kernel (1 and 2
// bf16 only). Returns the first nonzero cudaGetLastError().
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

// Dynamic shared memory a block of conv3x3_mma_kernel (packed = 0) or
// conv3x3_c4_mma_kernel (packed = 1) is launched with at dilation `dil`.
extern "C" long long pe_conv_mma_smem_bytes(int dil, int packed) {
  return (long long)pe::conv3x3_mma_smem_bytes(dil, packed);
}
