// Probe kernels for Hopper (sm_90a): small kernels that each exercise one
// feature a larger int8 kernel is built from.
//
// Replaces scripts/exp_im2col_bisect.py::run_case (Pallas bodies k_copy,
// k_stage, k_dyn_read, k_reshape, k_concat_dot) and
// scripts/exp_mosaic_probe.py::probe_int8_vector_arith, probe_grid and
// probe_int8_vector_in_grid. (run_full of the first script is the single
// int8 conv of qconv_stage.cu with a requant of 64; it is not written twice.)
//
//   copy            out = x
//   staged copies   out = x, through a zero-filled shared-memory tile with a
//                   halo of 2 pixels, in row tiles of 16:
//                     mode 0  read the tile's interior back
//                     mode 1  walk the tile in bands at a run-time row
//                             offset, read each band with its column halo,
//                             keep the interior columns
//                     mode 2  as mode 1, the band addressed through a flat
//                             pixel index and back
//   concat_dot      9-tap dilation-2 SAME int8 conv, all-ones weights, every
//                   output channel clip(sum, -127, 127): mode 3
//   int8_axpb       out = int8(a * 2 + b), wrapping as two's complement
//   grid_scale      out = x * 2.0f, one block per (rows, cols) slab
//   int8_in_grid    out = int8(((int32)x * 3 + 7) >> 2), one block per slab
//
// What bounds them on this card: bytes. Each moves its input once and its
// output once and does at most 9 * C integer adds a pixel; at 2.4 MB a frame
// they finish in microseconds and launch overhead dominates. The design does
// nothing about that: they exist to be right, each against its plain PyTorch
// version. The TPU versions' 224-wide, 32-aligned whole-frame staging buffer
// has no counterpart: a tile of 16 x 32 pixels and its halo fits the 48 KB
// of static shared memory at up to 64 channels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO = 2;   // the conv's dilation: one tap each side
constexpr int TR = 16;    // tile rows
constexpr int TW = 32;    // tile columns
constexpr int PR = TR + 2 * HALO;
constexpr int PW = TW + 2 * HALO;
constexpr int MAX_C = 64;
constexpr int THREADS = 256;

__global__ void copy_kernel(const int8_t* __restrict__ x,
                            int8_t* __restrict__ o, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    o[i] = x[i];
}

__device__ inline int8_t wrap8(int v) {
  return static_cast<int8_t>(static_cast<uint8_t>(v & 0xff));
}

// mode 0..2: the staged copies; mode 3: concat_dot. `band`: rows of a band.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
staged_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ o, int H,
              int W, int C, int band) {
  __shared__ __align__(16) int8_t tile[PR * PW * MAX_C];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TR;
  const long long frame = (long long)blockIdx.z * H * W * C;
  x += frame;
  o += frame;

  // zero-fill, then the pixels of the padded tile that lie inside the image
  for (int i = threadIdx.x; i < PR * PW * C; i += THREADS) tile[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < PR * PW * C; i += THREADS) {
    const int c = i % C, px = (i / C) % PW, py = i / (C * PW);
    const int yy = y0 + py - HALO, xx = x0 + px - HALO;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      tile[i] = x[((long long)yy * W + xx) * C + c];
  }
  __syncthreads();

  if (MODE == 0) {
    for (int i = threadIdx.x; i < TR * TW * C; i += THREADS) {
      const int c = i % C, px = (i / C) % TW, py = i / (C * TW);
      const int yy = y0 + py, xx = x0 + px;
      if (yy < H && xx < W)
        o[((long long)yy * W + xx) * C + c] =
            tile[((py + HALO) * PW + px + HALO) * C + c];
    }
  } else if (MODE == 1 || MODE == 2) {
    for (int r0 = 0; r0 < TR; r0 += band) {  // run-time offset and length
      for (int i = threadIdx.x; i < band * PW * C; i += THREADS) {
        int c, wc, wr;
        if (MODE == 1) {
          c = i % C; wc = (i / C) % PW; wr = i / (C * PW);
        } else {
          const int flat = i / C;  // (band * PW, C) and back to (band, PW, C)
          c = i - flat * C; wr = flat / PW; wc = flat - wr * PW;
        }
        if (r0 + wr >= TR) continue;  // a last band shorter than `band`
        const int8_t val = tile[((r0 + wr + HALO) * PW + wc) * C + c];
        const int yy = y0 + r0 + wr, xx = x0 + wc - HALO;
        if (wc >= HALO && wc < HALO + TW && yy < H && xx < W)
          o[((long long)yy * W + xx) * C + c] = val;
      }
    }
  } else {
    const int words = C / 4;
    for (int p = threadIdx.x; p < TR * TW; p += THREADS) {
      const int px = p % TW, py = p / TW;
      const int yy = y0 + py, xx = x0 + px;
      if (yy >= H || xx >= W) continue;
      int acc = 0;
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const int* src = reinterpret_cast<const int*>(
            tile + ((py + ky * HALO) * PW + px + kx * HALO) * C);
        for (int wd = 0; wd < words; ++wd)
          acc = __dp4a(src[wd], 0x01010101, acc);  // weights all ones
      }
      acc = max(-127, min(127, acc));
      const int8_t val = static_cast<int8_t>(acc);
      int8_t* dst = o + ((long long)yy * W + xx) * C;
      for (int c = 0; c < C; ++c) dst[c] = val;
    }
  }
}

__global__ void int8_axpb_kernel(const int8_t* __restrict__ a,
                                 const int8_t* __restrict__ b,
                                 int8_t* __restrict__ o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = wrap8((int)a[i] * 2 + (int)b[i]);
}

__global__ void grid_scale_kernel(const float* __restrict__ x,
                                  float* __restrict__ o, int slab) {
  const long long base = (long long)blockIdx.x * slab;
  for (int i = threadIdx.x; i < slab; i += blockDim.x)
    o[base + i] = x[base + i] * 2.0f;
}

__global__ void int8_in_grid_kernel(const int8_t* __restrict__ x,
                                    int8_t* __restrict__ o, int slab) {
  const long long base = (long long)blockIdx.x * slab;
  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    const int v = ((int)x[base + i] * 3 + 7) >> 2;  // arithmetic shift
    o[base + i] = wrap8(v);
  }
}

}  // namespace

extern "C" int pe_probe_copy(const void* x, void* o, long long n,
                             void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  copy_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(o), n);
  return (int)cudaGetLastError();
}

// mode 0 k_stage, 1 k_dyn_read, 2 k_reshape, 3 k_concat_dot; x, o contiguous
// (B, H, W, C) int8, C <= 64 (a multiple of 4 for mode 3), B <= 65535;
// band: rows of a band of modes 1 and 2 (1..16).
extern "C" int pe_probe_staged(int mode, const void* x, void* o, int B, int H,
                               int W, int C, int band, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || C > MAX_C ||
      band < 1 || band > TR || (mode == 3 && C % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(o);
  if (mode == 0)
    staged_kernel<0><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
  else if (mode == 1)
    staged_kernel<1><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
  else if (mode == 2)
    staged_kernel<2><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
  else if (mode == 3)
    staged_kernel<3><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int pe_probe_int8_axpb(const void* a, const void* b, void* o,
                                  long long n, void* stream) {
  if (n < 1 || (n + THREADS - 1) / THREADS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  int8_axpb_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int8_t*>(o), n);
  return (int)cudaGetLastError();
}

// x, o: (n, slab) contiguous; a grid of n blocks, one slab each.
extern "C" int pe_probe_grid_scale(const void* x, void* o, int n, int slab,
                                   void* stream) {
  if (n < 1 || slab < 1) return (int)cudaErrorInvalidValue;
  grid_scale_kernel<<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), slab);
  return (int)cudaGetLastError();
}

extern "C" int pe_probe_int8_in_grid(const void* x, void* o, int n, int slab,
                                     void* stream) {
  if (n < 1 || slab < 1) return (int)cudaErrorInvalidValue;
  int8_in_grid_kernel<<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(o), slab);
  return (int)cudaGetLastError();
}
