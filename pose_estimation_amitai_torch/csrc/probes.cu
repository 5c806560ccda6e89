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
//                   halo of 2 pixels:
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
// they take microseconds, so launch latency and the host's dispatch are what
// a caller sees. The TPU versions' 224-wide, 32-aligned whole-frame staging
// buffer is a Mosaic workaround and has no counterpart.
//
// Two kernels each, chosen by the caller (ops/hopper_probes.py names one by
// a rule on C and alignment; nothing here falls from one to the other):
//   KERNEL_VEC16  16 bytes a thread. The staged copies stage a tile of
//                 8 x 16 pixels and its halo (12 x 20 pixels, 15 KB at 64
//                 channels: 288 blocks for one 192 x 192 frame, two or more
//                 an SM) with 16-byte cp.async; pixels outside the image are
//                 fetched with a source size of 0, which is the zero fill.
//                 Indices come from compile-time divisors (the 16-byte
//                 pieces a pixel are a template argument), and neighbouring
//                 lanes store neighbouring 16 bytes. concat_dot stages one
//                 int32 channel sum a padded pixel (four __dp4a a piece):
//                 with all-ones weights every output channel is the clipped
//                 sum of nine of them, stored as C / 16 16-byte words. The
//                 flat probes run a 16-byte body with a scalar head and tail.
//                 Takes C a multiple of 16 and 16-byte aligned operands.
//   KERNEL_BYTE   one byte (one float) a thread; a zero-filled 16 x 32 pixel
//                 tile staged byte by byte. Takes every C <= 64 and any
//                 alignment.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int KERNEL_BYTE = 0;
constexpr int KERNEL_VEC16 = 1;

constexpr int HALO = 2;   // the conv's dilation: one tap each side
constexpr int MAX_C = 64;
constexpr int THREADS = 256;

// KERNEL_BYTE's staged tile
constexpr int TR = 16;    // tile rows
constexpr int TW = 32;    // tile columns
constexpr int PR = TR + 2 * HALO;
constexpr int PW = TW + 2 * HALO;

// KERNEL_VEC16's staged tile
constexpr int VTR = 8;
constexpr int VTW = 16;
constexpr int VPR = VTR + 2 * HALO;
constexpr int VPW = VTW + 2 * HALO;
constexpr int VTHREADS = 128;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Makes `device` current for one launch and restores the caller's device.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    cudaGetDevice(&prev_);
    if (prev_ != device_) cudaSetDevice(device_);
  }
  ~DeviceGuard() {
    if (prev_ != device_) cudaSetDevice(prev_);
  }

 private:
  int device_, prev_ = -1;
};

// ---------------------------------------------------------------------------
// KERNEL_BYTE
// ---------------------------------------------------------------------------
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

__device__ inline int8_t in_grid(int8_t v) {
  return wrap8(((int)v * 3 + 7) >> 2);  // arithmetic shift
}

__global__ void int8_in_grid_kernel(const int8_t* __restrict__ x,
                                    int8_t* __restrict__ o, int slab) {
  const long long base = (long long)blockIdx.x * slab;
  for (int i = threadIdx.x; i < slab; i += blockDim.x)
    o[base + i] = in_grid(x[base + i]);
}

// ---------------------------------------------------------------------------
// KERNEL_VEC16
// ---------------------------------------------------------------------------

// The padded tile (VPR x VPW pixels of P 16-byte pieces) of the block's
// frame -> shared memory at `tile`, zeros outside the image. Piece i is
// piece i % P of padded pixel i / P.
template <int P>
__device__ __forceinline__ void stage_tile_vec(uint32_t tile,
                                               const int8_t* x, int H, int W,
                                               int y0, int x0) {
  constexpr int C = 16 * P;
  for (int i = threadIdx.x; i < VPR * VPW * P; i += VTHREADS) {
    const int p = i / P, k = i - p * P;
    const int py = p / VPW, px = p - py * VPW;
    const int yy = y0 + py - HALO, xx = x0 + px - HALO;
    const bool in = (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W;
    pe::cp_async16(tile + i * 16, in ? x + (yy * W + xx) * C + k * 16 : x,
                   in ? 16 : 0);
  }
  pe::cp_async_commit();
  pe::cp_async_wait<0>();
  __syncthreads();
}

// modes 0..2 at C = 16 P
template <int P, int MODE>
__global__ void __launch_bounds__(VTHREADS)
staged_vec_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ o, int H,
                  int W, int band) {
  constexpr int C = 16 * P;
  __shared__ __align__(16) int4 tile[VPR * VPW * P];
  const int x0 = blockIdx.x * VTW, y0 = blockIdx.y * VTR;
  const long long frame = (long long)blockIdx.z * H * W * C;
  x += frame;
  o += frame;
  stage_tile_vec<P>(pe::smem_u32(tile), x, H, W, y0, x0);

  if (MODE == 0) {
    for (int i = threadIdx.x; i < VTR * VTW * P; i += VTHREADS) {
      const int p = i / P, k = i - p * P;
      const int py = p / VTW, px = p - py * VTW;
      const int yy = y0 + py, xx = x0 + px;
      if (yy < H && xx < W)
        *reinterpret_cast<int4*>(o + (yy * W + xx) * C + k * 16) =
            tile[((py + HALO) * VPW + px + HALO) * P + k];
    }
  } else {
    for (int r0 = 0; r0 < VTR; r0 += band) {  // run-time offset and length
      for (int i = threadIdx.x; i < band * VPW * P; i += VTHREADS) {
        int k, wc, wr;
        if (MODE == 1) {
          k = i % P; wc = (i / P) % VPW; wr = i / (P * VPW);
        } else {
          const int flat = i / P;  // (band * VPW, P) and back to (band, VPW, P)
          k = i - flat * P; wr = flat / VPW; wc = flat - wr * VPW;
        }
        if (r0 + wr >= VTR) break;  // a last band shorter than `band`
        const int4 val = tile[((r0 + wr + HALO) * VPW + wc) * P + k];
        const int yy = y0 + r0 + wr, xx = x0 + wc - HALO;
        if (wc >= HALO && wc < HALO + VTW && yy < H && xx < W)
          *reinterpret_cast<int4*>(o + (yy * W + xx) * C + k * 16) = val;
      }
    }
  }
}

// mode 3 at C = 16 P: channel sums of the padded tile, then nine a pixel
template <int P>
__global__ void __launch_bounds__(VTHREADS)
concat_dot_vec_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ o,
                      int H, int W) {
  constexpr int C = 16 * P;
  __shared__ int sums[VPR * VPW];
  const int x0 = blockIdx.x * VTW, y0 = blockIdx.y * VTR;
  const long long frame = (long long)blockIdx.z * H * W * C;
  x += frame;
  o += frame;

  // |sum| <= 9 taps * 64 channels * 128: exact in int32
  for (int p = threadIdx.x; p < VPR * VPW; p += VTHREADS) {
    const int py = p / VPW, px = p - py * VPW;
    const int yy = y0 + py - HALO, xx = x0 + px - HALO;
    int s = 0;
    if ((unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W) {
      const int4* src = reinterpret_cast<const int4*>(x + (yy * W + xx) * C);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int4 v = __ldg(src + k);
        s = __dp4a(v.x, 0x01010101, s);  // weights all ones
        s = __dp4a(v.y, 0x01010101, s);
        s = __dp4a(v.z, 0x01010101, s);
        s = __dp4a(v.w, 0x01010101, s);
      }
    }
    sums[p] = s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < VTR * VTW * P; i += VTHREADS) {
    const int p = i / P, k = i - p * P;
    const int py = p / VTW, px = p - py * VTW;
    const int yy = y0 + py, xx = x0 + px;
    if (yy >= H || xx >= W) continue;
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        acc += sums[(py + ky * HALO) * VPW + px + kx * HALO];
    acc = max(-127, min(127, acc));
    const int b = (acc & 0xff) * 0x01010101;  // the byte in each of four
    *reinterpret_cast<int4*>(o + (yy * W + xx) * C + k * 16) =
        make_int4(b, b, b, b);
  }
}

// The blocks of a flat probe over `nvec` 16-byte words: one word a thread,
// at most 16 blocks an SM's worth (grid-stride beyond).
unsigned flat_blocks(long long nvec) {
  const long long want = (nvec + THREADS - 1) / THREADS;
  return (unsigned)(want < 1 ? 1 : (want < 2112 ? want : 2112));
}

__global__ void copy_vec_kernel(const int4* __restrict__ x,
                                int4* __restrict__ o, long long nvec,
                                int tail) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += step)
    o[i] = x[i];
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {  // numel % 16 bytes
    const int8_t* xt = reinterpret_cast<const int8_t*>(x + nvec);
    reinterpret_cast<int8_t*>(o + nvec)[threadIdx.x] = xt[threadIdx.x];
  }
}

__device__ __forceinline__ uint32_t axpb4(uint32_t a, uint32_t b) {
  return __vadd4(__vadd4(a, a), b);  // per byte, modulo 256
}

__global__ void int8_axpb_vec_kernel(const int4* __restrict__ a,
                                     const int4* __restrict__ b,
                                     int4* __restrict__ o, long long nvec,
                                     int tail) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += step) {
    const int4 u = a[i], v = b[i];
    o[i] = make_int4(axpb4(u.x, v.x), axpb4(u.y, v.y), axpb4(u.z, v.z),
                     axpb4(u.w, v.w));
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    const int t = threadIdx.x;
    const int8_t* at = reinterpret_cast<const int8_t*>(a + nvec);
    const int8_t* bt = reinterpret_cast<const int8_t*>(b + nvec);
    reinterpret_cast<int8_t*>(o + nvec)[t] = wrap8((int)at[t] * 2 + (int)bt[t]);
  }
}

// Elements of T before a slab's first 16-byte boundary (x and o lie at the
// same offset from one: both are 16-byte aligned at their start).
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int slab) {
  const int bytes = (16 - (int)(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  return min(slab, bytes / (int)sizeof(T));
}

__global__ void grid_scale_vec_kernel(const float* __restrict__ x,
                                      float* __restrict__ o, int slab) {
  const long long base = (long long)blockIdx.x * slab;
  x += base;
  o += base;
  const int head = head_of(x, slab), nvec = (slab - head) >> 2;
  if ((int)threadIdx.x < head) o[threadIdx.x] = x[threadIdx.x] * 2.0f;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(o + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const float4 v = xv[i];
    ov[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
  for (int i = head + 4 * nvec + threadIdx.x; i < slab; i += blockDim.x)
    o[i] = x[i] * 2.0f;
}

__global__ void int8_in_grid_vec_kernel(const int8_t* __restrict__ x,
                                        int8_t* __restrict__ o, int slab) {
  const long long base = (long long)blockIdx.x * slab;
  x += base;
  o += base;
  const int head = head_of(x, slab), nvec = (slab - head) >> 4;
  if ((int)threadIdx.x < head) o[threadIdx.x] = in_grid(x[threadIdx.x]);
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  int4* ov = reinterpret_cast<int4*>(o + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    union { int4 v; int8_t b[16]; } u;
    u.v = xv[i];
#pragma unroll
    for (int j = 0; j < 16; ++j) u.b[j] = in_grid(u.b[j]);
    ov[i] = u.v;
  }
  for (int i = head + 16 * nvec + threadIdx.x; i < slab; i += blockDim.x)
    o[i] = in_grid(x[i]);
}

template <int P>
void launch_staged_vec(int mode, dim3 grid, cudaStream_t s, const int8_t* x,
                       int8_t* o, int H, int W, int band) {
  if (mode == 0)
    staged_vec_kernel<P, 0><<<grid, VTHREADS, 0, s>>>(x, o, H, W, band);
  else if (mode == 1)
    staged_vec_kernel<P, 1><<<grid, VTHREADS, 0, s>>>(x, o, H, W, band);
  else if (mode == 2)
    staged_vec_kernel<P, 2><<<grid, VTHREADS, 0, s>>>(x, o, H, W, band);
  else
    concat_dot_vec_kernel<P><<<grid, VTHREADS, 0, s>>>(x, o, H, W);
}

}  // namespace

// Every entry: `kernel` KERNEL_BYTE or KERNEL_VEC16, launched on `device`
// (made current for the launch) and `stream`; returns a cudaError_t. A
// kernel that does not take the operands returns cudaErrorInvalidValue.

extern "C" int pe_probe_copy(int kernel, const void* x, void* o, long long n,
                             int device, void* stream) {
  if (n < 1 || (kernel == KERNEL_VEC16 && !(aligned16(x) && aligned16(o))))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == KERNEL_BYTE) {
    const long long want = (n + THREADS - 1) / THREADS;
    const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
    copy_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const int8_t*>(x),
                                           static_cast<int8_t*>(o), n);
  } else if (kernel == KERNEL_VEC16) {
    copy_vec_kernel<<<flat_blocks(n / 16), THREADS, 0, s>>>(
        static_cast<const int4*>(x), static_cast<int4*>(o), n / 16,
        (int)(n % 16));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// mode 0 k_stage, 1 k_dyn_read, 2 k_reshape, 3 k_concat_dot; x, o contiguous
// (B, H, W, C) int8, C <= 64 (KERNEL_BYTE: a multiple of 4 for mode 3;
// KERNEL_VEC16: a multiple of 16, x and o 16-byte aligned, H W C < 2^31),
// B <= 65535; band: rows of a band of modes 1 and 2 (KERNEL_BYTE 1..16,
// KERNEL_VEC16 1..8).
extern "C" int pe_probe_staged(int kernel, int mode, const void* x, void* o,
                               int B, int H, int W, int C, int band,
                               int device, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || C > MAX_C ||
      band < 1 || band > (kernel == KERNEL_BYTE ? TR : VTR) || mode < 0 ||
      mode > 3)
    return (int)cudaErrorInvalidValue;
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == KERNEL_BYTE) {
    const dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
    if ((mode == 3 && C % 4) || grid.y > 65535)
      return (int)cudaErrorInvalidValue;
    DeviceGuard guard(device);
    if (mode == 0)
      staged_kernel<0><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
    else if (mode == 1)
      staged_kernel<1><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
    else if (mode == 2)
      staged_kernel<2><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
    else
      staged_kernel<3><<<grid, THREADS, 0, s>>>(xi, oi, H, W, C, band);
    return (int)cudaGetLastError();
  }
  if (kernel != KERNEL_VEC16) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + VTW - 1) / VTW, (H + VTR - 1) / VTR, B);
  if (C % 16 || !aligned16(x) || !aligned16(o) || grid.y > 65535 ||
      (long long)H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  switch (C / 16) {
    case 1: launch_staged_vec<1>(mode, grid, s, xi, oi, H, W, band); break;
    case 2: launch_staged_vec<2>(mode, grid, s, xi, oi, H, W, band); break;
    case 3: launch_staged_vec<3>(mode, grid, s, xi, oi, H, W, band); break;
    default: launch_staged_vec<4>(mode, grid, s, xi, oi, H, W, band); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int pe_probe_int8_axpb(int kernel, const void* a, const void* b,
                                  void* o, long long n, int device,
                                  void* stream) {
  if (n < 1 || (n + THREADS - 1) / THREADS > 2147483647LL ||
      (kernel == KERNEL_VEC16 &&
       !(aligned16(a) && aligned16(b) && aligned16(o))))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == KERNEL_BYTE) {
    int8_axpb_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                       s>>>(static_cast<const int8_t*>(a),
                            static_cast<const int8_t*>(b),
                            static_cast<int8_t*>(o), n);
  } else if (kernel == KERNEL_VEC16) {
    int8_axpb_vec_kernel<<<flat_blocks(n / 16), THREADS, 0, s>>>(
        static_cast<const int4*>(a), static_cast<const int4*>(b),
        static_cast<int4*>(o), n / 16, (int)(n % 16));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, o: (n, slab) contiguous; a grid of n blocks, one slab each.
extern "C" int pe_probe_grid_scale(int kernel, const void* x, void* o, int n,
                                   int slab, int device, void* stream) {
  if (n < 1 || slab < 1 ||
      (kernel == KERNEL_VEC16 && !(aligned16(x) && aligned16(o))))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(o);
  if (kernel == KERNEL_BYTE)
    grid_scale_kernel<<<n, THREADS, 0, s>>>(xf, of, slab);
  else if (kernel == KERNEL_VEC16)
    grid_scale_vec_kernel<<<n, THREADS, 0, s>>>(xf, of, slab);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int pe_probe_int8_in_grid(int kernel, const void* x, void* o,
                                     int n, int slab, int device,
                                     void* stream) {
  if (n < 1 || slab < 1 ||
      (kernel == KERNEL_VEC16 && !(aligned16(x) && aligned16(o))))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(o);
  if (kernel == KERNEL_BYTE)
    int8_in_grid_kernel<<<n, THREADS, 0, s>>>(xi, oi, slab);
  else if (kernel == KERNEL_VEC16)
    int8_in_grid_vec_kernel<<<n, THREADS, 0, s>>>(xi, oi, slab);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
