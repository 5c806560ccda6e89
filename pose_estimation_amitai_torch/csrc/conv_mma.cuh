// The SAME 3x3 dilated convolution of conv_tile.cuh as an implicit GEMM on
// the bf16 tensor cores (f32 accumulation), with the same fused epilogue.
// bf16 only; float32 keeps conv3x3_kernel (TF32 would break its 1e-4 limit).
// Which kernel a conv takes is the caller's choice (ops/hopper_conv.py:
// conv_kernel_for), passed down as `kind`.
//
// What bounds it. A flagship conv does 2 * 9 * Cin * Cout operations a
// pixel, against 2 (Cin + Cout) bytes or so: 100 to 1000 operations a byte,
// above the tensor cores' ridge (295) from Cin = Cout = 128 on, so the bound
// is the tensor cores' rate (stage 1's 64-channel convs sit near the ridge),
// and what stands between the kernel and it is feeding them: the latency of
// staging, the issue slots it takes from the multiply, and the bytes each
// staged tile is used for.
//
// What the design does about it: conv3x3_wgmma_kernel, a persistent,
// warp-specialised implicit GEMM. GEMM view: M = output pixels, N = output
// channels, K = 9 taps x Cin. A block owns 16 x 16 output pixels x N
// channels (N = 64 for Cout <= 64, else 128) and walks tiles in steps of the
// grid (one block an SM). One producer thread keeps TMA loads in flight into
// two rings of shared memory, each slot with a "full" and an "empty"
// `mbarrier`: the input patch of a 64-channel chunk (a box of 64 channels x
// (16 + 2 dil)^2 pixels of a 4-D tensor map over NHWC x, its coordinates
// starting at -dil: TMA's zero fill outside the image IS the SAME padding),
// and for each tap the 64 x N weight tile (one or two 64 x 64 boxes of a 3-D
// map over HWIO read as (Cout, Cin, tap); zero fill past Cin and Cout). Both
// arrive with the 128-byte swizzle. Four consumer warpgroups (setmaxnreg
// moves registers to them from the producer's) each own one m64 tile, 4 x 16
// pixels, and run `wgmma.mma_async.m64nNk16`: A from registers by `ldmatrix`
// on the swizzled patch, a tap being an address offset of (ky dil, kx dil)
// pixels into it (no im2col buffer exists); B from the weight slot by
// descriptor (MN-major). Every k-step of 16 channels is its own wgmma group;
// the next step's fragments are loaded and its group issued before the wait
// on the one before (`wait_group 1`), and the A fragments alternate between
// two register sets. A weight slot is released once the groups that read it
// are done; a patch slot once its last fragments are in registers. So each
// staged patch feeds all N channels and all 9 taps, and each weight tile 256
// pixels; the producer is up to the ring's depth ahead, across tiles too, so
// the next tile's loads overlap this tile's epilogue. Four consumer
// warpgroups of 64 accumulators a thread, rather than two of 128, because
// the epilogue does not overlap the multiply: 16 warps share it, each with
// half the work, and hide its load and store latency twice as well. Shared
// memory: two patch slots and up to six weight slots (one patch slot at the
// largest halos), conv3x3_wgmma_ring.
//
// Epilogue, from registers: a warp's m64 share is 2 rows x 8 columns of
// pixels, so a thread's accumulators hold a vertical pair and its quad
// neighbour (lane ^ 4) the horizontal one. LReLU(acc + bias), plus the skip
// (16-byte loads, quad-transposed to the accumulator layout), then either
// one rounding and 16-byte stores (quad-transposed back), or the
// NaN-propagating 2 x 2 max over the thread's pair and its neighbour's, the
// post-pool LReLU, one rounding and a 16-byte store; the same arithmetic in
// the same order as mma_epilogue below. Ragged tiles are masked there;
// Cout a multiple of 8 keeps the 16 bytes whole.
//
// The first conv of the encoder has Cin = 4, K = 36: conv3x3_c4_mma_kernel
// packs the nine taps of a pixel into one row of K = 48 at staging (8-byte
// `cp.async`, 4 channels a tap; columns 36..47 zero) and multiplies by the
// (36, Cout) weight matrix, which is HWIO as it lies, in three k-steps of
// `mma.sync.m16n8k16`. It writes 64 channels a pixel and is bound by those
// bytes. Its epilogue, mma_epilogue, goes as f32 through shared memory so
// that every thread then owns 8 consecutive channels of one output pixel,
// or of one 2 x 2 pool window.
//
// Not done yet: an epilogue that overlaps the next tile's multiply
// (consumer warpgroups in ping-pong on two tiles, or results staged in
// shared memory and written by TMA stores); the skip of conv2 and conv3 is
// that conv's own input and could come from the staged patch instead of a
// second read; a cluster of two blocks multicasting each weight tile
// (halving its L2 reads); x1/x2 row bands resident in shared memory across
// the stage.
#pragma once

#include "conv_tile.cuh"
#include "mma_tile.cuh"
#include "tensor_map.cuh"

namespace pe {

// ---- conv3x3_c4_mma_kernel's tiling ----
constexpr int MT = 16;            // output rows and columns of a block
constexpr int MC = 64;            // output channels of a block
constexpr int MTHREADS = 256;     // 8 warps, two tile rows each
constexpr int W_LD = MC + 8;      // bf16 a row of the packed conv's weights
constexpr int EPI_LD = MC + 8;    // f32 a pixel of the epilogue tile
constexpr int C4_K = 48;          // 9 taps x 4 channels, padded to 3 k-steps
constexpr int C4_LD = C4_K + 8;   // bf16 a packed pixel row (112 bytes)
constexpr size_t EPI_BYTES = sizeof(float) * MT * MT * EPI_LD;

inline size_t conv3x3_c4_smem_bytes() {
  const size_t c4 = 2 * (size_t)(MT * MT * C4_LD + C4_K * W_LD);
  return c4 > EPI_BYTES ? c4 : EPI_BYTES;
}

// ---- conv3x3_wgmma_kernel's tiling ----
constexpr int WG_TILE = 16;        // output rows and columns of a tile
constexpr int WG_KC = 64;          // input channels of a staged chunk
constexpr int WG_PIX_BYTES = 2 * WG_KC;  // a staged pixel: one 128-byte row
constexpr int WG_CONSUMERS = 4;    // consumer warpgroups, an m64 tile each
constexpr int WG_THREADS = 128 * (1 + WG_CONSUMERS);
// Registers a thread: what a launch of WG_THREADS gets, then setmaxnreg
// moves all but WG_REGS_PRODUCER of the producer's to the consumers.
constexpr int WG_REGS_LAUNCH = 65536 / WG_THREADS / 8 * 8;
constexpr int WG_REGS_PRODUCER = 32;
constexpr int WG_REGS_CONSUMER =
    WG_REGS_LAUNCH + (WG_REGS_LAUNCH - WG_REGS_PRODUCER) / WG_CONSUMERS / 8 * 8;
static_assert(WG_REGS_CONSUMER * WG_CONSUMERS + WG_REGS_PRODUCER <=
                  WG_REGS_LAUNCH * (1 + WG_CONSUMERS),
              "the consumers take no more than the producer gives up");
constexpr int WG_WS_MAX = 6;       // deepest weight ring
constexpr int WG_BAR_BYTES = 256;  // the rings' mbarriers
constexpr int WG_INFLIGHT = 1;     // wgmma groups left running at a wait
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block

constexpr int WG_MAX_DIL = 8;      // the widest halo the rings are sized for

// The output channels of a tile: 64 or 128.
constexpr int conv3x3_wgmma_n(int Cout) { return Cout <= 64 ? 64 : 128; }

// The rings at dilation `dil` and tile width `n`: patch slots (2 if two fit
// beside 4 weight slots, else 1), weight slots (as many as fit, up to 6) and
// the dynamic shared memory asked for (with 1024 bytes to align the start).
struct WgmmaRing {
  int patches, wstages;
  size_t bytes;
};
constexpr WgmmaRing conv3x3_wgmma_ring(int dil, int n) {
  const size_t side = WG_TILE + 2 * dil;
  const size_t patch = (side * side * WG_PIX_BYTES + 1023) & ~(size_t)1023;
  const size_t wt = (size_t)n * WG_KC * 2, fixed = 1024 + WG_BAR_BYTES;
  const int patches = fixed + 2 * patch + 4 * wt <= SMEM_LIMIT ? 2 : 1;
  size_t ws = (SMEM_LIMIT - fixed - patches * patch) / wt;
  if (ws > WG_WS_MAX) ws = WG_WS_MAX;
  return {patches, (int)ws, fixed + patches * patch + ws * wt};
}

// Every dilation the launch takes, at both tile widths, leaves room for two
// weight slots at least (the producer runs one ahead of the consumers), so
// the dispatch rule needs no figure of shared memory: 1 <= dil <= 8 is it.
constexpr bool conv3x3_wgmma_rings_fit() {
  for (int dil = 1; dil <= WG_MAX_DIL; ++dil)
    for (int n = 64; n <= 128; n += 64)
      if (conv3x3_wgmma_ring(dil, n).wstages < 2 ||
          conv3x3_wgmma_ring(dil, n).bytes > SMEM_LIMIT)
        return false;
  return true;
}
static_assert(conv3x3_wgmma_rings_fit(),
              "a dilation of 1..8 leaves fewer than two weight slots");

// acc[mt][nt][4]: this warp's tile rows 2 warp + mt, channels nt * 8 ...
// -> out, through the f32 tile `ep` in shared memory (see the note above).
// Every thread of the block calls it; shared memory must be free for reuse.
__device__ __forceinline__ void mma_epilogue(
    float (&acc)[2][8][4], float* ep, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ skip, __nv_bfloat16* __restrict__ out,
    int bi, int oy0, int ox0, int co0, int H, int W, int Cout, float alpha,
    int pool) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int cl = nt * 8 + tig * 2;
    float b0 = 0.f, b1 = 0.f;
    if (co0 + cl < Cout) {
      b0 = bias[co0 + cl];
      b1 = bias[co0 + cl + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* row = ep + ((2 * warp + mt) * MT + gid) * EPI_LD + cl;
      *reinterpret_cast<float2*>(row) = make_float2(
          lrelu(acc[mt][nt][0] + b0, alpha), lrelu(acc[mt][nt][1] + b1, alpha));
      *reinterpret_cast<float2*>(row + 8 * EPI_LD) = make_float2(
          lrelu(acc[mt][nt][2] + b0, alpha), lrelu(acc[mt][nt][3] + b1, alpha));
    }
  }
  __syncthreads();

  // f[8] = the tile's f32 values of pixel (ty, tx), channels c8.. (+ skip)
  auto pixel = [&](int ty, int tx, int c8, float (&f)[8]) {
    const float4* p =
        reinterpret_cast<const float4*>(ep + (ty * MT + tx) * EPI_LD + c8);
    const float4 lo = p[0], hi = p[1];
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
    if (skip != nullptr) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          skip + (((size_t)bi * H + oy0 + ty) * W + ox0 + tx) * Cout + co0 + c8);
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 s2 = unpack_bf16(w4[i]);
        f[2 * i] += s2.x;
        f[2 * i + 1] += s2.y;
      }
    }
  };
  auto store8 = [&](__nv_bfloat16* dst, const float (&f)[8]) {
    uint4 u;
    u.x = pack_bf16(f[0], f[1]);
    u.y = pack_bf16(f[2], f[3]);
    u.z = pack_bf16(f[4], f[5]);
    u.w = pack_bf16(f[6], f[7]);
    *reinterpret_cast<uint4*>(dst) = u;
  };

  if (!pool) {
    for (int i = threadIdx.x; i < MT * MT * (MC / 8); i += MTHREADS) {
      const int c8 = (i % (MC / 8)) * 8, px = i / (MC / 8);
      const int ty = px / MT, tx = px % MT;
      if (oy0 + ty >= H || ox0 + tx >= W || co0 + c8 >= Cout) continue;
      float f[8];
      pixel(ty, tx, c8, f);
      store8(out + (((size_t)bi * H + oy0 + ty) * W + ox0 + tx) * Cout + co0 + c8,
             f);
    }
    return;
  }
  const int Ho = H / 2, Wo = W / 2;  // H, W even: a window is whole or absent
  for (int i = threadIdx.x; i < (MT / 2) * (MT / 2) * (MC / 8); i += MTHREADS) {
    const int c8 = (i % (MC / 8)) * 8, pp = i / (MC / 8);
    const int ty = 2 * (pp / (MT / 2)), tx = 2 * (pp % (MT / 2));
    if (oy0 + ty >= H || ox0 + tx >= W || co0 + c8 >= Cout) continue;
    float a[8], b[8], c[8], d[8], m[8];
    pixel(ty, tx, c8, a);
    pixel(ty, tx + 1, c8, b);
    pixel(ty + 1, tx, c8, c);
    pixel(ty + 1, tx + 1, c8, d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m[j] = lrelu(nanmax(nanmax(a[j], b[j]), nanmax(c[j], d[j])), alpha);
    store8(out + (((size_t)bi * Ho + (oy0 + ty) / 2) * Wo + (ox0 + tx) / 2) * Cout +
               co0 + c8,
           m);
  }
}

// The consumer warp's share of a tile after its last wait: acc holds its
// warpgroup's m64 tile, of which this warp owns output rows oy, oy + 1 and
// columns ox0w .. ox0w + 7 (row 0 of its 16 accumulator rows is pixel
// (oy, ox0w + gid), row 8 pixel (oy + 1, ox0w + gid)), channels co0 ..
// co0 + N - 1. Same arithmetic, in the same order, as mma_epilogue.
template <int N>
__device__ __forceinline__ void wgmma_epilogue(
    const float (&acc)[N / 2], const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ skip, __nv_bfloat16* __restrict__ out,
    int bi, int oy, int ox0w, int co0, int H, int W, int Cout, float alpha,
    int pool) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int ox = ox0w + gid;
  const bool in_row[2] = {ox < W && oy < H, ox < W && oy + 1 < H};
  const size_t px = ((size_t)bi * H + oy) * W + ox;  // row 0's pixel
#pragma unroll
  for (int k = 0; k < N / 32; ++k) {  // n8 blocks 4k .. 4k + 3
    // after a quad transpose, lane tig holds the 16 bytes of n8 block 4k + tig
    const int c8 = co0 + (4 * k + tig) * 8;
    const bool in_c = c8 < Cout;
    uint4 sq[2];  // the skip's 16 bytes of each row, asked for first
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sq[r] = make_uint4(0u, 0u, 0u, 0u);
      if (skip != nullptr && in_row[r] && in_c)
        sq[r] = __ldg(reinterpret_cast<const uint4*>(
            skip + (px + (size_t)r * W) * Cout + c8));
    }
    float v[2][4][2];  // [pixel row][n8 block 4k + i][channel pair]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cl = co0 + (4 * k + i) * 8 + tig * 2;
      const float2 b = cl < Cout
                           ? __ldg(reinterpret_cast<const float2*>(bias + cl))
                           : make_float2(0.f, 0.f);
      const float* d = acc + (4 * k + i) * 4;
      v[0][i][0] = lrelu(d[0] + b.x, alpha);
      v[0][i][1] = lrelu(d[1] + b.y, alpha);
      v[1][i][0] = lrelu(d[2] + b.x, alpha);
      v[1][i][1] = lrelu(d[3] + b.y, alpha);
    }
    if (skip != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t u[4] = {sq[r].x, sq[r].y, sq[r].z, sq[r].w};
        quad_transpose(u, tig);  // u[i]: block 4k + i, channels 2 tig, + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 s2 = unpack_bf16(u[i]);
          v[r][i][0] += s2.x;
          v[r][i][1] += s2.y;
        }
      }
    }
    if (!pool) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = pack_bf16(v[r][i][0], v[r][i][1]);
        quad_transpose(o, tig);  // o[i]: block 4k + tig, channels 2 i, + 1
        if (in_row[r] && in_c)
          *reinterpret_cast<uint4*>(out + (px + (size_t)r * W) * Cout + c8) =
              make_uint4(o[0], o[1], o[2], o[3]);
      }
      continue;
    }
    // window (oy, ox), (oy, ox + 1), (oy + 1, ox), (oy + 1, ox + 1) for an
    // even gid; its right column comes from the lane of gid + 1
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = v[0][i][e], c = v[1][i][e];
        const float b = __shfl_xor_sync(0xffffffffu, a, 4);
        const float d = __shfl_xor_sync(0xffffffffu, c, 4);
        m[e] = lrelu(nanmax(nanmax(a, b), nanmax(c, d)), alpha);
      }
      o[i] = pack_bf16(m[0], m[1]);
    }
    quad_transpose(o, tig);
    if (!(gid & 1) && in_row[0] && in_c) {  // H, W even: a window is whole
      const size_t pooled = ((size_t)bi * (H / 2) + oy / 2) * (W / 2) + ox / 2;
      *reinterpret_cast<uint4*>(out + pooled * Cout + c8) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  if constexpr (N == 64)
    wgmma_m64n64k16(d, a, desc_b, accumulate);
  else
    wgmma_m64n128k16(d, a, desc_b, accumulate);
}

// y = LReLU(conv3x3_dil(x) + b) [+ skip] [-> 2x2 max-pool -> LReLU], as
// conv3x3_kernel, N output channels a tile (see the note above). Cin a
// multiple of 16, Cout a multiple of 8, H * W < 2^31. `xmap`: 4-D tiled map
// over x (Cin, W, H, B), box (64, 16 + 2 dil, 16 + 2 dil, 1); `wmap`: 3-D
// over w (Cout, Cin, 9), box (64, 64, 1); both bf16, 128-byte swizzle, zero
// fill. grid = (min(tiles, SMs)), WG_THREADS threads; dynamic shared memory
// conv3x3_wgmma_ring(dil, N).bytes, laid out from a 1024-byte aligned start
// as `patches` patch slots, `wstages` weight slots of 64 x N, the barriers.
template <int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ skip,
                     __nv_bfloat16* __restrict__ out, int B, int H, int W,
                     int Cin, int Cout, int dil, float alpha, int pool,
                     int patches, int wstages) {
  constexpr uint32_t WT_BYTES = N * WG_KC * 2;  // a weight slot
  extern __shared__ unsigned char smem_raw[];
  const int side = WG_TILE + 2 * dil;
  const uint32_t box_bytes = side * side * WG_PIX_BYTES;
  const uint32_t patch_bytes = (box_bytes + 1023u) & ~1023u;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t wring = base + patches * patch_bytes;
  // mbarriers: full and empty of patch slot i, of weight slot i
  const uint32_t bars = wring + wstages * WT_BYTES;
  const uint32_t full_p = bars, empty_p = bars + 16;
  const uint32_t full_w = bars + 32, empty_w = bars + 32 + 8 * WG_WS_MAX;
  constexpr int RELEASES = 4 * WG_CONSUMERS;  // one arrival a consumer warp

  const int chunks = (Cin + WG_KC - 1) / WG_KC;
  const int n_co = (Cout + N - 1) / N;
  const int tiles_w = (W + WG_TILE - 1) / WG_TILE;
  const int tiles_h = (H + WG_TILE - 1) / WG_TILE;
  const int n_tiles = n_co * tiles_w * tiles_h * B;
  // tile t -> frame, first output row and column, first output channel;
  // the channel tile fastest, so the blocks that share a patch run together
  auto tile_at = [&](int t, int& bi, int& oy0, int& ox0, int& co0) {
    co0 = (t % n_co) * N;
    t /= n_co;
    ox0 = (t % tiles_w) * WG_TILE;
    t /= tiles_w;
    oy0 = (t % tiles_h) * WG_TILE;
    bi = t / tiles_h;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < patches; ++i) {
      mbar_init(full_p + 8 * i, 1);
      mbar_init(empty_p + 8 * i, RELEASES);
    }
    for (int i = 0; i < wstages; ++i) {
      mbar_init(full_w + 8 * i, 1);
      mbar_init(empty_w + 8 * i, RELEASES);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup: one thread issues ----
    setmaxnreg_dec<WG_REGS_PRODUCER>();
    if (threadIdx.x != 0) return;
    int ps = 0, pph = 0, ws = 0, wph = 0;  // slot and phase of each ring
    auto load_patch = [&](int t, int c) {
      int bi, oy0, ox0, co0;
      tile_at(t, bi, oy0, ox0, co0);
      mbar_wait_or_trap(empty_p + 8 * ps, pph ^ 1);
      mbar_arrive_expect_tx(full_p + 8 * ps, box_bytes);
      tma_load_4d(base + ps * patch_bytes, &xmap, c * WG_KC, ox0 - dil,
                  oy0 - dil, bi, full_p + 8 * ps);
      if (++ps == patches) ps = 0, pph ^= 1;
    };
    // With two patch slots the next chunk's patch is asked for right after
    // this chunk's first weight tile (its slot frees as the chunk before
    // ends); with one, after the last (it frees as this chunk ends).
    const int lead = patches == 2 ? 0 : 8;
    if ((int)blockIdx.x < n_tiles) load_patch(blockIdx.x, 0);
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int bi, oy0, ox0, co0;
      tile_at(t, bi, oy0, ox0, co0);
      for (int c = 0; c < chunks; ++c) {
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait_or_trap(empty_w + 8 * ws, wph ^ 1);
          mbar_arrive_expect_tx(full_w + 8 * ws, WT_BYTES);
          for (int h = 0; h < N / 64; ++h)
            tma_load_3d(wring + ws * WT_BYTES + h * (WT_BYTES * 64 / N),
                        &wmap, co0 + 64 * h, c * WG_KC, tap, full_w + 8 * ws);
          if (++ws == wstages) ws = 0, wph ^= 1;
          if (tap == lead) {
            if (c + 1 < chunks)
              load_patch(t, c + 1);
            else if (t + (int)gridDim.x < n_tiles)
              load_patch(t + gridDim.x, 0);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  setmaxnreg_inc<WG_REGS_CONSUMER>();
  const int g = threadIdx.x / 128 - 1;  // consumer warpgroup: m64 tile g
  const int w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  // warp tile q = 4 g + w: 2 rows x 8 columns at (2 (q / 2), 8 (q % 2)) of
  // the 16 x 16 tile. This lane's ldmatrix row r is that tile's pixel
  // (r / 8, r % 8); its 16-byte half of a k-step, h.
  const int q = 4 * g + w, ty = 2 * (q / 2), tx = 8 * (q % 2);
  const int r = lane % 16, h = lane / 16;
  const int lane_pix = (ty + r / 8) * side + tx + r % 8;
  float acc[N / 2];
  // A fragments, [k-step mod (WG_INFLIGHT + 1)]: a set is loaded again only
  // once the group that read it is done
  uint32_t afr[WG_INFLIGHT + 1][4];
  static_assert(36 % (WG_INFLIGHT + 1) == 0, "a chunk's steps cycle the sets");
  int ps = 0, pph = 0, ws = 0, wph = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int bi, oy0, ox0, co0;
    tile_at(t, bi, oy0, ox0, co0);
    int held = -1;  // a weight slot whose last group may still run
    for (int c = 0; c < chunks; ++c) {
      mbar_wait_or_trap(full_p + 8 * ps, pph);
      const uint32_t patch = base + ps * patch_bytes;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        mbar_wait_or_trap(full_w + 8 * ws, wph);
        const uint32_t wslot = wring + ws * WT_BYTES;
        const int p = lane_pix + (tap / 3) * dil * side + (tap % 3) * dil;
        const uint32_t prow = patch + p * WG_PIX_BYTES, pswz = p & 7;
#pragma unroll
        for (int s = 0; s < 4; ++s) {  // k-step: channels 16 s .. 16 s + 15
          uint32_t (&a)[4] = afr[(4 * tap + s) % (WG_INFLIGHT + 1)];
          ldmatrix_x4(a, prow + (((2 * s + h) ^ pswz) << 4));
          wgmma_fence();
          // rows 16 s .. of the slot; 8 rows of 128 bytes to the next 8,
          // 64 x 64 (8 KB) to the next 64 channels
          const uint64_t db = wgmma_desc_sw128(wslot + s * 2048, 8192, 1024);
          wgmma_bf16<N>(acc, a, db, (c | tap | s) != 0);
          wgmma_commit();
          wgmma_wait<WG_INFLIGHT>();
          // the last group of the tap before is done
          if (s == WG_INFLIGHT - 1 && held >= 0 && lane == 0)
            mbar_arrive(empty_w + 8 * held);
        }
        held = ws;
        if (++ws == wstages) ws = 0, wph ^= 1;
      }
      // the chunk's last fragments are in registers: its patch slot is free
      if (lane == 0) mbar_arrive(empty_p + 8 * ps);
      if (++ps == patches) ps = 0, pph ^= 1;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty_w + 8 * held);
    wgmma_epilogue<N>(acc, bias, skip, out, bi, oy0 + ty, ox0 + tx, co0, H, W,
                      Cout, alpha, pool);
  }
}

// The same function for Cin == 4: the nine taps of a pixel packed into one
// K of 48. grid = (ceil(Cout/MC) * ceil(H/MT) * ceil(W/MT), B); dynamic
// shared memory conv3x3_c4_smem_bytes().
__global__ void __launch_bounds__(MTHREADS, 2)
conv3x3_c4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ skip,
                      __nv_bfloat16* __restrict__ out, int H, int W, int Cout,
                      int dil, float alpha, int pool) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [256][C4_LD]
  __nv_bfloat16* Ws = As + MT * MT * C4_LD;                        // [48][W_LD]

  const int n_co = (Cout + MC - 1) / MC;
  const int tiles_w = (W + MT - 1) / MT;
  const int co0 = (blockIdx.x % n_co) * MC;
  const int tile = blockIdx.x / n_co;
  const int oy0 = (tile / tiles_w) * MT;
  const int ox0 = (tile % tiles_w) * MT;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* xb = x + (size_t)bi * H * W * 4;

  for (int i = threadIdx.x; i < MT * MT * 9; i += MTHREADS) {
    const int px = i / 9, tap = i % 9;
    const int iy = oy0 + px / MT + (tap / 3 - 1) * dil;
    const int ix = ox0 + px % MT + (tap % 3 - 1) * dil;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const __nv_bfloat16* src = in ? xb + ((size_t)iy * W + ix) * 4 : xb;
    cp_async8(smem_u32(As + px * C4_LD + tap * 4), src, in ? 8 : 0);
  }
  for (int i = threadIdx.x; i < C4_K * (MC / 8); i += MTHREADS) {
    const int row = i / (MC / 8), c8 = (i % (MC / 8)) * 8;  // row = tap*4+ci
    const bool in = row < 36 && co0 + c8 < Cout;
    const __nv_bfloat16* src = in ? w + (size_t)row * Cout + co0 + c8 : w;
    cp_async16(smem_u32(Ws + row * W_LD + c8), src, in ? 16 : 0);
  }
  cp_async_commit();
  for (int px = threadIdx.x; px < MT * MT; px += MTHREADS) {  // K 36..47
    uint2* z = reinterpret_cast<uint2*>(As + px * C4_LD + 36);
    z[0] = z[1] = z[2] = make_uint2(0u, 0u);
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const uint32_t sa = smem_u32(
      As + ((2 * warp) * MT + (lane & 15)) * C4_LD + (lane >> 4) * 8);
  const uint32_t sb = smem_u32(
      Ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * W_LD + (lane >> 4) * 8);
#pragma unroll
  for (int k0 = 0; k0 < C4_K; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], sa + 2 * (mt * MT * C4_LD + k0));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sb + 2 * (k0 * W_LD + np * 16));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every warp has read its fragments: the tile is free
  mma_epilogue(acc, reinterpret_cast<float*>(smem_raw), bias, skip, out, bi,
               oy0, ox0, co0, H, W, Cout, alpha, pool);
}

// Per host thread and device: the largest dynamic shared memory a kernel
// was allowed (the attribute belongs to the device, so one size for every
// dilation keeps threads out of each other's way, and a launch still
// occupies only its own bytes), and the device's SM count. `static`, not
// `inline`: each library that includes this header has its own copy of the
// kernels, so each needs its own record, and a local of an inline function
// would be one object for the whole process.
struct KernelDevice {
  int allowed_dev[3] = {-1, -1, -1};  // c4, wgmma N = 64, N = 128
  int sms_dev = -1, sms = 0;
};
static KernelDevice& kernel_device() {
  thread_local KernelDevice kd;
  return kd;
}

template <typename K>
static cudaError_t allow_smem(int which, K kernel, size_t bytes, int dev) {
  KernelDevice& kd = kernel_device();
  if (kd.allowed_dev[which] == dev) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) kd.allowed_dev[which] = dev;
  return e;
}

// conv3x3_wgmma_kernel<N> for N = conv3x3_wgmma_n(Cout). Refuses what the
// kernel does not take; returns cudaGetLastError() after the launch.
static cudaError_t launch_conv3x3_wgmma(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
    const __nv_bfloat16* skip, __nv_bfloat16* out, int B, int H, int W,
    int Cin, int Cout, int dil, float alpha, int pool, cudaStream_t stream) {
  if (Cout < 8 || Cout % 8 || dil < 1 || dil > WG_MAX_DIL || Cin < 16 ||
      Cin % 16 || B < 1 || H < 1 || W < 1 || (pool && (H % 2 || W % 2)) ||
      (long long)H * W > 2147483647LL ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return cudaErrorInvalidValue;
  const int n = conv3x3_wgmma_n(Cout);
  const long long tiles = (long long)((Cout + n - 1) / n) *
                          ((W + WG_TILE - 1) / WG_TILE) *
                          ((H + WG_TILE - 1) / WG_TILE) * B;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const WgmmaRing ring = conv3x3_wgmma_ring(dil, n);
  const int side = WG_TILE + 2 * dil;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                  (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {WG_KC, (cuuint32_t)side, (cuuint32_t)side, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Cout * 2,
                                  (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t wbox[3] = {64, WG_KC, 1};
  if (!encode_bf16_map(&xmap, x, 4, xdims, xstrides, xbox) ||
      !encode_bf16_map(&wmap, w, 3, wdims, wstrides, wbox))
    return cudaErrorInvalidValue;

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  KernelDevice& kd = kernel_device();
  if (kd.sms_dev != dev) {
    e = cudaDeviceGetAttribute(&kd.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    kd.sms_dev = dev;
  }
  const dim3 grid((unsigned)(tiles < kd.sms ? tiles : kd.sms));
  // setmaxnreg hands the consumers registers the producer gave up: a kernel
  // built with fewer than WG_REGS_LAUNCH a thread would wait for them forever
  static const bool regs_as_built = [] {
    auto regs = [](auto kernel) {
      cudaFuncAttributes fa;
      return cudaFuncGetAttributes(&fa, kernel) == cudaSuccess ? fa.numRegs : -1;
    };
    return regs(conv3x3_wgmma_kernel<64>) == WG_REGS_LAUNCH &&
           regs(conv3x3_wgmma_kernel<128>) == WG_REGS_LAUNCH;
  }();
  if (!regs_as_built) return cudaErrorInvalidConfiguration;
  if (n == 64) {
    e = allow_smem(1, conv3x3_wgmma_kernel<64>, SMEM_LIMIT, dev);
    if (e != cudaSuccess) return e;
    conv3x3_wgmma_kernel<64><<<grid, WG_THREADS, ring.bytes, stream>>>(
        xmap, wmap, b, skip, out, B, H, W, Cin, Cout, dil, alpha, pool,
        ring.patches, ring.wstages);
  } else {
    e = allow_smem(2, conv3x3_wgmma_kernel<128>, SMEM_LIMIT, dev);
    if (e != cudaSuccess) return e;
    conv3x3_wgmma_kernel<128><<<grid, WG_THREADS, ring.bytes, stream>>>(
        xmap, wmap, b, skip, out, B, H, W, Cin, Cout, dil, alpha, pool,
        ring.patches, ring.wstages);
  }
  return cudaGetLastError();
}

// conv3x3_c4_mma_kernel; refuses what it does not take, as above.
static cudaError_t launch_conv3x3_c4(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
    const __nv_bfloat16* skip, __nv_bfloat16* out, int B, int H, int W,
    int Cin, int Cout, int dil, float alpha, int pool, cudaStream_t stream) {
  if (Cout < 8 || Cout % 8 || dil < 1 || dil > 8 || Cin != 4 ||
      (pool && (H % 2 || W % 2)) || (long long)H * W > 2147483647LL)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const size_t bytes = conv3x3_c4_smem_bytes();
  e = allow_smem(0, conv3x3_c4_mma_kernel, bytes, dev);
  if (e != cudaSuccess) return e;
  const dim3 grid(((Cout + MC - 1) / MC) * ((H + MT - 1) / MT) * ((W + MT - 1) / MT),
                  B);
  conv3x3_c4_mma_kernel<<<grid, MTHREADS, bytes, stream>>>(
      x, w, b, skip, out, H, W, Cout, dil, alpha, pool);
  return cudaGetLastError();
}

// One conv by the kernel the caller names: kind 0 = conv3x3_kernel (any
// dtype and shape), 2 = conv3x3_c4_mma_kernel, 3 = conv3x3_wgmma_kernel (2
// and 3 bf16 only).
template <typename T>
cudaError_t launch_conv3x3_kind(const T* x, const T* w, const float* b,
                                const T* skip, T* out, int B, int H, int W,
                                int Cin, int Cout, int dil, float alpha,
                                int pool, int kind, cudaStream_t stream);

template <>
inline cudaError_t launch_conv3x3_kind<float>(
    const float* x, const float* w, const float* b, const float* skip,
    float* out, int B, int H, int W, int Cin, int Cout, int dil, float alpha,
    int pool, int kind, cudaStream_t stream) {
  if (kind != 0) return cudaErrorInvalidValue;
  return launch_conv3x3<float>(x, w, b, skip, out, B, H, W, Cin, Cout, dil,
                               alpha, pool, stream);
}

template <>
inline cudaError_t launch_conv3x3_kind<__nv_bfloat16>(
    const __nv_bfloat16* x, const __nv_bfloat16* w, const float* b,
    const __nv_bfloat16* skip, __nv_bfloat16* out, int B, int H, int W,
    int Cin, int Cout, int dil, float alpha, int pool, int kind,
    cudaStream_t stream) {
  if (kind == 0)
    return launch_conv3x3<__nv_bfloat16>(x, w, b, skip, out, B, H, W, Cin,
                                         Cout, dil, alpha, pool, stream);
  if (kind == 2)
    return launch_conv3x3_c4(x, w, b, skip, out, B, H, W, Cin, Cout, dil,
                             alpha, pool, stream);
  if (kind == 3)
    return launch_conv3x3_wgmma(x, w, b, skip, out, B, H, W, Cin, Cout, dil,
                                alpha, pool, stream);
  return cudaErrorInvalidValue;
}

}  // namespace pe
