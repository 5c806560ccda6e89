// Fused softmax attention for Hopper (sm_90a).
//
// Replaces scripts/exp_fused_attention.py::fused_attention (Pallas kernel
// _attention_kernel). Per fused batch-head g:
//
//   logits = (q k^T) * scale      products accumulated in f32, scaled in f32
//   p      = softmax(logits)      max, exp, sum and the division in f32,
//                                 then rounded to the input dtype
//   out    = p v                  accumulated in f32, stored in the input dtype
//
// q, k, v and out are (B, H, N, D) views with arbitrary element strides for
// b, h and n and a contiguous last dimension, so the ViT's attention can hand
// in slices of its one (B, N, 3, H, D) qkv tensor and take the result as
// (B, N, H*D) with no transposing copy. float32 or bfloat16.
//
// What bounds it on this card. At the served shape (B 256, H 8, N 144,
// D 256, bf16) one call is 4 G N^2 D = 4.35e10 operations against
// 4 G N D 2 B = 604 MB: 72 operations a byte, below the bf16 tensor cores'
// ridge near 295, so the card's bound is bytes (0.18 ms), as long as the
// products run on the tensor cores; as f32 FMAs on the CUDA cores (67
// TFLOP/s) the same work is compute bound at 0.65 ms.
//
// What the design does about it. Two kernels, chosen by the wrapper from
// dtype and shape (ops/hopper_attention.py: attention_kernel_for):
//
// attention_mma_kernel (bf16, N <= 144, D a multiple of 16, q k v of one g
// within 227 KB). Both products are bf16 `mma.sync.m16n8k16` with f32
// accumulation. A persistent block (one per SM at the served shape) walks
// over g = blockIdx.x, + gridDim.x, ...; q, k and v of a g lie whole in
// shared memory in bf16, rows padded by 16 bytes so that the eight rows of
// an `ldmatrix` fall into distinct banks, and cross device memory exactly
// once. One warp only copies: a bulk asynchronous copy a row (512 bytes at
// D = 256) that reports to an `mbarrier`; rows past N are zeroed once. Nine
// warps multiply, 16 query rows each, and meet no block-wide barrier: a
// warp waits for q, k ("full"), takes its logits against all keys into 72
// f32 registers a thread (k rows are the B fragments of q k^T as they lie;
// no transpose), says it is done with q, k ("free"), runs the softmax on
// those registers (row max and sum by two quad shuffles), waits for v, and
// multiplies: the probabilities, rounded to bf16, are the A fragments of the
// second product as they stand, v's B fragments come through
// `ldmatrix.trans`, and the output goes in halves of 128 columns (64 f32
// registers), transposed within each quad so that a lane stores 16 bytes.
// The copies form a ring over the one set of buffers: v(g) arrives while
// q k^T and the softmax of g run; once every warp has its logits, q and k
// of the next g load under the softmax and p v of this one, and v of the
// next g under the next q k^T; the warps drift apart, so tensor-core,
// softmax and store phases of different warps overlap. The rounding points
// are the plain version's: f32 logits, scale in f32, expf(logit - max),
// division by the f32 sum, p rounded to bf16, f32 accumulation, one rounding
// at the store. No online softmax: N = 144 fits.
//
// attention_kernel (float32, and every bf16 shape the first does not take:
// N up to 1056, D any multiple of 8). f32 FMAs on the CUDA cores; TF32
// would break float32's 1e-4 limit. One block per (g, tile of 48 query
// rows); the tile's logits against ALL keys live in shared memory in f32,
// q/k/v stream through shared memory in 48 x 64 chunks converted to f32 at
// staging, and each of the 256 threads owns a 3 x 3 (first product) or
// 3 x 4 (second product) register tile. Rows and columns past N or D are
// zero at staging and masked at the store.
//
// Nothing of the Mosaic shape carries over: no block of heads with a static
// unroll, no (N, N) scratch bounce between the dots, no divisibility of G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int TQ = 48;        // query rows of a block
constexpr int KC = 48;        // keys of a staged chunk (== TQ)
constexpr int DC = 64;        // columns of D of a staged chunk
constexpr int LDK = DC + 4;   // padded row stride of the q and k chunks
constexpr int THREADS = 256;  // 16 x 16 threads, each 3 rows x 3 or 4 columns
constexpr size_t SMEM_MAX = 232448;  // bytes a block may use on sm_90

__device__ inline void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ inline void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ inline float round_to(float x, const float*) { return x; }
__device__ inline float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ inline void store4(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ inline void store4(__nv_bfloat16* p, const float* a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [r0, r0 + KC) x columns [c0, c0 + DC) of an (n_rows, D) matrix with
// row stride `rs` -> dst[row * ld + column] as f32; zero past n_rows or D.
template <typename T>
__device__ inline void stage(const T* src, long long rs, int r0, int n_rows,
                             int c0, int D, float* dst, int ld) {
  constexpr int GROUPS = DC / 8;
  for (int i = threadIdx.x; i < KC * GROUPS; i += THREADS) {
    const int r = i / GROUPS, c = (i % GROUPS) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n_rows && c0 + c < D)
      load8(src + (long long)(r0 + r) * rs + c0 + c, v);
    float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int N,
                 int D, int NP, long long qb, long long qh, long long qn,
                 long long kb, long long kh, long long kn, long long vb,
                 long long vh, long long vn, long long ob, long long oh,
                 long long on, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int lds = NP + 4;         // padded row stride of the logits
  float* S = smem;                // [TQ][lds] logits, then probabilities
  float* Qs = S + TQ * lds;       // [TQ][LDK]
  float* Ks = Qs + TQ * LDK;      // [KC][LDK]
  float* Vs = Qs;                 // [KC][DC], second product (reuses Qs, Ks)

  const int tiles = (N + TQ - 1) / TQ;
  const int g = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TQ;
  const int b = g / H, h = g % H;
  q += b * qb + h * qh;
  k += b * kb + h * kh;
  v += b * vb + h * vh;
  o += b * ob + h * oh;
  const int tr = threadIdx.x / 16;  // rows tr, tr + 16, tr + 32 of the tile
  const int tc = threadIdx.x % 16;

  // ---- logits of the tile against every key ----
  for (int kc = 0; kc < NP; kc += KC) {
    float acc[3][3] = {};
    for (int d0 = 0; d0 < D; d0 += DC) {
      stage(q, qn, q0, N, d0, D, Qs, LDK);
      stage(k, kn, kc, N, d0, D, Ks, LDK);
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < DC; dd += 4) {
        float4 a[3], w[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a[i] = *reinterpret_cast<const float4*>(Qs + (tr + 16 * i) * LDK + dd);
          w[i] = *reinterpret_cast<const float4*>(Ks + (tc + 16 * i) * LDK + dd);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        S[(tr + 16 * i) * lds + kc + tc + 16 * j] = acc[i][j] * scale;
  }
  __syncthreads();

  // ---- softmax over the N keys, one warp a row; zero past N ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TQ; r += THREADS / 32) {
    float* row = S + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, s);
    for (int c = lane; c < NP; c += 32)
      row[c] = c < N ? round_to(row[c] / sum, q) : 0.f;
  }
  __syncthreads();

  // ---- out = p v, 64 output columns at a time ----
  for (int c0 = 0; c0 < D; c0 += DC) {
    float acc[3][4] = {};
    for (int kc = 0; kc < NP; kc += KC) {
      stage(v, vn, kc, N, c0, D, Vs, DC);
      __syncthreads();
#pragma unroll 2
      for (int m = 0; m < KC; m += 4) {
        float p[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float4 t = *reinterpret_cast<const float4*>(
              S + (tr + 16 * i) * lds + kc + m);
          p[i][0] = t.x; p[i][1] = t.y; p[i][2] = t.z; p[i][3] = t.w;
        }
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const float4 w =
              *reinterpret_cast<const float4*>(Vs + (m + mm) * DC + 4 * tc);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            acc[i][0] = fmaf(p[i][mm], w.x, acc[i][0]);
            acc[i][1] = fmaf(p[i][mm], w.y, acc[i][1]);
            acc[i][2] = fmaf(p[i][mm], w.z, acc[i][2]);
            acc[i][3] = fmaf(p[i][mm], w.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
    const int col = c0 + 4 * tc;
    if (col < D) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int row = q0 + tr + 16 * i;
        if (row < N) store4(o + (long long)row * on + col, acc[i]);
      }
    }
  }
}

// ---- bf16 tensor-core kernel ----

constexpr int MMA_TILES = 9;  // 16-row tiles: N <= 144, one warp a tile
constexpr int MMA_THREADS = 32 * (MMA_TILES + 1);  // + the warp that copies
constexpr int MMA_PAD = 8;    // bf16 of padding a staged row
constexpr int MMA_BAR_BYTES = 32;  // four mbarriers behind the three buffers

struct Strides {
  long long qb, qh, qn, kb, kh, kn, vb, vh, vn, ob, oh, on;
};

// grid: any number of blocks up to G (each walks g = blockIdx.x, +gridDim.x,
// ...); block: 32 * (ceil(N / 16) + 1) threads; dynamic shared memory
// 3 * NP * (D + MMA_PAD) * 2 + MMA_BAR_BYTES bytes, NP = 16 * ceil(N / 16).
__global__ void __launch_bounds__(MMA_THREADS, 1)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int G, int H, int N, int D,
                     Strides st, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles = (N + 15) / 16;
  const int NP = tiles * 16;
  const int ld = D + MMA_PAD;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + NP * ld;
  __nv_bfloat16* Vs = Ks + NP * ld;
  const uint32_t bars = pe::smem_u32(Vs + NP * ld);
  const uint32_t full_qk = bars, full_v = bars + 8;     // the copies landed
  const uint32_t free_qk = bars + 16, free_v = bars + 24;  // every warp read
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // rows N .. NP - 1 are never copied: zero them once (0 x NaN in p v)
  const int cpr = D / 8;
  for (int i = threadIdx.x; i < (NP - N) * cpr; i += blockDim.x) {
    const int off = (N + i / cpr) * ld + (i % cpr) * 8;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(Qs + off) = z;
    *reinterpret_cast<uint4*>(Ks + off) = z;
    *reinterpret_cast<uint4*>(Vs + off) = z;
  }
  if (threadIdx.x == 0) {
    pe::mbar_init(full_qk, 1);
    pe::mbar_init(full_v, 1);
    pe::mbar_init(free_qk, tiles);
    pe::mbar_init(free_v, tiles);
    pe::mbar_init_fence();
  }
  __syncthreads();

  if (warp == tiles) {
    // ---- the copying warp: one bulk copy a row, a lane a row ----
    const uint32_t row_bytes = D * 2;
    int it = 0;
    for (int g = blockIdx.x; g < G; g += gridDim.x, ++it) {
      const int b = g / H, h = g % H;
      const __nv_bfloat16* qg = q + b * st.qb + h * st.qh;
      const __nv_bfloat16* kg = k + b * st.kb + h * st.kh;
      const __nv_bfloat16* vg = v + b * st.vb + h * st.vh;
      if (it > 0) pe::mbar_wait(free_qk, (it - 1) & 1);
      if (lane == 0) pe::mbar_arrive_expect_tx(full_qk, 2 * N * row_bytes);
      __syncwarp();
      for (int r = lane; r < N; r += 32) {
        pe::bulk_copy_g2s(pe::smem_u32(Qs + r * ld), qg + (long long)r * st.qn,
                          row_bytes, full_qk);
        pe::bulk_copy_g2s(pe::smem_u32(Ks + r * ld), kg + (long long)r * st.kn,
                          row_bytes, full_qk);
      }
      if (it > 0) pe::mbar_wait(free_v, (it - 1) & 1);
      if (lane == 0) pe::mbar_arrive_expect_tx(full_v, N * row_bytes);
      __syncwarp();
      for (int r = lane; r < N; r += 32)
        pe::bulk_copy_g2s(pe::smem_u32(Vs + r * ld), vg + (long long)r * st.vn,
                          row_bytes, full_v);
    }
    return;
  }

  // ---- the multiplying warps: 16 query rows each ----
  const int gid = lane / 4, tig = lane % 4;
  const int row0 = warp * 16;
  // this lane's row addresses for ldmatrix (see mma_tile.cuh)
  const uint32_t q_addr =
      pe::smem_u32(Qs + (row0 + (lane & 15)) * ld + (lane >> 4) * 8);
  const uint32_t k_addr = pe::smem_u32(
      Ks + ((lane & 7) + ((lane >> 4) & 1) * 8) * ld + ((lane >> 3) & 1) * 8);
  const uint32_t v_addr = pe::smem_u32(
      Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);

  int it = 0;
  for (int g = blockIdx.x; g < G; g += gridDim.x, ++it) {
    pe::mbar_wait(full_qk, it & 1);

    // ---- logits of this warp's 16 rows against every key ----
    float s[2 * MMA_TILES][4];
#pragma unroll
    for (int j = 0; j < 2 * MMA_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t a[4];
      pe::ldmatrix_x4(a, q_addr + d0 * 2);
#pragma unroll
      for (int jp = 0; jp < MMA_TILES; ++jp) {
        if (jp < tiles) {
          uint32_t bk[4];
          pe::ldmatrix_x4(bk, k_addr + (jp * 16 * ld + d0) * 2);
          pe::mma_bf16(s[2 * jp], a, bk[0], bk[1]);
          pe::mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) pe::mbar_arrive(free_qk);  // this warp is done with q, k

    // ---- softmax on the accumulator fragments: rows gid and gid + 8 ----
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * MMA_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tig * 2 + (e & 1);
        const float x = col < N ? s[j][e] * scale : -INFINITY;
        s[j][e] = x;
        if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
      }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * MMA_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - (e < 2 ? m0 : m1));
        s[j][e] = x;
        if (e < 2) sum0 += x; else sum1 += x;
      }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    // probabilities, rounded to bf16: the A fragments of p v
    uint32_t p[MMA_TILES][4];
#pragma unroll
    for (int jp = 0; jp < MMA_TILES; ++jp) {
      p[jp][0] = pe::pack_bf16(s[2 * jp][0] / sum0, s[2 * jp][1] / sum0);
      p[jp][1] = pe::pack_bf16(s[2 * jp][2] / sum1, s[2 * jp][3] / sum1);
      p[jp][2] = pe::pack_bf16(s[2 * jp + 1][0] / sum0, s[2 * jp + 1][1] / sum0);
      p[jp][3] = pe::pack_bf16(s[2 * jp + 1][2] / sum1, s[2 * jp + 1][3] / sum1);
    }

    pe::mbar_wait(full_v, it & 1);

    // ---- out = p v, 128 output columns at a time ----
    __nv_bfloat16* og = o + (g / H) * st.ob + (g % H) * st.oh;
    for (int c0 = 0; c0 < D; c0 += 128) {
      float acc[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int jp = 0; jp < MMA_TILES; ++jp) {
        if (jp < tiles) {
#pragma unroll
          for (int np = 0; np < 8; ++np) {
            if (c0 + np * 16 < D) {
              uint32_t bv[4];
              pe::ldmatrix_x4_trans(
                  bv, v_addr + (jp * 16 * ld + c0 + np * 16) * 2);
              pe::mma_bf16(acc[2 * np], p[jp], bv[0], bv[1]);
              pe::mma_bf16(acc[2 * np + 1], p[jp], bv[2], bv[3]);
            }
          }
        }
      }
      if (c0 + 128 >= D) {  // the last read of v is behind this warp
        __syncwarp();
        if (lane == 0) pe::mbar_arrive(free_v);
      }
      // 4 n-tiles = 32 columns at a time: after the quad transpose a lane
      // holds 8 consecutive columns of its two rows, 16 bytes a store
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += 4) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = pe::pack_bf16(acc[j0 + i][0], acc[j0 + i][1]);
          hi[i] = pe::pack_bf16(acc[j0 + i][2], acc[j0 + i][3]);
        }
        pe::quad_transpose(lo, tig);
        pe::quad_transpose(hi, tig);
        const int col = c0 + j0 * 8 + tig * 8;
        if (col < D) {
          const int r0 = row0 + gid, r1 = r0 + 8;
          if (r0 < N)
            *reinterpret_cast<uint4*>(og + (long long)r0 * st.on + col) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
          if (r1 < N)
            *reinterpret_cast<uint4*>(og + (long long)r1 * st.on + col) =
                make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      }
    }
  }
}

// Dynamic shared memory of attention_mma_kernel at N rows of D columns.
size_t mma_smem_bytes(int N, int D) {
  return (size_t)3 * ((N + 15) / 16) * 16 * (D + MMA_PAD) * 2 + MMA_BAR_BYTES;
}

int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int N, int D, const long long* s, float scale,
               cudaStream_t stream) {
  const int tiles = (N + 15) / 16;
  const long long G = (long long)B * H;
  const size_t bytes = mma_smem_bytes(N, D);
  if (N < 1 || tiles > MMA_TILES || D < 16 || D % 16 || bytes > SMEM_MAX ||
      G < 1 || G > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * (tiles + 1);
  // how many blocks the card holds at once, kept per host thread for its
  // last (device, shape)
  thread_local int c_dev = -1, c_threads = 0, c_resident = 0;
  thread_local size_t c_bytes = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != c_dev || threads != c_threads || bytes != c_bytes) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(attention_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attention_mma_kernel, threads, bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    c_dev = dev; c_threads = threads; c_bytes = bytes;
    c_resident = sms * per_sm;
  }
  const Strides st = {s[0], s[1], s[2], s[3], s[4], s[5],
                      s[6], s[7], s[8], s[9], s[10], s[11]};
  attention_mma_kernel<<<(unsigned)(G < c_resident ? G : c_resident), threads,
                         bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      (int)G, H, N, D, st, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int N, int D, const long long* st, float scale, cudaStream_t s) {
  const int NP = (N + KC - 1) / KC * KC;
  const size_t bytes = sizeof(float) * ((size_t)TQ * (NP + 4) + 2 * TQ * LDK);
  const long long blocks = (long long)B * H * ((N + TQ - 1) / TQ);
  if (bytes > SMEM_MAX || blocks < 1 || blocks > 2147483647LL || D % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  attention_kernel<T><<<(unsigned)blocks, THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, N, D, NP, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kernel: 0 = the CUDA-core kernel, 1 = the
// bf16 tensor-core kernel (bf16, N <= 144, D a multiple of 16; the caller
// chooses, nothing here falls from one to the other). q, k, v, o: (B, H, N,
// D) views with element strides (b, h, n) each in `strides` (q, k, v, o in
// turn: 12 values), last dimension contiguous, every stride and base 16-byte
// aligned. Returns the first nonzero CUDA error.
extern "C" int pe_fused_attention(int dtype, int kernel, const void* q,
                                  const void* k, const void* v, void* o, int B,
                                  int H, int N, int D,
                                  const long long* strides, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, o, B, H, N, D, strides, scale, s);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, N, D, strides, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, N, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the tensor-core kernel is launched with.
extern "C" long long pe_attention_mma_smem_bytes(int N, int D) {
  return (long long)mma_smem_bytes(N, D);
}
