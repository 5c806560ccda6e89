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
// ridge near 295, so the card's bound is bytes (0.18 ms). This kernel does
// its products as f32 FMAs on the CUDA cores (67 TFLOP/s peak), where the
// same work is compute bound (0.65 ms at that peak); it keeps everything
// between the two products on chip, so the logits and probabilities never
// reach device memory and q, k, v, out cross it once (k and v once per
// 48-row query tile, out of L2 after the first).
//
// What the design does about it. One block per (g, tile of 48 query rows).
// The tile's logits against ALL keys live in shared memory in f32 (N = 144
// fits whole, so there is no online softmax), q/k/v stream through shared
// memory in 48 x 64 chunks converted to f32 at staging, and each of the 256
// threads owns a 3 x 3 (first product) or 3 x 4 (second product) register
// tile fed by 16-byte shared-memory loads. Rows and columns past N or D are
// zero at staging and masked at the store, so any G, N <= 1056 and D (a
// multiple of 8) work. Nothing of the Mosaic shape carries over: no block of
// heads with a static unroll, no (N, N) scratch bounce between the dots, no
// divisibility of G. Next: bf16 `mma.sync`/`wgmma` for the two products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: (B, H, N, D) views with
// element strides (b, h, n) each in `strides` (q, k, v, o in turn: 12
// values), last dimension contiguous, every stride and base 16-byte aligned.
// Returns the first nonzero CUDA error.
extern "C" int pe_fused_attention(int dtype, const void* q, const void* k,
                                  const void* v, void* o, int B, int H, int N,
                                  int D, const long long* strides, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, N, D, strides, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, N, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
