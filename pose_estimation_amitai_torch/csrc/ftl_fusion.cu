// The 4-camera disentanglement model's middle (ops/ftl_fusion.py) as one
// hand-written kernel for Hopper (sm_90a), bf16 in and out:
//
//   r_v   = rearrange1(x_v)                    1x1, C -> 300
//   c_v   = FTL^-1(r_v, P_inv_v)               groups of 3 -> 4, float32
//   f     = ReLU(bn1(fusion1([c_0 .. c_3])))   1x1, 1600 -> 400
//   g     = fusion2(f);  f' = ReLU(bn2(g))     1x1, 400 -> 400
//   t_v   = ReLU(bn3(FTL(f', P_v)))            groups of 4 -> 3, float32
//   out_v = rearrange2(t_v) + x_v              1x1, 300 -> C, the skip
//
// for the four views v of each sample, with the sample's own cameras, the
// BatchNorms on their running averages. It replaces no TPU kernel: the JAX
// package runs this middle in XLA (pose_estimation_amitai_tpu/models/
// disentangled.py). It rounds where ftl_fusion_plain rounds: each 1x1 once
// with its bias (float32 sums), the FTLs and BatchNorms in float32, c_v, f,
// t_v and each output in bf16, g in bf16 before bn2; only the order of the
// sums differs.
//
// What bounds it on this card. A sample of 48 x 48 latent pixels costs 6.56
// GFLOP, nearly all of it the four 1x1s; at 256 samples that is 1.70 ms of
// the tensor cores' bf16 rate, against 1.08 ms for its least bytes (the
// latent read, the skip read again, the output written). So it is bound by
// operations, and the composition of library calls it replaces spent 25.4 ms
// a chunk moving some 45 GB of float32 intermediates.
//
// What the design does about it. Nothing but the latent, the cameras, the
// weights and the output crosses device memory: every intermediate lives in
// registers and shared memory. A persistent block (one an SM) walks tiles of
// 64 pixels of one sample and takes all four of its views. One producer
// thread keeps loads in flight through `mbarrier`s: each view's 64 x C
// latent tile by TMA (128-byte swizzle, zero fill past the last pixel), and
// the weights as "stages" of 64 K-values by all output channels, each one
// bulk copy into a ring of two slots (about 2.1 MB of weights, read from L2
// by every tile). pack_ftl_weights lays the weights out for that once for
// each set of weights: each stage as the K-major, 128-byte-swizzled image `wgmma` reads,
// zero past each K and N. Two consumer warpgroups run every 1x1 as
// `wgmma.m64nNk16` (A from registers by `ldmatrix`, B by descriptor, float32
// sums), each on half of the output channels: 152 of rearrange1's 304, 200
// of the fusions' 400, C/2 of rearrange2's. Per view: r_v, rounded with its
// bias into a tile of shared memory; the inverse FTL on the CUDA cores into
// fusion1's A tile; then fusion1's product over that view's 400 rows of
// K, its sums held in registers across the four views, so the 1,600-wide
// side-by-side row never exists. Then, once a tile: bias, bn1, ReLU into
// fusion2's A tile; fusion2 rounded with its bias into shared memory; and
// per view the FTL (bn2 and ReLU applied as it reads g), bn3 and ReLU into
// rearrange2's A tile, and rearrange2 with its bias and the skip stored from
// registers. The latent tile, r_v and t_v share one 40 KB buffer, c_v, f and
// g another; the BatchNorms' factors sit in shared memory for the whole run.
//
// Measured (H100 80GB HBM3, 700 W, 256 samples): 6.6 ms a chunk. Without
// its products it still takes 5.0 ms: every tile reads all the weights from
// L2 (64 operations a byte, 28 GB a chunk, about 5.7 TB/s). Without the FTLs
// it takes 4.9 ms: they and the epilogues do not overlap the tensor cores
// (both warpgroups work on one tile). Not done yet: clusters of blocks
// sharing each stage by multicast (two would halve the L2 reads).
#include "mma_tile.cuh"
#include "tensor_map.cuh"

namespace pe {
namespace {

constexpr int VIEWS = 4;
constexpr int LAT3 = 300;              // rearrange1's width: 3G
constexpr int CANON = 400;             // the canonical width: 4G
constexpr int PAIRS = LAT3 / 6;        // pairs of groups a pixel: 50
constexpr int TP = 64;                 // pixels of a tile: one wgmma m64
constexpr int KS = 64;                 // K-values of a weight stage
constexpr int ROW = 2 * KS;            // bytes of a stage's row: 128
constexpr int BLOCK = TP * ROW;        // a 64-column block of an A tile: 8 KB
constexpr int R1_N = 304;              // rearrange1's N, to a multiple of 8
constexpr int F_STAGES = (CANON + KS - 1) / KS;  // 7
constexpr int F_STEPS = CANON / 16;              // 25
constexpr int R2_STAGES = (LAT3 + KS - 1) / KS;  // 5
constexpr int R2_STEPS = (LAT3 + 15) / 16;       // 19: K 300..303 are zeros
constexpr int SLOT_BYTES = CANON * ROW;          // the largest stage: 51,200
constexpr int SLOTS = 2;
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int FTL_THREADS = 5 * PAIRS;           // 250: (5 rows x 50 pairs)
// registers a thread: the launch's share, then setmaxnreg moves all but
// REGS_PRODUCER of the producer warpgroup's to the consumers
constexpr int REGS_LAUNCH = 65536 / THREADS / 8 * 8;
constexpr int REGS_PRODUCER = 40;
constexpr int REGS_CONSUMER =
    REGS_LAUNCH + (REGS_LAUNCH - REGS_PRODUCER) / CONSUMERS / 8 * 8;
static_assert(REGS_CONSUMER * CONSUMERS + REGS_PRODUCER <=
                  REGS_LAUNCH * (1 + CONSUMERS),
              "the consumers take no more than the producer gives up");

// shared memory, from a 1024-byte aligned base
constexpr int R_LD = 2 * R1_N + 16;    // bytes a row of r (plain): 624
constexpr int G_LD = 2 * CANON + 16;   // bytes a row of g (plain): 816
constexpr int XRT_BYTES = 5 * BLOCK;   // the latent tile, r, t
constexpr int CF_BYTES = F_STAGES * BLOCK;  // c_v, f, g
constexpr int BN_CH = 2 * CANON + LAT3;     // bn1, bn2, bn3 channels
constexpr int OFF_CF = XRT_BYTES;
constexpr int OFF_RING = OFF_CF + CF_BYTES;
constexpr int OFF_BN = OFF_RING + SLOTS * SLOT_BYTES;
constexpr int OFF_BAR = OFF_BN + 16 * BN_CH;
constexpr int SMEM_BYTES = 1024 + OFF_BAR + 64;
static_assert(TP * R_LD <= XRT_BYTES && TP * G_LD <= CF_BYTES &&
                  R2_STAGES * BLOCK <= XRT_BYTES && OFF_RING % 1024 == 0 &&
                  SLOT_BYTES % 1024 == 0 && SMEM_BYTES <= 232448,
              "the tiles fit their buffers and the block its shared memory");

// The packed weights (pack_ftl_weights), in bytes from their start: each
// stage `rows` x 128 bytes, its rows K-major and 128-byte swizzled, zero past
// each matrix's K and N. rearrange1: C / 64 stages of 304 rows; fusion1: 4
// views x 7 stages of 400 rows (view v's 400 rows of K); fusion2: 7 stages
// of 400 rows; rearrange2: 5 stages of C rows.

__host__ __device__ constexpr long long r1_bytes(int C) {
  return (long long)(C / KS) * R1_N * ROW;
}
__host__ __device__ constexpr long long f2_off(int C) {
  return r1_bytes(C) + (long long)VIEWS * F_STAGES * SLOT_BYTES;
}
__host__ __device__ constexpr long long r2_off(int C) {
  return f2_off(C) + (long long)F_STAGES * SLOT_BYTES;
}
__host__ __device__ constexpr long long packed_bytes(int C) {
  return r2_off(C) + (long long)R2_STAGES * C * ROW;
}

// ---- device helpers ----

// The two consumer warpgroups' barrier (the producer warpgroup is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

// Orders this thread's shared-memory accesses before later TMA writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of column c (even) of row p in a 64-row A tile as TMA's
// 128-byte swizzle lays it out: 64-column blocks of 8 KB, rows of 128 bytes
// whose 16-byte pieces are XORed with the row's index mod 8.
__device__ __forceinline__ uint32_t swz(int p, int c) {
  return (c >> 6) * BLOCK + p * ROW + ((((c >> 3) & 7) ^ (p & 7)) << 4) +
         (c & 7) * 2;
}

// Descriptor of a K-major, 128-byte-swizzled B operand: rows of 64 K-values,
// groups of 8 rows 1024 bytes apart (the leading offset is unused: 1).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return wgmma_desc_sw128(addr, 16, 1024);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 bf16_pair(const __nv_bfloat16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

// ReLU(bn(v)) in ftl_fusion_plain's order of operations: (v - mean) * mul
// + bias, each rounded (no FMA), then ReLU (NaN stays). s = (mul, mean,
// bias, -).
__device__ __forceinline__ float bn_relu(float v, float4 s) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(v, s.y), s.x), s.z);
  return y < 0.f ? 0.f : y;
}

// d += a b (`accumulate` 0: d = a b), bf16 operands, float32 sums: A (64 x
// 16) from the warpgroup's registers in mma.sync's A fragment layout (warp w
// holds rows 16 w ..), B (16 x N) by descriptor, K-major. d[4 i + e] is
// element e of the m16n8 C fragment of columns 8 i .. 8 i + 7.
template <int N>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[N / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_kmajor<32>(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<152>(float (&d)[76],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75"
      "}, "
      "{%76, %77, %78, %79}, %80, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<200>(float (&d)[100],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99"
      "}, "
      "{%100, %101, %102, %103}, %104, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// The consumers' view of the weight ring: its slots' base address, the full
// and empty barriers, and the slot and phase of the next stage.
struct Ring {
  uint32_t base, full, empty;
  int slot, phase;
};

// This lane's part in a warpgroup's A fragments: its `ldmatrix` row of the
// 64-row tile (warp w's rows 16 w .. 16 w + 15) and its 16-byte half.
struct Lane {
  uint32_t row_bytes;
  int row7, half, lane;
};

// acc += A x B over K = 16 STEPS: A the 64-row swizzled tile at `a_tile`,
// B the next ceil(STEPS / 4) stages of the ring, this warpgroup's N columns
// from stage row `row0`. Each k-step is its own wgmma group; the next one's
// fragments are loaded and its group issued before the wait on the one
// before, and a slot is released once the last group that read it is done.
// The caller zeroes acc where a product starts (rather than a first step
// that overwrites it), so that the compiler sees the old sums dead.
template <int N, int STEPS>
__device__ __forceinline__ void gemm(float (&acc)[N / 2], uint32_t a_tile,
                                     int row0, const Lane& ln, Ring& ring) {
  constexpr int STAGES = (STEPS + 3) / 4;
  uint32_t afr[2][4];
  int held = -1;
#pragma unroll 1
  for (int st = 0; st < STAGES; ++st) {
    mbar_wait_or_trap(ring.full + 8 * ring.slot, ring.phase);
    const uint32_t b0 = ring.base + ring.slot * SLOT_BYTES + row0 * ROW;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (st * 4 + s < STEPS) {
        ldmatrix_x4(afr[s & 1], a_tile + st * BLOCK + ln.row_bytes +
                                    (((2 * s + ln.half) ^ ln.row7) << 4));
        wgmma_fence();
        wgmma_kmajor<N>(acc, afr[s & 1], desc_kmajor(b0 + s * 32), 1);
        wgmma_commit();
        wgmma_wait<1>();
        if (s == 0 && held >= 0 && ln.lane == 0)
          mbar_arrive(ring.empty + 8 * held);
      }
    }
    held = ring.slot;
    if (++ring.slot == SLOTS) ring.slot = 0, ring.phase ^= 1;
  }
  wgmma_wait<0>();
  if (ln.lane == 0) mbar_arrive(ring.empty + 8 * held);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// ---- the kernel ----
//
// latent x and out: (4B, npix, C) view-rows, row 4 b + v; P (B, 4, 3, 4),
// P_inv (B, 4, 4, 3) float32; the biases bf16; bn1, bn2 (4, 400) and bn3 (4,
// 300) float32 stacks of scale, bias, mean, variance; `packed` the weights
// as pack_ftl_weights lays them out. `xmap`: 3-D tiled map over x (C, npix,
// 4B), box (64, 64, 1), 128-byte swizzle, zero fill. grid = (min(tiles,
// SMs)), THREADS threads, SMEM_BYTES of dynamic shared memory.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
ftl_fusion_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ P, const float* __restrict__ P_inv,
                  const unsigned char* __restrict__ packed,
                  const __nv_bfloat16* __restrict__ b_r1,
                  const __nv_bfloat16* __restrict__ b_f1,
                  const __nv_bfloat16* __restrict__ b_f2,
                  const __nv_bfloat16* __restrict__ b_r2,
                  const float* __restrict__ bn1, const float* __restrict__ bn2,
                  const float* __restrict__ bn3, float eps,
                  __nv_bfloat16* __restrict__ out, int B, int npix) {
  static_assert(C % KS == 0 && C / KS <= 5 && (C / CONSUMERS) % 32 == 0,
                "the latent tile fits its buffer; rearrange2's halves are whole");
  constexpr int NR = R1_N / CONSUMERS, NF = CANON / CONSUMERS, NO = C / CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t xrt = smem_u32(sm), cf = xrt + OFF_CF, bars = xrt + OFF_BAR;
  const uint32_t full_x = bars, empty_x = bars + 8, full_w = bars + 16;
  const uint32_t empty_w = full_w + 8 * SLOTS;
  float4* bnp = reinterpret_cast<float4*>(sm + OFF_BN);
  const int tps = (npix + TP - 1) / TP, n_tiles = B * tps;

  // each BatchNorm channel's (mul, mean, bias): mul = rsqrt(var + eps) scale
  for (int c = threadIdx.x; c < BN_CH; c += THREADS) {
    const int which = c / CANON, i = c - which * CANON;
    const float* bn = which == 0 ? bn1 : which == 1 ? bn2 : bn3;
    const int n = which == 2 ? LAT3 : CANON;
    const float mul = __fmul_rn(1.0f / sqrtf(__fadd_rn(bn[3 * n + i], eps)), bn[i]);
    bnp[c] = make_float4(mul, bn[2 * n + i], bn[n + i], 0.f);
  }
  if (threadIdx.x == 0) {
    mbar_init(full_x, 1);
    mbar_init(empty_x, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full_w + 8 * s, 1);
      mbar_init(empty_w + 8 * s, 4 * CONSUMERS);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup: one thread issues ----
    setmaxnreg_dec<REGS_PRODUCER>();
    if (threadIdx.x != 0) return;
    int ws = 0, wph = 0, xph = 0;
    auto load_w = [&](long long off, uint32_t bytes) {
      mbar_wait_or_trap(empty_w + 8 * ws, wph ^ 1);
      mbar_arrive_expect_tx(full_w + 8 * ws, bytes);
      bulk_copy_g2s(xrt + OFF_RING + ws * SLOT_BYTES, packed + off, bytes,
                    full_w + 8 * ws);
      if (++ws == SLOTS) ws = 0, wph ^= 1;
    };
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int b = t / tps, p0 = (t - b * tps) * TP;
      for (int v = 0; v < VIEWS; ++v) {
        // the latent tile of view v: into the buffer once the consumers
        // release it (after view v - 1's inverse FTL, or the tile before)
        mbar_wait_or_trap(empty_x, xph ^ 1);
        mbar_arrive_expect_tx(full_x, C * ROW);
        for (int kb = 0; kb < C / KS; ++kb)
          tma_load_3d(xrt + kb * BLOCK, &xmap, kb * KS, p0, VIEWS * b + v, full_x);
        xph ^= 1;
        for (int st = 0; st < C / KS; ++st)
          load_w((long long)st * R1_N * ROW, R1_N * ROW);
        for (int st = 0; st < F_STAGES; ++st)
          load_w(r1_bytes(C) + (long long)(v * F_STAGES + st) * SLOT_BYTES, SLOT_BYTES);
      }
      for (int st = 0; st < F_STAGES; ++st)
        load_w(f2_off(C) + (long long)st * SLOT_BYTES, SLOT_BYTES);
      for (int v = 0; v < VIEWS; ++v)
        for (int st = 0; st < R2_STAGES; ++st)
          load_w(r2_off(C) + (long long)st * C * ROW, C * ROW);
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup wg owns columns wg N / 2 .. ----
  setmaxnreg_inc<REGS_CONSUMER>();
  const int wg = threadIdx.x / 128 - 1, ctid = threadIdx.x - 128;
  const int w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const Lane ln{(uint32_t)(16 * w + lane % 16) * ROW, (16 * w + lane % 16) & 7,
                lane / 16, lane};
  Ring ring{xrt + OFF_RING, full_w, empty_w, 0, 0};
  // the FTLs: thread ctid < FTL_THREADS takes pair q (groups 2q, 2q + 1) of
  // rows p_ftl, p_ftl + 5, ...
  const int q = ctid % PAIRS, p_ftl = ctid / PAIRS;
  const bool ftl_thread = ctid < FTL_THREADS;
  const int pr = 16 * w + gid;  // this thread's accumulator rows pr, pr + 8
  unsigned char* const R = sm;             // r_v, plain rows of R_LD bytes
  unsigned char* const CF = sm + OFF_CF;   // c_v and f swizzled; g plain
  float accR[NR / 2], accF[NF / 2], accO[NO / 2];
  int xph = 0;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tps, p0 = (t - b * tps) * TP;
    zero(accF);  // f sums over the four views
    for (int v = 0; v < VIEWS; ++v) {
      // r_v = x_v W_r1 + b_r1, rounded, into R
      mbar_wait_or_trap(full_x, xph);
      xph ^= 1;
      zero(accR);
      gemm<NR, C / 16>(accR, xrt, wg * NR, ln, ring);
      consumer_sync();  // both warpgroups are done with the latent tile
#pragma unroll
      for (int i = 0; i < NR / 8; ++i) {
        const int c = wg * NR + 8 * i + 2 * tig;
        const float2 bias = c < LAT3 ? bf16_pair(b_r1 + c) : make_float2(0.f, 0.f);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<uint32_t*>(R + (pr + 8 * rr) * R_LD + 2 * c) =
              pack_bf16(accR[4 * i + 2 * rr] + bias.x, accR[4 * i + 2 * rr + 1] + bias.y);
      }
      consumer_sync();
      // c_v = FTL^-1(r_v, P_inv[b, v]) in float32, rounded, into fusion1's A
      if (ftl_thread) {
        float pi[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) pi[j] = __ldg(P_inv + (VIEWS * b + v) * 12 + j);
        for (int p = p_ftl; p < TP; p += FTL_THREADS / PAIRS) {
          const uint32_t* src = reinterpret_cast<const uint32_t*>(R + p * R_LD + 12 * q);
          float z[6];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float2 f = unpack_bf16(src[k]);
            z[2 * k] = f.x;
            z[2 * k + 1] = f.y;
          }
          float cv[8];
#pragma unroll
          for (int gg = 0; gg < 2; ++gg)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              cv[4 * gg + i] = fmaf(z[3 * gg + 2], pi[3 * i + 2],
                                    fmaf(z[3 * gg + 1], pi[3 * i + 1],
                                         __fmul_rn(z[3 * gg], pi[3 * i])));
          *reinterpret_cast<uint4*>(CF + (q >> 3) * BLOCK + p * ROW +
                                    (((q & 7) ^ (p & 7)) << 4)) =
              make_uint4(pack_bf16(cv[0], cv[1]), pack_bf16(cv[2], cv[3]),
                         pack_bf16(cv[4], cv[5]), pack_bf16(cv[6], cv[7]));
        }
      }
      if (v < VIEWS - 1) fence_proxy_async();
      consumer_sync();  // r_v is read: the buffer takes the next latent tile
      if (v < VIEWS - 1 && ctid == 0) mbar_arrive(empty_x);
      // f += c_v W_f1[400 v .. 400 v + 399]
      gemm<NF, F_STEPS>(accF, cf, wg * NF, ln, ring);
    }
    consumer_sync();  // both warpgroups are done with c_3
    // f = ReLU(bn1(f + b_f1 rounded)), rounded, into fusion2's A
#pragma unroll
    for (int i = 0; i < NF / 8; ++i) {
      const int c = wg * NF + 8 * i + 2 * tig;
      const float2 bias = bf16_pair(b_f1 + c);
      const float4 s0 = bnp[c], s1 = bnp[c + 1];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint32_t*>(CF + swz(pr + 8 * rr, c)) =
            pack_bf16(bn_relu(bf16r(accF[4 * i + 2 * rr] + bias.x), s0),
                      bn_relu(bf16r(accF[4 * i + 2 * rr + 1] + bias.y), s1));
    }
    consumer_sync();
    // g = f W_f2 + b_f2, rounded, into G (bn2 and ReLU wait for the FTL)
    zero(accF);
    gemm<NF, F_STEPS>(accF, cf, wg * NF, ln, ring);
    consumer_sync();
#pragma unroll
    for (int i = 0; i < NF / 8; ++i) {
      const int c = wg * NF + 8 * i + 2 * tig;
      const float2 bias = bf16_pair(b_f2 + c);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint32_t*>(CF + (pr + 8 * rr) * G_LD + 2 * c) =
            pack_bf16(accF[4 * i + 2 * rr] + bias.x, accF[4 * i + 2 * rr + 1] + bias.y);
    }
    consumer_sync();
    float4 s2[8], s3[6];  // this thread's channels of bn2 (8 q ..) and bn3 (6 q ..)
    if (ftl_thread) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s2[j] = bnp[CANON + 8 * q + j];
#pragma unroll
      for (int j = 0; j < 6; ++j) s3[j] = bnp[2 * CANON + 6 * q + j];
    }
    for (int v = 0; v < VIEWS; ++v) {
      // t_v = ReLU(bn3(FTL(ReLU(bn2(g)), P[b, v]))) in float32, rounded,
      // into rearrange2's A (its K 300 .. 303 zero)
      if (ftl_thread) {
        float pv[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) pv[j] = __ldg(P + (VIEWS * b + v) * 12 + j);
        for (int p = p_ftl; p < TP; p += FTL_THREADS / PAIRS) {
          const uint4 gq = *reinterpret_cast<const uint4*>(CF + p * G_LD + 16 * q);
          const uint32_t gw[4] = {gq.x, gq.y, gq.z, gq.w};
          float y[8];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = unpack_bf16(gw[k]);
            y[2 * k] = bn_relu(f.x, s2[2 * k]);
            y[2 * k + 1] = bn_relu(f.y, s2[2 * k + 1]);
          }
          float tv[6];
#pragma unroll
          for (int gg = 0; gg < 2; ++gg)
#pragma unroll
            for (int i = 0; i < 3; ++i)
              tv[3 * gg + i] = bn_relu(
                  fmaf(y[4 * gg + 3], pv[4 * i + 3],
                       fmaf(y[4 * gg + 2], pv[4 * i + 2],
                            fmaf(y[4 * gg + 1], pv[4 * i + 1],
                                 __fmul_rn(y[4 * gg], pv[4 * i])))),
                  s3[3 * gg + i]);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            *reinterpret_cast<uint32_t*>(sm + swz(p, 6 * q + 2 * k)) =
                pack_bf16(tv[2 * k], tv[2 * k + 1]);
        }
      }
      if (ctid < TP)
        *reinterpret_cast<uint2*>(sm + swz(ctid, LAT3)) = make_uint2(0u, 0u);
      consumer_sync();
      // out_v = t_v W_r2 + b_r2, rounded, + x_v, rounded
      zero(accO);
      gemm<NO, R2_STEPS>(accO, xrt, wg * NO, ln, ring);
      if (v == VIEWS - 1) fence_proxy_async();
      consumer_sync();  // t_v is read
      if (v == VIEWS - 1 && ctid == 0) mbar_arrive(empty_x);
      const size_t row0 = (size_t)(VIEWS * b + v) * npix;
      const int px[2] = {p0 + pr, p0 + pr + 8};
#pragma unroll
      for (int k = 0; k < NO / 32; ++k) {  // n8 blocks 4k .. 4k + 3
        // after a quad transpose, lane tig holds the 16 bytes of block 4k + tig
        const int c8 = wg * NO + (4 * k + tig) * 8;
        uint4 sq[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          sq[rr] = px[rr] < npix
                       ? __ldg(reinterpret_cast<const uint4*>(x + (row0 + px[rr]) * C + c8))
                       : make_uint4(0u, 0u, 0u, 0u);
        float o[2][4][2];  // [row][n8 block 4k + i][channel pair]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 bias = bf16_pair(b_r2 + wg * NO + (4 * k + i) * 8 + 2 * tig);
          const float* d = accO + (4 * k + i) * 4;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            o[rr][i][0] = bf16r(d[2 * rr] + bias.x);
            o[rr][i][1] = bf16r(d[2 * rr + 1] + bias.y);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t u[4] = {sq[rr].x, sq[rr].y, sq[rr].z, sq[rr].w};
          quad_transpose(u, tig);  // u[i]: block 4k + i, channels 2 tig, + 1
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 s = unpack_bf16(u[i]);
            u[i] = pack_bf16(o[rr][i][0] + s.x, o[rr][i][1] + s.y);
          }
          quad_transpose(u, tig);  // u[i]: block 4k + tig, channels 2 i, + 1
          if (px[rr] < npix)
            *reinterpret_cast<uint4*>(out + (row0 + px[rr]) * C + c8) =
                make_uint4(u[0], u[1], u[2], u[3]);
        }
      }
    }
  }
}

// The weights as the kernel's stages (see packed_bytes): one 16-byte piece a
// thread, piece `pos` of row n of a stage holding the 8 K-values 8 (pos ^ (n
// & 7)) .. of column n of the (K, N) source, zero past its K and N.
__global__ void pack_ftl_weights(const __nv_bfloat16* __restrict__ w_r1,
                                 const __nv_bfloat16* __restrict__ w_f1,
                                 const __nv_bfloat16* __restrict__ w_f2,
                                 const __nv_bfloat16* __restrict__ w_r2,
                                 unsigned char* __restrict__ packed, int C) {
  const long long pieces = packed_bytes(C) / 16;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pieces;
       i += (long long)gridDim.x * blockDim.x) {
    long long rel = i * 16;
    const __nv_bfloat16* w;
    int rows, n_src, k_src, k_off = 0;
    if (rel < r1_bytes(C)) {
      w = w_r1, rows = R1_N, n_src = LAT3, k_src = C;
    } else if (rel < f2_off(C)) {
      rel -= r1_bytes(C);
      const int v = (int)(rel / ((long long)F_STAGES * SLOT_BYTES));
      rel -= (long long)v * F_STAGES * SLOT_BYTES;
      w = w_f1, rows = CANON, n_src = CANON, k_src = CANON, k_off = v * CANON;
    } else if (rel < r2_off(C)) {
      rel -= f2_off(C);
      w = w_f2, rows = CANON, n_src = CANON, k_src = CANON;
    } else {
      rel -= r2_off(C);
      w = w_r2, rows = C, n_src = C, k_src = LAT3;
    }
    const int st = (int)(rel / (rows * ROW));
    const int n = (int)(rel % (rows * ROW)) / ROW, pos = (int)(rel % ROW) / 16;
    const int k0 = st * KS + 8 * (pos ^ (n & 7));
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat16 h[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + 2 * e + j;
        h[j] = n < n_src && k < k_src ? w[(size_t)(k_off + k) * n_src + n]
                                      : __float2bfloat16_rn(0.f);
      }
      u[e] = (uint32_t)__bfloat16_as_ushort(h[0]) |
             ((uint32_t)__bfloat16_as_ushort(h[1]) << 16);
    }
    *reinterpret_cast<uint4*>(packed + i * 16) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// Per host thread and device: the dynamic shared memory each kernel was
// allowed, and the SM count.
struct FtlDevice {
  int allowed_dev[3] = {-1, -1, -1};  // C = 64, 128, 256
  int sms_dev = -1, sms = 0;
};
FtlDevice& ftl_device() {
  thread_local FtlDevice d;
  return d;
}

template <int C>
cudaError_t launch_ftl_fusion(const __nv_bfloat16* x, const float* P,
                              const float* P_inv, const unsigned char* packed,
                              const __nv_bfloat16* b_r1, const __nv_bfloat16* b_f1,
                              const __nv_bfloat16* b_f2, const __nv_bfloat16* b_r2,
                              const float* bn1, const float* bn2, const float* bn3,
                              float eps, __nv_bfloat16* out, int B, int npix,
                              int which, cudaStream_t stream) {
  // setmaxnreg hands the consumers registers the producer gave up: a kernel
  // built with fewer than REGS_LAUNCH a thread would wait for them forever
  static const bool regs_as_built = [] {
    cudaFuncAttributes fa;
    return cudaFuncGetAttributes(&fa, ftl_fusion_kernel<C>) == cudaSuccess &&
           fa.numRegs == REGS_LAUNCH;
  }();
  if (!regs_as_built) return cudaErrorInvalidConfiguration;
  CUtensorMap xmap;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)npix, (cuuint64_t)VIEWS * B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)npix * C * 2};
  const cuuint32_t box[3] = {KS, TP, 1};
  if (!encode_bf16_map(&xmap, x, 3, dims, strides, box)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  FtlDevice& fd = ftl_device();
  if (fd.sms_dev != dev) {
    e = cudaDeviceGetAttribute(&fd.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    fd.sms_dev = dev;
  }
  if (fd.allowed_dev[which] != dev) {
    e = cudaFuncSetAttribute(ftl_fusion_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    fd.allowed_dev[which] = dev;
  }
  const long long tiles = (long long)B * ((npix + TP - 1) / TP);
  ftl_fusion_kernel<C><<<(unsigned)(tiles < fd.sms ? tiles : fd.sms), THREADS,
                         SMEM_BYTES, stream>>>(xmap, x, P, P_inv, packed, b_r1,
                                               b_f1, b_f2, b_r2, bn1, bn2, bn3,
                                               eps, out, B, npix);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pe

// Bytes of the packed weights at encoder width C: the buffer the wrapper
// allocates for pe_ftl_pack.
extern "C" long long pe_ftl_packed_bytes(int C) { return pe::packed_bytes(C); }

// w_* (Cin, Cout) bf16 -> `packed`, pe_ftl_packed_bytes(C) bytes: the four
// 1x1s as the kernel's stages, one launch on `stream`. The wrapper packs a
// set of weights once and passes the stages to every pe_ftl_fusion call.
extern "C" int pe_ftl_pack(const void* w_r1, const void* w_f1, const void* w_f2,
                           const void* w_r2, void* packed, int C, void* stream) {
  using bf16 = __nv_bfloat16;
  if (C < pe::KS || C % pe::KS || reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  const long long pieces = pe::packed_bytes(C) / 16;
  pe::pack_ftl_weights<<<(unsigned)((pieces + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w_r1), static_cast<const bf16*>(w_f1),
      static_cast<const bf16*>(w_f2), static_cast<const bf16*>(w_r2),
      static_cast<unsigned char*>(packed), C);
  return (int)cudaGetLastError();
}

// x, out: (4B, npix, C) bf16 view-rows; P, P_inv float32 cameras; `packed`,
// the stages pe_ftl_pack wrote at this C; b_* bf16; bn* float32 (4, width).
// One launch on `stream`. The widths it takes are the instances below
// (ops/hopper_ftl.py WIDTHS). Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for shapes and alignments the kernel does not take.
extern "C" int pe_ftl_fusion(const void* x, const void* P, const void* P_inv,
                             const void* packed, const void* b_r1, const void* b_f1,
                             const void* b_f2, const void* b_r2, const void* bn1,
                             const void* bn2, const void* bn3, float eps, void* out,
                             int B, int npix, int C, void* stream) {
  using bf16 = __nv_bfloat16;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(packed);
  if (B < 1 || npix < 1 || align % 16 ||
      (long long)B * ((npix + pe::TP - 1) / pe::TP) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* Pf = static_cast<const float*>(P);
  const auto* Pi = static_cast<const float*>(P_inv);
  const auto* pk = static_cast<const unsigned char*>(packed);
  const auto *br1 = static_cast<const bf16*>(b_r1), *bf1 = static_cast<const bf16*>(b_f1);
  const auto *bf2 = static_cast<const bf16*>(b_f2), *br2 = static_cast<const bf16*>(b_r2);
  const auto *n1 = static_cast<const float*>(bn1), *n2 = static_cast<const float*>(bn2);
  const auto* n3 = static_cast<const float*>(bn3);
  auto* o = static_cast<bf16*>(out);
  cudaError_t e;
  switch (C) {
    case 64:
      e = pe::launch_ftl_fusion<64>(xb, Pf, Pi, pk, br1, bf1, bf2, br2, n1, n2, n3, eps,
                                    o, B, npix, 0, s);
      break;
    case 128:
      e = pe::launch_ftl_fusion<128>(xb, Pf, Pi, pk, br1, bf1, bf2, br2, n1, n2, n3,
                                     eps, o, B, npix, 1, s);
      break;
    case 256:
      e = pe::launch_ftl_fusion<256>(xb, Pf, Pi, pk, br1, bf1, bf2, br2, n1, n2, n3,
                                     eps, o, B, npix, 2, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}
