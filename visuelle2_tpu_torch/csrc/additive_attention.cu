// Fused Bahdanau additive attention, for Hopper (sm_90a).
//
// Replaces visuelle2_tpu/ops/pallas/additive_attention.py::fused_additive_attention:
//
//     h     = enc @ We                       [L, A] per batch row
//     s     = dec @ Wd                       [A]
//     e     = tanh(h + s) @ v + vb           [L]
//     alpha = softmax over L of e
//     out   = alpha * enc   (weight_on "inputs",    Dw = De)
//     out   = alpha * h     (weight_on "projected", Dw = A)
//
// enc [B, L, De], dec [B, Dd], We [De, A], Wd [Dd, A], v [A] (the [A, 1]
// kernel, contiguous), vb [1]; out [B, L, Dw], alpha [B, L]: float32,
// row-major, contiguous.
//
// What bounds it.  At the CrossAttnRNN Demand image call (B = 128, L = 100
// patches, De = Dd = A = 512) the enc @ We product is 2·B·L·De·A = 6.7
// GFLOP against 55 MB to move (enc in, out written, weights), 16 us at 3.35
// TB/s: the call is bound by operations.  Done as float32 FMAs that is 101
// us at the H100's 67 TFLOP/s outside the tensor cores; done as three TF32
// tensor-core products per multiply-add (below) it is 41 us at 494.7 TFLOP/s
// of TF32.  The trend call (L = 52) is half of that, the fused-token call
// (L = 4) a twentieth.
//
// The products, 3xTF32.  TF32 keeps 10 bits of mantissa, so one TF32 product
// breaks float32 parity.  Each operand x is split into hi = x rounded to TF32
// (to nearest, ties away: cvt.rna's rounding, done in integer operations,
// which the card issues far faster than cvt) and lo = x - hi rounded the
// same way, and a product is lo·hi + hi·lo + hi·hi; hi + lo is x to 2^-22
// of |x| and the dropped lo·lo is as small.  With the sums in IEEE float32
// (tests/test_torch_additive.py emulates that on the CPU) this is as close
// to the float32 plain version as float32 itself.  The tensor cores' own
// float32 sums are not: they drop more low bits at each accumulating step.
// With one running sum per tile over all of K (64 steps of 8) the kernel was
// 3.7e-5 from the plain version on the Demand forward's fused-token inputs
// (L = 4, |enc| up to 41), inside a tolerance of about 5e-5 there by only a
// quarter of it, on an H100.  So a tile's tensor-core sum runs over one
// 32-deep chunk only, started at zero each chunk, and the chunks are added
// in float32 registers (below); chip_smoke.py requires the Demand inputs of
// two seeds to stay within half the tolerance.
//
// The design: two launches on the stream, issued by one C call.
//  1. One grouped GEMM, h = enc @ We and s = dec @ Wd: the B·L rows of enc
//     are one [B·L, De] matrix (so L = 4, 52 and 100 need no padding) and the
//     B rows of dec a second one; a block computes one 128 x BN tile of
//     either, the dec tiles after the enc tiles.  BN is 128, 104, 64 or 32,
//     chosen by the wrapper from the shape so that the last wave of tiles on
//     the card's SMs is as full as these widths allow
//     (ops/cuda/additive_attention.py::launch_plan: 104 at L = 100, 3.83
//     waves; 128 at L = 52; 32 at L = 4).  Two warpgroups each own 64 rows
//     and issue wgmma.mma_async m64nBNk8 (TF32 in, float32 sums in
//     registers) on both operands in shared memory, K-major in 8 x 16-byte
//     core matrices without swizzle (tf32 wgmma reads both operands
//     K-major, so the block writes We's chunk transposed).  The block streams
//     32-deep k-chunks: chunk c's products run on the tensor cores while the
//     block splits chunk c + 1 from its raw stage into the other of two
//     shared-memory sets (hi and lo of each operand), and up to three more
//     chunks are in flight from memory into raw stages (cp.async); then
//     chunk c's tensor-core sum is added to the float32 one; two barriers
//     a chunk.  h goes
//     straight to out for "projected" (scaled in place by launch 2), to
//     out's rows for "inputs" when A <= De (overwritten by launch 2), else to
//     a scratch [B, L, A]; s to a scratch [B, A].  (Run as a SIMT launch of
//     its own, dec @ Wd took 15 us at B = 128 on an H100; as 4 to 16 more
//     tensor-core tiles it rides in a wave.  mma.sync m16n8k8 TF32, the
//     first form of this kernel, ran the products at about a third of
//     wgmma's rate on an H100: PERF.md has the times.)
//  2. The energies, softmax and scaling, one block per batch row (1,024
//     threads, 256 below 32 rows of h): a warp takes two rows of h at a
//     time, all of a batch's loads issued before its arithmetic, and folds
//     tanh(h + s)·v into their energies; the block takes the softmax over L,
//     then scales the row's out in batches of four 16-byte loads before
//     their four stores, so that no load waits on a store (out = alpha * h,
//     or alpha * enc).
// perf/additive_split.py times each launch and the GEMM without its
// products, without its loads and with one product of the three.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

// ---------------------------------------------------------------------------
// 1. The grouped 3xTF32 GEMM.
constexpr int kThreads = 256;         // two warpgroups, 64 rows each
constexpr int kBM = 128;              // rows of a tile
constexpr int kMaxBN = 128;           // columns of a tile at most
constexpr int kBK = 32;               // k of one chunk
constexpr int kRawStages = 3;         // chunks in flight from memory
// A split chunk in shared memory, K-major in 8 x 16-byte core matrices
// (wgmma's layout without swizzle): element (r, k) of a chunk at float
// ((r / 8) * 8 + k / 4) * 32 + (r % 8) * 4 + k % 4; core matrices 128 bytes
// apart along k, 8-row groups 1,024 bytes apart.
constexpr int kCoreLbo = 128, kCoreSbo = 1024;
// Dynamic shared memory: two sets of split chunks {A hi, A lo, B^T hi,
// B^T lo}, each 128 x 32 floats (B^T uses BN of its 128 rows), then
// kRawStages chunks as they land: A [128][32] (float4 kq of row r at kq ^
// (r % 8), so that both its writes and the split's reads spread over the
// banks) and B [32][BN].
constexpr int kPart = kBM * kBK;
constexpr int kSet = 4 * kPart;
constexpr int kRaw = kBM * kBK + kBK * kMaxBN;
constexpr int kGemmSmem = 4 * (2 * kSet + kRawStages * kRaw);

// One product C = A[M, K] @ B[K, N] into C (rows ldc apart).
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  int M, K, N, ldc;
  int tiles_m;  // ceil(M / kBM)
  int vec_a;    // 16-byte copies of A: K % 4 == 0, a 16-byte aligned
  int vec_b;    // 16-byte copies of B: N % 4 == 0, b 16-byte aligned
  int vec_c;    // float2 stores: ldc even, c 8-byte aligned
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 bits of mantissa, to nearest, ties away from zero:
// cvt.rna's rounding, in integer operations, which the card issues far
// faster than cvt).
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
// x = hi + lo, each a TF32 value: hi = tf32(x), lo = tf32(x - hi) (x - hi is
// exact in float32).  hi + lo is x to 2^-22 of |x|.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

__device__ __forceinline__ int core_off(int r, int k) {
  return ((r >> 3) * 8 + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// A wgmma shared-memory descriptor, no swizzle: start address, leading
// (along k) and stride (along rows) byte offsets, in 16-byte units.
__device__ __forceinline__ uint64_t core_desc(const float* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kCoreLbo >> 4) << 16) |
         ((uint64_t)(kCoreSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Shared-memory stores become visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x N] = A[64 x 8] · B[8 x N] (+ d, unless scale_d is 0), both K-major
// TF32 in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<104>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "%52, %53, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void store2(const Gemm& p, int row, int col, float x, float y) {
  if (row >= p.M) return;
  float* c = p.c + (size_t)row * p.ldc + col;
  if (p.vec_c && col + 1 < p.N) {
    *reinterpret_cast<float2*>(c) = make_float2(x, y);
  } else {
    if (col < p.N) c[0] = x;
    if (col + 1 < p.N) c[1] = y;
  }
}

// Grid: (p0.tiles_m + p1.tiles_m) x tiles_n tiles of kBM x BN.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_3xtf32_kernel(Gemm p0, Gemm p1, int tiles_n) {
  extern __shared__ __align__(128) float smem[];

  int tile = blockIdx.x;
  const int tiles0 = p0.tiles_m * tiles_n;
  const Gemm p = tile < tiles0 ? p0 : p1;
  if (tile >= tiles0) tile -= tiles0;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int nK = (p.K + kBK - 1) / kBK;

  // Chunk kc from memory into raw stage `stage`, zero past the edges.
  auto load = [&](int kc, int stage) {
    const int k0 = kc * kBK;
    float* ra = smem + 2 * kSet + stage * kRaw;
    float* rb = ra + kBM * kBK;
    if (p.vec_a) {
#pragma unroll
      for (int e = 0; e < kBM * kBK / 4 / kThreads; ++e) {
        const int i = tid + e * kThreads, r = i / 8, kq = i % 8;
        const bool ok = m0 + r < p.M && k0 + 4 * kq < p.K;
        const float* src = ok ? p.a + (size_t)(m0 + r) * p.K + k0 + 4 * kq : p.a;
        float* dst = ra + r * kBK + 4 * (kq ^ (r & 7));
        cp_async16(dst, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, k = i % kBK;
        const bool ok = m0 + r < p.M && k0 + k < p.K;
        const float* src = ok ? p.a + (size_t)(m0 + r) * p.K + k0 + k : p.a;
        float* dst = ra + r * kBK + 4 * ((k / 4) ^ (r & 7)) + k % 4;
        cp_async4(dst, src, ok ? 4 : 0);
      }
    }
    if (p.vec_b) {
      for (int i = tid; i < kBK * BN / 4; i += kThreads) {
        const int k = i / (BN / 4), q = i % (BN / 4);
        const bool ok = k0 + k < p.K && n0 + 4 * q < p.N;
        const float* src = ok ? p.b + (size_t)(k0 + k) * p.N + n0 + 4 * q : p.b;
        float* dst = rb + k * BN + 4 * q;
        cp_async16(dst, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBK * BN; i += kThreads) {
        const int k = i / BN, n = i % BN;
        const bool ok = k0 + k < p.K && n0 + n < p.N;
        const float* src = ok ? p.b + (size_t)(k0 + k) * p.N + n0 + n : p.b;
        float* dst = rb + k * BN + n;
        cp_async4(dst, src, ok ? 4 : 0);
      }
    }
  };
  // Raw stage `stage`, split, into set s.  A: the thread's float4 e is row
  // r, k 4 kq..+3, (r % 8) the fastest of the thread index, so that eight
  // lanes store one 128-byte core matrix; B: column n, k 4 kq..+3.
  auto store_split = [&](int stage, int s) {
    const float* ra = smem + 2 * kSet + stage * kRaw;
    const float* rb = ra + kBM * kBK;
    float* set = smem + s * kSet;
#pragma unroll
    for (int e = 0; e < kBM * kBK / 4 / kThreads; ++e) {
      const int i = tid + e * kThreads;
      const int r = (i / 64) * 8 + i % 8, kq = (i / 8) % 8;
      const float4 x = *reinterpret_cast<const float4*>(ra + r * kBK + 4 * (kq ^ (r & 7)));
      const int o = core_off(r, 4 * kq);
      float4 hi, lo;
      split(x.x, hi.x, lo.x);
      split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z);
      split(x.w, hi.w, lo.w);
      *reinterpret_cast<float4*>(set + o) = hi;
      *reinterpret_cast<float4*>(set + kPart + o) = lo;
    }
    for (int i = tid; i < BN * kBK / 4; i += kThreads) {
      const int n = i % BN, kq = i / BN;
      const float* x = rb + 4 * kq * BN + n;
      const int o = core_off(n, 4 * kq);
      float4 hi, lo;
      split(x[0], hi.x, lo.x);
      split(x[BN], hi.y, lo.y);
      split(x[2 * BN], hi.z, lo.z);
      split(x[3 * BN], hi.w, lo.w);
      *reinterpret_cast<float4*>(set + 2 * kPart + o) = hi;
      *reinterpret_cast<float4*>(set + 3 * kPart + o) = lo;
    }
    fence_proxy_async();
  };

  // A chunk's products are summed by the tensor cores in `acc`, started at 0
  // (scale-d 0) with the two small correction products and then hi·hi, and
  // the chunk's sum is added into `sum` by float32 adds once its products
  // are done.  The tensor cores' float32 sums drop more low bits at each
  // step than a float32 add does, so their sum runs over one chunk (4
  // k-steps of 8) only, and the corrections' steps run while it is 2^-11
  // the size of hi·hi.  `sum` is never a wgmma operand.
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;

  // Chunk kc's products run on the tensor cores while the block splits chunk
  // kc + 1 into the other set, and chunks up to kc + 1 + kRawStages are in
  // flight from memory; then the block waits for them and adds them to
  // `sum`, so the other set is free again when chunk kc + 2 is split into
  // it.  One group of copies is committed per chunk, empty past the last,
  // so that waiting for kRawStages - 1 pending groups always means the
  // oldest chunk has landed.
#pragma unroll
  for (int c = 0; c < kRawStages; ++c) {
    if (c < nK) load(c, c);
    cp_async_commit();
  }
  cp_async_wait<kRawStages - 1>();
  __syncthreads();  // chunk 0 landed, every thread's copies
  store_split(0, 0);
  __syncthreads();  // chunk 0 split; its raw stage is free
  if (kRawStages < nK) load(kRawStages, 0);
  cp_async_commit();
  for (int kc = 0; kc < nK; ++kc) {
    const float* set = smem + (kc & 1) * kSet;
    const float* a_hi = set + core_off(64 * wg, 0);
    const float* a_lo = a_hi + kPart;
    const float* b_hi = set + 2 * kPart;
    const float* b_lo = set + 3 * kPart;
    // k 8 ks..+7 is core matrices 2 ks and 2 ks + 1 along k: 64 ks floats.
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks)
      wgmma_tf32<BN>(acc, core_desc(a_lo + 64 * ks), core_desc(b_hi + 64 * ks), ks);
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks)
      wgmma_tf32<BN>(acc, core_desc(a_hi + 64 * ks), core_desc(b_lo + 64 * ks), 1);
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks)
      wgmma_tf32<BN>(acc, core_desc(a_hi + 64 * ks), core_desc(b_hi + 64 * ks), 1);
    wgmma_commit();
    if (kc + 1 < nK) {
      const int stage = (kc + 1) % kRawStages;
      cp_async_wait<kRawStages - 1>();  // this thread's copies of chunk kc + 1
      __syncthreads();  // everyone's: chunk kc + 1 landed
      store_split(stage, (kc + 1) & 1);
      __syncthreads();  // chunk kc + 1 split; its raw stage is free
      if (kc + 1 + kRawStages < nK) load(kc + 1 + kRawStages, stage);
      cp_async_commit();
    }
    wgmma_wait<0>();  // this warpgroup's products of chunk kc are done
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      // acc is read only after the wait: its registers are tied here to the
      // wait's place in the program, which the compiler keeps.
      asm volatile("" : "+f"(acc[i])::"memory");
      sum[i] += acc[i];
    }
  }

  // sum[4 j + 2 h + e], as acc's: row 16 warp + lane / 4 + 8 h of the
  // warpgroup's 64, column 8 j + 2 (lane % 4) + e.
  const int row = m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    store2(p, row, col, sum[4 * j], sum[4 * j + 1]);
    store2(p, row + 8, col, sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// 2. Energies, softmax over L and scaling, one block per batch row.
// The attend block: 1,024 threads, 256 where the row has few rows of h.
constexpr int kAttendThreads = 1024, kAttendThreadsFew = 256, kFewRows = 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Max (is_max) or sum over the block; every thread gets the result.
template <int Threads>
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < Threads / kWarp; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// h: rows ldh floats apart (out itself for "projected"); s [B, A].  Dynamic
// shared memory: s of the row [A] | v [A] | energies [L] | reduction [32]
// floats; ops/cuda/additive_attention.py::launch_plan computes the same size.
// `vec_h`: float4 loads of h (A % 4 == 0, ldh % 4 == 0, aligned); `vec_o`:
// float4 loads and stores of out and the scaled rows (Dw % 4 == 0, aligned).
template <int Threads>
__global__ void __launch_bounds__(Threads)
attend_kernel(const float* h, int ldh, const float* __restrict__ s, const float* __restrict__ v,
              const float* __restrict__ vb, const float* __restrict__ enc, float* out,
              float* __restrict__ alpha, int L, int A, int Dw, int projected, int vec_h,
              int vec_o) {
  extern __shared__ float sm[];
  float* s_s = sm;
  float* v_s = s_s + A;
  float* e_s = v_s + A;
  float* red = e_s + L;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  constexpr int kWarps = Threads / kWarp;
  const long long b = blockIdx.x;
  for (int a = tid; a < A; a += Threads) {
    s_s[a] = s[b * A + a];
    v_s[a] = v[a];
  }
  __syncthreads();

  // Energies: a warp two rows at a time, its lanes over A, every load of a
  // batch (up to four float4s a row a lane) issued before the arithmetic.
  const float bias = vb[0];
  const float* hb = h + b * L * ldh;
  for (int l0 = warp; l0 < L; l0 += 2 * kWarps) {
    const int l1 = l0 + kWarps;
    const float* r0 = hb + (long long)l0 * ldh;
    const float* r1 = hb + (long long)min(l1, L - 1) * ldh;
    float part0 = 0.f, part1 = 0.f;
    if (vec_h) {
      for (int q0 = 0; q0 < A / 4; q0 += 4 * kWarp) {
        float4 x0[4], x1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + e * kWarp + lane;
          x0[e] = q < A / 4 ? *reinterpret_cast<const float4*>(r0 + 4 * q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
          x1[e] = q < A / 4 && l1 < L ? *reinterpret_cast<const float4*>(r1 + 4 * q)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + e * kWarp + lane;
          if (q >= A / 4) continue;
          const float xs0[4] = {x0[e].x, x0[e].y, x0[e].z, x0[e].w};
          const float xs1[4] = {x1[e].x, x1[e].y, x1[e].z, x1[e].w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int a = 4 * q + c;
            float x = xs0[c];
            part0 = fmaf(v_s[a], tanhf(x + s_s[a]), part0);
            x = xs1[c];
            part1 = fmaf(v_s[a], tanhf(x + s_s[a]), part1);
          }
        }
      }
    } else {
      for (int a = lane; a < A; a += kWarp) {
        float x = r0[a];
        part0 = fmaf(v_s[a], tanhf(x + s_s[a]), part0);
        x = r1[a];
        part1 = fmaf(v_s[a], tanhf(x + s_s[a]), part1);
      }
    }
    part0 = warp_sum(part0);
    part1 = warp_sum(part1);
    if (lane == 0) {
      e_s[l0] = part0 + bias;
      if (l1 < L) e_s[l1] = part1 + bias;
    }
  }
  __syncthreads();

  // Softmax over L; alpha into e_s and out.
  float m = -INFINITY;
  for (int l = tid; l < L; l += Threads) m = fmaxf(m, e_s[l]);
  m = block_reduce<Threads>(m, red, true);
  float sum = 0.f;
  for (int l = tid; l < L; l += Threads) {
    const float ex = expf(e_s[l] - m);
    e_s[l] = ex;
    sum += ex;
  }
  sum = block_reduce<Threads>(sum, red, false);
  for (int l = tid; l < L; l += Threads) {
    const float p = e_s[l] / sum;
    e_s[l] = p;
    alpha[b * L + l] = p;
  }
  __syncthreads();

  // out = alpha * (h in place, or enc): four loads, then their four stores.
  float* ob = out + b * L * Dw;
  const float* xb = projected ? ob : enc + b * L * Dw;
  if (vec_o) {
    const int per_row = Dw / 4, n4 = L * per_row;
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    float4* o4 = reinterpret_cast<float4*>(ob);
    for (int i0 = tid; i0 < n4; i0 += 4 * Threads) {
      float4 x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * Threads;
        if (i < n4) x[e] = x4[i];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * Threads;
        if (i < n4) {
          const float p = e_s[i / per_row];
          o4[i] = make_float4(p * x[e].x, p * x[e].y, p * x[e].z, p * x[e].w);
        }
      }
    }
  } else {
    const int n = L * Dw;
    for (int i0 = tid; i0 < n; i0 += 4 * Threads) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * Threads;
        if (i < n) x[e] = xb[i];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * Threads;
        if (i < n) ob[i] = e_s[i / Dw] * x[e];
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

template <int BN>
cudaError_t launch_gemm(const Gemm& p0, const Gemm& p1, int A, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(gemm_3xtf32_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  const int tiles_n = (A + BN - 1) / BN;
  gemm_3xtf32_kernel<BN><<<(p0.tiles_m + p1.tiles_m) * tiles_n, kThreads, kGemmSmem, st>>>(
      p0, p1, tiles_n);
  return cudaGetLastError();
}

// Launches the two kernels on `stream`: the grouped GEMM, h = enc @ We into
// `h` (rows `ldh` floats apart: out itself, out's rows or a scratch) and s =
// dec @ Wd into `s` [B, A], with tiles of 128 rows by `bn` (32, 64, 104 or
// 128) columns; then the energies, softmax and scaling with `smem_attend` bytes
// of dynamic shared memory.  Returns the first cudaError_t that is not 0
// (cudaErrorInvalidValue for another bn), else 0.  The caller has checked
// shapes, dtypes, devices, contiguity and the shared-memory size, and
// allocated the scratch.
extern "C" int v2t_additive_attention_f32(const void* enc, const void* dec, const void* we,
                                          const void* wd, const void* v, const void* vb,
                                          void* out, void* alpha, void* s, void* h, int B, int L,
                                          int De, int Dd, int A, int ldh, int projected, int bn,
                                          int smem_attend, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * L;
  const Gemm p0 = {(const float*)enc, (const float*)we, (float*)h, M, De, A, ldh,
                   (M + kBM - 1) / kBM, De % 4 == 0 && aligned(enc, 16),
                   A % 4 == 0 && aligned(we, 16), ldh % 2 == 0 && aligned(h, 8)};
  const Gemm p1 = {(const float*)dec, (const float*)wd, (float*)s, B, Dd, A, A,
                   (B + kBM - 1) / kBM, Dd % 4 == 0 && aligned(dec, 16),
                   A % 4 == 0 && aligned(wd, 16), A % 2 == 0 && aligned(s, 8)};
  cudaError_t err;
  switch (bn) {
    case 32: err = launch_gemm<32>(p0, p1, A, st); break;
    case 64: err = launch_gemm<64>(p0, p1, A, st); break;
    case 104: err = launch_gemm<104>(p0, p1, A, st); break;
    case 128: err = launch_gemm<128>(p0, p1, A, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;

  const bool few = L < kFewRows;
  auto attend = few ? attend_kernel<kAttendThreadsFew> : attend_kernel<kAttendThreads>;
  if (smem_attend > 48 * 1024) {
    err = cudaFuncSetAttribute(attend, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_attend);
    if (err != cudaSuccess) return (int)err;
  }
  const int Dw = projected ? A : De;
  const int vec_h = A % 4 == 0 && ldh % 4 == 0 && aligned(h, 16);
  const int vec_o = Dw % 4 == 0 && aligned(out, 16) && (projected || aligned(enc, 16));
  attend<<<B, few ? kAttendThreadsFew : kAttendThreads, smem_attend, st>>>(
      (const float*)h, ldh, (const float*)s, (const float*)v, (const float*)vb,
      (const float*)enc, (float*)out, (float*)alpha, L, A, Dw, projected, vec_h, vec_o);
  return (int)cudaGetLastError();
}
