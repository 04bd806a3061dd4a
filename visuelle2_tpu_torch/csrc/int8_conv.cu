// The w8a8 backbone's convolution for Hopper (sm_90a): an implicit GEMM over
// int8 NHWC activations with the requantize epilogue fused.
//
// It replaces no pl.pallas_call: the JAX engine's convolutions are XLA
// (visuelle2_tpu/models/quantized_resnet.py:86, `_conv(..., jnp.int32)`),
// which fuses the epilogue of :204-213 into each conv, and stock PyTorch has
// no CUDA int8 convolution.  ops/cuda/int8_conv.py is the wrapper and holds
// the plain version.
//
// The GEMM: M = N·Ho·Wo output pixels, N = Cout, K = kh·kw·Cin in (ky, kx, c)
// order.  The weight is packed once ([Cout][K_pad], K_pad a multiple of 32,
// zeros past K).  A block computes a BM x BN tile of the output (BN = 128,
// BM = 128; or BN = 64, BM = 256 when Cout is not a multiple of 128), eight
// warps each a 32 x 64 warp tile of mma.sync m16n8k32 s8 -> s32 products
// (the staging of csrc/probe_gemm.cu).  K runs in 64-byte chunks through a
// ring of four shared-memory stages filled by cp.async: the A chunk of a row
// is gathered from the activation as four 16-byte pieces, each piece 16
// consecutive channels of one input pixel (Cin a multiple of 16), zero-filled
// where the tap falls in the padding or past K; the stem (Cin = 3) gathers
// byte by byte instead.  A 64-byte row's four pieces are stored XOR-swizzled
// by bits 1-2 of the row, so the eight rows one ldmatrix phase reads fall in
// distinct banks.
//
// The epilogue, per output channel, from the accumulators in registers:
//   0  int8  = clamp(rint(acc·m + z), 0, 127)
//   1  int8  = clamp(rint((acc·m + z) + addend), 0, 127)   (conv3 + shortcut)
//   2  float = acc·m + z                                    (downsample sc)
// acc is converted to float32 first and each product and sum is rounded on
// its own (__fmul_rn, __fadd_rn: nvcc cannot contract them into an FMA), in
// the JAX engine's order; __float2int_rn rounds half to even as rint does.
// So the codes are bit-equal to the plain version's.
//
// What bounds it: the 1x1 convs of the early stages move more bytes than the
// int8 tensor cores need time for (at B = 128, layer1's 75² maps); the 3x3
// and late convs are bound by operations.  ops/cuda/roofline.py::
// int8_conv_cost gives the bound of each shape.  This first design uses
// mma.sync and cp.async; wgmma and TMA are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kChunk = 64;  // bytes of K a stage holds per row
constexpr int kWarpRows = 32, kWarpCols = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const unsigned char* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of 16-byte piece `seg` (0-3) of 64-byte row `row` in a stage.
__device__ __forceinline__ int swz(int row, int seg) {
  return row * kChunk + ((seg ^ ((row >> 1) & 3)) << 4);
}

struct Geometry {
  int M, H, W, Cin, Ho, Wo, Cout, kw, stride, pad, K, Kpad, epilogue;
};

__device__ __forceinline__ int requant(float f) {
  const int q = __float2int_rn(f);
  return q < 0 ? 0 : (q > 127 ? 127 : q);
}

template <int BN, bool kGeneric>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ mul, const float* __restrict__ add,
                     const float* __restrict__ addend, void* __restrict__ out, Geometry g) {
  constexpr int kColGroups = BN / kWarpCols;       // 2 or 1
  constexpr int BM = kWarpRows * (kWarps / kColGroups);  // 128 or 256
  constexpr int kRowsA = BM / 64;                  // A rows a thread stages per chunk
  constexpr int kRowsB = BN / 64;                  // B rows a thread stages per chunk
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_s = smem;                       // kStages x BM x 64
  unsigned char* b_s = smem + kStages * BM * kChunk;  // kStages x BN x 64

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int seg = threadIdx.x & 3, row_in = threadIdx.x >> 2;  // 64 rows a pass

  // The output pixels of this thread's A rows: image base, top-left tap.
  long long base[kRowsA];
  int iy0[kRowsA], ix0[kRowsA];
  bool row_ok[kRowsA];
#pragma unroll
  for (int j = 0; j < kRowsA; ++j) {
    const int gm = m0 + row_in + 64 * j;
    row_ok[j] = gm < g.M;
    const int hw = g.Ho * g.Wo;
    const int n = row_ok[j] ? gm / hw : 0;
    const int rem = row_ok[j] ? gm - n * hw : 0;
    const int oy = rem / g.Wo, ox = rem - (rem / g.Wo) * g.Wo;
    base[j] = (long long)n * g.H * g.W * g.Cin;
    iy0[j] = oy * g.stride - g.pad;
    ix0[j] = ox * g.stride - g.pad;
  }
  const int n_chunks = (g.Kpad + kChunk - 1) / kChunk;

  auto load_chunk = [&](int c) {
    unsigned char* a_dst = a_s + (c % kStages) * BM * kChunk;
    unsigned char* b_dst = b_s + (c % kStages) * BN * kChunk;
    const int k = c * kChunk + seg * 16;
    if constexpr (!kGeneric) {
      // One tap for the piece: 16 consecutive channels of one input pixel.
      const int tap = k / g.Cin, ch = k - tap * g.Cin;
      const int ky = tap / g.kw, kx = tap - ky * g.kw;
#pragma unroll
      for (int j = 0; j < kRowsA; ++j) {
        const int iy = iy0[j] + ky, ix = ix0[j] + kx;
        const bool ok = row_ok[j] && k < g.K && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        const int8_t* src = ok ? x + base[j] + ((long long)iy * g.W + ix) * g.Cin + ch : x;
        cp_async16(a_dst + swz(row_in + 64 * j, seg), src, ok ? 16 : 0);
      }
    } else {
      // Any Cin: each byte of the piece is its own tap, loaded on its own.
#pragma unroll 1
      for (int j = 0; j < kRowsA; ++j) {
        unsigned words[4] = {0u, 0u, 0u, 0u};
        for (int b = 0; b < 16; ++b) {
          const int kb = k + b;
          if (!row_ok[j] || kb >= g.K) break;
          const int tap = kb / g.Cin, ch = kb - tap * g.Cin;
          const int ky = tap / g.kw, kx = tap - ky * g.kw;
          const int iy = iy0[j] + ky, ix = ix0[j] + kx;
          if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
            const unsigned char v = static_cast<unsigned char>(
                x[base[j] + ((long long)iy * g.W + ix) * g.Cin + ch]);
            words[b >> 2] |= unsigned(v) << ((b & 3) * 8);
          }
        }
        *reinterpret_cast<uint4*>(a_dst + swz(row_in + 64 * j, seg)) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsB; ++j) {
      const int n = n0 + row_in + 64 * j;
      const bool ok = k < g.Kpad;
      const int8_t* src = ok ? w + (long long)n * g.Kpad + k : w;
      cp_async16(b_dst + swz(row_in + 64 * j, seg), src, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s);
    cp_async_commit();
  }

  const int wr = warp / kColGroups, wc = warp % kColGroups;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix: A lane l reads row l % 16 of an m16 tile at the k-step's
  // first or second 16 bytes (l / 16); B lane l reads row (l & 7) + 8 (l / 16)
  // of a pair of n8 tiles at the k-step's first or second 16 bytes ((l / 8) & 1).
  const int a_row = lane & 15, a_half = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_half = (lane >> 3) & 1;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1);
    cp_async_commit();

    const unsigned char* a_stage = a_s + (c % kStages) * BM * kChunk;
    const unsigned char* b_stage = b_s + (c % kStages) * BN * kChunk;
#pragma unroll
    for (int s = 0; s < kChunk / 32; ++s) {
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], a_stage + swz(wr * kWarpRows + i * 16 + a_row, 2 * s + a_half));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldmatrix_x4(b[j], b_stage + swz(wc * kWarpCols + j * 16 + b_row, 2 * s + b_half));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma(acc[i][j], a[i], &b[j >> 1][(j & 1) * 2]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator (i, j, 2h + e) is row wr*32 + i*16 + h*8 + lane/4,
  // column wc*64 + j*8 + (lane%4)*2 + e of the block's tile.
  const int row0 = m0 + wr * kWarpRows + (lane >> 2);
  const int col0 = n0 + wc * kWarpCols + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + i * 16 + h * 8;
      if (gm >= g.M) continue;
      const long long o = (long long)gm * g.Cout;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + j * 8;
        const float2 mm = *reinterpret_cast<const float2*>(mul + col);
        const float2 zz = *reinterpret_cast<const float2*>(add + col);
        float f0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), mm.x), zz.x);
        float f1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), mm.y), zz.y);
        if (g.epilogue == 2) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o + col) = make_float2(f0, f1);
          continue;
        }
        if (g.epilogue == 1) {
          const float2 ad = *reinterpret_cast<const float2*>(addend + o + col);
          f0 = __fadd_rn(f0, ad.x);
          f1 = __fadd_rn(f1, ad.y);
        }
        char2 q;
        q.x = static_cast<signed char>(requant(f0));
        q.y = static_cast<signed char>(requant(f1));
        *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o + col) = q;
      }
    }
}

template <int BN, bool kGeneric>
int launch(const int8_t* x, const int8_t* w, const float* mul, const float* add,
           const float* addend, void* out, const Geometry& g, cudaStream_t stream) {
  constexpr int BM = kWarpRows * (kWarps / (BN / kWarpCols));
  constexpr int smem = kStages * (BM + BN) * kChunk;
  auto kernel = int8_conv_kernel<BN, kGeneric>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.M + BM - 1) / BM, g.Cout / BN);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, mul, add, addend, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, H, W, Cin] int8, w [Cout, Kpad] int8, m and z [Cout] float32, addend
// [N, Ho, Wo, Cout] float32 (epilogue 1 only, else null) -> out [N, Ho, Wo,
// Cout] (int8, or float32 for epilogue 2).  Returns cudaGetLastError() (0 on
// success).  The caller (ops/cuda/int8_conv.py) has checked dtypes, shapes,
// contiguity, 16-byte alignment, Cout a multiple of 64 and Kpad a multiple of
// 32 holding K = kh·kw·Cin.
extern "C" int v2t_int8_conv(const void* x, const void* w, const void* m, const void* z,
                             const void* addend, void* out, int N, int H, int W, int Cin,
                             int Ho, int Wo, int Cout, int kh, int kw, int stride, int pad,
                             int K, int Kpad, int epilogue, void* stream) {
  (void)kh;
  const Geometry g{N * Ho * Wo, H, W, Cin, Ho, Wo, Cout, kw, stride, pad, K, Kpad, epilogue};
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* ms = static_cast<const float*>(m);
  const auto* zs = static_cast<const float*>(z);
  const auto* as = static_cast<const float*>(addend);
  auto s = static_cast<cudaStream_t>(stream);
  const bool generic = Cin % 16 != 0;
  if (Cout % 128 == 0)
    return generic ? launch<128, true>(xs, ws, ms, zs, as, out, g, s)
                   : launch<128, false>(xs, ws, ms, zs, as, out, g, s);
  return generic ? launch<64, true>(xs, ws, ms, zs, as, out, g, s)
                 : launch<64, false>(xs, ws, ms, zs, as, out, g, s);
}
