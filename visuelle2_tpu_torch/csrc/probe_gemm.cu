// The conv-floor probe's int8 GEMM for Hopper (sm_90a): x [M, K] · w [K, N].
//
// Replaces scripts/perf_pallas_convfloor.py::_pallas_matmul_int8 (int8 in,
// exact int32 out).  x, w and out are row-major and contiguous.  The bf16
// probe GEMM (::_pallas_matmul) has its own TMA and wgmma kernel,
// probe_gemm_bf16.cu.
//
// What bounds it.  The probe shapes are narrow: A = 720896 x 256 -> 64 and
// B = 184320 x 512 -> 128.  In int8 they do about 64 (A) and 128 (B)
// operations per byte of device memory, far below the H100's ~590 at which
// the int8 tensor cores and not HBM set the pace.  So the call is bound by
// streaming x through HBM once: 110.2 / 56.4 us at 3.35 TB/s
// (ops/cuda/roofline.py).
//
// The design follows the Pallas kernel's idea, not its blocks.  w (16 KB or
// 64 KB) is staged once per block in shared memory, the counterpart of the
// VMEM-resident weight; each block then walks over row tiles of x,
// blockIdx.x, blockIdx.x + gridDim.x, ..., with as many blocks as fit on the
// card at once.  x arrives in chunks of BM rows x 128 bytes (128 int8
// columns) through a ring of STAGES chunks filled by cp.async, so STAGES - 1
// chunks are in flight while the tensor cores work on one; rows past M are
// zero-filled, so a ragged M needs no padding copy.
//
// Products run on the tensor cores through mma.sync m16n8k32 s8 with s32
// sums, 32 bytes of k per step.  Eight warps cover the block's BM x N output
// tile in warp tiles of 32 rows x 64 columns (2 x 8 mma tiles, 64
// accumulator registers), so BM = 32 * 8 / (N / 64).  Fragments come from
// shared memory by ldmatrix: x's chunk is kept row-major, w transposed to
// [N][K] when it is staged (the "col" operand of mma.sync, k contiguous).
// The eight 16-byte pieces of each 128-byte run of a row are stored
// XOR-swizzled by the row's low three bits, so the eight rows one ldmatrix
// phase reads fall in distinct banks.  The epilogue stores the accumulators
// from registers, masking rows past M.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kChunkBytes = 128;      // bytes of one x row in a chunk
constexpr int kStepBytes = 32;        // k bytes of one mma step
constexpr int kWarpRows = 32;         // a warp's output tile: 32 x 64
constexpr int kWarpCols = 64;

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

// Byte offset of 16-byte piece `seg` in a row: the low three bits of the
// piece index are XORed with the row's, within each 128-byte run.
__device__ __forceinline__ int swizzled(int row, int seg) {
  return ((seg & ~7) | ((seg ^ row) & 7)) << 4;
}

__device__ __forceinline__ void store_pair(int* out, int a, int b) {
  *reinterpret_cast<int2*>(out) = make_int2(a, b);
}

__global__ void __launch_bounds__(kThreads, 1)
    probe_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      int* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];

  const int col_groups = N / kWarpCols;          // 1, 2, 4 or 8
  const int BM = kWarpRows * (kWarps / col_groups);
  const int row_bytes = K;                       // of x, and of w transposed
  const int n_kc = row_bytes / kChunkBytes;      // chunks per row tile
  const int stage_bytes = BM * kChunkBytes;
  unsigned char* wt_s = smem;                    // w transposed: [N][row_bytes]
  unsigned char* x_s = wt_s + N * row_bytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int n_tiles = (M + BM - 1) / BM;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * n_kc;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  // Chunk c of this block: row tile blockIdx.x + (c / n_kc) * gridDim.x,
  // bytes [kc * 128, kc * 128 + 128) of each of its BM rows.
  auto load_chunk = [&](int c) {
    const int tile = (int)blockIdx.x + (c / n_kc) * (int)gridDim.x;
    const int kc = c % n_kc;
    unsigned char* dst = x_s + (c % kStages) * stage_bytes;
    for (int q = threadIdx.x; q < BM * (kChunkBytes / 16); q += kThreads) {
      const int row = q / (kChunkBytes / 16), seg = q % (kChunkBytes / 16);
      const long long grow = (long long)tile * BM + row;
      const bool inside = grow < M;
      const unsigned char* src = inside ? xb + grow * row_bytes + kc * kChunkBytes + seg * 16 : xb;
      cp_async16(dst + row * kChunkBytes + swizzled(row, seg), src, inside ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_chunk(s);
    cp_async_commit();
  }

  // w, transposed into shared memory while the first chunks are in flight.
  // Each thread builds 16-byte pieces of a row n of w transposed (16
  // consecutive k) and stores each whole: neighbouring threads take
  // neighbouring n, so each of their loads reads one run of a row of w, and
  // the swizzle spreads eight rows' stores over distinct banks.
  {
    const uint8_t* w_raw = reinterpret_cast<const uint8_t*>(w);
#pragma unroll 2
    for (int q = threadIdx.x; q < N * (row_bytes / 16); q += kThreads) {
      const int n = q % N, seg = q / N;
      unsigned words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        words[j / 4] |= unsigned(w_raw[(long long)(seg * 16 + j) * N + n]) << (j % 4 * 8);
      *reinterpret_cast<uint4*>(wt_s + n * row_bytes + swizzled(n, seg)) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  }

  const int wr = warp / col_groups, wc = warp % col_groups;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix addresses: for x, lane l reads row l % 16 of the m16 tile, at
  // the step's first or second 16 bytes (l / 16); for w transposed, lane l
  // reads row n = (l & 7) + 8 * (l / 16) of a pair of n8 tiles, at the
  // step's first or second 16 bytes ((l / 8) & 1).
  const int a_row = lane & 15, a_half = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_half = (lane >> 3) & 1;

  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c (and w) have landed; every warp is done with chunk c - 1
    if (c + kStages - 1 < total) load_chunk(c + kStages - 1);
    cp_async_commit();

    const unsigned char* stage = x_s + (c % kStages) * stage_bytes;
    const int kc = c % n_kc;
#pragma unroll
    for (int s = 0; s < kChunkBytes / kStepBytes; ++s) {
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wr * kWarpRows + i * 16 + a_row;
        ldmatrix_x4(a[i], stage + row * kChunkBytes + swizzled(row, 2 * s + a_half));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wc * kWarpCols + j * 16 + b_row;
        ldmatrix_x4(b[j], wt_s + n * row_bytes + swizzled(n, kc * (kChunkBytes / 16) + 2 * s + b_half));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma(acc[i][j], a[i], &b[j >> 1][(j & 1) * 2]);
    }

    if (kc == n_kc - 1) {  // the row tile is done: write it out
      const long long row0 = ((long long)blockIdx.x + (long long)(c / n_kc) * gridDim.x) * BM +
                             wr * kWarpRows + (lane >> 2);
      const int col0 = wc * kWarpCols + (lane & 3) * 2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long grow = row0 + i * 16 + h * 8;
          if (grow < M) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              store_pair(out + grow * N + col0 + j * 8, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0;
        }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// x [M, K], w [K, N] -> out [M, N]; returns cudaGetLastError() (0 on
// success).  The caller has checked dtypes, devices, contiguity, M >= 1,
// N in {64, 128, 256, 512}, K a multiple of 128 and `smem_bytes` =
// K * N + 4 * BM * 128 <= 232448 (ops/cuda/probe_gemm.py::smem_bytes).
extern "C" int v2t_probe_matmul_int8(const void* x, const void* w, void* out, int M, int K,
                                     int N, int smem_bytes, void* stream) {
  auto kernel = probe_gemm_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int BM = kWarpRows * (kWarps / (N / kWarpCols));
  const int n_tiles = (M + BM - 1) / BM;
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int*)out, M, K, N);
  return (int)cudaGetLastError();
}
