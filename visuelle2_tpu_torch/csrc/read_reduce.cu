// The conv-floor read-bandwidth probe, for Hopper (sm_90a).
//
// Replaces scripts/perf_pallas_convfloor.py::_pallas_read_reduce: x [M, K]
// bf16 is read once; for each 2048-row tile t and each j < 8 the kernel
// writes the f32 sum of the tile's rows r with r = j (mod 8):
//
//     full[8 t + j, c] = sum_{i < 256} x[2048 t + 8 i + j, c]
//                        + (c < 128 ? bias[j, c] : 0)
//
// for every column c < K.  The probe's result is full[:, :128]; the Pallas
// kernel also sums all K columns before it slices.  Writing the whole (8, K)
// partial (2.9 MB against 369 MB read on shape A) is what keeps every load
// of x alive: a kernel that loaded columns past 128 and never used them
// would have those loads removed by the compiler, and would no longer
// measure the read of x.  M is a multiple of 2048, K of 64 and K >= 128.
//
// What bounds it: the read of x, 2 * M * K bytes at 3.35 TB/s (110.6 us on
// shape A = 720896 x 256, 56.5 us on B = 184320 x 512;
// ops/cuda/roofline.py::read_reduce_cost).
//
// Design.  Shape B has only 90 tiles for 132 SMs, so one block per tile
// would leave a third of the card idle.  A tile is split over K / 64
// blocks by column slices of 64 (128 bytes a row): block (s, t) of 256
// threads reads 2048 rows x 128 bytes.  Eight neighbouring threads read one
// row's 128 bytes as 16-byte loads, so a warp reads four whole rows per
// load, and the 32 thread groups of a block take rows g, g + 32, ...;
// every row a thread reads has the same residue g mod 8.  Each thread keeps
// 8 column sums in registers over its 64 rows, with eight loads in flight;
// the four groups of each residue are then added in order through 8 KB of
// shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileM = 2048;
constexpr int kThreads = 256;
constexpr int kSliceCols = 64;                 // bf16 columns per block
constexpr int kLanesPerRow = kSliceCols / 8;   // 16-byte loads per row slice
constexpr int kGroups = kThreads / kLanesPerRow;  // 32 rows per pass
constexpr int kRowsPerThread = kTileM / kGroups;  // 64
constexpr int kUnroll = 8;

__device__ __forceinline__ void add_bf16x8(float* acc, uint4 v) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[2 * e] += __uint_as_float(u[e] << 16);
    acc[2 * e + 1] += __uint_as_float(u[e] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(kThreads)
    read_reduce_kernel(const uint16_t* __restrict__ x, const float* __restrict__ bias,
                       float* __restrict__ full, int K) {
  __shared__ float red[kGroups][kSliceCols];
  const int slice = blockIdx.x, tile = blockIdx.y;
  const int g = threadIdx.x / kLanesPerRow, lane = threadIdx.x % kLanesPerRow;
  const int col0 = slice * kSliceCols + lane * 8;
  const uint16_t* base = x + ((long long)tile * kTileM + g) * K + col0;

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < kRowsPerThread; i += kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(reinterpret_cast<const uint4*>(base + (long long)(i + u) * kGroups * K));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_bf16x8(acc, v[u]);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[g][lane * 8 + e] = acc[e];
  __syncthreads();

  // 8 residues x 64 columns, two outputs a thread; group g has residue g % 8.
  for (int o = threadIdx.x; o < 8 * kSliceCols; o += kThreads) {
    const int j = o / kSliceCols, cl = o % kSliceCols;
    const float s = red[j][cl] + red[j + 8][cl] + red[j + 16][cl] + red[j + 24][cl];
    const int c = slice * kSliceCols + cl;
    full[((long long)tile * 8 + j) * K + c] = c < 128 ? s + bias[j * 128 + c] : s;
  }
}

}  // namespace

// x [M, K] bf16, bias [8, 128] f32 -> full [8 M / 2048, K] f32; returns
// cudaGetLastError() (0 on success).  The caller has checked dtypes,
// devices, contiguity, M % 2048 == 0, K % 64 == 0 and K >= 128.
extern "C" int v2t_read_reduce_bf16(const void* x, const void* bias, void* full, int M, int K,
                                    void* stream) {
  const dim3 grid(K / kSliceCols, M / kTileM);
  read_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const float*)bias, (float*)full, K);
  return (int)cudaGetLastError();
}
