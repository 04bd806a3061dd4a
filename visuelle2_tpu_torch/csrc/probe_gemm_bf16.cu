// The conv-floor probe's bf16 GEMM for Hopper (sm_90a): x [M, K] bf16 · w [K, N] bf16
// -> out [M, N] bf16, the f32 sum rounded to bf16 once (round to nearest even, as
// torch's .to(bfloat16)).  x, w and out are row-major and contiguous.
//
// Replaces scripts/perf_pallas_convfloor.py::_pallas_matmul.  The int8 probe GEMM
// stays on the mma.sync kernel of probe_gemm.cu.
//
// What bounds it.  At the probe shapes, A = 720896 x 256 -> 64 and B = 184320 x
// 512 -> 128, the GEMM does about 51 (A) and 102 (B) operations per byte of device
// memory, below the H100's ~295 at which the tensor cores and not HBM set the
// pace: the call is bound by streaming x through HBM once, 137.7 / 70.5 us at
// 3.35 TB/s (ops/cuda/roofline.py).  The mma.sync kernel it replaces fell short
// on both halves: its cp.async ring streamed x at 2.5-2.6 TB/s, and eight warps of
// mma.sync reached about 216 TFLOP/s with the loads removed (perf/gemm_split.py).
//
// The design is Hopper's own.  A persistent grid, one block per SM, walks over row
// tiles of x: tile blockIdx.x, blockIdx.x + gridDim.x, ...  Each block has three
// warpgroups.  One thread of the first, the producer, asks the Tensor Memory
// Accelerator for every copy: w once per block, then x in tiles of BM rows x 64
// columns (128 bytes, 128-byte swizzle) into a ring of `stages` buffers guarded by
// full and empty mbarriers, so the loads of the next chunks, and of the next
// tile, are in flight while the consumers compute and store.  TMA zero-fills rows
// past M, so a ragged M needs no padding copy.  The other two warpgroups, the
// consumers, issue wgmma.mma_async m64nNk16 (bf16 in, f32 sums in registers)
// straight from shared memory: x as the K-major A operand, w as the MN-major B
// operand (bf16 allows it), so w [K, N] row-major is used as TMA lays it down,
// with no transposition by the threads.  setmaxnreg moves registers from the
// producer to the consumers.  For N <= 256 a tile has BM = 128 rows and each
// consumer takes 64 rows and all N columns (N / 2 accumulators a thread); at
// N = 512 a tile has 64 rows and each consumer takes 256 of the columns, since a
// 64 x 512 f32 tile would need 256 registers a thread.  Each consumer keeps one
// chunk's products in flight while it frees the stage of the one before; at the
// end of a tile it rounds its sums to bf16 in registers, gathers each row's
// eight consecutive columns into one lane by shuffles within a quad of lanes,
// and stores them as 16-byte pieces, masking rows past M.
//
// What bounds this form (H100 SXM, perf/gemm_split.py at both probe shapes):
// the memory side, not the tensor cores.  Without its stores x streams at
// about 3 TB/s, the read probe's rate; the stores of out cost some 1.3 to 1.5
// times their bytes' share of the bandwidth.  Removing the wgmma issue
// changes nothing; the ring's depth (4 to 8 stages) changes nothing.
//
// Shared memory: w as N / 64 column panels of [K][128 bytes] (K * N * 2 bytes,
// 128 KB at shape B), then the ring, `stages` x BM x 128 bytes, then the
// barriers; the base is aligned to 1024 bytes, the swizzle's period.  The caller
// (ops/cuda/probe_gemm.py::smem_bytes) gives as many stages as fit, up to eight:
// six at shape B.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int kThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kMaxStages = 8;
constexpr int kChunkK = 64;          // x columns per TMA tile: 128 bytes of bf16
constexpr int kChunkBytes = 128;
constexpr int kSmemFixed = 1024 + 256;  // alignment slack + barriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA tile of a 2-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}

// d[64 x NW] (+)= A[64 x 16] · B[16 x NW]: A K-major, B MN-major (the final
// immediate, trans-b = 1), both 128-byte swizzled; `accumulate` = 0 starts
// the sums.
template <int NW>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tile<64>(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<128>(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tile<256>(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}


// Within each quad of lanes (q = lane % 4), w[p] of lane q becomes w[q] of
// lane p: the off-diagonal 2 x 2 blocks swap with lane q ^ 2, then each
// 2 x 2 block transposes with lane q ^ 1.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? w[k] : w[2 + k], 2);
    if (hi) w[k] = got; else w[2 + k] = got;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w[2 * k] : w[2 * k + 1], 1);
    if (odd) w[2 * k] = got; else w[2 * k + 1] = got;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    probe_gemm_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           __nv_bfloat16* __restrict__ out, int M, int K, int stages) {
  constexpr int NW = N > 256 ? 256 : N;   // columns of one consumer's products
  constexpr int BM = N > 256 ? 64 : 128;  // rows of a tile
  constexpr int kStageBytes = BM * kChunkBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t w_s = smem_addr(smem);
  const uint32_t x_s = w_s + K * N * 2;  // a multiple of 8 KB past w_s
  const uint32_t full0 = x_s + stages * kStageBytes;
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t w_bar = empty0 + 8 * stages;
  const int n_kc = K / kChunkK;
  const int n_tiles = (M + BM - 1) / BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrive from each consumer warp
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(w_bar, K * N * 2);
      for (int nc = 0; nc < N / 64; ++nc)
        for (int kb = 0; kb < n_kc; ++kb)
          tma_load_2d(&w_map, w_s + (nc * K + kb * kChunkK) * kChunkBytes, w_bar, nc * 64,
                      kb * kChunkK);
      int c = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int kc = 0; kc < n_kc; ++kc, ++c) {
          const int s = c % stages;
          mbar_wait(empty0 + 8 * s, ((c / stages) & 1) ^ 1);
          const uint32_t full_bar = full0 + 8 * s;
          mbar_arrive_expect_tx(full_bar, kStageBytes);
          tma_load_2d(&x_map, x_s + s * kStageBytes, full_bar, kc * kChunkK, tile * BM);
        }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int row_off = N > 256 ? 0 : 64 * cw;
    const int col_off = N > 256 ? 256 * cw : 0;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    // B panel of this consumer's columns: LBO steps 64 columns (one panel,
    // K * 128 bytes), SBO steps 8 rows of k (1024 bytes).
    const uint32_t w_base = w_s + (col_off / 64) * K * kChunkBytes;
    const uint32_t x_base = x_s + row_off * kChunkBytes;
    float acc[NW / 2];
    mbar_wait(w_bar, 0);
    int c = 0, pending = -1;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int kc = 0; kc < n_kc; ++kc, ++c) {
        const int s = c % stages;
        mbar_wait(full0 + 8 * s, (c / stages) & 1);
        wgmma_fence();
        // A: 8-row groups 1024 bytes apart, k advanced 32 bytes (2 units) a
        // step inside the swizzled row; B: k advanced 16 rows (2048 bytes).
        const uint64_t a_desc = sw128_desc(x_base + s * kStageBytes, 16, 1024);
        const uint64_t b_desc = sw128_desc(w_base + kc * kChunkK * kChunkBytes, K * kChunkBytes, 1024);
#pragma unroll
        for (int kk = 0; kk < kChunkK / 16; ++kk)
          wgmma_tile<NW>(acc, a_desc + 2 * kk, b_desc + 128 * kk, kc | kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done: free its stage
        if (pending >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pending);
        pending = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      if (lane == 0) mbar_arrive(empty0 + 8 * pending);
      pending = -1;

      // acc[4 j + 2 h + e] is row warp * 16 + lane / 4 + 8 h, column
      // 8 j + 2 (lane % 4) + e of this consumer's 64 x NW tile.  Rounded to
      // bf16 pairs, then transposed within each quad of lanes, so that lane q
      // holds the eight columns 8 (4 jj + q) .. + 7 of its row whole and
      // stores them as one 16-byte piece: a warp writes 64 contiguous bytes
      // of each of its 8 rows per store, not 16.
      const long long row0 = (long long)tile * BM + row_off + warp * 16 + lane / 4;
      const int q = lane % 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + 8 * h;
        __nv_bfloat16* o = out + row * N + col_off;
#pragma unroll
        for (int jj = 0; jj < NW / 32; ++jj) {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * jj + e;
            const __nv_bfloat162 pair =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            w[e] = *reinterpret_cast<const uint32_t*>(&pair);
          }
          quad_transpose(w, q);
          if (row < M) *reinterpret_cast<uint4*>(o + 8 * (4 * jj + q)) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up at run time: the library
// links only the CUDA runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 2-D bf16 map over a row-major [outer, inner] array, tiles of
// box_outer x 64 elements (128 bytes), 128-byte swizzle, zeros past the edge.
bool make_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kChunkK, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch(const void* x, const void* w, void* out, int M, int K, int smem_bytes,
           cudaStream_t stream) {
  constexpr int BM = N > 256 ? 64 : 128;
  int stages = (smem_bytes - kSmemFixed - K * N * 2) / (BM * kChunkBytes);
  stages = stages < kMaxStages ? stages : kMaxStages;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap x_map, w_map;
  if (!make_map(&x_map, x, K, M, BM) || !make_map(&w_map, w, N, K, kChunkK))
    return (int)cudaErrorInvalidValue;
  auto kernel = probe_gemm_bf16_kernel<N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int n_tiles = (M + BM - 1) / BM;
  const int grid = n_tiles < sms ? n_tiles : sms;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(x_map, w_map, (__nv_bfloat16*)out, M, K,
                                                  stages);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N] -> out [M, N]; returns a cudaError_t (0 on success).
// The caller has checked dtypes, devices, contiguity, 16-byte alignment,
// M >= 1, N in {64, 128, 256, 512}, K a multiple of 64, and `smem_bytes`
// (ops/cuda/probe_gemm.py::smem_bytes) <= 232448 with at least two stages.
extern "C" int v2t_probe_matmul_bf16(const void* x, const void* w, void* out, int M, int K,
                                     int N, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 64: return launch<64>(x, w, out, M, K, smem_bytes, s);
    case 128: return launch<128>(x, w, out, M, K, smem_bytes, s);
    case 256: return launch<256>(x, w, out, M, K, smem_bytes, s);
    case 512: return launch<512>(x, w, out, M, K, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
