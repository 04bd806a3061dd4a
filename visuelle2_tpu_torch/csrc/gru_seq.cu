// GRU recurrence over a whole sequence, for Hopper (sm_90a): one persistent
// launch per call.
//
// Replaces visuelle2_tpu/ops/pallas/gru_seq.py::fused_gru_sequence.  The
// input projection gi = x @ W_i + b_i [B, T, 3H] is one GEMM the caller runs
// before this kernel, as the JAX wrapper does; here runs only the recurrence:
//
//     gh  = h @ W_h + b_h                       [B, 3H], gates (r, z, n)
//     r   = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//     n   = tanh(gi_n + r * gh_n)
//     h   = (1 - z) * n + z * h                 written to outs[:, t, :]
//
// gi [B, T, 3H], W_h [H, 3H] (the JAX [in, out] layout, gate order r, z, n:
// torch.nn.GRU's order, transposed), b_h [3H], h0 [B, H]; outs [B, T, H],
// h_T [B, H]: float32, row-major, contiguous.  Every product is a float32 FMA
// chain over its inner index in order; no tensor core is used, so two calls
// on the same inputs give the same bits.
//
// What bounds it.  At the CrossAttnRNN trend GRU's shape (B = 128, T = 52,
// H = 512) the recurrence does T * 2 * B * H * 3H = 10.5 GFLOP, about 157 us
// at the H100's 67 TFLOP/s of float32 outside the tensor cores, against 58 MB
// to move (gi in, outs out, W_h once), about 17 us at 3.35 TB/s: bound by
// operations.  Step t needs every h of step t - 1, so the steps are serial,
// and a launch per step would pay launch and fill latency T times.
//
// The design is the Pallas kernel's idea (W_h and h resident for the whole
// sequence, gru_seq.py:27-39) in Hopper's terms: one cooperative launch, so
// the runtime either makes every block resident at once or refuses the
// launch (the barrier below would deadlock on a block left waiting for an
// SM, as when another stream holds part of the card).  Block (s, g) owns hidden units [16 s, 16 s + 16) and keeps
// its slice of W_h, the three gates of its units over all H (96 KB at
// H = 512), in shared memory for all T steps.  Its row group g is the row
// tiles g, g + G, ... of 32 batch rows, where G is as many groups as fit
// beside the ceil(H / 16) unit slices on the card at once (4 at B = 128,
// H = 512: 128 blocks).  Each step, for each of its row tiles, a block reads
// the previous h of the tile's rows from outs[:, t - 1, :] (h0 at t = 0) past
// L1 (__ldcg: other SMs wrote it, and L1 is not coherent) into shared memory,
// computes the three gate sums of its units for two rows a thread, each as a
// float4 walk over k, finishes the r/z/n epilogue in registers and writes
// h_t; the last step also writes h_T.  Then the blocks of a row group meet at
// a barrier: a release add to the group's counter, and a wait until an
// acquire load of it shows every unit slice done with the step.  The
// counters are zeroed by the caller on every call and only grow within it.
// gi of the next step is loaded into registers before the barrier.
//
// What bounds this form (H100 SXM, perf/gru_split.py at the trend GRU's
// shape): the product loop, about 70% of the launch, and within it the
// shared-memory loads of the W_h slice, three 128-bit loads a warp per four
// k for 24 FMAs; then a fixed few us a step of epilogue, release and arrive.
// The barrier's wait costs little, and the h tile's loads, all in flight at
// once, one L2 round trip a step.  More rows or units a thread (fewer W_h
// loads per FMA) is the next lever.
//
// Shared memory, dynamic: the W_h slice, [ceil(H / 4)][3][16] float4s (four
// consecutive k of one gate column, zero past H), then the h tile, [32][ldh]
// floats with ldh = 4 ceil(H / 4) + 4 (rows float4-aligned and in distinct
// banks), zero past H.  ops/cuda/gru_seq.py::smem_bytes computes the same
// size; the wrapper raises on CUDA tensors with an H for which it passes
// 227 KB (H > 724).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kUnits = 16;     // hidden units of a block
constexpr int kRowThreads = 16;  // threadIdx.y
constexpr int kRowsPer = 2;    // rows of a thread
constexpr int kRows = kRowThreads * kRowsPer;  // rows of a tile
constexpr int kThreads = kUnits * kRowThreads;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid (ceil(H / 16) unit slices, G row groups); `vec0` / `vec_outs`: h0 /
// outs allow float4 loads of h (H % 4 == 0, 16-byte aligned).
__global__ void __launch_bounds__(kThreads, 1)
gru_persistent_f32_kernel(const float* __restrict__ gi, const float* __restrict__ wh,
                          const float* __restrict__ bh, const float* __restrict__ h0,
                          // read back through __ldcg after other blocks wrote it
                          float* outs, float* __restrict__ h_last,
                          unsigned* __restrict__ counters, int B, int T, int H, int vec0,
                          int vec_outs) {
  extern __shared__ float4 smem4[];
  const int nq = (H + 3) / 4;
  const int ldh = 4 * nq + 4;
  float4* w_s = smem4;                                     // [nq][3][kUnits]
  float* h_s = reinterpret_cast<float*>(w_s + nq * 3 * kUnits);  // [kRows][ldh]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kUnits + tx;
  const int u0 = blockIdx.x * kUnits, j = u0 + tx;
  const int groups = gridDim.y, slices = gridDim.x;
  const int n_tiles = (B + kRows - 1) / kRows;
  const long long H3 = 3LL * H;

  for (int i = tid; i < nq * 3 * kUnits; i += kThreads) {
    const int u = i % kUnits, g = (i / kUnits) % 3, q = i / (3 * kUnits);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      v[e] = (k < H && u0 + u < H) ? wh[k * H3 + g * H + u0 + u] : 0.f;
    }
    w_s[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const bool unit = j < H;
  const float b_r = unit ? bh[j] : 0.f, b_z = unit ? bh[H + j] : 0.f,
              b_n = unit ? bh[2 * H + j] : 0.f;

  // gi of (t, the thread's rows of `tile`), as r, z, n.
  auto load_gi = [&](int t, int tile, float (&g)[kRowsPer][3]) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const long long row = (long long)tile * kRows + ty + kRowThreads * i;
      if (unit && row < B) {
        const float* p = gi + (row * T + t) * H3 + j;
        g[i][0] = __ldg(p);
        g[i][1] = __ldg(p + H);
        g[i][2] = __ldg(p + 2 * H);
      }
    }
  };

  const float4* w4 = w_s;
  float g_next[kRowsPer][3];
  load_gi(0, blockIdx.y, g_next);
  for (int t = 0; t < T; ++t) {
    const float* prev = t == 0 ? h0 : outs + (long long)(t - 1) * H;
    const long long stride = t == 0 ? H : (long long)T * H;
    const bool vec = t == 0 ? vec0 : vec_outs;
    for (int tile = blockIdx.y; tile < n_tiles; tile += groups) {
      const int r0 = tile * kRows, nrows = min(kRows, B - r0);
      float g_cur[kRowsPer][3];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int e = 0; e < 3; ++e) g_cur[i][e] = g_next[i][e];
      __syncthreads();  // every thread is done with the previous h tile
      if (vec) {  // H % 4 == 0: nq float4s a row
        float4* h4 = reinterpret_cast<float4*>(h_s);
        // Unrolled, a thread's loads are all issued before its stores (16 a
        // step at H = 512): one L2 round trip, not one a load.
#pragma unroll 16
        for (int i = tid; i < kRows * nq; i += kThreads) {
          const int r = i / nq, q = i - r * nq;
          h4[r * (ldh / 4) + q] =
              r < nrows ? __ldcg(reinterpret_cast<const float4*>(prev + (r0 + r) * stride) + q)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int i = tid; i < kRows * 4 * nq; i += kThreads) {
          const int r = i / (4 * nq), k = i - r * 4 * nq;
          h_s[r * ldh + k] = r < nrows && k < H ? __ldcg(prev + (r0 + r) * stride + k) : 0.f;
        }
      }
      __syncthreads();
      // Prefetch the next (step, tile)'s gi while this one computes.
      const int next_tile = tile + groups < n_tiles ? tile + groups : blockIdx.y;
      const int next_t = tile + groups < n_tiles ? t : t + 1;
      if (next_t < T) load_gi(next_t, next_tile, g_next);

      float acc[kRowsPer][3] = {};
#pragma unroll 4
      for (int q = 0; q < nq; ++q) {
        float4 hv[kRowsPer];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i)
          hv[i] = *reinterpret_cast<const float4*>(h_s + (ty + kRowThreads * i) * ldh + 4 * q);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float4 w = w4[(q * 3 + g) * kUnits + tx];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i)
            acc[i][g] = fmaf(hv[i].w, w.w, fmaf(hv[i].z, w.z,
                        fmaf(hv[i].y, w.y, fmaf(hv[i].x, w.x, acc[i][g]))));
        }
      }

      if (unit) {
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const int r = ty + kRowThreads * i;
          if (r >= nrows) continue;
          const long long row = r0 + r;
          const float rg = sigmoidf(g_cur[i][0] + (acc[i][0] + b_r));
          const float zg = sigmoidf(g_cur[i][1] + (acc[i][1] + b_z));
          const float ng = tanhf(g_cur[i][2] + rg * (acc[i][2] + b_n));
          const float h = (1.f - zg) * ng + zg * h_s[r * ldh + j];
          outs[(row * T + t) * H + j] = h;
          if (t == T - 1) h_last[row * H + j] = h;
        }
      }
    }
    if (t + 1 < T) {  // every unit slice of this row group is done with step t
      __syncthreads();
      if (tid == 0) {
        unsigned* counter = counters + blockIdx.y;
        __threadfence();
        add_release(counter, 1u);
        const unsigned target = (unsigned)slices * (unsigned)(t + 1);
        while (load_acquire(counter) < target) {
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Runs the T steps as one cooperative launch on `stream` of ceil(H / 16) x G
// blocks of 16 x 16 threads with `smem_bytes` of dynamic shared memory, G =
// the row groups that fit on the card beside the unit slices, at most
// ceil(B / 32); `counters` holds ceil(B / 32) zeroed words.  Returns a
// cudaError_t (0 on success): cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be resident at once, which the barrier needs.  The
// launch goes through cudaLaunchKernelEx, so a CUDA graph can capture it.
// The caller has checked shapes, dtypes, devices, contiguity and the
// shared-memory size.
extern "C" int v2t_fused_gru_sequence_f32(const void* gi, const void* wh, const void* bh,
                                          const void* h0, void* outs, void* h_last,
                                          void* counters, int B, int T, int H, int smem_bytes,
                                          void* stream) {
  auto kernel = gru_persistent_f32_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int slices = (H + kUnits - 1) / kUnits, n_tiles = (B + kRows - 1) / kRows;
  const int fit = sms * per_sm / slices;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(slices, fit < n_tiles ? fit : n_tiles);
  const int vec0 = H % 4 == 0 && ((unsigned long long)h0 % 16) == 0;
  const int vec_outs = H % 4 == 0 && ((unsigned long long)outs % 16) == 0;
  cudaLaunchAttribute cooperative = {};
  cooperative.id = cudaLaunchAttributeCooperative;
  cooperative.val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kUnits, kRowThreads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = (cudaStream_t)stream;
  config.attrs = &cooperative;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, (const float*)gi, (const float*)wh,
                                 (const float*)bh, (const float*)h0, (float*)outs,
                                 (float*)h_last, (unsigned*)counters, B, T, H, vec0, vec_outs);
}
