// Fused context-conditioned gated residual, for Hopper (sm_90a).
//
// Replaces visuelle2_tpu/ops/pallas/gated_fusion.py::fused_gated_residual:
//
//     g   = sigmoid(x @ Wx + ctx @ Wc + b)
//     out = x + x * g            (residual != 0)
//     out = x * g                (residual == 0)
//
// x [B, D], ctx [B, C], Wx [D, D], Wc [C, D], b [D], out [B, D]: float32,
// row-major, contiguous; every sum is accumulated in float32.
//
// What bounds it.  At the main-path shape (gated_v4: B = 128, D = 32,
// C = 128) one call moves about 119 KB — x, ctx, Wx, Wc and b read once and
// out written once, in float32 — which takes about 36 ns at the H100's
// 3.35 TB/s, against 1.3 MFLOP, about 20 ns at 67 TFLOP/s in float32: the
// call is memory-bound, and in practice its latency, microseconds, sets its
// time: the launch, one trip to L2 or memory for the weights, and the
// longest chain of dependent operations.
//
// The design cuts that chain.  A CTA takes R rows (1, 2 or 4: enough CTAs
// to spread the loads over the SMs) and a tile of up to 32 column units (a
// unit is a float4 of columns where D and the weights' alignment allow it,
// else one column).  The lanes of a warp split into the tile's units and
// 32 / units k-splits, the warps into more k-splits, so that the (D + C)-long
// sum of each output is cut into S interleaved partial sums of about eight
// terms each, every k-split loading its weight rows straight from L2 with
// 16-byte loads (no staging, no barrier before the first FMA).  The
// partials are summed in a fixed order: a shuffle butterfly over the warp's
// k-splits, then the warps in order through 4 KB of shared memory; then the
// sigmoid, multiply and add in registers.  No atomics: the same bits every
// call.  ops/cuda/gated_fusion.py::launch_plan picks R, the units a tile
// and the warps.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float (&w)[1]) { w[0] = __ldg(p); }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float (&w)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
};

// One CTA: rows blockIdx.x * R .. + R, column units blockIdx.y * cub .. + cub
// (V columns a unit); blockDim.x = 32 * warps.
template <int V, int R>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
    gated_residual_f32_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
                              const float* __restrict__ wx, const float* __restrict__ wc,
                              const float* __restrict__ b, float* __restrict__ out, int B,
                              int D, int C, int residual, int cub) {
  __shared__ float part[kMaxWarps * R * kWarp * V];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int ksub = kWarp / cub;  // k-splits in a warp
  const int u = lane % cub, kl = lane / cub;
  const int S = ksub * warps, ks = kl + ksub * warp;
  const int units = D / V;
  const int col = V * min((int)blockIdx.y * cub + u, units - 1);  // clamped for the loads
  const long long row0 = (long long)blockIdx.x * R;
  const float* xr[R];
  const float* cr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long r = min(row0 + i, (long long)B - 1);
    xr[i] = x + r * D;
    cr[i] = ctx + r * C;
  }
  float acc[R][V] = {};
  // This thread's k-split: k = ks, ks + S, ... over [x, ctx] · [Wx; Wc].
  int k = ks;
#pragma unroll 4
  for (; k < D; k += S) {
    float w[V];
    Vec<V>::load(wx + (long long)k * D + col, w);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a = __ldg(xr[i] + k);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = fmaf(a, w[e], acc[i][e]);
    }
  }
#pragma unroll 4
  for (k -= D; k < C; k += S) {
    float w[V];
    Vec<V>::load(wc + (long long)k * D + col, w);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a = __ldg(cr[i] + k);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] = fmaf(a, w[e], acc[i][e]);
    }
  }
  // The warp's k-splits of one unit are lanes cub apart: a butterfly.
  for (int off = kWarp / 2; off >= cub; off >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
  const int tile = cub * V;  // columns of the tile
  if (kl == 0)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) part[(warp * R + i) * tile + u * V + e] = acc[i][e];
  __syncthreads();
  // The warps' partials in order, the bias, the gate.
  for (int t = threadIdx.x; t < R * tile; t += blockDim.x) {
    const int i = t / tile, c = t - i * tile;
    const long long r = row0 + i;
    const int column = (int)blockIdx.y * tile + c;
    if (r >= B || column >= D) continue;
    float s = part[i * tile + c];
    for (int w = 1; w < warps; ++w) s += part[(w * R + i) * tile + c];
    const float logit = s + __ldg(b + column);
    const float g = 1.f / (1.f + expf(-logit));
    const float xv = __ldg(x + r * D + column);
    const float gated = xv * g;
    out[r * D + column] = residual ? xv + gated : gated;
  }
}

template <int V, int R>
int launch(const float* x, const float* ctx, const float* wx, const float* wc, const float* b,
           float* out, int B, int D, int C, int residual, int cub, int warps,
           cudaStream_t stream) {
  const dim3 grid((B + R - 1) / R, (D / V + cub - 1) / cub);
  gated_residual_f32_kernel<V, R><<<grid, kWarp * warps, 0, stream>>>(x, ctx, wx, wc, b, out, B,
                                                                      D, C, residual, cub);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` a grid of ceil(B / rows) x ceil(D / vec / cub) CTAs
// of 32 x warps threads: rows in {1, 2, 4}, vec in {1, 4} (4: D % 4 == 0
// and Wx, Wc 16-byte aligned), cub a power of two up to 32, warps up to 8.
// Returns a CUDA error code (0 on success).  The caller has checked shapes,
// dtypes, devices, contiguity and the plan.
extern "C" int v2t_fused_gated_residual_f32(const void* x, const void* ctx, const void* wx,
                                            const void* wc, const void* b, void* out, int B,
                                            int D, int C, int residual, int rows, int vec,
                                            int cub, int warps, void* stream) {
  const float *xp = (const float*)x, *cp = (const float*)ctx, *wxp = (const float*)wx,
              *wcp = (const float*)wc, *bp = (const float*)b;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    if (rows == 4) return launch<4, 4>(xp, cp, wxp, wcp, bp, op, B, D, C, residual, cub, warps, s);
    if (rows == 2) return launch<4, 2>(xp, cp, wxp, wcp, bp, op, B, D, C, residual, cub, warps, s);
    if (rows == 1) return launch<4, 1>(xp, cp, wxp, wcp, bp, op, B, D, C, residual, cub, warps, s);
  } else if (vec == 1) {
    if (rows == 4) return launch<1, 4>(xp, cp, wxp, wcp, bp, op, B, D, C, residual, cub, warps, s);
    if (rows == 2) return launch<1, 2>(xp, cp, wxp, wcp, bp, op, B, D, C, residual, cub, warps, s);
    if (rows == 1) return launch<1, 1>(xp, cp, wxp, wcp, bp, op, B, D, C, residual, cub, warps, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* v2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
