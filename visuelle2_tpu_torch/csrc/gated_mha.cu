// Fused multi-head attention with the gated epilogues of gated_v2, for Hopper
// (sm_90a).
//
// Replaces visuelle2_tpu/ops/pallas/gated_mha.py::fused_gated_mha:
//
//     q, k, v = query @ Wq + bq, key @ Wk + bk, value @ Wv + bv
//     ctx_h   = softmax(q_h k_hᵀ · d^-½ + mask) v_h                 per head h
//     head:   y = merge(ctx_h ⊙ σ(q_h @ Wg + bg)) @ Wo + bo        Wg [d, d]
//     pure:   y = (merge(ctx) ⊙ σ(query @ Wg + bg)) @ Wo + bo      Wg [D, D]
//
// query [B, Lq, D], key and value [B, Lk, D], mask [Lq, Lk] additive (0 or
// -inf), Wq/Wk/Wv/Wo [D, D] in the JAX [in, out] layout, biases [D], out
// [B, Lq, D]: float32, row-major, contiguous; every sum is accumulated in
// float32 and no tensor core is used, so the result keeps float32 parity.
//
// What bounds it.  On the main path (gated_v2, B = 128, D = 64, 4 heads of
// d = 16) the "head" call of the trend encoder (Lq = Lk = 52) does about
// 320 MFLOP -- the q/k/v projections 164 M, scores 44 M, probabilities x v
// 44 M, gate 14 M, output 55 M -- which takes about 4.8 us at the H100's
// 67 TFLOP/s of float32 outside the tensor cores, against 3.5 MB to move
// (query, key and value are one tensor there; the output; the weights),
// about 1.0 us at 3.35 TB/s: it is bound by operations.  The "pure" call of
// the decoder (Lq = 1, Lk = 52, key and value one tensor) does about
// 114 MFLOP (1.7 us) and moves 1.9 MB (0.6 us).
//
// The design keeps everything between the inputs and the output on chip, as
// the Pallas kernel does, and is otherwise the simplest correct one: one
// block per batch row, so the ragged batch edge needs no mask and no padding
// copy.  The row's query, key and value and their projections are staged in
// dynamic shared memory; each thread of a projection computes one output
// column for four rows, in float32, reading each weight once through the
// read-only cache, so consecutive threads read consecutive weight columns.
// Each (head, query row) pair is one warp: the lanes take the keys (the key
// rows are padded so that they fall in distinct banks), the row max and sum
// are warp shuffles, and the probabilities stay in a per-warp strip of
// shared memory.  The gate and the output projection run on the context in
// shared memory.  The [B, h, Lq, Lk] probabilities and the [B, L, D] intermediates
// never reach device memory.  wgmma, TMA and tensor cores (which would need
// TF32 and lose float32 parity) are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Rows of a projection one thread computes: each weight it loads feeds
// kRows multiply-adds, and the kRows sums are independent.
constexpr int kRows = 4;

// out[r * ldo + c] = bias[c] + sum_k x[r * D + k] * w[k * D + c] for
// r < rows, c < D; x and out in shared memory, w [D, D] in device memory.
// Each sum runs over k in order, in float32.
__device__ void project(const float* x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* out, int ldo,
                        int rows, int D) {
  const int groups = (rows + kRows - 1) / kRows;
  for (int i = threadIdx.x; i < groups * D; i += blockDim.x) {
    const int g = i / D, c = i - g * D;
    const float* xr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xr[r] = x + min(g * kRows + r, rows - 1) * D;
    float acc[kRows] = {};
    for (int k = 0; k < D; ++k) {
      const float wk = __ldg(w + k * D + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xr[r][k], wk, acc[r]);
    }
    const float b = __ldg(bias + c);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (g * kRows + r < rows) out[(g * kRows + r) * ldo + c] = acc[r] + b;
  }
}

// Shared-memory layout, in floats:
//   query [Lq*D] | key [Lk*D] | value [Lk*D] | q [Lq*D] | k [Lk*(D+1)] |
//   v [Lk*D] | ctx [Lq*D] | probabilities [warps*Lk]
// The projected keys' rows are D + 1 apart: the lanes of a warp read one
// key row each, and an odd row stride puts them in 32 different banks.
// ops/cuda/gated_mha.py::_smem_bytes computes the same size.
__global__ void gated_mha_f32_kernel(
    const float* __restrict__ query, const float* __restrict__ key,
    const float* __restrict__ value, const float* __restrict__ mask,
    const float* __restrict__ wq, const float* __restrict__ bq,
    const float* __restrict__ wk, const float* __restrict__ bk,
    const float* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ wg, const float* __restrict__ bg,
    const float* __restrict__ wo, const float* __restrict__ bo,
    float* __restrict__ out, int Lq, int Lk, int D, int num_heads,
    float scale, int head_gate) {
  extern __shared__ float smem[];
  float* query_s = smem;
  float* key_s = query_s + Lq * D;
  float* value_s = key_s + Lk * D;
  float* q_s = value_s + Lk * D;
  const int ldk = D + 1;
  float* k_s = q_s + Lq * D;
  float* v_s = k_s + Lk * ldk;
  float* ctx_s = v_s + Lk * D;
  float* p_s = ctx_s + Lq * D;

  const long long row = blockIdx.x;
  const float* qg = query + row * Lq * D;
  const float* kg = key + row * Lk * D;
  const float* vg = value + row * Lk * D;
  for (int i = threadIdx.x; i < Lq * D; i += blockDim.x) query_s[i] = qg[i];
  for (int i = threadIdx.x; i < Lk * D; i += blockDim.x) {
    key_s[i] = kg[i];
    value_s[i] = vg[i];
  }
  __syncthreads();

  project(query_s, wq, bq, q_s, D, Lq, D);
  project(key_s, wk, bk, k_s, ldk, Lk, D);
  project(value_s, wv, bv, v_s, D, Lk, D);
  __syncthreads();

  // Attention: one warp per (head, query row).
  const int d = D / num_heads;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  float* p = p_s + warp * Lk;
  for (int pair = warp; pair < num_heads * Lq; pair += warps) {
    const int h = pair / Lq, i = pair - h * Lq;
    const float* qi = q_s + i * D + h * d;
    float row_max = -INFINITY;
    for (int j = lane; j < Lk; j += kWarp) {
      const float* kj = k_s + j * ldk + h * d;
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot = fmaf(qi[e], kj[e], dot);
      const float s = dot * scale + mask[i * Lk + j];
      p[j] = s;
      row_max = fmaxf(row_max, s);
    }
    row_max = warp_max(row_max);
    float row_sum = 0.f;
    for (int j = lane; j < Lk; j += kWarp) {
      const float ex = expf(p[j] - row_max);
      p[j] = ex;
      row_sum += ex;
    }
    row_sum = warp_sum(row_sum);
    const float inv = 1.f / row_sum;
    for (int j = lane; j < Lk; j += kWarp) p[j] *= inv;
    __syncwarp();
    for (int e = lane; e < d; e += kWarp) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(p[j], v_s[j * D + h * d + e], acc);
      ctx_s[i * D + h * d + e] = acc;
    }
    __syncwarp();
  }
  __syncthreads();

  // Gate, in place on the context.
  for (int idx = threadIdx.x; idx < Lq * D; idx += blockDim.x) {
    const int i = idx / D, c = idx - i * D;
    float logit;
    if (head_gate) {
      const int h = c / d, e = c - h * d;
      const float* qh = q_s + i * D + h * d;
      float acc = 0.f;
      for (int k = 0; k < d; ++k) acc = fmaf(qh[k], __ldg(wg + k * d + e), acc);
      logit = acc + __ldg(bg + e);
    } else {
      const float* xr = query_s + i * D;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc = fmaf(xr[k], __ldg(wg + k * D + c), acc);
      logit = acc + __ldg(bg + c);
    }
    ctx_s[idx] *= sigmoidf(logit);
  }
  __syncthreads();

  project(ctx_s, wo, bo, out + row * Lq * D, D, Lq, D);
}

}  // namespace

// Launches one block of `threads` threads per batch row on `stream` with
// `smem_bytes` of dynamic shared memory; `scale` is d^-1/2, rounded to
// float32 by the caller as the JAX package rounds it.  Returns
// cudaGetLastError() (0 on success).  The caller has checked shapes, dtypes,
// devices, contiguity and the shared-memory size.
extern "C" int v2t_fused_gated_mha_f32(
    const void* query, const void* key, const void* value, const void* mask,
    const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* wg, const void* bg,
    const void* wo, const void* bo, void* out, int B, int Lq, int Lk, int D,
    int num_heads, float scale, int head_gate, int threads, int smem_bytes,
    void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gated_mha_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  gated_mha_f32_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)query, (const float*)key, (const float*)value,
      (const float*)mask, (const float*)wq, (const float*)bq,
      (const float*)wk, (const float*)bk, (const float*)wv, (const float*)bv,
      (const float*)wg, (const float*)bg, (const float*)wo, (const float*)bo,
      (float*)out, Lq, Lk, D, num_heads, scale, head_gate);
  return (int)cudaGetLastError();
}
