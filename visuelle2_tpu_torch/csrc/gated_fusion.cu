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
// call is memory-bound.  In practice the launch overhead, microseconds, sets
// its time.
//
// The design follows from that and stays simple: one block per tile of
// rows; Wx, Wc and b (20 KB at the main-path shape) and the tile's x and ctx
// rows are staged in dynamic shared memory with coalesced loads; each thread
// accumulates one (row, out-col) logit over the C + D inputs and applies the
// sigmoid / multiply / add epilogue in registers, so the logits never touch
// device memory.  The ragged batch edge is masked, with no padding copy.
// wgmma / TMA would not move a launch-bound call; they are later work.

#include <cuda_runtime.h>

namespace {

// Shared-memory layout, in floats: Wx [D*D] | Wc [C*D] | b [D] | x tile
// [rows*D] | ctx tile [rows*C].  ops/cuda/gated_fusion.py::_smem_bytes
// computes the same size.
__global__ void gated_residual_f32_kernel(const float* __restrict__ x,
                                          const float* __restrict__ ctx,
                                          const float* __restrict__ wx,
                                          const float* __restrict__ wc,
                                          const float* __restrict__ b,
                                          float* __restrict__ out,
                                          int B, int D, int C, int residual) {
  extern __shared__ float smem[];
  const int rows = blockDim.y;
  float* wx_s = smem;
  float* wc_s = wx_s + D * D;
  float* b_s = wc_s + C * D;
  float* x_s = b_s + D;
  float* ctx_s = x_s + rows * D;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, (long long)B - row0);

  for (int i = tid; i < D * D; i += nthreads) wx_s[i] = wx[i];
  for (int i = tid; i < C * D; i += nthreads) wc_s[i] = wc[i];
  for (int i = tid; i < D; i += nthreads) b_s[i] = b[i];
  for (int i = tid; i < nrows * D; i += nthreads) x_s[i] = x[row0 * D + i];
  for (int i = tid; i < nrows * C; i += nthreads) ctx_s[i] = ctx[row0 * C + i];
  __syncthreads();

  const int r = threadIdx.y;
  const int col = threadIdx.x;
  if (r >= nrows) return;

  const float* xr = x_s + r * D;
  const float* cr = ctx_s + r * C;
  float acc_x = 0.f;
  for (int k = 0; k < D; ++k) acc_x = fmaf(xr[k], wx_s[k * D + col], acc_x);
  float acc_c = 0.f;
  for (int k = 0; k < C; ++k) acc_c = fmaf(cr[k], wc_s[k * D + col], acc_c);
  const float logit = acc_x + acc_c + b_s[col];
  const float g = 1.f / (1.f + expf(-logit));
  const float xv = xr[col];
  const float gated = xv * g;
  out[(row0 + r) * D + col] = residual ? xv + gated : gated;
}

}  // namespace

// Launches on `stream` with a block of D x rows threads and `smem_bytes` of
// dynamic shared memory; returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, dtypes, devices and contiguity.
extern "C" int v2t_fused_gated_residual_f32(const void* x, const void* ctx,
                                            const void* wx, const void* wc,
                                            const void* b, void* out,
                                            int B, int D, int C, int rows,
                                            int smem_bytes, int residual,
                                            void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gated_residual_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(D, rows);
  const dim3 grid((B + rows - 1) / rows);
  gated_residual_f32_kernel<<<grid, block, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ctx, (const float*)wx, (const float*)wc,
      (const float*)b, (float*)out, B, D, C, residual);
  return (int)cudaGetLastError();
}

extern "C" const char* v2t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
