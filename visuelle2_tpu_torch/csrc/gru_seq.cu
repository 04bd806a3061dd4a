// GRU recurrence over a whole sequence, for Hopper (sm_90a).
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
// chain over its inner index in order; no tensor core is used.
//
// What bounds it.  At the CrossAttnRNN trend GRU's shape (B = 128, T = 52,
// H = 512) the recurrence does T * 2 * B * H * 3H = 10.5 GFLOP, about 157 us
// at the H100's 67 TFLOP/s of float32 outside the tensor cores, against 58 MB
// to move (gi in, outs out, W_h once), about 17 us at 3.35 TB/s: bound by
// operations.  Step t needs every h of step t - 1, so the steps are serial.
//
// The design is the simple first form.  W_h at H = 512 is 3 MB, more than any
// SM's shared memory, so it stays in the 50 MB L2 and each step is its own
// launch: this file's entry point issues the T launches on the stream in
// one call.  A block takes 32 batch rows and 16 hidden units (128 blocks at
// B = 128, H = 512).  It stages its rows of the previous h in shared memory
// (as float4s where H allows) and streams its 3 x 16 columns of W_h through
// shared memory in slices of 64 along H, the next slice's loads issued into
// registers before the current one is used.  Each thread computes all three
// gate sums of one unit for two rows, reading h and W_h four k at a time, so
// the r/z/n epilogue stays in registers and gh never reaches device memory.
// The previous h is read from outs[:, t - 1, :] (h0 at t = 0), so no
// ping-pong buffer is needed; the last step also writes h_T.  A persistent
// single launch that keeps a slice of W_h in each SM's shared memory and
// exchanges h through a grid-wide barrier is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// One step for a block of G * R batch rows and U hidden units, U x G
// threads; each thread keeps R rows (ty + G i) of one unit's three gates.
// W_h streams through shared memory in slices KC deep.
//
// Dynamic shared memory: the block's rows of the previous h, [G R][ldh]
// floats with ldh = H rounded up to KC, plus 4 (rows float4-aligned and in
// distinct banks), zero past H.  ops/cuda/gru_seq.py::_smem_bytes computes
// the same size.  Static: one W_h slice, [KC / 4][3][U] float4s, each
// holding four consecutive k of one gate column.  `vec_h`: H and the row
// stride of h_prev are multiples of 4, so h is loaded as float4.
template <int U, int G, int R, int KC>
__global__ void __launch_bounds__(U * G)
gru_step_f32_kernel(const float* __restrict__ gi, const float* __restrict__ wh,
                    // h_prev points into outs (at t > 0): neither is __restrict__.
                    const float* __restrict__ bh, const float* h_prev,
                    long long prev_stride, float* outs,
                    float* __restrict__ h_last, int t, int B, int T, int H, int vec_h) {
  constexpr int kThreads = U * G;
  constexpr int kRows = G * R;
  constexpr int kWPer = KC * 3 * U / kThreads;  // W_h slice values per thread
  extern __shared__ __align__(16) float h_s[];
  __shared__ __align__(16) float w_s[KC * 3 * U];
  const int nK = (H + KC - 1) / KC;
  const int ldh = nK * KC + 4;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * U + tx;
  const int r0 = blockIdx.y * kRows, u0 = blockIdx.x * U;
  const int nrows = min(kRows, B - r0);
  const long long H3 = 3LL * H;

  float w_pre[kWPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int i = tid + j * kThreads;
      const int u = i % U, g = (i / U) % 3, k = i / (3 * U);
      w_pre[j] = (k0 + k < H && u0 + u < H) ? __ldg(wh + (k0 + k) * H3 + g * H + u0 + u) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int i = tid + j * kThreads;
      const int u = i % U, g = (i / U) % 3, k = i / (3 * U);
      w_s[(((k / 4) * 3 + g) * U + u) * 4 + k % 4] = w_pre[j];
    }
  };

  fetch(0);
  if (vec_h) {
    const int ld4 = ldh / 4;
    float4* h4 = reinterpret_cast<float4*>(h_s);
#pragma unroll 16
    for (int i = tid; i < kRows * ld4; i += kThreads) {
      const int r = i / ld4, k = 4 * (i - r * ld4);
      h4[i] = (r < nrows && k < H)
                  ? *reinterpret_cast<const float4*>(h_prev + (r0 + r) * prev_stride + k)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < kRows * ldh; i += kThreads) {
      const int r = i / ldh, k = i - r * ldh;
      h_s[i] = (r < nrows && k < H) ? h_prev[(r0 + r) * prev_stride + k] : 0.f;
    }
  }

  float acc[R][3] = {};
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  for (int ik = 0; ik < nK; ++ik) {
    __syncthreads();  // the previous slice is consumed (and h_s is written)
    stash();
    __syncthreads();
    if (ik + 1 < nK) fetch((ik + 1) * KC);
#pragma unroll
    for (int kq = 0; kq < KC / 4; ++kq) {
      const int k = ik * KC + kq * 4;
      float4 hv[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        hv[i] = *reinterpret_cast<const float4*>(h_s + (ty + G * i) * ldh + k);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 w = w4[(kq * 3 + g) * U + tx];
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i][g] = fmaf(hv[i].w, w.w, fmaf(hv[i].z, w.z,
                      fmaf(hv[i].y, w.y, fmaf(hv[i].x, w.x, acc[i][g]))));
      }
    }
  }

  const int j = u0 + tx;
  if (j >= H) return;
  const float b_r = __ldg(bh + j), b_z = __ldg(bh + H + j), b_n = __ldg(bh + 2 * H + j);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + G * i;
    if (r >= nrows) continue;
    const long long row = r0 + r;
    const float* g = gi + (row * T + t) * H3;
    const float rg = sigmoidf(g[j] + (acc[i][0] + b_r));
    const float zg = sigmoidf(g[H + j] + (acc[i][1] + b_z));
    const float ng = tanhf(g[2 * H + j] + rg * (acc[i][2] + b_n));
    const float h = (1.f - zg) * ng + zg * h_s[r * ldh + j];
    outs[(row * T + t) * H + j] = h;
    if (h_last) h_last[row * H + j] = h;
  }
}

// Runs the T steps as T launches of ceil(H / U) x ceil(B / (G R)) blocks.
template <int U, int G, int R, int KC>
int run_steps(const float* gi, const float* wh, const float* bh, const float* h0, float* out,
              float* h_last, int B, int T, int H, int smem_bytes, cudaStream_t stream) {
  // Set even below 48 KB: the static W_h slice counts against the default
  // limit too.
  cudaError_t err = cudaFuncSetAttribute(gru_step_f32_kernel<U, G, R, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(U, G);
  const dim3 grid((H + U - 1) / U, (B + G * R - 1) / (G * R));
  for (int t = 0; t < T; ++t) {
    const float* prev = t == 0 ? h0 : out + (long long)(t - 1) * H;
    const long long stride = t == 0 ? H : (long long)T * H;
    const int vec_h = H % 4 == 0 && ((unsigned long long)prev % 16) == 0;
    gru_step_f32_kernel<U, G, R, KC><<<grid, block, smem_bytes, stream>>>(
        gi, wh, bh, prev, stride, out, t == T - 1 ? h_last : nullptr, t, B, T, H, vec_h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Runs the T steps as T launches on `stream`, each of ceil(H / 16) x
// ceil(B / 32) blocks of 16 x 16 threads (2 rows a thread, W_h slices 64
// deep: the fastest of the variants timed at the trend GRU's shape) with
// `smem_bytes` of dynamic shared memory.  Returns the first
// cudaGetLastError() that is not 0, else 0.  The caller has checked shapes,
// dtypes, devices, contiguity and the shared-memory size.
extern "C" int v2t_fused_gru_sequence_f32(const void* gi, const void* wh, const void* bh,
                                          const void* h0, void* outs, void* h_last,
                                          int B, int T, int H, int smem_bytes,
                                          void* stream) {
  return run_steps<16, 16, 2, 64>((const float*)gi, (const float*)wh, (const float*)bh,
                                   (const float*)h0, (float*)outs, (float*)h_last, B, T, H,
                                   smem_bytes, (cudaStream_t)stream);
}
