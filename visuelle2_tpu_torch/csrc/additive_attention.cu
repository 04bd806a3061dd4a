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
// row-major, contiguous.  Every product is a float32 FMA chain over its inner
// index in order; no tensor core is used (TF32 would lose float32 parity).
//
// What bounds it.  At the CrossAttnRNN Demand image call (B = 128, L = 100
// patches, De = Dd = A = 512) the enc @ We product alone is 2·B·L·De·A =
// 6.7 GFLOP, about 100 us at the H100's 67 TFLOP/s of float32 outside the
// tensor cores, against 55 MB to move (enc in, out written, weights), about
// 16 us at 3.35 TB/s: the call is bound by operations.  The trend call (L = 52)
// is half of that, the fused-token call (L = 4) a twentieth.
//
// The design: four launches on the stream, issued by one C call.
//  1. S = dec @ Wd for the whole batch, as one small tiled product (16 rows
//     by 64 columns a block), so Wd is read once per 16 rows and not once
//     per row.
//  2. The energies.  The B·L rows of enc are taken as one [B·L, De] matrix
//     and cut into tiles of TL rows by TA columns of A, one block each, so a
//     tile may span batch rows and the uneven L = 4, 52 and 100 leave no
//     padding.  A block streams enc and We through shared memory in slices
//     along De, the next slice's loads issued into registers before the
//     current slice is used.  Each of the 256 threads keeps an RPT x CPT
//     block of h in registers (TL = 16 RPT, TA = 16 CPT) and reads enc four
//     k at a time, to spend fewer shared-memory loads per multiply-add.  The
//     caller picks the tile by B·L: 16 x 64 for few rows (the fused tokens:
//     many blocks, each with little work), 128 x 128 otherwise; slice depth
//     and blocks per SM are the fastest of the variants timed at the Demand
//     shapes.  When a tile is done the thread folds it through tanh, s and
//     v into its rows' partial energies, the 16 threads that share a row add
//     theirs with warp shuffles, and the block writes one partial energy per
//     row to a scratch [B, A/TA, L].  One row's enc is L·De·4 = 204,800 bytes
//     at the image call, nearly a block's 227 KB of shared memory, and h is
//     as large again: neither is kept on chip whole.  For "projected" the
//     block also writes its h tile, unscaled, into out.
//  3. The softmax, one block per batch row: the partial energies are summed
//     over the column blocks in order, the row max is subtracted.
//  4. The scaling, one block per (batch row, l): out is alpha * enc, or h
//     scaled in place.  Writing h unscaled and scaling it in place costs one
//     more read and write of out (L2-resident at these sizes); recomputing
//     enc @ We would double the work that bounds the call.  (Scaling inside
//     the softmax block, row after row, took about 100 us at L = 100: each
//     row's loads waited on the previous row's stores.)
// The ragged batch edge needs no padding copy.  wgmma, TMA and 3xTF32 tensor
// core products are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTA = 64;   // columns of S per dec_proj block
constexpr int kWarp = 32;

// ---------------------------------------------------------------------------
// 1. S[B, A] = dec[B, Dd] @ Wd[Dd, A]; a block computes 16 rows x 64 columns
// (4 rows a thread: 4 rows a block, 256 blocks at B = 128, was slower).
constexpr int kSRows = 16;
constexpr int kTK = 128;  // depth of one dec / Wd slice

__global__ void __launch_bounds__(kThreads)
dec_proj_kernel(const float* __restrict__ dec, const float* __restrict__ wd,
                float* __restrict__ s, int B, int Dd, int A) {
  __shared__ float dec_s[kSRows][kTK + 1];
  __shared__ float wd_s[kTK][kTA];
  const int tid = threadIdx.x;
  const int c = tid % kTA, g = tid / kTA;  // column, row group (4 rows each)
  const int r0 = blockIdx.y * kSRows, a0 = blockIdx.x * kTA;
  float acc[4] = {};
  for (int k0 = 0; k0 < Dd; k0 += kTK) {
    __syncthreads();
    // Fixed trip counts, unrolled: the slice's 40 loads a thread are issued
    // together, not one L2 round trip after another.
#pragma unroll
    for (int j = 0; j < kSRows * kTK / kThreads; ++j) {
      const int i = tid + j * kThreads, r = i / kTK, k = i % kTK;
      dec_s[r][k] = (r0 + r < B && k0 + k < Dd) ? dec[(long long)(r0 + r) * Dd + k0 + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kTK * kTA / kThreads; ++j) {
      const int i = tid + j * kThreads, k = i / kTA, a = i % kTA;
      wd_s[k][a] = (k0 + k < Dd && a0 + a < A) ? wd[(long long)(k0 + k) * A + a0 + a] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      const float w = wd_s[k][c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(dec_s[g * 4 + i][k], w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g * 4 + i;
    if (r < B && a0 + c < A) s[(long long)r * A + a0 + c] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// 2. Partial energies of TL = 16 * RPT rows of h by TA = 16 * CPT columns of A.
// The rows are the B·L rows of enc taken as one [B·L, De] matrix, so a tile
// may span batch rows and carries no padding.  Each thread keeps RPT rows x
// CPT columns of h: rows ty + 16 i, columns 64 q + 4 tx + c (so that a warp's
// float4 reads of a We row are consecutive); slices are TK deep; MINB is the
// launch bound's blocks per SM.
template <int RPT, int CPT, int TK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
energy_kernel(const float* __restrict__ enc, const float* __restrict__ we,
              const float* __restrict__ s, const float* __restrict__ v,
              float* __restrict__ e_part, float* __restrict__ out,
              int B, int L, int De, int A, int projected) {
  constexpr int TL = 16 * RPT;
  constexpr int TA = 16 * CPT;
  constexpr int Q = CPT / 4;    // float4 column groups per thread
  constexpr int kLdx = TK + 4;  // enc slice row stride: float4-aligned, rows in distinct banks
  constexpr int kEncPer = TL * TK / kThreads;  // enc slice values per thread
  constexpr int kWePer = TK * TA / kThreads;   // We slice values per thread
  __shared__ __align__(16) float we_s[TK * TA];
  __shared__ __align__(16) float enc_s[TL * kLdx];
  __shared__ float v_s[TA];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nA = (A + TA - 1) / TA;
  const long long M = (long long)B * L;
  const long long m0 = (long long)(blockIdx.x / nA) * TL;
  const int ia = blockIdx.x % nA, a0 = ia * TA;

  for (int a = tid; a < TA; a += kThreads) v_s[a] = a0 + a < A ? v[a0 + a] : 0.f;

  float enc_pre[kEncPer], we_pre[kWePer];
  // Loads the slice at depth k0 into the prefetch registers.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kEncPer; ++j) {
      const int i = tid + j * kThreads, r = i / TK, k = i % TK;
      const long long m = m0 + r;
      enc_pre[j] = (m < M && k0 + k < De) ? enc[m * De + k0 + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kWePer; ++j) {
      const int i = tid + j * kThreads, k = i / TA, a = i % TA;
      we_pre[j] = (k0 + k < De && a0 + a < A) ? __ldg(we + (long long)(k0 + k) * A + a0 + a)
                                               : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < kEncPer; ++j) {
      const int i = tid + j * kThreads;
      enc_s[(i / TK) * kLdx + i % TK] = enc_pre[j];
    }
#pragma unroll
    for (int j = 0; j < kWePer; ++j) we_s[tid + j * kThreads] = we_pre[j];
  };

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int nK = (De + TK - 1) / TK;
  fetch(0);
  for (int ik = 0; ik < nK; ++ik) {
    __syncthreads();  // the previous slice is consumed
    stash();
    __syncthreads();
    if (ik + 1 < nK) fetch((ik + 1) * TK);  // in flight during this slice's arithmetic
    const float4* we4 = reinterpret_cast<const float4*>(we_s);
#pragma unroll 2
    for (int k = 0; k < TK; k += 4) {
      float4 w[Q][4];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[q][j] = we4[(k + j) * (TA / 4) + q * 16 + tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(enc_s + (ty + 16 * i) * kLdx + k);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float* a = acc[i] + 4 * q;
          a[0] = fmaf(x.w, w[q][3].x, fmaf(x.z, w[q][2].x, fmaf(x.y, w[q][1].x, fmaf(x.x, w[q][0].x, a[0]))));
          a[1] = fmaf(x.w, w[q][3].y, fmaf(x.z, w[q][2].y, fmaf(x.y, w[q][1].y, fmaf(x.x, w[q][0].y, a[1]))));
          a[2] = fmaf(x.w, w[q][3].z, fmaf(x.z, w[q][2].z, fmaf(x.y, w[q][1].z, fmaf(x.x, w[q][0].z, a[2]))));
          a[3] = fmaf(x.w, w[q][3].w, fmaf(x.z, w[q][2].w, fmaf(x.y, w[q][1].w, fmaf(x.x, w[q][0].w, a[3]))));
        }
      }
    }
  }

  // Fold the tile through tanh and v; keep h for "projected".
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long m = m0 + ty + 16 * i;
    const long long b = m / L;
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int a = 64 * q + 4 * tx + c;
        if (m < M && a0 + a < A) {
          part = fmaf(v_s[a], tanhf(acc[i][4 * q + c] + __ldg(s + b * A + a0 + a)), part);
          if (projected) out[m * A + a0 + a] = acc[i][4 * q + c];
        }
      }
    // The 16 threads of a row are 16 consecutive lanes of one warp.
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && m < M) e_part[(b * nA + ia) * L + (m - b * L)] = part;
  }
}

// ---------------------------------------------------------------------------
// 3. Softmax over L and scaling, one block per batch row.
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
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / kWarp; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Dynamic shared memory: energy [L] | reduction [kThreads / 32] floats.
// ops/cuda/additive_attention.py::_smem_bytes computes the same size.
__global__ void __launch_bounds__(kThreads)
softmax_kernel(const float* __restrict__ e_part, const float* __restrict__ vb,
               float* __restrict__ alpha, int L, int nA) {
  extern __shared__ float smem[];
  float* e_s = smem;
  float* red_s = e_s + L;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float bias = vb[0];

  float m = -INFINITY;
  for (int l = tid; l < L; l += kThreads) {
    float e = 0.f;
    for (int ia = 0; ia < nA; ++ia) e += e_part[(row * nA + ia) * L + l];
    e += bias;
    e_s[l] = e;
    m = fmaxf(m, e);
  }
  m = block_reduce(m, red_s, true);
  float sum = 0.f;
  for (int l = tid; l < L; l += kThreads) {
    const float ex = expf(e_s[l] - m);
    e_s[l] = ex;
    sum += ex;
  }
  sum = block_reduce(sum, red_s, false);
  for (int l = tid; l < L; l += kThreads) alpha[row * L + l] = e_s[l] / sum;
}

// 4. out[b, l, :] = alpha[b, l] * (enc[b, l, :] or h[b, l, :] in place), one
// block per (b, l): the loads of a block are independent of each other.
constexpr int kScaleThreads = 128;

__global__ void __launch_bounds__(kScaleThreads)
scale_kernel(const float* __restrict__ enc, const float* __restrict__ alpha, float* out,
             int Dw, int projected) {
  const long long bl = blockIdx.x;
  const float p = alpha[bl];
  float* o = out + bl * Dw;
  const float* x = projected ? o : enc + bl * Dw;
#pragma unroll 4
  for (int c = threadIdx.x; c < Dw; c += kScaleThreads) o[c] = p * x[c];
}

// Launches the energy kernel over ceil(B·L / (16 RPT)) x ceil(A / (16 CPT)) blocks.
template <int RPT, int CPT, int TK, int MINB>
void launch_energy(const float* enc, const float* we, const float* s, const float* v,
                   float* e_part, float* out, int B, int L, int De, int A, int projected,
                   cudaStream_t stream) {
  const long long row_tiles = ((long long)B * L + 16 * RPT - 1) / (16 * RPT);
  const int blocks = (int)(row_tiles * ((A + 16 * CPT - 1) / (16 * CPT)));
  energy_kernel<RPT, CPT, TK, MINB><<<blocks, kThreads, 0, stream>>>(
      enc, we, s, v, e_part, out, B, L, De, A, projected);
}

}  // namespace

// Launches the four kernels on `stream`: S = dec @ Wd into `s` [B, A], the
// partial energies into `e_part` [B, ceil(A / (16 * cols_per_thread)), L]
// with register tiles of rows_per_thread x cols_per_thread, the softmax with
// `smem_bytes` of dynamic shared memory, and the scaling.  Returns the first
// cudaGetLastError() that is not 0, cudaErrorInvalidValue for a tile this
// file does not build, else 0.  The caller has checked shapes, dtypes,
// devices, contiguity and the shared-memory size, and allocated the scratch.
extern "C" int v2t_fused_additive_attention_f32(
    const void* enc, const void* dec, const void* we, const void* wd, const void* v,
    const void* vb, void* out, void* alpha, void* s, void* e_part, int B, int L, int De,
    int Dd, int A, int projected, int rows_per_thread, int cols_per_thread, int smem_bytes,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dec_proj_kernel<<<dim3((A + kTA - 1) / kTA, (B + kSRows - 1) / kSRows), kThreads, 0, st>>>(
      (const float*)dec, (const float*)wd, (float*)s, B, Dd, A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float *e = (const float*)enc, *w = (const float*)we, *sp = (const float*)s,
              *vv = (const float*)v;
  float *ep = (float*)e_part, *o = (float*)out;
  const int tile = rows_per_thread * 100 + cols_per_thread;
  switch (tile) {
    // The fastest of the variants timed at the Demand shapes (PERF.md).
    case 104: launch_energy<1, 4, 32, 4>(e, w, sp, vv, ep, o, B, L, De, A, projected, st); break;
    case 808: launch_energy<8, 8, 16, 1>(e, w, sp, vv, ep, o, B, L, De, A, projected, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(softmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int nA = (A + 16 * cols_per_thread - 1) / (16 * cols_per_thread);
  softmax_kernel<<<B, kThreads, smem_bytes, st>>>(ep, (const float*)vb, (float*)alpha, L, nA);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scale_kernel<<<B * L, kScaleThreads, 0, st>>>(e, (const float*)alpha, o,
                                                 projected ? A : De, projected);
  return (int)cudaGetLastError();
}
