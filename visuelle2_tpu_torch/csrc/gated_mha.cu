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
// The design.  Every part of the function but the output product splits by
// head: q_h, k_h and v_h are column slices of the projections, the "head"
// gate needs only q_h, the "pure" gate of head h is the matching column
// slice of query·Wg + bg, and y = Σ_h merged_h · Wo[h·d:(h+1)·d, :] + bo.
// So one batch row is one thread-block cluster (cudaLaunchKernelEx with a
// cluster dimension), one CTA per group of `hpc` heads (one head where there
// are at most 8, the portable cluster size).  A CTA projects its columns of
// q, k and v (and of the pure gate), runs the attention of its heads and
// gates the context.  After a cluster barrier it multiplies the gated
// context by its rows of Wo and pushes each column slice of that partial y
// into the shared memory of the CTA that owns the slice, one slot per rank
// (distributed shared memory, `cluster.map_shared_rank`); after a second
// barrier each CTA sums its slots in rank order, adds bo and stores its
// slice.  No atomics: the same bits every call.  At the main path's shapes
// that is 512 CTAs of 160 and 128 threads, all resident at once (five an
// SM: 43 KB of shared memory and at most 80 registers a thread), in place
// of 128 blocks of one batch row each.
//
// Every product (projections, scores, probabilities x v, gate, output) is
// one routine, `tile`: a thread computes a 4 x 4 micro-tile, summing over k
// in order in float32 FMAs.  In the staged layout (the main path) the row's
// inputs, the CTA's weight slices and biases and every intermediate live in
// shared memory, copied in by cp.async, with rows padded to 16 bytes and
// zeros past each product's depth, so each step over four k loads four
// float4 of A and four of B for 64 FMAs; a 4-row spread of an A operand's
// stride puts the rows a warp reads at once in distinct banks.  The keys
// are stored transposed, so the scores are such a product too.  A query
// block's mask rows are copied into its probabilities' rows, to which the
// scores add; the softmax takes a few lanes a row (shuffles for its max and
// sum) and leaves exp(s - max) and 1 / the row sum, which the context takes
// on.  The projections of
// query, key and value and of the pure gate run as one pass; a tensor
// passed twice (query is key in the trend encoder, key is value in the
// decoder) is staged once; the rows of Wo arrive while the attention runs.
// Shapes whose staged layout would not fit in 227 KB take the unstaged
// layout: inputs, weights and biases read where they lie in device memory,
// scalar loads, no padding; queries run in blocks of `qb` rows when all
// their probabilities would not fit.  ops/cuda/gated_mha.py::launch_plan
// picks the layout, the cluster, the threads and every offset; its Plan is
// this file's struct, field by field.
//
// What bounds it after the redesign (perf/gated_split.py on an H100 SXM at
// 700 W): not the card's float32 rate but each CTA's chain of dependent
// phases -- staging, projections, mask and gate, scores, softmax, context,
// two cluster barriers, output product, sum -- at a few warps a CTA.  At
// B = 8, one CTA an SM and the card otherwise idle, the "head" call takes
// 21 us of its 36 at B = 128 (the "pure" call 14 of 23); taking out any one
// phase saves at most 13 of the 36.  Each product's 4 x 4 tile reads 32 bytes of
// shared memory for 16 FMAs, so the products are bound by shared-memory
// loads, not by FMAs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
// Five CTAs of up to 160 threads an SM: at most 80 registers a thread.
constexpr int kMaxThreads = 160, kMinBlocks = 5;

// ops/cuda/gated_mha.py::PLAN_FIELDS, in this order.  Offsets and strides
// count floats of dynamic shared memory.
struct Plan {
  int ncta;            // CTAs of a cluster: one batch row
  int hpc;             // heads per CTA
  int width;           // columns per CTA: hpc * d
  int d;               // head width
  int qb;              // query rows per attention block
  int kd, kk, kw, kx;  // product depths: d, Lk, width, D (padded to 4 when staged)
  int q, ldq, qhs;     // projected queries [hpc][Lq][ldq]
  int kt, ldkt, khs;   // projected keys, transposed [hpc][kd][ldkt]
  int v, ldv, vhs;     // projected values [hpc][kk][ldv]
  int p, ldp, phs;     // mask, scores, exp(score - row max) of a query block [hpc][qb][ldp]
  int ri;              // 1 / the row sums of p [hpc][qb]
  int bias;            // staged biases: bq | bk | bv | bo | bg, each padded to 4
  int m, ldm;          // the gate, then the gated context [Lq][ldm]
  int y, ldy;          // the cluster's partial outputs of this CTA's columns [ncta][Lq][ldy]
  int zero_begin, zero_end;  // zeroed before the products: padding
  int xq, xk, xv, ldx;       // staged inputs [rows][ldx]
  int wq, wk, wv, ldw;       // staged weight column slices [kx][ldw]
  int wg, ldg;               // staged gate weight: head [kd][ldg], pure slice [kx][ldg]
  int wo, ldo;               // staged rows of Wo [kw][ldo]
  int stage_k, stage_v;      // key staged apart from query, value apart from key
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// dst[r][c] (row stride ldd, a multiple of 4) = src[r * lds + c] for r < rows,
// c < cols, and 0 elsewhere in rows_pad x ldd: the padding a product reads
// past its depth is zero.  A thread keeps one column of 4 and steps over
// rows; 16-byte copies where the source allows them.
template <bool kVec>
__device__ __forceinline__ void stage_rows(float* dst, int ldd, int rows_pad, const float* src,
                                           int lds, int rows, int cols) {
  const int units = ldd / 4;
  const int first = units <= (int)blockDim.x ? threadIdx.x / units : 0;
  const int step = units <= (int)blockDim.x ? blockDim.x / units : 1;
  for (int cu = threadIdx.x - first * units; cu < units; cu += blockDim.x) {
    const int c = 4 * cu;
    for (int r = first; r < rows_pad && first < step; r += step) {
      float* dp = dst + r * ldd + c;
      const float* sp = src + (long long)r * lds + c;
      if constexpr (kVec) {
        const bool ok = r < rows && c < cols;
        cp_async16(dp, ok ? sp : src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = r < rows && c + e < cols;
          cp_async4(dp + e, ok ? sp + e : src, ok ? 4 : 0);
        }
      }
    }
    if (units <= (int)blockDim.x) break;
  }
}

__device__ __forceinline__ void stage(float* dst, int ldd, int rows_pad, const float* src,
                                      int lds, int rows, int cols) {
  if (((lds | cols) & 3) == 0 && ((uintptr_t)src & 15) == 0)
    stage_rows<true>(dst, ldd, rows_pad, src, lds, rows, cols);
  else
    stage_rows<false>(dst, ldd, rows_pad, src, lds, rows, cols);
}

// acc[i][j] += Σ_k A[r0 + i][k] · B[k][c0 + j] for a 4 x 4 micro-tile, k
// from 0 to K in order, one float32 FMA each.  A's rows are lda apart (rows
// past M read row M - 1), B's rows ldb apart.  kVec: A and B in shared
// memory, K a multiple of 4 with zeros past the product's depth in both,
// columns c0..c0+3 inside B's row: four float4 of A and four of B for 64
// FMAs.  Otherwise scalar loads from anywhere, columns past N reading
// column N - 1.
template <bool kVec>
__device__ __forceinline__ void tile(float (&acc)[4][4], const float* A, int lda, int r0, int M,
                                     const float* B, int ldb, int c0, int N, int K) {
  const float* a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = A + min(r0 + i, M - 1) * lda;
  if constexpr (kVec) {
    const float* b = B + c0;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a[i] + k);
#pragma unroll
      for (int t = 0; t < 4; ++t) bv[t] = *reinterpret_cast<const float4*>(b + (k + t) * ldb);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = comp(av[i], t);
          acc[i][0] = fmaf(x, bv[t].x, acc[i][0]);
          acc[i][1] = fmaf(x, bv[t].y, acc[i][1]);
          acc[i][2] = fmaf(x, bv[t].z, acc[i][2]);
          acc[i][3] = fmaf(x, bv[t].w, acc[i][3]);
        }
    }
  } else {
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = min(c0 + j, N - 1);
    for (int k = 0; k < K; ++k) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = B[(long long)k * ldb + c[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = a[i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) gated_mha_f32_kernel(
    const float* __restrict__ query, const float* __restrict__ key,
    const float* __restrict__ value, const float* __restrict__ mask,
    const float* __restrict__ w_q, const float* __restrict__ b_q,
    const float* __restrict__ w_k, const float* __restrict__ b_k,
    const float* __restrict__ w_v, const float* __restrict__ b_v,
    const float* __restrict__ w_g, const float* __restrict__ b_g,
    const float* __restrict__ w_o, const float* __restrict__ b_o,
    float* __restrict__ out, int Lq, int Lk, int D, float scale, int head_gate,
    const Plan p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long row = blockIdx.x / p.ncta;
  const int W = p.width, d = p.d, c0 = rank * W;
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp, warps = T / kWarp;
  const float* xq = query + row * Lq * D;
  const float* xk = key + row * Lk * D;
  const float* xv = value + row * Lk * D;

  // The products' operands and the biases: staged in shared memory, or
  // where they lie.
  const float *aq = xq, *ak = xk, *av = xv;
  const float *bq = w_q + c0, *bk = w_k + c0, *bv = w_v + c0;
  const float* bg = head_gate ? w_g : w_g + c0;
  const float* bo = w_o + (long long)c0 * D;
  const float *cq = b_q + c0, *ck = b_k + c0, *cv = b_v + c0, *co = b_o + c0;
  const float* cg_ = head_gate ? b_g : b_g + c0;
  int lda = D, ldw = D, ldg = head_gate ? d : D, ldo = D;
  if constexpr (kStaged) {
    float4* z = reinterpret_cast<float4*>(smem + p.zero_begin);
    for (int i = tid; i < (p.zero_end - p.zero_begin) / 4; i += T)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int w4 = (W + 3) / 4 * 4, gw = head_gate ? d : W;
    float* bias = smem + p.bias;  // bq | bk | bv | bo | bg, each 16-byte aligned
    stage(bias, w4, 1, cq, 0, 1, W);
    stage(bias + w4, w4, 1, ck, 0, 1, W);
    stage(bias + 2 * w4, w4, 1, cv, 0, 1, W);
    stage(bias + 3 * w4, w4, 1, co, 0, 1, W);
    stage(bias + 4 * w4, (gw + 3) / 4 * 4, 1, cg_, 0, 1, gw);
    stage(smem + p.xq, p.ldx, Lq, xq, D, Lq, D);
    if (p.stage_k) stage(smem + p.xk, p.ldx, Lk, xk, D, Lk, D);
    if (p.stage_v) stage(smem + p.xv, p.ldx, Lk, xv, D, Lk, D);
    stage(smem + p.wq, p.ldw, p.kx, bq, D, D, W);
    stage(smem + p.wk, p.ldw, p.kx, bk, D, D, W);
    stage(smem + p.wv, p.ldw, p.kx, bv, D, D, W);
    if (head_gate) stage(smem + p.wg, p.ldg, p.kd, bg, d, d, d);
    else stage(smem + p.wg, p.ldg, p.kx, bg, D, D, W);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    aq = smem + p.xq, ak = smem + p.xk, av = smem + p.xv;
    bq = smem + p.wq, bk = smem + p.wk, bv = smem + p.wv, bg = smem + p.wg, bo = smem + p.wo;
    cq = bias, ck = bias + w4, cv = bias + 2 * w4, co = bias + 3 * w4, cg_ = bias + 4 * w4;
    lda = p.ldx, ldw = p.ldw, ldg = p.ldg, ldo = p.ldo;
    __syncthreads();
  }

  // Projections: this CTA's columns of q, k (stored transposed), v and, for
  // the pure gate, σ(query·Wg + bg) into merged, in one pass over their
  // micro-tiles.
  {
    const int ntc = (W + 3) / 4;
    const int tq = (Lq + 3) / 4 * ntc, tk = (Lk + 3) / 4 * ntc;
    const int total = tq + 2 * tk + (head_gate ? 0 : tq);
    for (int t = tid; t < total; t += T) {
      int job = 0, u = t;
      if (u >= tq) {
        u -= tq, job = 1;
        if (u >= tk) {
          u -= tk, job = 2;
          if (u >= tk) u -= tk, job = 3;
        }
      }
      const int rt = u / ntc, r0 = 4 * rt, cc = 4 * (u - rt * ntc);
      const bool on_q = job == 0 || job == 3;
      const int M = on_q ? Lq : Lk;
      const float* A = on_q ? aq : job == 1 ? ak : av;
      const float* Bw = job == 0 ? bq : job == 1 ? bk : job == 2 ? bv : bg;
      const float* bias = job == 0 ? cq : job == 1 ? ck : job == 2 ? cv : cg_;
      float acc[4][4] = {};
      tile<kStaged>(acc, A, lda, r0, M, Bw, job == 3 ? ldg : ldw, cc, W, p.kx);
      // Where the tile goes: head h's column e of row r at base + h·hs +
      // r·rs + e·es (k transposed); the pure gate through σ.
      const int base = job == 0 ? p.q : job == 1 ? p.kt : job == 2 ? p.v : p.m;
      const int rs = job == 0 ? p.ldq : job == 1 ? 1 : job == 2 ? p.ldv : p.ldm;
      const int es = job == 1 ? p.ldkt : 1;
      const int hs = job == 0 ? p.qhs : job == 1 ? p.khs : job == 2 ? p.vhs : d;
      int h = cc / d, e = cc - h * d;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cc + j < W) {
          const float bj = bias[cc + j];
          float* dst = smem + base + h * hs + e * es;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float val = acc[i][j] + bj;
            if (r0 + i < M) dst[(r0 + i) * rs] = job == 3 ? sigmoidf(val) : val;
          }
        }
        if (++e == d) e = 0, ++h;
      }
    }
  }
  __syncthreads();
  // A query block's mask rows into each head's P, where the scores add to
  // them.  The first block's, then the rows of Wo, go over the staged
  // operands the projections are done with, and arrive while the attention
  // runs.
  auto copy_mask = [&](int i0, int rows) {
    if constexpr (kStaged) {
      for (int h = 0; h < p.hpc; ++h)
        stage(smem + p.p + h * p.phs, p.ldp, rows, mask + i0 * Lk, Lk, rows, Lk);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int i = tid; i < p.hpc * rows * Lk; i += T) {
        const int h = i / (rows * Lk), e = i - h * rows * Lk;
        smem[p.p + h * p.phs + e / Lk * p.ldp + e % Lk] = __ldg(mask + i0 * Lk + e);
      }
    }
  };
  if constexpr (kStaged) {
    copy_mask(0, min(p.qb, Lq));
    stage(smem + p.wo, p.ldo, p.kw, w_o + (long long)c0 * D, D, W, D);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Attention, a block of qb query rows at a time.  A softmax row is lpr
  // lanes (up to 8 keys a lane), so a warp takes 32 / lpr rows at once.
  const int ntk = (Lk + 3) / 4, ntd = (d + 3) / 4;
  int lpr = 1;
  while (lpr < kWarp && 8 * lpr < Lk) lpr <<= 1;
  for (int i0 = 0; i0 < Lq; i0 += p.qb) {
    const int rows = min(p.qb, Lq - i0), nrt = (rows + 3) / 4;
    if (!kStaged || i0 > 0) copy_mask(i0, rows);
    // Meanwhile the head gate, σ(q_h·Wg + bg), into merged.
    const int per_g = head_gate ? nrt * ntd : 0;
    for (int t = tid; t < p.hpc * per_g; t += T) {
      const int h = t / per_g, u = t - h * per_g, rt = u / ntd, cc = 4 * (u - rt * ntd);
      float acc[4][4] = {};
      tile<kStaged>(acc, smem + p.q + h * p.qhs + i0 * p.ldq, p.ldq, 4 * rt, rows, bg, ldg,
                    cc, d, p.kd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = i0 + 4 * rt + i, e = cc + j;
          if (r < i0 + rows && e < d)
            smem[p.m + r * p.ldm + h * d + e] = sigmoidf(acc[i][j] + cg_[e]);
        }
    }
    if constexpr (kStaged) {
      if (i0 == 0) asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // Wo may still come
      else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    // Scores: P = q_h·k_hᵀ·d^-½ + P.
    const int per_s = nrt * ntk;
    for (int t = tid; t < p.hpc * per_s; t += T) {
      const int h = t / per_s, u = t - h * per_s, rt = u / ntk, cc = 4 * (u - rt * ntk);
      float acc[4][4] = {};
      tile<kStaged>(acc, smem + p.q + h * p.qhs + i0 * p.ldq, p.ldq, 4 * rt, rows,
                    smem + p.kt + h * p.khs, p.ldkt, cc, Lk, p.kd);
      float* pr = smem + p.p + h * p.phs;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rt + i;
        if (r >= rows) continue;
        float* dst = pr + r * p.ldp + cc;
        if (kStaged && cc + 3 < Lk) {
          const float4 mk = *reinterpret_cast<const float4*>(dst);
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0] * scale + mk.x, acc[i][1] * scale + mk.y,
                          acc[i][2] * scale + mk.z, acc[i][3] * scale + mk.w);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (cc + j < Lk) dst[j] = acc[i][j] * scale + dst[j];
        }
      }
    }
    __syncthreads();
    // Softmax: P = exp(P - row max), zero past Lk (where P·V reads to its
    // depth), and 1 / the row sum, which the context takes on.  Each lane's
    // keys are loaded together, then exponentiated together.
    for (int t0 = warp * (kWarp / lpr); t0 < p.hpc * rows; t0 += warps * (kWarp / lpr)) {
      const int t = min(t0 + lane / lpr, p.hpc * rows - 1), sub = lane % lpr;
      const bool mine = t0 + lane / lpr < p.hpc * rows;
      const int h = t / rows;
      float* pr = smem + p.p + h * p.phs + (t - h * rows) * p.ldp;
      float mx = -INFINITY;
      for (int j0 = 0; j0 < Lk; j0 += 8 * lpr) {
        float x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + sub + q * lpr;
          x[q] = j < Lk ? pr[j] : -INFINITY;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) mx = fmaxf(mx, x[q]);
      }
      for (int off = lpr / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j0 = 0; j0 < p.kk; j0 += 8 * lpr) {
        float x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + sub + q * lpr;
          x[q] = j < Lk ? expf(pr[j] - mx) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + sub + q * lpr;
          if (mine && j < p.kk) pr[j] = x[q];
          sum += x[q];
        }
      }
      for (int off = lpr / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (mine && sub == 0) smem[p.ri + t] = 1.f / sum;
    }
    __syncthreads();
    // Context P·v_h / the row sum, times the gate in merged.
    const int per_c = nrt * ntd;
    for (int t = tid; t < p.hpc * per_c; t += T) {
      const int h = t / per_c, u = t - h * per_c, rt = u / ntd, cc = 4 * (u - rt * ntd);
      float acc[4][4] = {};
      tile<kStaged>(acc, smem + p.p + h * p.phs, p.ldp, 4 * rt, rows, smem + p.v + h * p.vhs,
                    p.ldv, cc, d, p.kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rt + i;
        if (r >= rows) continue;
        const float inv = smem[p.ri + h * rows + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = cc + j;
          if (e >= d) continue;
          float* m = smem + p.m + (i0 + r) * p.ldm + h * d + e;
          *m = acc[i][j] * inv * *m;
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kStaged) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // Every CTA of the cluster is done with its attention: y may now lie over
  // what it used.
  cluster.sync();

  // This CTA's partial output, merged · Wo[c0:c0 + W, :], each column slice
  // pushed into the shared memory of the CTA that owns it, into this CTA's
  // slot there: y [ncta][Lq][W].
  {
    const int nto = (D + 3) / 4, total = (Lq + 3) / 4 * nto;
    const bool vec = (W & 3) == 0;
    for (int t = tid; t < total; t += T) {
      const int rt = t / nto, cc = 4 * (t - rt * nto);
      float acc[4][4] = {};
      tile<kStaged>(acc, smem + p.m, p.ldm, 4 * rt, Lq, bo, ldo, cc, D, p.kw);
      const int owner = cc / W;
      float* slot = cluster.map_shared_rank(smem + p.y + rank * Lq * p.ldy + cc - owner * W,
                                            owner);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rt + i;
        if (r >= Lq) continue;
        if (vec && cc + 3 < D) {
          *reinterpret_cast<float4*>(slot + r * p.ldy) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = cc + j, owner = c / W;
            if (c < D)
              *cluster.map_shared_rank(smem + p.y + (rank * Lq + r) * p.ldy + c - owner * W,
                                       owner) = acc[i][j];
          }
        }
      }
    }
  }
  cluster.sync();  // the pushes are in place
  // This CTA's columns of y: the slots summed in rank order, then bo; four
  // columns at a time where W allows.
  if ((W & 3) == 0 && (D & 3) == 0) {
    const int w4 = W / 4;
    for (int i = tid; i < Lq * w4; i += T) {
      const int r = i / w4, cl = 4 * (i - r * w4);
      float4 s = *reinterpret_cast<const float4*>(smem + p.y + r * p.ldy + cl);
      for (int q = 1; q < p.ncta; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(smem + p.y + (q * Lq + r) * p.ldy + cl);
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      *reinterpret_cast<float4*>(out + (row * Lq + r) * D + c0 + cl) =
          make_float4(s.x + co[cl], s.y + co[cl + 1], s.z + co[cl + 2], s.w + co[cl + 3]);
    }
  } else {
    for (int i = tid; i < Lq * W; i += T) {
      const int r = i / W, cl = i - r * W;
      float s = smem[p.y + r * p.ldy + cl];
      for (int q = 1; q < p.ncta; ++q) s += smem[p.y + (q * Lq + r) * p.ldy + cl];
      out[(row * Lq + r) * D + c0 + cl] = s + co[cl];
    }
  }
}

}  // namespace

// Launches one cluster of plan[0] CTAs of `threads` threads per batch row on
// `stream`, with `smem_bytes` of dynamic shared memory; `plan` holds the
// Plan's fields in order (`plan_len` of them), `staged` picks the layout;
// `scale` is d^-1/2, rounded to float32 by the caller as the JAX package
// rounds it.  Returns a CUDA error code (0 on success).  The caller has
// checked shapes, dtypes, devices, contiguity and the plan.
extern "C" int v2t_fused_gated_mha_f32(
    const void* query, const void* key, const void* value, const void* mask,
    const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* wg, const void* bg,
    const void* wo, const void* bo, void* out, int B, int Lq, int Lk, int D,
    float scale, int head_gate, const int* plan, int plan_len, int staged, int threads,
    int smem_bytes, void* stream) {
  Plan p;
  if (plan_len != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&p, plan, sizeof(Plan));
  auto kernel = staged ? gated_mha_f32_kernel<true> : gated_mha_f32_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.ncta;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * p.ncta);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = (cudaStream_t)stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, (const float*)query, (const float*)key, (const float*)value,
      (const float*)mask, (const float*)wq, (const float*)bq, (const float*)wk,
      (const float*)bk, (const float*)wv, (const float*)bv, (const float*)wg,
      (const float*)bg, (const float*)wo, (const float*)bo, (float*)out, Lq, Lk, D, scale,
      head_gate, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
