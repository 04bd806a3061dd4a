// The w8a8 backbone's convolution for Hopper (sm_90a): an implicit GEMM over
// int8 NHWC activations, int32 sums on wgmma, with the requantize epilogue fused.
//
// It replaces no pl.pallas_call: the JAX engine's convolutions are XLA
// (visuelle2_tpu/models/quantized_resnet.py:86, `_conv(..., jnp.int32)`),
// which fuses the epilogue of :204-213 and the identity shortcut's rescale
// (:238-240) into each conv, and stock PyTorch has no CUDA int8 convolution.
// ops/cuda/int8_conv.py is the wrapper and holds the plain version.
//
// The GEMM: M = N·Ho·Wo output pixels, N = Cout, K = kh·kw·Cin in (ky, kx, c)
// order.  The weight is packed once ([Cout][K_pad], K_pad a multiple of 32,
// zeros past K).  Both operands are K-major, as wgmma's 8-bit forms require,
// so neither is transposed.
//
// What bounds it (ops/cuda/roofline.py::int8_conv_cost, at B = 128): the 3x3
// convs and the 1x1s of layers 3 and 4 by the int8 tensor cores' operations,
// which only wgmma reaches at full rate; the 1x1s of layer 1, the stem and the
// conv3s that read a shortcut by bytes, so the shortcut is read as its int8
// codes and the stem's input as whole 4-byte taps.
//
// The design is Hopper's own, the shape of probe_gemm_bf16.cu.  A persistent
// grid, one block per SM, walks over output tiles, the column tiles of one
// row tile side by side so that its activation rows are read from L2 once.
// Each block has three warpgroups.  The first, the producer, fills a ring
// of stages (a 128-byte K chunk of the tile's A rows and B columns, in the
// 128-byte swizzle that the wgmma descriptor names) guarded by full and
// empty mbarriers.  The other two, the consumers, issue
// wgmma.mma_async m64nBNk32 .s32.s8.s8 straight from shared memory, one
// chunk's products in flight as they free the stage before, then run the
// epilogue; setmaxnreg moves registers from the producer to them.  The
// last chunk issues only the k-steps that K_pad holds (K = 64: two of four).
// The wrapper's launch_plan picks BN (64, 128 or 256) and how the
// consumers share the tiles:
//   cooperative  both take 64 rows of each 128 x BN tile and read the same
//                B stages, which halves the weights' traffic from L2 (the
//                3x3 convs are bound by it: B is read again for each row
//                tile);
//   ping-pong    (the 3x3 convs and the stem at Cout = 64) each takes its
//                own 256 x 64 tile in turns, one's epilogue beside the
//                other's products; two named barriers keep the turns'
//                products in order, so that a consumer never waits on a
//                stage a lap ahead (a barrier's parity tells one lap).
//
// What still bounds it (perf/int8_split.py, on an H100): on the identity
// conv3s the epilogue (removing it takes about 70% off their time), on the
// 3x3 convs the products and the ring, on the stem its gathers and epilogue.
//
// The producer fills the ring in one of three modes:
//   TMA       the 1x1 stride-1 convs, whose A is the plain [N·H·W, Cin]
//             matrix: one thread asks the Tensor Memory Accelerator for A's
//             and B's tiles; TMA zero-fills rows past M and K past K_pad.
//   gather16  the 3x3 and strided convs (Cin a multiple of 16): B by TMA,
//             A gathered by the 128 producer threads with 16-byte cp.async,
//             each piece 16 channels of one input pixel (zero-filled in the
//             padding and past K), stored into the swizzled layout; each
//             thread's cp.async.mbarrier.arrive lands on the stage's full
//             barrier when its copies have, and the consumers issue
//             fence.proxy.async before their wgmma (async proxy) reads what
//             the copies (generic proxy) wrote.
//   gather4   the stem, whose input the caller pads from 3 to 4 channels (a
//             zero channel, packed with zero weights: the sums do not
//             change): each tap's channels are then one 4-byte cp.async,
//             and each (output pixel, ky) row of K 28 contiguous bytes; a
//             table of taps in shared memory, built once, spares the
//             threads the index arithmetic of each piece.
//
// The epilogue, per output channel, from the accumulator fragment:
//   0  int8  = clamp(rint(acc·m + z), 0, 127)
//   1  int8  = clamp(rint((acc·m + z) + addend), 0, 127)   (conv3 + float shortcut)
//   2  float = acc·m + z                                    (the downsample conv)
//   3  int8  = clamp(rint((acc·m + z) + sc·ratio), 0, 127)  (conv3 + identity shortcut,
//            sc the block input's int8 codes, ratio a float32 scalar on the device)
// in float32, each product and sum rounded on its own (__fmul_rn, __fadd_rn:
// nvcc cannot contract them into an FMA), in the JAX engine's order, rint
// halving to even.  int32 sums are exact in any order (|acc| <= 127² · 4,608
// < 2^31).  The conversions run on the full-rate float pipe: acc and sc
// become float32 by the 1.5 · 2^23 offset (exact: acc when 128² · K_pad <=
// 2^22, else __int2float_rn), and the clamped f is rounded by adding that
// offset.  So the codes are bit-equal to the plain version's.  The int8
// codes of a row's four neighbouring fragments are gathered into one lane by
// a transpose within each quad of lanes, so a warp stores (and reads the
// identity shortcut as) 32 contiguous bytes of each of its rows at once; the
// shortcut's loads are issued before the tile's products.

#include "hopper_tma.cuh"

#include <mutex>

namespace {

constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kChunk = 128;         // bytes of K a stage holds per row
constexpr int kMaxStages = 10;
constexpr int kSmemLimit = 232448;  // the most dynamic shared memory a block may use
constexpr int kMaxTable = 256;      // gather4's tap table: 8 chunks of 32 pieces
constexpr int kSmemFixed = 1024 + 256 + 8 * kMaxTable;  // alignment, barriers, table
constexpr int kMaxDevices = 64;
enum Mode { kTma = 0, kGather16 = 1, kGather4 = 2 };

// A tile's rows.  Cooperative, both consumers' 64 rows of one tile: 128 x
// BN, each stage's B read by both.  Ping-pong (BN = 64 only), a consumer's
// own tile: 256 x 64 in four wgmma row blocks (a 64 x 64 tile is too little
// work for the fixed cost of a turn).
__host__ __device__ constexpr int bm_of(bool coop) { return coop ? 128 : 256; }
// The ring's stages: as many as fit, up to kMaxStages.
__host__ __device__ constexpr int stages_of(int bn, bool coop) {
  return (kSmemLimit - kSmemFixed) / ((bm_of(coop) + bn) * kChunk) < kMaxStages
             ? (kSmemLimit - kSmemFixed) / ((bm_of(coop) + bn) * kChunk)
             : kMaxStages;
}

struct Params {
  const int8_t* x;
  const float* mul;
  const float* add;
  const float* addend;     // epilogue 1
  const int8_t* shortcut;  // epilogue 3
  const float* ratio;      // epilogue 3
  void* out;
  int M, H, W, Cin, Ho, Wo, Cout, kw, stride, pad, K, Kpad, epilogue;
  int stages, tiles_n, n_tiles, n_chunks;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
// The barrier sees one arrival of this thread once its cp.async copies so far
// have landed (the count at init includes it).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x N] (+)= A[64 x 32] · B[32 x N], int8 in, int32 sums: A and B
// K-major, 128-byte swizzled; `accumulate` = 0 starts the sums.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The ring's position: stage s, and the parity of its current phase.
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) { s = 0; phase ^= 1; }
  }
  __device__ __forceinline__ void skip(int n, int stages) {
    for (s += n; s >= stages; s -= stages) phase ^= 1;
  }
};

// The tile of one of the block's turns: row tiles of BM output pixels, the
// column tiles of one row tile side by side.
struct Tile {
  int mt, nt;
  __device__ __forceinline__ Tile(int tile, int tiles_n)
      : mt(tile / tiles_n), nt(tile - (tile / tiles_n) * tiles_n) {}
};

// Each gather thread's rows: base pixel offset and the top-left tap.
struct RowOrigin {
  int pix;        // the row's image in elements: n·H·W·Cin (x holds < 2^31)
  int iy0, ix0;   // iy0 far below 0 for a row past M: all padding
  __device__ __forceinline__ RowOrigin(const Params& p, int gm) {
    const int hw = p.Ho * p.Wo;
    const int n = gm / hw, rem = gm - n * hw, oy = rem / p.Wo, ox = rem - oy * p.Wo;
    pix = n * p.H * p.W * p.Cin;
    iy0 = gm < p.M ? oy * p.stride - p.pad : -(1 << 28);
    ix0 = ox * p.stride - p.pad;
  }
};

// gather16: thread t moves the 16-byte piece t % 8 of rows t / 8 + 16 i of
// each chunk: 16 channels of one input pixel.
template <int BN, int BM>
__device__ void produce_gather16(const CUtensorMap* b_map, const Params& p, uint32_t ring,
                                 uint32_t full0, uint32_t empty0) {
  constexpr int kRows = BM / 16;
  constexpr int kABytes = BM * kChunk, kStageBytes = kABytes + BN * kChunk;
  const int t = threadIdx.x, seg = t & 7, r0 = t >> 3;
  const uint32_t swz = r0 * kChunk + ((seg ^ (r0 & 7)) << 4);  // + 16 i rows: 2048 i
  Ring r;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const Tile tl(tile, p.tiles_n);
    int pix[kRows], iy0[kRows], ix0[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const RowOrigin o(p, tl.mt * BM + r0 + 16 * i);
      pix[i] = o.pix; iy0[i] = o.iy0; ix0[i] = o.ix0;
    }
    for (int kc = 0; kc < p.n_chunks; ++kc, r.next(p.stages)) {
      mbar_wait(empty0 + 8 * r.s, r.phase ^ 1);
      const uint32_t stage = ring + r.s * kStageBytes, full = full0 + 8 * r.s;
      if (t == 0) {
        mbar_arrive_expect_tx(full, BN * kChunk);
        tma_load_2d(b_map, stage + kABytes, full, kc * kChunk, tl.nt * BN);
      }
      const int k = kc * kChunk + seg * 16;
      const int tap = k / p.Cin, ch = k - tap * p.Cin;
      const int ky = tap / p.kw, kx = tap - ky * p.kw;
      const bool k_ok = k < p.K;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int iy = iy0[i] + ky, ix = ix0[i] + kx;
        const bool ok = k_ok && (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
        const int8_t* src = ok ? p.x + pix[i] + (iy * p.W + ix) * p.Cin + ch : p.x;
        cp_async16(stage + swz + 2048 * i, src, ok ? 16 : 0);
      }
      cp_async_arrive(full);
    }
  }
}

// gather4 (Cin a multiple of 4 below 16): thread t moves the 4-byte pieces
// 16 (t / 64) .. + 15 of rows t % 64 + 64 i of each chunk, whole channels of
// one tap each; a table in shared memory (built once) gives each piece of K
// its tap and its offset from the row's top-left tap.
template <int BN, int BM>
__device__ void produce_gather4(const CUtensorMap* b_map, const Params& p, uint32_t ring,
                                uint32_t full0, uint32_t empty0, int2* table) {
  constexpr int kRows = BM / 64;
  constexpr int kABytes = BM * kChunk, kStageBytes = kABytes + BN * kChunk;
  const int t = threadIdx.x, row = t & 63, half = t >> 6;
  for (int g = t; g < p.n_chunks * (kChunk / 4); g += 128) {
    const int k = 4 * g;
    const int tap = k / p.Cin, ch = k - tap * p.Cin, ky = tap / p.kw, kx = tap - ky * p.kw;
    table[g] = k < p.K ? make_int2((ky << 16) | kx, (ky * p.W + kx) * p.Cin + ch)
                       : make_int2(0x4000 << 16, 0);  // past K: a tap far below the image
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the producer warpgroup's own barrier
  Ring r;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const Tile tl(tile, p.tiles_n);
    int iy0[kRows], ix0[kRows];
    const int8_t* origin[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const RowOrigin o(p, tl.mt * BM + row + 64 * i);
      iy0[i] = o.iy0; ix0[i] = o.ix0;
      origin[i] = p.x + o.pix + ((long long)o.iy0 * p.W + o.ix0) * p.Cin;
    }
    for (int kc = 0; kc < p.n_chunks; ++kc, r.next(p.stages)) {
      mbar_wait(empty0 + 8 * r.s, r.phase ^ 1);
      const uint32_t stage = ring + r.s * kStageBytes, full = full0 + 8 * r.s;
      if (t == 0) {
        mbar_arrive_expect_tx(full, BN * kChunk);
        tma_load_2d(b_map, stage + kABytes, full, kc * kChunk, tl.nt * BN);
      }
      const int2* tab = table + kc * (kChunk / 4) + 16 * half;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int q = 16 * half + j;  // the piece: bytes 4 q .. 4 q + 3 of a row
        const int2 e = tab[j];
        const uint32_t dst = stage + row * kChunk + ((((q >> 2) ^ (row & 7))) << 4) + ((q & 3) << 2);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int iy = iy0[i] + (e.x >> 16), ix = ix0[i] + (e.x & 0xffff);
          const bool ok = (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
          cp_async4(dst + 64 * kChunk * i, ok ? origin[i] + e.y : p.x, ok ? 4 : 0);
        }
      }
      cp_async_arrive(full);
    }
  }
}

// TMA: one thread asks for A's and B's tiles of every chunk.
template <int BN, int BM>
__device__ void produce_tma(const CUtensorMap* a_map, const CUtensorMap* b_map,
                            const Params& p, uint32_t ring, uint32_t full0, uint32_t empty0) {
  constexpr int kABytes = BM * kChunk, kStageBytes = kABytes + BN * kChunk;
  Ring r;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const Tile tl(tile, p.tiles_n);
    for (int kc = 0; kc < p.n_chunks; ++kc, r.next(p.stages)) {
      mbar_wait(empty0 + 8 * r.s, r.phase ^ 1);
      const uint32_t stage = ring + r.s * kStageBytes, full = full0 + 8 * r.s;
      mbar_arrive_expect_tx(full, kStageBytes);
      tma_load_2d(a_map, stage, full, kc * kChunk, tl.mt * BM);
      tma_load_2d(b_map, stage + kABytes, full, kc * kChunk, tl.nt * BN);
    }
  }
}

// Exact conversions on the full-rate float pipe in place of the
// quarter-rate I2F and F2I: x + 1.5 · 2^23 holds the integer x in its low
// mantissa bits for |x| <= 2^22.
constexpr float kMagic = 12582912.0f;
constexpr uint32_t kMagicBits = 0x4B400000u;

// int32 -> float32, the bits of __int2float_rn when |v| <= 2^22.
__device__ __forceinline__ float small_i2f(int v) {
  return __fsub_rn(__int_as_float(static_cast<int>(kMagicBits) + v), kMagic);
}
// The int8 in byte `B` of w -> float32 (offset binary: b ^ 0x80 in 0..255).
template <int B>
__device__ __forceinline__ float byte_i2f(uint32_t w) {
  return __fsub_rn(__uint_as_float(((w >> (8 * B)) & 0xffu) ^ (kMagicBits | 0x80u)),
                   kMagic + 128.0f);
}
// clamp(rint(f), 0, 127) in the low byte (rint's halves to even: the add
// rounds to nearest even at an ulp of 1); rint and the clamp commute, the
// bounds being integers.  A NaN gives 0, as __float2int_rn's clamped.
__device__ __forceinline__ uint32_t requant_bits(float f) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(f, 0.f), 127.f), kMagic));
}

// The epilogue of one 64 x BN row block of a consumer's tile (see the note
// at the top).  acc[4 j + 2 h + e] is row warp * 16 + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e of the block; sc holds the identity shortcut's bytes
// 32 jj + 8 (lane % 4) .. + 7 of rows h, loaded before the tile's products.
template <int BN, bool kSmallK>
__device__ __forceinline__ void epilogue(const int* acc, const uint2 (&sc)[2][BN / 32],
                                         const Params& p, int row0, int n0, float ratio) {
  const int q = threadIdx.x % 4;
  auto to_float = [](int v) { return kSmallK ? small_i2f(v) : __int2float_rn(v); };
#pragma unroll
  for (int jj = 0; jj < BN / 32; ++jj) {
    float2 mm[4], zz[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + 8 * (4 * jj + e) + 2 * q;
      mm[e] = __ldg(reinterpret_cast<const float2*>(p.mul + col));
      zz[e] = __ldg(reinterpret_cast<const float2*>(p.add + col));
    }
    float2 ad[2][4];
    if (p.epilogue == 1) {  // all of this jj's addends in flight at once
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ad[h][e] = row0 + 8 * h < p.M
                         ? __ldg(reinterpret_cast<const float2*>(
                               p.addend + (long long)(row0 + 8 * h) * p.Cout + n0 +
                               8 * (4 * jj + e) + 2 * q))
                         : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const bool in = row < p.M;
      const long long o = (long long)row * p.Cout;
      float f[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * jj + e;
        f[e][0] = __fadd_rn(__fmul_rn(to_float(acc[4 * j + 2 * h]), mm[e].x), zz[e].x);
        f[e][1] = __fadd_rn(__fmul_rn(to_float(acc[4 * j + 2 * h + 1]), mm[e].y), zz[e].y);
      }
      if (p.epilogue == 2) {
        if (in) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o + n0 + 8 * (4 * jj + e) +
                                       2 * q) = make_float2(f[e][0], f[e][1]);
        }
        continue;
      }
      if (p.epilogue == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[e][0] = __fadd_rn(f[e][0], ad[h][e].x);
          f[e][1] = __fadd_rn(f[e][1], ad[h][e].y);
        }
      }
      uint32_t w[4];
      if (p.epilogue == 3) {
        // Lane q holds the shortcut's bytes 32 jj + 8 q .. + 7 of its row;
        // the transpose hands each lane its fragment's pairs.
        w[0] = sc[h][jj].x; w[1] = sc[h][jj].x >> 16; w[2] = sc[h][jj].y; w[3] = sc[h][jj].y >> 16;
        quad_transpose(w, q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[e][0] = __fadd_rn(f[e][0], __fmul_rn(byte_i2f<0>(w[e]), ratio));
          f[e][1] = __fadd_rn(f[e][1], __fmul_rn(byte_i2f<1>(w[e]), ratio));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = __byte_perm(requant_bits(f[e][0]), requant_bits(f[e][1]), 0x0040);
      // Lane q now gets the row's bytes 32 jj + 8 q .. + 7.
      quad_transpose(w, q);
      if (in)
        *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o + n0 + 32 * jj + 8 * q) =
            make_uint2(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410));
    }
  }
}

// Named barriers 2 and 3: consumer cw waits on 2 + cw for its turn to issue
// products; the other consumer arrives there when its own turn's products
// are done (128 threads each side).
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - cw) : "memory");
}

// Consumer warpgroup cw.  Ping-pong: the block's tiles of turns cw, cw + 2,
// ... (one consumer's products overlap the other's epilogue); the turns'
// products run in order, so that a consumer waits on a stage's full barrier
// only for the ring's current lap (the barrier's parity tells no more), and
// the stages of the other consumer's turns are skipped.  Cooperative: every
// turn, rows 64 cw .. 64 cw + 63 of the tile.
template <int BN, int kMode, bool kCoop>
__device__ void consume(const Params& p, uint32_t ring, uint32_t full0, uint32_t empty0,
                        int cw) {
  constexpr int BM = bm_of(kCoop), MT = kCoop ? 1 : BM / 64;
  constexpr int kTurnStep = kCoop ? 1 : 2;
  constexpr int kABytes = BM * kChunk, kStageBytes = kABytes + BN * kChunk;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, q = lane % 4;
  const float ratio = p.epilogue == 3 ? __ldg(p.ratio) : 0.f;
  // |acc| <= 128² · K_pad: within small_i2f's 2^22 up to K_pad = 256.
  const bool small_k = 16384LL * p.Kpad <= (1LL << 22);
  const int turns = (p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  int acc[MT][BN / 2];
  uint2 sc[MT][2][BN / 32];
  // The consumer's rows in each stage's A: row block cw when cooperative.
  const uint32_t a_rows = kCoop ? 64 * cw * kChunk : 0;
  Ring r;
  if (!kCoop) r.skip(cw * p.n_chunks, p.stages);
  for (int turn = kCoop ? 0 : cw; turn < turns; turn += kTurnStep) {
    const Tile tl(blockIdx.x + turn * gridDim.x, p.tiles_n);
    const int row0 = tl.mt * BM + (kCoop ? 64 * cw : 0) + warp * 16 + lane / 4;
    const int n0 = tl.nt * BN;
    if (p.epilogue == 3) {  // the shortcut's loads fly while the products run
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < BN / 32; ++jj) {
            const int row = row0 + 64 * mt + 8 * h;
            sc[mt][h][jj] = row < p.M ? __ldg(reinterpret_cast<const uint2*>(
                                            p.shortcut + (long long)row * p.Cout + n0 +
                                            32 * jj + 8 * q))
                                      : make_uint2(0u, 0u);
          }
    }
    if (!kCoop && turn > 0) turn_wait(cw);
    int pending = -1;
    for (int kc = 0; kc < p.n_chunks; ++kc, r.next(p.stages)) {
      mbar_wait(full0 + 8 * r.s, r.phase);
      // The gathers' cp.async wrote through the generic proxy.
      if constexpr (kMode != kTma) fence_proxy_async();
      wgmma_fence();
      // 8-row groups 1024 bytes apart, row blocks 8 KB apart; k advanced 32
      // bytes (2 units) a step inside the swizzled 128-byte row.
      const uint32_t stage = ring + r.s * kStageBytes;
      const uint64_t a_desc = sw128_desc(stage + a_rows, 16, 1024);
      const uint64_t b_desc = sw128_desc(stage + kABytes, 16, 1024);
      const int steps = min(kChunk / 32, (p.Kpad - kc * kChunk) / 32);
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
        if (kk < steps) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_s8<BN>(acc[mt], a_desc + 512 * mt + 2 * kk, b_desc + 2 * kk, kc | kk);
        }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: free its stage
      if (pending >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pending);
      pending = r.s;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[mt][i])::"memory");
    if (lane == 0) mbar_arrive(empty0 + 8 * pending);
    if (!kCoop) {
      if (turn + 1 < turns) turn_pass(cw);
      r.skip(p.n_chunks, p.stages);  // the other consumer's turn
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (small_k)
        epilogue<BN, true>(acc[mt], sc[mt], p, row0 + 64 * mt, n0, ratio);
      else
        epilogue<BN, false>(acc[mt], sc[mt], p, row0 + 64 * mt, n0, ratio);
    }
  }
}

template <int BN, int kMode, bool kCoop>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BM = bm_of(kCoop), kStageBytes = (BM + BN) * kChunk;
  const uint32_t align = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  const uint32_t ring = smem_addr(smem_raw) + align;
  const uint32_t full0 = ring + p.stages * kStageBytes;
  const uint32_t empty0 = full0 + 8 * p.stages;
  int2* table = reinterpret_cast<int2*>(smem_raw + align + p.stages * kStageBytes + 256);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // TMA: the producer's one arrive.expect_tx; gathers: that (for B) and
      // the cp.async arrival of each of the 128 producer threads.
      mbar_init(full0 + 8 * s, kMode == kTma ? 1 : 129);
      // One arrive from each warp of the stage's consumers.
      mbar_init(empty0 + 8 * s, kCoop ? 8 : 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    if constexpr (kMode == kTma) {
      if (threadIdx.x == 0) produce_tma<BN, BM>(&a_map, &b_map, p, ring, full0, empty0);
    } else if constexpr (kMode == kGather16) {
      produce_gather16<BN, BM>(&b_map, p, ring, full0, empty0);
    } else {
      produce_gather4<BN, BM>(&b_map, p, ring, full0, empty0, table);
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
    consume<BN, kMode, kCoop>(p, ring, full0, empty0, wg - 1);
  }
}

template <int BN, int kMode, bool kCoop>
int launch(const void* x, const void* w, Params p, cudaStream_t stream) {
  static_assert(kCoop || BN == 64, "ping-pong takes 256 x 64 tiles only");
  static_assert(kMode != kTma || (kCoop && BN <= 128), "TMA: cooperative, BN 64 or 128");
  constexpr int BM = bm_of(kCoop), kStageBytes = (BM + BN) * kChunk;
  auto kernel = int8_conv_kernel<BN, kMode, kCoop>;
  // Once per device: the shared-memory ceiling and the SM count.
  static std::once_flag once[kMaxDevices];
  static cudaError_t set_err[kMaxDevices];
  static int sm_count[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::call_once(once[device], [&] {
    set_err[device] =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (set_err[device] == cudaSuccess)
      set_err[device] =
          cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
  });
  if (set_err[device] != cudaSuccess) return (int)set_err[device];
  if (!encode_tiled()) return (int)cudaErrorSharedObjectSymbolNotFound;

  p.stages = stages_of(BN, kCoop);
  p.tiles_n = p.Cout / BN;
  p.n_tiles = ((p.M + BM - 1) / BM) * p.tiles_n;
  p.n_chunks = (p.Kpad + kChunk - 1) / kChunk;
  if (kMode == kGather4 && p.n_chunks * (kChunk / 4) > kMaxTable) return (int)cudaErrorInvalidValue;
  CUtensorMap a_map{}, b_map;
  if (!make_map_2d(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, p.Kpad, p.Cout, p.Kpad, kChunk, BN))
    return (int)cudaErrorInvalidValue;
  if (kMode == kTma &&
      !make_map_2d(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, p.Cin, p.M, p.Cin, kChunk, BM))
    return (int)cudaErrorInvalidValue;
  // At most one block an SM; in ping-pong each of its two consumers a tile.
  const int want = kCoop ? p.n_tiles : (p.n_tiles + 1) / 2;
  const int grid = want < sm_count[device] ? want : sm_count[device];
  const int smem = kSmemFixed + p.stages * kStageBytes;
  kernel<<<grid, kThreads, smem, stream>>>(a_map, b_map, p);
  return (int)cudaGetLastError();
}

// A gather's launch (gather16 or gather4) at column tile BN.
template <int BN, bool kCoop>
int launch_gather(int mode, const void* x, const void* w, const Params& p, cudaStream_t s) {
  return mode == kGather16 ? launch<BN, kGather16, kCoop>(x, w, p, s)
                           : launch<BN, kGather4, kCoop>(x, w, p, s);
}

}  // namespace

// x [N, H, W, Cin] int8, w [Cout, Kpad] int8, m and z [Cout] float32;
// addend [N, Ho, Wo, Cout] float32 (epilogue 1, else null); shortcut [N, Ho,
// Wo, Cout] int8 and ratio a float32 scalar (epilogue 3, else null) -> out
// [N, Ho, Wo, Cout] (int8, or float32 for epilogue 2).  `bn` is the column
// tile (64, 128 or 256, dividing Cout), `coop` 1 for the cooperative
// consumers, 0 for ping-pong.  Returns a cudaError_t (0 on
// success).  The caller (ops/cuda/int8_conv.py) has checked dtypes, shapes,
// contiguity, 16-byte alignment, Cin a multiple of 4, Cout a multiple of 64,
// Kpad a multiple of 32 holding K = kh·kw·Cin, and every tensor under 2^31
// bytes.
extern "C" int v2t_int8_conv(const void* x, const void* w, const void* m, const void* z,
                             const void* addend, const void* shortcut, const void* ratio,
                             void* out, int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
                             int kh, int kw, int stride, int pad, int K, int Kpad, int epilogue,
                             int bn, int coop, void* stream) {
  Params p{};
  p.x = static_cast<const int8_t*>(x);
  p.mul = static_cast<const float*>(m);
  p.add = static_cast<const float*>(z);
  p.addend = static_cast<const float*>(addend);
  p.shortcut = static_cast<const int8_t*>(shortcut);
  p.ratio = static_cast<const float*>(ratio);
  p.out = out;
  p.M = N * Ho * Wo;
  p.H = H; p.W = W; p.Cin = Cin; p.Ho = Ho; p.Wo = Wo; p.Cout = Cout;
  p.kw = kw; p.stride = stride; p.pad = pad; p.K = K; p.Kpad = Kpad; p.epilogue = epilogue;
  const int mode = (kh == 1 && kw == 1 && stride == 1 && pad == 0 && Cin % 16 == 0)
                       ? kTma
                       : (Cin % 16 == 0 ? kGather16 : kGather4);
  if (Cin % 4 != 0 || Cout % bn != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  // The instantiations are the plans launch_plan can return: TMA cooperative
  // at BN 64 or 128; the gathers cooperative at 64, 128 or 256, or
  // ping-pong at 64.
  if (mode == kTma) {
    if (!coop) return (int)cudaErrorInvalidValue;
    return bn == 64 ? launch<64, kTma, true>(x, w, p, s)
                    : bn == 128 ? launch<128, kTma, true>(x, w, p, s)
                                : (int)cudaErrorInvalidValue;
  }
  if (!coop) return bn == 64 ? launch_gather<64, false>(mode, x, w, p, s)
                             : (int)cudaErrorInvalidValue;
  switch (bn) {
    case 64: return launch_gather<64, true>(mode, x, w, p, s);
    case 128: return launch_gather<128, true>(mode, x, w, p, s);
    case 256: return launch_gather<256, true>(mode, x, w, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
