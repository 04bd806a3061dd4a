// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels
// (probe_gemm_bf16.cu, int8_conv.cu): mbarriers, 2-D TMA loads, the wgmma
// shared-memory descriptor and its fences, the quad transpose of an
// accumulator fragment, and cuTensorMapEncodeTiled looked up at run time (the
// library links only the CUDA runtime, no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

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

// Within each quad of lanes (q = lane % 4), w[p] of lane q becomes w[q] of
// lane p: the off-diagonal 2 x 2 blocks swap with lane q ^ 2, then each
// 2 x 2 block transposes with lane q ^ 1.  Its own inverse.
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once at run time.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 2-D map over a row-major [outer, inner] array of `elem_bytes`-byte
// elements, rows `row_bytes` apart, tiles of box_outer rows x box_inner
// elements (box_inner x elem_bytes = 128 bytes), 128-byte swizzle, zeros
// past the edges.
bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
                 uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
