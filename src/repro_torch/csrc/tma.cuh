// The Tensor Memory Accelerator (TMA) and mbarrier pieces the tensor-core
// GEMMs share (wo_tc_gemm.cuh: B4/B5; i8_tc_gemm.cuh: B1/B6): tensor maps of
// a stack of row-major matrices built on the host, box loads into shared
// memory counted on an mbarrier, and the mbarrier operations of a ring of
// shared-memory stages. A GEMM's operands are [E, rows, cols] stacks (one
// matrix a MoE expert; E = 1 for a plain 2-D operand): a box never spans
// two matrices, and the TMA zero-fills past each matrix's rows and columns
// as it does past a lone matrix's.

#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtq {
namespace {  // internal linkage: each library keeps its own copy

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A box of matrix c2 of a stack (stack_map) global -> shared through the
// TMA, counted on mbarrier `bar`; (c0, c1) = (column, row) element
// coordinates of the box within the matrix.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point
// lookup (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major stack [depth, rows, cols] of `elem`-byte elements as a 3-D
// TMA map whose boxes are box_cols x box_rows of one matrix, loaded with
// tma_load_3d (depth 1: a lone matrix). Returns false if it cannot.
bool stack_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
               uint64_t depth, uint64_t rows, uint64_t cols, uint32_t box_cols,
               uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols * elem, rows * cols * elem};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace rtq
