// Warp-level tensor-core helpers shared by the attention cores of the
// forward (block_fused.cu) and backward (block_fused_bwd.cu) halves:
// ldmatrix loads of 16-bit tiles from shared memory, mma.sync m16n8k16 with
// fp32 accumulation, and the cast of two fp32 values into one A-fragment
// register.
//
// Register layouts (PTX m16n8k16, lane = 4 gid + tig): an m16n8 accumulator
// d[4] holds rows gid (d[0..1]) and gid + 8 (d[2..3]) at columns 2 tig + {0,
// 1}; two adjacent m16n8 accumulator tiles, each pair cast and packed, are
// one m16n8k16 A fragment.
#pragma once

#include "common.cuh"

namespace ovmr {

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a . b for a 16 x 16 A fragment and a 16 x 8 B fragment (b0, b1)
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two fp32 values rounded to T (nearest even) in one register, lo first
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The A fragment of a 16-row tile whose row r starts at p + r * ld (16-bit
// elements), columns c0 .. c0 + 15
template <typename T>
__device__ __forceinline__ void lds_a(uint32_t (&r)[4], const T* p, int ld, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, p + (lane & 15) * ld + c0 + (lane >> 4) * 8);
}

// B fragments (b[0], b[1]) and (b[2], b[3]) of rows n0 .. n0 + 15 of a
// row-major tile read as B^T (B[k][n] = tile[n][k]): the operand of q . k^T;
// columns (k) c0 .. c0 + 15
template <typename T>
__device__ __forceinline__ void lds_bt(uint32_t (&b)[4], const T* p, int ld, int n0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, p + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + ((lane >> 3) & 1) * 8);
}

// The A fragment of the transpose of a row-major tile: A rows are the
// tile's columns c0 .. c0 + 15, A columns (k) its rows r0 .. r0 + 15 (the
// operand of P^T . dO with P stored [query][key])
template <typename T>
__device__ __forceinline__ void lds_at(uint32_t (&a)[4], const T* p, int ld, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(a, p + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of rows (k) k0 .. k0 + 15 and columns (n) c0 .. c0 + 7 (b[0],
// b[1]) and c0 + 8 .. + 15 (b[2], b[3]) of a row-major tile read as B: the
// operand of probs . v
template <typename T>
__device__ __forceinline__ void lds_b(uint32_t (&b)[4], const T* p, int ld, int k0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, p + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8);
}

}  // namespace ovmr
