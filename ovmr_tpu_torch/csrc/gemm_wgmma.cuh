// The Hopper GEMM of the block halves in bf16/fp16: wgmma fed by TMA
// through an mbarrier ring. Every bf16/fp16 product of K1-K5, K7 and K8
// runs on it: K1's QKV and out-proj, K7's q/k/v and fp32 out-proj, the
// c_fc and c_proj of K2, K5 and K8 (block_fused.cu, ovmr_gemm_wgmma), and
// the backward's products of K3 and K4 (block_fused_bwd.cu,
// ovmr_gemm_wgmma_bwd; K3's QKV recompute is K1's forward launch).
//
//   C[M, N] = epilogue(A[M, K] @ op(W))
//
// the contract of gemm.cuh's kernel: A dense row-major; op(W) is W stored
// [K, N] (TRANS = false, the forward's x @ W) or W^T with W stored [N, K]
// (TRANS = true, the backward's g @ W^T against the same weight buffer, so
// no transposed copy is ever made); W's rows ldw elements apart (a column
// slice of a wider weight is read in place); C rows ldc elements (of C's
// own type) apart, so C may be a column slice of a wider buffer (K7 writes
// q, k and v side by side); M free, N and K multiples of 8, ragged edges
// masked. Epilogues, rounded exactly as gemm.cuh's epilogue_value /
// epilogue_cast round them:
//   EPI_BIAS           T(acc + bias), bias added in fp32 (K1's QKV and K3's
//                      recompute of it, K7's q/k/v)
//   EPI_BIAS_GELU      T(QuickGELU(acc + bias)), QuickGELU in fp32 (c_fc)
//   EPI_BIAS_RESIDUAL  T(R + T(acc + bias)), R dense [M, N] (K1's out-proj,
//                      K2's c_proj)
//   EPI_BIAS_F32       acc + bias stored as fp32 (K4's h_pre)
//   EPI_CAST           T(acc) (K3's dattn = g @ w_out^T)
//   EPI_GELU_GRAD      T(acc * QuickGELU'(h)), h the dense fp32 [M, N] h_pre
//                      (K4's dh_pre = (g @ c_proj_w^T) * QuickGELU'(h_pre))
//   EPI_F32            acc stored as fp32, no bias (the partials of K7's
//                      out-proj and K8's c_proj; K3's and K4's dxln)
//   EPI_ACCUM          T(C + T(acc)) (K5's per-chunk c_proj)
//
// What bounds it: the block's products are far above the card's ~295
// FLOP/byte ridge (at ViT-L/14@336px and 512 images K5's two are 4.96 TFLOP
// against ~2.5 GB, K1's QKV 1.86 TFLOP against ~2.4 GB; K4's three at the
// text tower's 192 prompts 93 GFLOP against ~0.4 GB), so tensor-core issue
// is the limit. K7's fp32 out-proj is the exception: at K = 512 its 1.2 GB
// of fp32 stores bound it. A WMMA kernel (16x16x16 fragments loaded by every
// warp, a two-stage cp.async pipeline that all threads wait on, an fp32
// shared-memory round trip per output) reached ~155 TFLOP/s. Here:
//   - a block computes a 128 x 128 tile: two consumer warpgroups each issue
//     wgmma.mma_async m64n128k16 on a 64-row half, A and B read by the
//     tensor cores straight from shared memory, one k-tile's products in
//     flight while the next are issued;
//   - one producer thread (a ninth warp) keeps a ring of WG_STAGES (A, W)
//     k-tiles of 64 in flight with cp.async.bulk.tensor (TMA), each stage
//     guarded by a full and an empty mbarrier;
//   - two blocks share an SM (97 KB of shared memory and at most 112
//     registers a thread each), so one block's epilogue and pipeline fill
//     overlap the other's products;
//   - tiles arrive 128-byte swizzled: A [128 m][64 k] K-major. W [K, N] as
//     [128 / 64 column blocks][64 k][64 n], N-major, which wgmma reads
//     transposed (tnspB = 1); W^T from W [N, K] as [128 n][64 k], K-major,
//     the layout and descriptor of A (tnspB = 0). TMA zero-fills rows and
//     columns past M, N and K, so the products need no masking;
//   - the epilogue works on the accumulator registers: bias in fp32,
//     QuickGELU or its derivative at the fp32 h_pre (8-byte pairs), the
//     cast, the residual or C read in the activation dtype, and a masked
//     store of column pairs (4 bytes a pair, 8 for fp32 out). The operands
//     it reads are loaded several column groups ahead of their use: one
//     at a time, each load's latency showed in every tile (K4's GELU'
//     product read its h_pre at half the rate of the fp32-out c_fc).
// K4 runs gemm_wgmma_dual_kernel below instead of its c_fc and GELU'
// launches: both products' accumulators in one block, h_pre never stored.
// The tensor maps are encoded on the host for every call, with the
// cuTensorMapEncodeTiled looked up once in libcuda at run time (the
// library links nothing beyond the CUDA runtime).
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "gemm.cuh"

namespace ovmr {

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 3, WG_THREADS = 288;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2, WG_B_BYTES = WG_BK * WG_BN * 2;
// the ring, plus room to align it to the 1024 bytes the 128-byte swizzle repeats at
constexpr size_t WG_SMEM = (size_t)WG_STAGES * (WG_A_BYTES + WG_B_BYTES) + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box of `map` at (c0 innermost, c1) into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). K-major A: the stride offset is
// the distance between 8-row groups (1024 bytes; the leading offset is not
// read). N-major B: the leading offset is the distance between 64-column
// blocks, the stride offset between 8-row (k) groups.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (+)= A . B for a 64 x 16 A tile and a 16 x 128 B tile, both from shared
// memory; TNSPB = 1 reads B N-major, 0 K-major
template <typename T, int TNSPB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
#define TY "bf16"
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TNSPB));
#undef TY
  } else {
#define TY "f16"
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TNSPB));
#undef TY
  }
}

template <typename T, int EPI, bool TRANS>
__global__ void __launch_bounds__(WG_THREADS, 2)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, const T* __restrict__ bias,
                      const void* __restrict__ aux, void* __restrict__ Cv, int M, int N,
                      int K, int ldc) {
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.y * WG_BM;
  const int nk = ceil_div(K, WG_BK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);     // the producer's arrive, plus the stage's bytes
      mbar_init(&empty[s], 256);  // every consumer thread, once its products are done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer warp: one thread issues every load
    if (t == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES, ph = (kt / WG_STAGES) & 1;
        mbar_wait(&empty[s], ph ^ 1);  // the first round finds every stage free
        unsigned char* a = ring + s * (WG_A_BYTES + WG_B_BYTES);
        unsigned char* b = a + WG_A_BYTES;
        mbar_expect_tx(&full[s], WG_A_BYTES + WG_B_BYTES);
        tma_load_2d(a, &map_a, &full[s], kt * WG_BK, m0);
        if constexpr (TRANS) {
          tma_load_2d(b, &map_w, &full[s], kt * WG_BK, n0);
        } else {
#pragma unroll
          for (int c = 0; c < WG_BN / 64; ++c)
            tma_load_2d(b + c * WG_BK * 128, &map_w, &full[s], n0 + c * 64, kt * WG_BK);
        }
      }
    }
  } else {  // consumer warpgroups: rows m0 + 64 wg .. + 63
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % WG_STAGES, ph = (kt / WG_STAGES) & 1;
      mbar_wait(&full[s], ph);
      const unsigned char* a = ring + s * (WG_A_BYTES + WG_B_BYTES) + wg * 64 * WG_BK * 2;
      const unsigned char* b = ring + s * (WG_A_BYTES + WG_B_BYTES) + WG_A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        if constexpr (TRANS)
          wgmma_m64n128k16<T, 0>(d, wg_desc(a + kk * 32, 16, 1024), wg_desc(b + kk * 32, 16, 1024),
                                 1);
        else
          wgmma_m64n128k16<T, 1>(d, wg_desc(a + kk * 32, 16, 1024),
                                 wg_desc(b + kk * 16 * 128, WG_BK * 128, 1024), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // k-tile kt - 1's products are done: its stage goes back to the
      // producer while kt's run
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i)  // the sums are read only after the wait
      asm volatile("" : "+f"(d[i])::"memory");

    // epilogue on the registers: thread t holds rows r and r + 8 of its
    // warp's 16, columns 8 i + 2 (t % 4) + {0, 1} for i < 16. The operands
    // it reads (bias, h_pre or C) are loaded EG column groups at a time
    // before any is used, so that their latencies overlap; the residual
    // epilogue loads one group at a time (with four, its bf16 form spilled
    // and K1's out-proj ran 12% slower)
    const int warp = t / 32, lane = t % 32;
    const int r = m0 + wg * 64 + warp * 16 + lane / 4;
    constexpr bool reads_t = EPI == EPI_BIAS_RESIDUAL || EPI == EPI_ACCUM;
    constexpr int EG = EPI == EPI_BIAS_RESIDUAL ? 1 : 4;
#pragma unroll
    for (int i0 = 0; i0 < WG_BN / 8; i0 += EG) {
      Vec<T, 2> bv[EG], rv[EG][2];
      Vec<float, 2> hp[EG][2];
#pragma unroll
      for (int i = 0; i < EG; ++i) {
        const int col = n0 + (i0 + i) * 8 + (lane % 4) * 2;
        if (col >= N) continue;
        if (epi_has_bias(EPI)) bv[i] = *reinterpret_cast<const Vec<T, 2>*>(bias + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          if (row >= M) continue;
          if (EPI == EPI_GELU_GRAD)
            hp[i][h] = *reinterpret_cast<const Vec<float, 2>*>(static_cast<const float*>(aux) +
                                                               (size_t)row * N + col);
          if (EPI == EPI_BIAS_RESIDUAL)
            rv[i][h] = *reinterpret_cast<const Vec<T, 2>*>(static_cast<const T*>(aux) +
                                                           (size_t)row * N + col);
          if (EPI == EPI_ACCUM)
            rv[i][h] = *reinterpret_cast<const Vec<T, 2>*>(static_cast<const T*>(Cv) +
                                                           (size_t)row * ldc + col);
        }
      }
#pragma unroll
      for (int i = 0; i < EG; ++i) {
        const int col = n0 + (i0 + i) * 8 + (lane % 4) * 2;
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          if (row >= M) continue;
          const size_t at = (size_t)row * ldc + col;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = epilogue_value<T, EPI>(d[(i0 + i) * 4 + h * 2 + e],
                                          epi_has_bias(EPI) ? bv[i].v[e] : from_f<T>(0.f),
                                          EPI == EPI_GELU_GRAD ? hp[i][h].v[e] : 0.f);
          if constexpr (epi_out_f32(EPI)) {
            Vec<float, 2> o;
            o.v[0] = v[0];
            o.v[1] = v[1];
            *reinterpret_cast<Vec<float, 2>*>(static_cast<float*>(Cv) + at) = o;
          } else {
            Vec<T, 2> o;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              o.v[e] = epilogue_cast<T, EPI>(v[e], reads_t ? rv[i][h].v[e] : from_f<T>(0.f));
            *reinterpret_cast<Vec<T, 2>*>(static_cast<T*>(Cv) + at) = o;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4's two products over one [M, hidden] tile in one launch: the c_fc
// recompute h = X @ Wfc + bias (Wfc [K, N], read N-major) and dh = G @
// Wproj^T (Wproj stored [N, K], read K-major), both with K = D, and
//   C = T(dh * QuickGELU'(h)), h in fp32 (EPI_BIAS_F32's sum, then
//   EPI_GELU_GRAD's arithmetic: bit-equal to those two launches)
// so the fp32 h_pre never reaches device memory. Each consumer warpgroup
// holds both 64 x 128 accumulators (128 registers a thread), so one block
// takes an SM (up to 224 registers a thread); a stage holds the k-tiles of
// X, Wfc, G and Wproj (64 KB), three stages in flight.
// ---------------------------------------------------------------------------
constexpr int WD_STAGE = 2 * (WG_A_BYTES + WG_B_BYTES);
constexpr size_t WD_SMEM = (size_t)WG_STAGES * WD_STAGE + 1024;

template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
    gemm_wgmma_dual_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_fc,
                           const __grid_constant__ CUtensorMap map_g,
                           const __grid_constant__ CUtensorMap map_proj,
                           const T* __restrict__ bias, T* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.y * WG_BM;
  const int nk = ceil_div(K, WG_BK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s: X tile, Wfc tile ([2 column blocks][64 k][64 n]), G tile, Wproj tile ([128 n][64 k])
  if (wg == 2) {
    if (t == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES, ph = (kt / WG_STAGES) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* x = ring + s * WD_STAGE;
        unsigned char* fc = x + WG_A_BYTES;
        unsigned char* g = fc + WG_B_BYTES;
        mbar_expect_tx(&full[s], WD_STAGE);
        tma_load_2d(x, &map_x, &full[s], kt * WG_BK, m0);
#pragma unroll
        for (int c = 0; c < WG_BN / 64; ++c)
          tma_load_2d(fc + c * WG_BK * 128, &map_fc, &full[s], n0 + c * 64, kt * WG_BK);
        tma_load_2d(g, &map_g, &full[s], kt * WG_BK, m0);
        tma_load_2d(g + WG_A_BYTES, &map_proj, &full[s], kt * WG_BK, n0);
      }
    }
  } else {
    float h[64], dh[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) h[i] = dh[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % WG_STAGES, ph = (kt / WG_STAGES) & 1;
      mbar_wait(&full[s], ph);
      const unsigned char* x = ring + s * WD_STAGE;
      const unsigned char* fc = x + WG_A_BYTES;
      const unsigned char* g = fc + WG_B_BYTES;
      const unsigned char* proj = g + WG_A_BYTES;
      x += wg * 64 * WG_BK * 2;
      g += wg * 64 * WG_BK * 2;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        wgmma_m64n128k16<T, 1>(h, wg_desc(x + kk * 32, 16, 1024),
                               wg_desc(fc + kk * 16 * 128, WG_BK * 128, 1024), 1);
        wgmma_m64n128k16<T, 0>(dh, wg_desc(g + kk * 32, 16, 1024),
                               wg_desc(proj + kk * 32, 16, 1024), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(h[i]), "+f"(dh[i])::"memory");

    const int warp = t / 32, lane = t % 32;
    const int r = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i) {
      const int col = n0 + i * 8 + (lane % 4) * 2;
      if (col >= N) continue;
      const Vec<T, 2> bv = *reinterpret_cast<const Vec<T, 2>*>(bias + col);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r + 8 * hr;
        if (row >= M) continue;
        Vec<T, 2> o;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = i * 4 + hr * 2 + e;
          const float pre = epilogue_value<T, EPI_BIAS_F32>(h[j], bv.v[e], 0.f);
          o.v[e] = from_f<T>(epilogue_value<T, EPI_GELU_GRAD>(dh[j], from_f<T>(0.f), pre));
        }
        *reinterpret_cast<Vec<T, 2>*>(C + (size_t)row * N + col) = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the copy the CUDA runtime has loaded
static TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = []() -> TensorMapEncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<TensorMapEncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a row-major [rows, cols] matrix with rows `ld` elements apart, read in
// boxes of box_rows x 64 columns (128 bytes), 128-byte swizzled; what lies
// outside the matrix reads as zero
template <typename T>
static bool encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                      int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// W is [K, N] (rows ldw apart, read in boxes of 64 k rows) or, with TRANS,
// [N, K] (read in boxes of 128 n rows, as A is read in boxes of 128 m rows);
// aux is the residual (EPI_BIAS_RESIDUAL) or the fp32 h_pre (EPI_GELU_GRAD)
template <typename T, int EPI, bool TRANS>
static cudaError_t launch_gemm_wgmma(const void* A, const void* W, const void* bias,
                                     const void* aux, void* C, int M, int N, int K, int ldw,
                                     int ldc, cudaStream_t st) {
  if (M == 0 || N == 0) return cudaSuccess;
  CUtensorMap map_a, map_w;
  const bool w_ok = TRANS ? encode_2d<T>(&map_w, W, N, K, ldw, WG_BN)
                          : encode_2d<T>(&map_w, W, K, N, ldw, WG_BK);
  if (!encode_2d<T>(&map_a, A, M, K, K, WG_BM) || !w_ok) return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<T, EPI, TRANS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(N, WG_BN), ceil_div(M, WG_BM));  // column tiles fastest: A rows shared in L2
  kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(map_a, map_w, (const T*)bias, aux, C, M, N, K,
                                            ldc);
  return cudaSuccess;
}

// K4's dh_pre = T((G @ Wproj^T) * QuickGELU'(X @ Wfc + bias)) for X, G [M, K],
// Wfc [K, N], Wproj [N, K], all dense (gemm_wgmma_dual_kernel)
template <typename T>
static cudaError_t launch_gemm_wgmma_dual(const void* X, const void* Wfc, const void* bias,
                                          const void* G, const void* Wproj, void* C, int M, int N,
                                          int K, cudaStream_t st) {
  if (M == 0 || N == 0) return cudaSuccess;
  CUtensorMap map_x, map_fc, map_g, map_proj;
  if (!encode_2d<T>(&map_x, X, M, K, K, WG_BM) || !encode_2d<T>(&map_fc, Wfc, K, N, N, WG_BK) ||
      !encode_2d<T>(&map_g, G, M, K, K, WG_BM) || !encode_2d<T>(&map_proj, Wproj, N, K, K, WG_BN))
    return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_dual_kernel<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WD_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(N, WG_BN), ceil_div(M, WG_BM));
  kernel<<<grid, WG_THREADS, WD_SMEM, st>>>(map_x, map_fc, map_g, map_proj, (const T*)bias,
                                            (T*)C, M, N, K);
  return cudaSuccess;
}

}  // namespace ovmr
