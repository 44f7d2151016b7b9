// The tiled GEMM shared by the forward and backward halves of the CLIP
// residual block (block_fused.cu, block_fused_bwd.cu).
//
//   C[M, N] = epilogue(A[M, K] @ op(W))
//
// op(W) is W stored [K, N] row-major (TRANS = false, the forward's
// `x @ W`) or W^T with W stored [N, K] row-major (TRANS = true, the
// backward's `g @ W^T` against the same weight buffer, so no transposed
// copy is ever made). bf16/fp16 products run on the tensor cores through
// WMMA with fp32 accumulation; fp32 products are plain FMA (TF32 would
// break the 1e-5 fp32 tolerance). M is free; N and K are multiples of 8.
// `ldw` is the distance in elements between two rows of W as stored, so W
// may be a column slice of a wider matrix (the chunked MLP half multiplies
// by c_fc_w[:, j0:j1] in place); 0 stands for a dense W (N, or K with TRANS).
// `ldc` is the same for C, so C may be a column slice of a wider buffer (the
// tensor-parallel attention partial writes q, k and v side by side into one
// [M, 3 dl] buffer); 0 stands for a dense C (N). A residual or h_pre operand
// is always dense [M, N].
//
// Epilogues (the fp32 accumulator is finished per element, then stored):
//   EPI_BIAS           T(acc + bias)
//   EPI_BIAS_GELU      T(QuickGELU(acc + bias)), QuickGELU in fp32
//   EPI_BIAS_RESIDUAL  T(aux + T(acc + bias)), aux = residual, T
//   EPI_BIAS_F32       acc + bias, stored as fp32 (the backward's h_pre)
//   EPI_CAST           T(acc)
//   EPI_GELU_GRAD      T(acc * QuickGELU'(aux)), aux = h_pre, fp32
//   EPI_F32            acc, stored as fp32 (the LayerNorm cotangent's input)
//   EPI_ACCUM          T(C + T(acc)): the partial product is cast, then added
//                      to what C holds, in the activation dtype
#pragma once

#include <mma.h>

#include "common.cuh"

namespace ovmr {

using namespace nvcuda;

enum Epilogue {
  EPI_BIAS = 0,
  EPI_BIAS_GELU = 1,
  EPI_BIAS_RESIDUAL = 2,
  EPI_BIAS_F32 = 3,
  EPI_CAST = 4,
  EPI_GELU_GRAD = 5,
  EPI_F32 = 6,
  EPI_ACCUM = 7
};

__host__ __device__ constexpr bool epi_has_bias(int e) { return e <= EPI_BIAS_F32; }
__host__ __device__ constexpr bool epi_out_f32(int e) {
  return e == EPI_BIAS_F32 || e == EPI_F32;
}

// the fp32 value of one output before it is cast and stored; `hpre` is
// read only by EPI_GELU_GRAD: d/dh of h * sigmoid(1.702 h) is
// s + 1.702 h s (1 - s)
template <typename T, int EPI>
__device__ __forceinline__ float epilogue_value(float acc, T bias, float hpre) {
  float v = acc;
  if (epi_has_bias(EPI)) v += to_f(bias);
  if (EPI == EPI_BIAS_GELU) v = v * (1.0f / (1.0f + expf(-1.702f * v)));
  if (EPI == EPI_GELU_GRAD) {
    const float s = 1.0f / (1.0f + expf(-1.702f * hpre));
    v = v * (s + 1.702f * hpre * s * (1.0f - s));
  }
  return v;
}

// cast, and for EPI_BIAS_RESIDUAL and EPI_ACCUM add the residual (or what C
// holds) in the activation dtype
template <typename T, int EPI>
__device__ __forceinline__ T epilogue_cast(float v, T resid) {
  T o = from_f<T>(v);
  if (EPI == EPI_BIAS_RESIDUAL || EPI == EPI_ACCUM) o = from_f<T>(to_f(resid) + to_f(o));
  return o;
}

// ---------------------------------------------------------------------------
// bf16/fp16: 128 x 128 block tile, 8 warps as 4 x 2, each warp 32 x 64
// (2 x 4 WMMA 16x16x16 fragments with fp32 accumulators). Two shared-memory
// stages: the next k-tile is copied with cp.async while the warps multiply
// the current one. With TRANS the W tile is staged [n][k], which WMMA reads
// as a column-major B.
// ---------------------------------------------------------------------------
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_THREADS = 256;
constexpr int TC_LDA = TC_BK + 8;  // padded rows; multiples of 8 for WMMA
constexpr int TC_LDB = TC_BN + 8;

template <bool TRANS>
__host__ __device__ constexpr int tc_b_elems() {
  return TRANS ? TC_BN * TC_LDA : TC_BK * TC_LDB;
}

// start copying k-tile k0 of A and W into one stage
template <typename T, bool TRANS>
__device__ __forceinline__ void copy_tile_async(T* As, T* Bs, const T* A, const T* W, int M,
                                           int N, int K, int ldw, int m0, int n0, int k0) {
  for (int c = threadIdx.x; c < TC_BM * TC_BK / 8; c += TC_THREADS) {
    const int r = c / (TC_BK / 8), kc = (c % (TC_BK / 8)) * 8;
    const bool ok = m0 + r < M && k0 + kc < K;
    cp_async16(&As[r * TC_LDA + kc], ok ? A + (size_t)(m0 + r) * K + k0 + kc : A, ok);
  }
  if constexpr (TRANS) {
    for (int c = threadIdx.x; c < TC_BN * TC_BK / 8; c += TC_THREADS) {
      const int r = c / (TC_BK / 8), kc = (c % (TC_BK / 8)) * 8;
      const bool ok = n0 + r < N && k0 + kc < K;
      cp_async16(&Bs[r * TC_LDA + kc], ok ? W + (size_t)(n0 + r) * ldw + k0 + kc : W, ok);
    }
  } else {
    for (int c = threadIdx.x; c < TC_BK * TC_BN / 8; c += TC_THREADS) {
      const int r = c / (TC_BN / 8), nc = (c % (TC_BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async16(&Bs[r * TC_LDB + nc], ok ? W + (size_t)(k0 + r) * ldw + n0 + nc : W, ok);
    }
  }
  cp_async_commit();
}

template <typename T, bool TRANS, int EPI>
__global__ void __launch_bounds__(TC_THREADS, 2)
    gemm_tc_kernel(const T* __restrict__ A, const T* __restrict__ W,
                   const T* __restrict__ bias, const void* __restrict__ aux,
                   void* __restrict__ Cv, int M, int N, int K, int ldw, int ldc) {
  __shared__ __align__(128) T As[2][TC_BM * TC_LDA];
  __shared__ __align__(128) T Bs[2][tc_b_elems<TRANS>()];
  __shared__ __align__(128) float scratch[TC_THREADS / 32][16 * 16];
  using BLayout = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;

  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  copy_tile_async<T, TRANS>(As[0], Bs[0], A, W, M, N, K, ldw, m0, n0, 0);
  const int nk = ceil_div(K, TC_BK);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    // the other stage was last read before the previous barrier: safe to fill
    if (kt + 1 < nk) {
      copy_tile_async<T, TRANS>(As[cur ^ 1], Bs[cur ^ 1], A, W, M, N, K, ldw, m0, n0,
                           (kt + 1) * TC_BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[cur][(wm * 32 + i * 16) * TC_LDA + kk], TC_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (TRANS)
          wmma::load_matrix_sync(b[j], &Bs[cur][(wn * 64 + j * 16) * TC_LDA + kk], TC_LDA);
        else
          wmma::load_matrix_sync(b[j], &Bs[cur][kk * TC_LDB + wn * 64 + j * 16], TC_LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment goes through the warp's fp32 scratch, then each
  // lane finishes 8 consecutive outputs of one row
  float* sc = scratch[warp];
  const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 32 + i * 16 + r, gn = n0 + wn * 64 + j * 16 + cc;
      if (gm < M && gn < N) {
        const size_t at = (size_t)gm * ldc + gn, at_aux = (size_t)gm * N + gn;
        Vec<T, 8> bv, rv;
        Vec<float, 4> hp[2];
        if (epi_has_bias(EPI)) bv = *reinterpret_cast<const Vec<T, 8>*>(bias + gn);
        if (EPI == EPI_BIAS_RESIDUAL)
          rv = *reinterpret_cast<const Vec<T, 8>*>(static_cast<const T*>(aux) + at_aux);
        if (EPI == EPI_ACCUM) rv = *reinterpret_cast<const Vec<T, 8>*>(static_cast<T*>(Cv) + at);
        if (EPI == EPI_GELU_GRAD) {
          const float* h = static_cast<const float*>(aux) + at_aux;
          hp[0] = *reinterpret_cast<const Vec<float, 4>*>(h);
          hp[1] = *reinterpret_cast<const Vec<float, 4>*>(h + 4);
        }
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = epilogue_value<T, EPI>(sc[r * 16 + cc + e],
                                        epi_has_bias(EPI) ? bv.v[e] : from_f<T>(0.f),
                                        EPI == EPI_GELU_GRAD ? hp[e / 4].v[e % 4] : 0.f);
        if (epi_out_f32(EPI)) {
          float* c = static_cast<float*>(Cv) + at;
          Vec<float, 4> o[2];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e / 4].v[e % 4] = v[e];
          *reinterpret_cast<Vec<float, 4>*>(c) = o[0];
          *reinterpret_cast<Vec<float, 4>*>(c + 4) = o[1];
        } else {
          Vec<T, 8> o;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o.v[e] = epilogue_cast<T, EPI>(
                v[e], EPI == EPI_BIAS_RESIDUAL || EPI == EPI_ACCUM ? rv.v[e] : from_f<T>(0.f));
          *reinterpret_cast<Vec<T, 8>*>(static_cast<T*>(Cv) + at) = o;
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: same contract, plain FMA. 64 x 64 block tile, 256 threads, each
// 4 x 4 outputs. Both operand tiles are staged [k][row] in shared memory.
// ---------------------------------------------------------------------------
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

template <bool TRANS, int EPI>
__global__ void __launch_bounds__(F_THREADS)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ bias, const void* __restrict__ auxv,
                    void* __restrict__ Cv, int M, int N, int K, int ldw, int ldc) {
  __shared__ __align__(16) float As[F_BK][F_BM + 4];  // transposed: As[k][m]
  __shared__ __align__(16) float Bs[F_BK][F_BN + 4];
  const float* aux = static_cast<const float*>(auxv);
  float* C = static_cast<float*>(Cv);

  const int n0 = blockIdx.x * F_BN, m0 = blockIdx.y * F_BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    {
      const int r = tid / 4, kc = (tid % 4) * 4;
      const int gm = m0 + r, gk = k0 + kc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M && gk < K) v = *reinterpret_cast<const float4*>(A + (size_t)gm * K + gk);
      As[kc + 0][r] = v.x;
      As[kc + 1][r] = v.y;
      As[kc + 2][r] = v.z;
      As[kc + 3][r] = v.w;
    }
    if constexpr (TRANS) {
      const int r = tid / 4, kc = (tid % 4) * 4;
      const int gn = n0 + r, gk = k0 + kc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gn < N && gk < K) v = *reinterpret_cast<const float4*>(W + (size_t)gn * ldw + gk);
      Bs[kc + 0][r] = v.x;
      Bs[kc + 1][r] = v.y;
      Bs[kc + 2][r] = v.z;
      Bs[kc + 3][r] = v.w;
    } else {
      const int r = tid / 16, nc = (tid % 16) * 4;
      const int gk = k0 + r, gn = n0 + nc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < K && gn < N) v = *reinterpret_cast<const float4*>(W + (size_t)gk * ldw + gn);
      *reinterpret_cast<float4*>(&Bs[r][nc]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      const size_t at = (size_t)gm * ldc + gn, at_aux = (size_t)gm * N + gn;
      const float v = epilogue_value<float, EPI>(
          acc[i][j], epi_has_bias(EPI) ? bias[gn] : 0.f, EPI == EPI_GELU_GRAD ? aux[at_aux] : 0.f);
      C[at] = epilogue_cast<float, EPI>(
          v, EPI == EPI_BIAS_RESIDUAL ? aux[at_aux] : EPI == EPI_ACCUM ? C[at] : 0.f);
    }
  }
}

template <typename T, bool TRANS, int EPI>
static void launch_gemm(const void* A, const void* W, const void* bias, const void* aux,
                        void* C, int M, int N, int K, cudaStream_t st, int ldw = 0,
                        int ldc = 0) {
  if (ldw == 0) ldw = TRANS ? K : N;
  if (ldc == 0) ldc = N;
  if constexpr (std::is_same<T, float>::value) {
    dim3 grid(ceil_div(N, F_BN), ceil_div(M, F_BM));
    gemm_f32_kernel<TRANS, EPI><<<grid, F_THREADS, 0, st>>>(
        (const float*)A, (const float*)W, (const float*)bias, aux, C, M, N, K, ldw, ldc);
  } else {
    dim3 grid(ceil_div(N, TC_BN), ceil_div(M, TC_BM));
    gemm_tc_kernel<T, TRANS, EPI><<<grid, TC_THREADS, 0, st>>>(
        (const T*)A, (const T*)W, (const T*)bias, aux, C, M, N, K, ldw, ldc);
  }
}

}  // namespace ovmr
