// The fp32 GEMM of the forward and backward halves of the CLIP residual
// block (block_fused.cu, block_fused_bwd.cu), and the epilogues every GEMM
// of the port rounds by (gemm_wgmma.cuh runs the bf16/fp16 products).
//
//   C[M, N] = epilogue(A[M, K] @ op(W))
//
// op(W) is W stored [K, N] row-major (TRANS = false, the forward's
// `x @ W`) or W^T with W stored [N, K] row-major (TRANS = true, the
// backward's `g @ W^T` against the same weight buffer, so no transposed
// copy is ever made). fp32 products are plain FMA with fp32 accumulation
// (TF32 would break the 1e-5 fp32 tolerance, and the fp32 card-vs-CPU
// gates rest on these sums). M is free; N and K are multiples of 8.
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

#include "common.cuh"

namespace ovmr {

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
    // a bf16/fp16 result keeps 8 or 11 bits, so there the sigmoid takes the
    // fast exponential and reciprocal (a few fp32 ulp; K4's epilogue is
    // issue-bound on the IEEE forms); fp32 keeps the forms its 1e-5 gates
    // rest on
    float s;
    if constexpr (std::is_same_v<T, float>)
      s = 1.0f / (1.0f + expf(-1.702f * hpre));
    else
      s = __fdividef(1.0f, 1.0f + __expf(-1.702f * hpre));
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
// fp32: plain FMA. 64 x 64 block tile, 256 threads, each
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

template <bool TRANS, int EPI>
static void launch_gemm_f32(const void* A, const void* W, const void* bias, const void* aux,
                            void* C, int M, int N, int K, cudaStream_t st, int ldw = 0,
                            int ldc = 0) {
  if (ldw == 0) ldw = TRANS ? K : N;
  if (ldc == 0) ldc = N;
  dim3 grid(ceil_div(N, F_BN), ceil_div(M, F_BM));
  gemm_f32_kernel<TRANS, EPI><<<grid, F_THREADS, 0, st>>>(
      (const float*)A, (const float*)W, (const float*)bias, aux, C, M, N, K, ldw, ldc);
}

}  // namespace ovmr
