// Hopper kernels for the input cotangents (dx) of the two halves of the
// CLIP residual block: the backward of the frozen text tower in training.
//
// Replaces the TPU kernels of ovmr_tpu/ops/block_fused_bwd.py:
//   K4 mlp_half_bwd_dx (_mlp_bwd_dx_kernel :57)
//      d/dy of y + c_proj(QuickGELU(c_fc(LN2(y)))) applied to g;
//   K3 attn_half_bwd_dx (_attn_bwd_dx_kernel :128, masked :219)
//      d/dx of x + out_proj(MHA(LN1(x))) applied to g, optional additive
//      [L, L] mask.
// Only dx: every trainer freezes the towers, so no weight cotangent is made.
//
// What bounds them on the H100: at the training shape (192 prompts x 77
// tokens, D = 512) K4 is three products of 2 x 14784 x 512 x 2048 FLOP
// (93 GFLOP) and K3 about 54 GFLOP of projections plus 6 GFLOP of attention
// products, against ~45 MB of activations: both are bound by tensor-core
// operations, not bytes.
//
// Design. Each kernel recomputes its half's forward intermediates, as the
// TPU kernels do, but one prompt's recompute state (the fp32 [77, 2048]
// h_pre alone is 631 KB) does not fit in 227 KB of shared memory, so each is
// a few launches behind one Python wrapper with the intermediates in global
// memory (keeping them on-chip is later work):
//   K4 = layer_norm -> gemm(+c_fc_b, fp32 out: h_pre)
//        -> gemm^T(g, c_proj_w; * QuickGELU'(h_pre), cast: dh_pre)
//        -> gemm^T(dh_pre, c_fc_w; fp32 out: dxln) -> ln_bwd(+g)
//   K3 = layer_norm -> gemm(+b_qkv, cast: qkv) -> gemm^T(g, w_out; cast: dattn)
//        -> attn_bwd_core(qkv, dattn: dqkv) -> gemm^T(dqkv, w_qkv; fp32 out: dxln)
//        -> ln_bwd(+g)
// layer_norm and the QKV gemm are the forward's launches (block_fused.cu);
// gemm^T multiplies by the transpose of the weight as it is stored
// (gemm.cuh), so no transposed copy exists. The attention-backward core is
// one block per (head, prompt): Q, K, V, dO and two fp32 [L, L] matrices
// (probs, then dS) stay in shared memory, so the column sums over queries
// that give dK and dV need no atomics. Its products are plain FMA in every
// dtype (a first design: right before fast; the tensor cores are later
// work). The whole head must fit: L = 77 with head width 64 takes 89 KB in
// bf16 and 128 KB in fp32; L = 197 would need 312 KB, and the launcher
// refuses it.
//
// Rounding follows the TPU kernels (block_fused_bwd.py:57-216): LN pieces in
// fp32, the LN output cast; h_pre stays fp32; dh_pre is cast after the fp32
// QuickGELU' product; qkv is cast after its bias and dattn after its
// product; scores, softmax and dP in fp32; dS is cast after the scale; probs
// are cast for the dV product; dq, dk, dv are cast per head; dxln stays
// fp32; the LN cotangent is cast and then added to g in the activation
// dtype.
#include "gemm.cuh"

namespace ovmr {

// ---------------------------------------------------------------------------
// LayerNorm input cotangent plus the residual path:
//   out = g + T(rstd * (dn - mean(dn) - normed * mean(dn * normed))),
//   dn = dxln * gamma, with mean, rstd and normed recomputed from x in fp32.
// One warp per row, 16-byte loads of x and g.
// ---------------------------------------------------------------------------
constexpr int LNB_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(LNB_THREADS)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dxln,
                  const T* __restrict__ g, const T* __restrict__ gamma, T* __restrict__ out,
                  int M, int K) {
  constexpr int VW = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (LNB_THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  const float* dr = dxln + (size_t)row * K;
  float s = 0.f;
  for (int k = lane * VW; k < K; k += 32 * VW) {
    const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(xr + k);
#pragma unroll
    for (int e = 0; e < VW; ++e) s += to_f(v.v[e]);
  }
  const float mean = warp_sum(s) / K;
  float ss = 0.f;
  for (int k = lane * VW; k < K; k += 32 * VW) {
    const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(xr + k);
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float d = to_f(v.v[e]) - mean;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / K + 1e-5f);
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane * VW; k < K; k += 32 * VW) {
    const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(xr + k);
    const Vec<T, VW> gm = *reinterpret_cast<const Vec<T, VW>*>(gamma + k);
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float dn = dr[k + e] * to_f(gm.v[e]);
      s1 += dn;
      s2 += dn * ((to_f(v.v[e]) - mean) * rstd);
    }
  }
  const float m1 = warp_sum(s1) / K, m2 = warp_sum(s2) / K;
  for (int k = lane * VW; k < K; k += 32 * VW) {
    const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(xr + k);
    const Vec<T, VW> gm = *reinterpret_cast<const Vec<T, VW>*>(gamma + k);
    const Vec<T, VW> gv = *reinterpret_cast<const Vec<T, VW>*>(g + (size_t)row * K + k);
    Vec<T, VW> o;
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float normed = (to_f(v.v[e]) - mean) * rstd;
      const float dn = dr[k + e] * to_f(gm.v[e]);
      const float dx = rstd * (dn - m1 - normed * m2);
      o.v[e] = from_f<T>(to_f(gv.v[e]) + to_f(from_f<T>(dx)));
    }
    *reinterpret_cast<Vec<T, VW>*>(out + (size_t)row * K + k) = o;
  }
}

// ---------------------------------------------------------------------------
// Attention-backward core of K3: qkv [B, L, 3D] and dattn [B, L, D] (the
// cotangent of the head-merged attention output) in, dqkv [B, L, 3D] out in
// the forward's packing (q heads | k heads | v heads).
// ---------------------------------------------------------------------------
constexpr int AB_THREADS = 256, AB_ROWS = 4;

// Shared-memory layout of one (head, prompt): Q, K, V, dO as T with a row
// stride that is an odd number of 32-bit words (no bank conflicts down a
// column), then two fp32 [L, L + 1] matrices.
template <typename T>
struct AttnBwdLayout {
  int ldt, ldp;
  size_t off_p, off_ds, bytes;
  __host__ __device__ AttnBwdLayout(int L, int Dh) {
    ldt = sizeof(T) == 4 ? Dh + 1 : Dh + 2;
    ldp = L + 1;
    off_p = align_up((size_t)4 * L * ldt * sizeof(T), 16);
    off_ds = off_p + (size_t)L * ldp * sizeof(float);
    bytes = off_ds + (size_t)L * ldp * sizeof(float);
  }
};

template <typename T>
__global__ void __launch_bounds__(AB_THREADS)
    attn_bwd_core_kernel(const T* __restrict__ qkv, const T* __restrict__ dattn,
                         const float* __restrict__ mask, T* __restrict__ dqkv, int L, int D,
                         int Dh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnBwdLayout<T> lay(L, Dh);
  const int ldt = lay.ldt, ldp = lay.ldp;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + L * ldt;
  T* Vs = Ks + L * ldt;
  T* Os = Vs + L * ldt;
  float* P = reinterpret_cast<float*>(smem + lay.off_p);    // scores, then probs
  float* DS = reinterpret_cast<float*>(smem + lay.off_ds);  // dP, then dS
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const T* dbase = dattn + (size_t)b * L * D + (size_t)h * Dh;

  constexpr int VW = 16 / sizeof(T);
  const int cpr = Dh / VW;  // 16-byte chunks per row (Dh is a multiple of 8)
  for (int idx = tid; idx < L * cpr; idx += AB_THREADS) {
    const int r = idx / cpr, c = (idx % cpr) * VW;
    const Vec<T, VW> q = *reinterpret_cast<const Vec<T, VW>*>(base + r * rs + c);
    const Vec<T, VW> k = *reinterpret_cast<const Vec<T, VW>*>(base + r * rs + D + c);
    const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(base + r * rs + 2 * D + c);
    const Vec<T, VW> o = *reinterpret_cast<const Vec<T, VW>*>(dbase + (size_t)r * D + c);
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      Qs[r * ldt + c + e] = q.v[e];
      Ks[r * ldt + c + e] = k.v[e];
      Vs[r * ldt + c + e] = v.v[e];
      Os[r * ldt + c + e] = o.v[e];
    }
  }
  __syncthreads();

  // scores = q k^T * scale + mask and dP = dO v^T, fp32; each thread takes
  // AB_ROWS queries of one key column
  const int ntile = ceil_div(L, AB_ROWS);
  for (int idx = tid; idx < ntile * L; idx += AB_THREADS) {
    const int i0 = (idx / L) * AB_ROWS, j = idx % L;
    int ii[AB_ROWS];
    float s[AB_ROWS], dp[AB_ROWS];
#pragma unroll
    for (int r = 0; r < AB_ROWS; ++r) {
      ii[r] = min(i0 + r, L - 1) * ldt;
      s[r] = 0.f;
      dp[r] = 0.f;
    }
    for (int d = 0; d < Dh; ++d) {
      const float kf = to_f(Ks[j * ldt + d]), vf = to_f(Vs[j * ldt + d]);
#pragma unroll
      for (int r = 0; r < AB_ROWS; ++r) {
        s[r] = fmaf(to_f(Qs[ii[r] + d]), kf, s[r]);
        dp[r] = fmaf(to_f(Os[ii[r] + d]), vf, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < AB_ROWS; ++r) {
      const int i = i0 + r;
      if (i < L) {
        float sc = s[r] * scale;
        if (mask) sc += mask[(size_t)i * L + j];
        P[i * ldp + j] = sc;
        DS[i * ldp + j] = dp[r];
      }
    }
  }
  __syncthreads();

  // per query row: probs = softmax(scores) in fp32 (a masked entry's -inf
  // gives exactly 0), dS = T(probs * (dP - sum(dP * probs)) * scale); the
  // probs are left rounded to T, as the dV product takes them
  for (int i = warp; i < L; i += AB_THREADS / 32) {
    float* prow = P + i * ldp;
    float* drow = DS + i * ldp;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, prow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = prow[j] / sum;
      prow[j] = p;
      delta += drow[j] * p;
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32) {
      const float p = prow[j];
      const float ds = p * (drow[j] - delta) * scale;
      drow[j] = to_f(from_f<T>(ds));
      prow[j] = to_f(from_f<T>(p));
    }
  }
  __syncthreads();

  T* obase = dqkv + (size_t)b * L * rs + (size_t)h * Dh;
  // dq = dS k: each thread takes AB_ROWS queries of one feature column
  for (int idx = tid; idx < ntile * Dh; idx += AB_THREADS) {
    const int i0 = (idx / Dh) * AB_ROWS, d = idx % Dh;
    int ii[AB_ROWS];
    float acc[AB_ROWS];
#pragma unroll
    for (int r = 0; r < AB_ROWS; ++r) {
      ii[r] = min(i0 + r, L - 1) * ldp;
      acc[r] = 0.f;
    }
    for (int j = 0; j < L; ++j) {
      const float kf = to_f(Ks[j * ldt + d]);
#pragma unroll
      for (int r = 0; r < AB_ROWS; ++r) acc[r] = fmaf(DS[ii[r] + j], kf, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < AB_ROWS; ++r)
      if (i0 + r < L) obase[(size_t)(i0 + r) * rs + d] = from_f<T>(acc[r]);
  }
  // dk = dS^T q and dv = probs^T dO: sums over the queries, all in this
  // block; each thread takes AB_ROWS keys of one feature column
  for (int idx = tid; idx < ntile * Dh; idx += AB_THREADS) {
    const int j0 = (idx / Dh) * AB_ROWS, d = idx % Dh;
    int jj[AB_ROWS];
    float ak[AB_ROWS], av[AB_ROWS];
#pragma unroll
    for (int r = 0; r < AB_ROWS; ++r) {
      jj[r] = min(j0 + r, L - 1);
      ak[r] = 0.f;
      av[r] = 0.f;
    }
    for (int i = 0; i < L; ++i) {
      const float qf = to_f(Qs[i * ldt + d]), of = to_f(Os[i * ldt + d]);
#pragma unroll
      for (int r = 0; r < AB_ROWS; ++r) {
        ak[r] = fmaf(DS[i * ldp + jj[r]], qf, ak[r]);
        av[r] = fmaf(P[i * ldp + jj[r]], of, av[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < AB_ROWS; ++r) {
      if (j0 + r < L) {
        obase[(size_t)(j0 + r) * rs + D + d] = from_f<T>(ak[r]);
        obase[(size_t)(j0 + r) * rs + 2 * D + d] = from_f<T>(av[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------
template <typename T>
static cudaError_t launch_bwd_gemm(const void* A, const void* W, const void* bias,
                                   const void* aux, void* C, int M, int N, int K, int epi,
                                   cudaStream_t st) {
  switch (epi) {
    case EPI_BIAS_F32:
      if (!bias) return cudaErrorInvalidValue;
      launch_gemm<T, false, EPI_BIAS_F32>(A, W, bias, aux, C, M, N, K, st);
      break;
    case EPI_CAST: launch_gemm<T, true, EPI_CAST>(A, W, bias, aux, C, M, N, K, st); break;
    case EPI_GELU_GRAD:
      if (!aux) return cudaErrorInvalidValue;
      launch_gemm<T, true, EPI_GELU_GRAD>(A, W, bias, aux, C, M, N, K, st);
      break;
    case EPI_F32: launch_gemm<T, true, EPI_F32>(A, W, bias, aux, C, M, N, K, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T>
static void launch_ln_bwd(const void* x, const void* dxln, const void* g, const void* gamma,
                          void* out, int M, int K, cudaStream_t st) {
  ln_bwd_kernel<T><<<ceil_div(M, LNB_THREADS / 32), LNB_THREADS, 0, st>>>(
      (const T*)x, (const float*)dxln, (const T*)g, (const T*)gamma, (T*)out, M, K);
}

template <typename T>
static cudaError_t launch_attn_bwd_core(const void* qkv, const void* dattn, const float* mask,
                                        void* dqkv, int B, int L, int D, int H,
                                        cudaStream_t st) {
  const int Dh = D / H;
  const AttnBwdLayout<T> lay(L, Dh);
  if (lay.bytes > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_core_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_core_kernel<T><<<dim3(H, B), AB_THREADS, lay.bytes, st>>>(
      (const T*)qkv, (const T*)dattn, mask, (T*)dqkv, L, D, Dh,
      (float)(1.0 / sqrt((double)Dh)));
  return cudaSuccess;
}

}  // namespace ovmr

using namespace ovmr;

// C = epilogue(A @ op(W)) for the backward halves. epilogue 3: op(W) = W
// [K, N], C = fp32(acc + bias). epilogues 4-6: op(W) = W^T with W stored
// [N, K]; 4: C = T(acc); 5: C = T(acc * QuickGELU'(aux)), aux fp32 [M, N];
// 6: C = fp32(acc)
OVMR_EXPORT int ovmr_gemm_bwd(int dtype, const void* A, const void* W, const void* bias,
                              const void* aux, void* C, int M, int N, int K, int epilogue,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case DT_F32: err = launch_bwd_gemm<float>(A, W, bias, aux, C, M, N, K, epilogue, st); break;
    case DT_BF16:
      err = launch_bwd_gemm<__nv_bfloat16>(A, W, bias, aux, C, M, N, K, epilogue, st);
      break;
    case DT_F16: err = launch_bwd_gemm<__half>(A, W, bias, aux, C, M, N, K, epilogue, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out = g + T(LayerNorm input cotangent of dxln at x), rows of [M, K];
// dxln is fp32, everything else in x's dtype
OVMR_EXPORT int ovmr_ln_bwd(int dtype, const void* x, const void* dxln, const void* g,
                            const void* gamma, void* out, int M, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: launch_ln_bwd<float>(x, dxln, g, gamma, out, M, K, st); break;
    case DT_BF16: launch_ln_bwd<__nv_bfloat16>(x, dxln, g, gamma, out, M, K, st); break;
    case DT_F16: launch_ln_bwd<__half>(x, dxln, g, gamma, out, M, K, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

OVMR_EXPORT int ovmr_attn_bwd_core(int dtype, const void* qkv, const void* dattn,
                                   const void* mask, void* dqkv, int B, int L, int D, int H,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  cudaError_t err;
  switch (dtype) {
    case DT_F32: err = launch_attn_bwd_core<float>(qkv, dattn, m, dqkv, B, L, D, H, st); break;
    case DT_BF16:
      err = launch_attn_bwd_core<__nv_bfloat16>(qkv, dattn, m, dqkv, B, L, D, H, st);
      break;
    case DT_F16: err = launch_attn_bwd_core<__half>(qkv, dattn, m, dqkv, B, L, D, H, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
