// Hopper kernel for standalone attention over [B, H, L, Dh].
//
// Replaces the TPU kernel ovmr_tpu/ops/attention.py fused_attention
// (_attn_kernel :28, _attn_kernel_masked :43): softmax(q k^T * scale +
// mask) v with Q and K upcast to fp32 before the score product (:30-31),
// an fp32 softmax, the probabilities cast to v's dtype, and the p.v product
// accumulated in fp32.
//
// On the serving path it runs the aggregator's attention: [N, D/64,
// n_ctx + K, 64], e.g. L = 18. What bounds it on the H100: 4*L*L*Dh FLOP
// per (batch, head) against 4*L*Dh*itemsize bytes is ~9 FLOP/byte at L = 18,
// far below the ~295 FLOP/byte ridge, so it is bound by bytes moved (and
// at serving sizes, by launch latency). Design: one block per (batch x
// head) reads its Q, K, V once into shared memory (as fp32), keeps the
// [L, L] scores there, and writes the output once; the products are plain
// fp32 FMA, as the TPU kernel's fp32 Q.K^T asks.
#include "common.cuh"

namespace ovmr {

constexpr int K6_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(K6_THREADS)
    fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ mask,
                           T* __restrict__ out, int L, int Dh, float scale) {
  constexpr int NW = K6_THREADS / 32;
  extern __shared__ float sm[];
  const int ld = Dh + 1, lds = L + 1;
  float* Qs = sm;
  float* Ks = Qs + L * ld;
  float* Vs = Ks + L * ld;
  float* S = Vs + L * ld;
  const size_t base = (size_t)blockIdx.x * L * Dh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int idx = tid; idx < L * Dh; idx += K6_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    Qs[r * ld + d] = to_f(q[base + idx]) * scale;
    Ks[r * ld + d] = to_f(k[base + idx]);
    Vs[r * ld + d] = to_f(v[base + idx]);
  }
  __syncthreads();

  for (int idx = tid; idx < L * L; idx += K6_THREADS) {
    const int i = idx / L, j = idx % L;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s = fmaf(Qs[i * ld + d], Ks[j * ld + d], s);
    if (mask) s += mask[idx];
    S[i * lds + j] = s;
  }
  __syncthreads();

  for (int i = warp; i < L; i += NW) {
    float* srow = S + i * lds;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // probs.astype(v.dtype)
    for (int j = lane; j < L; j += 32) srow[j] = to_f(from_f<T>(srow[j] / sum));
  }
  __syncthreads();

  for (int idx = tid; idx < L * Dh; idx += K6_THREADS) {
    const int i = idx / Dh, d = idx % Dh;
    float o = 0.f;
    for (int j = 0; j < L; ++j) o = fmaf(S[i * lds + j], Vs[j * ld + d], o);
    out[base + idx] = from_f<T>(o);
  }
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, const float* mask,
                          void* out, int BH, int L, int Dh, cudaStream_t st) {
  const size_t bytes = (size_t)(3 * L * (Dh + 1) + L * (L + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  fused_attention_kernel<T><<<BH, K6_THREADS, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, L, Dh,
      (float)(1.0 / sqrt((double)Dh)));
  return cudaSuccess;
}

}  // namespace ovmr

using namespace ovmr;

OVMR_EXPORT int ovmr_fused_attention(int dtype, const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int BH, int L, int Dh,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  cudaError_t err;
  switch (dtype) {
    case DT_F32: err = launch<float>(q, k, v, m, out, BH, L, Dh, st); break;
    case DT_BF16: err = launch<__nv_bfloat16>(q, k, v, m, out, BH, L, Dh, st); break;
    case DT_F16: err = launch<__half>(q, k, v, m, out, BH, L, Dh, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
