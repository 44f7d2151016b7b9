// Hopper kernel for standalone attention over [B, H, L, Dh].
//
// Replaces the TPU kernel ovmr_tpu/ops/attention.py fused_attention
// (_attn_kernel :28, _attn_kernel_masked :43): softmax(q k^T * scale +
// mask) v with Q and K upcast to fp32 before the score product (:30-31),
// an fp32 softmax, the probabilities cast to v's dtype, and the p.v product
// accumulated in fp32.
//
// On the serving path it runs the aggregator's attention: [N, D/64,
// n_ctx + K, 64], e.g. [32, 8, 18, 64] at ViT-B/16 and [32, 12, 18, 64] at
// ViT-L/14@336px: 256-384 (batch, head) pairs of 18 tokens. What bounds it
// on the H100: 4*L*L*Dh FLOP per pair against 4*L*Dh*itemsize bytes is ~9
// FLOP/byte at L = 18, far below the ~295 FLOP/byte ridge, and the whole
// call is 0.59 MB (0.0002 ms at 3.35 TB/s). So no bound of the card's is
// near: a call costs the latency of one launch, of one round of loads, and
// of the dependent steps of one head, plus the host's time to issue it,
// which is the larger part (PERF.md).
//
// Design, for that latency. One warp owns one (batch, head) pair, and
// K6_WARPS = 2 warps share a block, so 256 pairs are 128 blocks (one per
// SM of 132) and 384 are 192: every SM takes work and no block waits on a
// block-wide barrier (only __syncwarp). The warp loads its head's Q, K and
// V with 16-byte loads, all of a serving head's in flight at once, and
// keeps them as fp32 in its own shared-memory slice; Q is scaled there, as
// :30 scales it. It then walks the query rows K6_ROWS at a time
// (independent FMA chains that share each K and V load; 18 tokens are
// three groups):
//   - lane j holds the score of key j of each row (L <= 32, one chunk of
//     keys, everything in registers), or of keys j, j + 32, ... in chunks
//     of 32 (L <= 256, K6_MAX_KEYS; the scores stay in registers too); the
//     dot products read Q (broadcast) and K as float4s, K's rows
//     k6_ldk(Dh) floats apart so that the eight lanes of a 16-byte phase
//     hit eight distinct bank quads;
//   - the row max and sum by __shfl_xor_sync butterflies (warp_max /
//     warp_sum's), each round taken for all rows of the group at once so
//     that their shuffles overlap; each probability divided by the sum in
//     fp32 and rounded to v's dtype and back, as the TPU kernel's
//     probs.astype(v.dtype);
//   - P.V: a lane owns output columns lane, lane + 32 (K6_COLS of them a
//     pass; wider heads take more passes) and receives p_j by __shfl_sync,
//     K6_KEYS keys' shuffles and V loads issued ahead of their FMAs.
// The whole-head kernel this replaced gave a pair a block of 4 warps and
// hid these latencies behind 4x the warps; one warp a pair hides them with
// independent chains, and with no branch in its loops: a lane past the
// last key or column reads a clamped, valid index and its result is
// dropped or multiplied by p = 0, and a zero probability is never divided
// (a zero dividend sends IEEE division down its slow path, for the whole
// warp). Every sum runs in the order of the whole-head kernel (the dot
// product over d, the row max and sum per lane over j then the butterfly,
// P.V over j), so the results are bit for bit the same.
// Host side: the block's shared memory (L (2 Dh + k6_ldk(Dh)) floats a
// warp, 29 KB a block at the serving shape) is dynamic; above 48 KB the
// kernel's limit is raised once per instantiation and device, never per
// call, and a block keeps fewer warps where two slices would outgrow
// 227 KB.
#include <atomic>

#include "common.cuh"

namespace ovmr {

constexpr int K6_WARPS = 2;         // (batch, head) pairs a block
constexpr int K6_ROWS = 6;          // query rows a warp takes at once
constexpr int K6_COLS = 2;          // output columns a lane accumulates a pass
constexpr int K6_KEYS = 8;          // keys whose shuffles and V loads go ahead of their FMAs
constexpr int K6_STAGE = 18 * 64;   // elements of q, k, v loaded in one round (a serving head)
constexpr int K6_MAX_KEYS = 256;    // 8 chunks of 32 keys
constexpr size_t K6_SMEM_MAX = 227 * 1024;
constexpr size_t K6_SMEM_DEFAULT = 48 * 1024;

// Floats between two K rows in shared memory. With Dh a multiple of 4 the
// rows are read as float4s: a stride of an odd number of float4s puts 8
// lanes' rows on 8 distinct bank quads. Otherwise they are read as floats:
// an odd stride puts 32 lanes' rows on 32 banks. Q and V rows are Dh apart
// (Q is read by all lanes at one address, V along a row).
__host__ __device__ constexpr int k6_ldk(int Dh) {
  return Dh % 4 ? (Dh | 1) : Dh + ((Dh / 4) % 2 ? 0 : 4);
}

// fp32 Q, K and V of one head
__host__ __device__ constexpr size_t k6_warp_floats(int L, int Dh) {
  return (size_t)L * (2 * Dh + k6_ldk(Dh));
}

// Q (times scale), K and V of one head ([L, Dh], n = L Dh elements) into
// fp32 shared rows. Where Dh is a multiple of the 16-byte vector width, a
// vector never crosses a row: a lane issues all of a round's loads (LOADS
// of each tensor, K6_STAGE elements a round for the warp) before its
// stores, which go out as float4s.
template <typename T>
__device__ __forceinline__ void k6_stage(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, float* Qs, float* Ks,
                                         float* Vs, int L, int Dh, int ldk, float scale,
                                         int lane) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int LOADS = (K6_STAGE + 32 * VW - 1) / (32 * VW);
  const int n = L * Dh;
  if (Dh % VW) {  // element by element
    for (int e = lane; e < n; e += 32) {
      const int r = e / Dh, c = e - r * Dh;
      Qs[e] = to_f(q[e]) * scale;
      Ks[r * ldk + c] = to_f(k[e]);
      Vs[e] = to_f(v[e]);
    }
    return;
  }
  for (int e0 = 0; e0 < n; e0 += 32 * VW * LOADS) {
    Vec<T, VW> tq[LOADS], tk[LOADS], tv[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + (u * 32 + lane) * VW;
      if (e < n) {
        tq[u] = *reinterpret_cast<const Vec<T, VW>*>(q + e);
        tk[u] = *reinterpret_cast<const Vec<T, VW>*>(k + e);
        tv[u] = *reinterpret_cast<const Vec<T, VW>*>(v + e);
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + (u * 32 + lane) * VW;
      if (e < n) {
        const int r = e / Dh, c = e - r * Dh;
#pragma unroll
        for (int w = 0; w < VW; w += 4) {
          *reinterpret_cast<float4*>(Qs + e + w) =
              make_float4(to_f(tq[u].v[w]) * scale, to_f(tq[u].v[w + 1]) * scale,
                          to_f(tq[u].v[w + 2]) * scale, to_f(tq[u].v[w + 3]) * scale);
          *reinterpret_cast<float4*>(Ks + r * ldk + c + w) =
              make_float4(to_f(tk[u].v[w]), to_f(tk[u].v[w + 1]), to_f(tk[u].v[w + 2]),
                          to_f(tk[u].v[w + 3]));
          *reinterpret_cast<float4*>(Vs + e + w) =
              make_float4(to_f(tv[u].v[w]), to_f(tv[u].v[w + 1]), to_f(tv[u].v[w + 2]),
                          to_f(tv[u].v[w + 3]));
        }
      }
    }
  }
}

// acc[r] += q_row[r][d..d+4) . k_j[d..d+4) in order over d, for S steps of
// 4: all S steps' float4 loads are issued before their FMAs
template <int S>
__device__ __forceinline__ void k6_dot4(const float* Qs, const float* kj,
                                        const int (&row)[K6_ROWS], int Dh, int d,
                                        float (&acc)[K6_ROWS]) {
  float4 kd[S], qd[S][K6_ROWS];
#pragma unroll
  for (int u = 0; u < S; ++u) {
    kd[u] = *reinterpret_cast<const float4*>(kj + d + 4 * u);
#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r)
      qd[u][r] = *reinterpret_cast<const float4*>(Qs + row[r] * Dh + d + 4 * u);
  }
#pragma unroll
  for (int u = 0; u < S; ++u) {
#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r) {
      acc[r] = fmaf(qd[u][r].x, kd[u].x, acc[r]);
      acc[r] = fmaf(qd[u][r].y, kd[u].y, acc[r]);
      acc[r] = fmaf(qd[u][r].z, kd[u].z, acc[r]);
      acc[r] = fmaf(qd[u][r].w, kd[u].w, acc[r]);
    }
  }
}

// acc[r] = q_row[r] . k_j over d in order, Q rows Dh apart; V4: float4 reads
// (Dh a multiple of 4), two steps of loads ahead of their FMAs
template <bool V4>
__device__ __forceinline__ void k6_dot(const float* Qs, const float* kj,
                                       const int (&row)[K6_ROWS], int Dh,
                                       float (&acc)[K6_ROWS]) {
  if constexpr (V4) {
    int d = 0;
    for (; d + 8 <= Dh; d += 8) k6_dot4<2>(Qs, kj, row, Dh, d, acc);
    if (d < Dh) k6_dot4<1>(Qs, kj, row, Dh, d, acc);
  } else {
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float kd = kj[d];
#pragma unroll
      for (int r = 0; r < K6_ROWS; ++r) acc[r] = fmaf(Qs[row[r] * Dh + d], kd, acc[r]);
    }
  }
}

// NT chunks of 32 keys: 1 for L <= 32, K6_MAX_KEYS / 32 above; V4: Dh is a
// multiple of 4
template <typename T, int NT, bool V4>
__global__ void __launch_bounds__(K6_WARPS * 32)
    k6_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        T* __restrict__ out, int BH, int L, int Dh, float scale) {
  extern __shared__ float4 sm4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= BH) return;  // whole warps only; nothing below waits on the block
  const int ldk = k6_ldk(Dh);
  float* Qs = reinterpret_cast<float*>(sm4) + warp * k6_warp_floats(L, Dh);
  float* Ks = Qs + L * Dh;
  float* Vs = Ks + L * ldk;
  const size_t base = (size_t)bh * L * Dh;
  k6_stage(q + base, k + base, v + base, Qs, Ks, Vs, L, Dh, ldk, scale, lane);
  __syncwarp();

  for (int i0 = 0; i0 < L; i0 += K6_ROWS) {
    // rows past L repeat row L - 1 and are not stored
    int row[K6_ROWS];
#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r) row[r] = min(i0 + r, L - 1);

    // s[r][t]: the score, then the probability, of key t * 32 + lane in row r
    float s[K6_ROWS][NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = t * 32 + lane;
      float acc[K6_ROWS];
#pragma unroll
      for (int r = 0; r < K6_ROWS; ++r) acc[r] = 0.f;
      if (t * 32 < L) {  // the same for every lane; a lane past L reads key L - 1
        k6_dot<V4>(Qs, Ks + min(j, L - 1) * ldk, row, Dh, acc);
      }
#pragma unroll
      for (int r = 0; r < K6_ROWS; ++r)
        s[r][t] = j >= L ? -INFINITY : mask ? acc[r] + mask[row[r] * L + j] : acc[r];
    }

    // the softmax of each row: the butterfly rounds (warp_max, warp_sum)
    // run across the rows, so that their shuffles overlap
    float mx[K6_ROWS], sum[K6_ROWS];
#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r) {
      mx[r] = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) mx[r] = fmaxf(mx[r], s[r][t]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < K6_ROWS; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    }
#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r) {
      sum[r] = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float e = t * 32 + lane < L ? expf(s[r][t] - mx[r]) : 0.f;
        s[r][t] = e;
        sum[r] += e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < K6_ROWS; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
    }
    // probs.astype(v.dtype). A zero (a key past L, a masked or underflowed
    // score) is not divided: 0 / sum is exactly 0, and a zero dividend
    // sends the IEEE division down its slow path, for the whole warp.
#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float e = s[r][t];
        float num = e != 0.f ? e : 1.f;
        asm("" : "+f"(num));  // so that the select is not folded into the division
        const float prob = to_f(from_f<T>(num / sum[r]));
        s[r][t] = e != 0.f ? prob : 0.f;
      }
    }

    for (int c0 = 0; c0 < Dh; c0 += 32 * K6_COLS) {
      float o[K6_ROWS][K6_COLS];
#pragma unroll
      for (int r = 0; r < K6_ROWS; ++r) {
#pragma unroll
        for (int n = 0; n < K6_COLS; ++n) o[r][n] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t * 32 >= L) break;  // the same for every lane
        // K6_KEYS keys at a time (a block never crosses a chunk): their
        // shuffles and V loads first, then the FMAs in key order. Indices
        // are clamped, not branched on: a key past L reads row L - 1 with
        // p = 0, which adds an exact zero; a column past Dh is not stored.
        const int keys = min(32, L - t * 32);
        for (int j0 = 0; j0 < keys; j0 += K6_KEYS) {
          float p[K6_KEYS][K6_ROWS], vv[K6_KEYS][K6_COLS];
#pragma unroll
          for (int b = 0; b < K6_KEYS; ++b) {
#pragma unroll
            for (int r = 0; r < K6_ROWS; ++r) p[b][r] = __shfl_sync(0xffffffffu, s[r][t], j0 + b);
          }
#pragma unroll
          for (int b = 0; b < K6_KEYS; ++b) {
            const float* vj = Vs + min(t * 32 + j0 + b, L - 1) * Dh;
#pragma unroll
            for (int n = 0; n < K6_COLS; ++n) vv[b][n] = vj[min(c0 + n * 32 + lane, Dh - 1)];
          }
#pragma unroll
          for (int b = 0; b < K6_KEYS; ++b) {
#pragma unroll
            for (int n = 0; n < K6_COLS; ++n) {
#pragma unroll
              for (int r = 0; r < K6_ROWS; ++r) o[r][n] = fmaf(p[b][r], vv[b][n], o[r][n]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < K6_ROWS; ++r) {
        if (i0 + r >= L) break;
        T* orow = out + base + (size_t)(i0 + r) * Dh;
#pragma unroll
        for (int n = 0; n < K6_COLS; ++n) {
          const int c = c0 + n * 32 + lane;
          if (c < Dh) orow[c] = from_f<T>(o[r][n]);
        }
      }
    }
  }
}

// Raise the kernel's dynamic shared-memory limit to K6_SMEM_MAX, once per
// instantiation and device (the attribute is kept by the device's context).
template <typename T, int NT, bool V4>
static cudaError_t allow_large_smem() {
  static std::atomic<unsigned long long> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(k6_attention_kernel<T, NT, V4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K6_SMEM_MAX);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T, int NT, bool V4>
static cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                                 const float* mask, void* out, int BH, int L, int Dh,
                                 cudaStream_t st) {
  const size_t warp_bytes = k6_warp_floats(L, Dh) * sizeof(float);
  int warps = K6_WARPS;
  while (warps > 1 && warps * warp_bytes > K6_SMEM_MAX) --warps;
  const size_t bytes = warps * warp_bytes;
  if (bytes > K6_SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes > K6_SMEM_DEFAULT) {
    const cudaError_t err = allow_large_smem<T, NT, V4>();
    if (err != cudaSuccess) return err;
  }
  k6_attention_kernel<T, NT, V4><<<ceil_div(BH, warps), warps * 32, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, BH, L, Dh,
      (float)(1.0 / sqrt((double)Dh)));
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, const float* mask,
                          void* out, int BH, int L, int Dh, cudaStream_t st) {
  constexpr int NT = K6_MAX_KEYS / 32;
  if (Dh % 4) {
    return L <= 32 ? launch_kernel<T, 1, false>(q, k, v, mask, out, BH, L, Dh, st)
                   : launch_kernel<T, NT, false>(q, k, v, mask, out, BH, L, Dh, st);
  }
  return L <= 32 ? launch_kernel<T, 1, true>(q, k, v, mask, out, BH, L, Dh, st)
                 : launch_kernel<T, NT, true>(q, k, v, mask, out, BH, L, Dh, st);
}

}  // namespace ovmr

using namespace ovmr;

OVMR_EXPORT int ovmr_fused_attention(int dtype, const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int BH, int L, int Dh,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (BH < 1 || L < 1 || L > K6_MAX_KEYS || Dh < 1 ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
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
