// Hopper kernels for the two halves of the CLIP residual block.
//
// Replaces the TPU kernels of ovmr_tpu/ops/block_fused.py:
//   K1 fused_attn_half (_attn_half_kernel :58, _masked_attn_half_kernel :113)
//      x + out_proj(MHA(LN1(x))), packed QKV, optional additive [L, L] mask;
//   K2 fused_mlp_half (_mlp_half_kernel :123)
//      x + c_proj(QuickGELU(c_fc(LN2(x))));
//   K5 fused_mlp_half_chunked (_mlp_half_chunked_kernel :249)
//      the same half with the hidden width taken in chunks: each chunk's
//      partial c_proj product is cast and added to the output in the
//      activation dtype;
// and the per-shard partials of ovmr_tpu/ops/block_fused_tp.py:
//   K7 tp_attn_half_partial (_attn_partial_kernel :179, masked :235)
//      fp32 attn_local(LN1(x)) @ w_out_local over one head shard, no bias and
//      no residual (the caller sums the shards' partials, then adds them);
//   K8 tp_mlp_half_partial (_mlp_partial_kernel :245)
//      fp32 QuickGELU(LN2(x) @ c_fc_local + b_local) @ c_proj_local.
// K7 and K8 are composed by their wrappers (ovmr_tpu_torch/ops/block_fused_tp.py)
// from the launchers below, as K1 and K2 are:
//   K7 = layer_norm -> 3 x gemm(+b_q | +b_k | +b_v), each into its column
//        slice of one [tokens, 3 dl] buffer (the GEMM's ldc) -> attn_core at
//        width dl and the shard's heads -> gemm(EPI_F32, fp32 out)
//   K8 = layer_norm -> gemm(+c_fc_b, QuickGELU) -> gemm(EPI_F32, fp32 out)
// Writing q, k and v into slices of the buffer the attention core reads
// keeps the shard's three weights as they are stored (nothing is packed
// when the shard is placed) and the core unchanged. A shard is half the
// work of K1/K2 at model axis 2 plus an fp32 partial (1.2 GB at ViT-L/14@336px,
// 512 images) written here and read by the sum of the shards.
//
// What bounds them on the H100: at ViT-B/16 batch 256 the products are
// 268 GFLOP (K1) and 476 GFLOP (K2) per layer against ~0.1 GB of
// activations, far above the ~295 FLOP/byte ridge, so both halves are
// bound by tensor-core operations (about 0.27 and 0.48 ms at 989 TFLOP/s).
// So are K7 and K8: a ViT-L/14@336px vision shard at model axis 2 and 512
// images is 1.59 and 2.48 TFLOP (1.61 and 2.51 ms) against 1.8 GB of
// activations and partials (0.54 ms).
//
// Design. The TPU kernels keep a whole tile of images in VMEM (an image's
// QKV alone is 197 x 2304 bf16 = 908 KB, the MLP hidden of a 64-token tile
// 393 KB); 227 KB of shared memory holds neither. So each half is a few
// launches behind one Python wrapper, and the LN output, the QKV, the head
// outputs and the MLP hidden pass through global memory (keeping them
// on-chip is later work):
//   K1 = layer_norm -> gemm(+b_qkv) -> attn_core -> gemm(+b_out, +x)
//   K2 = layer_norm -> gemm(+c_fc_b, QuickGELU) -> gemm(+c_proj_b, +x)
//   K5 = layer_norm -> residual_bias (out = x + c_proj_b), then per chunk j
//        gemm(+c_fc_b[j], QuickGELU) on the column slice c_fc_w[:, j] ->
//        gemm(out += T(.)) on the row slice c_proj_w[j, :]
// K5's hidden buffer is [tokens, hidden / chunks], not [tokens, hidden]: at
// ViT-L/14@336px (577 tokens, width 1024, hidden 4096) and 512 images that
// is 1.2 GB instead of 2.4 GB a layer. The slices are read in place through
// the GEMM's leading dimension; nothing is copied.
// LayerNorm is its own pass: normalizing inside the GEMM's A-tile staging
// made every column block recompute the row statistics and kept A out of
// cp.async; the extra pass moves one activation (77 MB at ViT-B/16 batch
// 256, ~50 us) and lets every GEMM stage both tiles with cp.async. The
// GEMM (gemm.cuh, shared with the backward halves) is one tiled kernel with
// two shared-memory stages; its epilogue adds the bias in fp32 and applies
// the activation or the residual. bf16/fp16 products run on the tensor cores
// through WMMA with fp32 accumulation; fp32 products are plain FMA (TF32
// would break the 1e-5 fp32 tolerance). No TMA or wgmma yet.
//
// Two attention cores, chosen by the launcher from the sequence length:
// - short (L padded to 16 at most 320; fp32: while a head fits in 227 KB):
//   a head's K and V and each 16-query tile's whole fp32 score rows stay in
//   shared memory, and the softmax of a row runs in registers;
// - long (577 tokens at 336 px): a head's K and V (148 KB in bf16) plus a
//   16 x L fp32 score tile per warp do not fit, so the keys are walked in
//   tiles of 64 and shared memory holds a K/V tile (two stages, cp.async)
//   and a 16 x 64 score tile per warp. Two passes over the key tiles: the
//   first takes each row's maximum and sum (rescaling the running sum when
//   the maximum grows), the second recomputes the scores, normalises,
//   casts the probs and multiplies by V. An online-softmax core would make
//   one pass but round unnormalised probs; two passes keep K1's rounding
//   (normalised probs cast before probs x V) at the price of a second
//   q . k product.
//
// Rounding follows the TPU kernel's contract (block_fused.py:68-149): the
// LN output is cast to the activation dtype before the QKV / c_fc product;
// qkv is cast after its bias; scores are scaled after the fp32 product; the
// mask is added before an fp32 softmax; probs and each head's output are
// cast; the projection is cast before the residual add in the activation
// dtype; QuickGELU runs in fp32 and is then cast.
#include "gemm.cuh"

namespace ovmr {

// LayerNorm in fp32 (two-pass, eps 1e-5), cast to the activation dtype:
// y[m] = T((x[m] - mean) * rstd * g + b), one warp per row, 16-byte loads.
// The cast output is what the products consume (block_fused.py:68, :131).
constexpr int LN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ b, T* __restrict__ y, int M, int K) {
  constexpr int VW = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
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
  for (int k = lane * VW; k < K; k += 32 * VW) {
    const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(xr + k);
    const Vec<T, VW> gv = *reinterpret_cast<const Vec<T, VW>*>(g + k);
    const Vec<T, VW> bv = *reinterpret_cast<const Vec<T, VW>*>(b + k);
    Vec<T, VW> o;
#pragma unroll
    for (int e = 0; e < VW; ++e)
      o.v[e] = from_f<T>((to_f(v.v[e]) - mean) * rstd * to_f(gv.v[e]) + to_f(bv.v[e]));
    *reinterpret_cast<Vec<T, VW>*>(y + (size_t)row * K + k) = o;
  }
}

// ---------------------------------------------------------------------------
// Attention core of K1: qkv [B, L, 3D] in, head-merged out [B, L, D].
// ---------------------------------------------------------------------------

// fp32: one block per (query tile of 64, head, image); the head's K and V,
// the tile's Q and its fp32 scores stay in shared memory; plain FMA.
constexpr int AF_QT = 64, AF_THREADS = 128;

__host__ __device__ inline size_t attn_f32_smem(int L, int Dh) {
  return ((size_t)(AF_QT + 2 * L) * (Dh + 1) + (size_t)AF_QT * (L + 1)) * sizeof(float);
}

__global__ void __launch_bounds__(AF_THREADS)
    attn_core_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                         float* __restrict__ out, int L, int D, int Dh, float scale) {
  constexpr int NW = AF_THREADS / 32;
  extern __shared__ float fsm[];
  const int ld = Dh + 1, lds = L + 1;
  float* Qs = fsm;
  float* Ks = Qs + AF_QT * ld;
  float* Vs = Ks + L * ld;
  float* S = Vs + L * ld;
  const int q0 = blockIdx.x * AF_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const int nq = min(AF_QT, L - q0);

  for (int idx = tid; idx < L * Dh; idx += AF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    Ks[r * ld + d] = base[r * rs + D + d];
    Vs[r * ld + d] = base[r * rs + 2 * D + d];
  }
  for (int idx = tid; idx < nq * Dh; idx += AF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    Qs[r * ld + d] = base[(q0 + r) * rs + d];
  }
  __syncthreads();
  for (int idx = tid; idx < nq * L; idx += AF_THREADS) {
    const int r = idx / L, c = idx % L;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s = fmaf(Qs[r * ld + d], Ks[c * ld + d], s);
    S[r * lds + c] = s;
  }
  __syncthreads();
  for (int r = warp; r < nq; r += NW) {  // softmax(scores * scale + mask)
    float* srow = S + r * lds;
    const float* mrow = mask ? mask + (size_t)(q0 + r) * L : nullptr;
    float mx = -INFINITY;
    for (int c = lane; c < L; c += 32) {
      float s = srow[c] * scale;
      if (mrow) s += mrow[c];
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(srow[c] - mx);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < L; c += 32) srow[c] = srow[c] / sum;
  }
  __syncthreads();
  float* obase = out + (size_t)b * L * D + (size_t)h * Dh;
  for (int idx = tid; idx < nq * Dh; idx += AF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    float o = 0.f;
    for (int c = 0; c < L; ++c) o = fmaf(S[r * lds + c], Vs[c * ld + d], o);
    obase[(size_t)(q0 + r) * D + d] = o;
  }
}

// bf16/fp16: one block per (head, image) loads the head's K and V once
// (cp.async, zero-padded to Lp x Dhp, multiples of 16); each warp
// then walks 16-query tiles on its own: Q tile -> fp32 scores by WMMA into
// its private shared memory -> softmax row by row in registers (the probs,
// cast to the activation dtype, overwrite the row's scores in place) ->
// probs . V by WMMA -> cast and store. Only the K/V load needs the block.
constexpr int AT_QT = 16, AT_MAX_WARPS = 8, AT_MAX_COLS = 10;  // Lp <= 320
constexpr int AT_MAX_DT = 8;                                    // Dhp <= 128

template <typename T>
struct AttnTcLayout {
  int ldk, lds;  // K/V and Q rows (elements of T); scores rows (floats)
  size_t off_v, off_warps, off_s, warp_bytes;
  __host__ __device__ AttnTcLayout(int Lp, int Dhp) {
    ldk = Dhp + 8;
    lds = (Lp > Dhp ? Lp : Dhp) + 4;  // the scores double as the output tile
    off_v = align_up((size_t)Lp * ldk * sizeof(T), 128);
    off_warps = align_up(off_v + (size_t)Lp * ldk * sizeof(T), 128);
    off_s = align_up((size_t)AT_QT * ldk * sizeof(T), 128);
    warp_bytes = align_up(off_s + (size_t)AT_QT * lds * sizeof(float), 128);
  }
  __host__ __device__ size_t bytes(int warps) const { return off_warps + warps * warp_bytes; }
};

template <typename T>
__global__ void __launch_bounds__(AT_MAX_WARPS * 32)
    attn_core_tc_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                        T* __restrict__ out, int L, int D, int Dh, int Lp, int Dhp,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnTcLayout<T> lay(Lp, Dhp);
  const int ldk = lay.ldk, lds = lay.lds, ldp = 2 * lay.lds;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + lay.off_v);
  const int nwarps = blockDim.x / 32, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned char* wsm = smem + lay.off_warps + warp * lay.warp_bytes;
  T* Qs = reinterpret_cast<T*>(wsm);
  float* S = reinterpret_cast<float*>(wsm + lay.off_s);
  T* P = reinterpret_cast<T*>(S);  // row r of P overlays row r of S

  const int h = blockIdx.x, b = blockIdx.y;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const int cpr = Dhp / 8;  // 8-element chunks per padded row

  for (int idx = tid; idx < Lp * cpr; idx += blockDim.x) {
    const int r = idx / cpr, c8 = (idx % cpr) * 8;
    const bool ok = r < L && c8 < Dh;
    cp_async16(Ks + r * ldk + c8, ok ? base + r * rs + D + c8 : base, ok);
    cp_async16(Vs + r * ldk + c8, ok ? base + r * rs + 2 * D + c8 : base, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int ntiles = ceil_div(L, AT_QT), tk = Lp / 16, td = Dhp / 16;
  for (int t = warp; t < ntiles; t += nwarps) {
    const int q0 = t * AT_QT;
    for (int idx = lane; idx < AT_QT * cpr; idx += 32) {
      const int r = idx / cpr, c8 = (idx % cpr) * 8;
      const bool ok = q0 + r < L && c8 < Dh;
      cp_async16(Qs + r * ldk + c8, ok ? base + (q0 + r) * rs + c8 : base, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // scores = q . k (fp32 accumulation)
    for (int tj = 0; tj < tk; ++tj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Dhp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + kk, ldk);
        wmma::load_matrix_sync(fb, Ks + tj * 16 * ldk + kk, ldk);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + tj * 16, acc, lds, wmma::mem_row_major);
    }
    __syncwarp();

    // probs = softmax(scores * scale + mask), fp32, cast into P in place
    for (int r = 0; r < AT_QT; ++r) {
      const int q = q0 + r;
      const float* srow = S + r * lds;
      const float* mrow = (mask && q < L) ? mask + (size_t)q * L : nullptr;
      float vals[AT_MAX_COLS];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < AT_MAX_COLS; ++i) {
        const int c = lane + 32 * i;
        float s = -INFINITY;
        if (q < L && c < L) {
          s = srow[c] * scale;
          if (mrow) s += mrow[c];
        }
        vals[i] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < AT_MAX_COLS; ++i) {
        const int c = lane + 32 * i;
        const float e = (q < L && c < L) ? expf(vals[i] - mx) : 0.f;
        vals[i] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      __syncwarp();  // every lane has read the row before it is overwritten
      T* prow = P + r * ldp;
#pragma unroll
      for (int i = 0; i < AT_MAX_COLS; ++i) {
        const int c = lane + 32 * i;
        if (c < Lp) prow[c] = from_f<T>(q < L && c < L ? vals[i] / sum : 0.f);
      }
    }
    __syncwarp();

    // out = probs . v (fp32 accumulation), staged through S, cast per head
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[AT_MAX_DT];
#pragma unroll
    for (int tj = 0; tj < AT_MAX_DT; ++tj)
      if (tj < td) wmma::fill_fragment(acc[tj], 0.f);
    for (int kk = 0; kk < Lp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, P + kk, ldp);
#pragma unroll
      for (int tj = 0; tj < AT_MAX_DT; ++tj) {
        if (tj < td) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Vs + kk * ldk + tj * 16, ldk);
          wmma::mma_sync(acc[tj], fa, fb, acc[tj]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int tj = 0; tj < AT_MAX_DT; ++tj)
      if (tj < td) wmma::store_matrix_sync(S + tj * 16, acc[tj], lds, wmma::mem_row_major);
    __syncwarp();
    T* obase = out + (size_t)b * L * D + (size_t)h * Dh;
    const int opr = Dh / 8;
    for (int idx = lane; idx < AT_QT * opr; idx += 32) {
      const int r = idx / opr, c8 = (idx % opr) * 8;
      if (q0 + r >= L) continue;
      Vec<T, 8> o;
#pragma unroll
      for (int e = 0; e < 8; ++e) o.v[e] = from_f<T>(S[r * lds + c8 + e]);
      *reinterpret_cast<Vec<T, 8>*>(obase + (size_t)(q0 + r) * D + c8) = o;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Long sequences: the keys in tiles of AL_KT, two passes (see the header).
// ---------------------------------------------------------------------------

// fp32: one block per (query tile of 64, head, image). Shared memory holds
// the tile's Q, one K and one V tile, the fp32 output tile, a 64 x 64 score
// tile and each row's running maximum and sum.
constexpr int AL_KT = 64;

__host__ __device__ inline size_t attn_f32_long_smem(int Dh) {
  return ((size_t)(2 * AF_QT + 2 * AL_KT) * (Dh + 1) + (size_t)AF_QT * (AL_KT + 1) +
          2 * AF_QT) * sizeof(float);
}

__global__ void __launch_bounds__(AF_THREADS)
    attn_core_f32_long_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                              float* __restrict__ out, int L, int D, int Dh, float scale) {
  constexpr int NW = AF_THREADS / 32;
  extern __shared__ float fsm[];
  const int ld = Dh + 1, lds = AL_KT + 1;
  float* Qs = fsm;
  float* Os = Qs + AF_QT * ld;
  float* Ks = Os + AF_QT * ld;
  float* Vs = Ks + AL_KT * ld;
  float* S = Vs + AL_KT * ld;
  float* row_max = S + AF_QT * lds;
  float* row_sum = row_max + AF_QT;
  const int q0 = blockIdx.x * AF_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const int nq = min(AF_QT, L - q0);

  for (int idx = tid; idx < nq * Dh; idx += AF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    Qs[r * ld + d] = base[(q0 + r) * rs + d];
    Os[r * ld + d] = 0.f;
  }
  for (int r = tid; r < AF_QT; r += AF_THREADS) {
    row_max[r] = -INFINITY;
    row_sum[r] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < L; k0 += AL_KT) {
      const int nk = min(AL_KT, L - k0);
      __syncthreads();  // the previous tile's readers are done; Q and the stats are written
      for (int idx = tid; idx < nk * Dh; idx += AF_THREADS) {
        const int r = idx / Dh, d = idx % Dh;
        Ks[r * ld + d] = base[(k0 + r) * rs + D + d];
        if (pass == 1) Vs[r * ld + d] = base[(k0 + r) * rs + 2 * D + d];
      }
      __syncthreads();
      for (int idx = tid; idx < nq * nk; idx += AF_THREADS) {
        const int r = idx / nk, c = idx % nk;
        float s = 0.f;
        for (int d = 0; d < Dh; ++d) s = fmaf(Qs[r * ld + d], Ks[c * ld + d], s);
        s *= scale;
        if (mask) s += mask[(size_t)(q0 + r) * L + k0 + c];
        S[r * lds + c] = s;
      }
      __syncthreads();
      for (int r = warp; r < nq; r += NW) {  // a warp owns its rows in both passes
        float* srow = S + r * lds;
        if (pass == 0) {
          float mx = -INFINITY;
          for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, srow[c]);
          const float m_old = row_max[r], m_new = fmaxf(m_old, warp_max(mx));
          float sum = 0.f;
          for (int c = lane; c < nk; c += 32)
            sum += srow[c] == -INFINITY ? 0.f : expf(srow[c] - m_new);
          sum = warp_sum(sum);
          if (lane == 0) {
            row_sum[r] = (m_old == -INFINITY ? 0.f : row_sum[r] * expf(m_old - m_new)) + sum;
            row_max[r] = m_new;
          }
        } else {
          const float m = row_max[r], sum = row_sum[r];
          for (int c = lane; c < nk; c += 32) srow[c] = expf(srow[c] - m) / sum;
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      for (int idx = tid; idx < nq * Dh; idx += AF_THREADS) {
        const int r = idx / Dh, d = idx % Dh;
        float o = Os[r * ld + d];
        for (int c = 0; c < nk; ++c) o = fmaf(S[r * lds + c], Vs[c * ld + d], o);
        Os[r * ld + d] = o;
      }
    }
  }
  // each thread wrote the Os entries it now stores
  float* obase = out + (size_t)b * L * D + (size_t)h * Dh;
  for (int idx = tid; idx < nq * Dh; idx += AF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    obase[(size_t)(q0 + r) * D + d] = Os[r * ld + d];
  }
}

// bf16/fp16: one block per (128 queries, head, image), a warp per 16-query
// tile. The block copies each K tile (second pass: and V tile) into one of
// two stages with cp.async while the warps work on the other. A warp keeps
// its Q tile, a 16 x AL_KT fp32 score tile and the cast probs in its own
// shared memory; lane r holds row r's running maximum and sum.
constexpr int AL_WARPS = 8;

template <typename T>
struct AttnLongLayout {
  int ldk, lds, ldp;  // K/V and Q rows, probs rows (elements of T); scores rows (floats)
  size_t kv_stage, off_v, off_warps, off_s, off_p, warp_bytes;
  __host__ __device__ explicit AttnLongLayout(int Dhp) {
    ldk = Dhp + 8;
    lds = (AL_KT > Dhp ? AL_KT : Dhp) + 4;  // the scores double as the output tile
    ldp = AL_KT + 8;
    kv_stage = align_up((size_t)AL_KT * ldk * sizeof(T), 128);
    off_v = 2 * kv_stage;
    off_warps = 4 * kv_stage;
    off_s = align_up((size_t)AT_QT * ldk * sizeof(T), 128);
    off_p = off_s + align_up((size_t)AT_QT * lds * sizeof(float), 128);
    warp_bytes = off_p + align_up((size_t)AT_QT * ldp * sizeof(T), 128);
  }
  __host__ __device__ size_t bytes() const { return off_warps + AL_WARPS * warp_bytes; }
};

// start copying rows k0 .. k0 + AL_KT of one operand (src points at row 0's
// first column of this head) into a stage, zero-filled past L and Dh
template <typename T>
__device__ __forceinline__ void copy_kv_tile_async(T* dst, const T* src, size_t rs, int k0,
                                                   int L, int Dh, int cpr, int ldk) {
  for (int idx = threadIdx.x; idx < AL_KT * cpr; idx += AL_WARPS * 32) {
    const int r = idx / cpr, c8 = (idx % cpr) * 8;
    const bool ok = k0 + r < L && c8 < Dh;
    cp_async16(dst + r * ldk + c8, ok ? src + (size_t)(k0 + r) * rs + c8 : src, ok);
  }
}

template <typename T, int MAX_DT>
__global__ void __launch_bounds__(AL_WARPS * 32)
    attn_core_tc_long_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                             T* __restrict__ out, int L, int D, int Dh, int Dhp, float scale) {
  constexpr int COLS = AL_KT / 32;  // score columns a lane holds of one row
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnLongLayout<T> lay(Dhp);
  const int ldk = lay.ldk, lds = lay.lds, ldp = lay.ldp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned char* wsm = smem + lay.off_warps + warp * lay.warp_bytes;
  T* Qs = reinterpret_cast<T*>(wsm);
  float* S = reinterpret_cast<float*>(wsm + lay.off_s);
  T* P = reinterpret_cast<T*>(wsm + lay.off_p);

  const int q0 = (blockIdx.x * AL_WARPS + warp) * AT_QT, h = blockIdx.y, b = blockIdx.z;
  const bool active = q0 < L;  // an idle warp still copies K/V and meets the barriers
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const int cpr = Dhp / 8, td = Dhp / 16, nkt = ceil_div(L, AL_KT);

  if (active) {
    for (int idx = lane; idx < AT_QT * cpr; idx += 32) {
      const int r = idx / cpr, c8 = (idx % cpr) * 8;
      const bool ok = q0 + r < L && c8 < Dh;
      cp_async16(Qs + r * ldk + c8, ok ? base + (size_t)(q0 + r) * rs + c8 : base, ok);
    }
  }  // committed with the first K tile

  float m_own = -INFINITY, l_own = 0.f;  // of row `lane` (lanes 0..15)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[MAX_DT];
#pragma unroll
  for (int tj = 0; tj < MAX_DT; ++tj) wmma::fill_fragment(oacc[tj], 0.f);

  for (int pass = 0; pass < 2; ++pass) {
    auto copy_stage = [&](int kt) {
      const int st = kt & 1;
      T* Kst = reinterpret_cast<T*>(smem + st * lay.kv_stage);
      copy_kv_tile_async(Kst, base + D, rs, kt * AL_KT, L, Dh, cpr, ldk);
      if (pass == 1) {
        T* Vst = reinterpret_cast<T*>(smem + lay.off_v + st * lay.kv_stage);
        copy_kv_tile_async(Vst, base + 2 * D, rs, kt * AL_KT, L, Dh, cpr, ldk);
      }
      cp_async_commit();
    };
    copy_stage(0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int st = kt & 1, k0 = kt * AL_KT;
      // the other stage was last read before the previous barrier: safe to fill
      if (kt + 1 < nkt) {
        copy_stage(kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const T* Ks = reinterpret_cast<const T*>(smem + st * lay.kv_stage);
        const T* Vs = reinterpret_cast<const T*>(smem + lay.off_v + st * lay.kv_stage);
        // scores = q . k (fp32 accumulation)
        for (int tj = 0; tj < AL_KT / 16; ++tj) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.f);
          for (int kk = 0; kk < Dhp; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, Qs + kk, ldk);
            wmma::load_matrix_sync(fb, Ks + tj * 16 * ldk + kk, ldk);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(S + tj * 16, acc, lds, wmma::mem_row_major);
        }
        __syncwarp();
#pragma unroll 4
        for (int r = 0; r < AT_QT; ++r) {
          const int q = q0 + r;
          const float* srow = S + r * lds;
          const float* mrow = (mask && q < L) ? mask + (size_t)q * L + k0 : nullptr;
          float vals[COLS];
          bool ok[COLS];
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < COLS; ++i) {
            const int c = lane + 32 * i;
            ok[i] = q < L && k0 + c < L;
            float s = -INFINITY;
            if (ok[i]) {
              s = srow[c] * scale;
              if (mrow) s += mrow[c];
            }
            vals[i] = s;
            mx = fmaxf(mx, s);
          }
          if (pass == 0) {
            const float m_old = __shfl_sync(0xffffffffu, m_own, r);
            const float l_old = __shfl_sync(0xffffffffu, l_own, r);
            const float m_new = fmaxf(m_old, warp_max(mx));
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < COLS; ++i)
              sum += vals[i] == -INFINITY ? 0.f : expf(vals[i] - m_new);
            sum = warp_sum(sum);
            if (lane == r) {
              l_own = (m_old == -INFINITY ? 0.f : l_old * expf(m_old - m_new)) + sum;
              m_own = m_new;
            }
          } else {
            // probs = exp(scores - max) / sum, cast to the activation dtype
            const float m = __shfl_sync(0xffffffffu, m_own, r);
            const float l = __shfl_sync(0xffffffffu, l_own, r);
#pragma unroll
            for (int i = 0; i < COLS; ++i)
              P[r * ldp + lane + 32 * i] = from_f<T>(ok[i] ? expf(vals[i] - m) / l : 0.f);
          }
        }
        if (pass == 1) {
          __syncwarp();
          // out += probs . v (fp32 accumulation)
          for (int kk = 0; kk < AL_KT; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, P + kk, ldp);
#pragma unroll
            for (int tj = 0; tj < MAX_DT; ++tj) {
              if (tj < td) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
                wmma::load_matrix_sync(fb, Vs + kk * ldk + tj * 16, ldk);
                wmma::mma_sync(oacc[tj], fa, fb, oacc[tj]);
              }
            }
          }
        }
        __syncwarp();  // S and P are rewritten by the next tile
      }
      __syncthreads();
    }
  }
  if (!active) return;

  // staged through S, cast per head
#pragma unroll
  for (int tj = 0; tj < MAX_DT; ++tj)
    if (tj < td) wmma::store_matrix_sync(S + tj * 16, oacc[tj], lds, wmma::mem_row_major);
  __syncwarp();
  T* obase = out + (size_t)b * L * D + (size_t)h * Dh;
  const int opr = Dh / 8;
  for (int idx = lane; idx < AT_QT * opr; idx += 32) {
    const int r = idx / opr, c8 = (idx % opr) * 8;
    if (q0 + r >= L) continue;
    Vec<T, 8> o;
#pragma unroll
    for (int e = 0; e < 8; ++e) o.v[e] = from_f<T>(S[r * lds + c8 + e]);
    *reinterpret_cast<Vec<T, 8>*>(obase + (size_t)(q0 + r) * D + c8) = o;
  }
}

// ---------------------------------------------------------------------------
// K5's first write: out[m, :] = x[m, :] + bias, added in the activation dtype
// ---------------------------------------------------------------------------
constexpr int RB_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(RB_THREADS)
    residual_bias_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                         T* __restrict__ out, size_t total, int N) {
  constexpr int VW = 16 / sizeof(T);
  const size_t at = ((size_t)blockIdx.x * RB_THREADS + threadIdx.x) * VW;
  if (at >= total) return;
  const Vec<T, VW> xv = *reinterpret_cast<const Vec<T, VW>*>(x + at);
  const Vec<T, VW> bv = *reinterpret_cast<const Vec<T, VW>*>(bias + at % N);
  Vec<T, VW> o;
#pragma unroll
  for (int e = 0; e < VW; ++e) o.v[e] = from_f<T>(to_f(xv.v[e]) + to_f(bv.v[e]));
  *reinterpret_cast<Vec<T, VW>*>(out + at) = o;
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------
template <typename T>
static void launch_fwd_gemm(const void* A, const void* W, const void* bias, const void* R,
                            void* C, int M, int N, int K, int ldw, int ldc, int epi,
                            cudaStream_t st) {
  if (epi == EPI_BIAS_GELU)
    launch_gemm<T, false, EPI_BIAS_GELU>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else if (epi == EPI_BIAS_RESIDUAL)
    launch_gemm<T, false, EPI_BIAS_RESIDUAL>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else if (epi == EPI_ACCUM)
    launch_gemm<T, false, EPI_ACCUM>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else if (epi == EPI_F32)
    launch_gemm<T, false, EPI_F32>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else
    launch_gemm<T, false, EPI_BIAS>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
}

template <typename T>
static void launch_residual_bias(const void* x, const void* bias, void* out, int M, int N,
                                 cudaStream_t st) {
  const size_t total = (size_t)M * N, per_block = (size_t)RB_THREADS * (16 / sizeof(T));
  residual_bias_kernel<T><<<(unsigned)((total + per_block - 1) / per_block), RB_THREADS, 0, st>>>(
      (const T*)x, (const T*)bias, (T*)out, total, N);
}

template <typename T>
static void launch_layer_norm(const void* x, const void* g, const void* b, void* y, int M,
                              int K, cudaStream_t st) {
  layer_norm_kernel<T><<<ceil_div(M, LN_THREADS / 32), LN_THREADS, 0, st>>>(
      (const T*)x, (const T*)g, (const T*)b, (T*)y, M, K);
}

static cudaError_t launch_attn_core_f32(const void* qkv, const float* mask, void* out, int B,
                                        int L, int D, int H, cudaStream_t st) {
  const int Dh = D / H;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  const bool whole_head = attn_f32_smem(L, Dh) <= 227 * 1024;
  const size_t bytes = whole_head ? attn_f32_smem(L, Dh) : attn_f32_long_smem(Dh);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = whole_head ? attn_core_f32_kernel : attn_core_f32_long_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(L, AF_QT), H, B);
  kernel<<<grid, AF_THREADS, bytes, st>>>((const float*)qkv, mask, (float*)out, L, D, Dh, scale);
  return cudaSuccess;
}

template <typename T, int MAX_DT>
static cudaError_t launch_attn_core_tc_long(const void* qkv, const float* mask, void* out,
                                            int B, int L, int D, int H, int Dhp,
                                            cudaStream_t st) {
  const AttnLongLayout<T> lay(Dhp);
  cudaError_t err = cudaFuncSetAttribute(attn_core_tc_long_kernel<T, MAX_DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes());
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(L, AL_WARPS * AT_QT), H, B);
  attn_core_tc_long_kernel<T, MAX_DT><<<grid, AL_WARPS * 32, lay.bytes(), st>>>(
      (const T*)qkv, mask, (T*)out, L, D, D / H, Dhp, (float)(1.0 / sqrt((double)(D / H))));
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_attn_core_tc(const void* qkv, const float* mask, void* out, int B,
                                       int L, int D, int H, cudaStream_t st) {
  const int Dh = D / H;
  const int Lp = ceil_div(L, 16) * 16, Dhp = ceil_div(Dh, 16) * 16;
  if (Dhp > 16 * AT_MAX_DT) return cudaErrorInvalidValue;
  if (Lp > 32 * AT_MAX_COLS)  // the score rows outgrow a lane's registers: tile the keys
    return Dhp <= 64 ? launch_attn_core_tc_long<T, 4>(qkv, mask, out, B, L, D, H, Dhp, st)
                     : launch_attn_core_tc_long<T, AT_MAX_DT>(qkv, mask, out, B, L, D, H, Dhp, st);
  const AttnTcLayout<T> lay(Lp, Dhp);
  // a warp per 16-query tile, up to as many as 227 KB of shared memory holds
  int warps = min(AT_MAX_WARPS, ceil_div(L, AT_QT));
  while (warps > 1 && lay.bytes(warps) > 227 * 1024) --warps;
  cudaError_t err = cudaFuncSetAttribute(attn_core_tc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes(warps));
  if (err != cudaSuccess) return err;
  attn_core_tc_kernel<T><<<dim3(H, B), warps * 32, lay.bytes(warps), st>>>(
      (const T*)qkv, mask, (T*)out, L, D, Dh, Lp, Dhp, (float)(1.0 / sqrt((double)Dh)));
  return cudaSuccess;
}

}  // namespace ovmr

using namespace ovmr;

// y = LayerNorm(x; g, b) over the rows of x [M, K], in x's dtype
OVMR_EXPORT int ovmr_layer_norm(int dtype, const void* x, const void* g, const void* b,
                                void* y, int M, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: launch_layer_norm<float>(x, g, b, y, M, K, st); break;
    case DT_BF16: launch_layer_norm<__nv_bfloat16>(x, g, b, y, M, K, st); break;
    case DT_F16: launch_layer_norm<__half>(x, g, b, y, M, K, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// C = epilogue(A @ W + bias), W's rows ldw and C's rows ldc elements apart:
// 0 cast, 1 QuickGELU then cast, 2 cast then add the residual R, 6 (no bias)
// the fp32 sum stored as fp32 (C is float), 7 (no bias) cast then add to
// what C holds
OVMR_EXPORT int ovmr_gemm(int dtype, const void* A, const void* W, const void* bias,
                          const void* R, void* C, int M, int N, int K, int ldw, int ldc,
                          int epilogue, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = epilogue == EPI_BIAS || epilogue == EPI_BIAS_GELU ||
                     epilogue == EPI_BIAS_RESIDUAL || epilogue == EPI_ACCUM ||
                     epilogue == EPI_F32;
  if (!known || (epilogue == EPI_BIAS_RESIDUAL && !R) || ldw < N || ldc < N)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32:
      launch_fwd_gemm<float>(A, W, bias, R, C, M, N, K, ldw, ldc, epilogue, st);
      break;
    case DT_BF16:
      launch_fwd_gemm<__nv_bfloat16>(A, W, bias, R, C, M, N, K, ldw, ldc, epilogue, st);
      break;
    case DT_F16:
      launch_fwd_gemm<__half>(A, W, bias, R, C, M, N, K, ldw, ldc, epilogue, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out = x + bias over the rows of x [M, N], added in x's dtype
OVMR_EXPORT int ovmr_residual_bias(int dtype, const void* x, const void* bias, void* out,
                                   int M, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: launch_residual_bias<float>(x, bias, out, M, N, st); break;
    case DT_BF16: launch_residual_bias<__nv_bfloat16>(x, bias, out, M, N, st); break;
    case DT_F16: launch_residual_bias<__half>(x, bias, out, M, N, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

OVMR_EXPORT int ovmr_attn_core(int dtype, const void* qkv, const void* mask, void* out,
                               int B, int L, int D, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  cudaError_t err;
  switch (dtype) {
    case DT_F32: err = launch_attn_core_f32(qkv, m, out, B, L, D, H, st); break;
    case DT_BF16: err = launch_attn_core_tc<__nv_bfloat16>(qkv, m, out, B, L, D, H, st); break;
    case DT_F16: err = launch_attn_core_tc<__half>(qkv, m, out, B, L, D, H, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
