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
// 256, ~50 us) and lets every GEMM stage both tiles with TMA or cp.async.
//
// The GEMMs. K2 and K5 are LayerNorm plus two products of 4 B L D hidden
// FLOP in all (4.96 TFLOP for K5 at ViT-L/14@336px and 512 images, 5 ms at
// the card's peak) against a few GB of activations: bound by tensor-core
// issue; so are K1's QKV (1.86 TFLOP at the same shape) and out-proj, and
// K7's four products and K8's two. In bf16/fp16 the products of K1, K2,
// K5, K7 and K8 (and K3's recompute of K1's QKV) run on the wgmma/TMA GEMM
// (gemm_wgmma.cuh, ovmr_gemm_wgmma): a TMA-fed mbarrier ring, two consumer
// warpgroups issuing wgmma on a 128 x 128 tile, the epilogue on the
// accumulator registers. fp32 products are plain FMA on gemm.cuh's kernel
// (ovmr_gemm; TF32 would break the 1e-5 fp32 tolerance). Both add the bias
// in fp32 and apply the activation or the residual in the epilogue, with
// the same rounding.
//
// The attention core (ovmr_attn_core; K1 at width D, K7 at the shard's
// width dl). In bf16/fp16 one register-resident core serves every sequence
// length and head width (a multiple of 8 up to 128; the kernel zero-pads to
// 64 or 128). At ViT-L/14@336px and 512 images its function is 0.70 TFLOP
// against 2.4 GB of q/k/v/out (0.71 and 0.72 ms at the card's peaks): the
// tensor cores and the memory bound it alike, so the scores and probs must
// not make shared-memory round trips or wait on scalar softmax. A block
// of 8 warps takes 128 queries of one head, each warp 16 rows; Q sits in
// registers as mma.sync A fragments; K and V stream in tiles of 64 keys
// through a 3-stage cp.async ring; the scores of a 16 x 64 tile live in the
// m16n8k16 accumulators, where each thread holds two rows and a row's
// reductions stay within a quad. Two passes over the key tiles: the first
// keeps each thread's running maximum and sum of its columns (the sum
// rescaled when the maximum grows), merged across the quad at the end; the
// second recomputes the scores and forms exp(s - max) / sum in fp32 (times
// the row's reciprocal sum), cast straight into the A fragments of
// probs x V. An online-softmax core would make one pass but round
// unnormalised probs; two passes keep K1's rounding (normalised probs cast
// before probs x V) at the price of a second q . k product, 1.5x the
// function's tensor work. The fp32 cores are plain FMA
// (TF32 would break the 1e-5 fp32 tolerance): up to a head's K and V in
// shared memory, one block per 64 queries holds them and the tile's whole
// score rows; beyond, the keys are walked in tiles of 64 in the same two
// passes.
//
// Rounding follows the TPU kernel's contract (block_fused.py:68-149): the
// LN output is cast to the activation dtype before the QKV / c_fc product;
// qkv is cast after its bias; scores are scaled after the fp32 product; the
// mask is added before an fp32 softmax; probs and each head's output are
// cast; the projection is cast before the residual add in the activation
// dtype; QuickGELU runs in fp32 and is then cast.
#include "gemm.cuh"
#include "gemm_wgmma.cuh"
#include "mma_frag.cuh"

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

// ---------------------------------------------------------------------------
// bf16/fp16: the register-resident core (see the header). One block of
// AC_WARPS warps per (query tile of AC_QT rows, head, image); warp w owns
// query rows q0 + 16 w .. + 15. The keys stream in tiles of AC_KT through a
// ring of AC_STAGES shared-memory stages (cp.async): pass 1 copies K tiles,
// pass 2 K and V tiles. Products are mma.sync m16n8k16 with fp32
// accumulation: Q (A fragments, by ldmatrix once) . K^T (B, by ldmatrix)
// into scores that stay in the accumulator registers; the cast probs
// re-enter as A fragments from those registers; V is the B operand by
// ldmatrix.trans.
// ---------------------------------------------------------------------------
constexpr int AC_WARPS = 8, AC_QT = 16 * AC_WARPS, AC_KT = 64, AC_STAGES = 3;
constexpr float AC_LOG2E = 1.4426950408889634f;

// Shared memory at padded head width dhp: the query tile (each warp's rows
// later stage its output) and the K/V ring. A row is dhp + 8 elements, so
// the eight 16-byte rows one ldmatrix reads fall in distinct banks.
__host__ __device__ constexpr size_t attn_core_smem(int dhp) {
  return (size_t)(AC_QT + AC_STAGES * 2 * AC_KT) * (dhp + 8) * 2;
}

// Registers (PTX m16n8k16 layouts, lane = 4 gid + tig): score tile sc[j]
// holds keys j*8 + 2 tig + {0, 1} of the warp's rows gid (sc[j][0..1]) and
// gid + 8 (sc[j][2..3]), so a row's reductions stay within a quad; the A
// fragment of keys 16 t .. 16 t + 15 is sc[2t][0..1], sc[2t][2..3],
// sc[2t+1][0..1], sc[2t+1][2..3], each pair cast and packed.
template <typename T, int DHP, bool MASKED>
__global__ void __launch_bounds__(AC_WARPS * 32, DHP <= 64 ? 2 : 1)
    attn_core_mma_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                         T* __restrict__ out, int L, int W, int Dh, float scale) {
  constexpr int LD = DHP + 8, TILE = AC_KT * LD, CPR = DHP / 8, THREADS = AC_WARPS * 32;
  constexpr int NT = AC_KT / 8, KD = DHP / 16, DT = DHP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = Qs + AC_QT * LD;  // stage s: a K tile, then a V tile

  const int q0 = blockIdx.x * AC_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t rs = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const int nkt = ceil_div(L, AC_KT), nsteps = 2 * nkt;

  // step s < nkt: pass 1 over key tile s (K); else pass 2 over tile s - nkt
  // (K and V); rows past L and columns past Dh are zero-filled
  auto load_step = [&](int s) {
    const bool pass2 = s >= nkt;
    const int k0 = (pass2 ? s - nkt : s) * AC_KT;
    T* Kst = ring + (s % AC_STAGES) * 2 * TILE;
    for (int idx = tid; idx < AC_KT * CPR; idx += THREADS) {
      const int r = idx / CPR, c8 = (idx % CPR) * 8;
      const bool ok = k0 + r < L && c8 < Dh;
      const T* row = ok ? base + (size_t)(k0 + r) * rs + c8 : base;
      cp_async16(Kst + r * LD + c8, ok ? row + W : base, ok);
      if (pass2) cp_async16(Kst + TILE + r * LD + c8, ok ? row + 2 * W : base, ok);
    }
  };
  for (int idx = tid; idx < AC_QT * CPR; idx += THREADS) {
    const int r = idx / CPR, c8 = (idx % CPR) * 8;
    const bool ok = q0 + r < L && c8 < Dh;
    cp_async16(Qs + r * LD + c8, ok ? base + (size_t)(q0 + r) * rs + c8 : base, ok);
  }
  load_step(0);  // in Q's group
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < AC_STAGES - 1; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }

  const int qw = q0 + warp * 16;
  const bool active = qw < L;  // an idle warp still copies and meets the barriers
  // the mask rows of gid and gid + 8 (a row past L reads row L - 1, unstored)
  const float* mrow0 = MASKED ? mask + (size_t)min(qw + gid, L - 1) * L : nullptr;
  const float* mrow1 = MASKED ? mask + (size_t)min(qw + gid + 8, L - 1) * L : nullptr;

  uint32_t qa[KD][4];
  float oacc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // rows gid and gid + 8. Pass 1: the running maximum and sum over this
  // thread's columns; pass 2: the row's maximum times log2(e) and 1 / sum
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<AC_STAGES - 2>();
    __syncthreads();  // step s has landed; step s - 1's stage is free to refill
    if (s + AC_STAGES - 1 < nsteps) load_step(s + AC_STAGES - 1);
    cp_async_commit();
    if (!active) continue;

    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const bool pass2 = s >= nkt;
    if (s == nkt) {  // merge the quad's partial statistics into the row's
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = m_r[r];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = m_r[r] == -INFINITY ? 0.f : l_r[r] * exp2f((m_r[r] - m) * AC_LOG2E);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        m_r[r] = m * AC_LOG2E;
        l_r[r] = 1.f / l;
      }
    }
    const int k0 = (pass2 ? s - nkt : s) * AC_KT;
    const T* Ks = ring + (s % AC_STAGES) * 2 * TILE;

    // scores = q . k, fp32, in registers
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        // keys j2*16 + 0..7 | + 8..15 by head columns kk*16 + 0..7 | + 8..15
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_16816<T>(sc[2 * j2], qa[kk], kb[0], kb[1]);
        mma_16816<T>(sc[2 * j2 + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // scaled after the fp32 product, then the fp32 mask; keys past L are -inf
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + j * 8 + tig * 2 + e;
        const bool in = kc < L;
        float v0 = sc[j][e] * scale, v1 = sc[j][2 + e] * scale;
        if (MASKED && in) {
          v0 += __ldg(mrow0 + kc);
          v1 += __ldg(mrow1 + kc);
        }
        sc[j][e] = in ? v0 : -INFINITY;
        sc[j][2 + e] = in ? v1 : -INFINITY;
      }
    }

    if (!pass2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[r];
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        if (mx == -INFINITY) continue;  // none of these columns visible to the row yet
        const float mxl = mx * AC_LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          sum += exp2f(fmaf(sc[j][2 * r], AC_LOG2E, -mxl)) +
                 exp2f(fmaf(sc[j][2 * r + 1], AC_LOG2E, -mxl));
        l_r[r] = l_r[r] * exp2f((m_r[r] - mx) * AC_LOG2E) + sum;
        m_r[r] = mx;
      }
      continue;
    }

    // probs = exp(s - max) / sum in fp32, cast to T straight into A fragments
    uint32_t pa[AC_KT / 16][4];
#pragma unroll
    for (int t = 0; t < AC_KT / 16; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = sc[2 * t + half];
        pa[t][2 * half] = pack2<T>(exp2f(fmaf(c[0], AC_LOG2E, -m_r[0])) * l_r[0],
                                   exp2f(fmaf(c[1], AC_LOG2E, -m_r[0])) * l_r[0]);
        pa[t][2 * half + 1] = pack2<T>(exp2f(fmaf(c[2], AC_LOG2E, -m_r[1])) * l_r[1],
                                       exp2f(fmaf(c[3], AC_LOG2E, -m_r[1])) * l_r[1]);
      }
    }
    // out += probs . v, fp32 accumulation
    const T* Vs = Ks + TILE;
#pragma unroll
    for (int t = 0; t < AC_KT / 16; ++t) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        // keys t*16 + 0..7 | + 8..15 by head columns dp*16 + 0..7 | + 8..15
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vs + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                              (lane >> 4) * 8);
        mma_16816<T>(oacc[2 * dp], pa[t], vb[0], vb[1]);
        mma_16816<T>(oacc[2 * dp + 1], pa[t], vb[2], vb[3]);
      }
    }
  }
  if (!active) return;

  // one cast; the warp's own Q rows stage its tile for 16-byte stores
  T* Os = Qs + warp * 16 * LD;
  asm volatile("" ::: "memory");  // the Q fragments were read before the rows are rewritten
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    *reinterpret_cast<uint32_t*>(Os + gid * LD + n * 8 + tig * 2) =
        pack2<T>(oacc[n][0], oacc[n][1]);
    *reinterpret_cast<uint32_t*>(Os + (gid + 8) * LD + n * 8 + tig * 2) =
        pack2<T>(oacc[n][2], oacc[n][3]);
  }
  __syncwarp();
  T* obase = out + (size_t)b * L * W + (size_t)h * Dh;
  const int opr = Dh / 8;
  for (int idx = lane; idx < 16 * opr; idx += 32) {
    const int r = idx / opr, c8 = (idx % opr) * 8;
    if (qw + r < L)
      *reinterpret_cast<Vec<T, 8>*>(obase + (size_t)(qw + r) * W + c8) =
          *reinterpret_cast<const Vec<T, 8>*>(Os + r * LD + c8);
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
static void launch_fwd_gemm_f32(const void* A, const void* W, const void* bias, const void* R,
                                void* C, int M, int N, int K, int ldw, int ldc, int epi,
                                cudaStream_t st) {
  if (epi == EPI_BIAS_GELU)
    launch_gemm_f32<false, EPI_BIAS_GELU>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else if (epi == EPI_BIAS_RESIDUAL)
    launch_gemm_f32<false, EPI_BIAS_RESIDUAL>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else if (epi == EPI_ACCUM)
    launch_gemm_f32<false, EPI_ACCUM>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else if (epi == EPI_F32)
    launch_gemm_f32<false, EPI_F32>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
  else
    launch_gemm_f32<false, EPI_BIAS>(A, W, bias, R, C, M, N, K, st, ldw, ldc);
}

template <typename T>
static cudaError_t launch_fwd_gemm_wgmma(const void* A, const void* W, const void* bias,
                                         const void* R, void* C, int M, int N, int K, int ldw,
                                         int ldc, int epi, cudaStream_t st) {
#define OVMR_FWD(E) launch_gemm_wgmma<T, E, false>(A, W, bias, R, C, M, N, K, ldw, ldc, st)
  switch (epi) {
    case EPI_BIAS: return OVMR_FWD(EPI_BIAS);
    case EPI_BIAS_GELU: return OVMR_FWD(EPI_BIAS_GELU);
    case EPI_BIAS_RESIDUAL: return OVMR_FWD(EPI_BIAS_RESIDUAL);
    case EPI_F32: return OVMR_FWD(EPI_F32);
    case EPI_ACCUM: return OVMR_FWD(EPI_ACCUM);
    default: return cudaErrorInvalidValue;
  }
#undef OVMR_FWD
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

template <typename T, int DHP, bool MASKED>
static cudaError_t launch_attn_core_mma(const void* qkv, const float* mask, void* out, int B,
                                        int L, int W, int H, cudaStream_t st) {
  constexpr size_t bytes = attn_core_smem(DHP);
  static_assert(bytes <= 227 * 1024, "the core's shared memory exceeds a block's 227 KB");
  auto kernel = attn_core_mma_kernel<T, DHP, MASKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int Dh = W / H;
  dim3 grid(ceil_div(L, AC_QT), H, B);  // query tiles fastest: a head's blocks share its K/V in L2
  kernel<<<grid, AC_WARPS * 32, bytes, st>>>((const T*)qkv, mask, (T*)out, L, W, Dh,
                                             (float)(1.0 / sqrt((double)Dh)));
  return cudaSuccess;
}

// head widths that are a multiple of 8 up to 64 run the 64-wide core, up to
// 128 the 128-wide one (zero-padded inside the kernel)
template <typename T>
static cudaError_t launch_attn_core_tc(const void* qkv, const float* mask, void* out, int B,
                                       int L, int W, int H, cudaStream_t st) {
  const int Dh = W / H;
  if (W % H || Dh % 8 || Dh > 128) return cudaErrorInvalidValue;
  if (Dh <= 64)
    return mask ? launch_attn_core_mma<T, 64, true>(qkv, mask, out, B, L, W, H, st)
                : launch_attn_core_mma<T, 64, false>(qkv, mask, out, B, L, W, H, st);
  return mask ? launch_attn_core_mma<T, 128, true>(qkv, mask, out, B, L, W, H, st)
              : launch_attn_core_mma<T, 128, false>(qkv, mask, out, B, L, W, H, st);
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

// fp32 only (bf16/fp16 products take ovmr_gemm_wgmma): C = epilogue(A @ W
// + bias), W's rows ldw and C's rows ldc elements apart: 0 cast, 1
// QuickGELU then cast, 2 cast then add the residual R, 6 (no bias) the fp32
// sum, 7 (no bias) add to what C holds
OVMR_EXPORT int ovmr_gemm(int dtype, const void* A, const void* W, const void* bias,
                          const void* R, void* C, int M, int N, int K, int ldw, int ldc,
                          int epilogue, void* stream) {
  const bool known = epilogue == EPI_BIAS || epilogue == EPI_BIAS_GELU ||
                     epilogue == EPI_BIAS_RESIDUAL || epilogue == EPI_ACCUM ||
                     epilogue == EPI_F32;
  if (dtype != DT_F32 || !known || (epilogue == EPI_BIAS_RESIDUAL && !R) || ldw < N || ldc < N)
    return (int)cudaErrorInvalidValue;
  launch_fwd_gemm_f32(A, W, bias, R, C, M, N, K, ldw, ldc, epilogue,
                      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// ovmr_gemm's contract for the block halves in bf16/fp16 on the wgmma/TMA
// GEMM (gemm_wgmma.cuh): epilogue 0 (cast), 1 (QuickGELU then cast), 2
// (cast then add the residual R), 6 (no bias; the fp32 sum stored as fp32,
// C is float and ldc counts floats) or 7 (no bias; cast then add to what C
// holds). A bias is given exactly when the epilogue adds one; N, K and ldw
// multiples of 8, A and W 16-byte aligned; ldc even, C, the bias and R
// aligned to a pair of their elements (the epilogue moves column pairs)
OVMR_EXPORT int ovmr_gemm_wgmma(int dtype, const void* A, const void* W, const void* bias,
                                const void* R, void* C, int M, int N, int K, int ldw, int ldc,
                                int epilogue, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = epilogue == EPI_BIAS || epilogue == EPI_BIAS_GELU ||
                     epilogue == EPI_BIAS_RESIDUAL || epilogue == EPI_F32 ||
                     epilogue == EPI_ACCUM;
  const uintptr_t pair = epi_out_f32(epilogue) ? 8 : 4;
  if (!known || epi_has_bias(epilogue) != (bias != nullptr) ||
      (epilogue == EPI_BIAS_RESIDUAL && !R) || N % 8 || K % 8 || ldw % 8 || ldw < N ||
      ldc < N || ldc % 2 || reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(W) % 16 || reinterpret_cast<uintptr_t>(C) % pair ||
      reinterpret_cast<uintptr_t>(bias) % 4 || reinterpret_cast<uintptr_t>(R) % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case DT_BF16:
      err = launch_fwd_gemm_wgmma<__nv_bfloat16>(A, W, bias, R, C, M, N, K, ldw, ldc, epilogue,
                                                 st);
      break;
    case DT_F16:
      err = launch_fwd_gemm_wgmma<__half>(A, W, bias, R, C, M, N, K, ldw, ldc, epilogue, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
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
