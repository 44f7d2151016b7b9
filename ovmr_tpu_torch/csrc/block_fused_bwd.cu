// Hopper kernels for the input cotangents (dx) of the two halves of the
// CLIP residual block: the backward of a tower's blocks (the frozen text
// tower in OVMR's training; any vision tower a caller differentiates).
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
// (93 GFLOP) and K3 about 54 GFLOP of projections plus 3-6 GFLOP of
// attention products, against ~0.4 GB (K4, the fp32 h_pre written and read
// back included) and ~0.2 GB (K3): both are bound by tensor-core
// operations, not bytes (0.094 and 0.058 ms at the card's peaks).
//
// Design. Each kernel recomputes its half's forward intermediates, as the
// TPU kernels do, but one prompt's recompute state (the fp32 [77, 2048]
// h_pre alone is 631 KB) does not fit in 227 KB of shared memory, so each is
// a few launches behind one Python wrapper with the intermediates in global
// memory:
//   K4 = layer_norm -> gemm(+c_fc_b, fp32 out: h_pre)
//        -> gemm^T(g, c_proj_w; * QuickGELU'(h_pre), cast: dh_pre)
//        -> gemm^T(dh_pre, c_fc_w; fp32 out: dxln) -> ln_bwd(+g)
//   K3 = layer_norm -> gemm(+b_qkv, cast: qkv) -> gemm^T(g, w_out; cast: dattn)
//        -> attention-backward core(qkv, dattn: dqkv)
//        -> gemm^T(dqkv, w_qkv; fp32 out: dxln) -> ln_bwd(+g)
// layer_norm and the QKV gemm are the forward's launches (block_fused.cu).
// gemm^T multiplies by the transpose of the weight as it is stored, so no
// transposed copy exists. In bf16/fp16 every product runs on the wgmma/TMA
// GEMM (gemm_wgmma.cuh; ovmr_gemm_wgmma_bwd here for the backward
// epilogues, the transposed weight read K-major, which is the layout of
// A); in fp32 on gemm.cuh's FMA GEMM (ovmr_gemm_bwd; TF32 would break the
// 1e-5 fp32 tolerance).
//
// The attention-backward core takes every length and every head width that
// is a multiple of 8 up to 128, routed by length (the wrapper picks the
// route; nothing falls back):
//   short (bf16/fp16, L <= 128: the text tower's 77 tokens) -- one launch,
//     one block per (head, image) holding the head's Q, K, V and dO
//     (~46 KB at 80 padded rows of width 64). Each of ceil(L / 16) warps
//     owns 16 query rows and keeps their whole score rows in mma.sync
//     accumulators: one pass over the keys gives the fp32 max, sum and
//     normalised probs, dP = dO v^T, delta and dS = T(P (dP - delta)
//     scale), and dq = dS k from the cast dS in registers. T(P) and T(dS)
//     go to shared memory in the activation dtype, where the contract casts
//     them; after one barrier each warp takes 16 keys for dv = T(P)^T dO and
//     dk = T(dS)^T q. No statistics leave the block and several blocks share
//     an SM; the tiled pair below spent a second launch recomputing P and dP
//     and ran one 8-warp block an SM with 3 of 8 warps idle at L = 77.
//   tiled (longer heads, and fp32 at every length) -- a whole head at a
//     vision tower's L = 197 (Q, K, V, dO and two fp32 [L, L] matrices:
//     ~416 KB in bf16) or L = 577 does not fit in a block, so the core is
//     tiled over the queries and recomputes the scores from the packed qkv
//     instead of keeping them; no atomics, two launches:
//     q-side: one block per (128 queries, head, image). Three passes over
//       the key tiles: the row maximum and sum (as the forward core's first
//       pass), then delta_i = sum_j P_ij dP_ij with the normalised fp32
//       probs and dP = dO v^T, then dS = T(P (dP - delta) scale) and dq +=
//       dS k. Writes dq and each row's statistics (fp32 [B, H, 3, Lp]: max,
//       sum, delta).
//     kv-side: one block per (128 keys, head, image), walking the query
//       tiles with their statistics: recomputes P and dP, dv += T(P)^T dO
//       and dk += dS^T q, fp32 sums cast once at the end.
//     At the vision shapes the core's products (five [L, L] x head-width
//     products, two of them recomputed once more) are ~10 B L^2 D FLOP
//     against q, k, v, dO and dqkv, so it is bound by tensor-core
//     operations: in bf16 and fp16 every product is mma.sync m16n8k16 on
//     fragments from ldmatrix (the forward core's helpers, mma_frag.cuh),
//     scores, probs, dP and dS live in the accumulator registers, and K/V
//     (q-side) or Q/dO (kv-side) tiles stream through a 3-stage cp.async
//     ring. fp32 stays plain FMA, the same two launches in shared-memory
//     tiles; it is the correctness dtype, not a timed one.
//
// Rounding follows the TPU kernels (block_fused_bwd.py:57-216): LN pieces in
// fp32, the LN output cast; h_pre stays fp32; dh_pre is cast after the fp32
// QuickGELU' product; qkv is cast after its bias and dattn after its
// product; scores, softmax and dP in fp32; dS is cast after the scale; probs
// are cast for the dV product; dq, dk, dv are cast per head; dxln stays
// fp32; the LN cotangent is cast and then added to g in the activation
// dtype.
#include "gemm.cuh"
#include "gemm_wgmma.cuh"
#include "mma_frag.cuh"

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
// the forward's packing (q heads | k heads | v heads), tiled over the
// queries at every L (see the header). The row statistics of
// (b, h) live at stats + (b H + h) 3 Lp: [0, Lp) the row maximum, [Lp, 2 Lp)
// the sum, [2 Lp, 3 Lp) delta; Lp is L rounded up to BT_QT, so a tile's
// statistics are read in whole 16-byte pieces (entries past L are never
// used). bf16/fp16 store the maximum times log2(e) and 1 / sum, the two
// numbers the probs are formed from: p = exp2(s log2(e) - m') * (1 / sum).
// ---------------------------------------------------------------------------
constexpr int BT_WARPS = 8, BT_QT = 16 * BT_WARPS, BT_KT = 64, BT_STAGES = 3;
constexpr float BT_LOG2E = 1.4426950408889634f;

// Shared memory at padded head width dhp (rows of dhp + 8 elements, so the
// eight 16-byte rows one ldmatrix reads fall in distinct banks). q-side: the
// block's Q and dO rows, then a ring of (K, V) tiles of BT_KT keys; kv-side:
// the block's K and V rows, then a ring of (Q, dO) tiles of bt_kv_qt(dhp)
// queries and their fp32 statistics.
__host__ __device__ constexpr int bt_kv_qt(int dhp) { return dhp > 64 ? 32 : 64; }
__host__ __device__ constexpr size_t bt_q_smem(int dhp) {
  return (size_t)(2 * BT_QT + BT_STAGES * 2 * BT_KT) * (dhp + 8) * 2;
}
__host__ __device__ constexpr size_t bt_kv_smem(int dhp) {
  return (size_t)(2 * BT_QT + BT_STAGES * 2 * bt_kv_qt(dhp)) * (dhp + 8) * 2 +
         (size_t)BT_STAGES * 3 * bt_kv_qt(dhp) * 4;
}

// one cast of a warp's 16 x dhp fp32 accumulators (rows r0 .. r0 + 15),
// staged in the warp's own shared-memory rows for 16-byte stores of the
// rows below L into out (row stride rs)
template <typename T, int DHP>
__device__ __forceinline__ void store_rows(T* stage, const float (&acc)[DHP / 8][4], T* out,
                                           size_t rs, int r0, int L, int Dh) {
  constexpr int LD = DHP + 8;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  asm volatile("" ::: "memory");  // the rows' last fragment reads come first
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + gid * LD + n * 8 + tig * 2) =
        pack2<T>(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (gid + 8) * LD + n * 8 + tig * 2) =
        pack2<T>(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  const int opr = Dh / 8;
  for (int idx = lane; idx < 16 * opr; idx += 32) {
    const int r = idx / opr, c8 = (idx % opr) * 8;
    if (r0 + r < L)
      *reinterpret_cast<Vec<T, 8>*>(out + (size_t)(r0 + r) * rs + c8) =
          *reinterpret_cast<const Vec<T, 8>*>(stage + r * LD + c8);
  }
}

// q-side, bf16/fp16: each warp owns 16 query rows (lanes hold rows gid and
// gid + 8); the scores of a 16 x BT_KT key tile, P and dP stay in mma.sync
// accumulators
template <typename T, int DHP, bool MASKED>
__global__ void __launch_bounds__(BT_WARPS * 32, 1)
    attn_bwd_q_kernel(const T* __restrict__ qkv, const T* __restrict__ dattn,
                      const float* __restrict__ mask, T* __restrict__ dqkv,
                      float* __restrict__ stats, int L, int Lp, int W, int Dh, float scale) {
  constexpr int LD = DHP + 8, TILE = BT_KT * LD, CPR = DHP / 8, THREADS = BT_WARPS * 32;
  constexpr int NT = BT_KT / 8, KD = DHP / 16, DT = DHP / 8;
  extern __shared__ __align__(128) unsigned char bt_smem[];
  T* Qs = reinterpret_cast<T*>(bt_smem);
  T* Os = Qs + BT_QT * LD;
  T* ring = Os + BT_QT * LD;  // stage s: a K tile, then a V tile

  const int q0 = blockIdx.x * BT_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t rs = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const T* dbase = dattn + (size_t)b * L * W + (size_t)h * Dh;
  const int nkt = ceil_div(L, BT_KT), nsteps = 3 * nkt;

  // step s: pass s / nkt over key tile s % nkt; pass 0 reads K, passes 1
  // and 2 K and V; rows past L and columns past Dh are zero-filled
  auto load_step = [&](int s) {
    const int k0 = (s % nkt) * BT_KT;
    T* Kst = ring + (s % BT_STAGES) * 2 * TILE;
    for (int idx = tid; idx < BT_KT * CPR; idx += THREADS) {
      const int r = idx / CPR, c8 = (idx % CPR) * 8;
      const bool ok = k0 + r < L && c8 < Dh;
      const T* row = ok ? base + (size_t)(k0 + r) * rs + c8 : base;
      cp_async16(Kst + r * LD + c8, ok ? row + W : base, ok);
      if (s >= nkt) cp_async16(Kst + TILE + r * LD + c8, ok ? row + 2 * W : base, ok);
    }
  };
  for (int idx = tid; idx < BT_QT * CPR; idx += THREADS) {
    const int r = idx / CPR, c8 = (idx % CPR) * 8;
    const bool ok = q0 + r < L && c8 < Dh;
    cp_async16(Qs + r * LD + c8, ok ? base + (size_t)(q0 + r) * rs + c8 : base, ok);
    cp_async16(Os + r * LD + c8, ok ? dbase + (size_t)(q0 + r) * W + c8 : dbase, ok);
  }
  load_step(0);  // in Q's group
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < BT_STAGES - 1; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }

  const int qw = q0 + warp * 16;
  const bool active = qw < L;  // an idle warp still copies and meets the barriers
  const float* mrow0 = MASKED ? mask + (size_t)min(qw + gid, L - 1) * L : nullptr;
  const float* mrow1 = MASKED ? mask + (size_t)min(qw + gid + 8, L - 1) * L : nullptr;
  const T* Qw = Qs + warp * 16 * LD;
  const T* Ow = Os + warp * 16 * LD;

  uint32_t qa[KD][4];
  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // rows gid and gid + 8: the running maximum and sum over this thread's
  // columns (pass 0), then the row's maximum times log2(e) and 1 / sum;
  // this thread's share of delta (pass 1), then the row's
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<BT_STAGES - 2>();
    __syncthreads();  // step s has landed; step s - 1's stage is free to refill
    if (s + BT_STAGES - 1 < nsteps) load_step(s + BT_STAGES - 1);
    cp_async_commit();
    if (!active) continue;

    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) lds_a<T>(qa[kk], Qw, LD, kk * 16);
    }
    const int pass = s / nkt;
    if (s == nkt) {  // merge the quad's partial statistics into the row's
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = m_r[r];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = m_r[r] == -INFINITY ? 0.f : l_r[r] * exp2f((m_r[r] - m) * BT_LOG2E);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        m_r[r] = m * BT_LOG2E;
        l_r[r] = 1.f / l;
      }
    }
    if (s == 2 * nkt) {  // delta complete: sum the quad's shares, store the row's statistics
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d_r[r] += __shfl_xor_sync(0xffffffffu, d_r[r], 1);
        d_r[r] += __shfl_xor_sync(0xffffffffu, d_r[r], 2);
        const int row = qw + gid + 8 * r;
        if (tig == 0 && row < L) {
          float* st = stats + ((size_t)b * gridDim.y + h) * 3 * Lp + row;
          st[0] = m_r[r];
          st[Lp] = l_r[r];
          st[2 * Lp] = d_r[r];
        }
      }
    }
    const int k0 = (s % nkt) * BT_KT;
    const T* Ks = ring + (s % BT_STAGES) * 2 * TILE;

    // scores = q . k, fp32, scaled after the product, then the fp32 mask;
    // keys past L are -inf
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t kb[4];
        lds_bt<T>(kb, Ks, LD, j2 * 16, kk * 16);
        mma_16816<T>(sc[2 * j2], qa[kk], kb[0], kb[1]);
        mma_16816<T>(sc[2 * j2 + 1], qa[kk], kb[2], kb[3]);
      }
    }
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

    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[r];
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        if (mx == -INFINITY) continue;  // none of these columns visible to the row yet
        const float mxl = mx * BT_LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          sum += exp2f(fmaf(sc[j][2 * r], BT_LOG2E, -mxl)) +
                 exp2f(fmaf(sc[j][2 * r + 1], BT_LOG2E, -mxl));
        l_r[r] = l_r[r] * exp2f((m_r[r] - mx) * BT_LOG2E) + sum;
        m_r[r] = mx;
      }
      continue;
    }

    // dP = dO . v^T in fp32; the normalised fp32 probs replace the scores
    const T* Vs = Ks + TILE;
    float dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t oa[4];
      lds_a<T>(oa, Ow, LD, kk * 16);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t vb[4];
        lds_bt<T>(vb, Vs, LD, j2 * 16, kk * 16);
        mma_16816<T>(dp[2 * j2], oa, vb[0], vb[1]);
        mma_16816<T>(dp[2 * j2 + 1], oa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = exp2f(fmaf(sc[j][e], BT_LOG2E, -m_r[e / 2])) * l_r[e / 2];

    if (pass == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d_r[e / 2] = fmaf(sc[j][e], dp[j][e], d_r[e / 2]);
      continue;
    }

    // dS = T(P (dP - delta) scale), cast straight into A fragments; dq += dS . k
    uint32_t da[BT_KT / 16][4];
#pragma unroll
    for (int t = 0; t < BT_KT / 16; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* p = sc[2 * t + half];
        const float* e = dp[2 * t + half];
        da[t][2 * half] = pack2<T>(p[0] * (e[0] - d_r[0]) * scale, p[1] * (e[1] - d_r[0]) * scale);
        da[t][2 * half + 1] =
            pack2<T>(p[2] * (e[2] - d_r[1]) * scale, p[3] * (e[3] - d_r[1]) * scale);
      }
    }
#pragma unroll
    for (int t = 0; t < BT_KT / 16; ++t) {
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t kb[4];
        lds_b<T>(kb, Ks, LD, t * 16, d2 * 16);
        mma_16816<T>(dq[2 * d2], da[t], kb[0], kb[1]);
        mma_16816<T>(dq[2 * d2 + 1], da[t], kb[2], kb[3]);
      }
    }
  }
  if (!active) return;
  store_rows<T, DHP>(Qs + warp * 16 * LD, dq, dqkv + (size_t)b * L * rs + (size_t)h * Dh, rs,
                     qw, L, Dh);
}

// kv-side, bf16/fp16: each warp owns 16 keys (lanes hold keys gid and
// gid + 8); the transposed scores of a 16 x QT query tile, then P^T and
// dP^T, then dS^T stay in accumulators; the warp's K and V rows are read as
// A fragments from shared memory
template <typename T, int DHP, bool MASKED>
__global__ void __launch_bounds__(BT_WARPS * 32, 1)
    attn_bwd_kv_kernel(const T* __restrict__ qkv, const T* __restrict__ dattn,
                       const float* __restrict__ mask, T* __restrict__ dqkv,
                       const float* __restrict__ stats, int L, int Lp, int W, int Dh,
                       float scale) {
  constexpr int QT = bt_kv_qt(DHP), LD = DHP + 8, CPR = DHP / 8, THREADS = BT_WARPS * 32;
  constexpr int NT = QT / 8, KD = DHP / 16, DT = DHP / 8, STAGE = 2 * QT * LD;
  extern __shared__ __align__(128) unsigned char bt_smem[];
  T* Ks = reinterpret_cast<T*>(bt_smem);
  T* Vs = Ks + BT_QT * LD;
  T* ring = Vs + BT_QT * LD;  // stage s: a Q tile, then a dO tile
  float* sring = reinterpret_cast<float*>(ring + BT_STAGES * STAGE);  // [stage][3][QT]

  const int kb0 = blockIdx.x * BT_QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t rs = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const T* dbase = dattn + (size_t)b * L * W + (size_t)h * Dh;
  const float* st = stats + ((size_t)b * gridDim.y + h) * 3 * Lp;
  const int nsteps = ceil_div(L, QT);

  auto load_step = [&](int s) {
    const int i0 = s * QT;
    T* Qst = ring + (s % BT_STAGES) * STAGE;
    for (int idx = tid; idx < QT * CPR; idx += THREADS) {
      const int r = idx / CPR, c8 = (idx % CPR) * 8;
      const bool ok = i0 + r < L && c8 < Dh;
      cp_async16(Qst + r * LD + c8, ok ? base + (size_t)(i0 + r) * rs + c8 : base, ok);
      cp_async16(Qst + QT * LD + r * LD + c8, ok ? dbase + (size_t)(i0 + r) * W + c8 : dbase,
                 ok);
    }
    float* Sst = sring + (s % BT_STAGES) * 3 * QT;
    for (int idx = tid; idx < 3 * QT / 4; idx += THREADS) {
      const int w = idx / (QT / 4), c4 = (idx % (QT / 4)) * 4;
      cp_async16(Sst + w * QT + c4, st + (size_t)w * Lp + i0 + c4, true);
    }
  };
  for (int idx = tid; idx < BT_QT * CPR; idx += THREADS) {
    const int r = idx / CPR, c8 = (idx % CPR) * 8;
    const bool ok = kb0 + r < L && c8 < Dh;
    const T* row = ok ? base + (size_t)(kb0 + r) * rs + c8 : base;
    cp_async16(Ks + r * LD + c8, ok ? row + W : base, ok);
    cp_async16(Vs + r * LD + c8, ok ? row + 2 * W : base, ok);
  }
  load_step(0);  // in K's group
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < BT_STAGES - 1; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }

  const int kw = kb0 + warp * 16;
  const bool active = kw < L;
  // the mask columns of keys gid and gid + 8 (a key past L reads key L - 1, unstored)
  const int key0 = min(kw + gid, L - 1), key1 = min(kw + gid + 8, L - 1);
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<BT_STAGES - 2>();
    __syncthreads();
    if (s + BT_STAGES - 1 < nsteps) load_step(s + BT_STAGES - 1);
    cp_async_commit();
    if (!active) continue;

    const int i0 = s * QT;
    const T* Qt = ring + (s % BT_STAGES) * STAGE;
    const T* Ot = Qt + QT * LD;
    const float* St = sring + (s % BT_STAGES) * 3 * QT;

    // s^T = k . q^T and dP^T = v . dO^T, fp32
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      lds_a<T>(ka, Kw, LD, kk * 16);
      lds_a<T>(va, Vw, LD, kk * 16);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t qb[4], ob[4];
        lds_bt<T>(qb, Qt, LD, j2 * 16, kk * 16);
        mma_16816<T>(sc[2 * j2], ka, qb[0], qb[1]);
        mma_16816<T>(sc[2 * j2 + 1], ka, qb[2], qb[3]);
        lds_bt<T>(ob, Ot, LD, j2 * 16, kk * 16);
        mma_16816<T>(dp[2 * j2], va, ob[0], ob[1]);
        mma_16816<T>(dp[2 * j2 + 1], va, ob[2], ob[3]);
      }
    }
    // column (query) i0 + c: P = exp2(s log2(e) - m') / sum and dS = P (dP -
    // delta) scale, both zero for a query past L
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + tig * 2 + e, qi = i0 + c;
        const bool in = qi < L;
        const float ml = St[c], rl = St[QT + c], delta = St[2 * QT + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = sc[j][2 * r + e] * scale;
          if (MASKED && in) v += __ldg(mask + (size_t)qi * L + (r ? key1 : key0));
          const float p = in ? exp2f(fmaf(v, BT_LOG2E, -ml)) * rl : 0.f;
          sc[j][2 * r + e] = p;
          dp[j][2 * r + e] = in ? p * (dp[j][2 * r + e] - delta) * scale : 0.f;
        }
      }
    }
    // dv += T(P)^T . dO and dk += T(dS)^T . q: the casts go straight into A
    // fragments (rows keys, depth queries)
#pragma unroll
    for (int t = 0; t < QT / 16; ++t) {
      uint32_t pa[4], da[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* p = sc[2 * t + half];
        const float* d = dp[2 * t + half];
        pa[2 * half] = pack2<T>(p[0], p[1]);
        pa[2 * half + 1] = pack2<T>(p[2], p[3]);
        da[2 * half] = pack2<T>(d[0], d[1]);
        da[2 * half + 1] = pack2<T>(d[2], d[3]);
      }
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t ob[4], qb[4];
        lds_b<T>(ob, Ot, LD, t * 16, d2 * 16);
        mma_16816<T>(dv[2 * d2], pa, ob[0], ob[1]);
        mma_16816<T>(dv[2 * d2 + 1], pa, ob[2], ob[3]);
        lds_b<T>(qb, Qt, LD, t * 16, d2 * 16);
        mma_16816<T>(dk[2 * d2], da, qb[0], qb[1]);
        mma_16816<T>(dk[2 * d2 + 1], da, qb[2], qb[3]);
      }
    }
  }
  if (!active) return;
  T* out = dqkv + (size_t)b * L * rs + (size_t)h * Dh;
  store_rows<T, DHP>(Ks + warp * 16 * LD, dk, out + W, rs, kw, L, Dh);
  store_rows<T, DHP>(Vs + warp * 16 * LD, dv, out + 2 * W, rs, kw, L, Dh);
}

// ---------------------------------------------------------------------------
// Short heads, bf16/fp16: the whole core of one (head, image) in one block
// (see the header). ceil(L / 16) warps, warp w owning query rows 16 w ..
// 16 w + 15 (lanes hold rows gid and gid + 8) and, after the barrier, keys
// 16 w .. 16 w + 15. The scores of a row live in NT m16n8 accumulator tiles
// (NT * 8 >= the padded length R; tiles past R are skipped, never computed).
// Shared memory: Q, K, V and dO of the head (R rows of DHP + 8 elements,
// rows past L and columns past Dh zero-filled), then T(P) and T(dS) (R rows
// of NT * 8 + 8 elements, [query][key]).
// ---------------------------------------------------------------------------
constexpr int BS_MAX_L = 128;

__host__ __device__ constexpr size_t bs_smem(int rows, int dhp, int nt) {
  return (size_t)rows * (4 * (dhp + 8) + 2 * (nt * 8 + 8)) * 2;
}

// at most 80 rows (NT = 10, the text tower) a block has 5 warps, and three
// share an SM (136 registers a thread, 3 x 73 KB of shared memory at width 64)
template <typename T, int DHP, int NT>
__global__ void __launch_bounds__(NT <= 10 ? 160 : BS_MAX_L / 16 * 32, NT <= 10 ? 3 : 1)
    attn_bwd_short_kernel(const T* __restrict__ qkv, const T* __restrict__ dattn,
                          const float* __restrict__ mask, T* __restrict__ dqkv, int L, int W,
                          int Dh, float scale) {
  constexpr int LD = DHP + 8, LDP = NT * 8 + 8, CPR = DHP / 8, KD = DHP / 16, DT = DHP / 8;
  extern __shared__ __align__(128) unsigned char bs_smem_raw[];
  const int nw = blockDim.x / 32, R = nw * 16;
  T* Qs = reinterpret_cast<T*>(bs_smem_raw);
  T* Ks = Qs + R * LD;
  T* Vs = Ks + R * LD;
  T* Os = Vs + R * LD;
  T* Ps = Os + R * LD;
  T* Ss = Ps + R * LDP;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t rs = 3 * (size_t)W;
  const T* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const T* dbase = dattn + (size_t)b * L * W + (size_t)h * Dh;
  for (int idx = tid; idx < R * CPR; idx += blockDim.x) {
    const int r = idx / CPR, c8 = (idx % CPR) * 8;
    const bool ok = r < L && c8 < Dh;
    const T* row = ok ? base + (size_t)r * rs + c8 : base;
    cp_async16(Qs + r * LD + c8, row, ok);
    cp_async16(Ks + r * LD + c8, ok ? row + W : base, ok);
    cp_async16(Vs + r * LD + c8, ok ? row + 2 * W : base, ok);
    cp_async16(Os + r * LD + c8, ok ? dbase + (size_t)r * W + c8 : dbase, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // scores = q . k and dP = dO . v^T over every key (tile pairs j2 < nw), fp32
  const int q0 = warp * 16;
  float sc[NT][4], dp[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t qa[4], oa[4];
    lds_a<T>(qa, Qs + q0 * LD, LD, kk * 16);
    lds_a<T>(oa, Os + q0 * LD, LD, kk * 16);
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      if (j2 >= nw) continue;
      uint32_t kb[4], vb[4];
      lds_bt<T>(kb, Ks, LD, j2 * 16, kk * 16);
      mma_16816<T>(sc[2 * j2], qa, kb[0], kb[1]);
      mma_16816<T>(sc[2 * j2 + 1], qa, kb[2], kb[3]);
      lds_bt<T>(vb, Vs, LD, j2 * 16, kk * 16);
      mma_16816<T>(dp[2 * j2], oa, vb[0], vb[1]);
      mma_16816<T>(dp[2 * j2 + 1], oa, vb[2], vb[3]);
    }
  }
  // scaled after the product, then the fp32 mask; keys past L are -inf. A
  // row past L (the last warp's padding) reads the mask row L - 1 and is
  // zeroed below
  const float* mrow[2] = {mask + (size_t)min(q0 + gid, L - 1) * L,
                          mask + (size_t)min(q0 + gid + 8, L - 1) * L};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kc = j * 8 + tig * 2 + e;
      const bool in = kc < L;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = sc[j][2 * r + e] * scale;
        if (mask && in) v += __ldg(mrow[r] + kc);
        sc[j][2 * r + e] = in ? v : -INFINITY;
      }
    }
  }
  // fp32 softmax over the whole row (the quad holds it), normalised as the
  // tiled core forms it: exp2(s log2(e) - m log2(e)) * (1 / sum); then delta
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mxl = mx * BT_LOG2E;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(sc[j][2 * r + e], BT_LOG2E, -mxl));
        sc[j][2 * r + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const bool live = q0 + gid + 8 * r < L;
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = live ? sc[j][2 * r + e] * inv : 0.f;
        sc[j][2 * r + e] = p;
        d = fmaf(p, dp[j][2 * r + e], d);
      }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    delta[r] = d;
  }
  // T(P) and dS = T(P (dP - delta) scale) into shared memory ([query][key]),
  // and the cast dS straight into the A fragments of dq = dS . k
  uint32_t da[NT / 2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= 2 * nw) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* p = &sc[j][2 * r];
      const float* e = &dp[j][2 * r];
      const uint32_t ds = pack2<T>(p[0] * (e[0] - delta[r]) * scale,
                                   p[1] * (e[1] - delta[r]) * scale);
      const int at = (q0 + gid + 8 * r) * LDP + j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(Ps + at) = pack2<T>(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(Ss + at) = ds;
      da[j / 2][(j % 2) * 2 + r] = ds;
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    if (t >= nw) continue;
#pragma unroll
    for (int d2 = 0; d2 < DT / 2; ++d2) {
      uint32_t kb[4];
      lds_b<T>(kb, Ks, LD, t * 16, d2 * 16);
      mma_16816<T>(acc[2 * d2], da[t], kb[0], kb[1]);
      mma_16816<T>(acc[2 * d2 + 1], da[t], kb[2], kb[3]);
    }
  }
  // dq, cast per head, stored as column pairs of the rows below L
  T* out = dqkv + (size_t)b * L * rs + (size_t)h * Dh;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = n * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + gid + 8 * r;
      if (row < L && col < Dh)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * rs + col) =
            pack2<T>(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
  __syncthreads();  // every row's T(P) and T(dS) is in; K and V are read for the last time

  // dv = T(P)^T . dO, then dk = T(dS)^T . q, for keys k0 .. k0 + 15; each is
  // staged through the warp's own rows of V (K), which no warp reads any more
  const int k0 = warp * 16;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const T* A = side == 0 ? Ps : Ss;
    const T* Bm = side == 0 ? Os : Qs;
#pragma unroll
    for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < NT / 2; ++t) {
      if (t >= nw) continue;
      uint32_t a[4];
      lds_at<T>(a, A, LDP, t * 16, k0);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t bb[4];
        lds_b<T>(bb, Bm, LD, t * 16, d2 * 16);
        mma_16816<T>(acc[2 * d2], a, bb[0], bb[1]);
        mma_16816<T>(acc[2 * d2 + 1], a, bb[2], bb[3]);
      }
    }
    if (side == 0)
      store_rows<T, DHP>(Vs + k0 * LD, acc, out + 2 * W, rs, k0, L, Dh);
    else
      store_rows<T, DHP>(Ks + k0 * LD, acc, out + W, rs, k0, L, Dh);
  }
}

// ---------------------------------------------------------------------------
// fp32: the same two launches in shared-memory tiles, plain FMA, at every
// length (shared memory depends on the head width only). q-side: one block
// per (BF_Q queries, head, image), the keys in tiles of BF_K; kv-side: one
// block per (BF_Q keys, head, image), the queries in tiles of BF_K.
// Statistics: the row maximum, sum and delta.
// ---------------------------------------------------------------------------
constexpr int BF_Q = 32, BF_K = 64, BF_THREADS = 256;

__host__ __device__ constexpr size_t bf_q_smem(int Dh) {
  return ((size_t)(3 * BF_Q + 2 * BF_K) * (Dh + 1) + 2 * BF_Q * (BF_K + 1) + 3 * BF_Q) * 4;
}
__host__ __device__ constexpr size_t bf_kv_smem(int Dh) {
  return ((size_t)(4 * BF_Q + 2 * BF_K) * (Dh + 1) + 2 * BF_K * (BF_Q + 1) + 3 * BF_K) * 4;
}

__global__ void __launch_bounds__(BF_THREADS)
    attn_bwd_q_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                          const float* __restrict__ mask, float* __restrict__ dqkv,
                          float* __restrict__ stats, int L, int Lp, int W, int Dh,
                          float scale) {
  constexpr int NW = BF_THREADS / 32, LDS = BF_K + 1;
  extern __shared__ float fsm[];
  const int ld = Dh + 1;
  float* Qs = fsm;
  float* Os = Qs + BF_Q * ld;
  float* DQ = Os + BF_Q * ld;
  float* Ks = DQ + BF_Q * ld;
  float* Vs = Ks + BF_K * ld;
  float* S = Vs + BF_K * ld;   // scores, then dS
  float* DP = S + BF_Q * LDS;  // dP
  float* row_m = DP + BF_Q * LDS;
  float* row_l = row_m + BF_Q;
  float* row_d = row_l + BF_Q;
  const int q0 = blockIdx.x * BF_Q, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const float* dbase = dattn + (size_t)b * L * W + (size_t)h * Dh;
  const int nq = min(BF_Q, L - q0);

  for (int idx = tid; idx < nq * Dh; idx += BF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    Qs[r * ld + d] = base[(size_t)(q0 + r) * rs + d];
    Os[r * ld + d] = dbase[(size_t)(q0 + r) * W + d];
    DQ[r * ld + d] = 0.f;
  }
  for (int r = tid; r < BF_Q; r += BF_THREADS) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
    row_d[r] = 0.f;
  }
  for (int pass = 0; pass < 3; ++pass) {
    for (int k0 = 0; k0 < L; k0 += BF_K) {
      const int nk = min(BF_K, L - k0);
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < nk * Dh; idx += BF_THREADS) {
        const int r = idx / Dh, d = idx % Dh;
        Ks[r * ld + d] = base[(size_t)(k0 + r) * rs + W + d];
        if (pass > 0) Vs[r * ld + d] = base[(size_t)(k0 + r) * rs + 2 * W + d];
      }
      __syncthreads();
      for (int idx = tid; idx < nq * nk; idx += BF_THREADS) {
        const int r = idx / nk, c = idx % nk;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < Dh; ++d) s = fmaf(Qs[r * ld + d], Ks[c * ld + d], s);
        s *= scale;
        if (mask) s += mask[(size_t)(q0 + r) * L + k0 + c];
        S[r * LDS + c] = s;
        if (pass > 0) {
          for (int d = 0; d < Dh; ++d) dp = fmaf(Os[r * ld + d], Vs[c * ld + d], dp);
          DP[r * LDS + c] = dp;
        }
      }
      __syncthreads();
      for (int r = warp; r < nq; r += NW) {  // a warp owns its rows in every pass
        float* srow = S + r * LDS;
        if (pass == 0) {
          float mx = -INFINITY;
          for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, srow[c]);
          const float m_old = row_m[r], m_new = fmaxf(m_old, warp_max(mx));
          float sum = 0.f;
          for (int c = lane; c < nk; c += 32)
            sum += srow[c] == -INFINITY ? 0.f : expf(srow[c] - m_new);
          sum = warp_sum(sum);
          if (lane == 0) {
            row_l[r] = (m_old == -INFINITY ? 0.f : row_l[r] * expf(m_old - m_new)) + sum;
            row_m[r] = m_new;
          }
        } else if (pass == 1) {
          const float m = row_m[r], l = row_l[r];
          float dsum = 0.f;
          for (int c = lane; c < nk; c += 32) dsum += expf(srow[c] - m) / l * DP[r * LDS + c];
          dsum = warp_sum(dsum);
          if (lane == 0) row_d[r] += dsum;
        } else {
          const float m = row_m[r], l = row_l[r], delta = row_d[r];
          for (int c = lane; c < nk; c += 32)
            srow[c] = expf(srow[c] - m) / l * (DP[r * LDS + c] - delta) * scale;
        }
      }
      if (pass < 2) continue;
      __syncthreads();
      for (int idx = tid; idx < nq * Dh; idx += BF_THREADS) {  // dq += dS . k
        const int r = idx / Dh, d = idx % Dh;
        float acc = DQ[r * ld + d];
        for (int c = 0; c < nk; ++c) acc = fmaf(S[r * LDS + c], Ks[c * ld + d], acc);
        DQ[r * ld + d] = acc;
      }
    }
  }
  __syncthreads();
  float* st = stats + ((size_t)b * gridDim.y + h) * 3 * Lp + q0;
  for (int r = tid; r < nq; r += BF_THREADS) {
    st[r] = row_m[r];
    st[Lp + r] = row_l[r];
    st[2 * Lp + r] = row_d[r];
  }
  float* obase = dqkv + (size_t)b * L * rs + (size_t)h * Dh;
  for (int idx = tid; idx < nq * Dh; idx += BF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    obase[(size_t)(q0 + r) * rs + d] = DQ[r * ld + d];
  }
}

__global__ void __launch_bounds__(BF_THREADS)
    attn_bwd_kv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                           const float* __restrict__ mask, float* __restrict__ dqkv,
                           const float* __restrict__ stats, int L, int Lp, int W, int Dh,
                           float scale) {
  constexpr int LDS = BF_Q + 1;
  extern __shared__ float fsm[];
  const int ld = Dh + 1;
  float* Ks = fsm;
  float* Vs = Ks + BF_Q * ld;
  float* DK = Vs + BF_Q * ld;
  float* DV = DK + BF_Q * ld;
  float* Qs = DV + BF_Q * ld;
  float* Os = Qs + BF_K * ld;
  float* P = Os + BF_K * ld;   // [BF_K queries][LDS]
  float* DS = P + BF_K * LDS;
  float* srow = DS + BF_K * LDS;  // m, l, delta of the tile's queries
  const int k0 = blockIdx.x * BF_Q, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t rs = 3 * (size_t)W;
  const float* base = qkv + (size_t)b * L * rs + (size_t)h * Dh;
  const float* dbase = dattn + (size_t)b * L * W + (size_t)h * Dh;
  const float* st = stats + ((size_t)b * gridDim.y + h) * 3 * Lp;
  const int nk = min(BF_Q, L - k0);

  for (int idx = tid; idx < nk * Dh; idx += BF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    Ks[r * ld + d] = base[(size_t)(k0 + r) * rs + W + d];
    Vs[r * ld + d] = base[(size_t)(k0 + r) * rs + 2 * W + d];
    DK[r * ld + d] = 0.f;
    DV[r * ld + d] = 0.f;
  }
  for (int i0 = 0; i0 < L; i0 += BF_K) {
    const int ni = min(BF_K, L - i0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < ni * Dh; idx += BF_THREADS) {
      const int r = idx / Dh, d = idx % Dh;
      Qs[r * ld + d] = base[(size_t)(i0 + r) * rs + d];
      Os[r * ld + d] = dbase[(size_t)(i0 + r) * W + d];
    }
    for (int idx = tid; idx < 3 * ni; idx += BF_THREADS)
      srow[(idx / ni) * BF_K + idx % ni] = st[(size_t)(idx / ni) * Lp + i0 + idx % ni];
    __syncthreads();
    for (int idx = tid; idx < ni * nk; idx += BF_THREADS) {
      const int i = idx / nk, j = idx % nk;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < Dh; ++d) {
        s = fmaf(Qs[i * ld + d], Ks[j * ld + d], s);
        dp = fmaf(Os[i * ld + d], Vs[j * ld + d], dp);
      }
      s *= scale;
      if (mask) s += mask[(size_t)(i0 + i) * L + k0 + j];
      const float p = expf(s - srow[i]) / srow[BF_K + i];
      P[i * LDS + j] = p;
      DS[i * LDS + j] = p * (dp - srow[2 * BF_K + i]) * scale;
    }
    __syncthreads();
    // dv += P^T . dO, dk += dS^T . q; each thread keeps its own entries
    for (int idx = tid; idx < nk * Dh; idx += BF_THREADS) {
      const int j = idx / Dh, d = idx % Dh;
      float av = DV[j * ld + d], ak = DK[j * ld + d];
      for (int i = 0; i < ni; ++i) {
        av = fmaf(P[i * LDS + j], Os[i * ld + d], av);
        ak = fmaf(DS[i * LDS + j], Qs[i * ld + d], ak);
      }
      DV[j * ld + d] = av;
      DK[j * ld + d] = ak;
    }
  }
  float* obase = dqkv + (size_t)b * L * rs + (size_t)h * Dh;
  for (int idx = tid; idx < nk * Dh; idx += BF_THREADS) {
    const int r = idx / Dh, d = idx % Dh;
    obase[(size_t)(k0 + r) * rs + W + d] = DK[r * ld + d];
    obase[(size_t)(k0 + r) * rs + 2 * W + d] = DV[r * ld + d];
  }
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------
static cudaError_t launch_bwd_gemm_f32(const void* A, const void* W, const void* bias,
                                       const void* aux, void* C, int M, int N, int K, int epi,
                                       cudaStream_t st) {
  switch (epi) {
    case EPI_BIAS_F32:
      if (!bias) return cudaErrorInvalidValue;
      launch_gemm_f32<false, EPI_BIAS_F32>(A, W, bias, aux, C, M, N, K, st);
      break;
    case EPI_CAST: launch_gemm_f32<true, EPI_CAST>(A, W, bias, aux, C, M, N, K, st); break;
    case EPI_GELU_GRAD:
      if (!aux) return cudaErrorInvalidValue;
      launch_gemm_f32<true, EPI_GELU_GRAD>(A, W, bias, aux, C, M, N, K, st);
      break;
    case EPI_F32: launch_gemm_f32<true, EPI_F32>(A, W, bias, aux, C, M, N, K, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// the backward's epilogues on the wgmma/TMA GEMM: EPI_BIAS_F32 in the
// forward form (W [K, N]), the others against W^T (W stored [N, K])
template <typename T>
static cudaError_t launch_bwd_gemm_wgmma(const void* A, const void* W, const void* bias,
                                         const void* aux, void* C, int M, int N, int K, int ldw,
                                         int ldc, int epi, cudaStream_t st) {
#define OVMR_BWD(E, TR) launch_gemm_wgmma<T, E, TR>(A, W, bias, aux, C, M, N, K, ldw, ldc, st)
  switch (epi) {
    case EPI_BIAS_F32: return OVMR_BWD(EPI_BIAS_F32, false);
    case EPI_CAST: return OVMR_BWD(EPI_CAST, true);
    case EPI_GELU_GRAD: return OVMR_BWD(EPI_GELU_GRAD, true);
    case EPI_F32: return OVMR_BWD(EPI_F32, true);
    default: return cudaErrorInvalidValue;
  }
#undef OVMR_BWD
}

template <typename T>
static void launch_ln_bwd(const void* x, const void* dxln, const void* g, const void* gamma,
                          void* out, int M, int K, cudaStream_t st) {
  ln_bwd_kernel<T><<<ceil_div(M, LNB_THREADS / 32), LNB_THREADS, 0, st>>>(
      (const T*)x, (const float*)dxln, (const T*)g, (const T*)gamma, (T*)out, M, K);
}

template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// fp32: the two tiled launches (plain FMA) at every length
static cudaError_t launch_attn_bwd_core_f32(const void* qkv, const void* dattn,
                                            const float* mask, void* dqkv, float* stats, int B,
                                            int L, int D, int H, cudaStream_t st) {
  static_assert(bf_q_smem(128) <= 227 * 1024 && bf_kv_smem(128) <= 227 * 1024,
                "the fp32 backward core's shared memory exceeds a block's 227 KB");
  const int Dh = D / H, Lp = ceil_div(L, BT_QT) * BT_QT;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  cudaError_t err;
  if ((err = set_smem(attn_bwd_q_f32_kernel, bf_q_smem(Dh))) != cudaSuccess) return err;
  if ((err = set_smem(attn_bwd_kv_f32_kernel, bf_kv_smem(Dh))) != cudaSuccess) return err;
  attn_bwd_q_f32_kernel<<<dim3(ceil_div(L, BF_Q), H, B), BF_THREADS, bf_q_smem(Dh), st>>>(
      (const float*)qkv, (const float*)dattn, mask, (float*)dqkv, stats, L, Lp, D, Dh, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_kv_f32_kernel<<<dim3(ceil_div(L, BF_Q), H, B), BF_THREADS, bf_kv_smem(Dh), st>>>(
      (const float*)qkv, (const float*)dattn, mask, (float*)dqkv, stats, L, Lp, D, Dh, scale);
  return cudaSuccess;
}

// bf16/fp16: the two tiled tensor-core launches at every length
template <typename T, int DHP, bool MASKED>
static cudaError_t launch_attn_bwd_tiled(const void* qkv, const void* dattn, const float* mask,
                                         void* dqkv, float* stats, int B, int L, int D, int H,
                                         cudaStream_t st) {
  constexpr size_t q_bytes = bt_q_smem(DHP), kv_bytes = bt_kv_smem(DHP);
  static_assert(q_bytes <= 227 * 1024 && kv_bytes <= 227 * 1024,
                "the backward core's shared memory exceeds a block's 227 KB");
  auto qk = attn_bwd_q_kernel<T, DHP, MASKED>;
  auto kvk = attn_bwd_kv_kernel<T, DHP, MASKED>;
  cudaError_t err;
  if ((err = set_smem(qk, q_bytes)) != cudaSuccess) return err;
  if ((err = set_smem(kvk, kv_bytes)) != cudaSuccess) return err;
  const int Dh = D / H, Lp = ceil_div(L, BT_QT) * BT_QT;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  const dim3 grid(ceil_div(L, BT_QT), H, B);  // query (key) tiles fastest: a head's blocks share it in L2
  qk<<<grid, BT_WARPS * 32, q_bytes, st>>>((const T*)qkv, (const T*)dattn, mask, (T*)dqkv, stats,
                                           L, Lp, D, Dh, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kvk<<<grid, BT_WARPS * 32, kv_bytes, st>>>((const T*)qkv, (const T*)dattn, mask, (T*)dqkv,
                                             stats, L, Lp, D, Dh, scale);
  return cudaSuccess;
}

// head widths that are a multiple of 8 up to 64 run the 64-wide core, up to
// 128 the 128-wide one (zero-padded inside the kernels)
template <typename T>
static cudaError_t launch_attn_bwd_core_tc(const void* qkv, const void* dattn, const float* mask,
                                           void* dqkv, float* stats, int B, int L, int D, int H,
                                           cudaStream_t st) {
  const int Dh = D / H;
  if (Dh <= 64)
    return mask ? launch_attn_bwd_tiled<T, 64, true>(qkv, dattn, mask, dqkv, stats, B, L, D, H, st)
                : launch_attn_bwd_tiled<T, 64, false>(qkv, dattn, mask, dqkv, stats, B, L, D, H, st);
  return mask ? launch_attn_bwd_tiled<T, 128, true>(qkv, dattn, mask, dqkv, stats, B, L, D, H, st)
              : launch_attn_bwd_tiled<T, 128, false>(qkv, dattn, mask, dqkv, stats, B, L, D, H, st);
}

// bf16/fp16, L <= BS_MAX_L: the one-launch core. The scores of a row take
// NT accumulator tiles: 10 (80 keys: the text tower's 77 tokens) or 16
template <typename T, int DHP, int NT>
static cudaError_t launch_attn_bwd_short(const void* qkv, const void* dattn, const float* mask,
                                         void* dqkv, int B, int L, int D, int H,
                                         cudaStream_t st) {
  constexpr size_t most = bs_smem(NT * 8, DHP, NT);
  static_assert(most <= 227 * 1024, "the short backward core's shared memory exceeds 227 KB");
  auto kernel = attn_bwd_short_kernel<T, DHP, NT>;
  const cudaError_t err = set_smem(kernel, most);
  if (err != cudaSuccess) return err;
  const int nw = ceil_div(L, 16), Dh = D / H;
  kernel<<<dim3(H, B), nw * 32, bs_smem(nw * 16, DHP, NT), st>>>(
      (const T*)qkv, (const T*)dattn, mask, (T*)dqkv, L, D, Dh, (float)(1.0 / sqrt((double)Dh)));
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_attn_bwd_short_tc(const void* qkv, const void* dattn, const float* mask,
                                            void* dqkv, int B, int L, int D, int H,
                                            cudaStream_t st) {
  const int Dh = D / H;
  const bool eighty = ceil_div(L, 16) * 16 <= 80;
  if (Dh <= 64)
    return eighty ? launch_attn_bwd_short<T, 64, 10>(qkv, dattn, mask, dqkv, B, L, D, H, st)
                  : launch_attn_bwd_short<T, 64, 16>(qkv, dattn, mask, dqkv, B, L, D, H, st);
  return eighty ? launch_attn_bwd_short<T, 128, 10>(qkv, dattn, mask, dqkv, B, L, D, H, st)
                : launch_attn_bwd_short<T, 128, 16>(qkv, dattn, mask, dqkv, B, L, D, H, st);
}

}  // namespace ovmr

using namespace ovmr;

// fp32 only (bf16/fp16 take ovmr_gemm_wgmma_bwd): C = epilogue(A @ op(W))
// for the backward halves. epilogue 3: op(W) = W [K, N], C = fp32(acc +
// bias). epilogues 4-6: op(W) = W^T with W stored [N, K]; 4: C = T(acc);
// 5: C = T(acc * QuickGELU'(aux)), aux fp32 [M, N]; 6: C = fp32(acc)
OVMR_EXPORT int ovmr_gemm_bwd(int dtype, const void* A, const void* W, const void* bias,
                              const void* aux, void* C, int M, int N, int K, int epilogue,
                              void* stream) {
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_bwd_gemm_f32(A, W, bias, aux, C, M, N, K, epilogue,
                                              static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ovmr_gemm_bwd's epilogues in bf16/fp16 on the wgmma/TMA GEMM
// (gemm_wgmma.cuh), W's rows ldw and C's rows ldc elements apart (C's own
// type). A bias is given exactly for 3 and the fp32 h_pre (aux, dense
// [M, N], 8-byte aligned) exactly for 5; N, K and ldw multiples of 8, ldw
// at least N (3) or K (4-6); A and W 16-byte aligned; ldc at least N and
// even, C aligned to a pair of its elements, the bias to 4 bytes
OVMR_EXPORT int ovmr_gemm_wgmma_bwd(int dtype, const void* A, const void* W, const void* bias,
                                    const void* aux, void* C, int M, int N, int K, int ldw,
                                    int ldc, int epilogue, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool trans = epilogue == EPI_CAST || epilogue == EPI_GELU_GRAD || epilogue == EPI_F32;
  const uintptr_t pair = epi_out_f32(epilogue) ? 8 : 4;
  if (!(trans || epilogue == EPI_BIAS_F32) || (epilogue == EPI_BIAS_F32) != (bias != nullptr) ||
      (epilogue == EPI_GELU_GRAD) != (aux != nullptr) || N % 8 || K % 8 || ldw % 8 ||
      ldw < (trans ? K : N) || ldc < N || ldc % 2 || reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(W) % 16 || reinterpret_cast<uintptr_t>(C) % pair ||
      reinterpret_cast<uintptr_t>(bias) % 4 || reinterpret_cast<uintptr_t>(aux) % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case DT_BF16:
      err = launch_bwd_gemm_wgmma<__nv_bfloat16>(A, W, bias, aux, C, M, N, K, ldw, ldc, epilogue,
                                                 st);
      break;
    case DT_F16:
      err = launch_bwd_gemm_wgmma<__half>(A, W, bias, aux, C, M, N, K, ldw, ldc, epilogue, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4's dh_pre = T((g @ c_proj_w^T) * QuickGELU'(xln @ c_fc_w + c_fc_b)) in one
// wgmma/TMA launch, bf16/fp16: xln, g [M, K]; c_fc_w [K, N]; c_proj_w
// [N, K]; dh_pre [M, N]; all dense and 16-byte aligned, N and K multiples
// of 8 (the fp32 h_pre is never stored)
OVMR_EXPORT int ovmr_mlp_bwd_dh(int dtype, const void* xln, const void* c_fc_w,
                                const void* c_fc_b, const void* g, const void* c_proj_w,
                                void* dh_pre, int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t any16 = reinterpret_cast<uintptr_t>(xln) | reinterpret_cast<uintptr_t>(c_fc_w) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(c_proj_w) |
                          reinterpret_cast<uintptr_t>(dh_pre);
  if (!c_fc_b || any16 % 16 || reinterpret_cast<uintptr_t>(c_fc_b) % 4 || N % 8 || K % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case DT_BF16:
      err = launch_gemm_wgmma_dual<__nv_bfloat16>(xln, c_fc_w, c_fc_b, g, c_proj_w, dh_pre, M, N,
                                                  K, st);
      break;
    case DT_F16:
      err = launch_gemm_wgmma_dual<__half>(xln, c_fc_w, c_fc_b, g, c_proj_w, dh_pre, M, N, K, st);
      break;
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

// dqkv = the attention-backward core of (qkv, dattn) for B sequences of L
// tokens, width D in H heads (a multiple of 8 up to 128 each), tiled over
// the queries (two launches; the route of every fp32 core and of bf16/fp16
// beyond BS_MAX_L tokens); stats is fp32 scratch of B H 3 Lp floats, Lp = L
// rounded up to 128
OVMR_EXPORT int ovmr_attn_bwd_core(int dtype, const void* qkv, const void* dattn,
                                   const void* mask, void* dqkv, void* stats, int B, int L,
                                   int D, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* sp = static_cast<float*>(stats);
  if (H <= 0 || D % H || (D / H) % 8 || D / H > 128) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case DT_F32: err = launch_attn_bwd_core_f32(qkv, dattn, m, dqkv, sp, B, L, D, H, st); break;
    case DT_BF16:
      err = launch_attn_bwd_core_tc<__nv_bfloat16>(qkv, dattn, m, dqkv, sp, B, L, D, H, st);
      break;
    case DT_F16:
      err = launch_attn_bwd_core_tc<__half>(qkv, dattn, m, dqkv, sp, B, L, D, H, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the same core for 1 <= L <= 128 tokens in one launch, bf16/fp16 only
OVMR_EXPORT int ovmr_attn_bwd_core_short(int dtype, const void* qkv, const void* dattn,
                                         const void* mask, void* dqkv, int B, int L, int D,
                                         int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (H <= 0 || D % H || (D / H) % 8 || D / H > 128 || L < 1 || L > BS_MAX_L)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case DT_BF16:
      err = launch_attn_bwd_short_tc<__nv_bfloat16>(qkv, dattn, m, dqkv, B, L, D, H, st);
      break;
    case DT_F16: err = launch_attn_bwd_short_tc<__half>(qkv, dattn, m, dqkv, B, L, D, H, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
