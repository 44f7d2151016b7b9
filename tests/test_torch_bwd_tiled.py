"""K3 at a vision tower's lengths, on the CPU.

The plain twin of K3 (``attn_half_bwd_dx``, what the wrapper runs for a CPU
tensor) at L = 197 (ViT-B/16) and 577 (ViT-L/14@336px), with no mask, the
causal mask and a random additive mask, against the TPU kernel in interpret
mode on the same numpy inputs: fp32 atol 1e-4, bf16 1e-2 (inputs scaled so
the outputs stay below 2). Then a numpy model of the query-tiled core the
card runs (row statistics by key tiles, then delta, then dq by key tiles;
dk and dv by key tiles walking the query tiles with those statistics)
against the plain core ``attn_bwd_core_plain``: the delta formulation gives
the same dqkv (fp32 1e-5 of the output scale; bf16 two units in the last
place at the output's largest magnitude, since the casts fall on fp32
values summed in another order).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ovmr_tpu.ops.block_fused_bwd import attn_half_bwd_dx as j_attn_half_bwd_dx
from ovmr_tpu_torch.ops.block_fused_bwd import attn_bwd_core_plain, attn_half_bwd_dx

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
D, HEADS = 64, 4
NAMES = ("w_qkv", "b_qkv", "w_out", "ln_1_scale", "ln_1_bias")


def _mask(kind, l):
    """None, causal (-inf above the diagonal), or random additive entries
    with a quarter of them pushed down towards -1e4."""
    if kind == "none":
        return None
    if kind == "causal":
        return np.triu(np.full((l, l), -np.inf, np.float32), 1)
    rng = np.random.RandomState(l)
    m = rng.randn(l, l).astype(np.float32)
    drop = rng.rand(l, l).astype(np.float32)
    return np.where(drop < 0.25, -1e4 * drop * 4, m).astype(np.float32)


def _attn_layer(seed):
    rng = np.random.RandomState(seed)
    return {
        "w_qkv": (rng.randn(D, 3 * D) * D ** -0.5).astype(np.float32),
        "b_qkv": (0.05 * rng.randn(3 * D)).astype(np.float32),
        "w_out": (0.5 * rng.randn(D, D) * D ** -0.5).astype(np.float32),
        "ln_1_scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
        "ln_1_bias": (0.05 * rng.randn(D)).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
@pytest.mark.parametrize("l", [197, 577])
def test_attn_half_bwd_dx_plain_matches_pallas_at_vision_lengths(dtype, mask_kind, l):
    jdt, tdt, tol = DTYPES[dtype]
    p = _attn_layer(l)
    rng = np.random.RandomState(l + 1)
    x = (0.25 * rng.randn(1, l, D)).astype(np.float32)
    g = (0.15 * rng.randn(1, l, D)).astype(np.float32)
    mask = _mask(mask_kind, l)
    ref = j_attn_half_bwd_dx(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), *(jnp.asarray(p[k], jdt) for k in NAMES),
        mask=None if mask is None else jnp.asarray(mask), n_head=HEADS, interpret=True,
    )
    got = attn_half_bwd_dx(
        torch.tensor(x).to(tdt), torch.tensor(g).to(tdt),
        *(torch.tensor(p[k]).to(tdt) for k in NAMES),
        mask=None if mask is None else torch.tensor(mask), n_head=HEADS,
    )
    ref = np.asarray(ref, np.float32)
    assert got.dtype == tdt and np.abs(ref).max() < 2.0
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def _tiled_core_model(q, k, v, do, mask, scale, cast, kt=64, qt=128, kv_qt=64):
    """The query-tiled attention-backward core of one head, step by step in
    numpy fp32: q-side blocks of ``qt`` queries make three passes over key
    tiles of ``kt`` (running max and sum; delta = sum P dP with the
    normalised probs; dS = cast(P (dP - delta) scale), dq += dS k), kv-side
    blocks of ``qt`` keys walk query tiles of ``kv_qt`` with those
    statistics (dv += cast(P)^T dO, dk += dS^T q). ``cast`` rounds to the
    activation dtype."""
    L = q.shape[0]
    if mask is None:
        mask = np.zeros((L, L), np.float32)
    f32 = np.float32

    def probs(s, m, l):
        return np.exp(s - m[:, None]) / l[:, None]

    m_all, l_all, d_all = (np.zeros(L, f32) for _ in range(3))
    dq = np.zeros_like(q)
    for q0 in range(0, L, qt):
        qb, ob = q[q0:q0 + qt], do[q0:q0 + qt]
        m = np.full(len(qb), -np.inf, f32)
        l = np.zeros(len(qb), f32)
        tiles = [(k0, (qb @ k[k0:k0 + kt].T) * f32(scale) + mask[q0:q0 + qt, k0:k0 + kt])
                 for k0 in range(0, L, kt)]
        for _, s in tiles:  # pass 0
            mx = np.maximum(m, s.max(1))
            with np.errstate(invalid="ignore"):
                keep = np.where(m == -np.inf, f32(0), l * np.exp(m - mx))
            l = keep + np.exp(s - mx[:, None]).sum(1)
            m = mx
        delta = np.zeros(len(qb), f32)
        for k0, s in tiles:  # pass 1
            delta += (probs(s, m, l) * (ob @ v[k0:k0 + kt].T)).sum(1)
        acc = np.zeros_like(qb)
        for k0, s in tiles:  # pass 2
            ds = cast(probs(s, m, l) * (ob @ v[k0:k0 + kt].T - delta[:, None]) * f32(scale))
            acc += ds @ k[k0:k0 + kt]
        dq[q0:q0 + qt] = cast(acc)
        m_all[q0:q0 + qt], l_all[q0:q0 + qt], d_all[q0:q0 + qt] = m, l, delta
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for k0 in range(0, L, qt):
        kb, vb = k[k0:k0 + qt], v[k0:k0 + qt]
        ak, av = np.zeros_like(kb), np.zeros_like(vb)
        for i0 in range(0, L, kv_qt):
            sl = slice(i0, i0 + kv_qt)
            s_t = (kb @ q[sl].T) * f32(scale) + mask[sl, k0:k0 + qt].T
            p_t = np.exp(s_t - m_all[sl][None]) / l_all[sl][None]
            ds_t = p_t * (vb @ do[sl].T - d_all[sl][None]) * f32(scale)
            av += cast(p_t) @ do[sl]
            ak += cast(ds_t) @ q[sl]
        dk[k0:k0 + qt], dv[k0:k0 + qt] = cast(ak), cast(av)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
@pytest.mark.parametrize("l,dh", [(77, 64), (197, 64), (577, 16), (130, 40)])
def test_tiled_core_model_matches_the_plain_core(dtype, mask_kind, l, dh):
    tdt = DTYPES[dtype][1]
    heads = 2
    rng = np.random.RandomState(l * 7 + dh)
    qkv = torch.tensor(rng.randn(1, l, 3 * heads * dh).astype(np.float32)).to(tdt)
    dattn = torch.tensor(rng.randn(1, l, heads * dh).astype(np.float32)).to(tdt)
    mask = _mask(mask_kind, l)
    ref = attn_bwd_core_plain(qkv, dattn, None if mask is None else torch.tensor(mask),
                              heads).float().numpy()[0]

    def cast(a):
        return torch.tensor(np.asarray(a, np.float32)).to(tdt).float().numpy()

    w = heads * dh
    q, k, v = (qkv.float().numpy()[0, :, i * w:(i + 1) * w] for i in range(3))
    do = dattn.float().numpy()[0]
    got = np.zeros_like(ref)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        for i, part in enumerate(_tiled_core_model(q[:, cols], k[:, cols], v[:, cols],
                                                   do[:, cols], mask, dh ** -0.5, cast)):
            got[:, i * w + h * dh:i * w + (h + 1) * dh] = part
    assert np.isfinite(got).all()
    peak = max(float(np.abs(ref).max()), 1.0)
    tol = 1e-5 * peak if dtype == "fp32" else 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    assert float(np.abs(got - ref).max()) <= tol

