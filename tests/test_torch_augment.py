"""The port's device augmentation and preprocessing against the JAX
package's, on the CPU.

Torch and JAX random streams cannot match, so every random number is drawn
in JAX, in the order ``ovmr_tpu.ops.augment.augment_batch`` draws it, and
handed to the port's draw-free functions. Inputs are numpy from a seed.

Tolerances: the crop boxes within 4 fp32 ulp of the box scale (XLA's CPU
``log`` and ``exp`` are not correctly rounded, torch's are, so the boxes
cannot be bit-equal; the valid-try pick and the fallback are exact, or the
boxes would differ by whole pixels); the fp32 crops within 1e-5 of the
0-255 scale (sums of up to S products in another order); bf16 crops within
1.0 on that scale; ``augment_batch`` fp32 atol 1e-4 and bf16 atol 3.2e-2
(normalised outputs up to ~4, where one bf16 ulp is 1.6e-2);
``preprocess_batch`` fp32 atol 1e-4 (``F.interpolate`` with antialias
against ``jax.image.resize``, within ~1.1e-5 on [0, 1] before the division
by the std).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.ops import augment as jaug
from ovmr_tpu.ops.preprocess import preprocess_batch as j_preprocess_batch
from ovmr_tpu_torch.ops import augment as taug
from ovmr_tpu_torch.ops.preprocess import preprocess_batch

SCALES = [(0.25, 1.0), (0.08, 1.0), (0.95, 1.0)]


def jax_draws(key, b, s, out_size, scale=(0.25, 1.0), jitter=(0.4, 0.4, 0.4, 0.1),
              gn_std=0.15):
    """The draws of ``ovmr_tpu.ops.augment.augment_batch(images, key)``, by
    its own key splits, as the port's ``sample_augment_draws`` dict (numpy)."""
    k_crop, k_flip, k_jit, k_noise, k_noise_p = jax.random.split(key, 5)
    x0, y0, cw, ch = jaug._sample_crop_boxes(k_crop, b, s, scale)
    kb, kc, ks, kh = jax.random.split(k_jit, 4)
    bri, con, sat, hue = jitter

    def u(k, lo, hi):
        return jax.random.uniform(k, (b,), minval=lo, maxval=hi)

    d = dict(x0=x0, y0=y0, cw=cw, ch=ch, flip=jax.random.bernoulli(k_flip, 0.5, (b,)),
             fb=u(kb, max(0, 1 - bri), 1 + bri), fc=u(kc, max(0, 1 - con), 1 + con),
             fs=u(ks, max(0, 1 - sat), 1 + sat),
             fh=u(kh, -hue, hue) * 2 * jnp.pi if hue > 0 else None,
             noise_gate=None, noise=None)
    if gn_std > 0:
        d["noise_gate"] = jax.random.bernoulli(k_noise_p, 0.5, (b,))
        d["noise"] = jax.random.normal(k_noise, (b, out_size, out_size, 3)) * gn_std
    return {k: None if v is None else np.asarray(v) for k, v in d.items()}


def to_torch(draws):
    return {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _boxes(seed, b=8):
    rng = np.random.RandomState(seed)
    s = 64
    cw = rng.uniform(10, s, b).astype(np.float32)
    ch = rng.uniform(10, s, b).astype(np.float32)
    x0 = (rng.rand(b) * (s - cw)).astype(np.float32)
    y0 = (rng.rand(b) * (s - ch)).astype(np.float32)
    img = rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8)
    return img, x0, y0, cw, ch


@pytest.mark.parametrize("scale", SCALES)
def test_crop_boxes_from_the_jax_uniforms(scale):
    b, s = 16, 256
    key = jax.random.PRNGKey(7)
    k_area, k_ratio, k_x, k_y, _ = jax.random.split(key, 5)
    want = jaug._sample_crop_boxes(key, b, s, scale)
    uniforms = [jax.random.uniform(k_area, (b, taug.TRIES)),
                jax.random.uniform(k_ratio, (b, taug.TRIES)),
                jax.random.uniform(k_x, (b,)), jax.random.uniform(k_y, (b,))]
    got = taug._crop_boxes(*(torch.from_numpy(np.asarray(u)) for u in uniforms), s, scale)
    for name, w, g in zip(("x0", "y0", "cw", "ch"), want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        tol = 4 * np.spacing(np.float32(s))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=name)
    # the full-frame fallback exactly where JAX takes it
    np.testing.assert_array_equal(got[2].numpy() == s, np.asarray(want[2]) == s)


def test_sample_crop_boxes_draws_valid_boxes():
    g = torch.Generator().manual_seed(0)
    x0, y0, cw, ch = taug._sample_crop_boxes(g, 64, 100, (0.25, 1.0))
    assert (cw <= 100).all() and (ch <= 100).all() and (cw > 0).all()
    assert (x0 >= 0).all() and (x0 + cw <= 100 + 1e-4).all()
    assert (y0 >= 0).all() and (y0 + ch <= 100 + 1e-4).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_interp_weights_match_jax(seed):
    _, x0, _, cw, _ = _boxes(seed)
    want = np.asarray(jaug._interp_weights(jnp.asarray(x0), jnp.asarray(cw), 64, 48))
    got = taug._interp_weights(torch.from_numpy(x0), torch.from_numpy(cw), 64, 48).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flip", [False, True])
def test_matmul_crop_matches_jax(dtype, flip):
    img, x0, y0, cw, ch = _boxes(2)
    fl = np.arange(len(x0)) % 2 == 0 if flip else None
    want = np.asarray(jaug._matmul_crop(
        jnp.asarray(img), *(jnp.asarray(a) for a in (x0, y0, cw, ch)), 40,
        flip=None if fl is None else jnp.asarray(fl), dtype=getattr(jnp, dtype)))
    got = taug._matmul_crop(
        torch.from_numpy(img), *(torch.from_numpy(a) for a in (x0, y0, cw, ch)), 40,
        flip=None if fl is None else torch.from_numpy(fl), dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 * 255.0 if dtype == "float32" else 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_bilinear_crop_matches_jax_and_the_matmul_crop():
    img, x0, y0, cw, ch = _boxes(3)
    args = [torch.from_numpy(a) for a in (x0, y0, cw, ch)]
    want = np.asarray(jaug._bilinear_crop(jnp.asarray(img),
                                          *(jnp.asarray(a) for a in (x0, y0, cw, ch)), 40))
    got = taug._bilinear_crop(torch.from_numpy(img), *args, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * 255.0)
    mm = taug._matmul_crop(torch.from_numpy(img), *args, 40, dtype=torch.float32)
    np.testing.assert_allclose(mm.numpy(), got.numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("hue", [0.0, 0.1])
def test_color_jitter_matches_jax(hue):
    b = 6
    x = np.random.RandomState(4).rand(b, 20, 20, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jaug._color_jitter(jnp.asarray(x), key, 0.4, 0.4, 0.4, hue))
    kb, kc, ks, kh = jax.random.split(key, 4)
    f = [np.asarray(jax.random.uniform(k, (b,), minval=0.6, maxval=1.4)) for k in (kb, kc, ks)]
    fh = (np.asarray(jax.random.uniform(kh, (b,), minval=-hue, maxval=hue) * 2 * jnp.pi)
          if hue > 0 else None)
    got = taug._color_jitter(torch.from_numpy(x), *(torch.from_numpy(a) for a in f),
                             None if fh is None else torch.from_numpy(fh))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_augment_batch_matches_jax_with_its_draws(out_dtype, layout):
    b, s, out = 6, 64, 40
    imgs = np.random.RandomState(6).randint(0, 256, (b, s, s, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.augment_batch(
        jnp.asarray(imgs), key, out_size=out, out_dtype=getattr(jnp, out_dtype),
        out_layout=layout).astype(jnp.float32))
    draws = to_torch(jax_draws(key, b, s, out))
    got = taug.augment_batch(torch.from_numpy(imgs), draws, out_size=out,
                             out_dtype=getattr(torch, out_dtype), out_layout=layout)
    assert got.dtype == getattr(torch, out_dtype) and got.shape == want.shape
    tol = 1e-4 if out_dtype == "float32" else 3.2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_sample_augment_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(3)
    d = taug.sample_augment_draws(g, 32, 64, out_size=40)
    assert d["noise"].shape == (32, 40, 40, 3) and d["flip"].dtype == torch.bool
    for k, lo, hi in (("fb", 0.6, 1.4), ("fc", 0.6, 1.4), ("fs", 0.6, 1.4),
                      ("fh", -0.2 * math.pi, 0.2 * math.pi)):
        assert (d[k] >= lo).all() and (d[k] <= hi).all(), k
    assert 0 < int(d["flip"].sum()) < 32 and 0 < int(d["noise_gate"].sum()) < 32
    quiet = taug.sample_augment_draws(torch.Generator().manual_seed(3), 4, 64, out_size=40,
                                      jitter=(0.4, 0.4, 0.4, 0.0), gn_std=0.0)
    assert quiet["fh"] is None and quiet["noise"] is None and quiet["noise_gate"] is None
    # the same seed draws the same batch
    again = taug.sample_augment_draws(torch.Generator().manual_seed(3), 32, 64, out_size=40)
    for k, v in d.items():
        assert torch.equal(v, again[k]), k
    imgs = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (32, 64, 64, 3))
                            .astype(np.uint8))
    out = taug.augment_batch(imgs, d, out_size=40, out_dtype=torch.float32)
    assert out.shape == (32, 3, 40, 40) and torch.isfinite(out).all()


def test_augment_batch_refuses_an_unknown_layout():
    d = taug.sample_augment_draws(torch.Generator().manual_seed(0), 2, 16, out_size=8)
    with pytest.raises(ValueError, match="out_layout"):
        taug.augment_batch(torch.zeros(2, 16, 16, 3, dtype=torch.uint8), d, out_size=8,
                           out_layout="HWC")


@pytest.mark.parametrize("shape", [(2, 120, 160, 3), (2, 160, 120, 3), (2, 60, 90, 3)])
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_preprocess_batch_matches_jax(shape, method):
    imgs = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(j_preprocess_batch(jnp.asarray(imgs), size=96, method=method,
                                         out_dtype=jnp.float32))
    got = preprocess_batch(torch.from_numpy(imgs), size=96, method=method,
                           out_dtype=torch.float32)
    assert got.shape == want.shape == (2, 3, 96, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_preprocess_batch_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="method"):
        preprocess_batch(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), size=4, method="lanczos3")
