"""The port's ``clip.load`` surface (``ovmr_tpu_torch/clip_compat.py``) and
``models/clip.clip_forward`` against the JAX package's
(``ovmr_tpu/clip_compat.py``, ``ovmr_tpu/models/clip.py:469``) on the CPU.

- one TINY reference checkpoint loaded by both ``load(path)`` at fp32:
  image and text features within 1e-5, the contrastive logits of
  ``CLIPModel.__call__`` and of ``clip_forward`` within 1e-4;
- ``available_models``, ``tokenize`` and the preprocess transform equal
  JAX's; every dtype, fp16 included, runs the towers through the fused
  block (K1/K2 on the card, their plain versions here); smoke mode (seeded random towers) and the unknown-name
  refusal; the model defaults to the CUDA card and raises without one.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ovmr_tpu_torch import clip_compat
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.ops.block_fused import fused_residual_block

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TRAJ = osp.join(ROOT, "tests", "fixtures", "trajectory_coop_golden.npz")


@pytest.fixture(scope="module")
def clip_pt(tmp_path_factory):
    data = np.load(TRAJ)
    path = tmp_path_factory.mktemp("clip") / "tiny_clip.pt"
    torch.save({k[len("clip."):]: torch.from_numpy(np.asarray(data[k]))
                for k in data.files if k.startswith("clip.")}, path)
    return str(path)


@pytest.fixture(scope="module")
def both(clip_pt):
    from ovmr_tpu import clip_compat as jclip_compat

    port, _ = clip_compat.load(clip_pt, dtype=torch.float32, device="cpu")
    jax_model, _ = jclip_compat.load(clip_pt, dtype=jnp.float32)
    return port, jax_model


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 3, 64, 64)).astype(np.float32)
    tokens = clip_compat.tokenize(["a photo of a cat", "a dog", "a red panda on a tree"])
    return images, tokens


def test_features_match_jax(both):
    port, jax_model = both
    images, tokens = _inputs()
    np.testing.assert_allclose(port.encode_image(images).numpy(),
                               np.asarray(jax_model.encode_image(images)), atol=1e-5)
    np.testing.assert_allclose(port.encode_text(tokens).numpy(),
                               np.asarray(jax_model.encode_text(tokens)), atol=1e-5)
    assert float(port.logit_scale) == pytest.approx(float(jax_model.logit_scale))


def test_logits_match_jax_and_clip_forward(both):
    from ovmr_tpu.models import clip as jclip

    port, jax_model = both
    images, tokens = _inputs()
    lpi, lpt = port(images, tokens)
    jlpi, jlpt = jax_model(images, tokens)
    assert lpi.dtype == torch.float32 and tuple(lpi.shape) == (3, 3)
    np.testing.assert_allclose(lpi.numpy(), np.asarray(jlpi), atol=1e-4)
    np.testing.assert_allclose(lpt.numpy(), np.asarray(jlpt), atol=1e-4)
    # the model-level function, on the same towers and inputs
    ours = tclip.clip_forward(port.params, port.cfg, torch.from_numpy(images),
                              torch.from_numpy(tokens))
    theirs = jclip.clip_forward(jax_model.params, jax_model.cfg, jnp.asarray(images),
                                jnp.asarray(tokens))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(ours[0].numpy(), lpi.numpy(), atol=1e-4)


def test_surface_equals_jax(clip_pt):
    from PIL import Image

    from ovmr_tpu import clip_compat as jclip_compat

    assert clip_compat.available_models() == jclip_compat.available_models()
    texts = ["a photo of a cat", "a diagram"]
    np.testing.assert_array_equal(clip_compat.tokenize(texts), jclip_compat.tokenize(texts))
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (50, 80, 3), np.uint8))
    np.testing.assert_array_equal(clip_compat._preprocess(64)(img),
                                  jclip_compat._preprocess(64)(img))
    _, preprocess = clip_compat.load(clip_pt, dtype=torch.float32, device="cpu")
    assert preprocess(img).shape == (3, 64, 64)


def test_block_route_by_dtype(clip_pt, monkeypatch):
    seen = []
    run_blocks = tclip.run_blocks

    def spy(*args, block_fn=None, **kwargs):
        seen.append(block_fn)
        return run_blocks(*args, block_fn=block_fn, **kwargs)

    monkeypatch.setattr(tclip, "run_blocks", spy)
    images, tokens = _inputs()
    for dtype in (torch.float16, torch.bfloat16):
        model, _ = clip_compat.load(clip_pt, dtype=dtype, device="cpu")
        assert model.dtype == dtype and model.params["logit_scale"].dtype == torch.float32
        seen.clear()
        lpi, lpt = model(images, tokens)
        assert seen == [fused_residual_block] * 2, (dtype, seen)
        assert lpi.dtype == torch.float32 and bool(torch.isfinite(lpi).all())
        assert torch.equal(lpi.T, lpt)


def test_smoke_mode_and_refusals(monkeypatch, tmp_path):
    monkeypatch.delenv("OVMR_CLIP_CKPT", raising=False)
    model, _ = clip_compat.load("TINY", download_root=str(tmp_path), dtype=torch.float32,
                                device="cpu", seed=3)
    again, _ = clip_compat.load("TINY", download_root=str(tmp_path), dtype=torch.float32,
                                device="cpu", seed=3)
    assert model.cfg == tclip.TINY
    assert torch.equal(model.params["visual"]["proj"], again.params["visual"]["proj"])
    with pytest.raises(KeyError, match="unknown model"):
        clip_compat.load("ViT-H/99", download_root=str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            clip_compat.load("TINY", download_root=str(tmp_path))
