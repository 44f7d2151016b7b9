"""The plain reference against the program at a small size on the CPU, in
float32, where the two compute the same equations."""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import common, runner
from benchmark.reference import augment as ref_augment
from benchmark.reference import nn as ref_nn
from benchmark.reference import ovmr as ref_ovmr
from benchmark.reference import tokenizer as ref_tok

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, transformer_width=64, transformer_heads=2,
            transformer_layers=2, dtype="float32")
CFG = {**runner.make_cell(ROOT, "clip_vit_b16.generate", 0, "cpu").config, **TINY}


def test_tokenizer_copy_gives_the_ports_ids_on_every_lvis_name():
    from ovmr_tpu_torch.models.ovmr import build_prompt_tokens

    names = common.lvis_names(ROOT)
    assert len(names) == 1203
    for got, want in zip(ref_tok.prompt_tokens(names), build_prompt_tokens(names)):
        np.testing.assert_array_equal(got, want)


def test_tokenizer_refuses_what_it_cannot_read():
    with pytest.raises(ValueError):
        ref_tok.tokenize(["café"])


@pytest.fixture(scope="module")
def tiny_weights():
    gen = torch.Generator().manual_seed(7)
    w = common.make_weights(CFG, gen, "cpu")
    return w, common.reference_weights(w)


def test_generation_matches_the_program(tiny_weights):
    from ovmr_tpu_torch.api import OVMRGenerator

    w, w32 = tiny_weights
    program = OVMRGenerator(w["clip"], common.clip_config(CFG), w["agg"], dtype=torch.float32,
                            device="cpu")
    gen = torch.Generator().manual_seed(8)
    images = torch.randn((5, 4, 3, 32, 32), generator=gen)
    names = common.lvis_names(ROOT)[100:105]
    out = program.generate(names, images)
    feats = ref_nn.encode_image(w32["visual"], CFG, images.reshape(20, 3, 32, 32)).reshape(5, 4, -1)
    ref = ref_ovmr.classifiers(w32, CFG, names, feats)
    for key in ("mm_classifier", "vision_classifier", "text_classifier", "visual_tokens"):
        np.testing.assert_allclose(out[key], ref[key].numpy(), rtol=1e-4, atol=1e-5)
    weights, settled = ref_ovmr.fusion(
        feats, [ref[k] for k in ("mm_classifier", "vision_classifier", "text_classifier")],
        w32["logit_scale"], 10.0, 1e-3)
    assert settled.any()
    np.testing.assert_allclose(out["fusion_weight"][settled.numpy()], weights[settled].numpy(),
                               atol=1e-6)


def test_fusion_counts_f1_as_the_program():
    from ovmr_tpu_torch.ops.fusion import multiclass_f1

    gen = torch.Generator().manual_seed(3)
    preds = torch.randint(0, 6, (40,), generator=gen)
    labels = torch.arange(5).repeat_interleave(8)
    logits = torch.nn.functional.one_hot(preds, 6).float()
    np.testing.assert_array_equal(ref_ovmr.f1_per_class(preds, labels, 6).numpy(),
                                  multiclass_f1(logits, labels, 6).numpy())


def test_augmentation_matches_the_program():
    from ovmr_tpu_torch.ops.augment import augment_batch

    cell = runner.make_cell(ROOT, "clip_vit_b16.train", 11, "cpu",
                            {"config": TINY, "traffic": {"classes": 4, "instances": 8,
                                                         "image_side": 40}})
    driver = runner.make_driver(cell)
    draws = driver.draws(0)
    images = driver.pool[0].reshape(-1, 40, 40, 3)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    got = augment_batch(images, draws, out_size=32, mean=mean, std=std, out_dtype=torch.float32,
                        out_layout="NHWC")
    want = ref_augment.augment(images, draws, 32, mean, std)
    # the program rounds its interpolation weights to bf16: at most a few grey
    # levels (1/255 / 0.26 = 0.015 a level after normalisation)
    assert float((got - want).abs().max()) < 0.06
    assert float((got - want).abs().mean()) < 0.01


def test_training_steps_match_the_program():
    cell = runner.make_cell(ROOT, "clip_vit_b16.train", 12, "cpu",
                            {"config": TINY, "traffic": {"classes": 4, "instances": 8,
                                                         "image_side": 40}})
    driver = runner.make_driver(cell)
    driver.warm()
    numbers, info = driver.check(cell.limits)
    assert info["steps_checked"] == 3
    # float32 on both sides; the program's bf16 interpolation weights in the
    # augmentation move the images by a few grey levels
    assert numbers["loss_err"] < 2e-3
    assert numbers["grad_err"] < 2e-2
    assert numbers["delta_err"] < 2e-2
