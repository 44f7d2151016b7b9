"""The port's ``data/autoaugment.py`` gives the JAX package's bytes.

Every primitive op at every magnitude bin, every policy (ImageNetPolicy,
CIFAR10Policy, SVHNPolicy, RandAugment, RandAugment2, RandAugmentFixMatch,
AugMix) and every policy choice of ``build_transform``, on the same image
with the same ``random.Random`` seed in both packages.
"""

import random

import numpy as np
import pytest

from ovmr_tpu.data import autoaugment as jaa
from ovmr_tpu.data import transforms as jtransforms
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.data import autoaugment as aa
from ovmr_tpu_torch.data import transforms
from ovmr_tpu_torch.utils import get_cfg_default


def _image(seed=0, h=36, w=44):
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, w, dtype=np.float32)[None, :, None] * np.ones((h, 1, 3))
    noise = rng.integers(0, 60, (h, w, 3))
    return Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8))


def test_tables_are_the_jax_package_s():
    assert set(aa.OPS) == set(jaa.OPS)
    assert aa.RANDAUGMENT_LIST == jaa.RANDAUGMENT_LIST
    assert aa.FIXMATCH_LIST == jaa.FIXMATCH_LIST
    for k in jaa._RANGES:
        np.testing.assert_array_equal(aa._RANGES[k], jaa._RANGES[k])
    for cls in ("ImageNetPolicy", "CIFAR10Policy", "SVHNPolicy"):
        assert getattr(aa, cls).TABLE == getattr(jaa, cls).TABLE


@pytest.mark.parametrize("op", sorted(set(jaa._RANGES) | {"flip", "identity"}))
def test_each_op_gives_the_jax_bytes(op):
    img = _image()
    for m in (0, 4, 9):
        for seed in (0, 1):
            want = jaa._apply(img, op, m, random.Random(seed)) if op in jaa._RANGES else \
                jaa.OPS[op](img, 0.0, random.Random(seed))
            got = aa._apply(img, op, m, random.Random(seed)) if op in aa._RANGES else \
                aa.OPS[op](img, 0.0, random.Random(seed))
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f"{op} {m}")


POLICIES = {
    "ImageNetPolicy": (), "CIFAR10Policy": (), "SVHNPolicy": (),
    "RandAugment": (2, 10), "RandAugment2": (2, 0.6), "RandAugmentFixMatch": (2,),
    "AugMix": (),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_each_policy_gives_the_jax_bytes(policy):
    args = POLICIES[policy]
    port, jax_p = getattr(aa, policy)(*args), getattr(jaa, policy)(*args)
    for seed in range(6):
        img = _image(seed)
        a, b = port(img, random.Random(seed)), jax_p(img, random.Random(seed))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"seed {seed}")


def _cfg(make, choices):
    cfg = make()
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.TRANSFORMS = tuple(choices)
    return cfg


@pytest.mark.parametrize("choice", sorted(transforms.POLICY_CHOICES))
def test_policy_choices_build_the_jax_pipeline(choice):
    choices = ["random_flip", choice, "cutout", "normalize"]
    port = transforms.build_transform(_cfg(get_cfg_default, choices), is_train=True)
    jax_t = jtransforms.build_transform(_cfg(j_cfg, choices), is_train=True)
    for seed in range(3):
        img = _image(seed)
        np.testing.assert_array_equal(port(img, rng=random.Random(seed)),
                                      jax_t(img, rng=random.Random(seed)))
