"""The port's host data layer (``ovmr_tpu_torch/data``) against the JAX
package's (``ovmr_tpu/data``): the reference-written few-shot pickle and
split files, class subsampling and few-shot draws, the samplers' index
streams per seed, every ported transform choice per seed, the Synthetic
dataset's files, and ``DataManager``'s batches on the DTD fixture and on
Synthetic (impaths, labels, pixels bit-equal). Importing the package loads
neither PIL nor yaml."""

import os
import os.path as osp
import random
import subprocess
import sys

import numpy as np
import pytest

from ovmr_tpu.data import datum as jdatum
from ovmr_tpu.data import samplers as jsamplers
from ovmr_tpu.data import transforms as jtransforms
from ovmr_tpu.data.manager import DataManager as JDataManager
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.data import datum, samplers, transforms
from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
DTD = osp.join(ROOT, "tests", "fixtures", "e2e_mm_dataset")
PICKLE = osp.join(DTD, "dtd", "split_fewshot", "shot_8-seed_1.pkl")
SPLIT = osp.join(DTD, "dtd", "split_zhou_DescribableTextures.json")


def _rows(items):
    return [(d.impath, d.label, d.domain, d.classname) for d in items]


def test_reference_fewshot_pickle_and_split():
    port, jax_data = datum.load_fewshot_pickle(PICKLE), jdatum.load_fewshot_pickle(PICKLE)
    assert sorted(port) == sorted(jax_data)
    for key in port:
        assert _rows(port[key]) == _rows(jax_data[key])
        assert all(isinstance(d, datum.Datum) for d in port[key])
    assert len(port["train"]) == 32
    prefix = osp.join(DTD, "dtd", "images")
    for a, b in zip(datum.read_split(SPLIT, prefix), jdatum.read_split(SPLIT, prefix)):
        assert _rows(a) == _rows(b)


def test_split_files_subsampling_and_fewshot(tmp_path):
    prefix = osp.join(DTD, "dtd", "images")
    train, val, test = datum.read_split(SPLIT, prefix)
    datum.save_split(train, val, test, str(tmp_path / "p.json"), prefix)
    jt, jv, je = jdatum.read_split(SPLIT, prefix)
    jdatum.save_split(jt, jv, je, str(tmp_path / "j.json"), prefix)
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    for mode in ("all", "base", "new"):
        got = datum.subsample_classes(train, val, test, subsample=mode)
        want = jdatum.subsample_classes(jt, jv, je, subsample=mode)
        assert [_rows(s) for s in got] == [_rows(s) for s in want]
    for shots, repeat in ((2, False), (5, True), (50, False)):
        got = datum.generate_fewshot_dataset(train, val, num_shots=shots, repeat=repeat,
                                             rng=random.Random(4))
        want = jdatum.generate_fewshot_dataset(jt, jv, num_shots=shots, repeat=repeat,
                                               rng=random.Random(4))
        assert [_rows(s) for s in got] == [_rows(s) for s in want]
    got = datum.generate_fewshot_dataset_eval(train, num_shots=1, seed=2,
                                              exist_few_shot_train=train[::3])
    want = jdatum.generate_fewshot_dataset_eval(jt, num_shots=1, seed=2,
                                                exist_few_shot_train=jt[::3])
    assert _rows(got) == _rows(want)
    path = str(tmp_path / "fs" / "shot.pkl")
    datum.save_fewshot_pickle(path, {"train": train[:5]})
    assert _rows(jdatum.load_fewshot_pickle(path)["train"]) == _rows(train[:5])


def _items(labels, domains=None):
    domains = domains if domains is not None else [0] * len(labels)
    return [datum.Datum(impath=f"{i}.png", label=int(l), domain=int(d))
            for i, (l, d) in enumerate(zip(labels, domains))]


@pytest.mark.parametrize("name,batch,n_ins", [
    ("SequentialSampler", 8, 4), ("RandomSampler", 8, 4), ("RandomClassSampler", 12, 4),
    ("RandomClassSampler", 16, 8), ("RandomFullClassSampler", 8, 4),
    ("RandomDomainSampler", 6, 4), ("SeqDomainSampler", 6, 4),
])
def test_samplers_give_the_jax_index_streams(name, batch, n_ins):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 7, 90)
    labels[:3] = [6, 6, 5]  # some classes short of n_ins
    items = _items(labels, rng.integers(0, 3, 90))
    port = samplers.build_sampler(name, items, batch, n_ins)
    jax_s = jsamplers.build_sampler(name, items, batch, n_ins)
    for seed in range(4):
        np.testing.assert_array_equal(port.epoch_indices(np.random.default_rng(seed)),
                                      jax_s.epoch_indices(np.random.default_rng(seed)))
    with pytest.raises(ValueError):
        samplers.build_sampler("Nope", items, batch)


def _cfg(make, choices, size=(48, 40), interp="bicubic"):
    cfg = make()
    cfg.INPUT.SIZE = size
    cfg.INPUT.TRANSFORMS = tuple(choices)
    cfg.INPUT.INTERPOLATION = interp
    cfg.INPUT.RRCROP_SCALE = (0.25, 1.0)
    cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    return cfg


FLAGSHIP = ["random_resized_crop", "random_flip", "colorjitter", "gaussian_noise", "normalize"]


@pytest.mark.parametrize("choices", [
    FLAGSHIP,
    ["random_resized_crop"], ["random_flip"], ["colorjitter"], ["gaussian_noise"],
    ["normalize"], ["center_crop"], ["instance_norm"], ["random_crop"],
    ["random_translation"], ["cutout"], ["randomgrayscale"], ["gaussian_blur"],
    ["random_crop", "random_flip", "cutout", "normalize"],
])
@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
def test_train_transforms_match_the_jax_packages(choices, interp):
    from PIL import Image

    rng = np.random.default_rng(5)
    imgs = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
            for h, w in ((64, 80), (50, 50), (90, 40))]
    port = transforms.build_transform(_cfg(get_cfg_default, choices, interp=interp))
    jax_t = jtransforms.build_transform(_cfg(j_cfg, choices, interp=interp))
    assert port.stochastic
    for i, img in enumerate(imgs * 3):
        np.testing.assert_array_equal(port(img, rng=random.Random(i)),
                                      jax_t(img, rng=random.Random(i)))


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("choices", [["normalize"], ["instance_norm"], []])
def test_test_transforms_match_the_jax_packages(uint8, choices):
    from PIL import Image

    rng = np.random.default_rng(6)
    for h, w in ((320, 240), (100, 130), (48, 40)):
        img = Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
        port = transforms.build_transform(_cfg(get_cfg_default, choices), is_train=False,
                                          uint8=uint8)
        jax_t = jtransforms.build_transform(_cfg(j_cfg, choices), is_train=False, uint8=uint8)
        a, b = port(img), jax_t(img)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_transform_refusals_and_resampling_codes():
    from PIL import Image

    assert (transforms.NEAREST, transforms.BILINEAR, transforms.BICUBIC) == (
        Image.NEAREST, Image.BILINEAR, Image.BICUBIC)
    # the seven policy choices build and run (data/autoaugment.py)
    img = Image.fromarray(np.full((40, 48, 3), 90, np.uint8))
    for choice in sorted(transforms.POLICY_CHOICES):
        tfm = transforms.build_transform(_cfg(get_cfg_default, ["normalize", choice]))
        out = tfm(img, rng=random.Random(0))
        assert out.dtype == np.float32 and out.shape[0] == 3
    with pytest.raises(ValueError, match="unknown transform"):
        transforms.build_transform(_cfg(get_cfg_default, ["nope"]))
    cfg = _cfg(get_cfg_default, ["normalize"])
    cfg.INPUT.NO_TRANSFORM = True
    assert transforms.build_transform(cfg) is None


def test_importing_the_data_layer_loads_neither_pil_nor_yaml():
    # against the modules the interpreter had before the imports
    code = ("import sys; before = set(sys.modules); "
            "import ovmr_tpu_torch.data, ovmr_tpu_torch.data.datasets, ovmr_tpu_torch.utils, "
            "ovmr_tpu_torch.evaluation, ovmr_tpu_torch.engine.trainer; "
            "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in ('PIL', 'yaml')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


def _manager_cfg(make, root, name, shots, choices, size, batch, n_ins, test_batch):
    cfg = make()
    cfg.SEED = 1
    cfg.DATASET.ROOT = root
    cfg.DATASET.NAME = name
    cfg.DATASET.NUM_SHOTS = shots
    cfg.INPUT.SIZE = size
    cfg.INPUT.TRANSFORMS = tuple(choices)
    cfg.INPUT.RRCROP_SCALE = (0.25, 1.0)
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomClassSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = batch
    cfg.DATALOADER.TRAIN_X.N_INS = n_ins
    cfg.DATALOADER.TEST.BATCH_SIZE = test_batch
    cfg.DATALOADER.NUM_WORKERS = 3
    return cfg


def _assert_same_batches(port, jax_dm, port_root, jax_root, epochs=2):
    for loader in ("train_loader_x", "eval_set_loader", "test_loader", "val_loader"):
        p_loader, j_loader = getattr(port, loader), getattr(jax_dm, loader)
        assert (p_loader is None) == (j_loader is None), loader
        if p_loader is None:
            continue
        assert len(p_loader) == len(j_loader), loader
        for _ in range(epochs):
            n = 0
            for a, b in zip(p_loader, j_loader):
                assert [p.replace(port_root, "") for p in a["impath"]] == \
                    [p.replace(jax_root, "") for p in b["impath"]], loader
                np.testing.assert_array_equal(a["label"], b["label"])
                assert a["img"].dtype == b["img"].dtype, loader
                np.testing.assert_array_equal(a["img"], b["img"])
                n += 1
            assert n == len(p_loader), loader
    assert port.num_classes == jax_dm.num_classes and port.lab2cname == jax_dm.lab2cname


@pytest.mark.parametrize("choices", [["normalize"], FLAGSHIP])
def test_data_manager_on_the_dtd_fixture(tmp_path, choices):
    import shutil

    root = str(tmp_path / "data")
    shutil.copytree(DTD, root)
    port = DataManager(_manager_cfg(get_cfg_default, root, "DescribableTextures", 8, choices,
                                    (64, 64), 16, 4, 16))
    jax_dm = JDataManager(_manager_cfg(j_cfg, root, "DescribableTextures", 8, choices,
                                       (64, 64), 16, 4, 16))
    _assert_same_batches(port, jax_dm, root, root)


def test_data_manager_on_synthetic(tmp_path, monkeypatch):
    monkeypatch.setenv("OVMR_SYNTHETIC", "6,8,40")
    p_root, j_root = str(tmp_path / "p"), str(tmp_path / "j")
    args = ("Synthetic", 4, FLAGSHIP, (32, 32), 12, 2, 8)
    port = DataManager(_manager_cfg(get_cfg_default, p_root, *args))
    jax_dm = JDataManager(_manager_cfg(j_cfg, j_root, *args))
    # the same files, byte for byte, at the same paths
    p_files = sorted(osp.relpath(osp.join(d, f), p_root)
                     for d, _, fs in os.walk(p_root) for f in fs)
    j_files = sorted(osp.relpath(osp.join(d, f), j_root)
                     for d, _, fs in os.walk(j_root) for f in fs)
    assert p_files == j_files and len(p_files) == 48
    for f in p_files:
        with open(osp.join(p_root, f), "rb") as a, open(osp.join(j_root, f), "rb") as b:
            assert a.read() == b.read(), f
    _assert_same_batches(port, jax_dm, p_root, j_root)
    # a second construction reuses the files
    again = DataManager(_manager_cfg(get_cfg_default, p_root, *args))
    assert [d.impath for d in again.dataset.train_x] == [d.impath for d in port.dataset.train_x]


def test_data_manager_refuses_what_waits(tmp_path):
    # nothing waits any more: DATALOADER.MULTI_RES_COLLATE is ported
    # (tests/test_torch_multires.py), and RETURN_IMG0 and TEXT_ONLY build and
    # give the JAX package's train batches (more in tests/test_torch_da_data.py)
    for key in ("DATALOADER.RETURN_IMG0", "TEXT_ONLY"):
        managers = []
        for make, cls in ((get_cfg_default, DataManager), (j_cfg, JDataManager)):
            cfg = _manager_cfg(make, DTD, "DescribableTextures", 8, FLAGSHIP, (32, 32), 16, 4, 16)
            cfg.merge_from_list([key, "True"])
            managers.append(cls(cfg))
        port, jax_dm = managers
        for a, b in zip(port.train_loader_x, jax_dm.train_loader_x):
            assert sorted(a) == sorted(b) and a["impath"] == b["impath"]
            for name in set(a) - {"impath", "_local"}:
                np.testing.assert_array_equal(a[name], b[name], err_msg=f"{key} {name}")
            assert ("img0" in a) == (key == "DATALOADER.RETURN_IMG0")
            assert ("img" in a) == (key != "TEXT_ONLY")
