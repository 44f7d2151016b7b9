"""The port's config system (``ovmr_tpu_torch/utils/{config,defaults}.py``)
against the JAX package's: the same default tree with a ``CUDA`` node in
place of the ``TPU`` node, the repo's yaml configs merged to the same
values, list overrides and freezing, and the ``TPU`` keys read onto their
``CUDA`` twins or refused."""

import glob
import os.path as osp

import pytest

from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.utils import CfgNode, get_cfg_default
from ovmr_tpu_torch.utils.defaults import TPU_KEYS_AT_DEFAULT, TPU_KEYS_ONTO_CUDA

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
YAMLS = sorted(osp.relpath(p, ROOT) for p in glob.glob(osp.join(ROOT, "configs", "**", "*.yaml"),
                                                     recursive=True))


def _leaves(node, prefix=""):
    out = {}
    for k, v in node.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_leaves(v, key) if isinstance(v, dict) else {key: v})
    return out


def _compare(port, jax_cfg):
    """Equal key for key outside the device nodes; every TPU key with a CUDA
    twin equal to it; the others at their defaults."""
    p, j = _leaves(port), _leaves(jax_cfg)
    p_rest = {k: v for k, v in p.items() if not k.startswith("CUDA.")}
    j_rest = {k: v for k, v in j.items() if not k.startswith("TPU.")}
    assert p_rest == j_rest
    for key in TPU_KEYS_ONTO_CUDA:
        assert p[f"CUDA.{key}"] == j[f"TPU.{key}"], key
    for key, default in TPU_KEYS_AT_DEFAULT.items():
        assert j[f"TPU.{key}"] == default, key


def test_defaults_equal_the_jax_packages_with_a_cuda_node():
    port, jax_cfg = get_cfg_default(), j_cfg()
    _compare(port, jax_cfg)
    tpu_keys = {k[len("TPU."):] for k in _leaves(jax_cfg) if k.startswith("TPU.")}
    assert tpu_keys == set(TPU_KEYS_ONTO_CUDA) | set(TPU_KEYS_AT_DEFAULT)
    cuda_keys = {k[len("CUDA."):] for k in _leaves(port) if k.startswith("CUDA.")}
    assert cuda_keys == set(TPU_KEYS_ONTO_CUDA) | {"DEVICE"}
    assert port.CUDA.DEVICE == "cuda"
    assert "TPU" not in port


@pytest.mark.parametrize("path", YAMLS)
def test_repo_yaml_merges_to_the_same_values(path):
    port, jax_cfg = get_cfg_default(), j_cfg()
    port.merge_from_file(osp.join(ROOT, path))
    jax_cfg.merge_from_file(osp.join(ROOT, path))
    _compare(port, jax_cfg)


def test_list_overrides_and_freeze():
    opts = ["OPTIM.LR", "0.01", "DATASET.NUM_SHOTS", "16", "INPUT.SIZE", "(64, 64)",
            "TEST.NO_TEST", "True", "INPUT.TRANSFORMS", "['normalize']",
            "TPU.CLASS_CHUNK", "512"]
    port, jax_cfg = get_cfg_default(), j_cfg()
    port.merge_from_list(opts)
    jax_cfg.merge_from_list(opts)
    _compare(port, jax_cfg)
    port.merge_from_list(["CUDA.DEVICE", "cpu"])
    assert port.OPTIM.LR == 0.01 and isinstance(port.OPTIM.LR, float)
    assert port.INPUT.SIZE == (64, 64) and port.TEST.NO_TEST is True
    assert port.CUDA.DEVICE == "cpu" and port.CUDA.CLASS_CHUNK == 512
    port.freeze()
    with pytest.raises(AttributeError):
        port.SEED = 5
    with pytest.raises(AttributeError):
        port.CUDA.DTYPE = "float32"
    port.defrost()
    port.CUDA.DTYPE = "float32"
    clone = port.clone()
    clone.OPTIM.LR = 123.0
    assert port.OPTIM.LR == 0.01
    with pytest.raises(ValueError):
        port.merge_from_list(["OPTIM.LR"])


def test_tpu_dtype_maps_onto_cuda_dtype(tmp_path):
    cfg = get_cfg_default()
    cfg.merge_from_list(["TPU.DTYPE", "float32"])
    assert cfg.CUDA.DTYPE == "float32"
    path = tmp_path / "t.yaml"
    path.write_text("TPU:\n  DTYPE: float16\n  INT8: True\n  MESH:\n    MODEL: 2\n")
    cfg.merge_from_file(str(path))
    assert cfg.CUDA.DTYPE == "float16" and cfg.CUDA.MESH.MODEL == 2 and cfg.CUDA.INT8 is True
    # at their JAX defaults, the keys with no CUDA twin are accepted
    cfg.merge_from_list(["TPU.INT8", "False", "TPU.CHECKPOINT_BACKEND", "npz",
                         "TPU.USE_FUSED_BLOCK", "True", "TPU.MESH.DATA", "-1"])
    assert "TPU" not in cfg


# the data axis, the sliced loader, the checkpoint backend and the GSPMD
# route have CUDA twins now: those keys map across off their defaults too
_MAPPED = {"TP_SPLIT_QKV": False, "CHECKPOINT_BACKEND": "orbax",
           "MULTIHOST_SLICED_LOADER": False, "MESH.DATA": 4}


@pytest.mark.parametrize("key,value", [
    ("USE_PALLAS_ATTENTION", "True"), ("USE_FUSED_BLOCK", "False"),
    ("TP_SPLIT_QKV", "False"), ("CHECKPOINT_BACKEND", "orbax"),
    ("MULTIHOST_SLICED_LOADER", "False"), ("MESH.DATA", "4"),
])
def test_unmapped_tpu_key_off_its_default_raises(tmp_path, key, value):
    """A TPU key with no CUDA twin raises off its default; one with a twin
    (``_MAPPED``) is read onto ``CUDA.<key>``, from the list and from a
    yaml file alike."""
    path = tmp_path / "t.yaml"
    node, leaf = ([*key.split(".")][:-1], key.split(".")[-1])
    text = "TPU:\n" + "".join(f"{'  ' * (i + 1)}{n}:\n" for i, n in enumerate(node))
    path.write_text(text + f"{'  ' * (len(node) + 1)}{leaf}: {value}\n")
    if key in _MAPPED:
        from_list = get_cfg_default()
        from_list.merge_from_list([f"TPU.{key}", value])
        from_file = get_cfg_default()
        from_file.merge_from_file(str(path))
        for cfg in (from_list, from_file):
            twin = cfg.CUDA
            for part in key.split("."):
                twin = twin[part]
            assert twin == _MAPPED[key] and "TPU" not in cfg, key
        return
    with pytest.raises(ValueError, match=f"TPU.{key}"):
        get_cfg_default().merge_from_list([f"TPU.{key}", value])
    with pytest.raises(ValueError, match=f"TPU.{key}"):
        get_cfg_default().merge_from_file(str(path))


def test_unknown_tpu_key_raises():
    with pytest.raises(KeyError, match="TPU.NOPE"):
        get_cfg_default().merge_from_list(["TPU.NOPE", "1"])


def test_a_plain_node_keeps_a_tpu_key():
    """Only a tree with a CUDA node reads TPU keys across."""
    node = CfgNode({"A": 1})
    node.merge_from_list(["TPU.DTYPE", "float32"])
    assert node.TPU.DTYPE == "float32"
