"""The port's ModifiedResNet image tower (``ovmr_tpu_torch/models/resnet.py``)
against the torch golden and the JAX package (``ovmr_tpu/models/resnet.py``),
on the CPU.

- the golden ``clip_rn_tiny_golden.npz`` (recorded from the reference
  ``clip/model.py``) through the port's importer: the config sniff and the
  image features at ``tests/test_resnet_parity.py``'s 5e-5;
- a ``TINY_RN`` tree in the JAX layout, converted by
  ``convert.clip_params_from_numpy``:
  the encode at fp32 within 1e-5 and at bf16 within 1e-2 of JAX's, at the
  native 64 px and off-native (the attention pool's positional resize, an
  equal-area non-square map included);
- ``CONFIGS`` equal to JAX's field for field, the smoke init's tree equal
  to the importer's, and the TorchScript archive of the golden's state dict
  ingested like its pickle;
- ``avg_pool``'s order of operations (fp32 sums, cast, then the division)
  against JAX's in bf16, bit for bit, and ``batch_norm``'s within one bf16
  step.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ovmr_tpu.models import clip as jclip
from ovmr_tpu.models import resnet as jresnet
from ovmr_tpu_torch.convert import clip_params_from_numpy
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import resnet as tresnet
from ovmr_tpu_torch.models.import_torch import (
    clip_config_from_state_dict,
    clip_params_from_state_dict,
    load_clip,
    load_torch_file,
)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDEN = osp.join(ROOT, "tests", "fixtures", "clip_rn_tiny_golden.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(np.asarray(data[k])) for k in data.files
          if k.startswith("sd.")}
    return data, sd


@pytest.fixture(scope="module")
def jax_tiny_rn():
    """A ``TINY_RN`` tree with numpy leaves in the JAX package's layout and
    the port's conversion of it (seeded by the port's init: JAX's eager
    init compiles every shape it draws, and the values' origin does not
    matter to the comparison)."""
    params = jax.tree_util.tree_map(lambda t: t.numpy(), tclip.init_params(tclip.TINY_RN, seed=3))
    return params, clip_params_from_numpy(params)


def test_config_sniff(golden):
    _, sd = golden
    cfg = clip_config_from_state_dict(sd)
    assert cfg.is_resnet and cfg.vision_layers == (1, 1, 1, 1)
    assert (cfg.vision_width, cfg.vision_heads, cfg.image_resolution, cfg.embed_dim) == (
        8, 4, 64, 64)
    assert cfg == _jax_cfg_of(golden)


def _jax_cfg_of(golden):
    from ovmr_tpu.models.import_torch import clip_config_from_state_dict as jsniff
    from tests.helpers import npz_state_dict

    data, _ = golden
    jcfg = jsniff(npz_state_dict(data, "sd"))
    return tclip.CLIPConfig(**{f: getattr(jcfg, f) for f in
                               tclip.CLIPConfig.__dataclass_fields__})


def test_golden_encode_through_the_importer(golden):
    """5e-5: ``tests/test_resnet_parity.py``'s tolerance for the same golden."""
    data, sd = golden
    params, cfg = clip_params_from_state_dict(sd)
    out = tclip.encode_image(params, cfg, torch.from_numpy(data["images"]))
    np.testing.assert_allclose(out.numpy(), data["img_feat"], atol=5e-5, rtol=5e-5)


def test_configs_equal_jax_field_for_field():
    assert set(tclip.CONFIGS) == set(jclip.CONFIGS)
    for name, jcfg in jclip.CONFIGS.items():
        cfg = tclip.CONFIGS[name]
        for field in tclip.CLIPConfig.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)
        assert cfg.is_resnet == jcfg.is_resnet and cfg.vision_heads == jcfg.vision_heads, name
    assert tclip.RN50.vision_heads == 32 and tclip.RN50x64.vision_heads == 64


@pytest.mark.parametrize("dtype,tol,hw", [
    (torch.float32, 1e-5, (64, 64)),
    (torch.bfloat16, 1e-2, (64, 64)),
    (torch.float32, 1e-5, (96, 64)),
    (torch.float32, 1e-5, (128, 32)),
], ids=["fp32-native", "bf16-native", "fp32-off-native", "fp32-equal-area-4x1"])
def test_encode_matches_jax(jax_tiny_rn, dtype, tol, hw):
    """1e-5 fp32 and 1e-2 bf16 (the repo's ladder). (96, 64) gives a 3 x 2
    map against the trained 2 x 2; (128, 32) a 4 x 1 map of the trained
    area, which must resize the table too."""
    jparams, tparams = jax_tiny_rn
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    x = np.random.default_rng(0).standard_normal((2, 3, *hw)).astype(np.float32)
    ref = jclip.encode_image(jclip.cast_params(jparams, jdt), jclip.TINY_RN, jnp.asarray(x))
    got = tclip.encode_image(tclip.cast_params(tparams, dtype), tclip.TINY_RN,
                             torch.from_numpy(x))
    assert got.dtype == dtype and got.shape == (2, tclip.TINY_RN.embed_dim)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=0)


def test_nhwc_layout_matches_nchw(jax_tiny_rn):
    _, tparams = jax_tiny_rn
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 64, 64))
                         .astype(np.float32))
    a = tclip.encode_image(tparams, tclip.TINY_RN, x)
    b = tclip.encode_image(tparams, tclip.TINY_RN, x.permute(0, 2, 3, 1), layout="NHWC")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_avg_pool_and_batch_norm_round_as_jax_in_bf16():
    """In bf16: the window sums in fp32, cast, then the division by 4, bit
    for bit; BatchNorm in fp32 with JAX's order, within one bf16 step."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 6, 6)).astype(np.float32) * 3
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tresnet.avg_pool(xt, 2).float().numpy(),
        np.asarray(jresnet.avg_pool(xj, 2).astype(jnp.float32)))
    bn = {k: rng.standard_normal(8).astype(np.float32) for k in ("scale", "bias", "mean")}
    bn["var"] = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    got = tresnet.batch_norm(xt, {k: torch.from_numpy(v) for k, v in bn.items()}).float().numpy()
    ref = np.asarray(jresnet.batch_norm(xj, {k: jnp.asarray(v) for k, v in bn.items()})
                     .astype(jnp.float32))
    # at most one bf16 step apart: XLA's CPU backend fuses the fp32
    # multiply-add, so a sum on a rounding boundary may round the other way
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() > 0.99


def test_smoke_init_tree_matches_the_importer(golden):
    """The seeded random tree has the importer's keys and shapes, so code
    downstream cannot tell them apart (``test_resnet_parity.py``)."""
    _, sd = golden
    params, cfg = clip_params_from_state_dict(sd)
    smoke = tclip.init_params(cfg, seed=0)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(smoke["visual"]) == shapes(params["visual"])
    assert smoke["visual"]["stages"][0][0]["bn3"]["scale"].abs().sum() == 0  # zeroed gamma


def test_converter_equals_the_importer_on_the_same_weights(golden):
    """The JAX importer's tree, through ``convert``, is the port importer's."""
    from ovmr_tpu.models.import_torch import clip_params_from_state_dict as jimport
    from tests.helpers import npz_state_dict

    data, sd = golden
    jparams, _ = jimport(npz_state_dict(data, "sd"))
    via_jax = clip_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    direct, _ = clip_params_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), via_jax))
    flat_b = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), direct))
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="attnpool"):
        bad = dict(jax.tree_util.tree_map(np.asarray, jparams))
        bad["visual"] = {k: v for k, v in bad["visual"].items() if k != "attnpool"}
        clip_params_from_numpy(bad)


def _module_holding(sd):
    """A module whose state dict is ``sd``: nested modules by key, each leaf
    a parameter (BatchNorm statistics as buffers)."""
    root = nn.Module()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        node = root
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, nn.Module())
            node = getattr(node, part)
        if "running" in leaf:
            node.register_buffer(leaf, value.clone())
        else:
            node.register_parameter(leaf, nn.Parameter(value.clone(), requires_grad=False))
    return root


class _Holder(nn.Module):
    def __init__(self, sd):
        super().__init__()
        self.inner = _module_holding(sd)

    def forward(self, x):
        return x


def test_torchscript_archive_ingests_like_the_state_dict(golden, tmp_path):
    """The reference loads OpenAI checkpoints with ``torch.jit.load`` first:
    an archive of the golden's ResNet state dict gives the same params and
    config as its pickle (``tests/test_torchscript_ingest.py``'s recipe)."""
    _, sd = golden
    model = _Holder(sd).eval()
    ts_path, sd_path = str(tmp_path / "rn_scripted.pt"), str(tmp_path / "rn_sd.pt")
    torch.jit.trace(model, torch.zeros(1)).save(ts_path)
    torch.save(sd, sd_path)
    archived = load_torch_file(ts_path)
    assert set(k[len("inner."):] for k in archived) == set(sd)
    (p_ts, cfg_ts) = clip_params_from_state_dict(
        {k[len("inner."):]: v for k, v in archived.items()})
    p_sd, cfg_sd = load_clip(sd_path)
    assert cfg_ts == cfg_sd and cfg_sd.is_resnet
    a = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), p_ts))
    b = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), p_sd))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
