"""The paths a ModifiedResNet backbone opens in the port, against the JAX
package on the CPU at fp32, with seeded ``TINY_RN`` towers (numpy leaves
in the JAX layout, given to both packages, and written once as a reference
state dict that both load through ``OVMR_CLIP_CKPT`` under the name
"RN50"):

- ``OVMRGenerator.generate()`` and ``classify()`` at ``TINY_RN`` (classifiers
  within 1e-4, fusion weights within 1e-3, scores within 1e-4:
  ``tests/test_torch_api.py``'s ladder), and the refusal where the image
  features are wider than the text tower (RN50's 1024 against 512), raised
  where and as the JAX package raises it;
- ``ZeroshotCLIP2`` through the entry point: its text classifier within
  1e-5, a test batch's scores within 1e-4;
- one ``CoOp`` step (sgd, lr 0.1, no momentum): the loss within 1e-5 and
  the ctx gradient within 1e-4 of its scale;
- ``clip_compat.load("RN50")``: the logits within 1e-4.
"""

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmr_tpu.models import clip as jclip
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.api import OVMRGenerator
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models.import_torch import TORCH_BLOCK_KEYS
from ovmr_tpu_torch.utils import get_cfg_default

NAMES = ["red circle", "green square", "blue triangle", "ski_mask"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_state_dict(params) -> dict:
    """A JAX CLIP tree with a ModifiedResNet image tower (numpy leaves) ->
    the reference OpenAI state dict (torch tensors, linear weights
    ``[out, in]``)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    sd = {}

    def conv_bn(prefix, node, conv, bn):
        sd[f"{prefix}.{conv[0]}.weight"] = t(node[conv[1]])
        p = node[bn[1]]
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{prefix}.{bn[0]}.{theirs}"] = t(p[ours])

    v = params["visual"]
    for i in (1, 2, 3):
        conv_bn("visual", v["stem"], (f"conv{i}", f"conv{i}_w"), (f"bn{i}", f"bn{i}"))
    for s, stage in enumerate(v["stages"], start=1):
        for b, block in enumerate(stage):
            pre = f"visual.layer{s}.{b}"
            for i in (1, 2, 3):
                conv_bn(pre, block, (f"conv{i}", f"conv{i}_w"), (f"bn{i}", f"bn{i}"))
            if "down_conv_w" in block:
                conv_bn(pre, block, ("downsample.0", "down_conv_w"), ("downsample.1", "down_bn"))
    ap = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = t(ap["positional_embedding"])
    for n in "qkvc":
        sd[f"visual.attnpool.{n}_proj.weight"] = t(np.asarray(ap[f"{n}_w"]).T)
        sd[f"visual.attnpool.{n}_proj.bias"] = t(ap[f"{n}_b"])
    tx = params["text"]
    sd["token_embedding.weight"] = t(tx["token_embedding"])
    sd["positional_embedding"] = t(tx["positional_embedding"])
    for i in range(tx["blocks"]["w_qkv"].shape[0]):
        for key, theirs, transpose in TORCH_BLOCK_KEYS:
            leaf = np.asarray(tx["blocks"][key][i])
            sd[f"transformer.resblocks.{i}.{theirs}"] = t(leaf.T if transpose else leaf)
    sd["ln_final.weight"] = t(tx["ln_final_scale"])
    sd["ln_final.bias"] = t(tx["ln_final_bias"])
    sd["text_projection"] = t(tx["text_projection"])
    sd["logit_scale"] = t(params["logit_scale"])
    return sd


def _numpy_tree(cfg, seed):
    """Seeded ``cfg`` towers as numpy leaves in the JAX package's layout
    (drawn by the port's init: which RNG made them does not matter to a
    parity test, and JAX's eager init compiles every shape it draws)."""
    return jax.tree_util.tree_map(lambda t: t.numpy(), tclip.init_params(cfg, seed=seed))


@pytest.fixture(scope="module")
def rn():
    return _numpy_tree(tclip.TINY_RN, 5)


@pytest.fixture(scope="module")
def rn_pt(rn, tmp_path_factory):
    path = tmp_path_factory.mktemp("rn") / "tiny_rn.pt"
    torch.save(_reference_state_dict(rn), path)
    return str(path)


def _images(seed, *shape):
    rng = np.random.RandomState(seed)
    base = rng.rand(shape[0], 1, *shape[2:])
    return (base + 0.3 * rng.rand(*shape)).astype(np.float32)


def _pair_generators(params, cfg, width):
    from ovmr_tpu.api import OVMRGenerator as JGen
    from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator

    agg = jax.tree_util.tree_map(
        np.asarray, j_init_aggregator(jax.random.PRNGKey(1), width=width, layers=2, n_ctx=2))
    jg = JGen(params, jclip.CLIPConfig(**dataclasses.asdict(cfg)), agg, dtype=jnp.float32)
    tg = OVMRGenerator(convert.clip_params_from_numpy(params), cfg,
                       convert.aggregator_params_from_numpy(agg), dtype=torch.float32,
                       device="cpu")
    return jg, tg


def test_generate_and_classify_match_jax(rn):
    jg, tg = _pair_generators(rn, tclip.TINY_RN, 64)
    exemplars = _images(0, 4, 3, 3, 64, 64)
    ref, got = jg.generate(NAMES, exemplars), tg.generate(NAMES, exemplars)
    assert set(got) == set(ref)
    for key, want in ref.items():
        tol = 1e-3 if key == "fusion_weight" else 1e-4
        np.testing.assert_allclose(got[key], want, atol=tol, rtol=0, err_msg=key)
    queries = np.random.RandomState(1).rand(5, 3, 64, 64).astype(np.float32)
    np.testing.assert_allclose(tg.classify(queries, got, mode="fusion"),
                               jg.classify(queries, ref, mode="fusion"), atol=1e-4, rtol=0)


def test_generate_refuses_where_jax_does():
    """Image features wider than the text tower (RN50: embed_dim 1024, text
    width 512) cannot be spliced into the prompts: both packages build the
    generator and raise the same ValueError in ``generate``."""
    cfg = dataclasses.replace(tclip.TINY_RN, embed_dim=32, image_resolution=32)
    jg, tg = _pair_generators(_numpy_tree(cfg, 2), cfg, 32)
    exemplars = _images(2, 2, 2, 3, 32, 32)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting") as theirs:
        jg.generate(["a", "b"], exemplars)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting") as ours:
        tg.generate(["a", "b"], exemplars)
    assert str(ours.value) == str(theirs.value)


def _synthetic_opts(backbone="RN50"):
    return ["DATASET.NAME", "Synthetic", "DATASET.NUM_SHOTS", "2", "INPUT.SIZE", "(64, 64)",
            "INPUT.TRANSFORMS", "['normalize']", "DATALOADER.TEST.BATCH_SIZE", "16",
            "DATALOADER.NUM_WORKERS", "2", "MODEL.BACKBONE.NAME", backbone]


def test_zeroshot_clip2_matches_jax(rn_pt, tmp_path, monkeypatch):
    from ovmr_tpu.engine import zsclip as _jzs  # noqa: F401  (registers)
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch import train as entry

    monkeypatch.setenv("OVMR_CLIP_CKPT", rn_pt)
    data = str(tmp_path / "data")
    port = entry.main(entry.build_parser().parse_args(
        ["--root", data, "--seed", "1", "--trainer", "ZeroshotCLIP2", "--no-train",
         "--output-dir", str(tmp_path / "zs")] + _synthetic_opts()
        + ["CUDA.DEVICE", "cpu", "CUDA.DTYPE", "float32"]))
    assert port.clip_cfg.is_resnet
    jcfg = j_cfg()
    jcfg.merge_from_list(_synthetic_opts() + ["TPU.DTYPE", "float32"])
    jcfg.DATASET.ROOT, jcfg.OUTPUT_DIR, jcfg.SEED = data, str(tmp_path / "jzs"), 1
    jcfg.TRAINER.NAME = "ZeroshotCLIP2"
    jtr = j_build_trainer(jcfg)
    np.testing.assert_allclose(port.text_classifier, np.asarray(jtr.text_classifier), atol=1e-5)
    port.prepare_test()
    jtr.prepare_test()
    batch = next(iter(port.dm.test_loader))
    np.testing.assert_allclose(port.model_inference(batch), jtr.model_inference(batch),
                               atol=1e-4)


class _DM:
    def __init__(self, classnames):
        self.dataset = type("DS", (), {"classnames": list(classnames)})()


def _coop_cfg(cfg, vt_path):
    cfg.MODEL.BACKBONE.NAME = "RN50"
    cfg.TRAINER.COOP.N_CTX = 2
    cfg.TRAINER.COOP.VISUAL_TOKEN_PATH = vt_path
    cfg.INPUT.SIZE = (64, 64)
    cfg.SEED = 1
    o = cfg.OPTIM
    o.NAME, o.LR, o.MOMENTUM, o.WEIGHT_DECAY, o.MAX_EPOCH = "sgd", 0.1, 0.0, 0.0, 1


def test_coop_step_matches_jax(rn_pt, tmp_path, monkeypatch):
    from ovmr_tpu.engine.coop import CoOp as JCoOp
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch.engine.coop import CoOp

    monkeypatch.setenv("OVMR_CLIP_CKPT", rn_pt)
    vt_path = str(tmp_path / "vt.pt")
    vt = 0.02 * np.random.default_rng(6).standard_normal((len(NAMES), 2, 64))
    torch.save({"visual_tokens": torch.from_numpy(vt.astype(np.float32))}, vt_path)
    trainers = []
    for cls, cfg in ((CoOp, get_cfg_default()), (JCoOp, j_cfg())):
        _coop_cfg(cfg, vt_path)
        if hasattr(cfg, "CUDA"):
            cfg.CUDA.DTYPE, cfg.CUDA.DEVICE = "float32", "cpu"
        else:
            cfg.TPU.DTYPE = "float32"
        trainer = cls.__new__(cls)
        trainer.cfg, trainer.dm = cfg, _DM(NAMES)
        trainer.build_model()
        trainer.epoch = 0
        trainer.before_epoch()
        trainers.append(trainer)
    port, jtr = trainers
    assert port.clip_cfg.is_resnet and port.lr_table[0] == pytest.approx(0.1)
    ctx = (0.02 * np.random.default_rng(7).standard_normal((2, 64))).astype(np.float32)
    with torch.no_grad():
        port.params["ctx"].copy_(torch.from_numpy(ctx))
    jtr.params = {"ctx": jnp.asarray(ctx)}
    jtr.opt_state = jtr.optimizer.init(jtr.params)
    jtr.before_epoch()

    images = _images(3, 8, 3, 64, 64)
    labels = np.arange(8) % len(NAMES)
    loss, _ = port.train_step(torch.from_numpy(images), torch.from_numpy(labels), 0)
    new_params, _, jloss, _ = jtr._step(jtr.params, jtr.opt_state, jtr.clip_params,
                                        jnp.asarray(images), jnp.asarray(labels, jnp.int32), 0)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    # plain sgd: the JAX step moved ctx by -lr * grad
    jgrad = (ctx - np.asarray(new_params["ctx"])) / 0.1
    grad = port.params["ctx"].grad.numpy()
    scale = float(np.abs(jgrad).max())
    assert scale > 0
    np.testing.assert_allclose(grad, jgrad, atol=1e-4 * scale, rtol=0)


def test_clip_compat_logits_match_jax(rn_pt, monkeypatch):
    from ovmr_tpu import clip_compat as jclip_compat
    from ovmr_tpu_torch import clip_compat

    monkeypatch.setenv("OVMR_CLIP_CKPT", rn_pt)
    port, preprocess = clip_compat.load("RN50", dtype=torch.float32, device="cpu")
    jax_model, _ = jclip_compat.load(rn_pt, dtype=jnp.float32)
    assert port.cfg.is_resnet and port.cfg.image_resolution == 64
    images = np.random.default_rng(0).standard_normal((3, 3, 64, 64)).astype(np.float32)
    tokens = clip_compat.tokenize(["a photo of a cat", "a dog", "a red panda"])
    for ours, theirs in zip(port(images, tokens), jax_model(images, tokens)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)
    assert osp.basename(rn_pt) == "tiny_rn.pt"
