"""The port's trainers on a data axis of local shards, against JAX's on
its virtual 8-device CPU mesh (``tests/conftest.py``).

- ``streaming_fusion_weights_sharded`` at 2 and 4 local shards: the port's
  single-device fusion bit for bit, JAX's sharded one within 1e-6;
- MM_CLS_OP and CoOp with ``CUDA.MESH.DATA 2`` (``TPU.MESH.DATA 2`` for
  JAX) over ``Synthetic`` and the trajectory golden's TINY towers (through
  ``OVMR_CLIP_CKPT``), the trained state copied across, sgd, dropout 0:
  the first step's loss within 1e-5 and the updated state within 1e-4,
  then the eval's classifiers within 1e-4;
- the ragged batch's one warning; ``setup_trainer_mesh``'s routes and
  printed lines; zero-shot on a model axis.
"""

import os.path as osp

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.engine import register_all_trainers
from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.convert import aggregator_params_from_numpy
from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine import trainer as trainer_mod
from ovmr_tpu_torch.engine.trainer import build_trainer, setup_trainer_mesh
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.ops.fusion import (
    streaming_fusion_weights,
    streaming_fusion_weights_sharded,
)
from ovmr_tpu_torch.parallel import DataAxis
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TRAJ = osp.join(ROOT, "tests", "fixtures", "trajectory_coop_golden.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the TINY tensors gain nothing from more,
    and under the suite's parallel workers the spinning thread pools of
    each worker slow every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_fusion_equals_the_single_device_fusion(shards):
    from ovmr_tpu.ops.fusion import streaming_fusion_weights_sharded as j_sharded
    from ovmr_tpu.parallel import build_mesh as j_build_mesh

    rng = np.random.default_rng(shards)
    n, k, d, row_chunk = 24, 9, 16, 20  # 216 rows: several chunks a shard, padded
    feats = rng.standard_normal((n * k, d)).astype(np.float32)
    labels = np.repeat(np.arange(n), k)
    cls3 = [rng.standard_normal((n, d)).astype(np.float32) for _ in range(3)]
    args = (torch.from_numpy(feats), torch.from_numpy(labels), [torch.from_numpy(c) for c in cls3],
            4.0, 10.0)
    want = streaming_fusion_weights(*args, row_chunk=row_chunk)
    got = streaming_fusion_weights_sharded(DataAxis.local(shards), *args, row_chunk=row_chunk)
    assert torch.equal(got, want)
    mesh = j_build_mesh(shards, 1, jax.devices()[:shards])
    theirs = j_sharded(mesh, jnp.asarray(feats), jnp.asarray(labels),
                       [jnp.asarray(c) for c in cls3], 4.0, 10.0, row_chunk=row_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=1e-6, rtol=0)


@pytest.fixture
def golden_towers(tmp_path, monkeypatch):
    data = np.load(TRAJ)
    path = tmp_path / "tiny_clip.pt"
    torch.save({k[len("clip."):]: torch.from_numpy(np.asarray(data[k]))
                for k in data.files if k.startswith("clip.")}, path)
    monkeypatch.setenv("OVMR_CLIP_CKPT", str(path))
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,64")
    register_all_trainers()


def _cfg(make, tmp_path, tag, trainer="MM_CLS_OP", **device):
    """TINY_64 on Synthetic at 64 px, sgd; ``device`` keys go to the CUDA
    node of the port's config or the TPU node of JAX's."""
    cfg = make()
    cfg.OUTPUT_DIR, cfg.SEED = str(tmp_path / tag), 1
    cfg.DATASET.ROOT, cfg.DATASET.NAME, cfg.DATASET.NUM_SHOTS = str(tmp_path / "data"), \
        "Synthetic", 4
    cfg.INPUT.SIZE, cfg.INPUT.TRANSFORMS = (64, 64), ["normalize"]
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomClassSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TRAIN_X.N_INS = 16, 4
    cfg.DATALOADER.TEST.BATCH_SIZE, cfg.DATALOADER.NUM_WORKERS = 16, 2
    cfg.MODEL.BACKBONE.NAME = "TINY_64"
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.MOMENTUM = "sgd", 0.05, 0.0
    cfg.OPTIM.MAX_EPOCH, cfg.TRAINER.NAME, cfg.TRAINER.COCOOP.N_CTX = 1, trainer, 2
    cfg.TRAINER.COOP.N_CTX = 2
    cfg.TEST.NO_TEST, cfg.EVAL_MODE = True, "fusion"
    node = cfg.CUDA if "CUDA" in cfg else cfg.TPU
    node.DTYPE = "float32"
    if "CUDA" in cfg:
        node.DEVICE = "cpu"
    for key, value in device.items():
        target = node
        for part in key.split(".")[:-1]:
            target = target[part]
        target[key.split(".")[-1]] = value
    return cfg


def _no_dropout(monkeypatch):
    """Dropout off in both packages' steps, so the losses compare."""
    import ovmr_tpu.engine.train_step as j_ts

    for mod, name in ((trainer_mod, "make_sharded_train_step"), (trainer_mod, "make_train_step"),
                      (j_ts, "make_sharded_train_step"), (j_ts, "make_train_step")):
        orig = getattr(mod, name)

        def patched(*a, _orig=orig, **k):
            k["dropout"] = 0.0
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, patched)


def test_mm_cls_op_on_a_data_axis_matches_jax(golden_towers, tmp_path, monkeypatch):
    _no_dropout(monkeypatch)
    port = build_trainer(_cfg(get_cfg_default, tmp_path, "port", **{"MESH.DATA": 2}))
    jtr = j_build_trainer(_cfg(j_cfg, tmp_path, "jax", **{"MESH.DATA": 2}))
    assert port.mesh.shape == {"data": 2, "model": 1} and port.train_step_sharded is not None
    assert dict(jtr.mesh.shape) == {"data": 2, "model": 1}
    ckpt.copy_into(port.agg_params, aggregator_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.agg_params)))
    port.before_epoch()
    jtr.before_epoch()
    batch = next(iter(port.train_loader))
    calls = []
    orig = port.train_step_sharded
    port.train_step_sharded = lambda *a, **k: calls.append(1) or orig(*a, **k)
    ours, theirs = port.forward_backward(batch), jtr.forward_backward(batch)
    assert calls == [1]  # the sharded step, not the ragged fallback
    np.testing.assert_allclose(ours["loss"], theirs["loss"], atol=1e-5, rtol=0)
    agg = ckpt.named_leaves(port.agg_params)
    jagg = dict(ckpt.named_leaves(aggregator_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.agg_params))))
    for key, leaf in agg:
        np.testing.assert_allclose(leaf.detach().numpy(), jagg[key].numpy(), atol=1e-4, rtol=0,
                                   err_msg=key)
    got, want = port.generate_classifiers(), jtr.generate_classifiers()
    for key in ("mm_classifier", "vision_classifier", "text_classifier", "fusion_weight"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


def test_coop_on_a_data_axis_matches_jax(golden_towers, tmp_path):
    port = build_trainer(_cfg(get_cfg_default, tmp_path, "port", "CoOp", **{"MESH.DATA": 2}))
    jtr = j_build_trainer(_cfg(j_cfg, tmp_path, "jax", "CoOp", **{"MESH.DATA": 2}))
    single = build_trainer(_cfg(get_cfg_default, tmp_path, "single", "CoOp"))
    assert port.mesh.shape == {"data": 2, "model": 1} and not port._tp and single.mesh is None
    ctx = torch.from_numpy(np.array(jtr.params["ctx"]))
    for trainer in (port, single):
        with torch.no_grad():
            trainer.params["ctx"].copy_(ctx)
        trainer.before_epoch()
    jtr.before_epoch()
    batch = next(iter(port.train_loader))
    ours, theirs, one = (t.forward_backward(batch) for t in (port, jtr, single))
    for key in ("loss", "acc"):
        np.testing.assert_allclose(ours[key], theirs[key], atol=1e-5, rtol=0, err_msg=key)
        np.testing.assert_allclose(ours[key], one[key], atol=1e-5, rtol=0, err_msg=key)
    got = port.params["ctx"].detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jtr.params["ctx"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, single.params["ctx"].detach().numpy(), atol=1e-4, rtol=0)
    assert np.abs(got - ctx.numpy()).max() > 0
    # the eval's classifiers and fusion weights after the step
    port.prepare_test()
    jtr.prepare_test()
    for key in ("mm_classifier", "vision_classifier", "text_classifier", "fusion_weight"):
        np.testing.assert_allclose(port.classifiers[key], np.asarray(jtr.classifiers[key]),
                                   atol=1e-4, rtol=0, err_msg=key)


def test_a_ragged_batch_warns_once_and_runs_the_single_program_step(golden_towers, tmp_path,
                                                                    capsys):
    port = build_trainer(_cfg(get_cfg_default, tmp_path, "port", **{"MESH.DATA": 3}))
    assert port.mesh.shape == {"data": 3, "model": 1}
    port.before_epoch()
    for _ in range(2):  # two epochs of one batch
        assert np.isfinite(port.forward_backward(next(iter(port.train_loader)))["loss"])
    out = capsys.readouterr().out
    assert out.count("WARNING: batch with 4 classes not divisible by the data axis (3)") == 1


def test_setup_trainer_mesh_routes_and_lines(capsys):
    params = tclip.init_params(tclip.TINY_TP, seed=0)

    def route(**device):
        cfg = get_cfg_default()
        for key, value in device.items():
            target = cfg.CUDA
            for part in key.split(".")[:-1]:
                target = target[part]
            target[key.split(".")[-1]] = value
        out = setup_trainer_mesh(cfg, params, clip_cfg=tclip.TINY_TP, label="X")
        return out, capsys.readouterr().out

    (mesh, tp, placed, _), out = route()
    assert mesh is None and tp is False and placed is params and out == ""
    (mesh, tp, _, _), out = route(**{"MESH.DATA": 1})
    assert mesh is None and tp is False
    (mesh, tp, placed, _), out = route(**{"MESH.DATA": 4})
    assert mesh.shape == {"data": 4, "model": 1} and tp is False and placed is params
    assert out == "X data-parallel mesh: {'data': 4, 'model': 1}\n"
    (mesh, tp, placed, _), out = route(**{"MESH.MODEL": 2})
    assert tp == "pallas" and mesh.shape == {"data": 1, "model": 2}
    assert placed["visual"]["blocks"]["w_q"].shape[1] == 2 and "w_qkv" not in placed["text"][
        "blocks"]
    assert out.startswith("X tensor-parallel mesh {'data': 1, 'model': 2}: split-QKV towers")
    for device in ({"MESH.MODEL": 2, "TP_SPLIT_QKV": False}, {"MESH.MODEL": 2, "INT8": True}):
        (mesh, tp, placed, _), out = route(**device)
        assert tp == "gspmd" and placed["visual"]["blocks"]["c_fc_w"].shape[1] == 2
        assert "w_qkv" in placed["visual"]["blocks"]
        assert out.splitlines() == [
            "X model-parallel mesh (model=2): routing the towers to the torch-math block "
            "(packed towers, the MLP split over 'model'; no kernel on this route)",
            "X tensor-parallel mesh: {'data': 1, 'model': 2} (GSPMD route)"]
    from ovmr_tpu_torch.parallel.mesh import build_mesh

    with pytest.raises(ValueError, match="mesh data axis 0"):
        build_mesh(0, 1)


@pytest.mark.parametrize("split_qkv", [True, False], ids=["tp-block", "gspmd"])
def test_zeroshot_on_a_model_axis(golden_towers, tmp_path, split_qkv):
    """ZeroshotCLIP with a model axis of 2: the text classifier against
    JAX's zero-shot trainer on its data 1 x model 2 mesh, and the eval
    against the unsharded port's."""
    device = {"MESH.MODEL": 2, "TP_SPLIT_QKV": split_qkv}
    port = build_trainer(_cfg(get_cfg_default, tmp_path, "zs", "ZeroshotCLIP", **device))
    assert port._tp == ("pallas" if split_qkv else "gspmd")
    jtr = j_build_trainer(_cfg(j_cfg, tmp_path, "jzs", "ZeroshotCLIP", **device,
                               **{"MESH.DATA": 1}))
    np.testing.assert_allclose(port.text_classifier, np.asarray(jtr.text_classifier), atol=1e-5,
                               rtol=0)
    single = build_trainer(_cfg(get_cfg_default, tmp_path, "zs1", "ZeroshotCLIP"))
    np.testing.assert_allclose(port.text_classifier, single.text_classifier, atol=1e-5, rtol=0)
    port.prepare_test()
    single.prepare_test()
    batch = next(iter(port.dm.test_loader))
    np.testing.assert_allclose(port.model_inference(batch), single.model_inference(batch),
                               atol=1e-4, rtol=0)


def test_placement_helpers_on_local_shards():
    """The rank-level helpers with every shard local: ``shard_batch`` keeps
    every row, ``place_local_batch`` refuses a sliced batch without a mesh
    (the JAX package's message, with the CUDA keys), ``map_data_shards``
    runs each shard's block and gathers tuples in shard order, ``to_host``
    and ``replicate`` move results and host values."""
    from ovmr_tpu_torch.parallel import (
        Mesh,
        ModelAxis,
        map_data_shards,
        place_local_batch,
        replicate,
        shard_batch,
        to_host,
    )

    mesh = Mesh(DataAxis.local(3), ModelAxis.local(1))
    x = torch.arange(12.0).reshape(6, 2)
    assert shard_batch(mesh, x) is x
    with pytest.raises(ValueError, match="do not shard"):
        shard_batch(mesh, x[:4])
    with pytest.raises(RuntimeError, match="CUDA.MESH.DATA"):
        place_local_batch(None, x)
    seen = []
    rows, twice = map_data_shards(mesh, lambda b: seen.append(b.shape[0]) or (b, 2 * b), x)
    assert seen == [2, 2, 2] and torch.equal(rows, x) and torch.equal(twice, 2 * x)
    np.testing.assert_array_equal(to_host(mesh, x), x.numpy())
    tree = replicate(mesh, {"a": np.ones(2), "b": {"c": np.zeros(3)}})
    assert torch.equal(tree["b"]["c"], torch.zeros(3, dtype=torch.float64))
