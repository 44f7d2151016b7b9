"""The port's CoOp stage-2 trainer (OVMR†, ``ovmr_tpu_torch/engine/coop.py``)
against the JAX package's (``ovmr_tpu/engine/coop.py``) and the reference
goldens, on the CPU at fp32.

- prompt features against ``coop_tiny_golden.npz`` (recorded from the
  reference ``trainers/coop_mm_classifier.py``; the JAX test's 3e-5) and
  against JAX's ``CoOp._text_features`` (1e-5) with a generic ctx, a
  class-specific one (``CSC``) and one from ``CTX_INIT`` words;
- both scenarios of ``trajectory_coop_golden.npz`` (3 prompts at 4
  classes; one recorded prompt a step at 401 classes) at
  ``tests/test_trajectory_parity.py``'s bounds;
- the 401-class prompt draws equal JAX's from the same seed;
- ``get_fusion_weight`` and the fusion eval's scores against JAX's (1e-5)
  on ``Synthetic``;
- a reference ``model.pth.tar`` through ``load_checkpoint(torch_converter=
  _ctx_from_torch)``, and a JAX-written ``visual_tokens.pt``;
- stage 1 -> stage 2 through ``python -m ovmr_tpu_torch.train`` with
  ``configs/trainers/MM_CLS/vit_b16_c16_ep10_batch1.yaml`` (sgd), a resume,
  the eval, and the JAX package reading the port's sgd state.

The towers of both packages come from one TINY reference state dict through
``OVMR_CLIP_CKPT``.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine import trainer as trainer_mod
from ovmr_tpu_torch.engine.coop import CoOp, _ctx_from_torch
from ovmr_tpu_torch.engine.optimizers import set_lr
from ovmr_tpu_torch.models.import_torch import clip_params_from_state_dict
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDEN = osp.join(ROOT, "tests", "fixtures", "coop_tiny_golden.npz")
TRAJ = osp.join(ROOT, "tests", "fixtures", "trajectory_coop_golden.npz")
MM_CLS_YAML = osp.join(ROOT, "configs", "trainers", "MM_CLS", "vit_b16_c16_ep10_batch1.yaml")
EPOCHS, BATCHES = 3, 2


class _NoWriter:
    def add_scalar(self, *a):
        pass

    def flush(self):
        pass


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread a test (the suite's workers share the cores) and
    no tensorboard writer (its first import costs seconds; no check reads
    it)."""
    monkeypatch.setattr(trainer_mod.TrainerBase, "init_writer",
                        lambda self: setattr(self, "_writer", _NoWriter()) or self._writer)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def traj():
    return np.load(TRAJ)


@pytest.fixture(scope="module")
def clip_pt(traj, tmp_path_factory):
    """The trajectory golden's TINY towers (64 px) as a reference state dict."""
    path = tmp_path_factory.mktemp("clip") / "tiny_clip.pt"
    torch.save({k[len("clip."):]: torch.from_numpy(np.asarray(traj[k]))
                for k in traj.files if k.startswith("clip.")}, path)
    return str(path)


class _DM:
    def __init__(self, classnames):
        self.dataset = type("DS", (), {"classnames": list(classnames)})()


def _optim(cfg, traj):
    base_lr, cons_lr, wd, b1, b2 = traj["optim_scalars"]
    o = cfg.OPTIM
    o.NAME, o.LR, o.WEIGHT_DECAY = "adam", float(base_lr), float(wd)
    o.ADAM_BETA1, o.ADAM_BETA2, o.MAX_EPOCH = float(b1), float(b2), EPOCHS
    o.LR_SCHEDULER, o.WARMUP_EPOCH, o.WARMUP_TYPE = "cosine", 1, "constant"
    o.WARMUP_CONS_LR = float(cons_lr)


def _configure(cfg, traj, vt_path, coop):
    cfg.TRAINER.COOP.N_CTX = 2
    cfg.TRAINER.COOP.VISUAL_TOKEN_PATH = vt_path
    cfg.INPUT.SIZE = (64, 64)
    cfg.SEED = 1
    for key, value in (coop or {}).items():
        setattr(cfg.TRAINER.COOP, key, value)
    _optim(cfg, traj)


def _vt_file(tmp_path, vt):
    path = str(tmp_path / f"visual_tokens_{len(vt)}.pt")
    torch.save({"visual_tokens": torch.from_numpy(np.asarray(vt, np.float32))}, path)
    return path


def port_trainer(traj, classnames, vt_path, coop=None):
    """The port's CoOp without a data manager (``build_model`` reads only
    the class names), fp32 on the CPU."""
    cfg = get_cfg_default()
    _configure(cfg, traj, vt_path, coop)
    cfg.CUDA.DTYPE, cfg.CUDA.DEVICE = "float32", "cpu"
    trainer = CoOp.__new__(CoOp)
    trainer.cfg, trainer.dm = cfg, _DM(classnames)
    trainer.build_model()
    return trainer


def jax_trainer(traj, classnames, vt_path, coop=None):
    from ovmr_tpu.engine.coop import CoOp as JCoOp
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    cfg = j_cfg()
    _configure(cfg, traj, vt_path, coop)
    cfg.TPU.DTYPE = "float32"
    trainer = JCoOp.__new__(JCoOp)
    trainer.cfg, trainer.dm = cfg, _DM(classnames)
    trainer.build_model()
    return trainer


def _set_ctx(port, jtr, ctx):
    with torch.no_grad():
        port.params["ctx"].copy_(torch.from_numpy(ctx))
    jtr.params = {"ctx": jnp.asarray(ctx)}
    jtr.opt_state = jtr.optimizer.init(jtr.params)


# ---------------------------------------------------------------------------
# prompt features
# ---------------------------------------------------------------------------

def test_prompt_features_match_reference_golden():
    """The reference's mm/v/t features of 3 classes (n_ctx 4, 2 vokens),
    through the port trainer's prompt assembly and text tower."""
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.text import tokenize

    data = np.load(GOLDEN)
    sd = {k[len("clip."):]: torch.from_numpy(np.asarray(data[k]))
          for k in data.files if k.startswith("clip.")}
    clip_params, cfg = clip_params_from_state_dict(sd)
    n_cls, n_ctx = 3, 4
    t = CoOp.__new__(CoOp)
    t.clip_params, t.clip_cfg, t.dtype, t.n_cls = clip_params, cfg, torch.float32, n_cls
    ptok = torch.from_numpy(data["ptok"].astype(np.int64))
    emb = tclip.embed_tokens(clip_params, ptok)
    t.eot_idx = ptok.argmax(-1)
    t.token_prefix, t.token_suffix = emb[:, :1], emb[:, 1 + n_ctx:]
    vis = tclip.embed_tokens(clip_params, torch.from_numpy(tokenize(["X X X X ."])))
    t.vis_tail = vis[:, 1 + n_ctx: vis.shape[1] - 2]
    t.visual_tokens = torch.from_numpy(data["vokens"])
    t.voken_len = 2
    t.params = {"ctx": torch.from_numpy(data["ctx"])}
    with torch.no_grad():
        feats = t.text_features()
    for name, f in zip(("mm_f", "v_f", "t_f"), feats):
        np.testing.assert_allclose(f.numpy(), data[name], atol=3e-5, rtol=3e-5, err_msg=name)


@pytest.mark.parametrize("variant", ["generic", "csc", "ctx_init"])
def test_text_features_match_jax(traj, clip_pt, tmp_path, monkeypatch, variant):
    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    classnames = list(traj["classnames_a"])
    vt = _vt_file(tmp_path, traj["vt_a"])
    coop = {"csc": {"CSC": True}, "ctx_init": {"CTX_INIT": "a_photo of a"},
            "generic": None}[variant]
    port = port_trainer(traj, classnames, vt, coop)
    jtr = jax_trainer(traj, classnames, vt, coop)
    assert tuple(port.params["ctx"].shape) == tuple(jtr.params["ctx"].shape)
    if variant == "ctx_init":
        # four words: n_ctx follows the words, ctx their embeddings
        assert port.n_ctx == jtr.n_ctx == 4
        np.testing.assert_allclose(port.params["ctx"].detach().numpy(),
                                   np.asarray(jtr.params["ctx"]), atol=1e-7)
    else:
        ctx = np.random.default_rng(3).standard_normal(port.params["ctx"].shape)
        _set_ctx(port, jtr, (0.02 * ctx).astype(np.float32))
    np.testing.assert_array_equal(port.eot_idx.numpy(), np.asarray(jtr.eot_idx))
    with torch.no_grad():
        ours = port.text_features()
    theirs = jtr._text_features(jtr.params)
    for name, a, b in zip(("mm", "v", "t"), ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the training trajectory and the prompt draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["a", "b"])
def test_trajectory_matches_reference_trainer(traj, clip_pt, tmp_path, monkeypatch, scenario):
    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    classnames = traj[f"classnames_{scenario}"]
    vt = np.asarray(traj[f"vt_{scenario}"], np.float32)
    trainer = port_trainer(traj, classnames, _vt_file(tmp_path, vt))
    np.testing.assert_allclose(trainer.visual_tokens.numpy(), vt, atol=1e-6)
    with torch.no_grad():
        trainer.params["ctx"].copy_(torch.from_numpy(traj["ctx_init"]))

    images = np.asarray(traj["images"], np.float32)
    labels = traj[f"labels_{scenario}"]
    ref_losses, ref_lrs = traj[f"losses_{scenario}"], traj["lrs"]
    prompt_inds = traj["prompt_inds_b"] if scenario == "b" else [0] * len(ref_losses)
    losses, step = [], 0
    for epoch in range(EPOCHS):
        set_lr(trainer.optimizer, trainer.lr_table[epoch])
        for _ in range(BATCHES):
            assert trainer.lr_table[epoch] == pytest.approx(ref_lrs[step], rel=1e-12)
            i = step % 2
            loss, acc = trainer.train_step(torch.from_numpy(images[i]),
                                           torch.from_numpy(labels[i].astype(np.int64)),
                                           int(prompt_inds[step]))
            assert 0.0 <= float(acc) <= 100.0
            losses.append(float(loss))
            step += 1
    np.testing.assert_allclose(losses, ref_losses, rtol=3e-5, atol=3e-5)
    ref_ctx = traj[f"ctx_final_{scenario}"]
    diff = np.abs(trainer.params["ctx"].detach().numpy() - ref_ctx)
    assert float(np.median(diff)) < 3e-6
    assert float(diff.max()) < 12 * float(traj["optim_scalars"][0])
    assert np.abs(ref_ctx - traj["ctx_init"]).max() > 1e-5  # it really moved


def test_prompt_draws_match_jax_above_400_classes(traj, clip_pt, tmp_path, monkeypatch):
    """At 401 classes each step trains one prompt drawn from
    ``default_rng(max(SEED, 0))``; the port draws JAX's sequence."""
    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    classnames = traj["classnames_b"]
    vt = _vt_file(tmp_path, traj["vt_b"])
    port, jtr = port_trainer(traj, classnames, vt), jax_trainer(traj, classnames, vt)
    ours, theirs = [], []
    port.train_step = lambda images, labels, ind: (ours.append(ind), (torch.zeros(()),) * 2)[1]

    def jstep(params, opt_state, clip_params, images, labels, ind):
        theirs.append(ind)
        return params, opt_state, 0.0, 0.0

    jtr._step = jtr._step_sharded = jstep
    port.epoch = jtr.epoch = 0
    batch = {"img": np.zeros((8, 3, 64, 64), np.float32), "label": np.zeros(8, np.int32)}
    for _ in range(12):
        port.forward_backward(batch)
        jtr.forward_backward(batch)
    assert ours == theirs and set(ours) == {0, 1, 2}
    assert port.n_cls > 400 and len(port.text_features((1,))) == 1


# ---------------------------------------------------------------------------
# the fusion eval on Synthetic
# ---------------------------------------------------------------------------

def _synthetic(cfg, root, out):
    cfg.OUTPUT_DIR = out
    cfg.DATASET.ROOT = root
    cfg.DATASET.NAME = "Synthetic"
    cfg.DATASET.NUM_SHOTS = 4
    cfg.INPUT.TRANSFORMS = ["normalize"]
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
    cfg.DATALOADER.TEST.BATCH_SIZE = 32
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.MODEL.BACKBONE.NAME = "TINY_64"  # resolved via OVMR_CLIP_CKPT
    cfg.TRAINER.NAME = "CoOp"


def test_fusion_eval_matches_jax(traj, clip_pt, tmp_path, monkeypatch):
    from ovmr_tpu.engine.coop import CoOp as JCoOp  # noqa: F401  (registers)
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch.engine.trainer import build_trainer

    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    vt = _vt_file(tmp_path, np.random.default_rng(5).standard_normal((8, 2, 128)) * 0.02)
    root = str(tmp_path / "data")
    pcfg, jcfg = get_cfg_default(), j_cfg()
    for cfg, tag in ((pcfg, "port"), (jcfg, "jax")):
        _configure(cfg, traj, vt, None)
        _synthetic(cfg, root, str(tmp_path / tag))
    pcfg.CUDA.DTYPE, pcfg.CUDA.DEVICE = "float32", "cpu"
    jcfg.TPU.DTYPE = "float32"
    port, jtr = build_trainer(pcfg), j_build_trainer(jcfg)
    ctx = (0.02 * np.random.default_rng(4).standard_normal((2, 128))).astype(np.float32)
    _set_ctx(port, jtr, ctx)

    # the same classifiers into both: the F1 of each on the exemplar set
    feats = [np.asarray(f, np.float32) for f in jtr._jit_text_features(jtr.params)]
    np.testing.assert_allclose(port.get_fusion_weight(*feats), jtr.get_fusion_weight(*feats),
                               atol=1e-5)
    port.prepare_test()
    jtr.prepare_test()
    for key in ("mm_classifier", "vision_classifier", "text_classifier", "fusion_weight"):
        np.testing.assert_allclose(port.classifiers[key], jtr.classifiers[key], atol=1e-5,
                                   err_msg=key)
    batch = next(iter(port.dm.test_loader))
    np.testing.assert_allclose(port.model_inference(batch), jtr.model_inference(batch),
                               atol=1e-5)
    # the weight is computed once (coop_…:348-349): a changed ctx keeps it
    weight = port.classifiers["fusion_weight"]
    _set_ctx(port, jtr, ctx * 2)
    port.prepare_test()
    assert port.classifiers["fusion_weight"] is weight


# ---------------------------------------------------------------------------
# loading: reference checkpoints and JAX-written vokens
# ---------------------------------------------------------------------------

def test_reference_checkpoint_loads_through_the_torch_converter(traj, clip_pt, tmp_path,
                                                                monkeypatch):
    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    classnames = list(traj["classnames_a"])
    vt = _vt_file(tmp_path, traj["vt_a"])
    ctx = torch.from_numpy(traj["ctx_final_a"])
    sub = tmp_path / "ref" / "prompt_learner"
    sub.mkdir(parents=True)
    torch.save({"state_dict": {"ctx": ctx.half()}, "epoch": 3}, sub / "model.pth.tar-3")
    params, opt, ep = ckpt.load_checkpoint(str(tmp_path / "ref"), "prompt_learner",
                                           {"ctx": torch.zeros(2, 128)}, epoch=3,
                                           torch_converter=_ctx_from_torch)
    assert ep == 3 and opt is None
    assert torch.equal(params["ctx"], ctx.half().float())
    port = port_trainer(traj, classnames, vt)
    port.load_model(str(tmp_path / "ref"), epoch=3)
    jtr = jax_trainer(traj, classnames, vt)
    jtr.load_model(str(tmp_path / "ref"), epoch=3)
    np.testing.assert_array_equal(port.params["ctx"].detach().numpy(), np.asarray(jtr.params["ctx"]))
    assert port.params["ctx"].requires_grad


def test_reads_jax_written_visual_tokens(traj, clip_pt, tmp_path, monkeypatch):
    from ovmr_tpu.engine.checkpoint import export_classifiers_torch as j_export

    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    rng = np.random.default_rng(6)
    vt = rng.standard_normal((4, 2, 128)).astype(np.float32)
    j_export({"mm_classifier": rng.standard_normal((4, 128)),
              "vision_classifier": rng.standard_normal((4, 128)),
              "visual_tokens": vt}, str(tmp_path))
    port = port_trainer(traj, list(traj["classnames_a"]), str(tmp_path / "visual_tokens.pt"))
    np.testing.assert_array_equal(port.visual_tokens.numpy(), vt)
    assert port.voken_len == 2
    # without a path: zero vokens, as the JAX trainer warns and does
    port = port_trainer(traj, list(traj["classnames_a"]), "")
    assert not port.visual_tokens.any() and tuple(port.visual_tokens.shape) == (4, 2, 128)


# ---------------------------------------------------------------------------
# the stage-1 -> stage-2 chain through the entry point
# ---------------------------------------------------------------------------

def test_stage1_to_stage2_through_the_entry_point(clip_pt, tmp_path, monkeypatch):
    from ovmr_tpu.engine import checkpoint as jckpt
    from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
    from ovmr_tpu_torch import train as entry

    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    data = str(tmp_path / "data")
    common = ["--root", data, "--seed", "1"]
    opts = ["DATASET.NAME", "Synthetic", "DATASET.NUM_SHOTS", "4", "INPUT.SIZE", "(64, 64)",
            "INPUT.TRANSFORMS", "['normalize']", "DATALOADER.TEST.BATCH_SIZE", "32",
            "DATALOADER.NUM_WORKERS", "2", "MODEL.BACKBONE.NAME", "TINY_64",
            "CUDA.DEVICE", "cpu", "CUDA.DTYPE", "float32"]
    s1, s2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    entry.main(entry.build_parser().parse_args(
        common + ["--trainer", "MM_CLS_OP", "--n_ctx", "2", "--output-dir", s1, "--eval-only",
                  "--eval_mode", "fusion", "--eval_tau", "10"] + opts
        + ["DATALOADER.TRAIN_X.SAMPLER", "RandomClassSampler", "DATALOADER.TRAIN_X.N_INS", "4",
           "DATALOADER.TRAIN_X.BATCH_SIZE", "16"]))
    vt_path = osp.join(s1, "visual_tokens.pt")
    stage2 = common + ["--trainer", "MM_CLS", "--config-file", MM_CLS_YAML, "--output-dir", s2,
                       "--visual_token_path", vt_path] + opts + [
        "DATALOADER.TRAIN_X.BATCH_SIZE", "4", "TRAINER.COOP.N_CTX", "4", "TEST.NO_TEST", "True"]
    t2 = entry.main(entry.build_parser().parse_args(stage2 + ["OPTIM.MAX_EPOCH", "1"]))
    assert type(t2).__name__ == "CoOp" and t2.cfg.OPTIM.NAME == "sgd"
    np.testing.assert_array_equal(
        t2.visual_tokens.numpy(),
        torch.load(vt_path, weights_only=False)["visual_tokens"].numpy())
    # the JAX package reads the port's sgd state in optax's layout
    jopt = j_build_optimizer(t2.cfg.OPTIM)
    template = {"ctx": jnp.zeros((4, 128))}
    jp, js, ep = jckpt.load_checkpoint(s2, "prompt_learner", template, jopt.init(template))
    assert ep == 1 and int(js.count) == 8  # 32 shots, batch 4
    np.testing.assert_array_equal(np.asarray(jp["ctx"]), t2.params["ctx"].detach().numpy())
    trace = jax.tree_util.tree_leaves(js.inner_state)
    np.testing.assert_array_equal(
        np.asarray(trace[0]), t2.optimizer.state[t2.params["ctx"]]["momentum_buffer"].numpy())

    t3 = entry.main(entry.build_parser().parse_args(
        stage2[:-2] + ["TEST.NO_TEST", "False", "OPTIM.MAX_EPOCH", "2"]))
    assert t3.start_epoch == 1
    assert float(t3.optimizer.state[t3.params["ctx"]]["step"]) == 16
    log = open(osp.join(s2, "log.txt")).read()
    assert "=> result" in log and "(eval mode: CoOp fusion)" in log
    assert sorted(os.listdir(osp.join(s2, "prompt_learner"))) == [
        "checkpoint", "model-1.npz", "model-2.npz"]
