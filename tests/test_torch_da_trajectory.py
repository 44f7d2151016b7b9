"""The port's Dassl DA trainers replay the torch-recorded goldens.

- The nine DA trajectory goldens (``trajectory_{adabn,adda,cdac,dael,dann,
  m3sda,mcd,mme,se}_golden.npz``, recorded from the reference trainers'
  ``forward_backward`` on torch CPU) through the port's trainers, by the
  method of ``tests/test_torch_dg_trajectory.py``: the recorded init state
  carried in with ``convert.dassl_state_from_numpy``, the recorded batches
  fed to ``forward_backward_xu`` at each step's lr, the losses and the final
  parameters and BN statistics held against the golden. Every tolerance is
  its JAX test's (``tests/test_trajectory_parity.py``), stated in
  :data:`CASES`.
- ``e2e_dann_fullloop_golden.npz`` on ``tests/fixtures/e2e_da_dataset``: the
  whole reference stack (the Office-31 folder reader, both loaders with the
  unlabeled one cycling mid-epoch, DANN's ``train()`` and ``test()``)
  through the port's ``build_trainer``.
"""

import contextlib
import os
import os.path as osp

import numpy as np
import pytest
import torch

from tests.test_torch_dg_trajectory import (
    FIX,
    _base_cfg,
    assert_tree_close,
    replay_trainer,
    transplant,
)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _interleave(v0, v1):
    """[B, ...] x 2 -> the loader's adjacent-view layout [B * 2, ...]."""
    return np.stack([v0, v1], axis=1).reshape((-1,) + v0.shape[1:])


def _cosine(cfg, optim, lr, wd, warm=None, warmup="linear", momentum=None, nesterov=False):
    cfg.OPTIM.NAME = optim
    cfg.OPTIM.LR = float(lr)
    cfg.OPTIM.WEIGHT_DECAY = float(wd)
    if momentum is not None:
        cfg.OPTIM.MOMENTUM = float(momentum)
        cfg.OPTIM.SGD_NESTEROV = nesterov
    cfg.OPTIM.MAX_EPOCH = 3
    cfg.OPTIM.LR_SCHEDULER = "cosine"
    if warm is None:
        cfg.OPTIM.WARMUP_EPOCH = 0
        return
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = warmup
    if warmup == "constant":
        cfg.OPTIM.WARMUP_CONS_LR = float(warm)
    else:
        cfg.OPTIM.WARMUP_MIN_LR = float(warm)


# each setup: the golden's scalars onto the config; returns the trainer's
# name, its models' golden prefixes and param-leaf counts, and the batches
# of a step (i = step % 2)

def _dann(d, cfg):
    base_lr, cons_lr, wd, step_size, gamma = d["optim_scalars"]
    cfg.MODEL.HEAD.NAME = ""
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.WEIGHT_DECAY = "adam", float(base_lr), float(wd)
    cfg.OPTIM.MAX_EPOCH = 4
    cfg.OPTIM.LR_SCHEDULER = "single_step"
    cfg.OPTIM.STEPSIZE = (int(step_size),)
    cfg.OPTIM.GAMMA = float(gamma)
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "constant"
    cfg.OPTIM.WARMUP_CONS_LR = float(cons_lr)
    return "DANN", {"model": ("m", 10), "critic": ("c", 10)}, _xu_batches(d)


def _adda(d, cfg):
    base_lr, cons_lr, wd = d["optim_scalars"]
    _cosine(cfg, "adam", base_lr, wd, cons_lr, "constant")
    return "ADDA", {"model": ("m", 14), "critic": ("c", 10)}, _xu_batches(d)


def _adabn(d, cfg):
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.MAX_EPOCH = "sgd", 1e-3, 3
    imgs_u = np.asarray(d["imgs_u"], np.float32)
    return "AdaBN", {"model": (None, 14)}, lambda i: (
        {"img": np.zeros((1, 3, 32, 32), np.float32), "label": np.zeros(1, np.int64)},
        {"img": imgs_u[i], "label": np.zeros(8, np.int64)})


def _mcd(d, cfg):
    base_lr, min_lr, wd, momentum, n_step_f = d["optim_scalars"]
    cfg.TRAINER.MCD.N_STEP_F = int(n_step_f)
    _cosine(cfg, "sgd", base_lr, wd, min_lr, momentum=momentum, nesterov=True)
    return "MCD", {"F": ("F", 12), "C1": ("C1", 2), "C2": ("C2", 2)}, _xu_batches(d)


def _mme(d, cfg):
    base_lr, cons_lr, wd, momentum, lmda = d["optim_scalars"]
    cfg.TRAINER.MME.LMDA = float(lmda)
    _cosine(cfg, "sgd", base_lr, wd, cons_lr, "constant", momentum=momentum)
    return "MME", {"F": ("F", 12), "C": ("C", 1)}, _xu_batches(d)


def _m3sda(d, cfg):
    base_lr, wd, momentum, n_step_f, lmda = d["optim_scalars"]
    cfg.DATALOADER.TRAIN_X.N_DOMAIN = 2
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.TRAINER.M3SDA.N_STEP_F = int(n_step_f)
    cfg.TRAINER.M3SDA.LMDA = float(lmda)
    _cosine(cfg, "sgd", base_lr, wd, momentum=momentum)  # warmup-free
    return "M3SDA", {"F": ("F", 12), "C": ("C", 4)}, _xu_batches(d, domains=True)


def _dael(d, cfg):
    base_lr, min_lr, wd, momentum, weight_u, conf_thre = d["optim_scalars"]
    cfg.DATALOADER.TRAIN_X.N_DOMAIN = 2
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.TRAINER.DAEL.WEIGHT_U = float(weight_u)
    cfg.TRAINER.DAEL.CONF_THRE = float(conf_thre)
    cfg.TRAINER.DAEL.STRONG_TRANSFORMS = ["random_flip"]
    _cosine(cfg, "sgd", base_lr, wd, min_lr, momentum=momentum)
    imgs = {k: np.asarray(d[k], np.float32) for k in ("imgs_x", "imgs_x2", "imgs_u", "imgs_u2")}
    return "DAEL", {"F": ("F", 12), "E": ("E", 2)}, lambda i: (
        {"img": imgs["imgs_x"][i], "img2": imgs["imgs_x2"][i],
         "label": d["labels_x"][i].astype(np.int64), "domain": d["domains_x"][i].astype(np.int64)},
        {"img": imgs["imgs_u"][i], "img2": imgs["imgs_u2"][i], "label": np.zeros(8, np.int64)})


def _cdac(d, cfg):
    base_lr, wd, momentum, rampup_coef, rampup_itrs, lr_multi, topk, p_thresh = d["optim_scalars"]
    cfg.DATALOADER.K_TRANSFORMS = 2
    t = cfg.TRAINER.CDAC
    t.RAMPUP_COEF, t.RAMPUP_ITRS = float(rampup_coef), int(rampup_itrs)
    t.CLASS_LR_MULTI, t.TOPK_MATCH, t.P_THRESH = float(lr_multi), int(topk), float(p_thresh)
    t.STRONG_TRANSFORMS = ["random_flip"]
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.WEIGHT_DECAY = "sgd", float(base_lr), float(wd)
    cfg.OPTIM.MOMENTUM, cfg.OPTIM.SGD_NESTEROV, cfg.OPTIM.MAX_EPOCH = float(momentum), False, 3
    imgs = {k: np.asarray(d[k], np.float32) for k in ("imgs_x", "imgs_u", "imgs_us", "imgs_us2")}
    return "CDAC", {"F": ("F", 12), "C": ("C", 1)}, lambda i: (
        {"img": _interleave(imgs["imgs_x"][i], imgs["imgs_x"][i]),
         "label": np.repeat(d["labels_x"][i].astype(np.int64), 2)},
        {"img": _interleave(imgs["imgs_u"][i], imgs["imgs_u"][i]),
         "img2": _interleave(imgs["imgs_us"][i], imgs["imgs_us2"][i]),
         "label": np.repeat(d["labels_u"][i].astype(np.int64), 2)})


def _se(d, cfg):
    base_lr, min_lr, wd, momentum, ema_alpha, conf_thre, rampup = d["optim_scalars"]
    cfg.DATALOADER.K_TRANSFORMS = 2
    cfg.TRAINER.SE.EMA_ALPHA = float(ema_alpha)
    cfg.TRAINER.SE.CONF_THRE = float(conf_thre)
    cfg.TRAINER.SE.RAMPUP = int(rampup)
    _cosine(cfg, "sgd", base_lr, wd, min_lr, momentum=momentum)
    imgs = {k: np.asarray(d[k], np.float32) for k in ("imgs_x", "imgs_u1", "imgs_u2")}
    return "SE", {"model": ("s", 14)}, lambda i: (
        {"img": _interleave(imgs["imgs_x"][i], imgs["imgs_x"][i]),
         "label": np.repeat(d["labels_x"][i].astype(np.int64), 2)},
        {"img": _interleave(imgs["imgs_u1"][i], imgs["imgs_u2"][i]),
         "label": np.zeros(16, np.int64)})


def _xu_batches(d, domains=False):
    imgs_x = np.asarray(d["imgs_x"], np.float32)
    imgs_u = np.asarray(d["imgs_u"], np.float32)

    def batches(i):
        batch_x = {"img": imgs_x[i], "label": d["labels_x"][i].astype(np.int64)}
        if domains:
            batch_x["domain"] = d["domains_x"][i].astype(np.int64)
        return batch_x, {"img": imgs_u[i], "label": np.zeros(imgs_u.shape[1], np.int64)}

    return batches


# golden -> (setup, epochs x batches, loss keys with their (rtol, atol), the
# final atol by (model, collection)); the JAX tests' tolerances
# (tests/test_trajectory_parity.py:441,556,1067,1177,1299,1432,1561,1703,1932)
CASES = {
    "dann": (_dann, 4, {"loss_x": (1e-3, 1e-4), "loss_d": (1e-3, 1e-4)},
             lambda s: {("model", "params"): 8 * float(s[0]), ("critic", "params"): 8 * float(s[0]),
                        ("critic", "batch_stats"): 5e-3}),
    "adda": (_adda, 3, {"loss_critic": (1e-3, 1e-4), "loss_model": (1e-3, 1e-4)},
             lambda s: {("model", "params"): 2e-3, ("model", "batch_stats"): 1e-3,
                        ("critic", "params"): 2e-3, ("critic", "batch_stats"): 1e-3}),
    "adabn": (_adabn, 3, {}, lambda s: {("model", "batch_stats"): 1e-4}),
    "mcd": (_mcd, 3, {k: (1e-4, 1e-5) for k in ("loss_step_A", "loss_step_B", "loss_step_C")},
            lambda s: {("F", "params"): 5e-5, ("F", "batch_stats"): 5e-5, ("C1", "params"): 5e-5,
                       ("C2", "params"): 5e-5}),
    "mme": (_mme, 3, {"loss_x": (2e-4, 2e-5), "loss_u": (2e-4, 2e-5)},
            lambda s: {("F", "params"): 1e-4, ("F", "batch_stats"): 1e-4, ("C", "params"): 1e-4}),
    "m3sda": (_m3sda, 3, {"loss_step_A": (2e-4, 2e-5), "loss_step_B": (2e-4, 2e-5),
                          "loss_step_C": (5e-4, 2e-5)},
              lambda s: {("F", "params"): 1e-4, ("F", "batch_stats"): 1e-4, ("C", "params"): 1e-4}),
    "dael": (_dael, 3, {"loss_x": (2e-4, 2e-5), "loss_cr": (5e-4, 2e-5), "loss_u": (5e-4, 2e-5)},
             lambda s: {("F", "params"): 1e-4, ("F", "batch_stats"): 1e-4, ("E", "params"): 1e-4}),
    "cdac": (_cdac, 3, {"loss_x": (5e-4, 5e-5), "aac_loss": (5e-4, 5e-5), "pl_loss": (1e-3, 5e-5),
                        "cons_loss": (1e-3, 5e-5), "p_u_pred_keep": (0.0, 1e-6)},
             lambda s: {("F", "params"): 2e-4, ("F", "batch_stats"): 2e-4, ("C", "params"): 2e-4}),
    "se": (_se, 3, {"loss_x": (2e-4, 2e-5), "loss_u": (1e-3, 2e-5)},
           lambda s: {("model", "params"): 2e-4, ("model", "batch_stats"): 2e-4}),
}
# the golden's name of a loss where it differs from the trainer's key
GOLDEN_KEY = {"p_u_pred_keep": "keep"}
# Replayed in float64: M3SDA's float32 steps on one thread take the other
# side of a max-pool near-tie from the reference's (conv3's pooling, in the
# last phase-C update of the second step), which moves conv3's weights by
# 7.9e-7 (3e-6 of their scale); the later phases amplify it to 8.7e-4 on a
# BN running mean by the sixth step (the JAX gate: 1e-4 + 1e-3 |x|). In
# float64 the replay holds every gate of the JAX test (its largest leaf
# error 5.7e-6), and in float32 on 2, 3 or 4 threads the BN means stay
# within 1e-5: the trajectory is the reference's; the near-tie's rounding
# is not.
FLOAT64 = {"m3sda"}


@contextlib.contextmanager
def _float64_trainers(active):
    """The Dassl trainers' models and batches in float64."""
    from ovmr_tpu_torch.engine import dassl_base

    if not active:
        yield
        return
    build_net, rows = dassl_base.DasslTrainer.build_net, dassl_base.DasslTrainer.rows

    def rows64(self, x, local=False):
        t = rows(self, x, local)
        return t.double() if t.is_floating_point() else t

    dassl_base.DasslTrainer.build_net = lambda self, net: build_net(self, net).double()
    dassl_base.DasslTrainer.rows = rows64
    try:
        yield
    finally:
        dassl_base.DasslTrainer.build_net, dassl_base.DasslTrainer.rows = build_net, rows


def _prefix(stage, tag, coll):
    return f"{stage}/{coll}" if tag is None else f"{stage}/{tag}/{coll}"


def _transplant(net, data, tag):
    return transplant(net, data, "init" if tag is None else f"init/{tag}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_da_trajectory_matches_reference_trainer(name):
    from ovmr_tpu_torch.engine import da

    setup, epochs, loss_tol, final_tol = CASES[name]
    data = np.load(osp.join(FIX, f"trajectory_{name}_golden.npz"))
    cfg = _base_cfg()
    trainer_name, models, batches = setup(data, cfg)
    with _float64_trainers(name in FLOAT64):
        _replay(name, data, cfg, getattr(da, trainer_name), models, batches, epochs, loss_tol,
                final_tol)


def _replay(name, data, cfg, cls, models, batches, epochs, loss_tol, final_tol):
    trainer = replay_trainer(cls, cfg)
    trainer.max_epoch = epochs
    assert trainer.get_model_names() == list(models)
    for model, (tag, n) in models.items():
        assert _transplant(trainer._nets[model], data, tag) == n
    # the frozen source model and the teacher are copies of the init state
    if name == "adda":
        trainer.copy_source_model()
    if name == "se":
        trainer.copy_teacher()
    if name == "adabn":  # warmed statistics, which the reset must discard
        assert float(np.abs(data["init/batch_stats/head/bn0/mean"]).max()) > 0.01

    losses = {k: [] for k in loss_tol}
    trainer.num_batches = 2
    for step in range(2 * epochs):
        trainer.epoch, trainer.batch_idx = divmod(step, 2)
        if trainer.batch_idx == 0:
            trainer.before_epoch()
        if "lrs" in data.files:
            assert trainer.lr_table[trainer.epoch] == pytest.approx(data["lrs"][step], rel=1e-12)
        out = trainer.forward_backward_xu(*batches(step % 2))
        for k in losses:
            losses[k].append(out[k])
        if name == "cdac":  # the lr installed for this step, both optimizers
            for model, key in (("F", "lrs_f"), ("C", "lrs_c")):
                lr = trainer._optims[model].param_groups[0]["lr"]
                assert lr == pytest.approx(data[key][step], rel=1e-6)

    for k, (rtol, atol) in loss_tol.items():
        np.testing.assert_allclose(losses[k], data[GOLDEN_KEY.get(k, k)], rtol=rtol, atol=atol,
                                   err_msg=k)
    if name == "dann":  # the first steps agree tighter (tests/test_trajectory_parity.py:521)
        for k in loss_tol:
            np.testing.assert_allclose(losses[k][:3], data[k][:3], rtol=1e-5, atol=1e-5)
    if name == "adda":
        np.testing.assert_allclose(losses["loss_critic"][:3], data["loss_critic"][:3],
                                   rtol=1e-5, atol=1e-5)
    if name == "mme":  # the negative entropy: the GRL's sign is part of the pin
        assert all(v < 0 for v in losses["loss_u"])
    if name == "se":  # the masked term really fires
        assert all(v > 1e-6 for v in losses["loss_u"])
    if name == "cdac":
        assert any(0.0 < k < 1.0 for k in losses["p_u_pred_keep"])

    tol = final_tol(data["optim_scalars"] if "optim_scalars" in data.files else None)
    for (model, coll), atol in tol.items():
        tag = models[model][0]
        assert_tree_close(trainer.model_state(model)[coll], data, _prefix("final", tag, coll),
                          atol=atol)
    if name == "se":
        from ovmr_tpu_torch.convert import dassl_state_to_numpy

        teacher = dassl_state_to_numpy(trainer.teacher)
        for coll in ("params", "batch_stats"):
            assert_tree_close(teacher[coll], data, f"final/t/{coll}", atol=2e-4)
    if name == "adda":  # the classifier exactly frozen (no gradient, no decay)
        kernel = trainer.model_state("model")["params"]["classifier"]["kernel"]
        np.testing.assert_array_equal(kernel, data["init/m/params/classifier/kernel"])
    if name == "adabn":  # no parameter moves
        state = trainer.model_state("model")["params"]
        for key in data.files:
            if key.startswith("init/params/"):
                node = state
                for p in key[len("init/params/"):].split("/"):
                    node = node[p]
                np.testing.assert_array_equal(node, data[key], err_msg=key)


# --------------------------------------------------------------------------
# e2e_dann_fullloop_golden.npz: the whole reference stack
# --------------------------------------------------------------------------

def test_dann_fullloop_matches_reference_stack(tmp_path, monkeypatch):
    from ovmr_tpu_torch.engine.trainer import build_trainer
    from ovmr_tpu_torch.utils import get_cfg_default

    data = np.load(osp.join(FIX, "e2e_dann_fullloop_golden.npz"))
    base_lr, cons_lr, wd, step_size, gamma = data["optim_scalars"]
    cfg = get_cfg_default()
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SEED = 1
    cfg.DATASET.ROOT = osp.join(FIX, "e2e_da_dataset")
    cfg.DATASET.NAME = "Office31"
    cfg.DATASET.SOURCE_DOMAINS = ["amazon"]
    cfg.DATASET.TARGET_DOMAINS = ["webcam"]
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.INTERPOLATION = "bilinear"
    cfg.INPUT.TRANSFORMS = ("normalize",)
    cfg.DATALOADER.TRAIN_X.SAMPLER = "SequentialSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 16
    cfg.DATALOADER.TRAIN_U.SAME_AS_X = True
    cfg.DATALOADER.TEST.BATCH_SIZE = 16
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.MODEL.BACKBONE.NAME = "cnn_digitsdg"
    cfg.MODEL.HEAD.NAME = ""
    cfg.OPTIM.NAME = "adam"
    cfg.OPTIM.LR = float(base_lr)
    cfg.OPTIM.WEIGHT_DECAY = float(wd)
    cfg.OPTIM.MAX_EPOCH = 3
    cfg.OPTIM.LR_SCHEDULER = "single_step"
    cfg.OPTIM.STEPSIZE = (int(step_size),)
    cfg.OPTIM.GAMMA = float(gamma)
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "constant"
    cfg.OPTIM.WARMUP_CONS_LR = float(cons_lr)
    cfg.TRAINER.NAME = "DANN"
    cfg.TRAIN.PRINT_FREQ = 1
    cfg.CUDA.DEVICE = "cpu"
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)

    trainer = build_trainer(cfg)
    assert trainer.dm.num_classes == 8
    assert len(trainer.dm.train_loader_x) == 2  # the COUNT_ITER basis
    assert len(trainer.dm.train_loader_u) == 1  # it runs out: the cycling path
    assert transplant(trainer._nets["model"], data, "init/m") == 10
    assert transplant(trainer._nets["critic"], data, "init/c") == 10

    losses_x, losses_d, accs, it = [], [], [], {"i": 0}
    orig_fb = trainer.forward_backward_xu

    def rec_fb(batch_x, batch_u):
        i = it["i"]
        np.testing.assert_array_equal(np.asarray(batch_x["label"]), data["batch_x_labels"][i])
        np.testing.assert_array_equal(np.asarray(batch_u["domain"]), data["batch_u_domains"][i])
        assert batch_u["img"].shape[0] == data["batch_u_sizes"][i]
        assert trainer.lr_table[trainer.epoch] == pytest.approx(data["lrs"][i], rel=1e-12)
        out = orig_fb(batch_x, batch_u)
        losses_x.append(out["loss_x"])
        losses_d.append(out["loss_d"])
        accs.append(out["acc_x"])
        it["i"] += 1
        return out

    monkeypatch.setattr(trainer, "forward_backward_xu", rec_fb)
    names_box, logits_box, tlabels = [], [], []
    orig_mi = trainer.model_inference

    def rec_mi(batch, scale_no=0):
        out = orig_mi(batch, scale_no=scale_no)
        names_box.extend("/".join(p.rsplit("/", 2)[-2:]) for p in batch["impath"])
        logits_box.append(np.asarray(out))
        tlabels.extend(np.asarray(batch["label"]).tolist())
        return out

    monkeypatch.setattr(trainer, "model_inference", rec_mi)
    results_box = {}
    orig_ev = trainer.evaluator.evaluate

    def rec_ev():
        res = orig_ev()
        results_box.update(res)
        return res

    monkeypatch.setattr(trainer.evaluator, "evaluate", rec_ev)
    trainer.train()  # the whole loop; after_train runs test()

    # tests/test_e2e_dann_fullloop_parity.py's tolerances
    assert it["i"] == 6
    np.testing.assert_allclose(losses_x, data["loss_x"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(losses_d, data["loss_d"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(accs, data["accs"])
    assert_tree_close(trainer.model_state("model")["params"], data, "final/m/params", atol=5e-5)
    assert_tree_close(trainer.model_state("critic")["params"], data, "final/c/params",
                      atol=8 * float(base_lr))
    assert_tree_close(trainer.model_state("critic")["batch_stats"], data, "final/c/batch_stats",
                      atol=5e-5)

    assert len(names_box) == 16
    lg = np.concatenate(logits_box, 0)
    order = np.argsort(np.asarray(names_box))
    lg, lb = lg[order], np.asarray(tlabels, np.int32)[order]
    np.testing.assert_array_equal(np.asarray([names_box[i] for i in order]), data["test_names"])
    np.testing.assert_array_equal(lb, data["test_labels"])
    np.testing.assert_allclose(lg, data["test_logits"], atol=3e-4, rtol=1e-3)
    assert float(data["margin"]) > 20 * 3e-4
    np.testing.assert_array_equal(lg.argmax(1), data["test_preds"])
    ref_acc, ref_err, ref_f1 = data["results"]
    assert results_box["accuracy"] == pytest.approx(ref_acc, rel=1e-9)
    assert results_box["error_rate"] == pytest.approx(ref_err, rel=1e-9)
    assert results_box["macro_f1"] == pytest.approx(ref_f1, rel=1e-9)
