"""The port's SSL trainers replay the torch-recorded goldens.

The four SSL trajectory goldens (``trajectory_{fixmatch,mt,entmin,
mixmatch}_golden.npz``, recorded from the reference trainers'
``forward_backward`` on torch CPU) through the port's trainers, by the
method of ``tests/test_torch_da_trajectory.py``: the recorded init state
carried in with ``convert.dassl_state_from_numpy``, the recorded batches fed
to ``forward_backward_xu`` at each step's lr, the losses and the final
parameters and BN statistics (MeanTeacher's teacher too) held against the
golden. MixMatch's recorded permutations and mixup coefficients are
injected through ``MixMatch.mixup_draws``. Every tolerance is its JAX
test's (``tests/test_trajectory_parity.py:324,675,1836,2127``), stated in
:data:`CASES`.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from tests.test_torch_da_trajectory import _cosine, _interleave
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


def _warm_cosine(cfg, optim, lr, wd, min_lr, momentum=None):
    _cosine(cfg, optim, lr, wd, min_lr, "linear", momentum=momentum)


# each setup: the golden's scalars onto the config; returns the trainer's
# name, the golden's tag of the student's state, and the batches of a step
# (i = step % 2)

def _fixmatch(d, cfg):
    base_lr, min_lr, wd, momentum, weight_u, conf_thre = d["optim_scalars"]
    cfg.TRAINER.FIXMATCH.WEIGHT_U = float(weight_u)
    cfg.TRAINER.FIXMATCH.CONF_THRE = float(conf_thre)
    cfg.TRAINER.FIXMATCH.STRONG_TRANSFORMS = ["random_flip"]
    _warm_cosine(cfg, "sgd", base_lr, wd, min_lr, momentum=momentum)
    imgs = {k: np.asarray(d[k], np.float32) for k in ("imgs_x", "imgs_x2", "imgs_u", "imgs_u2")}
    return "FixMatch", None, lambda i: (
        {"img": imgs["imgs_x"][i], "img2": imgs["imgs_x2"][i],
         "label": d["labels_x"][i].astype(np.int64)},
        {"img": imgs["imgs_u"][i], "img2": imgs["imgs_u2"][i],
         "label": d["labels_u"][i].astype(np.int64)})


def _mt(d, cfg):
    (base_lr, min_lr, wd, momentum, rms_alpha, step_size, gamma, weight_u, ema_alpha,
     rampup) = d["optim_scalars"]
    t = cfg.TRAINER.MEANTEACHER
    t.WEIGHT_U, t.EMA_ALPHA, t.RAMPUP = float(weight_u), float(ema_alpha), int(rampup)
    cfg.OPTIM.NAME, cfg.OPTIM.LR, cfg.OPTIM.WEIGHT_DECAY = "rmsprop", float(base_lr), float(wd)
    cfg.OPTIM.MOMENTUM, cfg.OPTIM.RMSPROP_ALPHA = float(momentum), float(rms_alpha)
    cfg.OPTIM.MAX_EPOCH = 3
    cfg.OPTIM.LR_SCHEDULER = "single_step"
    cfg.OPTIM.STEPSIZE = (int(step_size),)
    cfg.OPTIM.GAMMA = float(gamma)
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "linear"
    cfg.OPTIM.WARMUP_MIN_LR = float(min_lr)
    return "MeanTeacher", "s", _xu_batches(d)


def _entmin(d, cfg):
    base_lr, min_lr, wd, lmda = d["optim_scalars"]
    cfg.TRAINER.ENTMIN.LMDA = float(lmda)
    _warm_cosine(cfg, "adamw", base_lr, wd, min_lr)
    return "EntMin", None, _xu_batches(d)


def _mixmatch(d, cfg):
    base_lr, min_lr, wd, momentum, weight_u, temp, beta, rampup, k = d["optim_scalars"]
    assert int(k) == 2
    cfg.DATALOADER.K_TRANSFORMS = int(k)
    t = cfg.TRAINER.MIXMATCH
    t.WEIGHT_U, t.TEMP, t.MIXUP_BETA, t.RAMPUP = (float(weight_u), float(temp), float(beta),
                                                  int(rampup))
    _warm_cosine(cfg, "sgd", base_lr, wd, min_lr, momentum=momentum)
    imgs_x = np.asarray(d["imgs_x"], np.float32)
    imgs_u = np.asarray(d["imgs_u"], np.float32)  # [2, K, B, 3, H, W]
    return "MixMatch", None, lambda i: (
        {"img": _interleave(imgs_x[i], imgs_x[i]),
         "label": np.repeat(d["labels_x"][i].astype(np.int64), 2)},
        {"img": _interleave(imgs_u[i, 0], imgs_u[i, 1]), "label": np.zeros(16, np.int64)})


def _xu_batches(d):
    imgs_x = np.asarray(d["imgs_x"], np.float32)
    imgs_u = np.asarray(d["imgs_u"], np.float32)
    return lambda i: ({"img": imgs_x[i], "label": d["labels_x"][i].astype(np.int64)},
                      {"img": imgs_u[i], "label": np.zeros(imgs_u.shape[1], np.int64)})


# golden -> (setup, loss keys with their (rtol, atol), the final atol by
# collection); the JAX tests' tolerances (tests/test_trajectory_parity.py:
# FixMatch :417-427, MeanTeacher :770-807, EntMin :1902-1913, MixMatch
# :2222-2233)
CASES = {
    "fixmatch": (_fixmatch, {"loss_x": (1e-4, 1e-5), "loss_u": (1e-4, 1e-5),
                             "y_u_pred_keep": (0.0, 1e-6)},
                 {"params": 5e-5, "batch_stats": 5e-5}),
    "mt": (_mt, {"loss_x": (1e-4, 1e-5), "loss_u": (1e-3, 1e-6)},
           {"params": 2e-3, "batch_stats": 1e-3}),
    "entmin": (_entmin, {"loss_x": (2e-4, 2e-5), "loss_u": (2e-4, 2e-5)},
               {"params": 2e-3, "batch_stats": 1e-3}),
    "mixmatch": (_mixmatch, {"loss_x": (2e-4, 2e-5), "loss_u": (1e-3, 2e-6)},
                 {"params": 1e-4, "batch_stats": 1e-4}),
}
GOLDEN_KEY = {"y_u_pred_keep": "keep"}


def _prefix(stage, tag, coll):
    return f"{stage}/{coll}" if tag is None else f"{stage}/{tag}/{coll}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_ssl_trajectory_matches_reference_trainer(name):
    from ovmr_tpu_torch.engine import ssl
    from ovmr_tpu_torch.modeling import ops as F

    setup, loss_tol, final_tol = CASES[name]
    data = np.load(osp.join(FIX, f"trajectory_{name}_golden.npz"))
    cfg = _base_cfg()
    trainer_name, tag, batches = setup(data, cfg)
    trainer = replay_trainer(getattr(ssl, trainer_name), cfg)
    trainer.max_epoch = 3
    assert trainer.get_model_names() == ["model"]
    assert transplant(trainer.net, data, "init" if tag is None else f"init/{tag}") == 14
    if name == "mt":  # the teacher starts as a copy of the (transplanted) student
        trainer.copy_teacher()
    if name == "mixmatch":  # the reference's recorded draws, step by step
        step_box = {}
        trainer.mixup_draws = lambda gen, n_x, n_u: (
            data["perms"][step_box["i"]], data["lams_x"][step_box["i"]],
            data["lams_u"][step_box["i"]])

    losses = {k: [] for k in loss_tol}
    trainer.num_batches = 2
    for step in range(6):
        trainer.epoch, trainer.batch_idx = divmod(step, 2)
        if trainer.batch_idx == 0:
            trainer.before_epoch()
        assert trainer.lr_table[trainer.epoch] == pytest.approx(data["lrs"][step], rel=1e-12)
        if name == "mixmatch":
            step_box["i"] = step
            weight_u, rampup = data["optim_scalars"][4], data["optim_scalars"][7]
            assert float(weight_u) * F.linear_rampup(step, int(rampup)) == pytest.approx(
                data["weight_u"][step], rel=1e-12)
        out = trainer.forward_backward_xu(*batches(step % 2))
        for k in losses:
            losses[k].append(out[k])

    for k, (rtol, atol) in loss_tol.items():
        np.testing.assert_allclose(losses[k], data[GOLDEN_KEY.get(k, k)], rtol=rtol, atol=atol,
                                   err_msg=k)
    if name == "fixmatch":  # the mask path really fires
        assert any(0.0 < k < 1.0 for k in losses["y_u_pred_keep"])
    if name == "mt":
        # the EMA decay starts at 0: the teacher tracks the student until
        # the second global step, so the consistency is exactly 0 there
        assert losses["loss_u"][0] == 0.0 and losses["loss_u"][1] == 0.0
        assert losses["loss_u"][3] > 1e-3  # the consistency term engages

    state = trainer.model_state("model")
    for coll, atol in final_tol.items():
        assert_tree_close(state[coll], data, _prefix("final", tag, coll), atol=atol)
    if name == "mt":
        from ovmr_tpu_torch.convert import dassl_state_from_numpy, dassl_state_to_numpy
        from tests.test_torch_dg_trajectory import unflatten

        teacher = dassl_state_to_numpy(trainer.teacher)
        for coll, atol in final_tol.items():
            assert_tree_close(teacher[coll], data, f"final/t/{coll}", atol=atol)
        # the function too (BN absorbs rescalings the raw leaves show):
        # eval-mode logits of the golden's final states against the port's
        probe = torch.as_tensor(np.asarray(data["imgs_x"][0], np.float32))
        for net, t in ((trainer.net, "s"), (trainer.teacher, "t")):
            ref = replay_trainer(ssl.MeanTeacher, cfg).net
            dassl_state_from_numpy(ref, {c: unflatten(data, f"final/{t}/{c}")
                                         for c in ("params", "batch_stats")})
            with torch.no_grad():
                got, want = net.eval()(probe), ref.eval()(probe)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3,
                                       err_msg=f"final {t} function")
