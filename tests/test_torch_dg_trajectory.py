"""The port's Dassl DG trainers replay the torch-recorded goldens.

- The five DG trajectory goldens (``trajectory_{vanilla,crossgrad,ddaig,
  daeldg,domainmix}_golden.npz``, recorded from the reference trainers'
  ``forward_backward`` on torch CPU) through the port's trainers, by the
  method of ``tests/test_trajectory_parity.py`` and at its tolerances: the
  recorded init state carried in with ``convert.dassl_state_from_numpy``,
  the recorded batches fed to ``forward_backward`` at each step's lr, the
  losses and the final parameters and BN statistics held against the
  golden. DomainMix's recorded torch draws are injected through
  ``trainer._np_rng``, as the JAX test injects them.
- ``dassl_golden.npz`` (``tests/test_dassl_golden.py``): two supervised
  steps of ``cnn_digitsdg``, WRN-16-4's BN running statistics, the ResNet
  blocks, and the MMD / Sinkhorn ops.
- ``e2e_fullloop_golden.npz`` on ``tests/fixtures/e2e_dataset``: the whole
  reference stack (DigitsDG reader, transforms, sampler, Vanilla's
  ``train()`` and ``test()``) through the port's ``build_trainer``.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.convert import dassl_state_from_numpy
from ovmr_tpu_torch.engine.dassl_base import SimpleNet
from ovmr_tpu_torch.engine.optimizers import build_optimizer
from ovmr_tpu_torch.modeling import build_backbone
from ovmr_tpu_torch.modeling import ops as F
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(ROOT, "tests", "fixtures")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the tiny tensors gain nothing from more,
    and under the suite's parallel workers the spinning thread pools of
    each worker slow every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def unflatten(data, prefix):
    """The golden's ``prefix/...`` keys as a nested dict of numpy arrays."""
    tree = {}
    for k in data.files:
        if k.startswith(prefix + "/"):
            parts = k[len(prefix) + 1:].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[k])
    return tree


def transplant(net, data, prefix):
    """The golden's init state into a port module; returns its leaf count."""
    state = {"params": unflatten(data, f"{prefix}/params"),
             "batch_stats": unflatten(data, f"{prefix}/batch_stats")}
    dassl_state_from_numpy(net, state)
    return sum(1 for k in data.files if k.startswith(f"{prefix}/params/"))


def assert_tree_close(tree, data, prefix, atol, rtol=1e-3):
    n = 0
    for k in data.files:
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        for p in k[len(prefix) + 1:].split("/"):
            node = node[p]
        np.testing.assert_allclose(node, data[k], atol=atol, rtol=rtol, err_msg=k)
        n += 1
    assert n > 0


def _base_cfg():
    cfg = get_cfg_default()
    cfg.MODEL.BACKBONE.NAME = "cnn_digitsdg"
    cfg.MODEL.HEAD.NAME = "mlp"
    cfg.MODEL.HEAD.HIDDEN_LAYERS = [64]
    cfg.MODEL.HEAD.ACTIVATION = "relu"
    cfg.MODEL.HEAD.BN = True
    cfg.MODEL.HEAD.DROPOUT = 0.0
    cfg.INPUT.SIZE = (32, 32)
    cfg.CUDA.DEVICE = "cpu"
    cfg.SEED = 1
    return cfg


def _schedule(cfg, scalars, optim, warmup):
    cfg.OPTIM.NAME = optim
    cfg.OPTIM.LR = float(scalars["lr"])
    cfg.OPTIM.WEIGHT_DECAY = float(scalars["wd"])
    if "momentum" in scalars:
        cfg.OPTIM.MOMENTUM = float(scalars["momentum"])
        cfg.OPTIM.SGD_NESTEROV = False
    cfg.OPTIM.MAX_EPOCH = 3
    cfg.OPTIM.LR_SCHEDULER = "cosine"
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = warmup
    if warmup == "constant":
        cfg.OPTIM.WARMUP_CONS_LR = float(scalars["warm"])
    else:
        cfg.OPTIM.WARMUP_MIN_LR = float(scalars["warm"])


def replay_trainer(cls, cfg, num_classes=4, num_source_domains=2):
    """A port trainer without a data manager, as the JAX tests build theirs."""

    class _DM:
        pass

    _DM.num_classes, _DM.num_source_domains = num_classes, num_source_domains
    trainer = cls.__new__(cls)
    trainer._init_state(cfg)
    trainer.dm = _DM()
    trainer.build_model()
    return trainer


class _ReplayRng:
    """np.random.Generator stand-in replaying recorded torch draws (the JAX
    test's ``_ReplayRng``)."""

    def __init__(self, lam, perm, multinomials):
        self._lam, self._perm = float(lam), np.asarray(perm)
        self._mn, self._mn_i = list(multinomials), 0

    def beta(self, a, b):
        return self._lam

    def permutation(self, n):
        assert n == len(self._perm)
        return self._perm.copy()

    def choice(self, n, size, replace):
        out = self._mn[self._mn_i]
        self._mn_i += 1
        assert len(out) == size
        return np.asarray(out)


def _vanilla(data, cfg):
    lr, warm, wd = data["optim_scalars"]
    _schedule(cfg, dict(lr=lr, warm=warm, wd=wd), "radam", "constant")
    return "Vanilla", {"model": 14}


def _crossgrad(data, cfg):
    lr, warm, wd, eps_f, eps_d, alpha_f, alpha_d = data["optim_scalars"]
    t = cfg.TRAINER.CROSSGRAD
    t.EPS_F, t.EPS_D, t.ALPHA_F, t.ALPHA_D = (float(v) for v in (eps_f, eps_d, alpha_f, alpha_d))
    _schedule(cfg, dict(lr=lr, warm=warm, wd=wd), "amsgrad", "constant")
    return "CrossGrad", {"F": 14, "D": 14}


def _ddaig(data, cfg):
    lr, warm, wd, mom, lmda, alpha, warmup, cmin, cmax = data["optim_scalars"]
    t = cfg.TRAINER.DDAIG
    t.G_ARCH, t.LMDA, t.ALPHA, t.WARMUP = "fcn_3x32_gctx", float(lmda), float(alpha), int(warmup)
    t.CLAMP, t.CLAMP_MIN, t.CLAMP_MAX = True, float(cmin), float(cmax)
    _schedule(cfg, dict(lr=lr, warm=warm, wd=wd, momentum=mom), "sgd", "constant")
    return "DDAIG", {"F": 14, "D": 14, "G": 10}


def _daeldg(data, cfg):
    lr, warm, wd, mom = data["optim_scalars"]
    cfg.DATALOADER.TRAIN_X.N_DOMAIN = 2
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.TRAINER.DAELDG.STRONG_TRANSFORMS = ["random_flip"]
    _schedule(cfg, dict(lr=lr, warm=warm, wd=wd, momentum=mom), "sgd", "linear")
    return "DAELDG", {"F": 12, "E": 2}


def _domainmix(data, cfg):
    lr, warm, wd, mom, alpha, beta = data["optim_scalars"]
    t = cfg.TRAINER.DOMAINMIX
    t.TYPE, t.ALPHA, t.BETA = "crossdomain", float(alpha), float(beta)
    _schedule(cfg, dict(lr=lr, warm=warm, wd=wd, momentum=mom), "sgd", "linear")
    return "DomainMix", {"model": 14}


# golden -> (setup, loss keys with their (rtol, atol), final atol by model and
# collection) at the JAX tests' tolerances (tests/test_trajectory_parity.py)
CASES = {
    "vanilla": (_vanilla, {"loss": (5e-4, 5e-5)}, lambda s: {"params": 2e-4, "batch_stats": 2e-4}),
    "crossgrad": (_crossgrad, {"loss_f": (1e-3, 1e-4), "loss_d": (1e-3, 1e-4)},
                  lambda s: {"params": 8 * float(s[0]), "batch_stats": 5e-3}),
    "ddaig": (_ddaig, {k: (2e-4, 2e-5) for k in ("loss_g", "loss_f", "loss_d")},
              lambda s: {"params": 1e-4, "batch_stats": 1e-4}),
    "daeldg": (_daeldg, {"loss_x": (2e-4, 2e-5), "loss_cr": (5e-4, 2e-5)},
               lambda s: {"params": 1e-4, "batch_stats": 1e-4}),
    "domainmix": (_domainmix, {"loss": (2e-4, 2e-5)},
                  lambda s: {"params": 1e-4, "batch_stats": 1e-4}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dg_trajectory_matches_reference_trainer(name):
    from ovmr_tpu_torch.engine import dg

    setup, loss_tol, final_tol = CASES[name]
    data = np.load(osp.join(FIX, f"trajectory_{name}_golden.npz"))
    cfg = _base_cfg()
    trainer_name, counts = setup(data, cfg)
    trainer = replay_trainer(getattr(dg, trainer_name), cfg)
    assert trainer.get_model_names() == list(counts)
    for model, n in counts.items():
        prefix = "init" if list(counts) == ["model"] else f"init/{model}"
        assert transplant(trainer._nets[model], data, prefix) == n

    imgs = np.asarray(data["imgs"], np.float32)
    losses = {k: [] for k in loss_tol}
    for step in range(6):
        epoch, i = divmod(step, 2)
        trainer.epoch, trainer.batch_idx, trainer.num_batches = epoch, i, 2
        if i == 0:
            trainer.before_epoch()
        assert trainer.lr_table[epoch] == pytest.approx(data["lrs"][step], rel=1e-12)
        batch = {"img": imgs[i], "label": data["labels"][i].astype(np.int64)}
        if "domains" in data.files:
            batch["domain"] = data["domains"][i].astype(np.int64)
        if "imgs2" in data.files:
            batch["img2"] = np.asarray(data["imgs2"][i], np.float32)
        if name == "domainmix":
            trainer._np_rng = _ReplayRng(data["lams"][step], data["perms"][step],
                                         data["multinomials"][step])
        out = trainer.forward_backward(batch)
        for k in losses:
            losses[k].append(out[k])

    for k, (rtol, atol) in loss_tol.items():
        np.testing.assert_allclose(losses[k], data[k], rtol=rtol, atol=atol, err_msg=k)
    if name == "crossgrad":
        # the small fixture lr keeps fp32 on one branch: the first steps tight
        for k in loss_tol:
            np.testing.assert_allclose(losses[k][:3], data[k][:3], rtol=1e-5, atol=1e-5)
    tol = final_tol(data["optim_scalars"])
    for model in counts:
        prefix = "final" if list(counts) == ["model"] else f"final/{model}"
        state = trainer.model_state(model)
        for coll in ("params", "batch_stats"):
            if any(k.startswith(f"{prefix}/{coll}/") for k in data.files):
                assert_tree_close(state[coll], data, f"{prefix}/{coll}", atol=tol[coll])


# --------------------------------------------------------------------------
# dassl_golden.npz
# --------------------------------------------------------------------------

def _nchw_tensor(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_supervised_step_matches_reference_torch():
    d = np.load(osp.join(FIX, "dassl_golden.npz"))
    net = SimpleNet(build_backbone("cnn_digitsdg", pretrained=False), None, 4)
    dassl_state_from_numpy(net, {"params": unflatten(d, "dd_init"), "batch_stats": {}})
    cfg = get_cfg_default()
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = 0.1
    opt = build_optimizer(cfg.OPTIM, list(net.parameters()))  # momentum 0.9, decay 5e-4
    net.train()

    def step(x, y):
        out = net(_nchw_tensor(x))
        loss = F.cross_entropy(out, torch.as_tensor(y).long())
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss, out

    loss1, logits1 = step(d["dd_x1"], d["dd_y1"])
    np.testing.assert_allclose(logits1.detach().numpy(), d["dd_logits1"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss1), d["dd_loss1"], rtol=1e-5)
    loss2, _ = step(d["dd_x2"], d["dd_y2"])
    np.testing.assert_allclose(float(loss2), d["dd_loss2"], rtol=1e-5)
    from ovmr_tpu_torch.convert import dassl_state_to_numpy

    assert_tree_close(dassl_state_to_numpy(net)["params"], d, "dd_final", atol=1e-5, rtol=1e-4)


def test_wrn_bn_running_stats_match_reference_torch():
    from ovmr_tpu_torch.convert import dassl_state_to_numpy

    d = np.load(osp.join(FIX, "dassl_golden.npz"))
    net = build_backbone("wide_resnet_16_4", pretrained=False)
    dassl_state_from_numpy(net, {"params": unflatten(d, "wrn_init/params"),
                                 "batch_stats": unflatten(d, "wrn_init/stats")})
    net.train()
    with torch.no_grad():
        f1 = net(_nchw_tensor(d["wrn_x1"]))
        f2 = net(_nchw_tensor(d["wrn_x2"]))
    np.testing.assert_allclose(f1.numpy(), d["wrn_feats1"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f2.numpy(), d["wrn_feats2"], rtol=1e-4, atol=1e-4)
    # running statistics after two train forwards: the unbiased-var update
    assert_tree_close(dassl_state_to_numpy(net)["batch_stats"], d, "wrn_after/stats",
                      atol=1e-5, rtol=1e-4)
    net.eval()
    with torch.no_grad():
        fe = net(_nchw_tensor(d["wrn_x1"]))
    np.testing.assert_allclose(fe.numpy(), d["wrn_feats_eval"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pre", ["rb", "bo"])
def test_resnet_blocks_match_reference_torch(pre):
    from ovmr_tpu_torch.convert import dassl_state_to_numpy
    from ovmr_tpu_torch.modeling.backbones import _BasicBlock, _Bottleneck

    d = np.load(osp.join(FIX, "dassl_golden.npz"))
    x = _nchw_tensor(d[f"{pre}_x"])
    block = (_BasicBlock(x.shape[1], 32, stride=2) if pre == "rb"
             else _Bottleneck(x.shape[1], 16, stride=2))
    dassl_state_from_numpy(block, {"params": unflatten(d, f"{pre}_init/params"),
                                   "batch_stats": unflatten(d, f"{pre}_init/stats")})
    block.train()
    with torch.no_grad():
        out = block(x)
    np.testing.assert_allclose(out.numpy(), d[f"{pre}_train_out"], rtol=1e-4, atol=1e-4)
    assert_tree_close(dassl_state_to_numpy(block)["batch_stats"], d, f"{pre}_after/stats",
                      atol=1e-5, rtol=1e-4)
    block.eval()
    with torch.no_grad():
        out_e = block(x)
    np.testing.assert_allclose(out_e.numpy(), d[f"{pre}_eval_out"], rtol=1e-4, atol=1e-4)


def test_mmd_and_sinkhorn_ops_match_reference_torch():
    d = np.load(osp.join(FIX, "dassl_golden.npz"))
    x, y = torch.as_tensor(d["op_x"]), torch.as_tensor(d["op_y"])
    for kt in ("linear", "poly", "rbf"):
        np.testing.assert_allclose(float(F.mmd(x, y, kernel_type=kt)), d[f"op_mmd_{kt}"],
                                   rtol=1e-4, atol=1e-5, err_msg=kt)
    np.testing.assert_allclose(float(F.mmd(x, y, kernel_type="rbf", normalize=True)),
                               d["op_mmd_rbf_norm"], rtol=1e-4, atol=1e-5)
    for dm, key in (("cosine", "op_sink_cosine"), ("euclidean", "op_sink_fast_euclidean")):
        np.testing.assert_allclose(float(F.sinkhorn_divergence(x, y, dist_metric=dm)), d[key],
                                   rtol=1e-4, atol=1e-5, err_msg=dm)
    x8, y8 = torch.as_tensor(d["op_x8"]), torch.as_tensor(d["op_y8"])
    np.testing.assert_allclose(float(F.minibatch_energy_distance(x8, y8)), d["op_med_cosine"],
                               rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# e2e_fullloop_golden.npz: the whole reference stack
# --------------------------------------------------------------------------

def test_fullloop_matches_reference_stack(tmp_path, monkeypatch):
    from ovmr_tpu_torch.engine.trainer import build_trainer

    data = np.load(osp.join(FIX, "e2e_fullloop_golden.npz"))
    lr, wd, warmup_min_lr = data["optim_scalars"]
    cfg = get_cfg_default()
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SEED = 7
    cfg.DATASET.ROOT = osp.join(FIX, "e2e_dataset")
    cfg.DATASET.NAME = "DigitsDG"
    cfg.DATASET.SOURCE_DOMAINS = ["mnist", "mnist_m"]
    cfg.DATASET.TARGET_DOMAINS = ["svhn"]
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.INTERPOLATION = "bilinear"
    cfg.INPUT.TRANSFORMS = ("normalize",)
    cfg.INPUT.PIXEL_MEAN = [0.5, 0.5, 0.5]
    cfg.INPUT.PIXEL_STD = [0.25, 0.25, 0.25]
    cfg.DATALOADER.TRAIN_X.SAMPLER = "SequentialSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.MODEL.BACKBONE.NAME = "cnn_digitsdg"
    cfg.MODEL.HEAD.NAME = ""
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = float(lr)
    cfg.OPTIM.WEIGHT_DECAY = float(wd)
    cfg.OPTIM.MAX_EPOCH = 3
    cfg.OPTIM.LR_SCHEDULER = "cosine"
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "linear"
    cfg.OPTIM.WARMUP_MIN_LR = float(warmup_min_lr)
    cfg.TRAINER.NAME = "Vanilla"
    cfg.TRAIN.PRINT_FREQ = 1
    cfg.CUDA.DEVICE = "cpu"
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)

    trainer = build_trainer(cfg)
    assert trainer.dm.num_classes == 4
    assert len(trainer.dm.dataset.train_x) == 32 and len(trainer.dm.dataset.test) == 12
    assert transplant(trainer._nets["model"], data, "init") == 10

    losses, accs, it = [], [], {"i": 0}
    orig_fb = trainer.forward_backward

    def rec_fb(batch):
        i = it["i"]
        np.testing.assert_array_equal(np.asarray(batch["label"]), data["batch_labels"][i])
        np.testing.assert_array_equal(np.asarray(batch["domain"]), data["batch_domains"][i])
        assert trainer.lr_table[trainer.epoch] == pytest.approx(data["lrs"][i], rel=1e-12)
        out = orig_fb(batch)
        losses.append(out["loss"])
        accs.append(out["acc"])
        it["i"] += 1
        return out

    monkeypatch.setattr(trainer, "forward_backward", rec_fb)
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

    assert it["i"] == 12
    np.testing.assert_allclose(losses, data["losses"], rtol=3e-5, atol=1e-6)
    np.testing.assert_array_equal(accs, data["accs"])
    assert_tree_close(trainer.model_state()["params"], data, "final/params", atol=5e-5)

    assert len(names_box) == 12
    lg = np.concatenate(logits_box, 0)
    order = np.argsort(np.asarray(names_box))
    lg, lb = lg[order], np.asarray(tlabels, np.int32)[order]
    np.testing.assert_array_equal(np.asarray([names_box[i] for i in order]), data["test_names"])
    np.testing.assert_array_equal(lb, data["test_labels"])
    np.testing.assert_allclose(lg, data["test_logits"], atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(lg.argmax(1), data["test_preds"])
    ref_acc, ref_err, ref_f1 = data["results"]
    assert results_box["accuracy"] == pytest.approx(ref_acc, rel=1e-9)
    assert results_box["error_rate"] == pytest.approx(ref_err, rel=1e-9)
    assert results_box["macro_f1"] == pytest.approx(ref_f1, rel=1e-9)
