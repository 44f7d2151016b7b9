"""The port's DG trainers end to end on the CPU, their checkpoints across
the two packages, and the data axis.

- Vanilla, CrossGrad, DDAIG, DAELDG and DomainMix ("random" and
  "crossdomain") through ``build_trainer`` -> ``train()`` -> ``test()`` on
  ``SyntheticDA`` at 32x32 (template: ``tests/test_dassl_trainers.py``).
- A Dassl run saved by the port resumes in the JAX package, and the other
  way round, parameters, BN statistics and optimizer state included; a JAX
  checkpoint loads as ``MODEL.INIT_WEIGHTS``.
- The optax layout of amsgrad, adamw, rmsprop (with and without momentum)
  and staged param groups: a JAX state resumes in the port and the port's
  in JAX, and the next step agrees.
- Vanilla on 2 local data shards (``CUDA.MESH.DATA 2``) equals the single
  program, BN statistics included (template: ``tests/test_dassl_mesh.py``),
  and two gloo ranks, one shard each, equal it too.
- On two gloo ranks MixStyle, EFDMix and TransNorm span the whole batch:
  the ops against the JAX functions on it, and Vanilla and DAELDG with
  mixing ResNet-18s against one process.
- The trainers run on ``CUDA.DEVICE`` and raise without a card.
"""

import contextlib
import os
import os.path as osp
import pathlib
import pickle
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine import trainer as trainer_mod
from ovmr_tpu_torch.engine.optimizers import build_optimizer, set_lr
from ovmr_tpu_torch.engine.trainer import build_trainer
from ovmr_tpu_torch.modeling import ops as F
from ovmr_tpu_torch.utils import get_cfg_default


class _NoWriter:
    def add_scalar(self, *a):
        pass

    def flush(self):
        pass


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """4 classes x 8 images at 32px (train 16, val 8, test 8), one intra-op
    thread, and no tensorboard writer (its first import costs seconds)."""
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,32")
    monkeypatch.setattr(trainer_mod.TrainerBase, "init_writer",
                        lambda self: setattr(self, "_writer", _NoWriter()) or self._writer)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_cfg(tmp_path, trainer, make=get_cfg_default, **overrides):
    cfg = make()
    cfg.TRAINER.NAME = trainer
    cfg.DATASET.NAME = "SyntheticDA"
    cfg.DATASET.ROOT = str(tmp_path / "data")
    cfg.DATASET.SOURCE_DOMAINS = ("a", "b")
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.SEED = 1
    cfg.INPUT.SIZE = (32, 32)
    cfg.MODEL.BACKBONE.NAME = "cnn_digitsdg"
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.HEAD.NAME = "mlp"
    cfg.MODEL.HEAD.HIDDEN_LAYERS = [16]
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = 0.01
    cfg.OPTIM.MAX_EPOCH = 1
    cfg.TRAIN.PRINT_FREQ = 1
    if make is get_cfg_default:
        cfg.CUDA.DEVICE = "cpu"
    for key, value in overrides.items():
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return cfg


TRAINERS = {
    "Vanilla": ({}, ["model"]),
    "CrossGrad": ({}, ["F", "D"]),
    "DDAIG": ({"TRAINER.DDAIG.G_ARCH": "fcn_3x32_gctx_stn", "TRAINER.DDAIG.WARMUP": 0},
              ["F", "D", "G"]),
    "DAELDG": ({"DATALOADER.TRAIN_X.SAMPLER": "RandomDomainSampler",
                "DATALOADER.TRAIN_X.N_DOMAIN": 2,
                "TRAINER.DAELDG.STRONG_TRANSFORMS": ("random_flip", "cutout", "randaugment2",
                                                     "normalize")}, ["F", "E"]),
    "DomainMix-random": ({"TRAINER.DOMAINMIX.TYPE": "random"}, ["model"]),
    "DomainMix-crossdomain": ({"TRAINER.DOMAINMIX.TYPE": "crossdomain"}, ["model"]),
}


@pytest.mark.parametrize("case", sorted(TRAINERS))
def test_trainer_trains_and_tests(tmp_path, case):
    overrides, models = TRAINERS[case]
    trainer = build_trainer(make_cfg(tmp_path, case.split("-")[0], **overrides))
    assert trainer.get_model_names() == models
    losses = []
    orig = trainer.forward_backward
    trainer.forward_backward = lambda batch: losses.append(orig(batch)) or losses[-1]
    trainer.train()  # one epoch, then test()
    assert len(losses) == 2 and all(np.isfinite(out["loss"]) for out in losses)
    assert 0.0 <= trainer.test() <= 100.0


def _jax_trainer(cfg):
    from ovmr_tpu.engine import register_all_trainers
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer

    register_all_trainers()
    cfg.freeze()
    return j_build_trainer(cfg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _assert_states_equal(port_state, jax_state, atol=0.0):
    a, b = _flat(port_state), _flat({"params": jax_state["params"],
                                     "batch_stats": jax_state["batch_stats"]})
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,optim", [("Vanilla", "sgd"), ("CrossGrad", "amsgrad")])
def test_checkpoints_resume_across_the_packages(tmp_path, name, optim):
    """The port's epoch-1 checkpoint resumes in JAX and JAX's in the port:
    states equal bit for bit, and the second epoch agrees."""
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg

    kw = {"OPTIM.NAME": optim, "TRAIN.CHECKPOINT_FREQ": 1, "TEST.NO_TEST": True,
          "DATALOADER.TRAIN_X.SAMPLER": "SequentialSampler"}
    port = build_trainer(make_cfg(tmp_path / "p", name, **kw))
    port.train()
    # the epoch-1 run continues in both packages, each in a copy of it
    shutil.copytree(tmp_path / "p", tmp_path / "q")
    jax_t = _jax_trainer(make_cfg(tmp_path / "p", name, make=j_cfg, **kw,
                                  **{"OPTIM.MAX_EPOCH": 2}))
    assert jax_t.resume_model_if_exist(str(tmp_path / "p" / "out")) == 1
    for model in port.get_model_names():
        _assert_states_equal(port.model_state(model), jax_t._models[model])
    jax_t.train()
    resumed = build_trainer(make_cfg(tmp_path / "q", name, **kw, **{"OPTIM.MAX_EPOCH": 2}))
    resumed.train()
    assert resumed.start_epoch == 1
    # an adam-family step normalises near-zero gradients, so an ulp can move
    # an entry by up to the lr: amsgrad at the JAX CrossGrad trajectory's
    # tolerance, 8 x lr (tests/test_trajectory_parity.py)
    atol = 2e-4 if optim == "sgd" else 8 * 0.01
    for model in port.get_model_names():
        _assert_states_equal(resumed.model_state(model), jax_t._models[model], atol=atol)

    # JAX's checkpoint resumes in the port
    jax_run = _jax_trainer(make_cfg(tmp_path / "j", name, make=j_cfg, **kw))
    jax_run.train()
    port2 = build_trainer(make_cfg(tmp_path / "j", name, **kw))
    assert port2.resume_model_if_exist(str(tmp_path / "j" / "out")) == 1
    for model in port2.get_model_names():
        _assert_states_equal(port2.model_state(model), jax_run._models[model])
    if name == "Vanilla":  # and as MODEL.INIT_WEIGHTS (the default build reads it)
        path = osp.join(str(tmp_path / "j" / "out"), "model", "model-1.npz")
        port3 = build_trainer(make_cfg(tmp_path / "k", name, **kw,
                                       **{"MODEL.INIT_WEIGHTS": path}))
        _assert_states_equal(port3.model_state(), jax_run._models["model"])


# --------------------------------------------------------------------------
# the optax layout of amsgrad, adamw, rmsprop and staged groups
# --------------------------------------------------------------------------

LAYOUTS = {
    "amsgrad": dict(NAME="amsgrad"),
    "amsgrad_no_decay": dict(NAME="amsgrad", WEIGHT_DECAY=0.0),
    "adamw": dict(NAME="adamw", WEIGHT_DECAY=0.05),
    "rmsprop": dict(NAME="rmsprop", MOMENTUM=0.0),
    "rmsprop_momentum": dict(NAME="rmsprop", MOMENTUM=0.9),
    "staged_sgd": dict(NAME="sgd", STAGED_LR=True, NEW_LAYERS=("head",), BASE_LR_MULT=0.1),
    "staged_adam": dict(NAME="adam", STAGED_LR=True, NEW_LAYERS=("head",), BASE_LR_MULT=0.1),
}


def _optim(case):
    cfg = get_cfg_default().OPTIM
    cfg.LR, cfg.WEIGHT_DECAY = 1e-2, 5e-4
    for k, v in LAYOUTS[case].items():
        setattr(cfg, k, v)
    return cfg


def _start():
    rng = np.random.default_rng(0)
    return {"body": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "head": {"b": rng.standard_normal(5).astype(np.float32)}}


def _grad(params):
    """The gradient of sum(t * p) + 0.5 * sum(t^2 * p^2) (t fixed)."""
    t = {"body/w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
         "head/b": np.linspace(0.5, -0.5, 5, dtype=np.float32)}
    return {k: t[k] + t[k] ** 2 * v for k, v in params.items()}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_optax_layout_round_trips(tmp_path, case):
    import jax
    import optax
    from ovmr_tpu.engine import checkpoint as jckpt
    from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
    from ovmr_tpu.engine.optimizers import set_lr as j_set_lr
    from ovmr_tpu.engine.optimizers import staged_lr_labels

    optim = _optim(case)
    start = _start()
    labels = staged_lr_labels(start, optim.NEW_LAYERS) if optim.STAGED_LR else None
    jopt = j_build_optimizer(optim, labels)

    def jax_step(p, s):
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(p)}
        g = _grad(flat)
        grads = {"body": {"w": g["body/w"]}, "head": {"b": g["head/b"]}}
        upd, s = jopt.update(grads, s, p)
        return optax.apply_updates(p, upd), s

    def port_step(params, opt):
        opt.zero_grad()
        g = _grad({"body/w": params["body"]["w"].detach().numpy(),
                   "head/b": params["head"]["b"].detach().numpy()})
        params["body"]["w"].grad = torch.as_tensor(g["body/w"])
        params["head"]["b"].grad = torch.as_tensor(g["head/b"])
        opt.step()

    def port_params(tree):
        return {k: {n: torch.tensor(np.asarray(v), requires_grad=True) for n, v in d.items()}
                for k, d in tree.items()}

    # JAX -> port
    jp, js = start, j_set_lr(jopt.init(start), 1e-2)
    for _ in range(3):
        jp, js = jax_step(jp, js)
    jckpt.save_checkpoint(str(tmp_path / "j"), "model", 3, jp, js)
    params = port_params(start)
    opt = set_lr(build_optimizer(optim, params), 1e-2)
    assert ckpt.resume_from_checkpoint(str(tmp_path / "j"), "model", params, opt) == 3
    jp, js = jax_step(jp, js)
    port_step(params, opt)
    for k in ("body", "head"):
        name = "w" if k == "body" else "b"
        np.testing.assert_allclose(params[k][name].detach().numpy(), np.asarray(jp[k][name]),
                                   atol=1e-6, rtol=1e-6)

    # port -> JAX
    params = port_params(start)
    opt = set_lr(build_optimizer(optim, params), 1e-2)
    for _ in range(3):
        port_step(params, opt)
    ckpt.save_checkpoint(str(tmp_path / "p"), "model", 3, params, opt)
    template = start
    jp, js, ep = jckpt.load_checkpoint(str(tmp_path / "p"), "model", template,
                                       jopt.init(template), epoch=3)
    assert ep == 3 and int(js.count) == 3
    jp, js = jax_step(jp, j_set_lr(js, 1e-2))
    port_step(params, opt)
    np.testing.assert_allclose(params["body"]["w"].detach().numpy(), np.asarray(jp["body"]["w"]),
                               atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# the data axis
# --------------------------------------------------------------------------

def _two_steps(trainer):
    trainer.epoch = 0
    trainer.before_epoch()
    rng = np.random.default_rng(3)
    for _ in range(2):
        batch = {"img": rng.standard_normal((8, 3, 32, 32)).astype(np.float32),
                 "label": rng.integers(0, 4, 8), "domain": rng.integers(0, 2, 8)}
        out = trainer.forward_backward(batch)
    return out, trainer.model_state()


@pytest.mark.parametrize("name", ["Vanilla", "DomainMix"])
def test_local_data_shards_equal_one_program(tmp_path, name):
    from tests.test_torch_dg_trajectory import replay_trainer
    from ovmr_tpu_torch.engine import dg

    results = []
    for data in (1, 2):
        cfg = make_cfg(tmp_path, name, **{"CUDA.MESH.DATA": data})
        torch.manual_seed(0)  # one init for both runs
        trainer = replay_trainer(getattr(dg, name), cfg)
        assert (trainer.mesh is None) == (data == 1)
        results.append(_two_steps(trainer))
    (out1, s1), (out2, s2) = results
    assert out1["loss"] == pytest.approx(out2["loss"], rel=1e-5)
    a, b = _flat(s1), _flat(s2)
    assert any(k.startswith("batch_stats/") for k in a)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0, err_msg=k)


# --------------------------------------------------------------------------
# two gloo ranks, one data shard each
# --------------------------------------------------------------------------

def rank_local(trainer):
    """The control: ``trainer`` with its cross-rank step made rank-local.
    Its gathers and blocks are this rank's rows, its domain groups a
    reshape of its own block and its step scope mixes features within the
    rank (:func:`F.rank_local_mixing`), so the moments, the similarities,
    the domain groups, MixMatch's shuffle and MixStyle/EFDMix span this
    rank's rows only."""
    trainer.gather_rows = lambda x: x
    trainer.own_rows = lambda x: x
    trainer.domain_groups = lambda x, n, split: [
        (rows, 0) for rows in x.reshape((n, -1) + tuple(x.shape[1:]))]
    scope = trainer.step_scope

    @contextlib.contextmanager
    def local_mixing_scope(*rows):
        with scope(*rows) as gen, F.rank_local_mixing():
            yield gen

    trainer.step_scope = local_mixing_scope
    return trainer


def trainer_leaves(trainer):
    """Every params, batch_stats and optimizer-state leaf of the trainer's
    models, flat."""
    out = {}
    for name in trainer.get_model_names():
        out.update({f"{name}/{k}": v for k, v in _flat(trainer.model_state(name)).items()})
        opt = trainer._optims[name]
        if opt is not None:
            arrays = ckpt.optimizer_state_arrays(opt, trainer._named_params(name))
            out.update({f"{name}/opt{k}": np.asarray(v) for k, v in arrays.items()})
    return out


def gate_readings(ref, got, rtol=1e-5, atol=1e-4):
    """A run ``(logged values, leaves)`` against the one-process run: its
    worst logged value over ``rel=rtol`` (``abs=1e-7``) and its worst leaf
    over ``atol``. A reading above 1 fails its gate."""
    (out_a, leaves_a), (out_b, leaves_b) = ref, got
    assert out_a.keys() == out_b.keys() and leaves_a.keys() == leaves_b.keys()
    loss = max(abs(out_b[k] - v) / max(rtol * abs(v), 1e-7) for k, v in out_a.items())
    leaf = max(float(np.abs(leaves_b[k].astype(np.float64) - v).max(initial=0.0)) / atol
               for k, v in leaves_a.items())
    return loss, leaf


def domain_batches(n_domain, split, steps=2, seed=3):
    """``RandomDomainSampler``-shaped batches: ``n_domain`` groups of
    ``split`` rows, a weak and a strong view."""
    rng = np.random.default_rng(seed)
    b = n_domain * split
    return [{"img": rng.standard_normal((b, 3, 32, 32)).astype(np.float32),
             "img2": rng.standard_normal((b, 3, 32, 32)).astype(np.float32),
             "label": rng.integers(0, 4, b), "domain": np.repeat(np.arange(n_domain), split)}
            for _ in range(steps)]


def _replay_steps(trainer, batches):
    trainer.epoch = 0
    trainer.before_epoch()
    for batch in batches:
        out = trainer.forward_backward(batch)
    return out, trainer_leaves(trainer)


def _daeldg_cfg(tmp, n_domain, batch, **overrides):
    return make_cfg(tmp, "DAELDG", **{**TRAINERS["DAELDG"][0],
                                      "DATALOADER.TRAIN_X.N_DOMAIN": n_domain,
                                      "DATALOADER.TRAIN_X.BATCH_SIZE": batch, **overrides})


# DAELDG's domain groups over two ranks: three groups of 4 rows, a rank's
# block of 6 cutting the middle one; two groups of 3, which do not split
# evenly (each rank holds one group and none of the other).
DAELDG_CASES = {"DAELDG": (3, 4), "DAELDG-uneven": (2, 3)}
# Cases replayed in float64, at the same gates (as
# tests/test_torch_da_trajectory.py replays M3SDA), since their float32 steps
# amplify a reordered sum past the gates: BatchNorm over 3 rows (on one
# process the data axis' sum-based statistics against torch's own read 0.95
# of the leaf gate), M3SDA's two steps (7.7 and 31 of the loss and leaf
# gates on two ranks in float32, 0.011 and 5e-6 in float64) and CDAC's pairs
# of temperature-0.05 prototypes, whose log(1 - p) takes p within 1e-7 of 1
# (150 and 996 in float32, 0.009 and 5e-9 in float64), and the mixing
# ResNet-18s at 32 px, whose gradients pass BatchNorm over a few values a
# channel (layer4's map is 1 x 1) and EFDMix's sort (0.39-1.78e3 of the loss
# gate and 2.6e3-3.8e4 of the leaf gate in float32, 0 and <= 2.4e-3 in
# float64)
FLOAT64_CASES = {"DAELDG-uneven", "M3SDA", "M3SDA-uneven", "CDAC", "DAELDG-ms", "Vanilla-ms",
                 "Vanilla-efdmix"}
SLICED_DAELDG = {"DATALOADER.NUM_WORKERS": 1}


def _daeldg_case(tmp, case, control=False):
    from ovmr_tpu_torch.engine import dg
    from tests.test_torch_da_trajectory import _float64_trainers
    from tests.test_torch_dg_trajectory import replay_trainer

    n_domain, split = DAELDG_CASES[case]
    torch.manual_seed(0)  # one init for every run
    with _float64_trainers(case in FLOAT64_CASES):
        trainer = replay_trainer(dg.DAELDG, _daeldg_cfg(tmp, n_domain, n_domain * split),
                                 num_source_domains=n_domain)
        return _replay_steps(rank_local(trainer) if control else trainer,
                             domain_batches(n_domain, split))


def _daeldg_loader_case(tmp, sliced):
    """DAELDG on its loader's first two batches (``RandomDomainSampler``,
    two domains of 4 rows), each rank decoding only its block when
    ``sliced``."""
    torch.manual_seed(0)
    trainer = build_trainer(_daeldg_cfg(tmp, 2, 8, **SLICED_DAELDG,
                                        **{"CUDA.MULTIHOST_SLICED_LOADER": sliced}))
    stream = iter(trainer.dm.train_loader_x)
    batches = [next(stream), next(stream)]
    return [bool(b.get("_local", False)) for b in batches], _replay_steps(trainer, batches)


# MixStyle/EFDMix and TransNorm on two ranks, each holding its rows of a
# batch of 8: rank 0 the first ``cut`` rows, as a step's blocks (4 + 4) and
# as a domain group's uneven pieces (3 + 5) hold them
OP_CUTS = {"even": 4, "uneven": 3}
MIX_OPS = [(op, mix) for op in ("mixstyle", "efdmix") for mix in ("random", "crossdomain")]


def _nchw(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _jax_op_refs():
    """JAX MixStyle and EFDMix and TransNorm (its source half the batch's first
    four rows, its state drawn) on the whole batch, in one jitted function:
    the inputs, a cotangent, MixStyle's and EFDMix's draws (recomputed from
    their key, as ``tests/test_torch_modeling_ops.py::_jax_mix_draws`` does),
    the outputs, the input gradients and TransNorm's statistics after, NCHW."""
    import jax
    import jax.numpy as jnp

    from ovmr_tpu.modeling import layers as jlayers
    from ovmr_tpu.modeling import ops as JF

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 5, 5, 3)).astype(np.float32) * 2.0 + 1.0
    cot = rng.standard_normal((8, 5, 5, 3)).astype(np.float32)
    xs = x.copy()
    xs[4:] += 3.0
    key = jax.random.PRNGKey(11)
    jt = jlayers.TransNorm(3)
    state = {"params": {"weight": 1.0 + 0.1 * rng.standard_normal(3),
                        "bias": 0.1 * rng.standard_normal(3)},
             "batch_stats": {"running_mean_s": rng.standard_normal(3),
                             "running_var_s": 1.0 + rng.random(3),
                             "running_mean_t": rng.standard_normal(3),
                             "running_var_t": 1.0 + rng.random(3)}}
    state = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), state)

    @jax.jit
    def refs(v, c, v_s):
        k_apply, k_lmda, k_perm = jax.random.split(key, 3)
        out = {"lmda": jax.random.beta(k_lmda, 0.1, 0.1, (8,)),
               "apply": jax.random.bernoulli(k_apply, 1.0)}
        for op, mix in MIX_OPS:
            want, vjp = jax.vjp(lambda u: getattr(JF, op)(u, key, p=1.0, alpha=0.1, mix=mix), v)
            out[f"{op}-{mix}"] = (want, vjp(c)[0])
            out[f"perm-{mix}"] = JF._mix_permutation(k_perm, 8, mix)
        (want, upd), vjp = jax.vjp(
            lambda u: jt.apply(state, u, train=True, mutable=["batch_stats"]), v_s)
        grad = vjp((c, jax.tree_util.tree_map(jnp.zeros_like, upd)))[0]
        out["transnorm"] = (want, upd["batch_stats"], grad)
        return out

    got = jax.tree_util.tree_map(np.asarray, refs(jnp.asarray(x), jnp.asarray(cot),
                                                  jnp.asarray(xs)))
    assert got["apply"]
    want, stats, grad = got["transnorm"]
    return {"x": _nchw(x), "cot": _nchw(cot),
            "mix": {(op, mix): (got["lmda"], got[f"perm-{mix}"], _nchw(got[f"{op}-{mix}"][0]),
                                _nchw(got[f"{op}-{mix}"][1])) for op, mix in MIX_OPS},
            "transnorm": {"x": _nchw(xs), "state": state, "want": _nchw(want),
                          "grad": _nchw(grad), "stats": stats}}


def _ops_on_rank(rank, refs):
    """This rank's rows of the batch through MixStyle/EFDMix (JAX's whole-batch
    draws injected) and TransNorm, within the data axis and the window of
    the rows it holds: the outputs and input gradients (and TransNorm's
    statistics after) for each cut."""
    from ovmr_tpu_torch.convert import dassl_state_from_numpy, dassl_state_to_numpy
    from ovmr_tpu_torch.modeling import layers
    from ovmr_tpu_torch.parallel.mesh import DataAxis

    axis = DataAxis.from_process_group()
    out = {}
    for name, cut in OP_CUTS.items():
        lo, hi = (0, cut) if rank == 0 else (cut, 8)

        def run(fn, x):
            xt = torch.tensor(x[lo:hi], requires_grad=True)
            with layers.data_axis_scope(axis), F.row_window(lambda n: (lo, 8)):
                got = fn(xt)
            got.backward(torch.as_tensor(refs["cot"][lo:hi]))
            return got.detach().numpy(), xt.grad.numpy()

        for (op, mix), (lmda, perm, _, _) in refs["mix"].items():
            out[op, mix, name] = run(lambda v: getattr(F, op)(
                v, p=1.0, alpha=0.1, mix=mix, lmda=lmda, perm=perm, apply=True), refs["x"])
        tn = layers.TransNorm(3)
        dassl_state_from_numpy(tn, refs["transnorm"]["state"])
        tn.train()
        out["transnorm", name] = (*run(tn, refs["transnorm"]["x"]),
                                  dassl_state_to_numpy(tn)["batch_stats"])
    return out


# Vanilla and DAELDG with mixing ResNet-18s (32 px), their coin at 1: case ->
# (trainer, backbone, mixing calls in two steps: Vanilla's three layers a
# forward; DAELDG's one a domain group's forward, three groups of 4 rows
# (DAELDG_CASES["DAELDG"]), a weak and a strong view)
MIXING_CASES = {"Vanilla-ms": ("Vanilla", "resnet18_ms_l123", 6),
                "Vanilla-efdmix": ("Vanilla", "resnet18_efdmix_l123", 6),
                "DAELDG-ms": ("DAELDG", "resnet18_ms_l1", 12)}


@contextlib.contextmanager
def _applied_mixes():
    """Whether each MixStyle/EFDMix call of the block mixed (a skipped call
    returns its input)."""
    applied = []
    saved = F.mixstyle, F.efdmix

    def counted(fn):
        def call(x, *args, **kwargs):
            out = fn(x, *args, **kwargs)
            applied.append(out is not x)
            return out
        return call

    F.mixstyle, F.efdmix = counted(saved[0]), counted(saved[1])
    try:
        yield applied
    finally:
        F.mixstyle, F.efdmix = saved


def _mixing_case(tmp, case, control=False):
    """Two steps of ``case`` from one init (``ms_p`` 1 on the built backbone):
    the logged values and leaves, and whether each mixing call mixed."""
    from ovmr_tpu_torch.engine import dg
    from tests.test_torch_dg_trajectory import replay_trainer

    from tests.test_torch_da_trajectory import _float64_trainers

    name, backbone, _ = MIXING_CASES[case]
    torch.manual_seed(0)  # one init for every run
    with _float64_trainers(case in FLOAT64_CASES), _applied_mixes() as applied:
        if name == "DAELDG":
            n_domain, split = DAELDG_CASES["DAELDG"]
            trainer = replay_trainer(dg.DAELDG, _daeldg_cfg(tmp, n_domain, n_domain * split, **{
                "MODEL.BACKBONE.NAME": backbone}), num_source_domains=n_domain)
            batches = domain_batches(n_domain, split)
        else:
            trainer = replay_trainer(dg.Vanilla, make_cfg(tmp, name, **{
                "MODEL.BACKBONE.NAME": backbone}))
            batches = domain_batches(2, 4)
        trainer.net.backbone.ms_p = 1.0
        result = _replay_steps(rank_local(trainer) if control else trainer, batches)
    return result, applied


def _dump(obj, path):
    """What the ranks and the parent hand each other (numpy leaves of
    ResNet-18s, ~0.5 GB a rank), pickled with protocol 5, which writes an
    array's bytes as they are (``torch.save`` pickles numpy arrays through
    protocol 2, seconds slower at this size)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=5)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _gloo_rank(rank, world, tmp):
    os.environ.update(OVMR_COORDINATOR=f"file://{tmp}/rendezvous", OVMR_NUM_PROCESSES=str(world),
                      OVMR_PROCESS_ID=str(rank), OVMR_SYNTHETIC="4,8,32")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ovmr_tpu_torch.engine import dg
    from ovmr_tpu_torch.parallel import maybe_initialize_distributed
    from tests.test_torch_dg_trajectory import replay_trainer

    trainer_mod.TrainerBase.init_writer = lambda self: _NoWriter()
    path = pathlib.Path(tmp)
    assert maybe_initialize_distributed("cpu")
    try:
        torch.manual_seed(0)
        trainer = replay_trainer(dg.Vanilla, make_cfg(path, "Vanilla"))
        assert trainer.axis.group is not None and trainer.loss_scale == 0.5
        out, state = _two_steps(trainer)
        runs = {case: _daeldg_case(path, case) for case in DAELDG_CASES}
        controls = {"DAELDG": _daeldg_case(path, "DAELDG", control=True)}
        loaders = {sliced: _daeldg_loader_case(path, sliced) for sliced in (True, False)}
        ops = _ops_on_rank(rank, _load(path / "op_refs.pkl"))
        mixing = {case: _mixing_case(path, case) for case in MIXING_CASES}
        controls.update({case: _mixing_case(path, case, control=True)[0]
                         for case in MIXING_CASES})
        _dump({"loss": out["loss"], "state": state, "runs": runs, "controls": controls,
               "loaders": loaders, "ops": ops, "mixing": mixing}, path / f"rank{rank}.pkl")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """The one-process runs, then one spawn of two gloo ranks running them
    again: Vanilla, DAELDG (its domain groups cut by the ranks' blocks, and
    not splitting evenly), its rank-local control, DAELDG on its loader
    with and without the sliced decode, MixStyle/EFDMix and TransNorm on the
    ranks' rows of JAX's whole batch, and Vanilla and DAELDG with mixing
    backbones and their rank-local controls."""
    from tests.test_torch_dg_trajectory import replay_trainer
    from ovmr_tpu_torch.engine import dg

    tmp = tmp_path_factory.mktemp("gloo")
    with pytest.MonkeyPatch.context() as mp_env:
        mp_env.setenv("OVMR_SYNTHETIC", "4,8,32")
        mp_env.setattr(trainer_mod.TrainerBase, "init_writer", lambda self: _NoWriter())
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            torch.manual_seed(0)
            vanilla = _two_steps(replay_trainer(dg.Vanilla, make_cfg(tmp, "Vanilla")))
            refs = {case: _daeldg_case(tmp, case) for case in DAELDG_CASES}
            loader = _daeldg_loader_case(tmp, True)
            mixing = {case: _mixing_case(tmp, case) for case in MIXING_CASES}
            op_refs = _jax_op_refs()
            _dump(op_refs, tmp / "op_refs.pkl")
            mp.spawn(_gloo_rank, args=(2, str(tmp)), nprocs=2, join=True)
        finally:
            torch.set_num_threads(threads)
    ranks = [_load(tmp / f"rank{r}.pkl") for r in range(2)]
    return {"vanilla": vanilla, "refs": refs, "loader": loader, "ranks": ranks,
            "mixing": mixing, "op_refs": op_refs}


def test_two_gloo_ranks_equal_one_program(gloo_runs):
    """One data shard a rank: the global BN statistics (all-reduced sums),
    the row-mean losses' share and the summed gradients give the single
    program's update on both ranks."""
    out1, s1 = gloo_runs["vanilla"]
    a = _flat(s1)
    for rank, got in enumerate(gloo_runs["ranks"]):
        assert got["loss"] == pytest.approx(out1["loss"], rel=1e-5)
        b = _flat(got["state"])
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0, err_msg=f"rank {rank} {k}")


def _assert_ranks_hold(ref, runs):
    for rank, got in enumerate(runs):
        loss, leaf = gate_readings(ref, got)
        assert loss <= 1 and leaf <= 1, f"rank {rank}: losses {loss:.3g}, leaves {leaf:.3g}"
    assert gate_readings(runs[0], runs[1], rtol=0, atol=1e-30) == (0.0, 0.0), "the ranks differ"


@pytest.mark.parametrize("case", sorted(DAELDG_CASES))
def test_daeldg_on_two_gloo_ranks_equals_one_program(gloo_runs, case):
    """Each rank forwards its rows of every domain group (a group's
    BatchNorm statistics over all its rows, an empty piece where the rank
    holds none of it), the groups' domain ids gathered: both ranks take the
    single program's step, losses within rel 1e-5 and every params,
    batch_stats and optimizer leaf within 1e-4."""
    _assert_ranks_hold(gloo_runs["refs"][case], [r["runs"][case] for r in gloo_runs["ranks"]])


@pytest.mark.parametrize("sliced", [True, False], ids=["sliced", "full-decode"])
def test_daeldg_on_two_gloo_ranks_with_its_loader_equals_one_program(gloo_runs, sliced):
    """DAELDG's domain-grouped loader: each rank decoding only its block
    (the strong views keyed on global positions) or the whole batch gives
    the single program's step (``tests/multihost_worker.py:215-292``)."""
    flags, ref = gloo_runs["loader"]
    assert flags == [False, False]
    for got in gloo_runs["ranks"]:
        assert got["loaders"][sliced][0] == [sliced, sliced]
    _assert_ranks_hold(ref, [r["loaders"][sliced][1] for r in gloo_runs["ranks"]])


def test_daeldg_rank_local_control_fails_the_gates(gloo_runs):
    """The control: domain groups taken over each rank's own block miss the
    gates the cross-rank step meets."""
    for got in gloo_runs["ranks"]:
        assert max(gate_readings(gloo_runs["refs"]["DAELDG"], got["controls"]["DAELDG"])) > 1


@pytest.mark.parametrize("cut", sorted(OP_CUTS))
@pytest.mark.parametrize("op,mix", MIX_OPS)
def test_feature_mixing_on_two_gloo_ranks_matches_jax_on_the_whole_batch(gloo_runs, op, mix,
                                                                         cut):
    """Each rank mixes its rows with their partners wherever they are, at
    the whole batch's weights: the ranks' rows, in order, are the JAX
    function's on the whole batch (fp32 1e-5), and EFDMix's input gradient
    reaches the partners across the ranks (1e-4), for a step's even blocks
    and a domain group's uneven pieces."""
    _, _, want, grad = gloo_runs["op_refs"]["mix"][op, mix]
    got = [r["ops"][op, mix, cut] for r in gloo_runs["ranks"]]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]), want, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g[1] for g in got]), grad, atol=1e-4)


@pytest.mark.parametrize("cut", sorted(OP_CUTS))
def test_transnorm_on_two_gloo_ranks_matches_jax_on_the_whole_batch(gloo_runs, cut):
    """The halves are the whole batch's (rank 0 may hold only source rows),
    their statistics over both ranks' rows: the outputs and each rank's
    running statistics (1e-5) and the input gradient (1e-4) are JAX's."""
    ref = gloo_runs["op_refs"]["transnorm"]
    got = [r["ops"]["transnorm", cut] for r in gloo_runs["ranks"]]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]), ref["want"], atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g[1] for g in got]), ref["grad"], atol=1e-4)
    for rank, (_, _, stats) in enumerate(got):
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(stats[k], v, atol=1e-5, err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", sorted(MIXING_CASES))
def test_feature_mixing_trainers_on_two_gloo_ranks_equal_one_program(gloo_runs, case):
    """Vanilla and DAELDG whose backbones mix every forward (the coin at 1,
    every mixing call mixed): each rank draws the whole batch's weights and
    permutation and mixes across the ranks, so both take the single
    program's step at the gates, bit for bit alike."""
    ref, applied = gloo_runs["mixing"][case]
    calls = MIXING_CASES[case][2]
    assert applied == [True] * calls
    for got in gloo_runs["ranks"]:
        assert got["mixing"][case][1] == [True] * calls
    _assert_ranks_hold(ref, [r["mixing"][case][0] for r in gloo_runs["ranks"]])


@pytest.mark.parametrize("case", sorted(MIXING_CASES))
def test_feature_mixing_rank_local_controls_fail_the_gates(gloo_runs, case):
    """The control: the mixing within each rank's block, drawn for its rows
    alone, misses the gates the cross-rank step meets."""
    for got in gloo_runs["ranks"]:
        assert max(gate_readings(gloo_runs["mixing"][case][0], got["controls"][case])) > 1


def test_trainers_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = make_cfg(tmp_path, "Vanilla")
    cfg.CUDA.DEVICE = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(cfg)
