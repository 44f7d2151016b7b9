"""The port's radam, custom_adam, staged learning rates and the optax layout
of sgd's, radam's and custom_adam's state
(``ovmr_tpu_torch/engine/optimizers.py``, ``engine/checkpoint.py``).

- radam (with and without decay) and custom_adam replay the 12-step
  trajectories recorded from the reference optimizers
  (``tests/fixtures/optim_golden.npz``) at ``tests/test_optim_extra.py``'s
  tolerances;
- staged groups follow the JAX package's ``staged_lr_labels`` and step at
  ``LR`` and ``LR * BASE_LR_MULT``, also after ``set_lr``;
- sgd (momentum, nesterov, no momentum), radam and custom_adam states
  written by each package are resumed by the other: the reader's next step
  equals the writer's own (parameters within 1e-6), and the state arrays
  are the writer's bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ovmr_tpu.engine import checkpoint as jckpt
from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from ovmr_tpu.engine.optimizers import set_lr as j_set_lr
from ovmr_tpu.engine.optimizers import staged_lr_labels as j_staged_lr_labels
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine.optimizers import (
    CustomAdam,
    RAdam,
    SGD,
    build_optimizer,
    set_lr,
    staged_lr_labels,
)

FIXTURE = "tests/fixtures/optim_golden.npz"


def _optim(name, lr=0.01, wd=5e-4, **extra):
    cfg = j_cfg()
    cfg.OPTIM.NAME = name
    cfg.OPTIM.LR = lr
    cfg.OPTIM.WEIGHT_DECAY = wd
    for key, value in extra.items():
        setattr(cfg.OPTIM, key, value)
    return cfg.OPTIM


def _trajectory(name, wd, p0, grads, lr=0.01):
    w = torch.tensor(p0, requires_grad=True)
    opt = build_optimizer(_optim(name, lr, wd), {"w": w})
    out = []
    for g in grads:
        w.grad = torch.tensor(g)
        opt.step()
        out.append(w.detach().numpy().copy())
    return np.stack(out)


# the tolerances of tests/test_optim_extra.py (radam: the reference takes its
# rectifier's scalars in Python floats, as the port does; JAX in fp32)
@pytest.mark.parametrize("name,wd,key,atol,rtol", [
    ("radam", 5e-4, "radam", 2e-5, 5e-4),
    ("radam", 0.0, "radam_nodecay", 2e-5, 5e-4),
    ("custom_adam", 5e-4, "custom_adam", 2e-6, 2e-6),
])
def test_trajectory_matches_the_reference_optimizer(name, wd, key, atol, rtol):
    data = np.load(FIXTURE)
    traj = _trajectory(name, wd, data["p0"], data["grads"])
    np.testing.assert_allclose(traj, data[key], atol=atol, rtol=rtol)


@pytest.mark.parametrize("name,kind", [("radam", RAdam), ("custom_adam", CustomAdam),
                                       ("sgd", SGD)])
def test_factory_builds_the_port_classes(name, kind):
    opt = build_optimizer(_optim(name), {"w": torch.zeros(3, requires_grad=True)})
    assert type(opt) is kind


def test_radam_without_degenerated_sgd_skips_its_warmup_steps():
    """With ``degenerated_to_sgd`` off the first five steps (N_sma < 5) move
    nothing, decay included, as the reference skips the whole update."""
    w = torch.ones(4, requires_grad=True)
    opt = RAdam([w], lr=0.1, weight_decay=0.5, degenerated_to_sgd=False)
    for _ in range(5):
        w.grad = torch.full((4,), 0.3)
        opt.step()
    assert torch.equal(w.detach(), torch.ones(4))
    w.grad = torch.full((4,), 0.3)
    opt.step()
    assert float(w.detach()[0]) < 1.0


def test_staged_lr_groups_follow_the_labels():
    optim = _optim("sgd", lr=0.1, wd=0.0, MOMENTUM=0.0, STAGED_LR=True, NEW_LAYERS=("head",),
                   BASE_LR_MULT=0.1)
    params = {"backbone": {"w": torch.ones(3, requires_grad=True)},
              "head": {"w": torch.ones(3, requires_grad=True), "b": torch.ones(2, requires_grad=True)}}
    jparams = {"backbone": {"w": jnp.ones(3)}, "head": {"w": jnp.ones(3), "b": jnp.ones(2)}}
    assert staged_lr_labels(params, optim.NEW_LAYERS) == j_staged_lr_labels(jparams,
                                                                            optim.NEW_LAYERS)
    assert staged_lr_labels(params, ()) is None and j_staged_lr_labels(jparams, ()) is None

    opt = build_optimizer(optim, params)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.01, 0.1])
    assert [len(g["params"]) for g in opt.param_groups] == [1, 2]
    jopt = j_build_optimizer(optim, staged_labels=j_staged_lr_labels(jparams, optim.NEW_LAYERS))
    jstate = jopt.init(jparams)
    for lr in (0.1, 0.05):
        set_lr(opt, lr)
        jstate = j_set_lr(jstate, lr)
        for _, p in ckpt.named_leaves(params):
            p.grad = torch.ones_like(p)
        opt.step()
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.ones_like, jparams), jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        _close(params, jparams, 1e-7)
    # the groups' ratio holds after set_lr
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.005, 0.05])


# ---------------------------------------------------------------------------
# the optax layout: each package resumes the other's state
# ---------------------------------------------------------------------------

CASES = {
    "sgd": dict(name="sgd", MOMENTUM=0.9),
    "sgd_nesterov": dict(name="sgd", MOMENTUM=0.9, SGD_NESTEROV=True),
    "sgd_no_decay": dict(name="sgd", MOMENTUM=0.9, wd=0.0),
    "sgd_no_momentum": dict(name="sgd", MOMENTUM=0.0),
    "radam": dict(name="radam"),
    "custom_adam": dict(name="custom_adam"),
}
# radam's rectified branch starts at the sixth step: take six before the save
STEPS_BEFORE = 6


def _case_optim(case):
    kw = dict(CASES[case])
    return _optim(kw.pop("name"), lr=1e-2, wd=kw.pop("wd", 5e-4), **kw)


def _start():
    rng = np.random.default_rng(0)
    return {"ctx": rng.standard_normal((4, 8)).astype(np.float32),
            "extra": {"w": rng.standard_normal(5).astype(np.float32)}}


def _targets():
    rng = np.random.default_rng(1)
    # zeros in the gradient exercise custom_adam's masked moments
    t = {"ctx": rng.standard_normal((4, 8)).astype(np.float32),
         "extra//w": rng.standard_normal(5).astype(np.float32)}
    t["ctx"][0] = 0.0
    return t


def _port_params(start):
    return {"ctx": torch.tensor(start["ctx"], requires_grad=True),
            "extra": {"w": torch.tensor(start["extra"]["w"], requires_grad=True)}}


def _port_step(params, optimizer, targets):
    """The gradient of sum(a * p) + 0.5 * sum(a^2 * p^2): zero where a is."""
    optimizer.zero_grad(set_to_none=True)
    loss = sum((torch.as_tensor(targets[k]) * p).sum()
               + 0.5 * (torch.as_tensor(targets[k]) ** 2 * p * p).sum()
               for k, p in ckpt.named_leaves(params))
    loss.backward()
    optimizer.step()


def _jax_grads(params, targets):
    flat = jckpt._flatten(params)
    grads = {k: targets[k] + targets[k] ** 2 * np.asarray(v) for k, v in flat.items()}
    return jckpt._unflatten_like(params, grads)


def _jax_step(params, opt, state, targets):
    updates, state = opt.update(_jax_grads(params, targets), state, params)
    return optax.apply_updates(params, updates), state


def _close(port_params, jax_params, atol):
    want = jckpt._flatten(jax_params)
    for key, p in ckpt.named_leaves(port_params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[key]), atol=atol, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_state_resumes_in_the_port(tmp_path, case):
    start, targets, optim = _start(), _targets(), _case_optim(case)
    jopt = j_build_optimizer(optim)
    jp = jax.tree_util.tree_map(jnp.asarray, start)
    js = j_set_lr(jopt.init(jp), 1e-2)
    for _ in range(STEPS_BEFORE):
        jp, js = _jax_step(jp, jopt, js, targets)
    jckpt.save_checkpoint(str(tmp_path), "prompt_learner", 3, jp, js)
    jp_next, _ = _jax_step(jp, jopt, js, targets)

    params = _port_params(_start())
    optimizer = set_lr(build_optimizer(optim, params), 1e-2)
    assert ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", params, optimizer) == 3
    _close(params, jp, 0.0)
    # the resumed state is the JAX package's, array for array
    saved = {k[len("opt//"):]: v for k, v in np.load(tmp_path / "prompt_learner" / "model-3.npz")
             .items() if k.startswith("opt//")}
    got = ckpt.optimizer_state_arrays(optimizer, params)
    assert sorted(got) == sorted(saved)
    for key in saved:
        np.testing.assert_array_equal(got[key], saved[key], err_msg=key)
    _port_step(params, optimizer, targets)
    _close(params, jp_next, 1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_state_resumes_in_jax(tmp_path, case):
    start, targets, optim = _start(), _targets(), _case_optim(case)
    params = _port_params(start)
    optimizer = set_lr(build_optimizer(optim, params), 1e-2)
    for _ in range(STEPS_BEFORE):
        _port_step(params, optimizer, targets)
    ckpt.save_checkpoint(str(tmp_path), "prompt_learner", 4, params, optimizer)

    jopt = j_build_optimizer(optim)
    template = jax.tree_util.tree_map(jnp.asarray, start)
    jp, js, ep = jckpt.load_checkpoint(str(tmp_path), "prompt_learner", template,
                                       jopt.init(template), epoch=4)
    assert ep == 4 and js is not None
    assert int(js.count) == STEPS_BEFORE
    _port_step(params, optimizer, targets)
    jp, js = _jax_step(jax.tree_util.tree_map(jnp.asarray, jp), jopt, j_set_lr(js, 1e-2), targets)
    _close(params, jp, 1e-6)


def test_sgd_refuses_another_optimizers_state(tmp_path):
    params = _port_params(_start())
    radam = build_optimizer(_optim("radam"), params)
    _port_step(params, radam, _targets())
    ckpt.save_checkpoint(str(tmp_path), "prompt_learner", 1, params, radam)
    with pytest.raises(ValueError, match="not written by SGD"):
        ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", params,
                                    build_optimizer(_optim("sgd", MOMENTUM=0.9), params))
