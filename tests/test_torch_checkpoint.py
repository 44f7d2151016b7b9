"""The port's save/resume cycle (``ovmr_tpu_torch/engine/checkpoint.py``)
against the JAX package's (``ovmr_tpu/engine/checkpoint.py``).

- save, load and resume round trips (parameters, adam's moments and step);
- each package reads the other's npz: the ``params//...`` keys, the
  ``__epoch__`` entry, and adam's ``opt//...`` keys in optax's layout;
- the adam cross resume both ways: one package takes a step and saves, the
  other resumes and takes the second, which equals the first package's
  own second step (parameters within 1e-6). Both steps take the gradient
  of the same elementwise loss, so the optimizers, not the towers, are
  what is compared;
- the ``model.pth.tar-N`` fallback, pointer and best-model precedence, and
  the refusal of a foreign optimizer layout.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ovmr_tpu.engine import checkpoint as jckpt
from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from ovmr_tpu.engine.optimizers import set_lr as j_set_lr
from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine.optimizers import build_optimizer, set_lr
from ovmr_tpu_torch.models.aggregator import init_aggregator
from ovmr_tpu_torch.utils import get_cfg_default

LR = 1e-3
WIDTH, LAYERS = 64, 2


def _optim(wd=5e-4, name="adam"):
    """The OPTIM node both packages build from (the JAX package's own)."""
    cfg = j_cfg()
    cfg.OPTIM.NAME = name
    cfg.OPTIM.LR = LR
    cfg.OPTIM.WEIGHT_DECAY = wd
    return cfg.OPTIM


def _port_params(seed=0):
    agg = init_aggregator(width=WIDTH, layers=LAYERS, n_ctx=2, seed=seed)
    for _, leaf in ckpt.named_leaves(agg):
        leaf.requires_grad_(True)
    return agg


def _targets(params, seed=1):
    """A fixed array per leaf: the loss is sum(a * p) + 0.5 * sum(p^2)."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in ckpt.named_leaves(params)}


def _port_step(params, optimizer, targets):
    optimizer.zero_grad(set_to_none=True)
    loss = sum((torch.as_tensor(targets[k]) * p).sum() + 0.5 * (p * p).sum()
               for k, p in ckpt.named_leaves(params))
    loss.backward()
    optimizer.step()


def _jax_loss(params, targets):
    total = 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = jckpt.SEP.join(jckpt._path_str(p) for p in path)
        total = total + (targets[key] * leaf).sum() + 0.5 * (leaf * leaf).sum()
    return total


def _jax_step(params, opt, opt_state, targets):
    import optax

    grads = jax.grad(_jax_loss)(params, targets)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def _numpy(params):
    return {k: v.detach().cpu().numpy() for k, v in ckpt.named_leaves(params)}


def _jax_tree(params_np):
    return jax.tree_util.tree_map(jnp.asarray, convert.aggregator_params_to_numpy(params_np))


def _assert_params_close(port_params, jax_params, atol):
    got = _numpy(port_params)
    want = jckpt._flatten(jax_params)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("wd", [5e-4, 0.0])
def test_save_load_resume_round_trip(tmp_path, wd):
    params = _port_params()
    optimizer = set_lr(build_optimizer(_optim(wd), params), LR)
    targets = _targets(params)
    for _ in range(2):
        _port_step(params, optimizer, targets)
    ckpt.save_checkpoint(str(tmp_path), "prompt_learner", 2, params, optimizer)

    fresh = _port_params(seed=5)
    fresh_opt = set_lr(build_optimizer(_optim(wd), fresh), LR)
    assert ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", fresh, fresh_opt) == 2
    for (k, a), (_, b) in zip(ckpt.named_leaves(params), ckpt.named_leaves(fresh)):
        assert torch.equal(a, b), k
        sa, sb = optimizer.state[a], fresh_opt.state[b]
        assert float(sb["step"]) == 2.0
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(
            sa["exp_avg_sq"], sb["exp_avg_sq"]), k
    # and both continue identically
    _port_step(params, optimizer, targets)
    _port_step(fresh, fresh_opt, targets)
    for (k, a), (_, b) in zip(ckpt.named_leaves(params), ckpt.named_leaves(fresh)):
        assert torch.equal(a, b), k

    # nothing to resume: epoch 0, nothing changed
    empty = _port_params(seed=7)
    before = _numpy(empty)
    assert ckpt.resume_from_checkpoint(str(tmp_path / "none"), "prompt_learner", empty) == 0
    assert all(np.array_equal(before[k], v) for k, v in _numpy(empty).items())


@pytest.mark.parametrize("wd", [5e-4, 0.0])
def test_each_package_reads_the_others_npz(tmp_path, wd):
    # the port writes; the JAX package's load_checkpoint reads it
    params = _port_params()
    optimizer = set_lr(build_optimizer(_optim(wd), params), LR)
    _port_step(params, optimizer, _targets(params))
    ckpt.save_checkpoint(str(tmp_path / "port"), "prompt_learner", 4, params, optimizer)
    jopt = j_build_optimizer(_optim(wd))
    template = _jax_tree(params)
    jp, jstate, ep = jckpt.load_checkpoint(str(tmp_path / "port"), "prompt_learner", template,
                                           jopt.init(template), epoch=4)
    assert ep == 4
    _assert_params_close(params, jp, 0.0)
    inner = 1 if wd > 0 else 0
    adam = jstate.inner_state[inner]
    assert int(adam.count) == 1 and int(jstate.count) == 1
    for k, p in ckpt.named_leaves(params):
        mu = jckpt._flatten(adam.mu)[k]
        np.testing.assert_array_equal(mu, optimizer.state[p]["exp_avg"].numpy())
        np.testing.assert_array_equal(jckpt._flatten(adam.nu)[k],
                                      optimizer.state[p]["exp_avg_sq"].numpy())

    # the JAX package writes; the port reads
    jstate2 = j_set_lr(jopt.init(template), LR)
    jp2, jstate2 = _jax_step(template, jopt, jstate2, _targets(params))
    jckpt.save_checkpoint(str(tmp_path / "jax"), "prompt_learner", 6, jp2, jstate2)
    loaded, opt_flat, ep = ckpt.load_checkpoint(str(tmp_path / "jax"), "prompt_learner",
                                                params, epoch=6)
    assert ep == 6
    _assert_params_close(loaded, jp2, 0.0)
    fresh_opt = build_optimizer(_optim(wd), params)
    ckpt.load_optimizer_state(fresh_opt, params, opt_flat)
    adam2 = jstate2.inner_state[inner]
    for k, p in ckpt.named_leaves(params):
        st = fresh_opt.state[p]
        assert float(st["step"]) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), jckpt._flatten(adam2.mu)[k])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), jckpt._flatten(adam2.nu)[k])


@pytest.mark.parametrize("wd", [5e-4, 0.0])
def test_adam_cross_resume_jax_to_port(tmp_path, wd):
    """JAX takes a step and saves; the port resumes and takes the second
    step, which equals JAX's own second step."""
    p0 = _port_params()
    targets = _targets(p0)
    jopt = j_build_optimizer(_optim(wd))
    jp = _jax_tree(p0)
    js = j_set_lr(jopt.init(jp), LR)
    jp, js = _jax_step(jp, jopt, js, targets)
    jckpt.save_checkpoint(str(tmp_path), "prompt_learner", 1, jp, js)
    jp2, _ = _jax_step(jp, jopt, js, targets)

    params = _port_params(seed=3)
    optimizer = set_lr(build_optimizer(_optim(wd), params), LR)
    assert ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", params, optimizer) == 1
    _port_step(params, optimizer, targets)
    _assert_params_close(params, jp2, 1e-6)


@pytest.mark.parametrize("wd", [5e-4, 0.0])
def test_adam_cross_resume_port_to_jax(tmp_path, wd):
    """The port takes a step and saves; JAX resumes and takes the second
    step, which equals the port's own second step."""
    params = _port_params()
    targets = _targets(params)
    template = _jax_tree(params)
    optimizer = set_lr(build_optimizer(_optim(wd), params), LR)
    _port_step(params, optimizer, targets)
    ckpt.save_checkpoint(str(tmp_path), "prompt_learner", 1, params, optimizer)
    _port_step(params, optimizer, targets)

    jopt = j_build_optimizer(_optim(wd))
    jp, js, ep = jckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", template,
                                              jopt.init(template))
    assert ep == 1 and int(js.count) == 1
    js = j_set_lr(js, LR)
    jp2, _ = _jax_step(jp, jopt, js, targets)
    _assert_params_close(params, jp2, 1e-6)


def test_model_pth_tar_fallback(tmp_path):
    params = _port_params()
    ckpt.save_torch_checkpoint(str(tmp_path), "prompt_learner", 3, params)
    template = _port_params(seed=9)
    loaded, opt, ep = ckpt.load_checkpoint(str(tmp_path), "prompt_learner", template, epoch=3)
    assert ep == 3 and opt is None
    got = dict(ckpt.named_leaves(loaded))
    for k, v in ckpt.named_leaves(params):
        torch.testing.assert_close(got[k], v.detach(), rtol=0, atol=0)


def test_pointer_and_best_precedence(tmp_path):
    d = str(tmp_path)
    p1, pb, p2 = _port_params(1), _port_params(2), _port_params(3)
    ckpt.save_checkpoint(d, "prompt_learner", 1, p1)
    ckpt.save_checkpoint(d, "prompt_learner", 1, pb, model_name="model-best")
    ckpt.save_checkpoint(d, "prompt_learner", 2, p2)
    with open(osp.join(d, "prompt_learner", "checkpoint")) as f:
        assert f.read() == "model-2.npz"  # the pointer tracks the latest write
    for prefer, want in (("best", pb), ("pointer", p2)):
        got, _, _ = ckpt.load_checkpoint(d, "prompt_learner", p1, prefer=prefer)
        assert torch.equal(got["cls_token"], want["cls_token"].detach()), prefer
    got, _, ep = ckpt.load_checkpoint(d, "prompt_learner", p1, epoch=1)
    assert ep == 1 and torch.equal(got["cls_token"], p1["cls_token"].detach())
    # the JAX package follows the same preference on the port's files
    template = _jax_tree(p1)
    for prefer, want in (("best", pb), ("pointer", p2)):
        jp, _, _ = jckpt.load_checkpoint(d, "prompt_learner", template, prefer=prefer)
        np.testing.assert_array_equal(np.asarray(jp["cls_token"]),
                                      want["cls_token"].detach().numpy())
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "nothing"), "prompt_learner", p1)


@pytest.mark.parametrize("name", ["sgd", "adamw", "rmsprop", "amsgrad"])
def test_other_optimizers_keep_their_own_layout(tmp_path, name):
    """Each optimizer keeps its own optax layout: it round-trips its state,
    adam refuses its checkpoint and it refuses adam's."""
    params = _port_params()
    optimizer = set_lr(build_optimizer(_optim(name=name), params), LR)
    targets = _targets(params)
    _port_step(params, optimizer, targets)
    ckpt.save_checkpoint(str(tmp_path), "prompt_learner", 1, params, optimizer)
    fresh = _port_params(seed=4)
    fresh_opt = set_lr(build_optimizer(_optim(name=name), fresh), LR)
    assert ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", fresh, fresh_opt) == 1
    _port_step(params, optimizer, targets)
    _port_step(fresh, fresh_opt, targets)
    for (k, a), (_, b) in zip(ckpt.named_leaves(params), ckpt.named_leaves(fresh)):
        assert torch.equal(a, b), k
    # adam refuses this layout, and this optimizer refuses adam's
    adam_opt = build_optimizer(_optim(), fresh)
    with pytest.raises(ValueError, match="optax layout"):
        ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", fresh, adam_opt)
    ckpt.save_checkpoint(str(tmp_path / "adam"), "prompt_learner", 1, fresh, adam_opt)
    with pytest.raises(ValueError, match="not written by .* optax layout"):
        ckpt.resume_from_checkpoint(str(tmp_path / "adam"), "prompt_learner", fresh, fresh_opt)


def test_an_optimizer_without_an_optax_twin_is_refused(tmp_path):
    params = _port_params()
    leaves = [p for _, p in ckpt.named_leaves(params)]
    centred = torch.optim.RMSprop(leaves, lr=LR, centered=True)
    with pytest.raises(ValueError, match="no optax layout"):
        ckpt.save_checkpoint(str(tmp_path), "prompt_learner", 1, params, centred)
    two_groups = torch.optim.SGD([{"params": leaves[:1]}, {"params": leaves[1:]}], lr=LR)
    with pytest.raises(ValueError, match="stage name"):
        ckpt.optimizer_state_arrays(two_groups, params)


def test_adam_refuses_a_checkpoint_of_another_weight_decay(tmp_path):
    params = _port_params()
    optimizer = build_optimizer(_optim(5e-4), params)
    _port_step(params, optimizer, _targets(params))
    ckpt.save_checkpoint(str(tmp_path), "prompt_learner", 1, params, optimizer)
    with pytest.raises(ValueError, match="optax layout"):
        ckpt.resume_from_checkpoint(str(tmp_path), "prompt_learner", params,
                                    build_optimizer(_optim(0.0), params))


def test_port_config_names_the_flagship_optimizer():
    """The trainer builds its optimizer from the port's own OPTIM node, whose
    defaults are the JAX package's."""
    assert dict(get_cfg_default().OPTIM) == dict(j_cfg().OPTIM)


def test_copy_into_refuses_other_leaves():
    params = _port_params()
    before = params["cls_token"].detach().clone()
    with pytest.raises(KeyError, match="do not match"):
        ckpt.copy_into(params, {"cls_token": torch.zeros_like(before)})
    assert torch.equal(params["cls_token"].detach(), before)
