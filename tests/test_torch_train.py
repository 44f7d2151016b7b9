"""The port's training step against the torch-recorded goldens and the JAX
package's ``make_train_step`` (CPU, fp32, dropout 0).

- ``ovmr_grad_golden.npz``: loss and aggregator gradients recorded from
  the reference modules' autograd, with the tolerances of
  ``tests/test_grad_parity.py``.
- ``trajectory_golden.npz``: nine consecutive optimizer updates recorded
  from the reference trainer, driven exactly as the MM_CLS_OP section of
  ``tests/test_trajectory_parity.py`` drives the JAX side (recorded splits,
  ``build_optimizer`` + ``lr_schedule_from_cfg``/``set_lr`` +
  ``make_train_step``), at that test's tolerances.
- one step against the JAX ``make_train_step`` on converted TINY params.

The optimizer settings are the JAX package's own ``OPTIM`` config node,
handed to both sides.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from ovmr_tpu.engine.train_step import make_train_step as j_make_train_step
from ovmr_tpu.models import clip as jclip
from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
from ovmr_tpu.utils.defaults import get_cfg_default
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves, set_lr
from ovmr_tpu_torch.engine.schedule import lr_schedule_from_cfg
from ovmr_tpu_torch.engine.train_step import (
    classifier_loss,
    make_train_step,
    sample_split_point,
)
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr as tovmr
from ovmr_tpu_torch.models.import_torch import (
    clip_params_from_state_dict,
    prompt_learner_params_from_state_dict,
)
from ovmr_tpu_torch.ops.block_fused import fused_residual_block
from ovmr_tpu_torch.ops.layers import residual_attention_block

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BLOCK_FNS = {"fused": fused_residual_block, "torch_math": residual_attention_block}


def _sd(data, prefix):
    return {k[len(prefix) + 1:]: data[k] for k in data.files if k.startswith(prefix + ".")}


def _trainable(agg):
    for leaf in param_leaves(agg):
        leaf.requires_grad_(True)
    return agg


@pytest.mark.parametrize("block", list(BLOCK_FNS))
def test_loss_and_grads_match_torch_golden(block):
    """Gradients flow through the frozen text tower (the Function around
    the block halves, or the checkpointed torch-math block) into the
    aggregator, and match the reference's autograd."""
    data = np.load(os.path.join(FIXTURES, "ovmr_grad_golden.npz"))
    clip_params, cfg = clip_params_from_state_dict(_sd(data, "clip"))
    agg = _trainable(prompt_learner_params_from_state_dict(_sd(data, "agg"), n_layers=2))
    num_cls, split = 3, 2
    e_feats = torch.tensor(data["e_feats"])
    prompt_embeds, vis_embeds = tovmr.prompt_embeddings(
        clip_params, e_feats, torch.tensor(data["ptok"]), torch.tensor(data["vtok"][0])
    )
    frozen = (
        torch.tensor(data["q_feats"]), e_feats, prompt_embeds, vis_embeds,
        torch.arange(num_cls).repeat_interleave(split),
        clip_params["logit_scale"].float().exp(),
    )
    loss = classifier_loss(clip_params, cfg, agg, frozen, torch.tensor(data["eot"]),
                           block_fn=BLOCK_FNS[block])
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(data["loss"]), rtol=1e-5)
    np.testing.assert_allclose(
        agg["cls_token"].grad.numpy(), data["grad.cls_token"], atol=2e-5, rtol=1e-3
    )
    blocks = agg["blocks"]
    for i in range(2):
        # the port's layout is [in, out]; the recorded grads are [out, in]
        for ours, theirs in (("w_qkv", "in_proj_weight"), ("w_out", "out_proj.weight"),
                             ("c_fc_w", "c_fc.weight"), ("c_proj_w", "c_proj.weight")):
            np.testing.assert_allclose(
                blocks[ours].grad[i].numpy().T, data[f"grad.b{i}.{theirs}"],
                atol=2e-5, rtol=1e-3, err_msg=f"{ours}[{i}]",
            )
    for leaf in param_leaves(clip_params):
        assert leaf.grad is None and not leaf.requires_grad


def _optim_cfg(**overrides):
    cfg = get_cfg_default()
    for key, value in overrides.items():
        setattr(cfg.OPTIM, key, value)
    return cfg.OPTIM


def test_nine_step_trajectory_matches_reference_trainer():
    n_cls, n_ins, epochs, batches = 4, 8, 3, 3
    data = np.load(os.path.join(FIXTURES, "trajectory_golden.npz"))
    clip_params, ccfg = clip_params_from_state_dict(_sd(data, "clip"))
    agg = _trainable(prompt_learner_params_from_state_dict(_sd(data, "agg_init"), n_layers=4))

    base_lr, cons_lr, wd, b1, b2 = (float(v) for v in data["optim_scalars"])
    optim = _optim_cfg(
        NAME="adam", LR=base_lr, WEIGHT_DECAY=wd, ADAM_BETA1=b1, ADAM_BETA2=b2,
        MAX_EPOCH=epochs, LR_SCHEDULER="cosine", WARMUP_EPOCH=1, WARMUP_TYPE="constant",
        WARMUP_CONS_LR=cons_lr,
    )
    optimizer = build_optimizer(optim, agg)
    step_fn = make_train_step(ccfg, dropout=0.0)
    lr_table = lr_schedule_from_cfg(optim)

    images = np.asarray(data["images"], np.float32)  # [2, 32, 3, 64, 64]
    ptok_all, eot_all = torch.tensor(data["ptok"]), torch.tensor(data["eot"])
    vtok = torch.tensor(data["vtok"])

    losses, step = [], 0
    for epoch in range(epochs):
        set_lr(optimizer, lr_table[epoch])  # before_epoch
        for _ in range(batches):
            # the lr actually used this step equals torch's param-group lr
            assert optimizer.param_groups[0]["lr"] == pytest.approx(data["lrs"][step], rel=1e-12)
            i = int(data["batch_order"][step])
            order = torch.tensor(data["class_orders"][i]).long()
            imgs = torch.tensor(images[i].reshape(n_cls, n_ins, *images.shape[2:]))
            loss = step_fn(agg, optimizer, clip_params, imgs, ptok_all[order], eot_all[order],
                           vtok, None, int(data["splits"][step]))
            losses.append(float(loss))
            step += 1

    np.testing.assert_allclose(losses, data["losses"], rtol=2e-5, atol=2e-5)

    final = prompt_learner_params_from_state_dict(_sd(data, "agg_final"), n_layers=4)
    init = prompt_learner_params_from_state_dict(_sd(data, "agg_init"), n_layers=4)
    ours = dict(cls_token=agg["cls_token"], **agg["blocks"])
    ref = dict(cls_token=final["cls_token"], **final["blocks"])
    assert set(ours) == set(ref) and len(ours) == 13
    for name, leaf in ours.items():
        diff = (leaf.detach() - ref[name]).abs().numpy()
        # adam normalizes: noise-gradient elements step +-lr with a sign that
        # is not reproducible across frameworks, so bound the bulk tightly
        # and the tail by a few lr-sized steps
        assert float(np.median(diff)) < 3e-6, name
        assert float(np.mean(diff)) < 2e-5, name
        assert float(diff.max()) < 12 * base_lr, name
    moved = (agg["cls_token"].detach() - init["cls_token"]).abs().max()
    assert float(moved) > 1e-4  # the trajectory really moved


@pytest.mark.parametrize("block", list(BLOCK_FNS))
def test_one_step_matches_jax_train_step(block):
    """The same TINY params, images, prompts and split through the JAX
    step and the port's: loss and post-step aggregator params. SGD, whose
    update is linear in the gradient, so every element is comparable."""
    key = jax.random.PRNGKey(0)
    jp = jclip.init_params(key, jclip.TINY)
    ja = j_init_aggregator(key, width=64, layers=2, n_ctx=2)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tp = convert.clip_params_from_numpy(np_tree(jp))
    ta = _trainable(convert.aggregator_params_from_numpy(np_tree(ja)))

    rng = np.random.RandomState(3)
    n_cls, n_ins, split = 3, 4, 2
    images = (rng.rand(n_cls, 1, 3, 32, 32) + 0.3 * rng.rand(n_cls, n_ins, 3, 32, 32)).astype(
        np.float32
    )
    ptok, eot, vtok = tovmr.build_prompt_tokens(["red circle", "green square", "blue triangle"])
    optim = _optim_cfg(NAME="sgd", LR=0.05, MOMENTUM=0.9, WEIGHT_DECAY=5e-4)

    j_opt = j_build_optimizer(optim)
    j_step = j_make_train_step(jclip.TINY, j_opt, dropout=0.0)
    ja_new, _, j_loss = j_step(
        ja, j_opt.init(ja), jp, jnp.asarray(images), jnp.asarray(ptok), jnp.asarray(eot),
        jnp.asarray(vtok), jax.random.PRNGKey(0), split,
    )

    optimizer = build_optimizer(optim, ta)
    before = convert.aggregator_params_to_numpy(ta)
    loss = make_train_step(tclip.TINY, dropout=0.0, block_fn=BLOCK_FNS[block])(
        ta, optimizer, tp, torch.tensor(images), torch.tensor(ptok), torch.tensor(eot),
        torch.tensor(vtok), None, split,
    )
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5)
    after = convert.aggregator_params_to_numpy(ta)
    ref = np_tree(ja_new)
    np.testing.assert_allclose(after["cls_token"], ref["cls_token"], atol=1e-5)
    assert np.abs(after["cls_token"] - before["cls_token"]).max() > 1e-4
    for k, v in after["blocks"].items():
        np.testing.assert_allclose(v, ref["blocks"][k], atol=1e-5, err_msg=k)


def test_sample_split_point_range():
    import random

    for rng in (np.random.default_rng(0), random.Random(0)):
        draws = {sample_split_point(rng, 8) for _ in range(200)}
        assert draws == {2, 3, 4, 5}
