"""The port's optimizers, schedule, dropout branch and generator
checkpoints against the JAX package (CPU, fp32).

Each ported optimizer name runs a few steps on a small tree beside the
JAX ``build_optimizer`` with the same recorded gradients; both sides read
the JAX package's own ``OPTIM`` config node. Dropout cannot be compared
mask for mask (torch and JAX streams differ), so its rate, scaling and
reproducibility are tested, and rate 0 is held bit for bit against the
serving path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from ovmr_tpu.engine.optimizers import set_lr as j_set_lr
from ovmr_tpu.engine.schedule import lr_schedule_from_cfg as j_lr_schedule_from_cfg
from ovmr_tpu.models.aggregator import init_aggregator as j_init_aggregator
from ovmr_tpu.models.import_torch import load_prompt_learner as j_load_prompt_learner
from ovmr_tpu.utils.defaults import get_cfg_default
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.engine.checkpoint import save_torch_checkpoint
from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves, set_lr
from ovmr_tpu_torch.engine.schedule import lr_for_epoch, lr_schedule_from_cfg
from ovmr_tpu_torch.models.aggregator import _dropout, generate_vokens, init_aggregator
from ovmr_tpu_torch.models.import_torch import load_prompt_learner
from ovmr_tpu_torch.ops.layers import (
    causal_mask,
    residual_attention_block,
    residual_block_remat,
)


def _optim_cfg(**overrides):
    cfg = get_cfg_default()
    for key, value in overrides.items():
        setattr(cfg.OPTIM, key, value)
    return cfg.OPTIM


OPTIMIZERS = {
    "adam": dict(NAME="adam", LR=1e-2, WEIGHT_DECAY=5e-4),
    "adam_no_decay": dict(NAME="adam", LR=1e-2, WEIGHT_DECAY=0.0, ADAM_BETA1=0.8, ADAM_BETA2=0.95),
    "amsgrad": dict(NAME="amsgrad", LR=1e-2, WEIGHT_DECAY=5e-4),
    "adamw": dict(NAME="adamw", LR=1e-2, WEIGHT_DECAY=0.05),
    "sgd": dict(NAME="sgd", LR=0.1, MOMENTUM=0.9, WEIGHT_DECAY=5e-4),
    "sgd_nesterov": dict(NAME="sgd", LR=0.1, MOMENTUM=0.9, SGD_NESTEROV=True, WEIGHT_DECAY=5e-4),
    "sgd_plain": dict(NAME="sgd", LR=0.1, MOMENTUM=0.0, SGD_NESTEROV=True, WEIGHT_DECAY=0.0),
    "rmsprop": dict(NAME="rmsprop", LR=1e-2, MOMENTUM=0.0, RMSPROP_ALPHA=0.9, WEIGHT_DECAY=5e-4),
    "rmsprop_momentum": dict(NAME="rmsprop", LR=1e-2, MOMENTUM=0.9, WEIGHT_DECAY=0.0),
}


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_matches_jax(case):
    """Five updates with recorded gradients (amsgrad's shrink after step 2,
    so its running max matters) and a new lr from step 3 on."""
    optim = _optim_cfg(**OPTIMIZERS[case])
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(4, 3).astype(np.float32), "b": {"c": rng.randn(5).astype(np.float32)}}
    grads = [
        {"a": s * rng.randn(4, 3).astype(np.float32), "b": {"c": s * rng.randn(5).astype(np.float32)}}
        for s in (1.0, 2.0, 0.1, 0.05, 0.5)
    ]
    j_opt = j_build_optimizer(optim)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = j_opt.init(jp)
    tp = {"a": torch.tensor(tree["a"], requires_grad=True),
          "b": {"c": torch.tensor(tree["b"]["c"], requires_grad=True)}}
    opt = build_optimizer(optim, tp)
    assert opt.param_groups[0]["lr"] == float(optim.LR)
    for step, g in enumerate(grads):
        if step == 3:
            state = j_set_lr(state, 0.3 * float(optim.LR))
            set_lr(opt, 0.3 * float(optim.LR))
        updates, state = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp["a"].grad, tp["b"]["c"].grad = torch.tensor(g["a"]), torch.tensor(g["b"]["c"])
        opt.step()
        np.testing.assert_allclose(tp["a"].detach().numpy(), np.asarray(jp["a"]),
                                   atol=2e-6, rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(tp["b"]["c"].detach().numpy(), np.asarray(jp["b"]["c"]),
                                   atol=2e-6, rtol=1e-5, err_msg=f"step {step}")


@pytest.mark.parametrize("overrides", [dict(NAME="radam", STAGED_LR=True),
                                       dict(NAME="custom_adam", STAGED_LR=True),
                                       dict(NAME="adam", STAGED_LR=True), dict(NAME="lion")])
def test_unported_optimizers_raise(overrides):
    # radam, custom_adam and staged groups are ported; staged groups need
    # named parameters, which a list of tensors does not give
    with pytest.raises(ValueError, match="needs named parameters|unsupported"):
        build_optimizer(_optim_cfg(**overrides), [torch.zeros(2, requires_grad=True)])


def test_param_leaves_order():
    tree = {"b": {"y": torch.zeros(1), "x": torch.ones(1)}, "a": torch.full((1,), 2.0)}
    assert [float(t) for t in param_leaves(tree)] == [2.0, 1.0, 0.0]


@pytest.mark.parametrize("scheduler,stepsize", [("cosine", (-1,)), ("single_step", (3,)),
                                                 ("multi_step", (2, 5))])
@pytest.mark.parametrize("warmup_type", ["constant", "linear"])
@pytest.mark.parametrize("recount", [True, False])
def test_lr_schedule_equals_jax(scheduler, stepsize, warmup_type, recount):
    optim = _optim_cfg(LR=2e-4, MAX_EPOCH=8, LR_SCHEDULER=scheduler, STEPSIZE=stepsize,
                       WARMUP_EPOCH=2, WARMUP_TYPE=warmup_type, WARMUP_RECOUNT=recount)
    table = lr_schedule_from_cfg(optim)
    assert table == j_lr_schedule_from_cfg(optim) and len(table) == 8
    assert table[3] == lr_for_epoch(
        3, 2e-4, 8, scheduler, stepsize, optim.GAMMA, 2, warmup_type,
        optim.WARMUP_CONS_LR, optim.WARMUP_MIN_LR, recount,
    )


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_rate_and_scaling():
    x = torch.full((400, 500), 2.0)
    out = _dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    share = float(kept.float().mean())
    # 200000 draws at p = 0.9: the standard error is 0.00067
    assert abs(share - 0.9) < 5 * (0.9 * 0.1 / x.numel()) ** 0.5
    np.testing.assert_allclose(out[kept].numpy(), 2.0 / 0.9, rtol=1e-6)
    assert out.dtype == x.dtype
    half = _dropout(x.to(torch.bfloat16), 0.1, torch.Generator().manual_seed(0))
    assert half.dtype == torch.bfloat16 and torch.equal(half != 0, kept)
    assert _dropout(x, 0.0, torch.Generator()) is x and _dropout(x, 0.1, None) is x


def test_vokens_dropout_is_seeded_and_rate_zero_is_the_serving_path():
    agg = init_aggregator(width=64, layers=2, n_ctx=2, seed=1)
    feats = torch.nn.functional.normalize(
        torch.randn(5, 3, 64, generator=torch.Generator().manual_seed(2)), dim=-1
    )
    serving = generate_vokens(agg, feats)
    for kwargs in (dict(dropout=0.0, generator=torch.Generator().manual_seed(3)),
                   dict(dropout=0.1, generator=None)):
        assert torch.equal(generate_vokens(agg, feats, **kwargs), serving)
    a = generate_vokens(agg, feats, dropout=0.1, generator=torch.Generator().manual_seed(3))
    b = generate_vokens(agg, feats, dropout=0.1, generator=torch.Generator().manual_seed(3))
    c = generate_vokens(agg, feats, dropout=0.1, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, serving)
    assert torch.isfinite(a).all()


def test_dropout_path_does_not_call_the_attention_kernel():
    """With dropout active the block expands the attention in torch ops
    (the masks must hit the probabilities); at rate 0 it calls attn_fn."""
    agg = init_aggregator(width=64, layers=2, n_ctx=2, seed=1)
    feats = torch.randn(2, 3, 64)
    calls = []

    def attn_fn(q, k, v, mask):
        calls.append(q.shape)
        return v

    generate_vokens(agg, feats, dropout=0.1, generator=torch.Generator().manual_seed(0),
                    attn_fn=attn_fn)
    assert not calls
    generate_vokens(agg, feats, attn_fn=attn_fn)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# remat block, checkpoints, the way back to numpy
# ---------------------------------------------------------------------------


def test_residual_block_remat_matches_the_plain_block():
    p = {k: v[0] for k, v in init_aggregator(width=64, layers=1, seed=0)["blocks"].items()}
    p["w_qkv"].requires_grad_(True)
    grads = []
    for block in (residual_attention_block, residual_block_remat):
        x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(1), requires_grad=True)
        out = block(x, p, 1, causal_mask(9))
        gx, gw = torch.autograd.grad((out ** 2).sum(), [x, p["w_qkv"]])
        grads.append((out.detach(), gx, gw))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_save_torch_checkpoint_round_trip(tmp_path):
    ja = jax.tree_util.tree_map(
        np.asarray, j_init_aggregator(jax.random.PRNGKey(1), width=64, layers=3, n_ctx=2)
    )
    ja["blocks"]["b_qkv"] = np.random.RandomState(0).randn(3, 192).astype(np.float32)
    agg = convert.aggregator_params_from_numpy(ja)
    path = save_torch_checkpoint(str(tmp_path), "prompt_learner", 5, agg)
    assert path.endswith("prompt_learner/model.pth.tar-5")
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["epoch"] == 5
    assert tuple(ckpt["state_dict"]["aggregator.resblocks.2.attn.in_proj_weight"].shape) == (192, 64)
    loaded, epoch = load_prompt_learner(path)
    assert epoch == 5
    back = convert.aggregator_params_to_numpy(loaded)
    np.testing.assert_array_equal(back["cls_token"], ja["cls_token"])
    for k, v in ja["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][k], v, err_msg=k)
    # the JAX package's loader reads the same file
    j_loaded, j_epoch = j_load_prompt_learner(path)
    assert j_epoch == 5
    for k, v in ja["blocks"].items():
        np.testing.assert_array_equal(np.asarray(j_loaded["blocks"][k]), v, err_msg=k)
    best = save_torch_checkpoint(str(tmp_path), "prompt_learner", 5, agg, model_name="model-best")
    assert best.endswith("model-best.pth.tar")


def test_saved_generator_loads_into_from_checkpoints(tmp_path, monkeypatch):
    from ovmr_tpu_torch.api import OVMRGenerator
    from ovmr_tpu_torch.models import clip as tclip

    cp = tclip.init_params(tclip.TINY, seed=0)
    agg = init_aggregator(width=64, layers=2, n_ctx=2, seed=0)
    path = save_torch_checkpoint(str(tmp_path), "prompt_learner", 1, agg)
    sd = _clip_state_dict(cp)
    torch.save(sd, tmp_path / "clip.pt")
    gen = OVMRGenerator.from_checkpoints(
        str(tmp_path / "clip.pt"), path, device="cpu", dtype=torch.float32
    )
    np.testing.assert_array_equal(
        gen.agg_params["blocks"]["w_qkv"].numpy(), agg["blocks"]["w_qkv"].numpy()
    )


def _clip_state_dict(cp):
    """A reference-layout CLIP state_dict of the port's TINY params."""
    from ovmr_tpu_torch.models.import_torch import TORCH_BLOCK_KEYS

    v, t = cp["visual"], cp["text"]
    sd = {
        "visual.conv1.weight": v["patch_embed_w"].t().reshape(64, 3, 16, 16).contiguous(),
        "visual.class_embedding": v["class_embedding"],
        "visual.positional_embedding": v["positional_embedding"],
        "visual.ln_pre.weight": v["ln_pre_scale"], "visual.ln_pre.bias": v["ln_pre_bias"],
        "visual.ln_post.weight": v["ln_post_scale"], "visual.ln_post.bias": v["ln_post_bias"],
        "visual.proj": v["proj"],
        "token_embedding.weight": t["token_embedding"],
        "positional_embedding": t["positional_embedding"],
        "ln_final.weight": t["ln_final_scale"], "ln_final.bias": t["ln_final_bias"],
        "text_projection": t["text_projection"], "logit_scale": cp["logit_scale"],
    }
    for prefix, blocks in (("visual.transformer.resblocks", v["blocks"]),
                           ("transformer.resblocks", t["blocks"])):
        for i in range(blocks["w_qkv"].shape[0]):
            for key, torch_key, transpose in TORCH_BLOCK_KEYS:
                w = blocks[key][i]
                sd[f"{prefix}.{i}.{torch_key}"] = w.t().contiguous() if transpose else w
    return sd
