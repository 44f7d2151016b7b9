"""The port's data-parallel and data x model training steps against JAX.

The same TINY params, images, prompts and split go through JAX's
``make_sharded_train_step`` on the virtual 8-device CPU mesh
(``tests/conftest.py``) and the port's
``engine/train_step.make_sharded_train_step`` on local shards
(``DataAxis.local``): the loss within 1e-5 and the updated aggregator
within 1e-4 (fp32), sgd with lr 0.05 and no momentum (an update linear in
the gradient), dropout 0, one split point. The port's sharded step must
also equal its own single-program step, which a double count of the
cross-shard classifier gradients would break.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ovmr_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from ovmr_tpu.engine.train_step import make_sharded_train_step as j_sharded
from ovmr_tpu.models import clip as jclip
from ovmr_tpu.parallel import build_mesh as j_build_mesh
from ovmr_tpu.parallel import shard_batch as j_shard_batch
from ovmr_tpu.utils.defaults import get_cfg_default
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves
from ovmr_tpu_torch.engine.train_step import (
    make_sharded_train_step,
    make_train_step,
    shard_seed,
    slice_draws,
)
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr as tovmr
from ovmr_tpu_torch.models.aggregator import init_aggregator
from ovmr_tpu_torch.ops.augment import sample_augment_draws
from ovmr_tpu_torch.ops.block_fused_tp import make_gspmd_block, make_tp_block, split_clip_qkv
from ovmr_tpu_torch.parallel import DataAxis, Mesh, ModelAxis, place_packed_mlp
from ovmr_tpu_torch.parallel.mesh import place_tower_params

NUM_CLS, N_INS, SPLIT = 8, 4, 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the TINY tensors gain nothing from more,
    and under the suite's parallel workers the spinning thread pools of
    each worker slow every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _optim_cfg():
    ocfg = get_cfg_default().OPTIM
    ocfg.NAME, ocfg.MOMENTUM, ocfg.LR = "sgd", 0.0, 0.05
    return ocfg


def _inputs(cfg):
    """Seeded towers and aggregator of the port's config ``cfg`` (its
    initialisers, in the JAX layout as numpy), images and prompt tokens."""
    jp = jax.tree_util.tree_map(lambda t: t.numpy(), tclip.init_params(cfg, seed=0))
    ja = convert.aggregator_params_to_numpy(
        init_aggregator(width=cfg.embed_dim, layers=2, n_ctx=2, seed=0))
    rng = np.random.RandomState(1)
    images = rng.randn(NUM_CLS, N_INS, 3, 32, 32).astype(np.float32)
    ptok, eot, vtok = tovmr.build_prompt_tokens([f"class {i}" for i in range(NUM_CLS)])
    return jp, ja, images, ptok, eot, vtok


@pytest.fixture(scope="module")
def tiny():
    return _inputs(tclip.TINY)


def _port_agg(ja):
    agg = convert.aggregator_params_from_numpy(_np(ja))
    for leaf in param_leaves(agg):
        leaf.requires_grad_(True)
    return agg


def _port_step(step, ja, tp_params, images, ptok, eot, vtok, seed=None, draws=None):
    agg = _port_agg(ja)
    opt = build_optimizer(_optim_cfg(), agg)
    args = (agg, opt, tp_params, torch.tensor(images), torch.tensor(ptok), torch.tensor(eot),
            torch.tensor(vtok), seed, SPLIT)
    loss = step(*args) if draws is None else step(*args, augment_draws=draws)
    return float(loss), convert.aggregator_params_to_numpy(agg)


def _assert_agg_close(got, want, atol):
    np.testing.assert_allclose(got["cls_token"], want["cls_token"], atol=atol, rtol=0)
    for k, v in got["blocks"].items():
        np.testing.assert_allclose(v, want["blocks"][k], atol=atol, rtol=0, err_msg=k)


def _jax_step(jp, ja, images, ptok, eot, vtok, data, model=1, cfg=jclip.TINY):
    optimizer = j_build_optimizer(_optim_cfg())
    mesh = j_build_mesh(data, model, jax.devices()[: data * model])
    kwargs = {}
    if model > 1:
        from ovmr_tpu.ops.block_fused_tp import make_tp_block as j_tp_block
        from ovmr_tpu.ops.block_fused_tp import split_clip_qkv as j_split
        from ovmr_tpu.parallel import clip_pspecs, place_tower_params as j_place

        jp = j_place(mesh, j_split(jp, model, cfg))
        kwargs = dict(block_fn=j_tp_block(model), clip_specs=clip_pspecs(jp, model))
    step = j_sharded(cfg, optimizer, mesh, dropout=0.0, **kwargs)
    new, _, loss = step(
        ja, optimizer.init(ja), jp, j_shard_batch(mesh, jnp.asarray(images)),
        j_shard_batch(mesh, jnp.asarray(ptok)), j_shard_batch(mesh, jnp.asarray(eot)),
        jnp.asarray(vtok), jax.random.PRNGKey(7), SPLIT,
    )
    return float(loss), _np(new)


@pytest.mark.parametrize("shards", [2, 4])
def test_local_shards_match_jax_and_the_single_program_step(tiny, shards):
    jp, ja, images, ptok, eot, vtok = tiny
    tp = convert.clip_params_from_numpy(_np(jp))
    mesh = Mesh(DataAxis.local(shards), ModelAxis.local(1))
    loss, agg = _port_step(make_sharded_train_step(tclip.TINY, mesh, dropout=0.0), ja, tp,
                           images, ptok, eot, vtok)
    j_loss, j_agg = _jax_step(jp, ja, images, ptok, eot, vtok, shards)
    np.testing.assert_allclose(loss, j_loss, atol=1e-5, rtol=0)
    _assert_agg_close(agg, j_agg, 1e-4)

    s_loss, s_agg = _port_step(make_train_step(tclip.TINY, dropout=0.0), ja, tp, images, ptok,
                               eot, vtok)
    np.testing.assert_allclose(loss, s_loss, atol=1e-5, rtol=0)
    _assert_agg_close(agg, s_agg, 1e-4)
    moved = np.abs(agg["cls_token"] - _np(ja)["cls_token"]).max()
    assert moved > 1e-4


def test_data_by_model_step_matches_jax():
    """Data 2 x model 2 at TINY_TP: the TP block (K7/K8's plain twins) on
    split towers placed for two local model shards, against JAX's step with
    ``clip_specs``, and against the port's single-program step."""
    jp, ja, images, ptok, eot, vtok = _inputs(tclip.TINY_TP)
    tp = convert.clip_params_from_numpy(_np(jp))
    model = ModelAxis.local(2)
    placed = place_tower_params(model, split_clip_qkv(tp, 2, tclip.TINY_TP))
    mesh = Mesh(DataAxis.local(2), model)
    step = make_sharded_train_step(tclip.TINY_TP, mesh, dropout=0.0,
                                   block_fn=make_tp_block(model))
    loss, agg = _port_step(step, ja, placed, images, ptok, eot, vtok)
    j_loss, j_agg = _jax_step(jp, ja, images, ptok, eot, vtok, 2, 2, jclip.TINY_TP)
    np.testing.assert_allclose(loss, j_loss, atol=1e-5, rtol=0)
    _assert_agg_close(agg, j_agg, 1e-4)
    s_loss, s_agg = _port_step(make_train_step(tclip.TINY_TP, dropout=0.0), ja, tp, images,
                               ptok, eot, vtok)
    np.testing.assert_allclose(loss, s_loss, atol=1e-5, rtol=0)
    _assert_agg_close(agg, s_agg, 1e-4)


def test_gspmd_route_step_matches_the_single_program_step(tiny):
    """The GSPMD route (packed towers, the MLP split over 'model', torch
    math, rematerialised in the text tower) at data 2 x model 2 trains as
    the single-program step does."""
    jp, ja, images, ptok, eot, vtok = tiny
    tp = convert.clip_params_from_numpy(_np(jp))
    model = ModelAxis.local(2)
    mesh = Mesh(DataAxis.local(2), model)
    step = make_sharded_train_step(tclip.TINY, mesh, dropout=0.0,
                                   block_fn=make_gspmd_block(model))
    loss, agg = _port_step(step, ja, place_packed_mlp(model, tp), images, ptok, eot, vtok)
    s_loss, s_agg = _port_step(make_train_step(tclip.TINY, dropout=0.0), ja, tp, images, ptok,
                               eot, vtok)
    np.testing.assert_allclose(loss, s_loss, atol=1e-5, rtol=0)
    _assert_agg_close(agg, s_agg, 1e-4)


def test_augmenting_step_with_injected_draws(tiny):
    """The augment branch: the single program's draws, cut per shard
    (``slice_draws``), give the sharded step the same pixels, so both steps
    agree; with a seed each shard draws from its own stream."""
    jp, ja, _, ptok, eot, vtok = tiny
    tp = convert.clip_params_from_numpy(_np(jp))
    u8 = np.random.RandomState(5).randint(0, 256, (NUM_CLS, N_INS, 40, 40, 3)).astype(np.uint8)
    augment = dict(out_size=32, scale=(0.5, 1.0), jitter=(0.4, 0.4, 0.4, 0.1), gn_std=0.15,
                   mean=(0.48, 0.45, 0.4), std=(0.27, 0.26, 0.28), out_dtype=torch.float32)
    draws = sample_augment_draws(torch.Generator().manual_seed(3), NUM_CLS * N_INS, 40,
                                 **{k: augment[k] for k in ("out_size", "scale", "jitter",
                                                            "gn_std")})
    mesh = Mesh(DataAxis.local(2), ModelAxis.local(1))
    step = make_sharded_train_step(tclip.TINY, mesh, dropout=0.0, augment=augment)
    loss, agg = _port_step(step, ja, tp, u8, ptok, eot, vtok, draws=slice_draws(draws, 2))
    single = make_train_step(tclip.TINY, dropout=0.0, augment=augment)
    s_loss, s_agg = _port_step(single, ja, tp, u8, ptok, eot, vtok, draws=draws)
    np.testing.assert_allclose(loss, s_loss, atol=1e-5, rtol=0)
    _assert_agg_close(agg, s_agg, 1e-4)
    # drawn per shard from the step's seed: finite, and distinct streams
    seeded, _ = _port_step(step, ja, tp, u8, ptok, eot, vtok, seed=11)
    assert np.isfinite(seeded) and shard_seed(11, 0) != shard_seed(11, 1)
