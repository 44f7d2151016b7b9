"""int8 serving in the port (``ovmr_tpu_torch/ops/quant.py``) against the JAX
package's (``ovmr_tpu/ops/quant.py``) on the CPU.

- ``quantize_weight`` / ``quantize_params``: int8 weights and fp32 scales
  bit for bit the JAX package's;
- ``dense_int8``: the int8 activations and the output bit for bit
  compiled JAX's (the int32 sums are exact; the scale and the
  dequantization are XLA's fp32 operations); ``int_mm``'s padding (rows to
  a multiple of 32, depth and width to multiples of 8) exact against an
  int64 product;
- TINY towers, int8 against JAX's int8 within 1e-5, and int8 against float
  at cosine > 0.995 (``tests/test_quant.py``'s floor); each int8 block
  replayed in JAX from the port's input, its products forced to the
  port's: the quantizers' inputs within 1e-3 of a step, the output equal;
- ``cast_params`` keeps the four dequantization scales fp32 and casts
  LayerNorm's ``*_scale``;
- every block function on an int8 block gives ``dense_int8``'s numbers
  (the torch-math block, ``fused_residual_block`` on the CPU,
  ``residual_block_remat``) or raises (``dense``, the raw K1/K2/K5 and
  K7/K8 wrappers, the TP block);
- ``TPU.INT8`` in a yaml or in the options is read onto ``CUDA.INT8``;
- ``tests/test_quant.py::test_int8_trainer_eval_only``'s scenario against
  the JAX trainer: the same towers (one TINY state dict through
  ``OVMR_CLIP_CKPT``) and aggregator, the training params float, the
  serving params JAX's int8 tree bit for bit; the text classifier within
  1e-4, the mm and vision classifiers within 1e-2 (row cosines 0.999),
  on the same features within half of int8's own distance from float, and
  the exemplar features within 2e-3: the per-row quantizer's rounding
  flips, which the test's docstring measures;
  ``CUDA.INT8`` with a model axis raises and names item 4.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmr_tpu.models import clip as jclip
from ovmr_tpu.ops import quant as jquant
from ovmr_tpu_torch.convert import clip_params_from_numpy
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.ops import quant
from ovmr_tpu_torch.ops.block_fused import (
    fused_attn_half,
    fused_mlp_half,
    fused_mlp_half_chunked,
    fused_residual_block,
)
from ovmr_tpu_torch.ops.layers import (
    dense,
    l2_normalize,
    residual_attention_block,
    residual_block_remat,
)
from ovmr_tpu_torch.utils import get_cfg_default

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TRAJ = osp.join(ROOT, "tests", "fixtures", "trajectory_coop_golden.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """TINY towers as numpy leaves in the JAX layout (the port's seeded
    init), their JAX and port int8 copies."""
    params = jax.tree_util.tree_map(lambda t: t.numpy(), tclip.init_params(tclip.TINY, seed=4))
    return params, jquant.quantize_params(params), quant.quantize_params(
        clip_params_from_numpy(params))


def test_quantize_weight_and_params_bit_equal_jax(tiny):
    w = np.random.default_rng(0).standard_normal((64, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes scale 1
    q, s = quant.quantize_weight(w)
    jq, js = jquant.quantize_weight(w)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s[3] == 1.0
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    _, jparams, tparams = tiny
    for tower in ("visual", "text"):
        got, want = tparams[tower]["blocks"], jparams[tower]["blocks"]
        assert set(got) == set(want)
        for key in quant.QUANT_KEYS:
            assert got[key].dtype == torch.int8 and got[key + "_scale"].dtype == torch.float32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
            np.testing.assert_array_equal(got[key + "_scale"].numpy(),
                                          np.asarray(want[key + "_scale"]))


@pytest.mark.parametrize("rows", [5, 16, 17, 40])
def test_dense_int8_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 64)).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes scale 1
    w = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    q, s = quant.quantize_weight(w)
    got = quant.dense_int8(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                           torch.from_numpy(b)).numpy()
    # compiled, as the JAX towers run it inside their scan
    want = np.asarray(jax.jit(jquant.dense_int8)(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                                 jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    # the int8 activations are compiled JAX's: round-half-even of x / (max|x|
    # * fl32(1/127)), XLA turning the division by the constant 127 into a
    # product with its float32 reciprocal and keeping the division by the
    # row's scale
    xq, x_scale = quant.quantize_rows(torch.from_numpy(x))
    ref_scale = np.abs(x).max(axis=1, keepdims=True) * (np.float32(1.0) / np.float32(127.0))
    ref_scale = np.where(ref_scale == 0, np.float32(1.0), ref_scale)
    np.testing.assert_array_equal(x_scale.numpy(), ref_scale)
    np.testing.assert_array_equal(
        xq.numpy(), np.clip(np.round(x / ref_scale), -127, 127).astype(np.int8))
    with pytest.raises(TypeError, match="int8"):
        quant.dense_int8(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))


@pytest.mark.parametrize("m,k,n", [(3, 64, 48), (16, 60, 20), (17, 8, 8), (33, 100, 7),
                                   (20, 64, 192)])
def test_int_mm_pads_exactly(m, k, n):
    """Padded to what the card's integer GEMM takes (rows to a multiple of
    32, depth and width to multiples of 8), the int32 result is the exact
    product."""
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = quant.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_int8_towers_match_jax_and_stay_close_to_float(tiny):
    """Port int8 vs JAX int8 within 1e-5 (the same int8 operands; fp32
    sums in another order); int8 vs float at cosine > 0.995."""
    params, jparams, tparams = tiny
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    tokens = rng.integers(1, 400, (4, 77))
    tokens[:, 0], tokens[:, 6] = 510, 511
    for encode, jencode, x in ((tclip.encode_image, jclip.encode_image, images),
                               (tclip.encode_text, jclip.encode_text, tokens)):
        got = encode(tparams, tclip.TINY, torch.from_numpy(x))
        want = np.asarray(jencode(jparams, jclip.TINY, jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        flt = encode(clip_params_from_numpy(params), tclip.TINY, torch.from_numpy(x))
        cos = (l2_normalize(got) * l2_normalize(flt)).sum(-1).numpy()
        assert (cos > 0.995).all(), cos


@pytest.mark.parametrize("tower", ["visual", "text"])
def test_int8_blocks_replay_against_jax(tiny, tower, monkeypatch):
    """Where the int8 towers of the two packages part, it is by the
    quantizer's rounding, shown block by block: each ``dense_int8`` call of
    the port's tower (64 images or prompts) equals compiled JAX's on the
    same input bit for bit, and each block replayed in JAX from the port's
    block input, its products forced to the port's, gives each quantizer an
    fp32 input within 1e-3 of a step of the port's and the port's output
    exactly. So an activation that rounds otherwise in the two packages
    lies on a .5 boundary of the per-row quantizer."""
    from ovmr_tpu.ops.layers import residual_attention_block as j_block
    from ovmr_tpu_torch.ops import block_fused

    _, _, tparams = tiny
    rng = np.random.default_rng(3)
    calls, blocks = [], []
    dense_int8, int8_block = quant.dense_int8, block_fused.residual_attention_block

    def recording(x, w_q, w_scale, b=None):
        y = dense_int8(x, w_q, w_scale, b)
        calls.append((x, w_q, w_scale, b, y))
        return y

    def recording_block(x, p, n_head, mask=None):
        lo = len(calls)
        y = int8_block(x, p, n_head, mask)
        blocks.append((x, p, n_head, mask, y, lo, len(calls)))
        return y

    monkeypatch.setattr(quant, "dense_int8", recording)
    monkeypatch.setattr(block_fused, "residual_attention_block", recording_block)
    if tower == "visual":
        x = rng.standard_normal((64, 3, 32, 32)).astype(np.float32)
        tclip.encode_image(tparams, tclip.TINY, torch.from_numpy(x))
    else:
        x = rng.integers(1, 400, (64, 77))
        x[:, 0], x[:, 9] = 510, 511
        tclip.encode_text(tparams, tclip.TINY, torch.from_numpy(x))
    monkeypatch.undo()
    assert len(blocks) == 2 and len(calls) == 8

    compiled = jax.jit(jquant.dense_int8)
    for x, w_q, w_scale, b, y in calls:
        want = compiled(*(jnp.asarray(t.numpy()) for t in (x, w_q, w_scale, b)))
        np.testing.assert_array_equal(y.numpy(), np.asarray(want))

    worst = 0.0
    for x, p, n_head, mask, y, lo, hi in blocks:
        forced = iter(calls[lo:hi])

        def replay(xs, w_q, w_scale, b=None):
            nonlocal worst
            x_port, _, _, _, y_port = next(forced)
            rows = torch.from_numpy(np.array(xs, np.float32)).reshape(-1, xs.shape[-1])
            u_jax = rows / quant.quantize_rows(rows)[1]
            rows = x_port.reshape(rows.shape)
            u_port = rows / quant.quantize_rows(rows)[1]
            worst = max(worst, float((u_jax - u_port).abs().max()))
            return jnp.asarray(y_port.numpy())

        monkeypatch.setattr(jquant, "dense_int8", replay)
        got = j_block(jnp.asarray(x.numpy()), {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                      n_head, None if mask is None else jnp.asarray(mask.numpy()))
        monkeypatch.undo()
        np.testing.assert_array_equal(np.asarray(got), y.numpy())
    assert worst <= 1e-3, worst


def test_cast_params_keeps_the_dequantization_scales_fp32(tiny):
    _, _, tparams = tiny
    cast = tclip.cast_params(tparams, torch.bfloat16)
    blocks = cast["visual"]["blocks"]
    for key in quant.QUANT_KEYS:
        assert blocks[key].dtype == torch.int8
        assert blocks[key + "_scale"].dtype == torch.float32
        assert torch.equal(blocks[key + "_scale"], tparams["visual"]["blocks"][key + "_scale"])
    assert blocks["ln_1_scale"].dtype == torch.bfloat16  # LayerNorm's scale is cast
    assert cast["logit_scale"].dtype == torch.float32


def _layer(blocks, i=0):
    return {k: v[i] for k, v in blocks.items()}


def test_every_block_function_takes_or_refuses_an_int8_block(tiny):
    """An int8 weight that reached ``dense`` would be read as unscaled
    integers: every block function either runs ``dense_int8`` (JAX's
    ``residual_attention_block`` on the same int8 layer within 1e-5) or
    raises."""
    from ovmr_tpu.ops.layers import residual_attention_block as j_block

    _, jparams, tparams = tiny
    p = _layer(tparams["visual"]["blocks"])
    jp = {k: jnp.asarray(v[0]) for k, v in jparams["visual"]["blocks"].items()}
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(j_block(jnp.asarray(x), jp, 1))
    xt = torch.from_numpy(x)
    for fn in (residual_attention_block, fused_residual_block, residual_block_remat):
        np.testing.assert_allclose(fn(xt, p, 1).numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=fn.__name__)
    # the route: no kernel wrapper is called for an int8 block
    with pytest.raises(TypeError, match="int8"):
        dense(xt, p["w_qkv"], p["b_qkv"])
    with pytest.raises(TypeError, match="int8"):
        fused_attn_half(xt, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], p["ln_1_scale"],
                        p["ln_1_bias"], n_head=1)
    for fn in (fused_mlp_half, fused_mlp_half_chunked):
        with pytest.raises(TypeError, match="int8"):
            fn(xt, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"], p["ln_2_scale"],
               p["ln_2_bias"])


def test_the_tp_block_refuses_int8(tiny):
    """The split-qkv TP block and K7/K8 take float towers only: int8 on a
    model axis takes the GSPMD route (JAX's GSPMD XLA block), the packed
    towers' MLP split over the axis. That block on two local shards equals
    the unsharded int8 block bit for bit (each row quantized with its scale
    over the whole row, exact int32 sums) and JAX's within 1e-5."""
    from ovmr_tpu.ops.layers import residual_attention_block as j_block
    from ovmr_tpu_torch.ops.block_fused_tp import (
        make_gspmd_block,
        make_tp_block,
        split_clip_qkv,
        tp_attn_half_partial,
        tp_mlp_half_partial,
    )
    from ovmr_tpu_torch.parallel.mesh import ModelAxis, place_packed_mlp

    _, jparams, tparams = tiny
    shard = _layer(split_clip_qkv(tparams, 2, tclip.TINY)["text"]["blocks"])
    assert shard["w_q"].dtype == torch.int8
    x = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="GSPMD route"):
        make_tp_block(ModelAxis(2, (0, 1)))(x, shard, 2)
    axis = ModelAxis.local(2)
    placed = _layer(place_packed_mlp(axis, tparams)["visual"]["blocks"])
    assert placed["c_fc_w"].shape[0] == 2 and placed["c_fc_w_scale"].shape[0] == 2
    xs = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 5, 64)).astype(np.float32))
    got = make_gspmd_block(axis)(xs, placed, 1)
    assert torch.equal(got, residual_attention_block(xs, _layer(tparams["visual"]["blocks"]), 1))
    jp = {k: jnp.asarray(v[0]) for k, v in jparams["visual"]["blocks"].items()}
    np.testing.assert_allclose(got.numpy(), np.asarray(j_block(jnp.asarray(xs.numpy()), jp, 1)),
                               atol=1e-5, rtol=0)
    with pytest.raises(TypeError, match="int8"):
        tp_attn_half_partial(x, shard["w_q"], shard["b_q"], shard["w_k"], shard["b_k"],
                             shard["w_v"], shard["b_v"], shard["w_out"], shard["ln_1_scale"],
                             shard["ln_1_bias"], n_head=2)
    with pytest.raises(TypeError, match="int8"):
        tp_mlp_half_partial(x, shard["c_fc_w"], shard["c_fc_b"], shard["c_proj_w"],
                            shard["ln_2_scale"], shard["ln_2_bias"])


def test_tpu_int8_is_read_onto_cuda_int8(tmp_path):
    cfg = get_cfg_default()
    assert cfg.CUDA.INT8 is False
    cfg.merge_from_list(["TPU.INT8", "True"])
    assert cfg.CUDA.INT8 is True and "TPU" not in cfg
    path = tmp_path / "int8.yaml"
    path.write_text("TPU:\n  INT8: True\n")
    cfg = get_cfg_default()
    cfg.merge_from_file(str(path))
    assert cfg.CUDA.INT8 is True


# ---------------------------------------------------------------------------
# the trainer's int8 eval, against the JAX trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_pt(tmp_path_factory):
    """The trajectory golden's TINY towers (64 px, width 128) as a reference
    state dict, for both packages."""
    data = np.load(TRAJ)
    path = tmp_path_factory.mktemp("clip") / "tiny_clip.pt"
    torch.save({k[len("clip."):]: torch.from_numpy(np.asarray(data[k]))
                for k in data.files if k.startswith("clip.")}, path)
    return str(path)


def _int8_cfg(tmp_path, make, tag):
    cfg = make()
    cfg.OUTPUT_DIR, cfg.SEED = str(tmp_path / tag), 1
    cfg.DATASET.ROOT, cfg.DATASET.NAME, cfg.DATASET.NUM_SHOTS = str(tmp_path / "data"), \
        "Synthetic", 4
    cfg.INPUT.SIZE, cfg.INPUT.TRANSFORMS = (64, 64), ["normalize"]
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomClassSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TRAIN_X.N_INS = 16, 4
    cfg.DATALOADER.TEST.BATCH_SIZE, cfg.DATALOADER.NUM_WORKERS = 16, 2
    cfg.MODEL.BACKBONE.NAME = "TINY_64"  # resolved through OVMR_CLIP_CKPT
    cfg.OPTIM.MAX_EPOCH, cfg.TRAINER.NAME, cfg.TRAINER.COCOOP.N_CTX = 1, "MM_CLS_OP", 2
    cfg.TEST.NO_TEST, cfg.EVAL_MODE = True, "fusion"
    if "CUDA" in cfg:
        cfg.CUDA.DTYPE, cfg.CUDA.DEVICE, cfg.CUDA.INT8 = "float32", "cpu", True
    else:
        cfg.TPU.DTYPE, cfg.TPU.INT8 = "float32", True
    return cfg


def _assert_rows_close(got, want, atol, cos_floor, what):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)
    assert ((got * want).sum(-1) >= cos_floor).all(), what


def test_int8_trainer_eval_matches_jax(clip_pt, tmp_path, monkeypatch):
    """The serving params are JAX's int8 tree bit for bit, and the float
    training params stay float. Through the int8 towers the two packages
    agree less closely than the float towers (which agree within 1e-6
    here): an activation whose fp32 value lies within an ulp of a rounding
    boundary of the per-row quantizer rounds to the neighbouring int8 step
    in one package and not in the other, and the change carries through
    the later layers (``test_int8_blocks_replay_against_jax`` shows it
    block by block). Measured on this scenario: exemplar features 7.6e-4
    apart, mm and vision classifiers 5.3e-3 and 2.7e-3 (row cosines above
    0.9998), the text classifier 6e-8. The bounds below are those
    magnitudes with room (1e-2, cosine 0.999); where the same features go
    into both generations, the int8 text towers must also stay within half
    of int8's own distance from the float tower. The fusion
    weights come from per-class F1 counts, which a flipped argmax can move
    by a whole exemplar, so they are held to their contract only (rows
    sum to 1)."""
    from ovmr_tpu.engine import register_all_trainers
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
    from ovmr_tpu.engine.trainer import collect_exemplar_features as j_collect
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch.convert import aggregator_params_from_numpy
    from ovmr_tpu_torch.engine import checkpoint as ckpt
    from ovmr_tpu_torch.engine.trainer import build_trainer, collect_exemplar_features

    register_all_trainers()
    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,64")
    port = build_trainer(_int8_cfg(tmp_path, get_cfg_default, "port"))
    jtr = j_build_trainer(_int8_cfg(tmp_path, j_cfg, "jax"))
    assert port.clip_params["visual"]["blocks"]["w_qkv"].dtype == torch.float32
    serving = port.serving_params
    assert serving is port.serving_params  # built once
    for tower in ("visual", "text"):
        for key, leaf in serving[tower]["blocks"].items():
            want = np.asarray(jtr.serving_params[tower]["blocks"][key])
            assert leaf.numpy().dtype == want.dtype, key
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=key)
    ckpt.copy_into(port.agg_params, aggregator_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.agg_params)))

    # the trainers' own evals (exemplar features through the int8 towers)
    port.prepare_test()
    jtr.prepare_test()
    ours, theirs = port.classifiers, {k: np.asarray(v) for k, v in jtr.classifiers.items()}
    np.testing.assert_allclose(ours["text_classifier"], theirs["text_classifier"], atol=1e-4,
                               rtol=0)
    for key in ("mm_classifier", "vision_classifier"):
        _assert_rows_close(ours[key], theirs[key], 1e-2, 0.999, key)
    np.testing.assert_allclose(ours["fusion_weight"].sum(-1), 1.0, atol=1e-5)
    batch = next(iter(port.dm.test_loader))
    assert port.model_inference(batch).shape == (batch["img"].shape[0], port.n_cls)

    # the next epoch's exemplars through each package's int8 image tower
    n_cls, shots, dim = port.n_cls, port.cfg.DATASET.NUM_SHOTS, port.clip_cfg.embed_dim
    jfeats = j_collect(jtr.dm.eval_set_loader, jtr._features, jtr.serving_params, n_cls, shots,
                       dim)
    feats = collect_exemplar_features(port.dm.eval_set_loader, port._features, serving, n_cls,
                                      shots, dim)
    _assert_rows_close(feats, jfeats, 2e-3, 0.9999, "exemplar features")
    # and the same features into both generations: the int8 text tower alone
    import ovmr_tpu.engine.trainer as jmod
    import ovmr_tpu_torch.engine.trainer as tmod

    monkeypatch.setattr(jmod, "collect_exemplar_features", lambda *a, **k: jfeats)
    monkeypatch.setattr(tmod, "collect_exemplar_features", lambda *a, **k: jfeats)
    ours = port.generate_classifiers()
    theirs = {k: np.asarray(v) for k, v in jtr.generate_classifiers().items()}
    np.testing.assert_allclose(ours["text_classifier"], theirs["text_classifier"], atol=1e-4,
                               rtol=0)
    # the float text tower on the same features: int8's own distance, which
    # the two packages' int8 towers stay well inside (measured 0.35 and
    # 0.32 of it in max abs)
    monkeypatch.setattr(type(port), "serving_params", property(lambda self: self.clip_params))
    flt = port.generate_classifiers()
    for key in ("mm_classifier", "vision_classifier"):
        _assert_rows_close(ours[key], theirs[key], 1e-2, 0.9999, key)
        assert np.abs(ours[key] - theirs[key]).max() < 0.5 * np.abs(ours[key] - flt[key]).max()
        apart = 1 - (ours[key] * theirs[key]).sum(-1).min()
        assert apart < 0.5 * (1 - (ours[key] * flt[key]).sum(-1).min()), key


def test_int8_on_a_model_axis_raises(tmp_path, monkeypatch, clip_pt):
    """``CUDA.INT8`` on a model axis of 2 serves on the GSPMD route (it
    raised before the route was ported): the eval's classifiers equal the
    unsharded int8 trainer's bit for bit, and JAX's int8 trainer on its
    data 1 x model 2 mesh to the quantizer's rounding."""
    monkeypatch.setenv("OVMR_CLIP_CKPT", clip_pt)
    monkeypatch.setenv("OVMR_SYNTHETIC", "4,8,64")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # TINY tensors gain nothing from intra-op threads
    try:
        _int8_model_axis_against_jax(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _int8_model_axis_against_jax(tmp_path):
    from ovmr_tpu.engine import register_all_trainers
    from ovmr_tpu.engine.trainer import build_trainer as j_build_trainer
    from ovmr_tpu.utils.defaults import get_cfg_default as j_cfg
    from ovmr_tpu_torch.convert import aggregator_params_from_numpy
    from ovmr_tpu_torch.engine import checkpoint as ckpt
    from ovmr_tpu_torch.engine.trainer import build_trainer

    cfg = _int8_cfg(tmp_path, get_cfg_default, "tp")
    cfg.CUDA.MESH.MODEL = 2
    port = build_trainer(cfg)
    assert port._tp == "gspmd" and port.mesh.shape == {"data": 1, "model": 2}
    single = build_trainer(_int8_cfg(tmp_path, get_cfg_default, "single"))
    register_all_trainers()
    jcfg = _int8_cfg(tmp_path, j_cfg, "jax_tp")
    jcfg.TPU.MESH.DATA, jcfg.TPU.MESH.MODEL = 1, 2
    jtr = j_build_trainer(jcfg)
    assert jtr._tp == "gspmd"
    agg = aggregator_params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.agg_params))
    for trainer in (port, single):
        ckpt.copy_into(trainer.agg_params, agg)
    ours, unsharded = port.generate_classifiers(), single.generate_classifiers()
    for key, value in ours.items():
        np.testing.assert_array_equal(value, unsharded[key], err_msg=key)
    theirs = {k: np.asarray(v) for k, v in jtr.generate_classifiers().items()}
    for key in ("mm_classifier", "vision_classifier"):
        _assert_rows_close(ours[key], theirs[key], 1e-2, 0.999, key)
