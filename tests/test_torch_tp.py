"""The port's tensor-parallel block against the JAX package's.

``ovmr_tpu_torch.ops.block_fused_tp`` against ``ovmr_tpu.ops.block_fused_tp``
on the same numpy inputs, at the shapes of ``tests/test_block_fused_tp.py``
(x [4, 17, 64], 2 heads, model axis 2):

- the plain twins of K7 and K8 against the Pallas partial kernels in
  interpret mode, masked and unmasked (fp32 atol 1e-5, bf16 1e-2);
- the layout helpers and the converter against JAX's, exactly, a
  head-padded tower included;
- the torch-math partials of the TP block's backward against JAX's XLA
  partials: forward 1e-5, dx 1e-4;
- the TP block on local shards (m = 1 and 2, and head-padded m = 2 and 4)
  against JAX ``make_tp_block`` under ``shard_map`` on the virtual CPU mesh
  and against the single-device block: forward 1e-5, dx and weight
  gradients 1e-4.

On the CPU every wrapper takes its plain version; the CUDA kernels run in
``tests/test_torch_cuda.py`` on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ovmr_tpu.models import clip as jclip
from ovmr_tpu.ops import block_fused_tp as jtp
from ovmr_tpu.ops.layers import causal_mask as j_causal_mask
from ovmr_tpu.ops.layers import residual_attention_block as j_block
from ovmr_tpu.parallel import build_mesh, clip_pspecs
from ovmr_tpu_torch import convert
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.ops import block_fused_tp as ttp
from ovmr_tpu_torch.ops import cuda_lib
from ovmr_tpu_torch.ops.layers import causal_mask, residual_attention_block
from ovmr_tpu_torch.parallel import ModelAxis, place_tower_params, shard_block

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
L, D = 17, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures: the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def layer_np():
    """One TINY vision block (D=64) from the JAX package's init_params, as
    numpy, with non-trivial biases and LayerNorm parameters."""
    params = jclip.init_params(jax.random.PRNGKey(0), jclip.TINY)
    p = {k: np.asarray(v[0]) for k, v in params["visual"]["blocks"].items()}
    rng = np.random.RandomState(0)
    for k in ("b_qkv", "b_out", "c_fc_b", "c_proj_b", "ln_1_bias", "ln_2_bias"):
        p[k] = (0.05 * rng.randn(*p[k].shape)).astype(np.float32)
    for k in ("ln_1_scale", "ln_2_scale"):
        p[k] = (1 + 0.1 * rng.randn(*p[k].shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def x_np():
    return np.random.RandomState(1).randn(4, L, D).astype(np.float32)


def _j_split(layer_np, m, n_head):
    return jtp.pad_head_shards(jtp.split_qkv_blocks(layer_np), D // n_head, m)


def _t_split(layer_np, m, n_head):
    p = {k: torch.tensor(v) for k, v in layer_np.items()}
    return ttp.pad_head_shards(ttp.split_qkv_blocks(p), D // n_head, m)


# --------------------------------------------------------------------------
# K7 and K8: plain twins against the Pallas kernels
# --------------------------------------------------------------------------

K7_KEYS = ("w_q", "b_q", "w_k", "b_k", "w_v", "b_v", "w_out", "ln_1_scale", "ln_1_bias")
K8_KEYS = ("c_fc_w", "c_fc_b", "c_proj_w", "ln_2_scale", "ln_2_bias")


def _shard_np(split_np, m, j):
    """Shard j of m of a split layer, numpy, sliced by TP_BLOCK_AXES."""
    out = {}
    for k, v in split_np.items():
        dim = jtp.TP_BLOCK_AXES[k]
        out[k] = v if dim is None else np.split(np.asarray(v), m, axis=dim)[j]
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("m,shard", [(1, 0), (2, 0), (2, 1)])
def test_partial_plain_twins_match_pallas(layer_np, x_np, dtype, masked, m, shard):
    jdt, tdt, tol = DTYPES[dtype]
    s = _shard_np(_j_split(layer_np, m, 2), m, shard)
    nh = 2 // m
    mask = np.asarray(j_causal_mask(L)) if masked else None
    ref7 = jtp.tp_attn_half_partial(
        jnp.asarray(x_np, jdt), *(jnp.asarray(s[k], jdt) for k in K7_KEYS),
        mask=None if mask is None else jnp.asarray(mask), n_head=nh, interpret=True,
    )
    ref8 = jtp.tp_mlp_half_partial(
        jnp.asarray(x_np, jdt), *(jnp.asarray(s[k], jdt) for k in K8_KEYS), interpret=True
    )
    xt = torch.tensor(x_np).to(tdt)
    cuda_lib.reset_launches()
    got7 = ttp.tp_attn_half_partial(
        xt, *(torch.tensor(s[k]).to(tdt) for k in K7_KEYS),
        mask=None if mask is None else torch.tensor(mask), n_head=nh,
    )
    got8 = ttp.tp_mlp_half_partial(xt, *(torch.tensor(s[k]).to(tdt) for k in K8_KEYS))
    assert not any(cuda_lib.LAUNCHES.values())  # the CPU runs the plain twins
    for got, ref in ((got7, ref7), (got8, ref8)):
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=0)


def test_padded_shard_partial_is_exactly_zero(layer_np, x_np):
    """TINY's one head padded to two at m=2: the second shard holds only
    the zero head, and K7's plain twin gives exact zeros, masked or not."""
    s = _shard_np(_j_split(layer_np, 2, 1), 2, 1)
    assert not np.asarray(s["w_q"]).any() and not np.asarray(s["w_out"]).any()
    for mask in (None, causal_mask(L)):
        got = ttp.tp_attn_half_partial(
            torch.tensor(x_np), *(torch.tensor(np.asarray(s[k])) for k in K7_KEYS),
            mask=mask, n_head=1,
        )
        assert torch.equal(got, torch.zeros_like(got))


# --------------------------------------------------------------------------
# layout, placement and conversion
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m,n_head", [(1, 2), (2, 2), (2, 1), (4, 2), (4, 1)])
def test_split_and_pad_match_jax_exactly(layer_np, m, n_head):
    ref = _np_tree(_j_split(layer_np, m, n_head))
    got = _t_split(layer_np, m, n_head)
    assert set(got) == set(ref) == set(ttp.TP_KEYS)
    for k, v in ref.items():
        assert got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_tp_block_axes_match_jax():
    assert ttp.TP_BLOCK_AXES == jtp.TP_BLOCK_AXES
    assert set(ttp.TP_KEYS) == set(jtp.TP_BLOCK_AXES)


@pytest.mark.parametrize("cfg_name,m", [("TINY", 2), ("TINY_TP", 2), ("TINY_TP", 4)])
def test_split_clip_qkv_and_convert_match_jax(cfg_name, m):
    """The numpy of JAX's ``split_clip_qkv(params, m, cfg)`` converts as it
    is and equals the port's ``split_clip_qkv`` of the converted packed
    towers bit for bit (TINY at m=2: the one vision head padded to two;
    TINY_TP at m=4: the two text heads padded to four)."""
    jcfg, tcfg = getattr(jclip, cfg_name), getattr(tclip, cfg_name)
    jp = jclip.init_params(jax.random.PRNGKey(0), jcfg)
    ref = convert.clip_params_from_numpy(_np_tree(jtp.split_clip_qkv(jp, m, jcfg)))
    got = ttp.split_clip_qkv(convert.clip_params_from_numpy(_np_tree(jp)), m, tcfg)
    for tower in ("visual", "text"):
        blocks = got[tower]["blocks"]
        assert set(blocks) == set(ttp.TP_KEYS)
        for k, v in ref[tower]["blocks"].items():
            assert torch.equal(blocks[k], v), (tower, k)
        heads = tcfg.vision_heads if tower == "visual" else tcfg.transformer_heads
        width = tcfg.vision_width if tower == "visual" else tcfg.transformer_width
        assert blocks["w_q"].shape[-1] == width // heads * (heads + (-heads) % m)
    # unpadded split layouts convert too
    unpadded = convert.clip_params_from_numpy(_np_tree(jtp.split_clip_qkv(jp)))
    assert unpadded["visual"]["blocks"]["w_q"].shape[-1] == jcfg.vision_width


@pytest.mark.parametrize("m,shards", [(2, (0, 1)), (4, (0, 1, 2, 3)), (4, (2, 3)), (2, (1,))])
def test_placement_follows_jax_partition_specs(m, shards):
    """Each placed leaf holds exactly the slices JAX's ``clip_pspecs``
    shards over 'model' (stacked as [L, m_local, ...]); the rest is whole."""
    jp = jclip.init_params(jax.random.PRNGKey(0), jclip.TINY_TP)
    split = jtp.split_clip_qkv(jp, m, jclip.TINY_TP)
    specs = clip_pspecs(split, m)
    placed = place_tower_params(
        ModelAxis(m, shards),
        convert.clip_params_from_numpy(_np_tree(split)),
    )
    for tower in ("visual", "text"):
        for k, leaf in _np_tree(split)[tower]["blocks"].items():
            spec = tuple(specs[tower]["blocks"][k])
            got = placed[tower]["blocks"][k].numpy()
            if "model" not in spec:
                np.testing.assert_array_equal(got, leaf)
                continue
            parts = np.split(leaf, m, axis=spec.index("model"))
            assert got.shape == (leaf.shape[0], len(shards)) + parts[0].shape[1:]
            for i, j in enumerate(shards):
                np.testing.assert_array_equal(got[:, i], parts[j], err_msg=(tower, k, j))
    assert placed["visual"]["patch_embed_w"] is not None
    with pytest.raises(ValueError, match="split"):
        place_tower_params(ModelAxis.local(2), convert.clip_params_from_numpy(_np_tree(jp)))


def test_shard_refuses_a_width_that_does_not_split():
    p = {k: torch.tensor(v) for k, v in jtp.split_qkv_blocks(
        {k: np.asarray(v[0]) for k, v in jclip.init_params(
            jax.random.PRNGKey(0), jclip.TINY)["visual"]["blocks"].items()}).items()}
    with pytest.raises(ValueError, match="pad the heads"):
        shard_block({"w_q": p["w_q"][:, :8]}, ModelAxis.local(3), stacked=False)


def test_model_axis_reduce_and_shards():
    axis = ModelAxis.local(3)
    assert axis.shards == (0, 1, 2) and axis.group is None
    parts = [torch.full((2,), float(j)) for j in range(3)]
    assert torch.equal(axis.reduce(iter(parts)), torch.full((2,), 3.0))
    with pytest.raises(ValueError):
        ModelAxis(2, (2,))


# --------------------------------------------------------------------------
# backward's torch-math partials against JAX's XLA partials
# --------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("m,n_head,shard", [(1, 2, 0), (2, 2, 1), (2, 1, 0), (2, 1, 1)])
def test_torch_math_partials_match_jax_xla(layer_np, x_np, masked, m, n_head, shard):
    """The partials the TP block's backward recomputes, against JAX's
    ``_attn_partial_xla``/``_mlp_partial_xla`` on the same shard (a padded
    shard of zero heads included), and their dx against JAX's VJP."""
    s = _shard_np(_np_tree(_j_split(layer_np, m, n_head)), m, shard)
    nh = s["w_q"].shape[-1] // (D // n_head)
    jmask = j_causal_mask(L) if masked else None
    tmask = causal_mask(L) if masked else None
    js = {k: jnp.asarray(v) for k, v in s.items()}
    ts = {k: torch.tensor(v) for k, v in s.items()}
    x = torch.tensor(x_np, requires_grad=True)
    cot = np.random.RandomState(5).randn(*x_np.shape).astype(np.float32)
    for jfn, tfn in ((lambda x_: jtp._attn_partial_xla(x_, js, nh, jmask),
                      lambda x_: ttp._attn_partial_torch(x_, ts, nh, tmask)),
                     (lambda x_: jtp._mlp_partial_xla(x_, js),
                      lambda x_: ttp._mlp_partial_torch(x_, ts))):
        ref, vjp = jax.vjp(jfn, jnp.asarray(x_np))
        got = tfn(x)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        (dx,) = torch.autograd.grad(got, x, torch.tensor(cot))
        np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                                   atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# the TP block
# --------------------------------------------------------------------------


def _j_leaf_specs(split_layer):
    out = {}
    for name, leaf in split_layer.items():
        axis = jtp.TP_BLOCK_AXES[name]
        spec = [None] * leaf.ndim
        if axis is not None:
            spec[axis] = "model"
        out[name] = P(*spec)
    return out


def _j_tp(x, split, m, n_head, mask, interpret, cot=None):
    """JAX's TP block under shard_map over a (1, m) mesh, as ``_run_tp`` of
    tests/test_block_fused_tp.py builds it; with ``cot`` its dx."""
    mesh = build_mesh(data=1, model=m)
    block = jtp.make_tp_block(m, interpret=interpret)
    if cot is None:
        fn = lambda x_, p_: block(x_, p_, n_head, mask)  # noqa: E731
    else:
        fn = jax.grad(lambda x_, p_: jnp.vdot(block(x_, p_, n_head, mask), cot))
    return np.asarray(jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(P(), _j_leaf_specs(split)), out_specs=P(), check_vma=False,
    ))(x, split))


# (m, n_head): one shard (a one-rank process group), m=2 unpadded, and
# head-padded 1 -> 2 and 2 -> 4
CASES = [(1, 2), (2, 2), (2, 1), (4, 2)]


@pytest.mark.parametrize("m,n_head", CASES)
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
def test_tp_block_matches_jax_and_single_device(layer_np, x_np, m, n_head, masked):
    """Forward at 1e-5 against JAX's TP block on the virtual mesh (the
    Pallas partials in interpret mode) and against the single-device block
    of both packages; dx at 1e-4 against JAX's TP custom VJP."""
    jmask = j_causal_mask(L) if masked else None
    tmask = causal_mask(L) if masked else None
    jsplit = _j_split(layer_np, m, n_head)
    axis = ModelAxis.local(m)
    tsplit = shard_block(_t_split(layer_np, m, n_head), axis, stacked=False)
    block = ttp.make_tp_block(axis)
    x = torch.tensor(x_np, requires_grad=True)
    got = block(x, tsplit, n_head, tmask)
    for ref in (_j_tp(jnp.asarray(x_np), jsplit, m, n_head, jmask, interpret=True),
                np.asarray(j_block(jnp.asarray(x_np), layer_np, n_head, jmask)),
                residual_attention_block(torch.tensor(x_np),
                                         {k: torch.tensor(v) for k, v in layer_np.items()},
                                         n_head, tmask).numpy()):
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=0)
    cot = np.random.RandomState(3).randn(*x_np.shape).astype(np.float32)
    (got * torch.tensor(cot)).sum().backward()
    ref_dx = _j_tp(jnp.asarray(x_np), jsplit, m, n_head, jmask, interpret=False,
                   cot=jnp.asarray(cot))
    np.testing.assert_allclose(x.grad.numpy(), ref_dx, atol=1e-4, rtol=0)


@pytest.mark.parametrize("m,n_head", CASES)
def test_tp_block_weight_gradients_match_the_single_device_block(layer_np, x_np, m, n_head):
    """Every weight gradient of the TP block (split leaves per shard,
    LayerNorm leaves summed over the shards, the two output biases) equals
    JAX's single-device block's, carried to the split layout, within 1e-4;
    a padded head's cotangents are exact zeros."""
    mask_j, mask_t = j_causal_mask(L), causal_mask(L)
    cot = np.random.RandomState(4).randn(*x_np.shape).astype(np.float32)
    ref = jax.grad(lambda p_: jnp.vdot(j_block(jnp.asarray(x_np), p_, n_head, mask_j),
                                       jnp.asarray(cot)))(dict(layer_np))
    ref = _shard_all(_np_tree(jtp.pad_head_shards(jtp.split_qkv_blocks(ref), D // n_head, m)), m)
    axis = ModelAxis.local(m)
    leaves = {k: v.requires_grad_(True) for k, v in
              shard_block(_t_split(layer_np, m, n_head), axis, stacked=False).items()}
    out = ttp.make_tp_block(axis)(torch.tensor(x_np), leaves, n_head, mask_t)
    (out * torch.tensor(cot)).sum().backward()
    for k, v in leaves.items():
        scale = max(float(np.abs(ref[k]).max()), 1.0)
        np.testing.assert_allclose(v.grad.numpy(), ref[k], atol=1e-4 * scale, rtol=0, err_msg=k)
    if n_head % m:  # head-padded: the last shard holds only zero heads
        assert not leaves["w_q"].grad[-1].any() and not leaves["w_out"].grad[-1].any()


def _shard_all(split_np, m):
    """Stack the m shards of each split leaf as [m, ...] (whole leaves pass)."""
    out = {}
    for k, v in split_np.items():
        dim = jtp.TP_BLOCK_AXES[k]
        out[k] = v if dim is None else np.stack(np.split(v, m, axis=dim))
    return out


def test_tp_block_refuses_bad_heads_and_unplaced_shards(layer_np, x_np):
    axis = ModelAxis.local(2)
    block = ttp.make_tp_block(axis)
    x = torch.tensor(x_np)
    placed = shard_block(_t_split(layer_np, 2, 2), axis, stacked=False)
    with pytest.raises(ValueError, match="not divisible"):
        block(x, placed, 3)
    with pytest.raises(ValueError, match="place the towers"):
        block(x, _t_split(layer_np, 2, 2), 2)  # not placed: w_q is [D, D]
    with pytest.raises(ValueError, match="split/pad"):
        block(x, shard_block(_t_split(layer_np, 1, 1), axis, stacked=False), 1)


def test_tower_runs_the_tp_block(x_np):
    """A whole TINY_TP text tower through ``run_blocks`` with the TP block
    on placed towers equals the packed tower (the blocks' layer count comes
    from a leaf every layout has)."""
    tp = convert.clip_params_from_numpy(
        _np_tree(jclip.init_params(jax.random.PRNGKey(2), jclip.TINY_TP)))
    axis = ModelAxis.local(2)
    placed = place_tower_params(axis, ttp.split_clip_qkv(tp, 2, tclip.TINY_TP))
    tokens = torch.tensor(np.random.RandomState(0).randint(1, 400, size=(3, 77)))
    ref = tclip.encode_text(tp, tclip.TINY_TP, tokens)
    got = tclip.encode_text(placed, tclip.TINY_TP, tokens, block_fn=ttp.make_tp_block(axis))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
