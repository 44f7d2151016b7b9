"""The port's backbone, head and network zoo against the JAX package's.

- The registries hold the JAX package's names.
- Each small backbone of JAX's ``SMALL_FORWARD`` (``tests/test_modeling_zoo.py``),
  plus ``vgg16``, ``alexnet`` and ``efficientnet_b0`` at the smallest input
  their pooling takes, runs on one state in both packages (the port's init
  through ``convert.dassl_state_to_numpy`` and back through
  ``dassl_state_from_numpy``): eval mode at batch 2, and train mode
  (output and BN running statistics) where the forward draws nothing. The
  backbones that draw (dropout, drop-connect, MixStyle/EFDMix) are held in
  eval mode and run finite in train mode. The NHWC flatten of PreActResNet,
  VGG16, AlexNet and the digit CNNs is in these forwards.
- The heavy backbones' parameter counts equal the JAX modules' (by
  ``jax.eval_shape``, without running either).
- ``mlp``, the FCN/STN generators and ``affine_grid_sample`` with samples
  outside the image.

The JAX forwards run jitted: op by op, the JAX CPU forwards of the larger
nets take tens of seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmr_tpu.modeling import BACKBONE_REGISTRY as J_BACKBONES
from ovmr_tpu.modeling import HEAD_REGISTRY as J_HEADS
from ovmr_tpu.modeling import NETWORK_REGISTRY as J_NETWORKS
from ovmr_tpu.modeling import build_backbone as j_build_backbone
from ovmr_tpu.modeling import build_head as j_build_head
from ovmr_tpu.modeling import build_network as j_build_network
from ovmr_tpu_torch.convert import dassl_state_from_numpy, dassl_state_to_numpy
from ovmr_tpu_torch.modeling import (
    BACKBONE_REGISTRY,
    HEAD_REGISTRY,
    NETWORK_REGISTRY,
    build_backbone,
    build_head,
    build_network,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the tiny tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _state(variables):
    v = jax.tree_util.tree_map(np.asarray, dict(variables))
    return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_registries_hold_the_jax_names():
    assert list(BACKBONE_REGISTRY.registered_names()) == list(J_BACKBONES.registered_names())
    assert list(HEAD_REGISTRY.registered_names()) == list(J_HEADS.registered_names())
    assert list(NETWORK_REGISTRY.registered_names()) == list(J_NETWORKS.registered_names())


# (name, feature width, input side, draws in train mode)
SMALL_FORWARD = [
    ("resnet18", 512, 32, False),
    ("wide_resnet_28_2", 128, 32, False),
    ("wide_resnet_16_4", 256, 32, False),
    ("preact_resnet18", 512, 32, False),
    ("cnn_digit5_m3sda", 2048, 32, True),
    ("cnn_digitsdg", 256, 32, False),
    ("cnn_digitsingle", 1024, 32, False),
    ("resnet18_ms_l123", 512, 32, True),
    ("resnet18_efdmix_l1", 512, 32, True),
    ("resnet18_dynamic", 512, 32, False),
    ("vgg16", 4096, 32, True),
    ("alexnet", 4096, 64, True),
    ("efficientnet_b0", 1280, 32, True),
]


@pytest.mark.parametrize("name,fdim,side,draws", SMALL_FORWARD)
def test_backbone_forward_matches_jax(name, fdim, side, draws, capsys):
    x = np.random.default_rng(0).standard_normal((2, side, side, 3)).astype(np.float32)
    jnet = j_build_backbone(name, pretrained=False)
    net = build_backbone(name, pretrained=True)
    assert "pretrained weights are asset-gated" in capsys.readouterr().out
    assert net.out_features == jnet.out_features == fdim
    # the port's init carried to the JAX module (dassl_state_to_numpy), and
    # back through dassl_state_from_numpy
    variables = dassl_state_to_numpy(net)
    dassl_state_from_numpy(net, variables)
    net.eval()
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    want = np.asarray(jax.jit(lambda v, xx: jnet.apply(v, xx, train=False))(variables, x))
    assert got.shape == (2, fdim)
    np.testing.assert_allclose(got, want, atol=2e-5 * max(1.0, np.abs(want).max()), rtol=1e-4)

    net.train()
    if draws:
        with torch.no_grad():
            out = net(_nchw(x))
        assert out.shape == (2, fdim) and torch.isfinite(out).all()
        return
    # train mode at batch 4: BatchNorm over 2 rows of a 1x1 map is too
    # ill-conditioned to compare two frameworks' roundings
    x4 = np.random.default_rng(1).standard_normal((4, side, side, 3)).astype(np.float32)
    want, upd = jax.jit(lambda v, xx: jnet.apply(v, xx, train=True, mutable=["batch_stats"]))(
        variables, x4)
    with torch.no_grad():
        got = net(_nchw(x4)).numpy()
    scale = max(1.0, np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4 * scale, rtol=1e-3)
    stats, jstats = _flat(dassl_state_to_numpy(net)["batch_stats"]), _flat(
        jax.tree_util.tree_map(np.asarray, dict(upd.get("batch_stats", {}))))
    assert stats.keys() == jstats.keys()
    for k in stats:
        np.testing.assert_allclose(stats[k], jstats[k], atol=1e-4, rtol=1e-3, err_msg=k)


HEAVY = ["resnet34", "resnet50", "resnet101", "resnet152", "resnet50_ms_l12",
         "resnet101_efdmix_l123", "resnet50_dynamic", "resnet101_dynamic_ms_l1",
         "efficientnet_b3", "efficientnet_b7"]


@pytest.mark.parametrize("name", HEAVY)
def test_heavy_backbone_parameter_counts(name):
    jnet = j_build_backbone(name, pretrained=False)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda xx: jnet.init({"params": jax.random.PRNGKey(0)}, xx), x)
    j_params = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    j_stats = sum(int(np.prod(s.shape))
                  for s in jax.tree_util.tree_leaves(shapes.get("batch_stats", {})))
    net = build_backbone(name, pretrained=False)
    assert sum(p.numel() for p in net.parameters()) == j_params
    assert sum(b.numel() for b in net.buffers()) == j_stats
    assert net.out_features == jnet.out_features


def test_mlp_head_matches_jax():
    key = jax.random.PRNGKey(0)
    f = np.random.default_rng(0).standard_normal((6, 64)).astype(np.float32)
    jh = j_build_head("mlp", in_features=64, hidden_layers=[32, 16], activation="leaky_relu",
                      bn=True)
    variables = jh.init({"params": key}, jnp.asarray(f), train=False)
    h = build_head("mlp", in_features=64, hidden_layers=[32, 16], activation="leaky_relu",
                   bn=True, pretrained=False)
    assert h.out_features == 16
    dassl_state_from_numpy(h, _state(variables))
    want, upd = jh.apply(variables, jnp.asarray(f), train=True, mutable=["batch_stats"])
    h.train()
    np.testing.assert_allclose(h(torch.as_tensor(f)).detach().numpy(), np.asarray(want),
                               atol=1e-5)
    stats = _flat(dassl_state_to_numpy(h)["batch_stats"])
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, dict(upd["batch_stats"]))).items():
        np.testing.assert_allclose(stats[k], v, atol=1e-5, err_msg=k)
    assert build_head("mlp", in_features=8, hidden_layers=4, activation="relu",
                      bn=False).out_features == 4
    with pytest.raises(NotImplementedError):
        build_head("mlp", in_features=8, hidden_layers=4, activation="gelu")


@pytest.mark.parametrize("name", ["fcn_3x32_gctx", "fcn_3x32_gctx_stn"])
def test_generator_networks_match_jax(name):
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    jg = j_build_network(name, image_size=32)
    variables = jg.init({"params": key}, jnp.asarray(x), train=False)
    if "locnet" in variables["params"]:
        # a warp that moves samples (the identity init would not test it)
        variables = jax.tree_util.tree_map(lambda a: a, dict(variables))
        loc = dict(variables["params"]["locnet"])
        loc["fc_loc"] = {"kernel": jnp.asarray(np.random.default_rng(1).standard_normal(
            loc["fc_loc"]["kernel"].shape).astype(np.float32) * 0.01),
            "bias": jnp.asarray([0.9, 0.2, -0.1, 1.1])}
        variables["params"] = {**variables["params"], "locnet": loc}
    g = build_network(name, image_size=32)
    dassl_state_from_numpy(g, _state(variables))
    (want, p_want), _ = jax.jit(lambda v, xx: jg.apply(
        v, xx, lmda=0.3, return_p=True, train=True, mutable=["batch_stats"]))(variables, x)
    g.train()
    xt = _nchw(x).requires_grad_(True)
    got, p = g(xt, lmda=0.3, return_p=True)
    # the STN's bilinear warp moves an ulp of theta into the samples
    np.testing.assert_allclose(np.transpose(got.detach().numpy(), (0, 2, 3, 1)),
                               np.asarray(want), atol=1e-5 if "stn" not in name else 5e-5)
    assert float(p.detach().abs().max()) <= 1.0
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    g_want = jax.jit(jax.grad(lambda v: (jg.apply(variables, v, lmda=0.3, train=True,
                                                  mutable=["batch_stats"])[0] * w).sum()))(x)
    (got * _nchw(w)).sum().backward()
    # through the warp the input gradient sums many pixels' terms: JAX's own
    # jitted and op-by-op gradients differ by 8e-4 of its scale there
    g_want = np.asarray(g_want)
    atol = 1e-4 if "stn" not in name else 2e-3 * np.abs(g_want).max()
    np.testing.assert_allclose(np.transpose(xt.grad.numpy(), (0, 2, 3, 1)), g_want, atol=atol)


def test_affine_grid_sample_matches_jax_outside_the_image():
    from ovmr_tpu.modeling.networks import affine_grid_sample as j_sample
    from ovmr_tpu_torch.modeling.networks import affine_grid_sample

    x = np.random.default_rng(0).standard_normal((3, 7, 9, 2)).astype(np.float32)
    theta = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],        # identity
                      [[1.3, 0.2, 0.4], [-0.1, 0.8, -0.5]],     # samples off the edges
                      [[0.5, -0.7, 0.9], [0.6, 1.2, 0.3]]], np.float32)
    want = np.asarray(j_sample(jnp.asarray(x), jnp.asarray(theta)))
    got = affine_grid_sample(_nchw(x), torch.as_tensor(theta))
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), want, atol=1e-5)
    np.testing.assert_allclose(want[0], x[0], atol=1e-5)
    assert (want[1] == 0).any()  # zero padding outside the image
