"""The port's modeling ops and layers against the JAX package's.

Every public function of ``ovmr_tpu_torch/modeling/ops.py`` and every layer
of ``modeling/layers.py`` on the same inputs as its JAX counterpart (NHWC
there, NCHW here), fp32 at atol 1e-5 and gradients at 1e-4. The random ops
(``mixup``, ``mixstyle``, ``efdmix``) take the JAX function's own draws,
recomputed from its key and injected. The layers' flax states are carried
in with ``convert.dassl_state_from_numpy``. The data axis' BatchNorm (the
global statistics over local shards) is held against the single program,
forward, running statistics and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovmr_tpu.modeling import layers as jlayers
from ovmr_tpu.modeling import ops as JF
from ovmr_tpu_torch.convert import dassl_state_from_numpy, dassl_state_to_numpy
from ovmr_tpu_torch.modeling import layers
from ovmr_tpu_torch.modeling import ops as F
from ovmr_tpu_torch.parallel.mesh import DataAxis


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the tiny tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_reverse_grad_forward_and_backward():
    x = _rand(3, 4)
    w = _rand(3, 4, seed=1)
    _, vjp = jax.vjp(lambda v: JF.reverse_grad(v, 0.5), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(w))[0])
    xt = torch.tensor(x, requires_grad=True)
    out = F.reverse_grad(xt, 0.5)
    np.testing.assert_array_equal(out.detach().numpy(), x)
    out.backward(torch.as_tensor(w))
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError):
        F.reverse_grad(xt, -1.0)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_cross_entropy_and_its_gradient(smooth):
    logits, label = _rand(5, 7), np.random.default_rng(2).integers(0, 7, 5)
    for reduction in ("mean", "sum", "none"):
        want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label), smooth, reduction)
        got = F.cross_entropy(torch.as_tensor(logits), torch.as_tensor(label), smooth, reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    g_want = jax.grad(lambda v: JF.cross_entropy(v, jnp.asarray(label), smooth))(
        jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    F.cross_entropy(lt, torch.as_tensor(label), smooth).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_want), atol=1e-4)
    with pytest.raises(ValueError):
        F.cross_entropy(lt, torch.as_tensor(label), smooth, "nope")


def test_label_and_schedule_utilities():
    lab = np.array([1, 0, 2])
    np.testing.assert_array_equal(F.create_onehot(lab, 3).numpy(),
                                  np.asarray(JF.create_onehot(jnp.asarray(lab), 3)))
    p = np.abs(_rand(4, 3)) + 0.1
    p = p / p.sum(1, keepdims=True)
    np.testing.assert_allclose(F.sharpen_prob(torch.as_tensor(p), 2.0).numpy(),
                               np.asarray(JF.sharpen_prob(jnp.asarray(p), 2.0)), atol=1e-6)
    for cur in (0, 3, 10, 12):
        assert F.sigmoid_rampup(cur, 10) == JF.sigmoid_rampup(cur, 10)
        assert F.linear_rampup(cur, 10) == JF.linear_rampup(cur, 10)
    a, b = {"w": _rand(3), "v": {"u": _rand(2)}}, {"w": _rand(3, seed=4), "v": {"u": _rand(2, seed=5)}}
    want = _np(JF.ema_update(a, b, 0.9))
    got = F.ema_update(jax.tree_util.tree_map(torch.as_tensor, a),
                       jax.tree_util.tree_map(torch.as_tensor, b), 0.9)
    np.testing.assert_allclose(got["w"].numpy(), want["w"], atol=1e-6)
    np.testing.assert_allclose(got["v"]["u"].numpy(), want["v"]["u"], atol=1e-6)
    # on modules, in place
    m1, m2 = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    before = m1.weight.detach().clone()
    F.ema_update(m1, m2, 0.5)
    np.testing.assert_allclose(m1.weight.detach().numpy(),
                               (0.5 * before + 0.5 * m2.weight.detach()).numpy(), atol=1e-6)


def test_mixup_with_injected_coefficients():
    x1, x2 = _rand(4, 8, 8, 3), _rand(4, 8, 8, 3, seed=1)
    y1 = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    y2 = np.eye(2, dtype=np.float32)[[1, 1, 0, 0]]
    lam = np.array([0.9, 0.6, 0.7, 0.55], np.float32)
    xw, yw = JF.mixup(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(y1), jnp.asarray(y2), 1.0,
                      None, lam=jnp.asarray(lam))
    xg, yg = F.mixup(_nchw(x1), _nchw(x2), torch.as_tensor(y1), torch.as_tensor(y2), 1.0,
                     lam=lam)
    np.testing.assert_allclose(_nhwc(xg), np.asarray(xw), atol=1e-6)
    np.testing.assert_allclose(yg.numpy(), np.asarray(yw), atol=1e-6)
    # drawn from a generator: convex and order-preserving
    gen = torch.Generator().manual_seed(0)
    xm, ym = F.mixup(torch.zeros(4, 3, 2, 2), torch.ones(4, 3, 2, 2), torch.as_tensor(y1),
                     torch.as_tensor(y2), 1.0, gen, preserve_order=True)
    assert float(xm.max()) <= 0.5 + 1e-6
    np.testing.assert_allclose(ym.sum(1).numpy(), 1.0, rtol=1e-6)


def _jax_mix_draws(key, b, alpha, p, mix):
    """The draws of one JAX MixStyle/EFDMix call (``ops.py`` :157, :197)."""
    k_apply, k_lmda, k_perm = jax.random.split(key, 3)
    lmda = np.asarray(jax.random.beta(k_lmda, alpha, alpha, (b,)))
    perm = np.asarray(JF._mix_permutation(k_perm, b, mix))
    apply = bool(jax.random.bernoulli(k_apply, p))
    return lmda, perm, apply


@pytest.mark.parametrize("op,mix", [("mixstyle", "random"), ("mixstyle", "crossdomain"),
                                    ("efdmix", "random"), ("efdmix", "crossdomain")])
def test_feature_mixing_with_injected_draws(op, mix):
    x = _rand(4, 5, 5, 3) * 2.0 + 1.0
    w = _rand(4, 5, 5, 3, seed=3)
    key = jax.random.PRNGKey(11)
    lmda, perm, apply = _jax_mix_draws(key, 4, 0.1, 1.0, mix)
    assert apply
    jfn = getattr(JF, op)
    want, vjp = jax.vjp(lambda v: jfn(v, key, p=1.0, alpha=0.1, mix=mix), jnp.asarray(x))
    g_want = np.asarray(vjp(jnp.asarray(w))[0])
    xt = _nchw(x).requires_grad_(True)
    got = getattr(F, op)(xt, p=1.0, alpha=0.1, mix=mix, lmda=lmda, perm=perm, apply=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    got.backward(_nchw(w))
    np.testing.assert_allclose(_nhwc(xt.grad), g_want, atol=1e-4)
    # the identity paths, and a generator's draws
    for kw in (dict(train=False), dict(p=0.0), dict(apply=False)):
        assert getattr(F, op)(xt, **kw) is xt
    gen = torch.Generator().manual_seed(3)
    out = getattr(F, op)(xt.detach(), gen, p=1.0, mix=mix)
    assert out.shape == xt.shape and torch.isfinite(out).all()


def test_crossdomain_permutation_swaps_halves():
    perm = F.mix_permutation(torch.Generator().manual_seed(0), 8, "crossdomain").numpy()
    assert set(perm[:4]) == {4, 5, 6, 7} and set(perm[4:]) == {0, 1, 2, 3}
    with pytest.raises(NotImplementedError):
        F.mix_permutation(None, 4, "nope")


@pytest.mark.parametrize("kernel", ["linear", "poly", "rbf", "rbf_normalized"])
def test_mmd_and_its_gradient(kernel):
    x, y = _rand(6, 16), _rand(5, 16, seed=1) + 0.5
    kt, norm = kernel.split("_")[0], kernel.endswith("normalized")
    want, vjp = jax.vjp(lambda a: JF.mmd(a, jnp.asarray(y), kt, norm), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = F.mmd(xt, torch.as_tensor(y), kt, norm)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-5)
    got.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.float32(1.0))[0]),
                               atol=1e-4)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_optimal_transport_distances(metric):
    x, y = _rand(6, 8), _rand(6, 8, seed=1)
    want = JF.sinkhorn_divergence(jnp.asarray(x), jnp.asarray(y), dist_metric=metric)
    got = F.sinkhorn_divergence(torch.as_tensor(x), torch.as_tensor(y), dist_metric=metric)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-5)
    want = JF.minibatch_energy_distance(jnp.asarray(x), jnp.asarray(y), dist_metric=metric)
    got = F.minibatch_energy_distance(torch.as_tensor(x), torch.as_tensor(y), dist_metric=metric)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-5)
    # the gradient through the cost, the plan held fixed
    want_g = jax.grad(lambda a: JF.sinkhorn_divergence(a, jnp.asarray(y), dist_metric=metric))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    F.sinkhorn_divergence(xt, torch.as_tensor(y), dist_metric=metric).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), atol=1e-4, rtol=1e-3)


def test_dropout_draws_from_the_scope():
    x = torch.ones(64, 8)
    with F.rng_scope(torch.Generator().manual_seed(1)):
        a = F.dropout(x, 0.5)
    with F.rng_scope(torch.Generator().manual_seed(1)):
        b = F.dropout(x, 0.5)
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
    assert F.dropout(x, 0.5, train=False) is x


@pytest.mark.parametrize("draw", ["dropout", "rand_rows"])
def test_row_window_draws_the_rows_of_the_whole_batch(draw):
    """Within ``row_window`` a process's rows draw what one process draws
    for the whole batch at those rows (dropout's mask; ``rand_rows``, as
    drop-connect draws), a rank's equal block and an empty piece included."""
    def sample(rows):
        gen = torch.Generator().manual_seed(2)
        if draw == "dropout":
            return F.dropout(torch.ones(rows, 5), 0.5, generator=gen)
        return F.rand_rows((rows, 5, 1), gen)

    whole = sample(12)
    for window, n, lo in ((lambda m: (m, 3 * m), 4, 4), (lambda m: (6, 12), 3, 6),
                          (lambda m: (6, 12), 0, 6)):
        with F.row_window(window):
            assert torch.equal(sample(n), whole[lo:lo + n])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,momentum,eps", [((6, 3, 4, 4), 0.9, 1e-5), ((8, 5), 0.9, 1e-5),
                                                ((6, 3, 4, 4), 0.99, 1e-3)])
def test_torch_batchnorm_running_statistics(shape, momentum, eps):
    nhwc_shape = (shape[0],) + shape[2:] + (shape[1],) if len(shape) == 4 else shape
    x1, x2 = _rand(*nhwc_shape) * 3 + 1, _rand(*nhwc_shape, seed=1) * 2 - 1
    jbn = jlayers.TorchBatchNorm(use_running_average=False, momentum=momentum, epsilon=eps)
    vs = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x1))
    vs = {"params": {"scale": jnp.linspace(0.5, 1.5, shape[1]), "bias": jnp.linspace(-1, 1, shape[1])},
          "batch_stats": vs["batch_stats"]}
    bn = layers.TorchBatchNorm(shape[1], momentum=1 - momentum, eps=eps)
    dassl_state_from_numpy(bn, _np(vs))
    to_t = _nchw if len(shape) == 4 else torch.as_tensor
    from_t = _nhwc if len(shape) == 4 else (lambda t: t.detach().numpy())
    bn.train()
    for x in (x1, x2):
        y, upd = jbn.apply(vs, jnp.asarray(x), mutable=["batch_stats"])
        vs = {"params": vs["params"], "batch_stats": upd["batch_stats"]}
        np.testing.assert_allclose(from_t(bn(to_t(x))), np.asarray(y), atol=1e-5)
    got = dassl_state_to_numpy(bn)["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], np.asarray(vs["batch_stats"][k]), atol=1e-5)
    bn.eval()
    jeval = jlayers.TorchBatchNorm(use_running_average=True, momentum=momentum, epsilon=eps)
    np.testing.assert_allclose(from_t(bn(to_t(x1))), np.asarray(jeval.apply(vs, jnp.asarray(x1))),
                               atol=1e-5)


@pytest.mark.parametrize("rows,shards", [(8, 2), (12, 4), (6, 3)])
def test_global_batchnorm_over_local_shards_equals_one_program(rows, shards):
    """The data axis' BatchNorm: forward, running statistics and gradients
    of the local shards' global statistics equal the single program's."""
    torch.manual_seed(0)
    x = torch.randn(rows, 4, 3, 3) * 2 + 0.5
    w = torch.randn(rows, 4, 3, 3)
    outs, grads, stats = [], [], []
    for axis in (None, DataAxis.local(shards)):
        bn = layers.TorchBatchNorm(4)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
        bn.train()
        xt = x.clone().requires_grad_(True)
        with layers.data_axis_scope(axis) if axis else torch.enable_grad():
            y = bn(xt)
            (y * w).sum().backward()
        outs.append(y.detach())
        grads.append((xt.grad, bn.weight.grad, bn.bias.grad))
        stats.append((bn.running_mean.clone(), bn.running_var.clone()))
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for a, b in zip(stats[1], stats[0]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_attention_and_dynamic_conv():
    x = _rand(2, 8, 8, 32)
    key = jax.random.PRNGKey(0)
    jatt = jlayers.Attention(32, 4)
    vs = jatt.init(key, jnp.asarray(x))
    att = layers.Attention(32, 4)
    dassl_state_from_numpy(att, {"params": _np(vs["params"]), "batch_stats": {}})
    np.testing.assert_allclose(att(_nchw(x)).detach().numpy(),
                               np.asarray(jatt.apply(vs, jnp.asarray(x))), atol=1e-5)
    jconv = jlayers.Conv2dDynamic(32, 16, 3, stride=2)
    vs = jconv.init(key, jnp.asarray(x))
    conv = layers.Conv2dDynamic(32, 16, 3, stride=2)
    dassl_state_from_numpy(conv, {"params": _np(vs["params"]), "batch_stats": {}})
    want, vjp = jax.vjp(lambda v: jconv.apply(vs, v), jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    got = conv(xt)
    assert got.shape == (2, 16, 4, 4)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    w = _rand(*want.shape, seed=5)
    got.backward(_nchw(w))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(vjp(jnp.asarray(w))[0]), atol=1e-4)
    with pytest.raises(ValueError):
        layers.Conv2dDynamic(32, 16, 2, stride=1)


def test_dsbn_and_transnorm():
    key = jax.random.PRNGKey(0)
    x = _rand(8, 4, 4, 6)
    jd = jlayers.DSBN(6, n_domain=2)
    vs = jd.init({"params": key}, jnp.asarray(x), domain_idx=0, train=True)
    d = layers.DSBN(6, n_domain=2)
    dassl_state_from_numpy(d, _np(vs))
    d.train()
    y, upd = jd.apply(vs, jnp.asarray(x) + 1.0, domain_idx=1, train=True,
                      mutable=["batch_stats"])
    np.testing.assert_allclose(_nhwc(d(_nchw(x) + 1.0, domain_idx=1)), np.asarray(y), atol=1e-5)
    got = dassl_state_to_numpy(d)["batch_stats"]
    for dom in ("bn_0", "bn_1"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[dom][k], np.asarray(upd["batch_stats"][dom][k]),
                                       atol=1e-5)

    jt = jlayers.TransNorm(6)
    vs = jt.init({"params": key}, jnp.asarray(x), train=True)
    t = layers.TransNorm(6)
    dassl_state_from_numpy(t, _np(vs))
    x2 = x.copy()
    x2[4:] += 3.0
    t.train()
    want, upd = jt.apply(vs, jnp.asarray(x2), train=True, mutable=["batch_stats"])
    xt = _nchw(x2).requires_grad_(True)
    got = t(xt)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    stats = dassl_state_to_numpy(t)["batch_stats"]
    for k, v in upd["batch_stats"].items():
        np.testing.assert_allclose(stats[k], np.asarray(v), atol=1e-5, err_msg=k)
    g_want = jax.grad(lambda v: (jt.apply(vs, v, train=True, mutable=["batch_stats"])[0]
                                 * jnp.asarray(x)).sum())(jnp.asarray(x2))
    (got * _nchw(x)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(g_want), atol=1e-4)
    t.eval()
    vs_after = {"params": vs["params"], "batch_stats": upd["batch_stats"]}
    np.testing.assert_allclose(_nhwc(t(_nchw(x))),
                               np.asarray(jt.apply(vs_after, jnp.asarray(x), train=False)),
                               atol=1e-5)
