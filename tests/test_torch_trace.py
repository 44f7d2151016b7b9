"""The port's span recorder (``ovmr_tpu_torch.utils.trace``) on the CPU: off
it records nothing and calls nothing of torch; on (``trace.enable()`` or a
recording ``torch.profiler``) its spans nest with their request id, their
self time is their time less their children's, their starts line up with
the profiler's annotations, a request and a training step record every span
of their paths, outputs do not depend on it, and the functions that the
benchmark's outside spans wrap are still where their metrics look. The card
case (stream times) is marked ``cuda``."""

import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.api import OVMRGenerator
from ovmr_tpu_torch.engine.optimizers import param_leaves
from ovmr_tpu_torch.engine.train_step import make_train_step
from ovmr_tpu_torch.models import clip as tclip
from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.models.aggregator import init_aggregator
from ovmr_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["red circle", "green square", "blue triangle", "café crème", "ski_mask"]
SERVING = {"generate", "encode", "prompt", "prompt.clean", "prompt.bpe", "tokens", "heads",
           "text_tower", "generator", "fusion", "fusion.count", "result"}
STEP = {"step", "augment", "frozen", "heads", "text_tower", "generator", "backward", "optimizer"}
AUGMENT = dict(out_size=32, scale=(0.25, 1.0), jitter=(0.4, 0.4, 0.4, 0.1), gn_std=0.15,
               mean=(0.48145466, 0.4578275, 0.40821073),
               std=(0.26862954, 0.26130258, 0.27577711), out_dtype=torch.float32)


@pytest.fixture(autouse=True)
def _clean_recorder():
    """One intra-op thread, an empty recorder and tracing off around each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def generator():
    return OVMRGenerator(tclip.init_params(tclip.TINY, seed=0), tclip.TINY,
                         init_aggregator(width=tclip.TINY.embed_dim, n_ctx=2, seed=0),
                         dtype=torch.float32, device="cpu")


def _exemplars(n=5, k=4):
    return torch.rand((n, k, 3, 32, 32), generator=torch.Generator().manual_seed(3))


def _tree(summary, root="generate"):
    """The spans of the last tree whose root is ``root``."""
    tree = [t for t in summary["requests"] if t["spans"][0]["name"] == root][-1]
    return tree["spans"]


def _refuse(*args, **kwargs):
    raise AssertionError("a span made a torch call while tracing was off")


@pytest.mark.parametrize("kind", [{}, {"wait": True}, {"host_only": True}],
                         ids=["plain", "wait", "host_only"])
def test_off_a_span_records_nothing_and_calls_nothing_of_torch(kind, monkeypatch):
    for owner, attr in ((torch.cuda, "Event"), (torch.cuda, "is_initialized"),
                        (torch.cuda, "current_device"), (trace, "_range")):
        monkeypatch.setattr(owner, attr, _refuse)
    first, second = trace.span("a", **kind), trace.span("b", **kind)
    assert first is second  # the shared no-op: nothing allocated a span
    with first:
        with trace.span("c", **kind):
            pass
    summary = trace.summary()
    assert summary["spans"] == {} and summary["roots"] == 0 and summary["requests"] == []


def test_the_recorder_follows_the_profiler_flag_of_this_torch():
    """The flag the recorder reads is the one a profiler sets while it
    records: a span opened under a profiler records, one opened after it
    stopped does not."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        with trace.span("under"):
            pass
    with trace.span("after"):
        pass
    assert set(trace.summary()["spans"]) == {"under"}


def _nest():
    with trace.span("root"):
        with trace.span("a"):
            time.sleep(0.002)
            with trace.span("b"):
                time.sleep(0.001)
        with trace.span("c", wait=True):
            time.sleep(0.001)
    with trace.span("root"):
        pass


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_spans_nest_with_parent_request_and_self_time(how):
    if how == "enable":
        trace.enable()
        _nest()
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _nest()
    s = trace.summary()
    assert s["roots"] == 2
    first, second = s["requests"][-2:]
    names = [(x["name"], x["parent"]) for x in first["spans"]]
    assert names == [("root", None), ("a", 0), ("b", 1), ("c", 0)]
    assert {x["request"] for x in first["spans"]} == {first["id"]}
    assert second["id"] != first["id"] and second["spans"][0]["request"] == second["id"]
    spans = s["spans"]
    for parent, children in (("root", ("a", "c")), ("a", ("b",))):
        want = spans[parent]["host_s"] - sum(spans[c]["host_s"] for c in children)
        assert spans[parent]["self_host_s"] == pytest.approx(want, abs=1e-9)
    assert spans["b"]["self_host_s"] == spans["b"]["host_s"]
    assert spans["c"]["wait"] and s["wait_host_s"] == pytest.approx(spans["c"]["host_s"])
    assert spans["root"]["stream_s"] is None  # the CPU records no events
    for x in first["spans"]:
        assert x["start_ns"] <= x["end_ns"]


def test_host_only_spans_add_to_their_parent_and_make_no_annotation():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            for _ in range(3):
                with trace.span("inner", host_only=True):
                    pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "span:ovmr.outer" in names and "span:ovmr.inner" not in names
    (outer,) = trace.summary()["requests"][-1]["spans"]
    assert outer["host_only"]["inner"]["calls"] == 3
    assert trace.summary()["spans"]["inner"]["calls"] == 3


def test_a_span_starts_where_its_annotation_starts():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("warm"):
            pass
        with trace.span("outer"):
            time.sleep(0.002)
            with trace.span("inner"):
                torch.ones(64).sum()
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith(trace.PREFIX)}
    recorded = {x["name"]: x["start_ns"] for t in trace.summary()["requests"]
                for x in t["spans"]}
    for name in ("outer", "inner"):
        assert abs(recorded[name] - starts[trace.PREFIX + name]) < 500_000, name


@pytest.mark.parametrize("entry,chunks", [("generate", 1), ("generate_from_features", 3)])
def test_a_request_records_every_serving_span(generator, entry, chunks):
    x = _exemplars()
    trace.enable()
    if entry == "generate":
        generator.generate(NAMES, x)
    else:
        feats = generator.encode_images(x.reshape(20, 3, 32, 32)).reshape(5, 4, -1)
        trace.reset()
        generator.generate_from_features(NAMES, feats, chunk_size=2)
    s = trace.summary()
    want = SERVING if entry == "generate" else (SERVING - {"generate", "encode"}) | {entry}
    assert set(s["spans"]) == want
    assert s["roots"] == 1
    assert s["spans"]["text_tower"]["calls"] == 3 * chunks
    assert s["spans"]["generator"]["calls"] == chunks
    assert s["spans"]["fusion.count"]["calls"] == 9
    assert s["spans"]["tokens"]["calls"] == 1 + 2 * chunks  # the template, then two a chunk
    assert all(s["spans"][k]["wait"] for k in ("tokens", "fusion.count", "result"))
    assert s["wait_host_s"] > 0
    # one name and the visual template: two stages each
    assert s["spans"]["prompt.clean"]["calls"] == len(NAMES) + 1
    tree = _tree(s, entry)
    index = {x["name"]: i for i, x in enumerate(tree)}
    parent = {x["name"]: tree[x["parent"]]["name"] for x in tree if x["parent"] is not None}
    assert parent["text_tower"] == "heads" and parent["generator"] == "heads"
    assert parent["fusion.count"] == "fusion" and parent["heads"] == entry
    assert set(tree[index["prompt"]]["host_only"]) == {"prompt.clean", "prompt.bpe"}


def _train_setup():
    agg = init_aggregator(width=tclip.TINY.embed_dim, n_ctx=2, seed=1)
    for leaf in param_leaves(agg):
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(param_leaves(agg), lr=1e-3)
    clip_params = tclip.init_params(tclip.TINY, seed=1)
    images = torch.randint(0, 256, (3, 4, 40, 40, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5))
    ptok, eot, vtok = ovmr.build_prompt_tokens(NAMES[:3])
    step = make_train_step(tclip.TINY, dropout=0.1, augment=AUGMENT)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return step(agg, optimizer, clip_params, images, torch.tensor(ptok), torch.tensor(eot),
                    torch.tensor(vtok), gen, 2)

    return run, agg


def test_a_training_step_records_its_phases():
    run, _ = _train_setup()
    trace.enable()
    run(7)
    s = trace.summary()
    assert STEP <= set(s["spans"]) and s["roots"] == 1
    tree = _tree(s, "step")
    parent = {(x["name"], tree[x["parent"]]["name"]) for x in tree if x["parent"] is not None}
    assert {("augment", "step"), ("frozen", "step"), ("heads", "step"), ("backward", "step"),
            ("optimizer", "step"), ("text_tower", "heads"), ("generator", "heads")} <= parent
    assert s["spans"]["text_tower"]["calls"] == 2
    assert s["spans"]["optimizer"]["calls"] == 2  # zero_grad, then the update


@pytest.mark.parametrize("path", ["serving", "training"])
def test_outputs_do_not_depend_on_tracing(generator, path):
    def once(on):
        torch.manual_seed(0)
        if path == "serving":
            trace.enable() if on else trace.disable()
            return generator.generate(NAMES, _exemplars())
        run, agg = _train_setup()
        trace.enable() if on else trace.disable()
        loss = run(11)
        return {"loss": loss.numpy(), **{f"leaf{i}": leaf.detach().numpy().copy()
                                         for i, leaf in enumerate(param_leaves(agg))}}

    off, on = once(False), once(True)
    assert trace.summary()["roots"] == 1
    assert set(off) == set(on)
    for key in off:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)


def test_the_recorder_stays_bounded(monkeypatch):
    monkeypatch.setattr(trace, "TREE_CAP", 4)
    monkeypatch.setattr(trace, "TREE_SPANS_CAP", 3)
    trace.reset()
    trace.enable()
    for _ in range(10):
        with trace.span("root"):
            for _ in range(5):
                with trace.span("child"):
                    pass
    s = trace.summary()
    assert s["roots"] == 10 and len(s["requests"]) == 4
    assert all(len(t["spans"]) == 3 for t in s["requests"])
    assert s["spans"]["child"]["calls"] == 50


def _span_targets():
    """(metric file, label, "module:attribute") of every ``SPANS`` entry of
    the benchmark's per-layer readers."""
    out = []
    for path in sorted((ROOT / "benchmark" / "metrics").glob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and [t.id for t in node.targets] == ["SPANS"]:
                out += [(path.name, k, v) for k, v in ast.literal_eval(node.value).items()]
    return out


@pytest.mark.parametrize("metric,label,target", _span_targets(),
                         ids=[f"{m}-{label}" for m, label, _ in _span_targets()])
def test_each_outside_span_still_finds_its_function(metric, label, target):
    import importlib

    module, attr = target.split(":")
    assert callable(getattr(importlib.import_module(module), attr)), (metric, label)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_on_the_card_spans_read_stream_time(card):
    """Stream times nest as host times do; the second root reuses the first
    one's resolved event pairs."""
    x = torch.randn(64, 2048, device="cuda")
    trace.enable()
    for _ in range(2):
        with trace.span("root"):
            with trace.span("a"):
                for _ in range(20):
                    x = x @ x.T @ x / 2048
            with trace.span("b", wait=True):
                x.sum().item()
    s = trace.summary()["spans"]
    assert s["root"]["calls"] == 2 and s["a"]["stream_s"] > 0 and s["b"]["stream_s"] >= 0
    want = s["root"]["stream_s"] - s["a"]["stream_s"] - s["b"]["stream_s"]
    assert s["root"]["self_stream_s"] == pytest.approx(want, abs=1e-6)
    assert s["root"]["stream_s"] >= s["a"]["stream_s"] + s["b"]["stream_s"] - 1e-6
    assert 3 <= sum(len(v) for v in trace._REC.spare.values()) < 6  # 6 without reuse
