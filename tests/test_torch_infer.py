"""The port's plug-and-play consumer (``python -m ovmr_tpu_torch.infer``)
against the repo's ``infer.py`` (the JAX package) on the CPU.

The same images, the same TINY reference checkpoint (``--clip``) and the
same ``mm_classifiers.pt`` through both ``main`` functions at fp32: the
JSON lines name the same images and labels in the same order, with scores
within 1e-5, in every eval mode. The port's CLI runs as a subprocess with
``--device cpu``; its ``--device`` defaults to ``cuda``.
"""

import json
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ovmr_tpu_torch import infer as port_infer
from ovmr_tpu_torch.engine.checkpoint import export_classifiers_torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TRAJ = osp.join(ROOT, "tests", "fixtures", "trajectory_coop_golden.npz")
N_CLS = 6


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A TINY checkpoint, an exported artifact, class names and images."""
    from PIL import Image

    work = tmp_path_factory.mktemp("infer")
    data = np.load(TRAJ)
    torch.save({k[len("clip."):]: torch.from_numpy(np.asarray(data[k]))
                for k in data.files if k.startswith("clip.")}, work / "tiny_clip.pt")
    rng = np.random.default_rng(0)

    def unit(n):
        x = rng.standard_normal((n, 128)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    f1 = rng.uniform(size=(N_CLS, 3))
    weight = np.exp(10 * f1) / np.exp(10 * f1).sum(1, keepdims=True)
    export_classifiers_torch({"mm_classifier": unit(N_CLS), "vision_classifier": unit(N_CLS),
                              "text_classifier": unit(N_CLS), "fusion_weight": weight,
                              "visual_tokens": rng.standard_normal((N_CLS, 2, 128))},
                             str(work / "out"))
    images = work / "images"
    images.mkdir()
    for i, (h, w) in enumerate([(64, 64), (80, 120), (120, 70), (64, 100), (90, 90)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(images / f"{i:03d}.png")
    (work / "classnames.txt").write_text("\n".join(f"class {i}" for i in range(N_CLS)) + "\n")
    return work


def _argv(work, mode):
    return [str(work / "images"), str(work / "images" / "002.png"), "--classifiers",
            str(work / "out" / "mm_classifiers.pt"), "--clip", str(work / "tiny_clip.pt"),
            "--classnames", str(work / "classnames.txt"), "--mode", mode, "--size", "64",
            "--topk", "3"]


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _jax_main(argv, monkeypatch, capsys):
    """The repo's ``infer.main`` with its towers at fp32."""
    import argparse

    import infer as jinfer
    from ovmr_tpu import api as japi

    orig = japi.OVMRGenerator.from_checkpoints.__func__
    monkeypatch.setattr(japi.OVMRGenerator, "from_checkpoints", classmethod(
        lambda cls, *a, **k: orig(cls, *a, **{**k, "dtype": jnp.float32})))
    parser = argparse.ArgumentParser()
    parser.add_argument("inputs", nargs="+")
    for flag, default in (("--classifiers", None), ("--clip", None), ("--classnames", ""),
                          ("--mode", "fusion")):
        parser.add_argument(flag, default=default)
    parser.add_argument("--size", type=int)
    parser.add_argument("--topk", type=int)
    capsys.readouterr()
    jinfer.main(parser.parse_args(argv))
    return _lines(capsys.readouterr().out)


def _assert_same(ours, theirs):
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a["image"] == b["image"]
        assert [p["label"] for p in a["predictions"]] == [p["label"] for p in b["predictions"]]
        assert [p["classname"] for p in a["predictions"]] == [
            p["classname"] for p in b["predictions"]]
        np.testing.assert_allclose([p["score"] for p in a["predictions"]],
                                   [p["score"] for p in b["predictions"]], atol=1e-5)


@pytest.mark.parametrize("mode", ["fusion", "text", "vision", "multimodal"])
def test_predictions_match_jax_infer(artifacts, monkeypatch, capsys, mode):
    argv = _argv(artifacts, mode)
    capsys.readouterr()
    port_infer.main(port_infer.build_parser().parse_args(
        argv + ["--device", "cpu", "--dtype", "float32"]))
    ours = _lines(capsys.readouterr().out)
    _assert_same(ours, _jax_main(argv, monkeypatch, capsys))
    assert ours[0]["predictions"][0]["classname"].startswith("class ")


def test_cli_subprocess_on_the_cpu(artifacts, monkeypatch, capsys):
    argv = _argv(artifacts, "fusion")
    proc = subprocess.run(
        [sys.executable, "-m", "ovmr_tpu_torch.infer"] + argv
        + ["--device", "cpu", "--dtype", "float32"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    _assert_same(_lines(proc.stdout), _jax_main(argv, monkeypatch, capsys))


def test_defaults_to_the_card(artifacts):
    args = port_infer.build_parser().parse_args(_argv(artifacts, "fusion"))
    assert args.device == "cuda" and args.dtype == "bfloat16"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_infer.main(args)
