"""The port's lpclip feature extractor (``python -m ovmr_tpu_torch.lpclip``)
against the repo's ``lpclip/feat_extractor.py``.

Both run in process on one TINY CLIP state dict (the CoOp trajectory
golden's 64 px towers, written once as a reference ``.pt`` that both load
through ``$OVMR_CLIP_CKPT``; template ``tests/test_torch_coop.py:53``) over
``Synthetic`` (``OVMR_SYNTHETIC=8,12,32``) in fp32:

- the three splits' npz files hold the same keys and labels, and features
  within 1e-5;
- the features are raw, not unit-norm (the reference's dump);
- ``CUDA.MESH.DATA 2`` (two local data shards, through ``python -m
  ovmr_tpu_torch.lpclip``) dumps the features of one program (template
  ``tests/test_lpclip.py:100``);
- the unchanged ``lpclip/linear_probe.py`` reads the port's npz and writes
  its report lines (template ``tests/test_lpclip.py:68``);
- without a card the extractor raises unless asked for the CPU.
"""

import argparse
import importlib.util
import os
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TRAJ = osp.join(ROOT, "tests", "fixtures", "trajectory_coop_golden.npz")
SPLITS = ("train", "val", "test")
OPTS = ["DATASET.NAME", "Synthetic", "INPUT.SIZE", "(64,64)", "DATALOADER.NUM_WORKERS", "2"]


def _port_args(root, out, split, *opts):
    from ovmr_tpu_torch.lpclip.feat_extractor import build_parser

    return build_parser().parse_args([
        "--root", str(root), "--split", split, "--output-dir", str(out), "--backbone", "TINY",
        "--seed", "1", *OPTS, "CUDA.DEVICE", "cpu", "CUDA.DTYPE", "float32", *opts])


def _jax_main(root, out, split):
    spec = importlib.util.spec_from_file_location(
        "_lpclip_feat_extractor", osp.join(ROOT, "lpclip", "feat_extractor.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main(argparse.Namespace(
        root=str(root), dataset_config_file="", split=split, output_dir=str(out),
        backbone="TINY", seed=1, config_file="", eval_only=False,
        opts=[*OPTS, "TPU.DTYPE", "float32"]))


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both extractors over the three splits: ``(data root, the port's
    Synthetic dir, JAX's, the environment)``."""
    from ovmr_tpu_torch.lpclip.feat_extractor import main

    tmp = tmp_path_factory.mktemp("lpclip")
    traj = np.load(TRAJ)
    ckpt = tmp / "tiny_clip.pt"
    torch.save({k[len("clip."):]: torch.from_numpy(np.asarray(traj[k]))
                for k in traj.files if k.startswith("clip.")}, ckpt)
    env = {"OVMR_CLIP_CKPT": str(ckpt), "OVMR_SYNTHETIC": "8,12,32"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        for split in SPLITS:
            main(_port_args(tmp / "data", tmp / "port", split))
            _jax_main(tmp / "data", tmp / "jax", split)
    torch.set_num_threads(threads)
    return tmp / "data", tmp / "port" / "Synthetic", tmp / "jax" / "Synthetic", env


@pytest.mark.parametrize("split,per_class", [("train", 6), ("val", 3), ("test", 3)])
def test_npz_matches_the_jax_extractor(dumps, split, per_class):
    _, port_dir, jax_dir, _ = dumps
    got, want = np.load(port_dir / f"{split}.npz"), np.load(jax_dir / f"{split}.npz")
    assert set(got.files) == set(want.files) == {"feature_list", "label_list"}
    assert got["feature_list"].shape == want["feature_list"].shape == (8 * per_class, 128)
    np.testing.assert_array_equal(got["label_list"], want["label_list"])
    assert sorted(np.unique(got["label_list"])) == list(range(8))
    np.testing.assert_allclose(got["feature_list"], want["feature_list"], atol=1e-5, rtol=0)


def test_features_are_raw(dumps):
    feats = np.load(dumps[1] / "test.npz")["feature_list"]
    assert np.isfinite(feats).all()
    assert not np.allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-3)


def test_local_data_shards_dump_the_features_of_one_program(dumps, tmp_path):
    data, port_dir, _, env = dumps
    out = tmp_path / "feats_mesh"
    args = _port_args(data, out, "test", "CUDA.MESH.DATA", "2")
    argv = ["--root", args.root, "--split", "test", "--output-dir", str(out), "--backbone",
            "TINY", "--seed", "1", *args.opts]
    proc = subprocess.run([sys.executable, "-m", "ovmr_tpu_torch.lpclip", *argv],
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, **env, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "data-parallel mesh" in proc.stdout, proc.stdout[-1000:]
    assert re.search(r"saved 24 features to .*/Synthetic/test\.npz", proc.stdout)
    got, ref = np.load(out / "Synthetic" / "test.npz"), np.load(port_dir / "test.npz")
    np.testing.assert_array_equal(got["label_list"], ref["label_list"])
    np.testing.assert_allclose(got["feature_list"], ref["feature_list"], atol=2e-6, rtol=2e-6)


def test_linear_probe_reads_the_port_npz(dumps, tmp_path):
    proc = subprocess.run(
        [sys.executable, osp.join(ROOT, "lpclip", "linear_probe.py"), "--dataset", "Synthetic",
         "--feature_dir", str(dumps[1].parent), "--num_run", "2", "--num_step", "2",
         "--shots", "1", "4"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert re.search(r"Synthetic, seed 1, 1 shot, C [\d.e+-]+, test_acc \d", proc.stdout)
    lines = (tmp_path / "report" / "Synthetic.txt").read_text().strip().splitlines()
    assert len(lines) == 2
    for line, shot in zip(lines, (1, 4)):
        m = re.fullmatch(rf"Synthetic, {shot} shot: (\d+\.\d\d) \+- (\d+\.\d\d)", line)
        assert m, f"malformed report line: {line!r}"
        assert 0.0 <= float(m.group(1)) <= 100.0


def test_the_extractor_needs_a_card_unless_asked_for_the_cpu(dumps, tmp_path, monkeypatch):
    from ovmr_tpu_torch.lpclip.feat_extractor import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for k, v in dumps[3].items():
        monkeypatch.setenv(k, v)
    args = _port_args(dumps[0], tmp_path, "test", "CUDA.DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    assert not (tmp_path / "Synthetic").exists()
