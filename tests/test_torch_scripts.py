"""The port's run scripts (``scripts/mm_cls_torch/*.sh``) are the JAX
package's ``scripts/mm_cls/*.sh`` with ``python -m ovmr_tpu_torch.train``
in place of ``python train.py``: the same arguments and output directories,
and the device id read onto ``CUDA_VISIBLE_DEVICES``. Each script runs
here with a stand-in ``python`` on the ``PATH`` that records its command
line, beside the JAX script's."""

import os
import os.path as osp
import stat
import subprocess

import pytest

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))

ARGS = {
    "train_ovmr": ["imagenet_21k_P", "1", "2", "3"],
    "eval_ovmr": ["oxford_pets", "1", "new", "2", "fusion", "10", "3"],
    "generate_classifier": ["oxford_pets", "1", "all", "2", "fusion", "10", "3"],
}


def _run(script, args, tmp_path, tag):
    bindir = tmp_path / f"bin_{tag}"
    bindir.mkdir()
    log = tmp_path / f"{tag}.log"
    fake = bindir / "python"
    fake.write_text(f'#!/bin/sh\necho "CUDA=$CUDA_VISIBLE_DEVICES $*" > {log}\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    work = tmp_path / f"work_{tag}"
    work.mkdir()
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    subprocess.run(["bash", osp.join(ROOT, script), *args], cwd=work, env=env, check=True,
                   timeout=60)
    return log.read_text().strip()


@pytest.mark.parametrize("name", sorted(ARGS))
def test_script_runs_the_port_entry_point_with_the_jax_scripts_arguments(name, tmp_path):
    ours = _run(f"scripts/mm_cls_torch/{name}.sh", ARGS[name], tmp_path, "port")
    theirs = _run(f"scripts/mm_cls/{name}.sh", ARGS[name], tmp_path, "jax")
    head, rest = ours.split(" ", 1)
    assert head == "CUDA=3" and theirs.startswith("CUDA= ")
    assert rest.startswith("-m ovmr_tpu_torch.train ")
    assert rest[len("-m ovmr_tpu_torch.train "):] == theirs[len("CUDA= train.py "):]
    assert "--output-dir output_ovmr/" in rest
