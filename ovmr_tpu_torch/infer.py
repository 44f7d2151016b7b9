"""Classify images with exported OVMR classifiers (plug-and-play consumer).

The port's counterpart of the repo's ``infer.py`` (the reference's
downstream use of ``mm_classifiers.pt``, README.md:126-129): load the
artifact, encode a directory of images (or a list of files) with the frozen
CLIP image tower and print one JSON line of top-k predictions per image.

    python -m ovmr_tpu_torch.infer --classifiers output/mm_classifiers.pt \\
        --clip ~/.cache/clip/ViT-B-16.pt --mode fusion \\
        --classnames classnames.txt path/to/images/ [--device cpu --dtype float32]

The tower runs on ``--device`` (default ``cuda``: the kernels K1/K2; ``cpu``:
their plain twins) in ``--dtype`` (default bfloat16, as the JAX package's
``OVMRGenerator``).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

import numpy as np

from ovmr_tpu_torch.engine.trainer import _DTYPES


def main(args):
    from ovmr_tpu_torch.api import OVMRGenerator, load_exported_classifiers
    from ovmr_tpu_torch.data.transforms import (
        CLIP_MEAN,
        CLIP_STD,
        center_crop,
        normalize,
        resize_smaller_edge,
        to_chw_float,
    )
    from ovmr_tpu_torch.models.ovmr import eval_logits_np
    from ovmr_tpu_torch.utils.tools import listdir_nohidden, read_image

    classifiers = load_exported_classifiers(args.classifiers)

    classnames = None
    if args.classnames and osp.exists(args.classnames):
        with open(args.classnames) as f:
            classnames = [line.strip() for line in f if line.strip()]

    gen = OVMRGenerator.from_checkpoints(args.clip, dtype=_DTYPES[args.dtype],
                                         device=args.device)

    paths = []
    for target in args.inputs:
        if osp.isdir(target):
            paths.extend(
                osp.join(target, f)
                for f in listdir_nohidden(target, sort=True)
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp"))
            )
        else:
            paths.append(target)
    if not paths:
        raise SystemExit("no images found")

    size = args.size
    batch = []
    for p in paths:
        img = read_image(p)
        img = center_crop(resize_smaller_edge(img, size), (size, size))
        batch.append(normalize(to_chw_float(img), CLIP_MEAN, CLIP_STD))
    feats = gen.encode_images(np.stack(batch))

    scale = float(np.exp(gen.clip_params["logit_scale"].float().cpu().numpy()))
    probs = eval_logits_np(feats, classifiers, scale, args.mode)
    topk = np.argsort(-probs, axis=1)[:, : args.topk]
    for path, idxs, row in zip(paths, topk, probs):
        preds = [
            {
                "label": int(i),
                "classname": classnames[i] if classnames else str(int(i)),
                "score": float(row[i]),
            }
            for i in idxs
        ]
        print(json.dumps({"image": path, "predictions": preds}))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m ovmr_tpu_torch.infer")
    parser.add_argument("inputs", nargs="+", help="image files or directories")
    parser.add_argument("--classifiers", required=True, help="mm_classifiers.pt path")
    parser.add_argument("--clip", default="~/.cache/clip/ViT-B-16.pt")
    parser.add_argument("--classnames", default="", help="optional classnames txt")
    parser.add_argument("--mode", default="fusion",
                        choices=["text", "vision", "multimodal", "fusion"])
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES),
                        help="the tower's compute dtype")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
