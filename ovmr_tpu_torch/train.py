"""CLI entry point of the port — flag-compatible with the repo's ``train.py``.

    python -m ovmr_tpu_torch.train --root DATA --seed 1 --trainer MM_CLS_OP \
        --n_ctx 2 --output-dir OUT [--eval-only --model-dir DIR --load-epoch N \
        --eval_mode fusion --eval_tau 10] [KEY VALUE ...]

Config assembly order (reference ``train.py:134-154``): code defaults ->
dataset yaml -> trainer yaml -> CLI resets -> free-form ``KEY VALUE`` opts
(last on the command line) -> freeze. The trainer runs on ``CUDA.DEVICE``
(default ``cuda``; ``CUDA.DEVICE cpu`` runs the kernels' plain twins on the
CPU). :func:`main` returns the trainer, so a caller in the same process
can read its state. Data-parallel over N cards, one process a card:

    OVMR_MULTIHOST=1 torchrun --nproc_per_node N -m ovmr_tpu_torch.train ...

or ``OVMR_COORDINATOR=host:port OVMR_NUM_PROCESSES=N OVMR_PROCESS_ID=i`` in
each process; ``CUDA.MESH.DATA`` and ``CUDA.MESH.MODEL`` lay the ranks out
(:mod:`ovmr_tpu_torch.parallel`).
"""

from __future__ import annotations

import argparse

from ovmr_tpu_torch.engine.trainer import build_trainer
from ovmr_tpu_torch.parallel.multihost import maybe_initialize_distributed
from ovmr_tpu_torch.utils import (
    collect_env_info,
    extend_cfg,
    get_cfg_default,
    set_random_seed,
    setup_logger,
)


def print_args(args, cfg):
    print("***************")
    print("** Arguments **")
    print("***************")
    for key in sorted(vars(args)):
        print(f"{key}: {getattr(args, key)}")
    print("************")
    print("** Config **")
    print("************")
    print(cfg.dump())


def reset_cfg(cfg, args):
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed:
        cfg.SEED = args.seed
    if args.fs_classifier:
        cfg.FS_CLASSIFIER = args.fs_classifier
    if args.transforms:
        cfg.INPUT.TRANSFORMS = args.transforms
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head
    if args.stage_num:
        cfg.STAGE_NUM = args.stage_num
    if args.init_weight:
        cfg.MODEL.INIT_WEIGHTS = args.init_weight
    if args.n_ctx:
        cfg.TRAINER.COCOOP.N_CTX = args.n_ctx
    if args.eval_mode:
        cfg.EVAL_MODE = args.eval_mode
    if args.eval_tau:
        cfg.EVAL_TAU = args.eval_tau
    if args.visual_token_path:
        cfg.TRAINER.COOP.VISUAL_TOKEN_PATH = args.visual_token_path


def setup_cfg(args):
    cfg = get_cfg_default()
    extend_cfg(cfg)
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    return cfg


def main(args):
    cfg = setup_cfg(args)
    # one process a card: join the process group (OVMR_COORDINATOR or
    # torchrun's variables) before anything touches the card, as the
    # repo's train.py does (:25-27); a no-op without them
    maybe_initialize_distributed(cfg.CUDA.DEVICE)
    if cfg.SEED >= 0:
        print(f"Setting fixed seed: {cfg.SEED}")
        set_random_seed(cfg.SEED)
    setup_logger(cfg.OUTPUT_DIR)

    print_args(args, cfg)
    print("Collecting env info ...")
    print(f"** System info **\n{collect_env_info()}\n")

    trainer = build_trainer(cfg)

    if args.eval_only:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
        trainer.test()
    elif not args.no_train:
        trainer.train()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m ovmr_tpu_torch.train")
    parser.add_argument("--root", type=str, default="", help="path to dataset")
    parser.add_argument("--output-dir", type=str, default="", help="output directory")
    parser.add_argument("--resume", type=str, default="", help="resume checkpoint dir")
    parser.add_argument("--seed", type=int, default=-1, help="fixed seed if positive")
    parser.add_argument("--source-domains", type=str, nargs="+", help="unused (DA compat)")
    parser.add_argument("--target-domains", type=str, nargs="+", help="unused (DA compat)")
    parser.add_argument("--transforms", type=str, nargs="+", help="data transforms")
    parser.add_argument("--config-file", type=str, default="", help="trainer config yaml")
    parser.add_argument("--dataset-config-file", type=str, default="", help="dataset yaml")
    parser.add_argument("--trainer", type=str, default="", help="trainer name")
    parser.add_argument("--backbone", type=str, default="", help="backbone name")
    parser.add_argument("--head", type=str, default="", help="head name")
    parser.add_argument("--eval-only", action="store_true", help="evaluation only")
    parser.add_argument("--fs_classifier", type=str, default="", help="few-shot classifier")
    parser.add_argument("--stage_num", type=int, default=1, help="stage number")
    parser.add_argument("--init_weight", type=str, default="", help="init weight path")
    parser.add_argument("--model-dir", type=str, default="", help="eval model dir")
    parser.add_argument("--load-epoch", type=int, help="epoch to load for eval")
    parser.add_argument("--n_ctx", type=int, help="number of visual tokens")
    parser.add_argument("--eval_mode", type=str, default="", help="text|vision|multimodal|fusion")
    parser.add_argument("--eval_tau", type=float, default=0, help="fusion temperature")
    parser.add_argument("--visual_token_path", type=str, default="", help="pretrained voken path")
    parser.add_argument("--no-train", action="store_true", help="do not train")
    parser.add_argument(
        "opts", default=None, nargs=argparse.REMAINDER,
        help="config overrides as KEY VALUE pairs",
    )
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
