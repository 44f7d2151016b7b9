"""``python -m ovmr_tpu_torch.lpclip``: :mod:`ovmr_tpu_torch.lpclip.feat_extractor`."""

from ovmr_tpu_torch.lpclip.feat_extractor import build_parser, main

if __name__ == "__main__":
    main(build_parser().parse_args())
