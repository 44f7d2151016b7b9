"""The linear-probe baseline's feature extractor (``python -m
ovmr_tpu_torch.lpclip``; :mod:`ovmr_tpu_torch.lpclip.feat_extractor`)."""
