"""Torch checkpoint ingestion straight into the port's parameter dicts.

Counterpart of ``ovmr_tpu/models/import_torch.py`` for ViT towers and OVMR
prompt-learner checkpoints: OpenAI-CLIP state_dicts or TorchScript
archives (reference ``clip/clip.py:117-126`` / ``clip/model.py:899-936``)
and ``model.pth.tar-{epoch}`` pickles (reference
``dassl/utils/torchtools.py:77-115``). Linear weights are transposed to
the ``[in, out]`` layout; every tensor comes out fp32 on the CPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .clip import CLIPConfig

# (port key, reference state_dict key, transpose to [in, out])
TORCH_BLOCK_KEYS = (
    ("w_qkv", "attn.in_proj_weight", True),
    ("b_qkv", "attn.in_proj_bias", False),
    ("w_out", "attn.out_proj.weight", True),
    ("b_out", "attn.out_proj.bias", False),
    ("ln_1_scale", "ln_1.weight", False),
    ("ln_1_bias", "ln_1.bias", False),
    ("c_fc_w", "mlp.c_fc.weight", True),
    ("c_fc_b", "mlp.c_fc.bias", False),
    ("c_proj_w", "mlp.c_proj.weight", True),
    ("c_proj_b", "mlp.c_proj.bias", False),
    ("ln_2_scale", "ln_2.weight", False),
    ("ln_2_bias", "ln_2.bias", False),
)


def _t(x) -> torch.Tensor:
    """Tensor or array -> detached fp32 CPU tensor (fp16 upcasts losslessly)."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def load_torch_file(path: str) -> Dict:
    """Load a torch file: TorchScript archive or pickled state_dict/checkpoint."""
    try:
        return torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        return torch.load(path, map_location="cpu", weights_only=False)


def clip_config_from_state_dict(sd: Dict) -> CLIPConfig:
    """Shape-sniff a ViT CLIP (reference ``clip/model.py:899-918``). Head
    counts are width // 64: they cannot be read from the shapes."""
    if "visual.proj" not in sd:
        raise NotImplementedError("ResNet CLIP checkpoints are not ported yet")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len(
        [k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")]
    )
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid_size,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}
        ),
    )


def _blocks_from_sd(sd: Dict, prefix: str, n_layers: int) -> Dict[str, torch.Tensor]:
    """Stack per-layer block weights along a leading layer axis, linear
    weights transposed to [in, out]."""
    out = {}
    for key, torch_key, transpose in TORCH_BLOCK_KEYS:
        rows = [_t(sd[f"{prefix}.{i}.{torch_key}"]) for i in range(n_layers)]
        out[key] = torch.stack([r.t() if transpose else r for r in rows]).contiguous()
    return out


def clip_params_from_state_dict(sd: Dict) -> Tuple[dict, CLIPConfig]:
    """torch ViT CLIP state_dict -> (param dict fp32, config)."""
    cfg = clip_config_from_state_dict(sd)
    conv1 = _t(sd["visual.conv1.weight"])  # [W, 3, p, p]
    visual = {
        "patch_embed_w": conv1.reshape(conv1.shape[0], -1).t().contiguous(),
        "class_embedding": _t(sd["visual.class_embedding"]),
        "positional_embedding": _t(sd["visual.positional_embedding"]),
        "ln_pre_scale": _t(sd["visual.ln_pre.weight"]),
        "ln_pre_bias": _t(sd["visual.ln_pre.bias"]),
        "blocks": _blocks_from_sd(sd, "visual.transformer.resblocks", cfg.vision_layers),
        "ln_post_scale": _t(sd["visual.ln_post.weight"]),
        "ln_post_bias": _t(sd["visual.ln_post.bias"]),
        "proj": _t(sd["visual.proj"]),
    }
    text = {
        "token_embedding": _t(sd["token_embedding.weight"]),
        "positional_embedding": _t(sd["positional_embedding"]),
        "blocks": _blocks_from_sd(sd, "transformer.resblocks", cfg.transformer_layers),
        "ln_final_scale": _t(sd["ln_final.weight"]),
        "ln_final_bias": _t(sd["ln_final.bias"]),
        "text_projection": _t(sd["text_projection"]),
    }
    return {"visual": visual, "text": text, "logit_scale": _t(sd["logit_scale"])}, cfg


def load_clip(path: str) -> Tuple[dict, CLIPConfig]:
    """torch file at ``path`` -> (params fp32, CLIPConfig)."""
    sd = load_torch_file(path)
    if not isinstance(sd, dict) or "text_projection" not in sd:
        sd = sd.get("state_dict", sd)
    return clip_params_from_state_dict(sd)


def prompt_learner_params_from_state_dict(sd: Dict, n_layers: int = 4) -> dict:
    """Reference prompt_learner state_dict (``aggregator.resblocks.{i}.*`` +
    ``cls_token``) -> aggregator params."""
    return {
        "blocks": _blocks_from_sd(sd, "aggregator.resblocks", n_layers),
        "cls_token": _t(sd["cls_token"]),
    }


def load_prompt_learner(path: str) -> Tuple[dict, int]:
    """Load a reference ``model.pth.tar-{epoch}`` file -> (params, epoch),
    dropping the ``token_prefix``/``token_suffix`` buffers as the reference
    loader does (``trainers/mm_classifier_one_prompt.py:484-489``)."""
    ckpt = load_torch_file(path)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if k not in ("token_prefix", "token_suffix")}
    epoch = ckpt.get("epoch", 0) if isinstance(ckpt, dict) else 0
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("aggregator.resblocks")})
    return prompt_learner_params_from_state_dict(sd, n_layers), epoch
