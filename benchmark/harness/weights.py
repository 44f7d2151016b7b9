"""Random CLIP towers and generator made on the device from the seed.

CLIP's initialisation scales (``CLIP.initialize_parameters``) and OVMR's
generator's, drawn by one ``torch.Generator`` on the device: every normal
leaf is a slice of one ``randn`` in the served dtype, scaled in place. The
nested dicts use the program's keys; the same tensors go to the program and,
read in float32, to the reference.
"""

from __future__ import annotations

import math

import torch


def _block_shapes(layers: int, width: int):
    """(key, shape, std) of a block stack; std None: ones, 0: zeros."""
    proj_std = width ** -0.5 * (2 * layers) ** -0.5
    return [
        ("w_qkv", (layers, width, 3 * width), width ** -0.5),
        ("b_qkv", (layers, 3 * width), 0),
        ("w_out", (layers, width, width), proj_std),
        ("b_out", (layers, width), 0),
        ("ln_1_scale", (layers, width), None),
        ("ln_1_bias", (layers, width), 0),
        ("c_fc_w", (layers, width, 4 * width), (2 * width) ** -0.5),
        ("c_fc_b", (layers, 4 * width), 0),
        ("c_proj_w", (layers, 4 * width, width), proj_std),
        ("c_proj_b", (layers, width), 0),
        ("ln_2_scale", (layers, width), None),
        ("ln_2_bias", (layers, width), 0),
    ]


def _fill(spec, generator, dtype, device):
    """One randn for every normal leaf of ``spec`` [(path, shape, std)]."""
    sizes = [math.prod(shape) for _, shape, std in spec if std]
    flat = torch.randn(sum(sizes), generator=generator, device=device, dtype=dtype)
    out, offset = {}, 0
    for path, shape, std in spec:
        if std is None:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif std == 0:
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            n = math.prod(shape)
            out[path] = flat[offset:offset + n].view(shape).mul_(std)
            offset += n
    return out


def _nest(flat: dict) -> dict:
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def make_clip(cfg: dict, generator: torch.Generator, dtype, device) -> dict:
    """CLIP ViT towers as the program's ``init_params`` lays them out."""
    vw, tw, p = cfg["vision_width"], cfg["transformer_width"], cfg["vision_patch_size"]
    grid = cfg["image_resolution"] // p
    spec = [
        (("visual", "patch_embed_w"), (3 * p * p, vw), vw ** -0.5),
        (("visual", "class_embedding"), (vw,), vw ** -0.5),
        (("visual", "positional_embedding"), (grid * grid + 1, vw), vw ** -0.5),
        (("visual", "ln_pre_scale"), (vw,), None),
        (("visual", "ln_pre_bias"), (vw,), 0),
        (("visual", "ln_post_scale"), (vw,), None),
        (("visual", "ln_post_bias"), (vw,), 0),
        (("visual", "proj"), (vw, cfg["embed_dim"]), vw ** -0.5),
        (("text", "token_embedding"), (cfg["vocab_size"], tw), 0.02),
        (("text", "positional_embedding"), (cfg["context_length"], tw), 0.01),
        (("text", "ln_final_scale"), (tw,), None),
        (("text", "ln_final_bias"), (tw,), 0),
        (("text", "text_projection"), (tw, cfg["embed_dim"]), tw ** -0.5),
    ]
    spec += [(("visual", "blocks", k), s, std)
             for k, s, std in _block_shapes(cfg["vision_layers"], vw)]
    spec += [(("text", "blocks", k), s, std)
             for k, s, std in _block_shapes(cfg["transformer_layers"], tw)]
    params = _nest(_fill(spec, generator, dtype, device))
    params["logit_scale"] = torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device)
    return params


def make_generator(cfg: dict, generator: torch.Generator, device) -> dict:
    """OVMR's visual token generator in float32, the type it trains and is
    served in; ``cls_token`` is unit-normalised noise."""
    width, layers, n_ctx = cfg["embed_dim"], cfg["generator_layers"], cfg["n_ctx"]
    spec = [(("blocks", k), s, std) for k, s, std in _block_shapes(layers, width)]
    spec.append((("cls_token",), (n_ctx, width), 1.0))
    agg = _nest(_fill(spec, generator, torch.float32, device))
    agg["cls_token"] = agg["cls_token"] / agg["cls_token"].norm(dim=-1, keepdim=True)
    return agg


def to_float(tree):
    """A float32 copy of a weights tree, for the reference."""
    if isinstance(tree, dict):
        return {k: to_float(v) for k, v in tree.items()}
    return tree.detach().float().clone()
