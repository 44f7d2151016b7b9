"""The port replays two torch-recorded OVMR goldens.

- ``ovmr_tiny_golden.npz`` (the reference's 2-layer TransformerDropout
  aggregator and CLIP text tower): the vokens, the prompt tokens, the
  multi-modal and vision heads, the text classifier, classifier generation
  with its fusion weights, and the eval logit modes, through the port's
  ``models/aggregator.py``, ``models/ovmr.py`` and ``ops/fusion.py``, at
  ``tests/test_ovmr_core.py``'s tolerances.
- ``consumer_roundtrip_golden.npz``: an ``mm_classifiers.pt`` that
  ``OVMRGenerator.export`` wrote from the port's generation, read by the
  reference's consumer lines (``mm_…:349-363``) and by the port's eval path,
  gives the reference's fused prediction (``tests/test_consumer_roundtrip.py``'s
  tolerances).
"""

import os.path as osp

import numpy as np
import pytest
import torch

from ovmr_tpu_torch.models import ovmr
from ovmr_tpu_torch.models.aggregator import generate_vokens
from ovmr_tpu_torch.models.import_torch import (
    clip_params_from_state_dict,
    prompt_learner_params_from_state_dict,
)

FIX = osp.join(osp.dirname(osp.abspath(__file__)), "fixtures")
CLASSNAMES = ["golden retriever", "tabby cat", "sports car", "red panda"]


def _state_dict(data, prefix):
    return {k[len(prefix) + 1:]: data[k] for k in data.files if k.startswith(prefix + ".")}


@pytest.fixture(scope="module")
def tiny():
    data = np.load(osp.join(FIX, "ovmr_tiny_golden.npz"))
    clip_params, clip_cfg = clip_params_from_state_dict(_state_dict(data, "clip"))
    agg_params = prompt_learner_params_from_state_dict(_state_dict(data, "agg"), n_layers=2)
    t_cls = ovmr.text_classifier(clip_params, clip_cfg, torch.as_tensor(data["ptok"]))
    out = ovmr.generate_classifiers_from_feats(
        clip_params, clip_cfg, agg_params, torch.as_tensor(data["feats"]),
        torch.as_tensor(data["ptok"]), torch.as_tensor(data["eot_idx"]),
        torch.as_tensor(data["vtok"][0]), t_cls, eval_tau=10.0)
    return data, clip_params, clip_cfg, agg_params, out


def test_tiny_vokens_tokens_and_heads_match_reference(tiny):
    data, clip_params, clip_cfg, agg_params, _ = tiny
    vokens = generate_vokens(agg_params, torch.as_tensor(data["feats"]))
    np.testing.assert_allclose(vokens.numpy(), data["vokens"], atol=2e-5, rtol=2e-5)
    # underscores read as spaces
    ptok, eot_idx, vtok = ovmr.build_prompt_tokens(["golden_retriever", "tabby cat", "sports car"])
    np.testing.assert_array_equal(ptok, data["ptok"])
    np.testing.assert_array_equal(eot_idx, data["eot_idx"])
    np.testing.assert_array_equal(vtok, data["vtok"][0])
    prompt_embeds, vis_embeds = ovmr.prompt_embeddings(
        clip_params, torch.as_tensor(data["feats"]), torch.as_tensor(data["ptok"]),
        torch.as_tensor(data["vtok"][0]))
    mm_cls, v_cls, _ = ovmr.classifier_heads(
        clip_params, clip_cfg, agg_params, torch.as_tensor(data["feats"]), prompt_embeds,
        vis_embeds, torch.as_tensor(data["eot_idx"]))
    np.testing.assert_allclose(mm_cls.numpy(), data["mm_cls"], atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(v_cls.numpy(), data["v_cls"], atol=3e-5, rtol=3e-5)
    t_cls = ovmr.text_classifier(clip_params, clip_cfg, torch.as_tensor(data["ptok"]))
    np.testing.assert_allclose(t_cls.numpy(), data["t_cls"], atol=3e-5, rtol=3e-5)


def test_tiny_generation_and_fusion_weights_match_reference(tiny):
    from sklearn.metrics import f1_score

    data, _, _, _, out = tiny
    np.testing.assert_allclose(out["mm_classifier"].numpy(), data["mm_cls"], atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out["vision_classifier"].numpy(), data["v_cls"], atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(out["text_classifier"].numpy(), data["t_cls"], atol=3e-5,
                               rtol=3e-5)
    fw = out["fusion_weight"].numpy()
    assert fw.shape == (3, 3)
    np.testing.assert_allclose(fw.sum(-1), 1.0, atol=1e-6)
    # softmax(tau * per-class F1 of each head on the exemplars)
    feats = data["feats"].reshape(-1, data["feats"].shape[-1]).astype(np.float32)
    labels = np.repeat(np.arange(3), data["feats"].shape[1])
    f1s = []
    for key in ("mm_classifier", "vision_classifier", "text_classifier"):
        preds = (feats @ out[key].numpy().T).argmax(-1)
        f1s.append(f1_score(labels, preds, average=None, labels=np.arange(3), zero_division=0))
    manual = np.stack(f1s, -1) * 10.0
    manual = np.exp(manual - manual.max(-1, keepdims=True))
    np.testing.assert_allclose(fw, manual / manual.sum(-1, keepdims=True), atol=1e-5)


def test_tiny_eval_logit_modes(tiny):
    data, clip_params, _, _, out = tiny
    feats = torch.as_tensor(data["feats"][:, 0, :])  # one query a class
    scale = float(np.exp(clip_params["logit_scale"].numpy()))

    def p(c):
        return torch.softmax(scale * feats @ c.T, dim=-1).numpy()

    for mode in ("text", "vision", "multimodal", "fusion"):
        probs = ovmr.eval_logits(feats, out, scale, mode).numpy()
        assert probs.shape == (3, 3)
        np.testing.assert_allclose(probs, ovmr.eval_logits_np(
            feats.numpy(), {k: v.numpy() for k, v in out.items()}, scale, mode), atol=1e-6)
        if mode != "fusion":  # the fusion blend is not row-normalised
            np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    manual = (np.stack([p(out["mm_classifier"]), p(out["vision_classifier"]),
                        p(out["text_classifier"])], axis=-1)
              * out["fusion_weight"].numpy()[None]).sum(-1)
    np.testing.assert_allclose(ovmr.eval_logits(feats, out, scale, "fusion").numpy(), manual,
                               atol=1e-5)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The port's generation on the golden weights and exemplars, written
    by ``OVMRGenerator.export``."""
    from ovmr_tpu_torch.api import OVMRGenerator

    data = np.load(osp.join(FIX, "forward_prompt_golden.npz"))
    clip_params, cfg = clip_params_from_state_dict(_state_dict(data, "clip"))
    agg_params = prompt_learner_params_from_state_dict(_state_dict(data, "agg"), n_layers=4)
    gen = OVMRGenerator(clip_params, cfg, agg_params, dtype=torch.float32, device="cpu")
    images = np.asarray(data["images"], np.float32).reshape(4, 4, 3, 224, 224)
    out = gen.generate(CLASSNAMES, images, eval_tau=10.0)
    outdir = str(tmp_path_factory.mktemp("consumer_rt"))
    gen.export(out, outdir)
    return gen, osp.join(outdir, "mm_classifiers.pt")


def test_exported_artifact_reproduces_reference_fused_prediction(exported):
    gen, path = exported
    golden = np.load(osp.join(FIX, "consumer_roundtrip_golden.npz"))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"text_classifier", "vision_classifier", "mm_classifier",
                            "fusion_weight"}
    assert all(v.dtype == torch.float32 for v in payload.values())
    feats = gen.encode_images(np.asarray(golden["eval_images"], np.float32))
    np.testing.assert_allclose(feats, golden["image_features"], atol=2e-4)
    # the reference's consumer lines (mm_…:349-363) on the port's artifact
    feats = torch.as_tensor(feats)
    scale = float(gen.clip_params["logit_scale"].float().exp())
    t_logits = (scale * feats @ payload["text_classifier"].t()).softmax(dim=-1)
    v_logits = (scale * feats @ payload["vision_classifier"].t()).softmax(dim=-1)
    mm_logits = (scale * feats @ payload["mm_classifier"].t()).softmax(dim=-1)
    three = torch.cat([mm_logits.unsqueeze(-1), v_logits.unsqueeze(-1), t_logits.unsqueeze(-1)],
                      dim=-1)
    fused = torch.einsum("bmn,mn->bmn", three, payload["fusion_weight"]).sum(-1).numpy()
    np.testing.assert_allclose(fused, golden["fused_probs"], atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(mm_logits.numpy(), golden["mm_probs"], atol=2e-4, rtol=2e-3)
    assert (fused.argmax(-1) == golden["fused_probs"].argmax(-1)).all()


def test_port_eval_path_matches_reference_consumer(exported):
    from ovmr_tpu_torch.api import load_exported_classifiers

    gen, path = exported
    golden = np.load(osp.join(FIX, "consumer_roundtrip_golden.npz"))
    classifiers = load_exported_classifiers(path)
    scale = float(gen.clip_params["logit_scale"].float().exp())
    probs = ovmr.eval_logits_np(golden["image_features"], classifiers, scale, "fusion")
    np.testing.assert_allclose(probs, golden["fused_probs"], atol=2e-4, rtol=2e-3)
    # classify(): the port's tower on the eval images, then the fusion
    got = gen.classify(np.asarray(golden["eval_images"], np.float32), classifiers, "fusion")
    np.testing.assert_allclose(got, golden["fused_probs"], atol=2e-4, rtol=2e-3)
