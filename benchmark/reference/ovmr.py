"""Plain PyTorch OVMR: classifier generation, preference fusion, the
generator's training step.

The reference's equations (``trainers/mm_classifier_one_prompt.py``):

- prompts ``"a {name}."`` and the visual template ``"a ."``, tokenised by
  :mod:`.tokenizer`;
- the text classifier: the text tower at the EOT token, unit-normalised;
- the generator's ``n_ctx`` vokens spliced after the first two prompt tokens,
  ``[tok[:2], vokens, tok[2 : 77 - n_ctx]]``; the multi-modal classifier at
  ``EOT + n_ctx``, the vision classifier on the template at ``1 + n_ctx``;
  both unit-normalised;
- fusion: per class, the F1 of each classifier's argmax on the exemplars,
  then ``softmax(tau * F1)`` over (mm, vision, text);
- training: CE of the query features against both generated classifiers,
  Adam with L2 decay on the generator only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nn
from .tokenizer import prompt_tokens


def _embed(text, tokens):
    return text["token_embedding"].float()[tokens]


def classifiers(weights: dict, cfg: dict, classnames, feats: torch.Tensor, dropout=0.0,
                rand=None, with_text=True) -> dict:
    """Unit exemplar features [N, K, D] + class names -> ``mm_classifier``,
    ``vision_classifier``, ``visual_tokens`` and (``with_text``)
    ``text_classifier``, float32 on the features' device."""
    dev = feats.device
    text = weights["text"]
    tok, eot, vis = (torch.as_tensor(a, device=dev) for a in prompt_tokens(classnames))
    vokens = nn.aggregator(weights["agg"], feats, dropout=dropout, rand=rand)
    n, n_ctx = vokens.shape[:2]
    pe = _embed(text, tok)
    ve = _embed(text, vis)[None].expand(n, -1, -1)

    def splice(e):
        return torch.cat([e[:, :2], vokens, e[:, 2:e.shape[1] - n_ctx]], dim=1)

    mm_eos = eot + n_ctx
    v_eos = torch.full_like(mm_eos, 1 + n_ctx)
    out = {
        "mm_classifier": nn.l2n(nn.text_tower(text, cfg, splice(pe), mm_eos)),
        "vision_classifier": nn.l2n(nn.text_tower(text, cfg, splice(ve), v_eos)),
        "visual_tokens": vokens,
    }
    if with_text:
        out["text_classifier"] = nn.l2n(nn.text_tower(text, cfg, pe, eot))
    return out


def f1_per_class(preds: torch.Tensor, labels: torch.Tensor, n: int) -> torch.Tensor:
    tp = torch.bincount(labels[preds == labels], minlength=n).float()
    denom = torch.bincount(preds, minlength=n).float() + torch.bincount(labels, minlength=n).float()
    return torch.where(denom > 0, 2 * tp / denom.clamp(min=1), torch.zeros_like(tp))


def fusion(feats: torch.Tensor, cls3, scale: float, tau: float, margin):
    """Fusion weights [N, 3] from unit features [N, K, D] and the (mm,
    vision, text) classifiers, and which classes they are determined for at
    ``margin``: a class is undetermined where a row of its own, or a row that
    might be predicted as it, has a runner-up logit within ``margin`` of its
    best, for any of the three classifiers. ``margin`` is a number, or one
    tensor [N * K] per classifier: a margin per exemplar row."""
    n, k, d = feats.shape
    flat = feats.reshape(n * k, d).float()
    labels = torch.arange(n, device=feats.device).repeat_interleave(k)
    margins = margin if isinstance(margin, (list, tuple)) else [margin] * len(cls3)
    f1s, undetermined = [], torch.zeros(n, dtype=torch.bool, device=feats.device)
    for c, m in zip(cls3, margins):
        logits = scale * (flat @ c.float().T)
        top = logits.max(dim=1, keepdim=True).values
        m = torch.as_tensor(m, dtype=torch.float32, device=feats.device)
        near = logits >= top - (m[:, None] if m.ndim else m)
        ambiguous = near.sum(dim=1) > 1
        f1s.append(f1_per_class(logits.argmax(dim=1), labels, n))
        undetermined |= (near & ambiguous[:, None]).any(dim=0)
        undetermined[labels[ambiguous]] = True
    return torch.softmax(tau * torch.stack(f1s, dim=-1), dim=-1), ~undetermined


def loss(weights: dict, cfg: dict, q_feats, e_feats, classnames, dropout=0.0, rand=None):
    """CE(mm) + CE(vision) of the query features [C * split, D] against the
    classifiers generated from the exemplar features [C, n_ex, D]."""
    out = classifiers(weights, cfg, classnames, e_feats, dropout=dropout, rand=rand,
                      with_text=False)
    c, split = e_feats.shape[0], q_feats.shape[0] // e_feats.shape[0]
    labels = torch.arange(c, device=q_feats.device).repeat_interleave(split)
    scale = weights["logit_scale"]
    q = q_feats.float()
    return (F.cross_entropy(scale * (q @ out["mm_classifier"].T), labels)
            + F.cross_entropy(scale * (q @ out["vision_classifier"].T), labels))


class Adam:
    """``torch.optim.Adam`` with L2 decay folded into the gradient, written
    out: ``g += wd * p``; ``m, v`` moments; ``p -= lr * m_hat / (sqrt(v_hat) +
    eps)``."""

    def __init__(self, leaves, lr, wd, betas=(0.9, 0.999), eps=1e-8):
        self.leaves, self.lr, self.wd, self.betas, self.eps = leaves, lr, wd, betas, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.leaves, self.m, self.v):
            g = p.grad + self.wd * p
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
            p.grad = None
