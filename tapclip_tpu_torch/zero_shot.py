"""Standard CLIP zero-shot classification (no prompt tuning).

Counterpart of ``tapclip_tpu/zero_shot.py``: encode class-name prompts with
the proper text encoder (positional embedding, causal mask, ln_final, EOT
pooling), L2-normalize, and classify images by scaled cosine similarity.
The template ensemble's norms and mean are taken on the host in numpy, as in
the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from tapclip_tpu_torch.config import CLIPConfig
from tapclip_tpu_torch.models import clip as clip_model

# The OpenAI CLIP prompt-ensemble subset commonly used for ImageNet-style
# zero-shot; the single-template default is the reference's prompt format.
DEFAULT_TEMPLATES = ("a photo of a {}.",)

OPENAI_IMAGENET_TEMPLATES_SMALL = (
    "a photo of a {}.",
    "a bad photo of a {}.",
    "a photo of many {}.",
    "a photo of the hard to see {}.",
    "a low resolution photo of the {}.",
    "a rendering of a {}.",
    "a bad photo of the {}.",
    "a cropped photo of the {}.",
    "a photo of a hard to see {}.",
    "a bright photo of a {}.",
    "a photo of a clean {}.",
    "a photo of a dirty {}.",
    "a dark photo of the {}.",
    "a drawing of a {}.",
    "a photo of my {}.",
    "a close-up photo of a {}.",
    "a black and white photo of the {}.",
    "a painting of the {}.",
    "a painting of a {}.",
    "a pixelated photo of the {}.",
)


def class_name_to_text(name: str) -> str:
    """Folder names use underscores ("Alarm_Clock"); prompts read better with
    spaces.  ``raw_names=True`` feeds the raw name, as the reference does."""
    return name.replace("_", " ")


def build_zero_shot_classifier(
    clip_params,
    cfg: CLIPConfig,
    class_names: Sequence[str],
    tokenizer,
    *,
    templates: Sequence[str] = DEFAULT_TEMPLATES,
    raw_names: bool = False,
    batch_size: int = 64,
) -> torch.Tensor:
    """``[n_cls, embed_dim]`` f32 L2-normalized class weights, on the model's device.

    Template-ensembled: each class's weight is the L2-normalized mean of its
    per-template embeddings, each batch encoded by
    :func:`clip_model.encode_text` under ``inference_mode``.
    """
    texts: List[str] = []
    for name in class_names:
        n = name if raw_names else class_name_to_text(name)
        texts.extend(t.format(n) for t in templates)
    ids = tokenizer.tokenize(texts, cfg.context_length)

    feats = []
    with torch.inference_mode():
        for start in range(0, len(texts), batch_size):
            f = clip_model.encode_text(clip_params, cfg, ids[start : start + batch_size])
            feats.append(f.float().cpu().numpy())
    feats = np.concatenate(feats).reshape(len(class_names), len(templates), -1)
    feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    mean = feats.mean(axis=1)
    mean = mean / np.linalg.norm(mean, axis=-1, keepdims=True)
    return torch.from_numpy(mean).to(clip_params["logit_scale"].device)


def zero_shot_logits(clip_params, cfg: CLIPConfig, classifier: torch.Tensor, images) -> torch.Tensor:
    """``[B, n_cls]`` f32 scaled cosine logits for images (preprocessed f32 or uint8)."""
    x = torch.as_tensor(images, device=clip_params["logit_scale"].device)
    img = clip_model.l2_normalize(clip_model.encode_image(clip_params, cfg, x))
    scale = torch.exp(clip_params["logit_scale"]).float()
    return scale * (img.float() @ classifier.float().T)


def evaluate_zero_shot(clip_params, cfg: CLIPConfig, classifier: torch.Tensor, loader) -> float:
    """Overall accuracy (%) of the zero-shot classifier over a loader of
    ``(images, labels, mask)`` batches."""
    correct = total = 0
    with torch.inference_mode():
        for images, labels, mask in loader:
            preds = zero_shot_logits(clip_params, cfg, classifier, images).argmax(-1).cpu().numpy()
            keep = np.asarray(mask, bool)
            correct += int(((preds == np.asarray(labels)) & keep).sum())
            total += int(keep.sum())
    return 100.0 * correct / total if total else 0.0
