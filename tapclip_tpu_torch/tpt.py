"""TPT: test-time prompt tuning (per-sample entropy minimization).

Counterpart of ``tapclip_tpu/tpt.py`` (Shu et al., NeurIPS 2022): each test
image is seen in N views (view 0 clean, the rest random resized crops with
an optional flip, ``data/augment.py``); the most confident views are kept,
and the context is tuned for a few Adam steps per sample to minimize the
entropy of their averaged prediction; then the clean view is classified
with the tuned context.  No labels and no training split.

The image tower is frozen and prompt-independent, so all B*V views go
through it once per batch (on the card, 12 K1 + 12 K2 launches at B*V
images); the tuning loop re-runs only the text tower, batched per (sample,
class) with a per-sample context ``[B, C, P, D]`` over ``B*C`` text rows.
The attribution pass inside the loop runs without a graph, as in training.
Samples never interact: Adam's moments are elementwise.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
without a card raises.

Usage:
    python -m tapclip_tpu_torch.tpt --val-root .../Real_World --model ViT-B-16 \\
        --pretrained open_clip_pytorch_model.bin --views 16 --steps 1
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger("tapclip_tpu_torch")


@dataclasses.dataclass(frozen=True)
class TPTConfig:
    """Test-time tuning hyperparameters.  ``n_views`` counts the clean view
    0; ``select_frac`` keeps the most confident ceil-fraction of the views
    for the marginal-entropy loss."""

    n_views: int = 16
    select_frac: float = 0.25
    steps: int = 1
    lr: float = 5e-3
    aug_scale_min: float = 0.3
    hflip: float = 0.5

    @property
    def n_selected(self) -> int:
        return max(1, min(self.n_views, round(self.select_frac * self.n_views)))


def _selected_marginal_entropy(logp: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, V, C]`` log-probs -> ``[B]``: per sample, the entropy of the mean
    probability of its ``k`` lowest-entropy views."""
    ent = -(logp.exp() * logp).sum(-1)  # [B, V]
    idx = torch.topk(-ent, k, dim=-1).indices  # the k most confident views
    sel = torch.take_along_dim(logp, idx[:, :, None], dim=1)  # [B, k, C]
    avg_p = sel.exp().mean(dim=1)
    avg_logp = torch.log(avg_p.clamp(1e-20, 1.0))
    return -(avg_p * avg_logp).sum(-1)


def make_views(generator: torch.Generator, images: torch.Tensor, tpt: "TPTConfig") -> torch.Tensor:
    """``[B, V, H, W, C]``: view 0 the clean image, views 1..V-1 random
    resized crops (area ``(aug_scale_min, 1)``, ratio ``(3/4, 4/3)``, flip
    ``hflip``) drawn from ``generator``."""
    from tapclip_tpu_torch.data.augment import AugmentConfig, augment_batch

    B, H, W, Ch = images.shape
    V = tpt.n_views
    if V == 1:
        return images[:, None]
    cfg = AugmentConfig(scale=(tpt.aug_scale_min, 1.0), ratio=(3 / 4, 4 / 3), hflip=tpt.hflip)
    rep = images[:, None].expand(B, V - 1, H, W, Ch).reshape(B * (V - 1), H, W, Ch)
    aug = augment_batch(generator, rep, cfg).reshape(B, V - 1, H, W, Ch)
    return torch.cat([images[:, None], aug], dim=1)


def make_tpt_predict_fn(clip_cfg, prompt_cfg, tpt: TPTConfig = TPTConfig()):
    """Build the per-batch TPT procedure.

    Returns ``fn(clip_params, trainable, bank, images, generator,
    batch_mask=None, *, views=None) -> (logits [B, C], aux)``: ``images`` a
    preprocessed float batch, ``logits`` the clean view's under the
    per-sample tuned context, ``aux = {"entropy_before", "entropy_after",
    "baseline_logits"}`` (mask-weighted batch means of the selected-marginal
    entropy at the first and the final context, and the clean view's logits
    at the first context).  ``views [B, V, H, W, C]`` replaces the draw.
    """
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import NEG_INF, _tile_bank, text_features_with_attribution

    if prompt_cfg.image_conditioned:
        raise NotImplementedError(
            "TPT already tunes a per-sample context; image_conditioned (CoCoOp) does not compose with it"
        )
    if prompt_cfg.maple_depth > 0:
        raise NotImplementedError(
            "maple_depth makes the vision tower prompt-dependent, which would force a full image-tower pass per "
            "TPT step; use the text-only context (maple_depth=0) for test-time tuning"
        )
    K, steps = tpt.n_selected, tpt.steps

    def predict(clip_params, trainable, bank, images, generator=None, batch_mask=None, *, views=None):
        dev = clip_params["logit_scale"].device
        images = torch.as_tensor(images, device=dev)
        B, H, W, Ch = images.shape
        bm = torch.ones((B,), device=dev) if batch_mask is None else torch.as_tensor(batch_mask, device=dev).float()
        bm_sum = bm.sum().clamp_min(1.0)
        if views is None:
            views = make_views(generator, images, tpt)
        views = torch.as_tensor(views, device=dev)
        V = views.shape[1]
        with torch.no_grad():  # the frozen tower: every view once, outside the loop
            vf = clip_model.l2_normalize(clip_model.encode_image(clip_params, clip_cfg, views.reshape(B * V, H, W, Ch)))
            vf = vf.reshape(B, V, -1).float()

        scale = torch.exp(trainable["logit_scale"]).float()
        C, P, D = trainable["ctx"].shape
        tiled = _tile_bank(bank, B)
        cmask = bank.class_mask
        ctx_dtype = trainable["ctx"].dtype

        def view_logits(ctx_b):  # [B, C, P, D] -> [B, V, C]
            tf, _ = text_features_with_attribution(
                clip_params, ctx_b.reshape(B * C, P, D).to(ctx_dtype), tiled, clip_cfg, prompt_cfg,
                trainable["adjustor"],
            )
            logits = scale * torch.einsum("bve,bce->bvc", vf, tf.reshape(B, C, -1).float())
            return torch.where(cmask[None, None, :], logits, torch.full_like(logits, NEG_INF))

        ctx = trainable["ctx"].detach().float()[None].expand(B, C, P, D).clone().requires_grad_(True)
        opt = torch.optim.Adam([ctx], lr=tpt.lr, betas=(0.9, 0.999), eps=1e-8)
        ent_before = base_logits = None
        for _ in range(steps):
            logits = view_logits(ctx)
            ent_b = _selected_marginal_entropy(torch.log_softmax(logits, dim=-1), K)
            (g,) = torch.autograd.grad(ent_b.sum(), [ctx])
            if ent_before is None:
                ent_before = (ent_b.detach() * bm).sum() / bm_sum
                base_logits = logits[:, 0].detach()
            ctx.grad = g
            opt.step()
            ctx.grad = None

        with torch.no_grad():
            logits = view_logits(ctx)
            ent_after = (_selected_marginal_entropy(torch.log_softmax(logits, dim=-1), K) * bm).sum() / bm_sum
        if ent_before is None:  # steps == 0: tuned == untuned
            ent_before, base_logits = ent_after, logits[:, 0]
        return logits[:, 0], {"entropy_before": ent_before, "entropy_after": ent_after,
                              "baseline_logits": base_logits}

    return predict


def evaluate_tpt(model, samples, *, tpt: TPTConfig = TPTConfig(), batch_size: int = 16, seed: int = 0,
                 verbose: bool = True) -> Dict[str, float]:
    """TPT over a labelled sample list -> ``{"accuracy", "baseline_accuracy",
    "entropy_before", "entropy_after"}`` (the baseline is the clean view at
    the first context, from the same pass).  The views are drawn from one
    CPU generator seeded with ``seed``, batch after batch."""
    from tapclip_tpu_torch.data.imagefolder import Loader

    cfg = model.clip_cfg
    predict = make_tpt_predict_fn(cfg, model.prompt_cfg, tpt)
    loader = Loader(samples, batch_size, shuffle=False, image_size=cfg.image_size)
    bank = model.prompt_learner.bank
    generator = torch.Generator().manual_seed(seed)

    correct = base_correct = total = 0
    e_before: List[float] = []
    e_after: List[float] = []
    for images, labels, mask in loader:
        logits, aux = predict(model.clip_params, model.trainable, bank, images, generator, mask)
        pred = logits.argmax(-1).cpu().numpy()
        base_pred = aux["baseline_logits"].argmax(-1).cpu().numpy()
        labels, mask = np.asarray(labels), np.asarray(mask, bool)
        correct += int(((pred == labels) & mask).sum())
        base_correct += int(((base_pred == labels) & mask).sum())
        total += int(mask.sum())
        e_before.append(float(aux["entropy_before"]))
        e_after.append(float(aux["entropy_after"]))
    out = {
        "accuracy": 100.0 * correct / max(total, 1),
        "baseline_accuracy": 100.0 * base_correct / max(total, 1),
        "entropy_before": float(np.mean(e_before)) if e_before else float("nan"),
        "entropy_after": float(np.mean(e_after)) if e_after else float("nan"),
    }
    if verbose:
        log.info("tpt: %.2f%% (baseline %.2f%%), entropy %.4f -> %.4f (%d views, %d selected, %d step%s)",
                 out["accuracy"], out["baseline_accuracy"], out["entropy_before"], out["entropy_after"],
                 tpt.n_views, tpt.n_selected, tpt.steps, "" if tpt.steps == 1 else "s")
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--val-root", required=True, help="labeled ImageFolder")
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None)
    p.add_argument("--pretrained", default=None, help="open_clip .bin/.pt state dict")
    p.add_argument("--ckpt", default=None,
                   help="trained prompt checkpoint (TPT-on-top; default is the template-initialized zero-shot setting)")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--select-frac", type=float, default=0.25)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--aug-scale-min", type=float, default=0.3)
    p.add_argument("--hflip", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from tapclip_tpu_torch.config import MODEL_PRESETS, PromptConfig, preset
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.featurize import load_clip_params
    from tapclip_tpu_torch.models.model_wrapper import FullModel

    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    params = load_clip_params(cfg, args.pretrained, device=args.device)
    index = ImageFolderIndex.scan(args.val_root)
    model = FullModel(index.classes, params, cfg, prompt_cfg=PromptConfig(max_classes=max(8, len(index.classes))),
                      tokenizer=get_tokenizer(args.bpe_path, cfg.context_length),
                      generator=torch.Generator().manual_seed(args.seed))
    if args.ckpt:
        from tapclip_tpu_torch.utils.checkpoint import apply_prompt_checkpoint

        apply_prompt_checkpoint(model, args.ckpt)
    tpt = TPTConfig(n_views=args.views, select_frac=args.select_frac, steps=args.steps, lr=args.lr,
                    aug_scale_min=args.aug_scale_min, hflip=args.hflip)
    return evaluate_tpt(model, index.samples, tpt=tpt, batch_size=args.batch_size, seed=args.seed)


if __name__ == "__main__":
    main()
