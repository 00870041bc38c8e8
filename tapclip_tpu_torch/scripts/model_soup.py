"""Model soups: average fine-tuned CLIP checkpoints (Wortsman et al. 2022).

Counterpart of ``scripts/model_soup.py``.  Averaging the weights of several
fine-tuned models improves accuracy and robustness at no inference cost.

Two recipes:
* **uniform**: the plain mean of all ingredient trees;
* **greedy**: ingredients sorted by held-out zero-shot accuracy, each added
  to the soup only if it does not lower that accuracy (needs --val-root).

Ingredients are the port's CLIP trees (``pretrain_cli``'s ``.pt`` output)
or open_clip ``.bin``/``.pt`` state dicts; the soup is written as a CLIP
tree ``.pt``, loadable by every ``--pretrained`` (back to ``.bin`` with
``convert_checkpoint export``).  An Orbax directory raises.

Usage:
    python -m tapclip_tpu_torch.scripts.model_soup --inputs runs/a/models/clip_pretrained.pt \\
        runs/b/models/clip_pretrained.pt --out soup.pt
    python -m tapclip_tpu_torch.scripts.model_soup --inputs ... --greedy \\
        --val-root data/OfficeHome/Art --model ViT-B-32 --out soup.pt
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch
from torch.utils import _pytree as pytree

log = logging.getLogger("tapclip_tpu_torch.soup")


def average_trees(trees):
    """Uniform soup: leaf-wise mean in float64, cast back to each leaf's
    dtype, leaves matched by key path (the port builds trees in more than
    one dict order); the soup has the first tree's structure."""
    if not trees:
        raise ValueError("no ingredient trees")
    flat = [dict(pytree.tree_flatten_with_path(t)[0]) for t in trees]
    for i, f in enumerate(flat[1:], 1):
        if f.keys() != flat[0].keys():
            raise ValueError(f"ingredient {i} has a different tree structure")

    def mean(path):
        a = torch.as_tensor(flat[0][path])
        return torch.stack([torch.as_tensor(f[path]).double() for f in flat]).mean(0).to(a.dtype)

    paths = [path for path, _ in pytree.tree_flatten_with_path(trees[0])[0]]
    return pytree.tree_unflatten([mean(p) for p in paths], pytree.tree_structure(trees[0]))


def _zeroshot_acc(params, cfg, index, loader, tokenizer):
    from tapclip_tpu_torch.zero_shot import build_zero_shot_classifier, evaluate_zero_shot

    clf = build_zero_shot_classifier(params, cfg, index.classes, tokenizer)
    return evaluate_zero_shot(params, cfg, clf, iter(loader))


def greedy_soup(trees, accs_sorted_idx, eval_fn):
    """Wortsman et al.'s greedy recipe: ingredients in descending held-out
    accuracy; keep each only if the running soup's accuracy doesn't drop."""
    soup = [trees[accs_sorted_idx[0]]]
    best = eval_fn(average_trees(soup))
    kept = [int(accs_sorted_idx[0])]
    for i in accs_sorted_idx[1:]:
        cand = eval_fn(average_trees(soup + [trees[i]]))
        if cand >= best:
            soup.append(trees[i])
            kept.append(int(i))
            best = cand
            log.info("  + ingredient %d kept (val %.2f%%)", i, cand)
        else:
            log.info("  - ingredient %d dropped (val %.2f%% < %.2f%%)", i, cand, best)
    return average_trees(soup), kept, best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--inputs", nargs="+", required=True, help="ingredient checkpoints (CLIP tree .pt or .bin)")
    p.add_argument("--out", required=True, help="output CLIP tree .pt")
    p.add_argument("--greedy", action="store_true", help="greedy soup (needs --val-root)")
    p.add_argument("--val-root", default=None,
                   help="labeled ImageFolder for the greedy recipe's held-out zero-shot accuracy")
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--preset", default=None, help="'tiny' for tests")
    p.add_argument("--bpe-path", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from tapclip_tpu_torch.config import MODEL_PRESETS, preset
    from tapclip_tpu_torch.featurize import load_clip_params
    from tapclip_tpu_torch.utils.checkpoint import save_clip_tree

    cfg = preset(args.preset).model if args.preset else MODEL_PRESETS[args.model]
    if len(args.inputs) < 2:
        raise SystemExit("a soup needs at least 2 ingredients")
    trees = [load_clip_params(cfg, path, device=args.device) for path in args.inputs]
    log.info("soup: %d ingredients (%s)", len(trees), cfg.name)

    kept = list(range(len(trees)))
    val_acc = None
    if args.greedy:
        if not args.val_root:
            raise SystemExit("--greedy needs --val-root")
        from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader
        from tapclip_tpu_torch.data.tokenizer import get_tokenizer

        index = ImageFolderIndex.scan(args.val_root)
        loader = Loader(index.samples, args.batch_size, shuffle=False, image_size=cfg.image_size)
        tokenizer = get_tokenizer(args.bpe_path, cfg.context_length)

        def eval_fn(tree):
            return _zeroshot_acc(tree, cfg, index, loader, tokenizer)

        accs = [eval_fn(t) for t in trees]
        order = list(np.argsort(accs)[::-1])
        log.info("ingredient accuracies: %s", [f"{a:.2f}%" for a in accs])
        soup, kept, val_acc = greedy_soup(trees, order, eval_fn)
    else:
        soup = average_trees(trees)

    out = save_clip_tree(args.out, soup, cfg)
    msg = f"soup saved: {out} ({len(kept)}/{len(trees)} ingredients"
    if val_acc is not None:
        msg += f", val {val_acc:.2f}%"
    log.info(msg + ")")
    return {"out": out, "kept": kept, "val_acc": val_acc}


if __name__ == "__main__":
    main()
