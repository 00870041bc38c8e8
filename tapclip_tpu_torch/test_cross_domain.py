"""Cross-domain zero/few-shot transfer eval with unseen classes.

Counterpart of ``tapclip_tpu/test_cross_domain.py`` (the reference's
``test_cross_domain.py``): loads a trained prompt checkpoint (the port's
``.pt``, or a reference ``.pt`` including the legacy ``context_emb``
layout), extends the class set with unseen classes at eval time, then
evaluates the ``num_shots x domains`` grid.  There is no fine-tuning here:
``num_shots`` only changes the val split (the few-shot samples leave it).
Writes the ``Domain,Shots,Accuracy`` CSV and the grouped bar chart
(``--ref-artifacts``: the reference's ``visible results/`` names).

The val features are keyed by image path (``trainer.PathFeatureCache``), so
the whole grid runs the frozen image tower once per distinct image.
``main`` is :func:`parse`, then :func:`run` (the grid and the CSV), then
:func:`write_plot`.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional

from tapclip_tpu_torch.config import preset
from tapclip_tpu_torch.train import apply_overrides, build_argparser, build_model

DEFAULT_DOMAINS = ["Real World", "Art", "Clipart", "Product"]
DEFAULT_SHOTS = [0, 5, 15]


def add_cross_domain_args(p):
    p.add_argument("--checkpoint", default=None, help="prompt checkpoint (the port's .pt or a reference .pt)")
    p.add_argument("--domains", nargs="+", default=None)
    p.add_argument("--domain-root", default=None, help="base dir containing one subdir per domain")
    p.add_argument("--shots", nargs="+", type=int, default=None)
    p.add_argument("--seen-classes", nargs="+", default=None)
    p.add_argument("--unseen-classes", nargs="+", default=["Clipboards"])
    p.add_argument("--ref-artifacts", action="store_true",
                   help="write artifacts under 'visible results/' with the reference's exact filename "
                        "pattern (quirks included)")
    p.add_argument("--artifact-root", default=".", help="base dir for --ref-artifacts (reference uses cwd)")
    return p


def ref_artifact_names(results, checkpoint: Optional[str], epochs_fallback: int, expand: bool):
    """The reference's artifact filenames, quirks and all:
    ``cross_domain_results_{epochs}_{acc}_{expand}.csv`` and
    ``cross_domain_accuracy_bar_{epochs}_{acc}_{expand}.png``, where
    ``epochs`` comes from a ``best_model_epoch{N}_acc`` checkpoint name (else
    ``epochs_fallback``), ``acc`` is the LAST grid cell's accuracy (the
    reference's shadowed loop variable) and ``expand`` says whether unseen
    classes were appended."""
    epochs = epochs_fallback
    if checkpoint:
        m = re.search(r"best_model_epoch(\d+)_acc", os.path.basename(checkpoint))
        if m:
            epochs = int(m.group(1))
    last_acc = results[-1]["Accuracy"] if results else 0.0
    suffix = f"{epochs}_{last_acc}_{expand}"
    return f"cross_domain_results_{suffix}.csv", f"cross_domain_accuracy_bar_{suffix}.png"


def evaluate_grid(
    model,
    preprocess,
    domain_root: str,
    domains: List[str],
    shots_list: List[int],
    class_names: List[str],
    *,
    batch_size: int = 32,
    seed: int = 0,
    fine_tune_fn=None,
    restore_fn=None,
):
    """shots x domains accuracy grid over path-cached per-domain features."""
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, few_shot_split
    from tapclip_tpu_torch.trainer import PathFeatureCache, evaluate_cached

    log = logging.getLogger("tapclip_tpu_torch")
    cache = PathFeatureCache(model, preprocess=preprocess)
    indexes = {d: ImageFolderIndex.scan(os.path.join(domain_root, d)) for d in domains}
    results = []
    for num_shots in shots_list:
        shot_type = f"{num_shots}-shot" if num_shots > 0 else "Zero-Shot"
        for domain in domains:
            log.info("\n\U0001f30d [%s] Testing on %s domain...", shot_type, domain)
            if restore_fn is not None:
                restore_fn(model)  # fresh state per cell
            split = few_shot_split(indexes[domain], class_names, num_shots, seed=seed)
            if fine_tune_fn is not None and num_shots > 0 and split.train:
                fine_tune_fn(model, cache.gather(split.train))
            acc, _ = evaluate_cached(model, cache.gather(split.val), batch_size=max(batch_size, 32))
            log.info("[%s/%s] accuracy: %.2f%%", shot_type, domain, acc)
            results.append({"Domain": domain, "Shots": shot_type, "Accuracy": acc})
    return results


def load_prompt_checkpoint_into(model, path: str, seen_classes: List[str]):
    """The reference's checkpoint loading, legacy migration included
    (``test_cross_domain.py:43-61``)."""
    from tapclip_tpu_torch.utils.checkpoint import apply_prompt_checkpoint

    return apply_prompt_checkpoint(model, path, seen_classes)


def parse(argv: Optional[List[str]] = None):
    args = add_cross_domain_args(build_argparser(__doc__)).parse_args(argv)
    return args, apply_overrides(preset(args.preset), args)


def run(args, cfg) -> dict:
    """The model, the checkpoint, the unseen classes, the grid and its CSV."""
    import dataclasses

    from tapclip_tpu_torch.utils.logging_utils import generate_output_paths, setup_logging
    from tapclip_tpu_torch.utils.plotting import save_results_csv

    paths = generate_output_paths(cfg.version + "_xdomain", cfg.output_root)
    log = setup_logging(os.path.join(paths["log_dir"], "cross_domain.log"))

    seen = list(args.seen_classes or cfg.class_names)
    unseen = list(args.unseen_classes or [])
    all_classes = seen + [c for c in unseen if c not in seen]
    model, preprocess = build_model(dataclasses.replace(cfg, class_names=tuple(seen)), bpe_path=args.bpe_path,
                                    device=args.device)
    if args.checkpoint:
        load_prompt_checkpoint_into(model, args.checkpoint, seen)
        log.info("loaded checkpoint %s", args.checkpoint)
    for cls in all_classes:
        model.add_class_prompt(cls)

    domains = args.domains or DEFAULT_DOMAINS
    shots_list = args.shots if args.shots is not None else DEFAULT_SHOTS
    domain_root = args.domain_root or os.path.dirname(cfg.data_root) or "."
    results = evaluate_grid(model, preprocess, domain_root, domains, shots_list, all_classes,
                            batch_size=cfg.train.batch_size, seed=cfg.train.seed)
    if args.ref_artifacts:
        csv_name, png_name = ref_artifact_names(results, args.checkpoint, cfg.train.epochs, expand=bool(unseen))
        vis_dir = os.path.join(args.artifact_root, "visible results")
        csv_path = save_results_csv(results, os.path.join(vis_dir, csv_name))
        plot_dest = os.path.join(vis_dir, png_name)
    else:
        csv_path = save_results_csv(results, os.path.join(paths["csv_dir"], "cross_domain_results.csv"))
        plot_dest = os.path.join(paths["plot_dir"], "cross_domain_accuracy_bar.png")
    log.info("✅ Results saved to %s", csv_path)
    return {"results": results, "csv": csv_path, "plot": plot_dest, "paths": paths}


def write_plot(out: dict) -> dict:
    """The grouped bar chart of a :func:`run` (the reference pins this
    chart's y-axis to 80-100)."""
    from tapclip_tpu_torch.utils.plotting import save_cross_domain_bar

    save_cross_domain_bar(out["results"], out["plot"], ylim=(80, 100))
    logging.getLogger("tapclip_tpu_torch").info("✅ Plot saved to %s", out["plot"])
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    args, cfg = parse(argv)
    return write_plot(run(args, cfg))


if __name__ == "__main__":
    main()
