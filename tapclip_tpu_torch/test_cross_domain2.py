"""Cross-domain eval with per-domain few-shot fine-tuning.

Counterpart of ``tapclip_tpu/test_cross_domain2.py`` (the reference's
``test_cross_domain2.py``).  For each ``(num_shots, domain)`` cell: restore
the model to the checkpointed state (the reference builds a fresh model per
cell), fine-tune the context bank alone on the few-shot split (10 passes,
AdamW lr 5e-3), then evaluate.  Classes given by ``--seen-classes`` that
the checkpoint lacks (an unseen class) join the bank before the grid.
CSV + grouped bar chart into the timestamped results tree.  ``main`` is
:func:`parse`, then :func:`run`, then :func:`write_plot`.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from tapclip_tpu_torch.config import preset
from tapclip_tpu_torch.test_cross_domain import (
    DEFAULT_DOMAINS,
    DEFAULT_SHOTS,
    add_cross_domain_args,
    evaluate_grid,
    load_prompt_checkpoint_into,
)
from tapclip_tpu_torch.train import apply_overrides, build_argparser, build_model


def parse(argv: Optional[List[str]] = None):
    p = add_cross_domain_args(build_argparser(__doc__))
    p.add_argument("--ft-steps", type=int, default=10)
    p.add_argument("--ft-lr", type=float, default=5e-3)
    args = p.parse_args(argv)
    return args, apply_overrides(preset(args.preset), args)


def run(args, cfg) -> dict:
    """The model, the checkpoint, the fine-tuned grid and its CSV."""
    from tapclip_tpu_torch.parallel.train_step import snapshot
    from tapclip_tpu_torch.trainer import fine_tune_on_few_shot
    from tapclip_tpu_torch.utils.logging_utils import generate_output_paths, setup_logging
    from tapclip_tpu_torch.utils.plotting import save_results_csv

    paths = generate_output_paths(cfg.version + "_xdomain_ft", cfg.output_root)
    log = setup_logging(os.path.join(paths["log_dir"], "cross_domain_ft.log"))

    class_names = list(args.seen_classes or cfg.class_names)
    model, preprocess = build_model(cfg, bpe_path=args.bpe_path, device=args.device)
    if args.checkpoint:
        load_prompt_checkpoint_into(model, args.checkpoint, class_names)
        log.info("loaded checkpoint %s", args.checkpoint)
    for cls in class_names:
        model.add_class_prompt(cls)

    # The restored state; every cell starts from it (the reference re-instantiates the model).
    start = {"trainable": snapshot(model.trainable), "bank": model.prompt_learner.bank}

    def restore_fn(m):
        m.trainable = snapshot(start["trainable"])
        m.prompt_learner.bank = start["bank"]

    def fine_tune_fn(m, loader):
        fine_tune_on_few_shot(m, loader, steps=args.ft_steps, lr=args.ft_lr)

    domains = args.domains or DEFAULT_DOMAINS
    shots_list = args.shots if args.shots is not None else DEFAULT_SHOTS
    domain_root = args.domain_root or os.path.dirname(cfg.data_root) or "."
    results = evaluate_grid(model, preprocess, domain_root, domains, shots_list, class_names,
                            batch_size=cfg.train.batch_size, seed=cfg.train.seed,
                            fine_tune_fn=fine_tune_fn, restore_fn=restore_fn)
    csv_path = save_results_csv(results, os.path.join(paths["csv_dir"], "cross_domain_results.csv"))
    log.info("✅ Results saved to %s", csv_path)
    return {"results": results, "csv": csv_path, "version": cfg.version, "paths": paths,
            "plot": os.path.join(paths["plot_dir"], f"cross_domain_bar_{cfg.version}.png")}


def write_plot(out: dict) -> dict:
    """The grouped bar chart of a :func:`run`."""
    from tapclip_tpu_torch.utils.plotting import save_cross_domain_bar

    save_cross_domain_bar(out["results"], out["plot"], title=f"Cross-Domain Accuracy [{out['version']}]",
                          ylim=(0, 100))
    logging.getLogger("tapclip_tpu_torch").info("✅ Plot saved to %s", out["plot"])
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    args, cfg = parse(argv)
    return write_plot(run(args, cfg))


if __name__ == "__main__":
    main()
