"""End-to-end tour of tapclip_tpu_torch on synthetic data (no weights needed).

Counterpart of ``examples/quickstart.py``: the lifecycle a user strings
together, in the same nine steps: few-shot prompt tuning -> evaluation ->
adding an unseen class -> checkpointing -> bulk featurization -> similarity
search -> linear probe -> attribution + saliency -> batch predict -> an
ahead-of-time export (``torch.export``, loaded without the model code).
Runs on the card's kernels by default; ``--device cpu`` runs the kernels'
plain versions, in about a minute with the tiny preset.  The synthetic
data, checkpoint, features and export go to a temporary directory that is
removed on exit.

Run: python -m tapclip_tpu_torch.examples.quickstart [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="tapclip_quickstart_") as tmp:
        return tour(tmp, args.device)


def tour(tmp, device):
    """The nine steps, writing every file under ``tmp``."""
    from tapclip_tpu_torch.config import TINY_TEST
    from tapclip_tpu_torch.data.imagefolder import get_dataloaders
    from tapclip_tpu_torch.data.preprocess import make_preprocess
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.utils.eval_metrics import evaluate_accuracy

    cfg = TINY_TEST
    classes = ["Backpack", "Pen", "Monitor"]

    # -- data: a color-separable synthetic ImageFolder --------------------
    from PIL import Image

    rng = np.random.default_rng(0)
    colors = [(200, 40, 40), (40, 200, 40), (40, 40, 200)]
    for name, c in zip(classes, colors):
        d = os.path.join(tmp, "data", name)
        os.makedirs(d)
        for i in range(10):
            arr = np.clip(np.array(c)[None, None] + rng.normal(0, 25, (cfg.image_size,) * 2 + (3,)),
                          0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"))
    train_loader, val_loader = get_dataloaders(
        os.path.join(tmp, "data"), classes, num_shots=5, batch_size=8,
        preprocess=make_preprocess(cfg.image_size), seed=0, verbose=False,
    )

    # -- model: random tiny CLIP + attribution-guided prompts -------------
    params = clip_model.init_clip_params(torch.Generator().manual_seed(0), cfg, device=device)
    model = FullModel(classes, params, cfg)
    acc0 = evaluate_accuracy(model, val_loader, verbose=False)
    print(f"[1] zero-init accuracy: {acc0:.2f}%")

    # -- few-shot prompt tuning (the reference train.py loop) -------------
    from tapclip_tpu_torch.config import TrainConfig
    from tapclip_tpu_torch.trainer import fit_prompt_model

    fit = fit_prompt_model(
        model, train_loader, val_loader,
        TrainConfig(epochs=15, lr=5e-2, batch_size=8), verbose=False,
    )
    acc1 = evaluate_accuracy(model, val_loader, verbose=False)
    print(f"[2] after {len(fit.loss_history)} epochs of prompt tuning: "
          f"{acc1:.2f}% (loss {fit.loss_history[-1]:.3f})")

    # -- live class add ----------------------------------------------------
    model.add_class_prompt("Clipboards")
    print(f"[3] added unseen class: {model.class_names}")

    # -- checkpoint round trip --------------------------------------------
    from tapclip_tpu_torch.utils.checkpoint import save_prompt_checkpoint

    ckpt = save_prompt_checkpoint(os.path.join(tmp, "prompts.pt"), trainable=model.trainable,
                                  bank=model.prompt_learner.bank, class_names=model.class_names)
    print(f"[4] checkpoint saved: {ckpt}")

    # -- bulk featurization + similarity search ---------------------------
    from tapclip_tpu_torch.featurize import main as featurize_main
    from tapclip_tpu_torch.search import main as search_main

    feats_dir = os.path.join(tmp, "feats")
    featurize_main(["--image-root", os.path.join(tmp, "data"), "--out", feats_dir, "--preset", "tiny",
                    "--batch-size", "8", "--device", device])
    results = search_main(["--index", feats_dir, "--row", "0", "-k", "3", "--preset", "tiny",
                           "--device", device])
    print(f"[5] search top hit for row 0: {results[0]['meta']}")

    # -- linear probe ------------------------------------------------------
    from tapclip_tpu_torch.linear_probe import main as probe_main

    probe = probe_main(["--train-root", os.path.join(tmp, "data"), "--preset", "tiny", "--batch-size", "8",
                        "--steps", "200", "--device", device])
    print(f"[6] linear-probe train accuracy: {probe['train_acc']:.2%}")

    # -- explainability: attribution + patch saliency ----------------------
    from tapclip_tpu_torch.utils.saliency import patch_saliency

    images, _, _ = next(iter(val_loader))
    with torch.no_grad():
        out = model(images[:2])
    attr = out["attribution"].float().cpu().numpy()
    grid = patch_saliency(model.clip_params, cfg, torch.as_tensor(np.asarray(images[:2]), device=model.device))
    print(f"[7] attribution {attr.shape} rows sum {attr.sum(-1)[:2].round(3)}; saliency grid {grid.shape}")

    # -- batch predict over an unlabeled folder (tuned prompts) ------------
    from tapclip_tpu_torch.predict import main as predict_main

    preds = predict_main(["--image-root", os.path.join(tmp, "data"), "--out", os.path.join(tmp, "preds"),
                          "--preset", "tiny", "--classes", *model.class_names, "--ckpt", ckpt,
                          "--batch-size", "8", "--top-k", "2", "--device", device])
    print(f"[8] batch predict: {preds['n']} rows -> {preds['csv']}")

    # -- ahead-of-time export (torch.export; loads without the model code) --
    from tapclip_tpu_torch.utils.model_export import export_model, load_exported

    exp_dir = export_model(os.path.join(tmp, "export"), model.clip_params, cfg, model.prompt_cfg,
                           model.trainable, model.prompt_learner.bank, batch=2, functions=("encode_image",))
    fns = load_exported(exp_dir)
    with torch.no_grad():
        emb = fns["encode_image"](model.clip_params, torch.as_tensor(np.asarray(images[:2]), device=model.device))
    print(f"[9] exported encode_image rehydrated: {tuple(emb.shape)} unit-norm features")

    print("quickstart complete.")
    return {"acc0": acc0, "acc1": acc1, "probe": probe["train_acc"], "n_preds": preds["n"], "embedding": emb}


if __name__ == "__main__":
    main()
