"""Plot + CSV artifacts, output-fidelity compatible with the reference.

Counterpart of ``tapclip_tpu/utils/plotting.py`` (matplotlib and pandas are
imported inside the functions that use them).  Reproduces:
* the per-epoch accuracy-curve PNG (the reference's ``train.py:136-148``),
* the ``Domain,Shots,Accuracy`` CSV schema (``test_cross_domain.py:85-90``),
* the grouped cross-domain accuracy bar chart (``test_cross_domain.py:96-116``,
  ``test_cross_domain2.py:108-128``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_accuracy_curve(
    acc_list: Sequence[float],
    per_class: Dict[str, Sequence[float]],
    out_path: str,
    title: str = "Validation Accuracy per Epoch",
) -> str:
    """train.py:136-148."""
    plt = _plt()
    plt.figure(figsize=(10, 6))
    plt.plot(list(acc_list), label="Total Accuracy", linewidth=2)
    for cls, vals in per_class.items():
        plt.plot(list(vals), label=cls)
    plt.xlabel("Epoch")
    plt.ylabel("Accuracy (%)")
    plt.title(title)
    plt.grid(True)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
    return out_path


def save_results_csv(results: List[Dict], csv_path: str) -> str:
    """``Domain,Shots,Accuracy`` rows (test_cross_domain.py:85-90)."""
    import pandas as pd

    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    pd.DataFrame(results, columns=["Domain", "Shots", "Accuracy"]).to_csv(
        csv_path, index=False
    )
    return csv_path


def save_attribution_chart(
    attribution,  # [n_cls, P]
    class_names: Sequence[str],
    out_path: str,
    title: str = "Per-class context-token attribution",
) -> str:
    """Grouped bars: attribution weight of each context token per class.

    Visualizes what the attribution monitor feeds the adjustor — the
    interpretability artifact the reference computes but never plots.
    """
    plt = _plt()
    attribution = np.asarray(attribution)
    n_cls, P = attribution.shape
    x = np.arange(P)
    width = 0.8 / max(n_cls, 1)
    plt.figure(figsize=(8, 4))
    for i, name in enumerate(class_names[:n_cls]):
        plt.bar(x + i * width, attribution[i], width=width, label=name)
    plt.xticks(x + width * (n_cls - 1) / 2, [f"ctx[{j}]" for j in range(P)])
    plt.ylabel("attribution (softmax)")
    plt.title(title)
    plt.legend(fontsize=8)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
    return out_path


def save_confusion_matrix(
    cm,  # [C, C] counts, rows = true
    class_names: Sequence[str],
    out_path: str,
    title: str = "Confusion matrix",
) -> str:
    """Row-normalized heatmap with count annotations (the error-structure
    readout the reference's per-class accuracy printout can't show)."""
    plt = _plt()
    cm = np.asarray(cm)
    C = cm.shape[0]
    row = cm.sum(axis=1, keepdims=True)
    norm = cm / np.maximum(row, 1)
    plt.figure(figsize=(max(4, 0.6 * C + 2),) * 2)
    plt.imshow(norm, cmap="Blues", vmin=0.0, vmax=1.0)
    names = list(class_names)[:C]
    plt.xticks(range(C), names, rotation=45, ha="right", fontsize=8)
    plt.yticks(range(C), names, fontsize=8)
    for i in range(C):
        for j in range(C):
            if cm[i, j]:
                plt.text(j, i, str(int(cm[i, j])), ha="center", va="center",
                         fontsize=7,
                         color="white" if norm[i, j] > 0.5 else "black")
    plt.xlabel("predicted")
    plt.ylabel("true")
    plt.title(title)
    plt.colorbar(fraction=0.046)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
    return out_path


def save_saliency_overlay(
    image,  # [H, W, 3] float in [0, 1] (display-space, NOT CLIP-normalized)
    grid,  # [g, g] float in [0, 1] (utils/saliency.patch_saliency row)
    out_path: str,
    title: str = "Patch saliency (attention rollout)",
    alpha: float = 0.5,
) -> str:
    """Patch-saliency heatmap overlaid on the image (bilinear-upsampled)."""
    plt = _plt()
    image = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    grid = np.asarray(grid, np.float32)
    plt.figure(figsize=(4, 4))
    plt.imshow(image)
    plt.imshow(
        grid, cmap="jet", alpha=alpha, interpolation="bilinear",
        # Match imshow's pixel-center convention for the base image
        # ((-0.5, W-0.5, ...)); a (0, W, ...) extent would shift the heatmap
        # half a pixel right/down relative to what it annotates.
        extent=(-0.5, image.shape[1] - 0.5, image.shape[0] - 0.5, -0.5),
    )
    plt.axis("off")
    plt.title(title, fontsize=9)
    plt.tight_layout()
    plt.savefig(out_path, bbox_inches="tight")
    plt.close()
    return out_path


def save_cross_domain_bar(
    results: List[Dict],
    out_path: str,
    *,
    title: str = "Cross-Domain Accuracy (Bar Chart)",
    ylim=(0, 100),
    bar_width: float = 0.25,
) -> str:
    """Grouped bar chart (test_cross_domain2.py:108-128)."""
    import pandas as pd

    plt = _plt()
    df = pd.DataFrame(results)
    domains = df["Domain"].unique()
    shots = df["Shots"].unique()
    x = np.arange(len(domains))

    plt.figure(figsize=(10, 5))
    for i, shot_type in enumerate(shots):
        subset = df[df["Shots"] == shot_type]
        accs = subset.set_index("Domain").loc[domains]["Accuracy"].values
        plt.bar(x + i * bar_width, accs, width=bar_width, label=shot_type)
    plt.xticks(x + bar_width * (len(shots) - 1) / 2, domains)
    plt.title(title)
    plt.ylabel("Accuracy (%)")
    plt.ylim(*ylim)
    plt.grid(axis="y", linestyle="--", alpha=0.5)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
    return out_path
