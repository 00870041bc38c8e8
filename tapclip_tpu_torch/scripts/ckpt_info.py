"""Inspect any checkpoint the port reads or writes.

Counterpart of ``scripts/ckpt_info.py``.  Prints the tree structure, leaf
shapes/dtypes and parameter counts of a torch ``.pt``/``.bin`` file: an
open_clip state dict, a CLIP tree, a prompt checkpoint or a pretraining
snapshot of the port (their non-tensor fields, such as ``format`` and
``meta``, are listed and not counted).  An Orbax directory (the JAX
package's format) raises.

Usage: python -m tapclip_tpu_torch.scripts.ckpt_info <path> [--depth N]
"""

from __future__ import annotations

import argparse
import os


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _walk(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path")
    p.add_argument("--depth", type=int, default=0, help="aggregate leaves deeper than this (0 = full detail)")
    args = p.parse_args(argv)

    import torch

    if os.path.isdir(args.path):
        raise ValueError(f"{args.path} is a directory: Orbax checkpoints (the JAX package's format) are not "
                         "read by tapclip_tpu_torch; inspect .pt/.bin files")
    tree = torch.load(args.path, map_location="cpu", weights_only=True)
    if hasattr(tree, "state_dict"):
        tree = tree.state_dict()

    total = 0
    rows, fields = {}, {}
    for name, leaf in _walk(tree):
        if not torch.is_tensor(leaf):
            fields[name] = leaf
            continue
        total += leaf.numel()
        key = ".".join(name.split(".")[: args.depth]) if args.depth else name
        n, shapes = rows.get(key, (0, set()))
        rows[key] = (n + leaf.numel(), shapes | {f"{str(leaf.dtype).replace('torch.', '')}{list(leaf.shape)}"})

    print(f"torch checkpoint: {args.path}")
    for key in sorted(fields):
        text = repr(fields[key])
        print(f"  {key:60s} {text if len(text) <= 60 else text[:57] + '...'}")
    for key in sorted(rows):
        n, shapes = rows[key]
        s = next(iter(shapes)) if len(shapes) == 1 else f"{len(shapes)} shapes"
        print(f"  {key:60s} {n:>12,}  {s}")
    print(f"total parameters: {total:,} ({total * 4 / 1e6:.1f} MB f32)")
    return total


if __name__ == "__main__":
    main()
