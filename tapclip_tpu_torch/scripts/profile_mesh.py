"""One traced pretraining step of a mesh form, rank 0's view: wall ms, the device's busy ms, the largest operators.

    torchrun --nproc-per-node 4 -m tapclip_tpu_torch.scripts.profile_mesh --dp 1 --pp 2 --tp 2 --seq-parallel
    torchrun --nproc-per-node 4 -m tapclip_tpu_torch.scripts.profile_mesh --dp 2 --pp 2 --fsdp
    torchrun --nproc-per-node 4 -m tapclip_tpu_torch.scripts.profile_mesh --dp 2 --tp 2 --moe-experts 8

One rank a card over NCCL (``cuda:LOCAL_RANK``).  Each rank builds the
kernels (run ``python3 -c "from tapclip_tpu_torch.ops import _build;
_build.library()"`` once first), places a ViT-B/16 tree from seed 20 on the
``(data, pipe, model)`` mesh (MoE towers with ``--moe-experts N``, the
experts over ``model``) and runs the InfoNCE step (AdamW, every leaf
trained; with MoE towers the load-balance term too) at the global batch
``--batch`` (32): three warm-up steps, three
timed steps (host clock ended by a synchronisation), then one step under
``torch.profiler``.  Rank 0 prints the card's name and power limit, the
times, the device's busy share (the sum of the operators' self device time
over the traced wall time) and the operators with the most self host time
and self device time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for axis in ("dp", "pp", "tp"):
        p.add_argument(f"--{axis}", type=int, default=1)
    p.add_argument("--seq-parallel", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--moe-experts", type=int, default=0, help="MoE towers with N experts a block")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--rows", type=int, default=25, help="operators printed per table")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.config import VIT_B_16
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.parallel.mesh import make_mesh
    from tapclip_tpu_torch.parallel.sharding import shard_batch, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl", init_method="env://")
    try:
        _build.library()
        mesh = make_mesh(dp=args.dp, tp=args.tp, pp=args.pp)
        cfg = VIT_B_16.replace(dtype=args.dtype, moe_experts=args.moe_experts)
        tree = clip_model.init_clip_params(torch.Generator(device="cuda").manual_seed(20), cfg)
        local = shard_params(tree, mesh, fsdp=args.fsdp)
        del tree
        opt = P.PretrainOptimizer(P.set_trainable(local), lr=1e-4, weight_decay=0.1)
        step = P.make_pretrain_step(cfg, opt, mesh=mesh, seq_parallel=args.seq_parallel, fsdp=args.fsdp)
        rng = np.random.default_rng(30)
        images = rng.integers(0, 256, (args.batch, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
        ids = rng.integers(1, cfg.vocab_size - 2, (args.batch, cfg.context_length)).astype(np.int32)
        ids[np.arange(args.batch), rng.integers(4, cfg.context_length, args.batch)] = cfg.vocab_size - 1
        x, t = shard_batch((images, ids), mesh)
        for _ in range(3):
            step(local, x, t)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(local, x, t)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(local, x, t)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        if dist.get_rank() == 0:
            card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True, check=True).stdout.strip()
            ev = prof.key_averages()
            busy = sum(e.self_device_time_total for e in ev) / 1e3
            print(f"mesh {dict(mesh.shape)} seq_parallel={args.seq_parallel} fsdp={args.fsdp} "
                  f"moe_experts={args.moe_experts} {args.dtype}, batch "
                  f"{args.batch}, rank 0 ({card}): ms a step {[round(v, 1) for v in ms]}, traced {wall:.1f} ms, "
                  f"device busy {busy:.1f} ms ({busy / wall:.2f})", flush=True)
            for key in ("self_cpu_time_total", "self_device_time_total"):
                print(ev.table(sort_by=key, row_limit=args.rows, max_name_column_width=60), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
