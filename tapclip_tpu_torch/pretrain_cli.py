"""CLIP contrastive pretraining driver.

Counterpart of ``tapclip_tpu/pretrain_cli.py``: trains the CLIP towers with
InfoNCE or SigLIP (``pretrain.py``) on (image, caption) pairs, on one
device.  Captions come from an ImageFolder tree's class names through a
template ("a photo of a {class}"), from webdataset shards (``--shard-dir``)
or from a CSV/TSV manifest (``--csv-path``).  Options: GradCache
accumulation (``--accum-full-negatives``) or gradient accumulation
(``--accum-steps``), LoRA (``--lora-rank``), BitFit, LiT locks, distillation
from a frozen teacher, an EMA of the tree, patch dropout, VPT, MoE towers
(``--moe-experts N``: Switch top-1 expert MLPs in both towers, the
load-balance term in the objective), on-device augmentation, remat, a
warmup + cosine schedule and global-norm clipping.
Each epoch appends a row to ``csv/pretrain_metrics.csv``: the mean loss,
then the held-out contrastive loss and Recall@K (``--val-shard-dir``) and
the zero-shot accuracy (``--zeroshot-val-root``), of the EMA tree too.

The final tree is ``models/clip_pretrained.pt`` (and
``clip_pretrained_ema.pt``), a ``utils.checkpoint.save_clip_tree`` file that
every driver's ``--pretrained`` reads; ``--save-every`` snapshots resume
with ``--resume`` (the epoch numbering continues).  Runs on ``cuda`` unless
``--device cpu`` is given; asking for ``cuda`` without a card raises.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
environment; NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) the
ranks form a ``(data, model)`` mesh, or ``(data, pipe, model)`` with
``--pp``: ``--dp`` (-1: every rank divided by ``--tp * --pp``), ``--tp``
(Megatron tensor parallelism in both towers' blocks; ``--seq-parallel``
adds Megatron-SP) and ``--pp`` (GPipe stages over the blocks,
``--pp-microbatches`` M, default ``2 * pp``); ``--fsdp`` cuts the big
weights and their AdamW moments over ``data`` (ZeRO; on one rank it warns
and is ignored, as in the JAX CLI).  Every rank reads the same stream and
keeps its rows of each global batch (``--batch-size`` is the global batch),
the negatives span it, and rank 0 writes the logs, the CSV and the ``.pt``
trees, gathered whole (``parallel.sharding.gather_params``: the layout of a
one-device run); ``--resume`` loads a whole tree and shards it.  Under
``--pp`` or ``--fsdp`` the validation and the zero-shot readout run on the
whole tree, gathered on every rank.  Without ``torchrun`` the run is one
process, as before.  ``--moe-experts`` runs under ``--dp`` (with
``--fsdp`` too) and ``--tp`` (expert parallelism: a rank holds ``E / tp``
experts of each bank), LoRA and distillation under ``--tp`` (the adapters
and ``kd_proj`` replicated, the teacher cut with its own config), and
``--vpt-deep`` under ``--seq-parallel``.  ``--sharded-snapshot``: every
rank writes its own shards at ``--save-every`` (a directory,
``utils.checkpoint.save_sharded_snapshot``), and ``--resume`` of such a
directory restores after placement, into this run's layout, on any
``(dp, pp, tp, fsdp)``.  The JAX CLI's refusals hold: ``--fsdp`` with
``--lora-rank`` or ``--pp``, ``--distill-teacher`` and ``--lora-rank`` with
``--pp`` (``--fsdp``), ``--distill-teacher`` with ``--moe-experts``, MoE
towers with ``--pp``, GradCache with ``--accum-steps`` / ``--pp`` /
``--fsdp`` / ``--seq-parallel``, a snapshot resumed with the other format's
flag.

Usage:
    python -m tapclip_tpu_torch.pretrain_cli --data-root data/OfficeHome/Real_World \\
        --model ViT-B-16 --epochs 5 --batch-size 256 --lr 1e-4
    python -m tapclip_tpu_torch.pretrain_cli --preset tiny --synthetic-data --epochs 2 --device cpu
    torchrun --nproc-per-node 2 -m tapclip_tpu_torch.pretrain_cli --preset tiny --synthetic-data --dp 2
    torchrun --nproc-per-node 4 -m tapclip_tpu_torch.pretrain_cli --preset tiny --synthetic-data \
        --pp 2 --tp 2 --seq-parallel
    torchrun --nproc-per-node 2 -m tapclip_tpu_torch.pretrain_cli --preset tiny --synthetic-data \
        --tp 2 --moe-experts 4
    torchrun --nproc-per-node 4 -m tapclip_tpu_torch.pretrain_cli --preset tiny --synthetic-data \
        --dp 2 --tp 2 --fsdp --sharded-snapshot --save-every 1 --epochs 1
    python -m tapclip_tpu_torch.pretrain_cli --preset tiny --synthetic-data --epochs 2 \
        --sharded-snapshot --resume OUT/models/pretrain_snapshot_e000001
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from tapclip_tpu_torch.config import MODEL_PRESETS, preset
from tapclip_tpu_torch.train import apply_overrides, build_argparser, build_model, maybe_synthetic_root


def _append_metrics_row(path: str, row: dict) -> None:
    """Append one epoch's row to the metrics CSV; a key not seen before
    rewrites the file with the union header, so every row stays aligned."""
    rows = []
    fields: list = []
    if os.path.exists(path):
        with open(path, newline="") as f:
            r = csv.DictReader(f)
            fields = list(r.fieldnames or [])
            rows = list(r)
    new_fields = fields + [k for k in row if k not in fields]
    rows.append({k: row.get(k, "") for k in new_fields})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=new_fields, restval="")
        w.writeheader()
        w.writerows(rows)


def step_generator(seed: int, gstep: int, device) -> torch.Generator:
    """The per-step generator of the stochastic knobs (augmentation, patch
    dropout): seeded by ``(seed, gstep)``, so a resumed run draws what the
    uninterrupted run would have."""
    state = np.random.SeedSequence([seed + 7, gstep]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def build_parser():
    p = build_argparser(__doc__)
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel mesh size under torchrun (-1: every rank divided by --tp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size under torchrun (Megatron in both towers' blocks)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages under torchrun: the block stacks over a 'pipe' mesh axis "
                        "(GPipe schedule, parallel/pipeline.py)")
    p.add_argument("--pp-microbatches", type=int, default=0, help="GPipe microbatch count (default 2*pp)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="Megatron-SP between blocks (requires --tp > 1); the same arithmetic")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO/FSDP: cut params + AdamW moments over the data axis (1/dp each); weights gather "
                        "at their use, grads reduce-scatter. Not with --pp or --lora-rank")
    p.add_argument("--sharded-snapshot", action="store_true",
                   help="--save-every writes each rank's own shards (a directory; nothing gathered) and --resume "
                        "reads such a directory into this run's layout, on any mesh")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an EMA of the whole tree (e.g. 0.999), saved beside the final tree as "
                        "clip_pretrained_ema.pt; full-tree runs only (ignored with --lora-rank)")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="train rank-r LoRA adapters on the tower GEMMs instead of the tree (peft.py); "
                        "the final tree is the merged weights")
    p.add_argument("--lora-alpha", type=float, default=16.0, help="LoRA scaling (merged delta alpha/r * A@B)")
    p.add_argument("--bitfit", action="store_true",
                   help="BitFit: train only the bias terms (+ logit_scale / logit_bias); the rest stays "
                        "bit-identical")
    p.add_argument("--scan-unroll", type=int, default=0,
                   help="the JAX package's block-scan unroll: a compile setting with no eager meaning, "
                        "accepted and ignored")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="N > 0: Switch top-1 mixture-of-experts MLPs with N experts in both towers "
                        "(models/moe.py); a fresh tree, or a CLIP tree .pt saved with the same N")
    p.add_argument("--distill-teacher", default=None,
                   help="distill from a frozen teacher: a CLIP tree .pt of this CLI or an open_clip "
                        ".bin/.pt (distill.py)")
    p.add_argument("--teacher-model", default=None, help="teacher preset (default: the student's --model)")
    p.add_argument("--kd-temp", type=float, default=1.0, help="distillation temperature")
    p.add_argument("--task-weight", type=float, default=1.0, help="weight of the student's own InfoNCE")
    p.add_argument("--kd-weight", type=float, default=1.0, help="weight of KL(teacher || student)")
    p.add_argument("--feat-weight", type=float, default=1.0, help="weight of the feature mimicry")
    p.add_argument("--shard-dir", default=None,
                   help="stream (image, caption) pairs from webdataset .tar shards (data/shards.py)")
    p.add_argument("--shuffle-buffer", type=int, default=1000, help="sample shuffle buffer for --shard-dir")
    p.add_argument("--fast-decode", action="store_true",
                   help="DCT-scaled JPEG decode in the native pipeline (near- but not bit-identical pixels)")
    p.add_argument("--csv-path", default=None,
                   help="CSV/TSV manifest of (image path, caption) rows (data/csv_dataset.py); relative "
                        "paths resolve against its directory")
    p.add_argument("--csv-img-key", default="filepath", help="image-path column")
    p.add_argument("--csv-caption-key", default="title", help="caption column")
    p.add_argument("--csv-sep", default="\t", help="column delimiter (default: tab)")
    p.add_argument("--zeroshot-val-root", default=None,
                   help="labelled ImageFolder for the zero-shot accuracy every --zeroshot-frequency epochs")
    p.add_argument("--zeroshot-frequency", type=int, default=1, help="zero-shot every N epochs")
    p.add_argument("--val-shard-dir", default=None,
                   help="held-out shards: contrastive val loss + Recall@1/5/10 every epoch (EMA too)")
    p.add_argument("--val-samples", type=int, default=1024, help="cap on validation pairs per epoch")
    p.add_argument("--template", default="a photo of a {}")
    p.add_argument("--schedule", default="constant", choices=["constant", "cosine"],
                   help="LR schedule: constant, or linear warmup + cosine decay to zero over the run")
    p.add_argument("--warmup-steps", type=int, default=0, help="linear warmup steps (cosine schedule)")
    p.add_argument("--lock-image-tower", action="store_true",
                   help="LiT: freeze the image tower (VPT tokens still train)")
    p.add_argument("--lock-text-tower", action="store_true", help="freeze the text tower")
    p.add_argument("--lock-unlocked-groups", type=int, default=0,
                   help="with --lock-*-tower: keep the last N groups of [stem, blocks.., head] trainable")
    p.add_argument("--grad-clip", type=float, default=0.0, help="global-norm gradient clipping (0 = off)")
    p.add_argument("--remat", default=None, choices=["none", "dots", "full"],
                   help="per-block gradient checkpointing (CLIPConfig.remat; 'dots' recomputes the whole "
                        "block, as 'full')")
    p.add_argument("--loss", default="infonce", choices=["infonce", "siglip"], help="contrastive objective")
    p.add_argument("--patch-dropout", type=float, default=0.0,
                   help="FLIP masking: drop this fraction of the vision patches per sample per step")
    p.add_argument("--vpt-tokens", type=int, default=0, help="VPT: N learned prompt tokens in the vision sequence")
    p.add_argument("--vpt-deep", action="store_true", help="VPT-Deep: fresh prompts at every block input")
    p.add_argument("--augment", action="store_true", help="on-device random-resized crop of every batch")
    p.add_argument("--aug-scale-min", type=float, default=0.9, help="lower bound of the crop-area fraction")
    p.add_argument("--hflip", type=float, default=0.0, help="horizontal-flip probability under --augment")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="one update every K micro-batches (negatives stay per micro-batch)")
    p.add_argument("--accum-full-negatives", type=int, default=1,
                   help="GradCache: one update every K micro-batches with negatives over the K x batch")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    _refuse_combinations(args)
    if args.resume:  # before anything is built: a snapshot of the other format's flag exits by name
        from tapclip_tpu_torch.utils.checkpoint import snapshot_format

        _check_snapshot_format(args.resume, args.sharded_snapshot, snapshot_format(args.resume))
    cfg = apply_overrides(preset(args.preset), args)
    if args.remat or args.moe_experts or args.patch_dropout or args.vpt_tokens or args.vpt_deep:
        model_cfg = cfg.model
        if args.remat:
            model_cfg = model_cfg.replace(remat=args.remat)
        if args.moe_experts:
            model_cfg = model_cfg.replace(moe_experts=args.moe_experts)
        if args.patch_dropout:
            model_cfg = model_cfg.replace(patch_dropout=args.patch_dropout)
        if args.vpt_tokens:
            model_cfg = model_cfg.replace(vpt_tokens=args.vpt_tokens, vpt_deep=args.vpt_deep)
        elif args.vpt_deep:
            raise ValueError("--vpt-deep requires --vpt-tokens N")
        cfg = dataclasses.replace(cfg, model=model_cfg)

    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader
    from tapclip_tpu_torch.data.prefetch import background_iter
    from tapclip_tpu_torch.featurize import resolve_device
    from tapclip_tpu_torch.parallel import sharding
    from tapclip_tpu_torch.parallel.collectives import model_group_of, tensor_parallel
    from tapclip_tpu_torch.utils import checkpoint as ckpt_io
    from tapclip_tpu_torch.utils.logging_utils import generate_output_paths, maybe_profile, setup_logging
    from tapclip_tpu_torch.zero_shot import class_name_to_text

    dev = resolve_device(args.device)
    mesh, owns_group = _mesh(args, dev)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    lead = mesh is None or mesh.rank == 0
    tp = mesh.tp if mesh is not None else 1
    fsdp = args.fsdp and mesh is not None
    cut = mesh is not None and (tp > 1 or mesh.pp > 1 or fsdp)  # the tree is a rank's shards
    if mesh is not None and cfg.train.batch_size % mesh.dp:
        raise ValueError(f"--batch-size {cfg.train.batch_size} (the global batch) must divide by dp={mesh.dp}")
    paths = _output_paths(lead, cfg, generate_output_paths)
    log = setup_logging(os.path.join(paths["log_dir"], "pretrain.log") if lead else None)
    if not lead:
        log.setLevel(logging.WARNING)
    if mesh is not None:
        log.info("mesh: %s over %d ranks (backend %s)", dict(mesh.shape), mesh.world, mesh.backend)
    if args.fsdp and mesh is None:
        log.warning("--fsdp ignored: single device, nothing to shard")

    model, preprocess = build_model(cfg, bpe_path=args.bpe_path, device=dev)
    params = model.clip_params
    tokenizer = model.tokenizer
    del model, preprocess  # the loaders decode at the model's size themselves

    def tokenize(caps):
        return np.asarray(tokenizer.tokenize(caps, cfg.model.context_length))

    u8 = "uint8" if args.uint8_transfer else "float32"
    caption_ids = None
    if args.shard_dir and args.csv_path:
        raise ValueError("--shard-dir and --csv-path are exclusive")
    if args.csv_path:
        from tapclip_tpu_torch.data.csv_dataset import CsvLoader

        loader = CsvLoader(args.csv_path, cfg.train.batch_size, tokenize=tokenize, image_size=cfg.model.image_size,
                           img_key=args.csv_img_key, caption_key=args.csv_caption_key, sep=args.csv_sep,
                           seed=cfg.train.seed, fast_decode=args.fast_decode, output_dtype=u8)
        log.info("streaming %d image-text pairs from %s", loader.num_samples, args.csv_path)
    elif args.shard_dir:
        from tapclip_tpu_torch.data.shards import ShardLoader, list_shards

        loader = ShardLoader(list_shards(args.shard_dir), cfg.train.batch_size, tokenize=tokenize,
                             image_size=cfg.model.image_size, shuffle_buffer=args.shuffle_buffer,
                             seed=cfg.train.seed, fast_decode=args.fast_decode, output_dtype=u8)
        log.info("streaming %d image-text pairs from %d tar shards (shuffle buffer %d)", loader.num_samples,
                 len(loader.shards), args.shuffle_buffer)
    else:
        data_root = maybe_synthetic_root(cfg, args.synthetic_data)
        index = ImageFolderIndex.scan(data_root)
        idx_to_name = {v: k for k, v in index.class_to_idx.items()}
        caption_ids = {raw: tokenize([args.template.format(class_name_to_text(name))])[0]
                       for raw, name in idx_to_name.items()}
        loader = Loader(index.samples, cfg.train.batch_size, shuffle=True, seed=cfg.train.seed,
                        image_size=cfg.model.image_size, drop_remainder=True, output_dtype=u8)
        log.info("pretraining on %d images, %d classes", len(index.samples), len(idx_to_name))

    teacher_params = teacher_cfg = None
    if args.distill_teacher:
        if args.lora_rank > 0:
            raise ValueError("--distill-teacher trains the full student tree; it does not compose with --lora-rank")
        if args.loss == "siglip":
            raise ValueError("--distill-teacher uses the InfoNCE task term; drop --loss siglip")
        from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint

        teacher_cfg = MODEL_PRESETS[args.teacher_model or cfg.model.name]
        teacher_params = load_openclip_checkpoint(args.distill_teacher, teacher_cfg, device=dev)
        log.info("distillation: frozen %s teacher from %s (tau=%.2f, w_task=%.2f, w_kd=%.2f, w_feat=%.2f)",
                 args.teacher_model or cfg.model.name, args.distill_teacher, args.kd_temp, args.task_weight,
                 args.kd_weight, args.feat_weight)
    lr = cfg.train.lr
    if args.schedule == "cosine":
        total_steps = max(len(loader) * cfg.train.epochs, 1)
        lr = P.warmup_cosine_decay_schedule(0.0, cfg.train.lr, min(args.warmup_steps, total_steps - 1),
                                            total_steps, 0.0)
        log.info("cosine schedule: peak %.2e, %d warmup of %d total steps", cfg.train.lr, args.warmup_steps,
                 total_steps)
    trainable = None
    if args.bitfit:
        if args.lora_rank:
            raise ValueError("--bitfit and --lora-rank are both PEFT restrictions of the trainable set; pick one")
        if args.lock_image_tower or args.lock_text_tower:
            raise ValueError("--bitfit already freezes every non-bias leaf; drop --lock-*-tower")
        log.info("BitFit: training bias terms + extras only")
    if args.lock_image_tower or args.lock_text_tower:
        if args.lora_rank:
            raise ValueError("--lock-*-tower composes oddly with --lora-rank (adapters already restrict the "
                             "trainable set); pick one")
        log.info("locked towers: image=%s text=%s unlocked_groups=%d (LiT-style)", args.lock_image_tower,
                 args.lock_text_tower, args.lock_unlocked_groups)
    if args.loss == "siglip":
        params = P.add_siglip_params(params)
    if (args.patch_dropout > 0 or args.augment) and (args.lora_rank > 0 or args.distill_teacher):
        raise ValueError("--patch-dropout/--augment are wired for the full-tree pretraining step only (not "
                         "--lora-rank/--distill-teacher yet)")
    augment = None
    if args.augment:
        from tapclip_tpu_torch.data.augment import AugmentConfig

        augment = AugmentConfig(scale=(args.aug_scale_min, 1.0), hflip=args.hflip)
    if args.accum_full_negatives > 1 and (args.lora_rank > 0 or teacher_params is not None):
        raise ValueError("--accum-full-negatives is wired for the full-tree pretraining step only (not "
                         "--lora-rank/--distill-teacher)")

    lora = None
    if args.lora_rank > 0:
        from tapclip_tpu_torch.peft import init_lora_params, lora_param_count

        lora = init_lora_params(torch.Generator(device=dev).manual_seed(cfg.train.seed + 1), params,
                                rank=args.lora_rank)
        log.info("LoRA fine-tuning: rank %d, %d adapter params", args.lora_rank, lora_param_count(lora))
    elif teacher_params is not None:
        from tapclip_tpu_torch.distill import init_distill_params

        params = init_distill_params(torch.Generator(device=dev).manual_seed(cfg.train.seed + 2), params,
                                     cfg.model.embed_dim, teacher_cfg.embed_dim)

    start_epoch, gstep, opt_state = 1, 0, None
    if args.resume and not args.sharded_snapshot:
        snap = ckpt_io.restore_pretrain_snapshot(args.resume)
        tree = P.map_tree(lambda t: t.to(dev), snap["params"])
        if lora is not None:
            lora = tree
        else:
            params = tree
        opt_state = snap["opt_state"]
        if cut and lora is None:  # a whole tree's moments, cut as its leaves are (the adapters: replicated)
            opt_state = sharding.shard_opt_state(opt_state, mesh, fsdp, params=tree)
        start_epoch, gstep = int(snap["epoch"]) + 1, int(snap["gstep"])
        _resume_loader(loader, args, start_epoch)
        log.info("resumed from %s (epoch %d)", args.resume, start_epoch - 1)

    if cut:  # this rank's stage, heads and hidden columns (and FSDP shards); the rest replicated
        params = sharding.shard_params(params, mesh, fsdp=fsdp)
        if teacher_params is not None:
            teacher_params = sharding.shard_params(teacher_params, mesh)
    if lora is not None:
        P.set_trainable(params, {path: False for path, _ in P.named_leaves(params)})
        leaves = P.set_trainable(lora)
    elif args.bitfit:
        leaves = P.set_trainable(params, P.bitfit_trainable(params))
    elif args.lock_image_tower or args.lock_text_tower:
        leaves = P.set_trainable(params, P.lock_tower_trainable(
            params, lock_image=args.lock_image_tower, lock_text=args.lock_text_tower,
            unlocked_groups=args.lock_unlocked_groups))
    else:
        leaves = P.set_trainable(params)
    optimizer = P.PretrainOptimizer(leaves, lr=lr, weight_decay=cfg.train.weight_decay, grad_clip=args.grad_clip,
                                    accum_steps=args.accum_steps)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    if args.resume and args.sharded_snapshot:
        # Deferred past placement, as the JAX CLI's: the snapshot restores into this run's layout, one leaf at a time.
        start_epoch, gstep = _restore_sharded(args.resume, lora if lora is not None else params, optimizer, mesh,
                                              fsdp, lora is not None, ckpt_io, log)
        _resume_loader(loader, args, start_epoch)
    if lora is not None:
        from tapclip_tpu_torch.peft import make_lora_pretrain_step, merge_lora

        step = make_lora_pretrain_step(cfg.model, optimizer, loss=args.loss, alpha=args.lora_alpha, mesh=mesh)
    elif teacher_params is not None:
        from tapclip_tpu_torch.distill import make_distill_step

        step = make_distill_step(cfg.model, teacher_cfg, optimizer, tau=args.kd_temp, w_task=args.task_weight,
                                 w_kd=args.kd_weight, w_feat=args.feat_weight, mesh=mesh)
    elif args.accum_full_negatives > 1:
        step = P.make_accum_pretrain_step(cfg.model, optimizer, args.accum_full_negatives, loss=args.loss,
                                          augment=augment, mesh=mesh)
    else:
        step = P.make_pretrain_step(cfg.model, optimizer, loss=args.loss, augment=augment, mesh=mesh,
                                    pp_microbatches=args.pp_microbatches, seq_parallel=args.seq_parallel, fsdp=fsdp)

    ema_params = ema_update = None
    if args.ema_decay > 0 and lora is None:
        ema_params = P.detached_copy(params)
        ema_update = P.make_ema_update(args.ema_decay)
        log.info("EMA tracking enabled (decay %.4f)", args.ema_decay)

    validate = val_loader = None
    if args.val_shard_dir:
        from tapclip_tpu_torch.data.shards import ShardLoader, list_shards

        val_loader = ShardLoader(list_shards(args.val_shard_dir), cfg.train.batch_size, tokenize=tokenize,
                                 image_size=cfg.model.image_size, shuffle_buffer=1, seed=cfg.train.seed,
                                 output_dtype=u8)
        validate = P.make_validation_fn(cfg.model)
        log.info("validation: %d held-out pairs (cap %d per epoch)", val_loader.num_samples, args.val_samples)
    zs_index = zs_loader = None
    if args.zeroshot_val_root:
        zs_index = ImageFolderIndex.scan(args.zeroshot_val_root)
        zs_loader = Loader(zs_index.samples, cfg.train.batch_size, shuffle=False, image_size=cfg.model.image_size,
                           output_dtype=u8)
        log.info("zero-shot validation: %d images, %d classes (every %d epoch(s))", len(zs_index.samples),
                 len(zs_index.classes), max(1, args.zeroshot_frequency))

    def effective(tree):  # LoRA runs evaluate the merged weights
        return merge_lora(tree, lora, alpha=args.lora_alpha, mesh=mesh) if lora is not None else tree

    def whole(tree):  # the one-device layout, gathered over the mesh (every rank calls it)
        return sharding.gather_params(tree, mesh, fsdp=fsdp) if cut else tree

    # Under --pp / --fsdp a rank's tree is not a tower it can run alone: the readouts take the whole tree.
    readout_whole = mesh is not None and (mesh.pp > 1 or fsdp)
    tp_group = None if readout_whole else model_group_of(mesh)

    def run_validation(tree, tag=""):
        val_loader.restore({"epoch": 0, "shards_done": 0})  # the same subset every epoch
        with tensor_parallel(tp_group):  # every rank runs it: its blocks' collectives
            vloss, r = validate(tree, iter(val_loader), args.val_samples)
        log.info("[Epoch %d] val%s loss: %.4f | i2t R@1/5/10 %.3f/%.3f/%.3f | t2i R@1/5/10 %.3f/%.3f/%.3f",
                 epoch, tag, vloss, r["i2t_r@1"], r["i2t_r@5"], r["i2t_r@10"], r["t2i_r@1"], r["t2i_r@5"],
                 r["t2i_r@10"])
        return {"loss": vloss, **r}

    def zs_acc(tree):
        from tapclip_tpu_torch.zero_shot import build_zero_shot_classifier, evaluate_zero_shot

        with tensor_parallel(tp_group):
            clf = build_zero_shot_classifier(tree, cfg.model, zs_index.classes, tokenizer)
            return evaluate_zero_shot(tree, cfg.model, clf, iter(zs_loader))

    stochastic = args.patch_dropout > 0 or args.augment
    if args.patch_dropout > 0:
        log.info("patch dropout: %.2f of vision patches per step", args.patch_dropout)
    if args.augment:
        log.info("on-device augmentation: crop scale (%.2f, 1.0), hflip %.2f", args.aug_scale_min, args.hflip)
    accum_k = args.accum_full_negatives
    snap_base = os.path.join(paths["model_dir"], "pretrain_snapshot")
    history, val_history = [], []
    with maybe_profile(args.profile_dir):
        for epoch in range(start_epoch, cfg.train.epochs + 1):
            losses, macro = [], []
            for item in background_iter(loader):
                if caption_ids is None:
                    images, ids = item
                else:
                    images, labels, _ = item
                    ids = np.stack([caption_ids[int(label)] for label in labels])
                if accum_k > 1:  # the macro batch gathers on the host; a partial one drops at the epoch's end
                    macro.append((np.asarray(images), np.asarray(ids)))
                    if len(macro) < accum_k:
                        continue
                    images, ids = np.concatenate([m[0] for m in macro]), np.concatenate([m[1] for m in macro])
                    macro = []
                if mesh is not None:  # this rank's rows of the global batch
                    images, ids = (sharding.shard_micro_batches((images, ids), mesh, accum_k) if accum_k > 1
                                   else sharding.shard_batch((images, ids), mesh))
                if lora is not None:
                    m = step(params, lora, images, ids)
                elif teacher_params is not None:
                    m = step(params, teacher_params, images, ids)
                elif stochastic:
                    m = step(params, images, ids, step_generator(cfg.train.seed, gstep, dev))
                    gstep += 1
                else:
                    m = step(params, images, ids)
                if ema_update is not None:
                    ema_update(ema_params, params)
                losses.append(m["loss"])
            avg = float(torch.stack(losses).mean()) if losses else float("nan")
            history.append(avg)
            log.info("[Epoch %d] contrastive loss: %.4f", epoch, avg)
            row = {"epoch": epoch, "loss": round(avg, 6), "skipped_images": getattr(loader, "skipped", 0)}
            if validate is not None:
                entry = run_validation(whole(effective(params)) if readout_whole else effective(params))
                if ema_params is not None:
                    entry["ema"] = run_validation(whole(ema_params) if readout_whole else ema_params, tag="[ema]")
                val_history.append(entry)
                row.update({"val_loss": round(entry["loss"], 6),
                            **{k: round(v, 4) for k, v in entry.items() if k.startswith(("i2t_", "t2i_"))}})
            if zs_loader is not None and epoch % max(1, args.zeroshot_frequency) == 0:
                acc = zs_acc(whole(effective(params)) if readout_whole else effective(params))
                row["zeroshot_acc"] = round(acc, 4)
                msg = f"[Epoch {epoch}] zero-shot val accuracy: {acc:.2f}%"
                if ema_params is not None:
                    ema_acc = zs_acc(whole(ema_params) if readout_whole else ema_params)
                    row["zeroshot_acc_ema"] = round(ema_acc, 4)
                    msg += f" | ema {ema_acc:.2f}%"
                log.info(msg)
            if lead:
                _append_metrics_row(os.path.join(paths["csv_dir"], "pretrain_metrics.csv"), row)
            if args.save_every and epoch % args.save_every == 0:
                # The previous snapshot goes only once the new one is in place.
                opt_sd = optimizer.state_dict()
                if args.sharded_snapshot:  # every rank its own shards, nothing gathered
                    new_snap = ckpt_io.save_sharded_snapshot(
                        f"{snap_base}_e{epoch:06d}", params=params if lora is None else lora, opt_state=opt_sd,
                        epoch=epoch, gstep=gstep, mesh=mesh, fsdp=fsdp, lora=lora is not None)
                else:
                    new_snap = os.path.abspath(f"{snap_base}_e{epoch:06d}.pt")
                    if cut and lora is None:
                        opt_sd = sharding.gather_opt_state(opt_sd, mesh, params, fsdp)
                    snap_tree = whole(params) if lora is None else lora
                    if lead:
                        ckpt_io.save_pretrain_snapshot(new_snap, params=snap_tree, opt_state=opt_sd, epoch=epoch,
                                                       gstep=gstep, lora=lora is not None)
                if lead:
                    _remove_other_snapshots(paths["model_dir"], os.path.basename(snap_base), new_snap)
                    log.info("pretrain snapshot at epoch %d -> %s", epoch, new_snap)

    if teacher_params is not None:  # export a plain CLIP tree: kd_proj is training-only
        from tapclip_tpu_torch.distill import strip_distill_params

        params = strip_distill_params(params)
        if ema_params is not None:
            ema_params = strip_distill_params(ema_params)
    final = whole(effective(params))
    ema_final = whole(ema_params) if ema_params is not None else None
    ckpt = ema_ckpt = None
    if lead:
        ckpt = ckpt_io.save_clip_tree(os.path.join(paths["model_dir"], "clip_pretrained.pt"), final, cfg.model)
        log.info("full CLIP params saved: %s", ckpt)
        if ema_final is not None:
            ema_ckpt = ckpt_io.save_clip_tree(os.path.join(paths["model_dir"], "clip_pretrained_ema.pt"), ema_final,
                                              cfg.model)
            log.info("EMA params saved: %s", ema_ckpt)
    if owns_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    return {"loss_history": history, "val_history": val_history, "ckpt": ckpt, "ema_ckpt": ema_ckpt,
            "paths": paths, "params": params, "ema_params": ema_params}


def _mesh(args, dev):
    """``(mesh, owns_group)``: the ``(data, model)`` mesh over the ranks
    ``torchrun`` started (this call joins their group, NCCL on a CUDA
    device, gloo on the CPU), or no mesh for one process; asking for more
    than one rank without ``torchrun`` raises, as ``make_mesh`` does."""
    import torch.distributed as dist

    from tapclip_tpu_torch.parallel.mesh import init_distributed, make_mesh

    owns = not dist.is_initialized()
    world = init_distributed(dev)
    owns = owns and dist.is_initialized()
    if world <= 1 and args.dp in (-1, 1) and args.tp == 1 and args.pp == 1:
        return None, owns
    return make_mesh(dp=args.dp, tp=args.tp, pp=args.pp), owns


def _check_snapshot_format(path: str, sharded: bool, fmt) -> None:
    """A resume in the other format's flag exits by name, as the JAX CLI's."""
    if sharded and fmt == "host":
        raise SystemExit(f"--resume {path}: host-format snapshot (saved WITHOUT --sharded-snapshot) — resume it "
                         "without --sharded-snapshot")
    if sharded and fmt is None:
        raise SystemExit(f"--resume {path}: not a readable sharded snapshot directory")
    if not sharded and fmt == "sharded":
        raise SystemExit(f"--resume {path}: a sharded snapshot directory (saved WITH --sharded-snapshot) — resume "
                         "it with --sharded-snapshot")


def _restore_sharded(path: str, tree, optimizer, mesh, fsdp: bool, lora: bool, ckpt_io, log):
    """``--resume`` of a sharded snapshot into this rank's live ``tree`` (the
    CLIP tree's shards, or the LoRA adapters) and ``optimizer``: the params
    in place; the moments where they match the trained leaves by key path
    and shape, else fresh ones with a warning.  Returns (start epoch, the
    step counter)."""
    from tapclip_tpu_torch.pretrain import named_leaves

    target = ckpt_io.abstract_target(tree, mesh, fsdp, replicated=lora)
    try:
        snap = ckpt_io.restore_sharded_snapshot(path, target, mesh, fsdp=fsdp, trained=optimizer.paths)
    except ckpt_io.SnapshotMismatch as err:
        raise SystemExit(f"--resume {path}: sharded snapshot does not match this run beyond its optimizer state — "
                         f"the PARAMS tree also drifted (model preset/LoRA change since the save?).  Params cannot be "
                         f"merged; start fresh or resume with the saving-time configuration. ({err})") from err
    with torch.no_grad():
        for p, t in named_leaves(tree):
            t.copy_(snap["params"][p])
    if snap["opt_state"] is not None:
        optimizer.load_state_dict(snap["opt_state"])
    else:
        log.warning("sharded resume: snapshot optimizer state (%d moments) does not match this run's %d trained "
                    "leaves by key path and shape — resuming params with FRESH optimizer state", *snap["moments"])
    log.info("resumed from %s (epoch %d, sharded)", path, snap["epoch"])
    return snap["epoch"] + 1, snap["gstep"]


def _resume_loader(loader, args, start_epoch: int) -> None:
    """The data order continues from ``start_epoch`` (seed + epoch)."""
    if args.shard_dir:
        loader.restore({"epoch": start_epoch - 1, "shards_done": 0})
    elif args.csv_path:
        loader.restore({"epoch": start_epoch - 1})
    elif hasattr(loader, "_epoch"):
        loader._epoch = start_epoch - 1


def _remove_other_snapshots(model_dir: str, base: str, keep: str) -> None:
    """Every snapshot under ``model_dir`` but ``keep`` (files and sharded
    directories)."""
    import shutil

    for d in sorted(os.listdir(model_dir)):
        full = os.path.abspath(os.path.join(model_dir, d))
        if d.startswith(base) and full != keep and os.path.isdir(full):
            shutil.rmtree(full)
        elif d.startswith(base) and full != keep:
            os.remove(full)


def _refuse_combinations(args) -> None:
    """The JAX CLI's refusals of the parallel forms' combinations."""
    if args.fsdp and args.lora_rank > 0:
        raise ValueError("--fsdp does not apply to --lora-rank runs (the adapters are KBs; shard nothing)")
    if args.fsdp and args.pp > 1:
        raise ValueError("--fsdp does not compose with --pp (both spread param/optimizer memory)")
    if args.moe_experts and args.pp > 1:  # the JAX towers' words (models/clip.py), before any tree is built
        raise ValueError("pipeline parallelism over MoE towers is not supported (expert + pipeline sharding do not "
                         "compose yet)")
    if args.distill_teacher and (args.pp > 1 or args.fsdp):
        raise ValueError("--distill-teacher does not compose with --pp/--fsdp yet (dp/tp only)")
    if args.distill_teacher and args.moe_experts:
        raise ValueError("--distill-teacher with MoE students is not wired (the aux loss is not in the KD "
                         "objective)")
    if args.lora_rank > 0 and args.pp > 1:
        raise ValueError("--lora-rank does not compose with --pp yet (the merged tree runs the sequential tower)")
    if args.accum_full_negatives > 1 and (args.accum_steps > 1 or args.pp > 1 or args.fsdp or args.seq_parallel):
        raise ValueError("--accum-full-negatives composes with dp/tp meshes and the stochastic knobs, not with "
                         "--accum-steps/--pp/--fsdp/--seq-parallel")


def _output_paths(lead: bool, cfg, generate_output_paths):
    """Rank 0 makes the output tree (its name carries a timestamp) and the
    other ranks take its paths."""
    import torch.distributed as dist

    paths = [generate_output_paths(cfg.version + "_pretrain", cfg.output_root) if lead else None]
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast_object_list(paths, src=0)
    return paths[0]


if __name__ == "__main__":
    main()
