"""Drive the PyTorch + CUDA port's serving, training, text and int8 paths once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written CUDA kernels from ``tapclip_tpu_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, all started together) and prints
   the build time.
3. Holds each forward kernel against its plain PyTorch version at the
   serving path's shapes, in float32 (atol = rtol = 1e-4; TF32 is off on
   both sides) and in bfloat16 (atol = rtol = 2e-2, compared in f32), and
   times both with CUDA events.  In bfloat16 the attention-block kernel
   keeps q and k in f32 as the JAX kernel does, while its plain version
   rounds the qkv product to bf16 as the JAX package's plain path does.
4. Holds the backward kernels B4 (attention block) and B5 (MLP) against
   their plain backward on all seven outputs at the text shape (8 x 88 rows,
   W 512, 8 heads, valid 82) and the image shape (8 x 200, W 768, 12 heads,
   valid 197), by the norm-relative error of each output (tolerances at
   BWD_F32_TOL / BWD_BF16_TOL), and times both with CUDA events.
   Then B6 and B7 (the packed-QKV attention core, its backward) against
   their plain versions at the text shape (64 texts, T 80, valid 77,
   causal), the idiomatic step's shape (8 x 77, causal) and the fused_split
   image shape (8 x 200, valid 197, W 768, 12 heads), and causal K3 at the
   idiomatic aux layer (8 classes x 8 heads, T 77, per-class EOT), f32 and
   bf16; B7 beside the flash chain on the same packed strides (what runs
   past B7's tile), held and timed.  Every kernel's time is printed beside its plain version's, one
   library call's (SDPA for the attention kernels, where one computes the
   same function) and its bound (bytes over 3.35 TB/s or operations over
   the dtype's peak, whichever is larger).
5. Serves ViT-B/16 at full width with random weights from a fixed seed
   through ``tapclip_tpu_torch.serve``'s HTTP server on localhost: adds a
   class, sends 16 concurrent /predict requests (uint8 pixels, batches of
   8), 8 more, then one /explain.  Every forward kernel's launch count is
   set to 0 just before and read just after; each must have risen.
6. Checks the answers: finite probabilities that sum to 1, the same class
   for the same image in every batch, and probabilities, logits and
   attribution rows equal, within the stated tolerance, to those of the same
   model run with the plain versions (``attn_impl="xla"``) on the card.
7. Serves the same weights in bfloat16 through ``PredictService`` (a class
   added, one batch of 8, one explain) and holds them, within the bfloat16
   model tolerance, against the same bfloat16 model on the plain versions.
8. Trains the same weights (the five classes of ``bench.py``, capacity 8),
   in float32 and then bfloat16: 3 pixels-in ``make_train_step`` steps at
   batch 32, then ``fit_prompt_model`` over cached features (256 train / 64
   val, batch 32, 2 epochs), each on the kernel path and on the plain path.
   Every launch count is set to 0 just before the kernel path and read just
   after: B4 and B5 must have launched 12 times per step (one per text
   block).  Per step, loss and grad norm must agree between the paths, and
   so must the context vectors' displacement from their start (TRAIN_TOL).
   Prints ms per step.
9. The causal text tower on the same weights, f32 and bf16: POST
   /embed_text over HTTP with 5 texts and with 33 (padded to 64), a
   zero-shot classifier over Office-Home's 65 class names and zero-shot
   logits on 8 images, each against the plain path on the card; a text
   batch takes 12 B6 and 12 K1 launches and no K2.
10. One image batch with ``attn_impl="fused_split"`` (12 B6 launches)
    against ``"auto"``.
11. Idiomatic (CoOp-style) prompt tuning, f32 and bf16, 3 cached-feature
    steps at batch 32 on the kernels and on the plain path: per step 23 B6,
    1 causal K3, 12 B7, 12 B5 and no B4 launches; loss, grad norm and ctx
    held as in 8.
12. The flash backward chain (``csrc/flash_bwd.cu``: LSE, dK/dV, dQ) kernel
    by kernel against its plain versions, f32 and bf16, at the pallas
    training step's shapes (8 classes x 8 heads, T 88 valid 82; T 77
    causal), the ViT-L/14-336 vision shape (4 x 16 heads, T 584, valid 577)
    and a long case (1 x 16 heads, T 4096, valid 4000, causal and not, where
    the JAX package runs its blockwise kernels), the whole chain against the
    single-block formula, with CUDA-event times beside the plain versions,
    SDPA's backward and the bound; K3 at T 4096 (the blockwise forward's
    counterpart) against its plain version, by the norm-relative error of
    its output and aux column (K3_LONG_TOL).
13. The B7 and B4 backwards past their [T, T] tile (T 584, W 1024, 16
    heads): the flash chain on the packed strides, and the split
    composition, against their plain backward.
14. Prompt tuning with ``attn_impl="pallas"`` in both text modes, f32 and
    bf16, 3 cached-feature steps at batch 32, against ``"xla"`` on the card:
    per step 24 K3 launches (causal in idiomatic mode), 12 each of LSE,
    dK/dV and dQ, and none of K1, K2, B4, B5, B6, B7.
15. The int8 kernels B13 (MLP) and B14 (attention) against their plain
    versions with the same random draws, f32 and bf16, stochastic and round
    to nearest, at ViT-B/16 (8 x 200, W 768; B14 also at the pruned 8 x 96)
    and ViT-L/14 (8 x 264, W 1024, H 4096, 16 heads), by the norm-relative
    error of the block's update (INT8_TOL), with CUDA-event times of the
    kernel, the plain version and the wrapper; the 64-seed mean of each
    stochastic block at least INT8_MEAN_GAIN times closer than one draw to
    the weight-only-quantized float block.
16. S5 (B13's erf3 / recipmul variants) against the base kernel
    (INT8_VARIANT_TOL) and their plain versions, timed in turns; S6 (the
    int8 product) exactly against its float64 plain version at the probe's
    shape (51,200 x 768 x 3,072) and at B13's two products, timed beside
    gemm.cu in bf16, ``torch._int_mm`` and ``torch.matmul`` in bf16.
17. ViT-B/16 with ``quantize_tower`` served over HTTP, f32 and bf16,
    stochastic and round to nearest: per image batch exactly 12 B13 + 12
    B14 and no K1/K2/K3/B6; logits and served probabilities against the
    same model on the plain int8 versions on the card (INT8_SERVE_TOL; a
    stochastic answer depends on the image's row in the batch, so each
    served image is matched to the plain path at its best batch position),
    /explain attribution, and features of cosine at least FEATURE_COS
    against the float tower; image-batch ms of the int8 kernels, the plain
    int8 versions and the float K1/K2 tower.
18. ``--token-keep-ratio 0.5`` (``token_prune_layer`` 4) served over HTTP,
    with and without int8 (f32): 4 blocks at T 200 and 8 at T 96 per image
    batch, the kept tokens against the plain path's (exactly for the float
    tower, INT8_KEEP_AGREE for the int8 one), features of cosine at least
    FEATURE_COS against the unpruned tower.
19. ``adaptive_logits`` with the int8 pruned cheap path: margin inf equals
    the full path, -inf the cheap path.

Prints one JSON line of per-kernel results before the last line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

F32_TOL = 1e-4
BF16_TOL = 2e-2
# K3's aux column is the head mean of f32 probabilities on both sides, in
# either dtype, so it is held at F32_TOL in bf16 too (reading on an H100
# 80GB HBM3 at 700 W: at most 1.1e-8 in either dtype, causal or not).
# Served model, float32, 12 + 12 layers: logits are exp(logit_scale) = 14.3
# times a cosine, so 1e-3 on logits is 7e-5 on the cosine; probabilities of
# four classes move by at most a quarter of that.
LOGIT_TOL = 1e-3
PROB_TOL = 5e-4
ATTR_TOL = 1e-4
# The same model in bfloat16, kernel path vs plain path, set from a reading
# on an H100 80GB HBM3 at 700 W of 3.1e-2 on logits, 2.2e-3 on probabilities
# and 8.7e-7 on attribution rows; the plain path's own bf16-vs-f32 gap in
# the logits read 1.5e-2.
BF16_LOGIT_TOL = 0.1
BF16_PROB_TOL = 1e-2
BF16_ATTR_TOL = 1e-4

# Backward kernels: norm-relative error ||got - want|| / ||want|| of each of
# the seven outputs.  f32: only the order of the f32 sums differs.  bf16:
# both sides round the same intermediates, but a value on the other side of
# a rounding step moves by one bf16 ulp (2^-8 relative).  Set from a reading
# on an H100 80GB HBM3 at 700 W of at most 1.2e-6 (f32) and 3.5e-4 (bf16).
BWD_F32_TOL = 1e-5
BWD_BF16_TOL = 5e-3
# K3 at T 4096 (B9's role), norm-relative error of the output and of the
# aux column: a softmax over about 4000 keys makes both small (a typical
# |out| of 0.03, an aux of 2.5e-4), so an absolute limit would hide a
# skipped 64-key tile, which moves the output by about 0.1 and the aux by
# about 1e-2 of their norms.  Set from a reading on an H100 80GB HBM3 at
# 700 W of at most 1.6e-6 (out, f32), 3.1e-3 (out, bf16: both sides round
# to bf16) and 1.0e-7 (aux, f32 math on both sides in either dtype).
K3_LONG_TOL = {"float32": {"out": 1e-5, "aux": 1e-6}, "bfloat16": {"out": 1e-2, "aux": 1e-6}}
# Training, kernel path vs plain path on the same weights and batches:
# relative error of each step's loss and grad norm, and the norm-relative
# error of the context vectors' displacement from their start,
# ||dk - dp|| / ||dp|| (``ctx_step``).  An unchanged ctx reads 1 there,
# whatever the number of steps; a max abs error cannot tell it apart in bf16,
# where AdamW moves each element by about lr = 2e-3 a step, whatever the
# gradient's size, so bf16 noise that flips a small gradient's sign moves
# that element by up to 2 lr a step.  Set from a reading on the same card of
# 3.6e-7 / 2.0e-6 / 1.0e-5 in f32 and 2.6e-4 / 1.7e-2 / 0.12 in bf16.
TRAIN_TOL = {"float32": {"loss": 5e-6, "grad_norm": 2e-5, "ctx_step": 1e-4},
             "bfloat16": {"loss": 2e-3, "grad_norm": 1e-1, "ctx_step": 0.3}}
TRAIN_CLASSES = ["Backpack", "Alarm_Clock", "Laptop", "Pen", "Mug"]  # bench.py:126
# The 65 classes of Office-Home, the reference's dataset: a zero-shot
# classifier over them encodes 65 prompts, two text batches of up to 64.
OFFICE_HOME = [
    "Alarm_Clock", "Backpack", "Batteries", "Bed", "Bike", "Bottle", "Bucket", "Calculator",
    "Calendar", "Candles", "Chair", "Clipboards", "Computer", "Couch", "Curtains", "Desk_Lamp",
    "Drill", "Eraser", "Exit_Sign", "Fan", "File_Cabinet", "Flipflops", "Flowers", "Folder",
    "Fork", "Glasses", "Hammer", "Helmet", "Kettle", "Keyboard", "Knives", "Lamp_Shade",
    "Laptop", "Marker", "Monitor", "Mop", "Mouse", "Mug", "Notebook", "Oven", "Pan",
    "Paper_Clip", "Pen", "Pencil", "Postit_Notes", "Printer", "Push_Pin", "Radio",
    "Refrigerator", "Ruler", "Scissors", "Screwdriver", "Shelf", "Sink", "Sneakers", "Soda",
    "Speaker", "Spoon", "TV", "Table", "Telephone", "ToothBrush", "Toys", "Trash_Can", "Webcam",
]
# Text tower, kernel path vs plain path on the same card: max abs error of
# unit-norm text embeddings and zero-shot class weights (elements of about
# 1/sqrt(512) = 0.044), and of the zero-shot logits (exp(logit_scale) = 14.3
# times a cosine).  bf16 set from a reading on an H100 80GB HBM3 at 700 W of
# 2.0e-3 on embeddings, 2.5e-3 on class weights and 3.1e-2 on logits.
TEXT_TOL = {"float32": {"embed": 1e-4, "logits": 1e-3},
            "bfloat16": {"embed": 1e-2, "logits": 0.1}}
IDIOMATIC_STEPS = 3
# Idiomatic training, kernel path vs plain path: as TRAIN_TOL, plus the
# first batch's gradient into ctx (max abs error over the largest element).
# AdamW's first step moves each element by lr g / (|g| + 1e-8): an element
# whose gradient is within a few 1e-8 of zero moves by a fraction of lr that
# f32 noise in g changes, so ctx is held by its displacement (ctx_step); the
# gradient check holds the kernels.  Set from a reading on an H100 80GB HBM3
# at 700 W: f32 loss 2.0e-6, grad norm 5.7e-7, gradient 1.4e-6, ctx_step
# 7.0e-4; bf16 1.3e-3, 1.2e-3, 1.8e-2, 7.9e-2 (the kernels keep q and k in
# f32 where the plain path rounds the qkv product to bf16).
IDIOMATIC_TOL = {"float32": {"loss": 5e-6, "grad_norm": 2e-5, "grad": 1e-5, "ctx_step": 5e-3},
                 "bfloat16": {"loss": 5e-3, "grad_norm": 1e-2, "grad": 5e-2, "ctx_step": 0.3}}
# The card's published peaks (H100 SXM data sheet, dense): memory 3.35 TB/s;
# f32 outside the tensor cores 67 TFLOP/s, bf16 989 TFLOP/s, int8 1,979 TOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_INT8_OPS = 1979e12
# The int8 kernels (B13, B14) against their plain versions with the same
# random draws: norm-relative error of the block's update (out - x).  Both
# sides do the same IEEE steps in the same order; what differs is the last
# bit of LayerNorm's sums, erf and the attention core's sums, and an
# activation code that lands on the other side of a rounding step there
# moves its row by about 5e-4 of the update (a quantum of one of 3,072
# hidden codes).  f32: 2e-3 (reading on an H100 80GB HBM3 at 700 W: at most
# 3.0e-4).  bf16: 2e-2, as the other kernels' bf16 limit (reading: B13 at
# most 2.3e-4; B14 1.8e-3 round to nearest and 7.8e-3 stochastic, where p
# is rounded to bf16 against the online softmax's running max in the kernel
# and against the row's max in the plain version, as in the TPU kernel).
INT8_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
# S5: each variant against the base kernel with the same draws, norm-relative
# on the output (erf3's 2.5e-5 error in erf moves about one hidden code a row).
INT8_VARIANT_TOL = 1e-3
# The 64-seed mean of the stochastic blocks must be this many times closer
# (norm-relative on the update) than one draw to the weight-only-quantized
# float block: stochastic rounding is unbiased, so averaging removes the
# activation noise but not the weights' rounding to nearest.
INT8_MEAN_GAIN = 3.0
INT8_SEEDS = 64
# Served int8 model, kernel path vs the plain int8 versions on the card, same
# weights, draws and images: max abs error of logits (14.3 x a cosine) and of
# probabilities, per dtype.  A code flip (above) in one block moves the next
# block's inputs, which flips more codes there, so through 24 quantized
# half-blocks the two paths drift apart by more than one block's error.  Set
# from a reading on an H100 80GB HBM3 at 700 W: f32 logits 9.7e-3
# (stochastic) and 2.5e-2 (round to nearest), probabilities 5.5e-4; bf16
# logits 3.4e-2, probabilities 2.2e-3.  The cosine of the int8 (or pruned)
# image features against the float (or unpruned) tower's must reach JAX's own
# bar under pruning (tests/test_int8.py:137).
INT8_SERVE_TOL = {"float32": {"logits": 0.1, "probs": 1e-2},
                  "bfloat16": {"logits": 0.2, "probs": 2e-2}}
FEATURE_COS = 0.98
# Kept tokens of the int8 pruned tower, kernel path vs plain path: the share
# of the 96 kept indices the two agree on, per image (the drift above can
# move a token across the keep boundary; the float tower's must agree
# exactly).  Reading on the same card: at least 0.979 (2 of 96).
INT8_KEEP_AGREE = 0.95

CLASSES = ["Backpack", "Pen", "Monitor"]

KERNELS = {
    "fused_mlp": {
        "source": "tapclip_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "tapclip_tpu/ops/fused_mlp.py:69",
    },
    "fused_attn_block": {
        "source": "tapclip_tpu_torch/csrc/attn_block.cu",
        "replaces": "tapclip_tpu/ops/fused_mha.py:519",
    },
    "fused_attention_aux": {
        "source": "tapclip_tpu_torch/csrc/attn_aux.cu",
        "replaces": "tapclip_tpu/ops/flash_attention.py:65",
    },
    "fused_attn_block_bwd": {
        "source": "tapclip_tpu_torch/csrc/attn_block_bwd.cu",
        "replaces": "tapclip_tpu/ops/fused_mha.py:628",
    },
    "fused_mlp_bwd": {
        "source": "tapclip_tpu_torch/csrc/mlp_bwd.cu",
        "replaces": "tapclip_tpu/ops/fused_mlp.py:119",
    },
    "fused_mha": {
        "source": "tapclip_tpu_torch/csrc/mha.cu",
        "replaces": "tapclip_tpu/ops/fused_mha.py:55",
    },
    "fused_mha_bwd": {
        "source": "tapclip_tpu_torch/csrc/mha_bwd.cu",
        "replaces": "tapclip_tpu/ops/fused_mha.py:125",
    },
    "fused_attention_aux_causal": {
        "source": "tapclip_tpu_torch/csrc/attn_aux.cu",
        "replaces": "tapclip_tpu/ops/flash_attention.py:65",
    },
    "flash_lse": {
        "source": "tapclip_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "tapclip_tpu/ops/flash_attention.py:463",
    },
    "flash_bwd_dkv": {
        "source": "tapclip_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "tapclip_tpu/ops/flash_attention.py:523, tapclip_tpu/ops/flash_attention.py:355",
    },
    "flash_bwd_dq": {
        "source": "tapclip_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "tapclip_tpu/ops/flash_attention.py:591, tapclip_tpu/ops/flash_attention.py:355",
    },
    "fused_attention_aux_long": {  # K3 where the JAX package runs its blockwise forward
        "source": "tapclip_tpu_torch/csrc/attn_aux.cu",
        "replaces": "tapclip_tpu/ops/flash_attention.py:129",
    },
}
# The ref_compat serving and training paths' kernels, the causal text
# tower's, and those of prompt tuning with attn_impl="pallas".
FORWARD = ("fused_mlp", "fused_attn_block", "fused_attention_aux")
BACKWARD = ("fused_attn_block_bwd", "fused_mlp_bwd")
TEXT = ("fused_mha", "fused_mha_bwd", "fused_attention_aux_causal")
FLASH = ("flash_lse", "flash_bwd_dkv", "flash_bwd_dq", "fused_attention_aux_long")
PALLAS_STEPS = 3
# The int8 eval tower's kernels (B13, B14), B13's A/B variants (S5) and the
# bare int8 product (S6): entries of the kernels line built by int8_record.
INT8_KERNELS = {
    "int8_mlp": {"source": "tapclip_tpu_torch/csrc/int8_mlp.cu", "replaces": "tapclip_tpu/ops/int8_mlp.py:63"},
    "int8_attn": {"source": "tapclip_tpu_torch/csrc/int8_attn.cu", "replaces": "tapclip_tpu/ops/int8_attn.py:48"},
    "int8_mlp_erf3": {"source": "tapclip_tpu_torch/csrc/int8_mlp.cu", "replaces": "scripts/int8_mlp_ab.py:63"},
    "int8_mlp_recipmul": {"source": "tapclip_tpu_torch/csrc/int8_mlp.cu", "replaces": "scripts/int8_mlp_ab.py:63"},
    "int8_mlp_erf3_recipmul": {"source": "tapclip_tpu_torch/csrc/int8_mlp.cu",
                               "replaces": "scripts/int8_mlp_ab.py:63"},
    "int8_gemm": {"source": "tapclip_tpu_torch/csrc/int8_gemm.cu", "replaces": "scripts/int8_probe.py:40"},
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _counters():
    """Each kernel's launch counter: (wrapper, attribute)."""
    from tapclip_tpu_torch.ops.flash_attention import fused_attention
    from tapclip_tpu_torch.ops.fused_mha import fused_attn_block, fused_mha
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block
    from tapclip_tpu_torch.ops.int8_attn import int8_attn_block
    from tapclip_tpu_torch.ops.int8_gemm import int8_gemm
    from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_block

    return {
        "fused_mlp": (fused_mlp_block, "launches"),
        "fused_attn_block": (fused_attn_block, "launches"),
        "fused_attention_aux": (fused_attention, "launches"),  # causal or not
        "fused_attn_block_bwd": (fused_attn_block, "bwd_launches"),
        "fused_mlp_bwd": (fused_mlp_block, "bwd_launches"),
        "fused_mha": (fused_mha, "launches"),
        "fused_mha_bwd": (fused_mha, "bwd_launches"),
        "fused_attention_aux_causal": (fused_attention, "causal_launches"),
        "flash_lse": (fused_attention, "lse_launches"),
        "flash_bwd_dkv": (fused_attention, "dkv_launches"),
        "flash_bwd_dq": (fused_attention, "dq_launches"),
        # fused_attention_aux_long has none: it is K3 past T 2048, which no
        # main path reaches (0 launches there); K3's own launches are above.
        "int8_mlp": (int8_mlp_block, "launches"),
        "int8_attn": (int8_attn_block, "launches"),
        "int8_mlp_variants": (int8_mlp_block, "variant_launches"),  # S5, off the serving path
        "int8_gemm": (int8_gemm, "launches"),  # S6, off the serving path
    }


def reset_counts() -> None:
    for wrapper, attr in _counters().values():
        setattr(wrapper, attr, 0)


def read_counts() -> dict:
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in _counters().items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got, want, tol: float) -> dict:
    import torch

    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), f"{name}: kernel output is not finite")
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= tol + tol * want.abs()).all())
    require(ok, f"{name}: max abs err {max_abs:.3e} (rel {max_rel:.3e}) exceeds atol=rtol={tol}")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float, dtype: str) -> dict:
    """The least time the card could take for a call: the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its operations over the peak rate for its dtype."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def attn_pairs(B: int, T: int, valid, causal: bool = False) -> int:
    """(query, key) pairs with a nonzero probability over B batch rows
    (``valid`` an int or one per row): the attention products' work."""
    valids = list(valid) if isinstance(valid, (list, tuple)) else [valid] * B
    if causal:
        return sum(min(i + 1, v) for v in valids for i in range(T))
    return sum(T * v for v in valids)


def key_mask(B: int, T: int, valid, causal: bool = False):
    """Boolean ``attn_mask`` [B, 1, 1 or T, T] for the library call (SDPA)."""
    import torch

    valids = torch.tensor(valid if isinstance(valid, (list, tuple)) else [valid] * B, device="cuda")
    keys = torch.arange(T, device="cuda")
    mask = keys.view(1, 1, 1, T) < valids.view(B, 1, 1, 1)
    if causal:
        mask = mask & (keys.view(1, 1, 1, T) <= keys.view(1, 1, T, 1))
    return mask


def _mlp_case(gen, B, T, W, dtype):
    import torch

    H = 4 * W
    dev = gen.device

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    x = rn(B, T, W).to(dtype)
    ln = {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}
    mlp = {"w_fc": rn(W, H, s=W ** -0.5), "b_fc": rn(H, s=0.1),
           "w_proj": rn(H, W, s=H ** -0.5), "b_proj": rn(W, s=0.1)}
    return x, ln, mlp


def check_kernels() -> dict:
    """Each kernel against its plain version at the serving path's shapes."""
    import torch

    from tapclip_tpu_torch.ops.attention import attention_reference
    from tapclip_tpu_torch.ops.flash_attention import _fused_attention_cuda, fused_attention
    from tapclip_tpu_torch.ops.fused_mha import attn_block_reference, fused_attn_block
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: {"cases": []} for name in KERNELS}
    f32, bf16 = torch.float32, torch.bfloat16

    def record(name, label, dtype, kern, plain, tol, timed, work=None, library=None):
        with torch.inference_mode():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if isinstance(got, tuple):  # (out, aux)
                err = compare(f"{name} {label} out", got[0], want[0], tol)
                if got[1] is not None:
                    aux_err = compare(f"{name} {label} aux", got[1], want[1], F32_TOL)
                    print(f"kernel {name} [{label} {dtype}]: aux max abs err "
                          f"{aux_err['max_abs_err']:.3e}", flush=True)
                    err = {k: max(err[k], aux_err[k]) for k in err}
            else:
                err = compare(f"{name} {label}", got, want, tol)
            case = {"shape": label, "dtype": str(dtype).replace("torch.", ""), **err}
            if timed:
                case["ms"] = time_ms(kern)
                case["plain_ms"] = time_ms(plain)
                case["library_ms"] = time_ms(library) if library is not None else None
                case.update(bound(*work, case["dtype"]))
        results[name]["cases"].append(case)
        print(f"kernel {name} [{label} {case['dtype']}]: "
              + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in case.items() if k not in ("shape", "dtype")),
              flush=True)

    for dtype, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        # K1: image tower rows B*T = 8*200 at W=768; text rows 8*88 at W=512;
        # a 64-text batch of the causal tower, rows 64*80.
        for label, (B, T, W), timed in (("image 8x200x768", (8, 200, 768), True),
                                        ("text 8x88x512", (8, 88, 512), True),
                                        ("text batch 64x80x512", (64, 80, 512), True)):
            x, ln, mlp = _mlp_case(gen, B, T, W, dtype)
            p = (x, ln["scale"], ln["bias"], mlp["w_fc"], mlp["b_fc"], mlp["w_proj"], mlp["b_proj"])
            # No single PyTorch call computes x + MLP(LN(x)): no library time.
            record("fused_mlp", label, dtype,
                   lambda: fused_mlp_block(x, ln, mlp, eps=1e-5),
                   lambda: fused_mlp_reference(*p, eps=1e-5), tol, timed,
                   work=(nbytes(*p) + nbytes(x), 16 * B * T * W * W))
        # K2: image T=200 (valid 197), 12 heads; text T=88 (valid 82), 8 heads.
        for label, (B, T, W, nh, valid), timed in (
            ("image 8x200x768 h12 valid197", (8, 200, 768, 12, 197), True),
            ("text 8x88x512 h8 valid82", (8, 88, 512, 8, 82), False),
        ):
            x = (torch.randn((B, T, W), generator=gen, device="cuda")).to(dtype)
            ln = {"scale": 1.0 + 0.1 * torch.randn(W, generator=gen, device="cuda"),
                  "bias": 0.1 * torch.randn(W, generator=gen, device="cuda")}
            attn = {"w_qkv": torch.randn((W, 3 * W), generator=gen, device="cuda") * W ** -0.5,
                    "b_qkv": 0.1 * torch.randn(3 * W, generator=gen, device="cuda"),
                    "w_out": torch.randn((W, W), generator=gen, device="cuda") * W ** -0.5,
                    "b_out": 0.1 * torch.randn(W, generator=gen, device="cuda")}
            args = (x, ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"],
                    attn["w_out"], attn["b_out"], nh, valid, 1e-5)
            record("fused_attn_block", label, dtype,
                   lambda: fused_attn_block(x, ln, attn, nh, valid_len=valid, eps=1e-5),
                   lambda: attn_block_reference(*args), tol, timed,
                   work=(nbytes(*args[:7]) + nbytes(x),
                         8 * B * T * W * W + 4 * W * attn_pairs(B, T, valid)))
        # K3: attribution pass, 8 classes x 8 heads, T=88 (valid 82, column 81);
        # and ViT-L/14@336 length T=584 with per-row valid/column.
        for label, (B, H, T, valid, eot), timed in (
            ("text 8x8x88 valid82 eot81", (8, 8, 88, 82, 81), True),
            ("long 2x16x584 per-row valid/eot", (2, 16, 584, [577, 300], [576, 17]), False),
        ):
            q, k, v = (torch.randn((B, H, T, 64), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            mask = key_mask(B, T, valid)
            work = (4 * nbytes(q) + 4 * B * T, 4 * H * 64 * attn_pairs(B, T, valid))
            if isinstance(valid, list):
                valid = torch.tensor(valid, device="cuda")
                eot = torch.tensor(eot, device="cuda")
            record("fused_attention_aux", label, dtype,
                   lambda: fused_attention(q, k, v, kv_valid_len=valid, attn_to_idx=eot),
                   lambda: attention_reference(q, k, v, kv_valid_len=valid, attn_to_idx=eot),
                   tol, timed, work=work,
                   library=lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask))
            if timed:  # the launcher alone, without the autograd Function around it
                with torch.inference_mode():
                    ms = time_ms(lambda: _fused_attention_cuda(q, k, v, False, valid, eot))
                results["fused_attention_aux"]["cases"][-1]["launcher_ms"] = ms
                print(f"kernel fused_attention_aux [{label} {dtype}]: launcher alone {ms:.4g} ms", flush=True)
    return results


def _rel_errors(got, want) -> tuple:
    """(max norm-relative error, max abs error) over paired output tensors."""
    import torch

    rel = ab = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float().reshape(a.shape)
        require(bool(torch.isfinite(a).all()), "backward kernel output is not finite")
        rel = max(rel, float((a - b).norm() / b.norm().clamp_min(1e-30)))
        ab = max(ab, float((a - b).abs().max()))
    return rel, ab


def check_backward() -> dict:
    """B4 and B5 against their plain backward on all seven outputs, at the
    text and image shapes, in f32 and bf16; CUDA-event times of the kernel
    (with and without weight gradients) and of the plain backward."""
    import torch

    from tapclip_tpu_torch.ops.fused_mha import _attn_block_bwd_cuda, attn_block_bwd_reference
    from tapclip_tpu_torch.ops.fused_mlp import _fused_mlp_bwd_cuda, fused_mlp_bwd_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {name: {"cases": []} for name in BACKWARD}

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    for dtype, tol in ((torch.float32, BWD_F32_TOL), (torch.bfloat16, BWD_BF16_TOL)):
        dname = str(dtype).replace("torch.", "")
        for label, (B, T, W, nh, valid) in (("text 8x88x512", (8, 88, 512, 8, 82)),
                                            ("image 8x200x768", (8, 200, 768, 12, 197))):
            x, g = rn(B, T, W).to(dtype), rn(B, T, W).to(dtype)
            ln = (1.0 + rn(W, s=0.1), rn(W, s=0.1))
            H = 4 * W
            mlp = (rn(W, H, s=W ** -0.5), rn(H, s=0.1), rn(H, W, s=H ** -0.5))
            attn = (rn(W, 3 * W, s=W ** -0.5), rn(3 * W, s=0.1), rn(W, W, s=W ** -0.5))
            cases = {
                "fused_mlp_bwd": (
                    lambda w=True: _fused_mlp_bwd_cuda(x, g, *ln, *mlp, eps=1e-5, weight_grads=w),
                    lambda: fused_mlp_bwd_reference(x, g, *ln, *mlp, 1e-5),
                    nbytes(x, g, *ln, *mlp), 40 * B * T * W * W),
                "fused_attn_block_bwd": (
                    lambda w=True: _attn_block_bwd_cuda(x, g, *ln, *attn, nh, valid, 1e-5, weight_grads=w),
                    lambda: attn_block_bwd_reference(x, g, *ln, *attn, nh, valid, 1e-5),
                    nbytes(x, g, *ln, *attn), 22 * B * T * W * W + 12 * W * attn_pairs(B, T, valid)),
            }
            # No single PyTorch call computes either backward: no library time.
            for name, (kern, plain, in_bytes, flops) in cases.items():
                with torch.no_grad():
                    got, want = kern(), plain()
                    dx_only = kern(False)[0]
                    torch.cuda.synchronize()
                    rel, ab = _rel_errors(got, want)
                    rel_dx, _ = _rel_errors([dx_only], [want[0]])
                    shape = label if name == "fused_mlp_bwd" else f"{label} h{nh} valid{valid}"
                    case = {"shape": shape, "dtype": dname, "max_rel_err": rel, "max_abs_err": ab,
                            "dx_only_rel_err": rel_dx,
                            "ms": time_ms(kern), "ms_dx_only": time_ms(lambda: kern(False)),
                            "plain_ms": time_ms(plain), "library_ms": None,
                            **bound(in_bytes + nbytes(*got), flops, dname)}
                results[name]["cases"].append(case)
                print(f"backward {name} [{shape} {dname}]: "
                      + ", ".join(f"{k}={v:.4g}" for k, v in case.items() if isinstance(v, float)),
                      flush=True)
                require(rel <= tol and rel_dx <= tol,
                        f"{name} {shape} {dname}: norm-relative error {max(rel, rel_dx):.3e} > {tol}")
    return results


def _step_err(k1, k0, p1, p0) -> float:
    """Norm-relative error of the kernel path's displacement ``k1 - k0``
    against the plain path's ``p1 - p0``: an unchanged ``k`` reads 1."""
    return float(np.linalg.norm((k1 - k0) - (p1 - p0)) / np.linalg.norm(p1 - p0))


def _sync_ms(fn) -> tuple:
    """(result, ms) of ``fn`` on the host clock, ended by a synchronisation."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _train_path(model, images, labels, train_set, val_set) -> dict:
    """3 pixels-in train steps at batch 32, then fit_prompt_model on cached
    features, for one model; returns the readings."""
    from tapclip_tpu_torch.config import TrainConfig
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step
    from tapclip_tpu_torch.trainer import fit_prompt_model

    cfg = TrainConfig(batch_size=32, epochs=2)
    ctx0 = model.trainable["ctx"].detach().float().cpu().numpy()
    state = init_train_state(model.trainable, make_optimizer(cfg))
    step = make_train_step(model.clip_cfg, model.prompt_cfg, use_image_feats=False)
    mask = np.ones(len(labels[0]), bool)
    losses, norms, step_ms = [], [], []
    for x, y in zip(images, labels):
        (state, metrics), ms = _sync_ms(
            lambda: step(model.clip_params, state, model.prompt_learner.bank, x, y, mask))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        step_ms.append(ms)
    pixel_ctx = state.params["ctx"].detach().float().cpu().numpy()
    res, fit_ms = _sync_ms(lambda: fit_prompt_model(model, train_set, val_set, cfg, verbose=False))
    return {"loss": losses, "grad_norm": norms, "pixel_step_ms": step_ms, "ctx0": ctx0, "pixel_ctx": pixel_ctx,
            "fit_loss": res.loss_history, "fit_acc": res.acc_history, "fit_entropy": res.attr_entropy,
            "fit_ctx": res.final_state.params["ctx"].detach().float().cpu().numpy(),
            "fit_step_ms": 1e3 / res.steps_per_sec, "fit_s": fit_ms / 1e3,
            "steps": len(losses) + res.final_state.step}


def train_phase(clip_params, base_cfg, dtype: str) -> dict:
    """The training path on the kernels and on the plain versions, same
    weights and batches; launch counts of the kernel path."""
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.trainer import CachedSet

    cfg = base_cfg.replace(dtype=dtype)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (32, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
              for _ in range(3)]
    labels = [rng.integers(0, len(TRAIN_CLASSES), 32) for _ in range(3)]
    train_set = CachedSet(rng.standard_normal((256, cfg.embed_dim)).astype(np.float32),
                          rng.integers(0, len(TRAIN_CLASSES), 256))
    val_set = CachedSet(rng.standard_normal((64, cfg.embed_dim)).astype(np.float32),
                        rng.integers(0, len(TRAIN_CLASSES), 64))
    out = {}
    for path, c in (("kernel", cfg), ("plain", cfg.replace(attn_impl="xla"))):
        model = FullModel(TRAIN_CLASSES, clip_params, c)
        require(model.prompt_learner.bank.capacity == 8, "capacity is not 8")
        reset_counts()
        out[path] = _train_path(model, images, labels, train_set, val_set)
        out[path]["launches"] = read_counts()
    k, p = out["kernel"], out["plain"]
    tol = TRAIN_TOL[dtype]
    steps = k["steps"]
    launches = k["launches"]
    errs = {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(k["loss"] + k["fit_loss"], p["loss"] + p["fit_loss"])),
        "grad_norm": max(abs(a - b) / abs(b) for a, b in zip(k["grad_norm"], p["grad_norm"])),
        "ctx_step": max(_step_err(k[key], k["ctx0"], p[key], p["ctx0"]) for key in ("pixel_ctx", "fit_ctx")),
    }
    ctx_abs = float(max(np.abs(k["pixel_ctx"] - p["pixel_ctx"]).max(), np.abs(k["fit_ctx"] - p["fit_ctx"]).max()))
    print(f"train {dtype}: {steps} steps per path; kernel-path launches {launches}; "
          f"plain-path launches {p['launches']}", flush=True)
    print(f"train {dtype}: pixels-in step ms (batch 32, incl. host) kernel "
          f"{[round(v, 2) for v in k['pixel_step_ms']]} vs plain {[round(v, 2) for v in p['pixel_step_ms']]}; "
          f"cached-feature step ms kernel {k['fit_step_ms']:.2f} vs plain {p['fit_step_ms']:.2f}", flush=True)
    print(f"train {dtype}: loss kernel {[round(v, 5) for v in k['loss']]} plain {[round(v, 5) for v in p['loss']]}; "
          f"fit loss kernel {[round(v, 5) for v in k['fit_loss']]} plain {[round(v, 5) for v in p['fit_loss']]}; "
          f"fit acc {k['fit_acc']} / {p['fit_acc']}; entropy {k['fit_entropy']} / {p['fit_entropy']}",
          flush=True)
    print(f"train {dtype}: kernel vs plain: loss rel err {errs['loss']:.3e} (tol {tol['loss']}), grad norm "
          f"rel err {errs['grad_norm']:.3e} (tol {tol['grad_norm']}), ctx displacement norm-rel err "
          f"{errs['ctx_step']:.3e} (tol {tol['ctx_step']}), ctx max abs err {ctx_abs:.3e}", flush=True)
    for name in BACKWARD:
        require(launches[name] == 12 * steps,
                f"{name}: {launches[name]} launches in {steps} train steps, expected {12 * steps}")
    for name in FORWARD:
        require(launches[name] > 0, f"kernel {name} was not launched on the training path")
    require(all(n == 0 for n in p["launches"].values()), f"plain path launched kernels {p['launches']}")
    for path in (k, p):
        require(all(np.isfinite(path["loss"] + path["fit_loss"] + path["grad_norm"])), "non-finite loss")
    for key, err in errs.items():
        require(err <= tol[key], f"train {dtype}: kernel vs plain {key} error {err:.3e} > {tol[key]}")
    return {"launches": launches, "steps": steps, "errors": errs,
            "pixel_step_ms": {"kernel": k["pixel_step_ms"], "plain": p["pixel_step_ms"]},
            "fit_step_ms": {"kernel": k["fit_step_ms"], "plain": p["fit_step_ms"]}}


def _post(url: str, obj: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _plain_probs(logits: np.ndarray) -> np.ndarray:
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def serve_path(model) -> dict:
    """``model`` (ViT-B/16 at full width) behind the HTTP server; returns
    launch counts and checks."""
    import torch

    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.serve import PredictService, make_http_server

    cfg = model.clip_cfg
    plain = FullModel(CLASSES, model.clip_params, cfg.replace(attn_impl="xla"))
    # A long batching deadline: 16 concurrent requests fill two batches of 8
    # even while the server is still decoding some of their JSON bodies.
    service = PredictService(model, batch_size=8, max_latency_ms=2000.0)
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    try:
        reset_counts()
        t0 = time.perf_counter()
        names = _post(base + "/classes", {"name": "Clipboards"})["classes"]
        with ThreadPoolExecutor(16) as pool:
            wave1 = list(pool.map(
                lambda j: _post(base + "/predict", {"pixels": images[j % 8].tolist()}), range(16)))
            wave2 = list(pool.map(
                lambda j: _post(base + "/predict", {"pixels": images[j].tolist()}), range(8)))
        explain = _post(base + "/explain", {"pixels": images[0].tolist()})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: n for name, n in read_counts().items() if name in FORWARD}
        stats = service.stats()
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    print(f"serve: 1 add_class + 24 /predict + 1 /explain in {wall:.2f} s; stats {stats}; "
          f"launches {launches}", flush=True)

    require(names == CLASSES + ["Clipboards"], f"/classes returned {names}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the serving path")
    served = wave1 + wave2
    for r in served + [explain]:
        probs = np.array([r["probs"][n] for n in names])
        require(bool(np.isfinite(probs).all()), f"non-finite probabilities {r}")
        require(abs(probs.sum() - 1.0) < 1e-4, f"probabilities sum to {probs.sum()}")
    for j in range(16):
        require(wave1[j]["index"] == wave2[j % 8]["index"],
                f"image {j % 8} got different classes in different batches")
    require(stats["mean_batch_fill"] >= 4.0, f"requests were not batched: {stats}")

    # The same model with the plain PyTorch versions, on the same card.
    plain.add_class_prompt("Clipboards")
    with torch.inference_mode():
        want = plain(images)
        got = model(images)
    want_logits = want["logits"].float().cpu().numpy()
    got_logits = got["logits"].float().cpu().numpy()
    logit_err = float(np.abs(got_logits - want_logits).max())
    require(logit_err <= LOGIT_TOL, f"served-model logits differ from plain by {logit_err:.3e}")
    want_probs = _plain_probs(want_logits)
    served_probs = np.array([[wave2[j]["probs"][n] for n in names] for j in range(8)])
    prob_err = float(np.abs(served_probs - want_probs).max())
    require(prob_err <= PROB_TOL, f"served probabilities differ from plain by {prob_err:.3e}")
    want_attr = want["attribution"].float().cpu().numpy()
    served_attr = np.array([explain["attribution"][n] for n in names])
    attr_err = float(np.abs(served_attr - want_attr).max())
    require(attr_err <= ATTR_TOL, f"/explain attribution differs from plain by {attr_err:.3e}")
    require(explain["index"] == int(want_logits[0].argmax()), "/explain class differs from plain")
    print(f"serve: vs plain on the card: logits max abs err {logit_err:.3e} (tol {LOGIT_TOL}), "
          f"probs {prob_err:.3e} (tol {PROB_TOL}), attribution {attr_err:.3e} (tol {ATTR_TOL})",
          flush=True)
    timing = time_model(model, plain, images)
    return {"launches": launches, "stats": stats, "wall_s": wall, "logit_err": logit_err,
            "prob_err": prob_err, "attr_err": attr_err, "timing_ms": timing,
            "images": images, "served_logits": got_logits}


def serve_bf16(model, images: np.ndarray, f32_logits: np.ndarray) -> dict:
    """The same weights served in bfloat16 through ``PredictService`` (no HTTP):
    add a class, one batch of 8 concurrent predictions, one explain.  Held
    against the same bfloat16 model run with the plain versions on the card;
    the bfloat16-vs-float32 gap of the plain path is printed beside it."""
    import torch

    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.serve import PredictService

    cfg = model.clip_cfg.replace(dtype="bfloat16")
    kern = FullModel(CLASSES, model.clip_params, cfg)
    plain = FullModel(CLASSES, model.clip_params, cfg.replace(attn_impl="xla"))
    reset_counts()
    service = PredictService(kern, batch_size=8, max_latency_ms=2000.0)
    try:
        names = service.add_class("Clipboards")
        with ThreadPoolExecutor(8) as pool:
            served = list(pool.map(lambda j: service.predict(images[j], timeout=300.0), range(8)))
        explain = service.explain(images[0])
        torch.cuda.synchronize()
        launches = {name: n for name, n in read_counts().items() if name in FORWARD}
        stats = service.stats()
    finally:
        service.close()
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the bfloat16 serving path")
    require(stats["batches"] == 1, f"bfloat16 requests were not batched: {stats}")

    plain.add_class_prompt("Clipboards")
    with torch.inference_mode():
        want = plain(images)
        got = kern(images)
    want_logits = want["logits"].float().cpu().numpy()
    logit_err = float(np.abs(got["logits"].float().cpu().numpy() - want_logits).max())
    served_probs = np.array([[r["probs"][n] for n in names] for r in served])
    prob_err = float(np.abs(served_probs - _plain_probs(want_logits)).max())
    served_attr = np.array([explain["attribution"][n] for n in names])
    attr_err = float(np.abs(served_attr - want["attribution"].float().cpu().numpy()).max())
    gap = float(np.abs(want_logits - f32_logits).max())
    print(f"serve bf16: launches {launches}; vs plain bf16 on the card: logits max abs err "
          f"{logit_err:.3e} (tol {BF16_LOGIT_TOL}), probs {prob_err:.3e} (tol {BF16_PROB_TOL}), "
          f"attribution {attr_err:.3e} (tol {BF16_ATTR_TOL}); plain bf16 vs f32 served logits "
          f"{gap:.3e}", flush=True)
    for p in served_probs:
        require(bool(np.isfinite(p).all()) and abs(p.sum() - 1.0) < 1e-4,
                f"bfloat16 probabilities {p}")
    require(logit_err <= BF16_LOGIT_TOL, f"bf16 served logits differ from plain by {logit_err:.3e}")
    require(prob_err <= BF16_PROB_TOL, f"bf16 served probabilities differ from plain by {prob_err:.3e}")
    require(attr_err <= BF16_ATTR_TOL, f"bf16 /explain attribution differs from plain by {attr_err:.3e}")
    timing = time_model(kern, plain, images, label="bf16")
    return {"launches": launches, "logit_err": logit_err, "prob_err": prob_err,
            "attr_err": attr_err, "bf16_vs_f32_logits": gap, "timing_ms": timing}


def time_model(model, plain, images, label: str = "f32") -> dict:
    """Model-level ms (CUDA events), kernel path vs plain path, no HTTP:
    one image batch (tower + logits against cached text features) and one
    text-side refresh (attribution pass + encode pass over the class bank)."""
    import torch

    from tapclip_tpu_torch.models.model_wrapper import text_features_with_attribution
    from tapclip_tpu_torch.serve import predict_batch

    x = torch.from_numpy(images).cuda()
    out = {}
    with torch.inference_mode():
        for path, m in (("kernel", model), ("plain", plain)):
            bank = m.prompt_learner.bank

            def text():
                return text_features_with_attribution(
                    m.clip_params, m.trainable["ctx"], bank, m.clip_cfg, m.prompt_cfg,
                    m.trainable["adjustor"])[0]

            feats = text()

            def image():
                return predict_batch(m.clip_params, m.clip_cfg, feats, m.trainable["logit_scale"],
                                     bank.class_mask, x)

            out[f"image_batch8_{path}"] = time_ms(image, iters=10, warmup=2)
            out[f"text_refresh_{path}"] = time_ms(text, iters=10, warmup=2)
    print(f"serve timing ({label}, ms, CUDA events, no HTTP): "
          + ", ".join(f"{k}={v:.3f}" for k, v in out.items()), flush=True)
    return out


def check_text_kernels() -> dict:
    """B6, B7 and causal K3 against their plain versions, f32 and bf16: B6
    and B7 at the text shape (a 64-text batch at T 80, valid 77, causal), the
    idiomatic step's shape (8 classes at T 77, causal) and the fused_split
    image shape (8 x 200, valid 197, W 768, 12 heads); causal K3 at the
    idiomatic aux layer's shape (8 classes x 8 heads, T 77, one EOT column
    per class).  Each with CUDA-event times of the kernel, the plain version
    and one library call (SDPA; for B7 the backward of SDPA through
    autograd), and its bound."""
    import torch
    import torch.nn.functional as F

    from tapclip_tpu_torch.ops.attention import attention_reference
    from tapclip_tpu_torch.ops.flash_attention import fused_attention
    from tapclip_tpu_torch.ops.fused_mha import (
        _fused_mha_bwd_cuda,
        _fused_mha_cuda,
        _mha_flash_bwd_cuda,
        fused_mha,
        fused_mha_bwd_reference,
        fused_mha_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {name: {"cases": []} for name in TEXT}

    def report(name, case):
        results[name]["cases"].append(case)
        print(f"text kernel {name} [{case['shape']} {case['dtype']}]: "
              + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in case.items() if k not in ("shape", "dtype")), flush=True)

    # The idiomatic step's shape first: the kernels line reports it.
    shapes = (("idiomatic 8x77x512 h8 causal", (8, 77, 512, 8, 77, True)),
              ("text 64x80x512 h8 valid77 causal", (64, 80, 512, 8, 77, True)),
              ("image 8x200x768 h12 valid197", (8, 200, 768, 12, 197, False)))
    for dtype, tol, bwd_tol in ((torch.float32, F32_TOL, BWD_F32_TOL),
                                (torch.bfloat16, BF16_TOL, BWD_BF16_TOL)):
        dname = str(dtype).replace("torch.", "")
        for label, (B, T, W, nh, valid, causal) in shapes:
            Dh = W // nh
            qkv = (0.5 * torch.randn((B, T, 3 * W), generator=gen, device="cuda")).to(dtype)
            g = torch.randn((B, T, W), generator=gen, device="cuda").to(dtype)
            heads = [t.view(B, T, nh, Dh).transpose(1, 2) for t in qkv.split(W, dim=-1)]
            mask = key_mask(B, T, valid, causal)
            pairs = attn_pairs(B, T, valid, causal)
            with torch.inference_mode():
                got = fused_mha(qkv, nh, valid_len=valid, causal=causal)
                want = fused_mha_reference(qkv, nh, valid, causal)
                torch.cuda.synchronize()
                err = compare(f"fused_mha {label} {dname}", got, want, tol)
                case = {"shape": label, "dtype": dname, **err,
                        "norm_rel_err": _rel_errors([got], [want])[0],
                        "ms": time_ms(lambda: fused_mha(qkv, nh, valid_len=valid, causal=causal)),
                        "plain_ms": time_ms(lambda: fused_mha_reference(qkv, nh, valid, causal)),
                        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(*heads, attn_mask=mask)),
                        **bound(nbytes(qkv, got), 4 * nh * Dh * pairs, dname)}
            report("fused_mha", case)

            with torch.no_grad():
                got = _fused_mha_bwd_cuda(qkv, g, nh, valid, causal)
                want = fused_mha_bwd_reference(qkv, g, nh, valid, causal)
                # The flash chain on the same packed strides (what runs past B7's tile).
                y = _fused_mha_cuda(qkv, nh, valid, causal)
                chain = _mha_flash_bwd_cuda(qkv, g, y, nh, valid, causal)
                torch.cuda.synchronize()
                rel, ab = _rel_errors([got], [want])
                chain_rel = _rel_errors([chain], [want])[0]
                ms = time_ms(lambda: _fused_mha_bwd_cuda(qkv, g, nh, valid, causal))
                chain_ms = time_ms(lambda: _mha_flash_bwd_cuda(qkv, g, y, nh, valid, causal))
                plain_ms = time_ms(lambda: fused_mha_bwd_reference(qkv, g, nh, valid, causal))
            leaves = [t.detach().clone().requires_grad_() for t in heads]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            g_heads = g.view(B, T, nh, Dh).transpose(1, 2)
            library_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g_heads, retain_graph=True))
            report("fused_mha_bwd", {"shape": label, "dtype": dname, "max_rel_err": rel,
                                     "max_abs_err": ab, "ms": ms, "plain_ms": plain_ms,
                                     "library_ms": library_ms, "chain_ms": chain_ms,
                                     "chain_rel_err": chain_rel,
                                     **bound(nbytes(qkv, g, got), 10 * nh * Dh * pairs, dname)})
            require(rel <= bwd_tol, f"fused_mha_bwd {label} {dname}: norm-relative error {rel:.3e} > {bwd_tol}")
            require(chain_rel <= bwd_tol,
                    f"flash chain on packed qkv {label} {dname}: norm-relative error {chain_rel:.3e} > {bwd_tol}")

        # causal K3 at the idiomatic aux layer: 8 classes x 8 heads, T 77, the
        # EOT column of each class after its 5 context tokens.
        B, H, T = 8, 8, 77
        eot = [11, 12, 13, 14, 15, 16, 17, 76]
        q, k, v = (torch.randn((B, H, T, 64), generator=gen, device="cuda").to(dtype) for _ in range(3))
        eot_t = torch.tensor(eot, device="cuda")
        with torch.inference_mode():
            got = fused_attention(q, k, v, causal=True, attn_to_idx=eot_t)
            want = attention_reference(q, k, v, causal=True, attn_to_idx=eot_t)
            torch.cuda.synchronize()
            err = compare(f"causal K3 {dname} out", got[0], want[0], tol)
            aux_err = compare(f"causal K3 {dname} aux", got[1], want[1], F32_TOL)
            print(f"causal K3 {dname}: aux max abs err {aux_err['max_abs_err']:.3e}", flush=True)
            for b, e in enumerate(eot):
                require(not bool(got[1][b, :e].any()), "causal K3: a query before its EOT key has a nonzero aux")
            case = {"shape": "idiomatic 8x8x77 per-class eot", "dtype": dname,
                    **{key: max(err[key], aux_err[key]) for key in err},
                    "ms": time_ms(lambda: fused_attention(q, k, v, causal=True, attn_to_idx=eot_t)),
                    "plain_ms": time_ms(lambda: attention_reference(q, k, v, causal=True, attn_to_idx=eot_t)),
                    "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
                    **bound(4 * nbytes(q) + 4 * B * T, 4 * H * 64 * attn_pairs(B, T, T, True), dname)}
        report("fused_attention_aux_causal", case)
    return results


def _expect(where: str, launches: dict, want: dict) -> None:
    for name, n in want.items():
        require(launches[name] == n, f"{where}: {name} launched {launches[name]} times, expected {n}")


def text_path(model, images: np.ndarray) -> dict:
    """The causal text tower on the served ViT-B/16 weights, f32 and bf16:
    POST /embed_text over HTTP with 5 texts (padded to 8) and 33 (padded to
    64), a zero-shot classifier over Office-Home's 65 class names (two text
    batches) and zero-shot logits on 8 images, each with the launch counts
    set to 0 just before and read just after, and each held against the
    plain path on the card."""
    import torch

    from tapclip_tpu_torch.featurize import make_text_embed_fn
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.serve import PredictService, make_http_server
    from tapclip_tpu_torch.zero_shot import build_zero_shot_classifier, zero_shot_logits

    params = model.clip_params
    texts = {5: [f"a photo of a {n}." for n in OFFICE_HOME[:5]],
             33: [f"a drawing of the {n}." for n in OFFICE_HOME[5:38]]}
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = model.clip_cfg.replace(dtype=dtype)
        plain_cfg = cfg.replace(attn_impl="xla")
        tol = TEXT_TOL[dtype]
        kern = FullModel(CLASSES, params, cfg)
        service = PredictService(kern, batch_size=8, max_latency_ms=50.0)
        server = make_http_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        launches, embedded = {}, {}
        try:
            for n, batch in texts.items():
                reset_counts()
                embedded[n], ms = _sync_ms(lambda: _post(base + "/embed_text", {"texts": batch})["embeddings"])
                launches[f"embed_text {n}"] = read_counts()
                print(f"text {dtype}: POST /embed_text with {n} texts in {ms:.1f} ms", flush=True)
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=10)
        reset_counts()
        clf, clf_ms = _sync_ms(lambda: build_zero_shot_classifier(params, cfg, OFFICE_HOME, kern.tokenizer))
        launches["classifier"] = read_counts()
        reset_counts()
        with torch.inference_mode():
            logits = zero_shot_logits(params, cfg, clf, images)
            torch.cuda.synchronize()
        launches["logits"] = read_counts()

        for n in texts:  # one text batch: 12 causal blocks
            _expect(f"/embed_text {n} {dtype}", launches[f"embed_text {n}"],
                    {"fused_mha": 12, "fused_mlp": 12, "fused_attn_block": 0, "fused_attention_aux": 0})
        _expect(f"zero-shot classifier {dtype}", launches["classifier"],
                {"fused_mha": 24, "fused_mlp": 24, "fused_attn_block": 0, "fused_attention_aux": 0})
        _expect(f"zero-shot logits {dtype}", launches["logits"],
                {"fused_mha": 0, "fused_mlp": 12, "fused_attn_block": 12})

        embed_plain = make_text_embed_fn(plain_cfg)
        errs = {}
        for n, batch in texts.items():
            ids = kern.tokenizer.tokenize(batch, cfg.context_length)
            ids = np.concatenate([ids, np.zeros(((1 << (n - 1).bit_length()) - n, ids.shape[1]), ids.dtype)])
            want = embed_plain(params, ids)[:n].cpu().numpy()
            got = np.asarray(embedded[n], np.float32)
            require(got.shape == want.shape and bool(np.isfinite(got).all()), f"/embed_text {n}: {got.shape}")
            errs[f"embed_text {n}"] = float(np.abs(got - want).max())
        plain_clf = build_zero_shot_classifier(params, plain_cfg, OFFICE_HOME, kern.tokenizer)
        with torch.inference_mode():
            plain_logits = zero_shot_logits(params, plain_cfg, plain_clf, images)
        require(tuple(clf.shape) == (65, cfg.embed_dim), f"classifier shape {tuple(clf.shape)}")
        errs["classifier"] = float((clf - plain_clf).abs().max())
        errs["logits"] = float((logits - plain_logits).abs().max())
        require(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (8, 65), "zero-shot logits")
        print(f"text {dtype}: vs plain on the card: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol embed {tol['embed']}, logits {tol['logits']}); classifier built in {clf_ms:.1f} ms",
              flush=True)
        for key, err in errs.items():
            limit = tol["logits"] if key == "logits" else tol["embed"]
            require(err <= limit, f"text {dtype}: {key} differs from plain by {err:.3e} > {limit}")

        # One text batch of 64 (encode_text), kernel vs plain, CUDA events.
        ids = kern.tokenizer.tokenize([f"a photo of a {n}." for n in OFFICE_HOME[:64]], cfg.context_length)
        with torch.inference_mode():
            timing = {"encode_text_64_kernel": time_ms(lambda: clip_model.encode_text(params, cfg, ids), 10, 2),
                      "encode_text_64_plain": time_ms(lambda: clip_model.encode_text(params, plain_cfg, ids),
                                                      10, 2)}
        print(f"text {dtype}: ms (CUDA events) " + ", ".join(f"{k}={v:.3f}" for k, v in timing.items()),
              flush=True)
        out[dtype] = {"launches": launches, "errors": errs, "timing_ms": timing}
    return out


def idiomatic_train_phase(clip_params, base_cfg, dtype: str) -> dict:
    """Prompt tuning in the idiomatic text mode (cached features, batch 32,
    the five classes in a bank of 8) on the kernels and on the plain
    versions, same weights and batches.  Per step the kernel path must launch
    B6 23 times (11 attribution blocks + 12 encode blocks), causal K3 once,
    B7 and B5 12 times each, and B4 never."""
    import torch

    from tapclip_tpu_torch.config import PromptConfig, TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel, full_model_forward
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step

    cfg = base_cfg.replace(dtype=dtype)
    pcfg = PromptConfig(text_mode="idiomatic")
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((32, cfg.embed_dim)).astype(np.float32),
                rng.integers(0, len(TRAIN_CLASSES), 32)) for _ in range(IDIOMATIC_STEPS)]
    mask = np.ones(32, bool)
    out = {}
    for path, c in (("kernel", cfg), ("plain", cfg.replace(attn_impl="xla"))):
        model = FullModel(TRAIN_CLASSES, clip_params, c, prompt_cfg=pcfg)
        state = init_train_state(model.trainable, make_optimizer(TrainConfig(batch_size=32)))
        step = make_train_step(c, pcfg)
        ctx0 = model.trainable["ctx"].clone().requires_grad_()
        fwd = full_model_forward(
            clip_params, dict(model.trainable, ctx=ctx0), model.prompt_learner.bank, None,
            torch.from_numpy(batches[0][1]).cuda(), clip_cfg=c, prompt_cfg=pcfg, with_loss=True,
            image_feats=torch.from_numpy(batches[0][0]).cuda())
        grad0 = torch.autograd.grad(fwd["loss"], [ctx0])[0].float().cpu().numpy()
        reset_counts()
        rec = {"loss": [], "grad_norm": [], "step_ms": [], "grad0": grad0,
               "ctx0": model.trainable["ctx"].detach().float().cpu().numpy()}
        for x, y in batches:
            (state, metrics), ms = _sync_ms(lambda: step(clip_params, state, model.prompt_learner.bank, x, y, mask))
            rec["loss"].append(float(metrics["loss"]))
            rec["grad_norm"].append(float(metrics["grad_norm"]))
            rec["step_ms"].append(ms)
        rec["launches"] = read_counts()
        rec["ctx"] = state.params["ctx"].detach().float().cpu().numpy()
        out[path] = rec
    k, p = out["kernel"], out["plain"]
    n = IDIOMATIC_STEPS
    _expect(f"idiomatic train {dtype}", k["launches"],
            {"fused_mha": 23 * n, "fused_attention_aux_causal": n, "fused_attention_aux": n,
             "fused_mha_bwd": 12 * n, "fused_mlp_bwd": 12 * n, "fused_mlp": 24 * n,
             "fused_attn_block": 0, "fused_attn_block_bwd": 0})
    require(all(v == 0 for v in p["launches"].values()), f"plain path launched kernels {p['launches']}")
    tol = IDIOMATIC_TOL[dtype]
    errs = {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"])),
        "grad_norm": max(abs(a - b) / abs(b) for a, b in zip(k["grad_norm"], p["grad_norm"])),
        "grad": float(np.abs(k["grad0"] - p["grad0"]).max() / np.abs(p["grad0"]).max()),
        "ctx_step": _step_err(k["ctx"], k["ctx0"], p["ctx"], p["ctx0"]),
    }
    ctx_abs = float(np.abs(k["ctx"] - p["ctx"]).max())
    worst = np.unravel_index(np.abs(k["ctx"] - p["ctx"]).argmax(), k["ctx"].shape)
    print(f"idiomatic train {dtype}: {n} cached-feature steps per path; kernel-path launches {k['launches']}",
          flush=True)
    print(f"idiomatic train {dtype}: step ms (batch 32, incl. host) kernel "
          f"{[round(v, 2) for v in k['step_ms']]} vs plain {[round(v, 2) for v in p['step_ms']]}; loss kernel "
          f"{[round(v, 5) for v in k['loss']]} plain {[round(v, 5) for v in p['loss']]}; kernel vs plain: loss "
          f"rel err {errs['loss']:.3e} (tol {tol['loss']}), grad norm rel err {errs['grad_norm']:.3e} "
          f"(tol {tol['grad_norm']}), first gradient max abs err / max |g| {errs['grad']:.3e} "
          f"(tol {tol['grad']}, max |g| {np.abs(p['grad0']).max():.3e}), ctx displacement norm-rel err "
          f"{errs['ctx_step']:.3e} (tol {tol['ctx_step']}), ctx max abs err {ctx_abs:.3e} at "
          f"ctx{[int(i) for i in worst]}, whose first gradient is {k['grad0'][worst]:.3e} "
          f"kernel / {p['grad0'][worst]:.3e} plain", flush=True)
    for path in (k, p):
        require(all(np.isfinite(path["loss"] + path["grad_norm"])), "non-finite idiomatic loss")
    for key, err in errs.items():
        require(err <= tol[key], f"idiomatic train {dtype}: kernel vs plain {key} error {err:.3e} > {tol[key]}")
    return {"launches": k["launches"], "errors": errs,
            "step_ms": {"kernel": k["step_ms"], "plain": p["step_ms"]}}


def fused_split_phase(model, images: np.ndarray) -> dict:
    """One image batch of 8 with ``attn_impl="fused_split"`` (plain
    projections around B6 in every vision block) against ``"auto"`` (K2)."""
    import torch

    from tapclip_tpu_torch.models import clip as clip_model

    params, cfg = model.clip_params, model.clip_cfg
    split = cfg.replace(attn_impl="fused_split")
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        reset_counts()
        got = clip_model.l2_normalize(clip_model.encode_image(params, split, x))
        torch.cuda.synchronize()
        launches = read_counts()
        want = clip_model.l2_normalize(clip_model.encode_image(params, cfg, x))
        err = float((got - want).abs().max())
        timing = {"fused_split": time_ms(lambda: clip_model.encode_image(params, split, x), 10, 2),
                  "auto": time_ms(lambda: clip_model.encode_image(params, cfg, x), 10, 2)}
    _expect("fused_split image batch", launches,
            {"fused_mha": 12, "fused_mlp": 12, "fused_attn_block": 0, "fused_attention_aux": 0})
    print(f"fused_split: image batch of 8, unit-norm features vs auto max abs err {err:.3e} "
          f"(tol {TEXT_TOL['float32']['embed']}); ms fused_split {timing['fused_split']:.3f} vs auto "
          f"{timing['auto']:.3f}", flush=True)
    require(err <= TEXT_TOL["float32"]["embed"], f"fused_split features differ from auto by {err:.3e}")
    return {"launches": launches, "err": err, "timing_ms": timing}


def _sdpa_bwd(q, k, v, g, mask):
    """SDPA's backward through autograd, on the same inputs: a closure to time."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def check_flash_kernels() -> dict:
    """The flash backward chain kernel by kernel (LSE, dK/dV, dQ) against its
    plain versions on the same inputs (the plain LSE and delta into both
    gradient kernels), the whole chain against the single-block formula, and
    K3 at T 4096, f32 and bf16, with CUDA-event times, SDPA's and the bound."""
    import torch
    import torch.nn.functional as F

    from tapclip_tpu_torch.ops.attention import attention_reference
    from tapclip_tpu_torch.ops.flash_attention import (
        _flash_bwd_dkv_cuda,
        _flash_bwd_dq_cuda,
        _flash_lse_cuda,
        attention_bwd_dkv_reference,
        attention_bwd_dq_reference,
        attention_bwd_reference,
        attention_delta,
        attention_lse_reference,
        flash_attention_bwd_cuda,
        fused_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    results = {name: {"cases": []} for name in FLASH}
    # The pallas training step's shape first: the kernels line reports it.
    shapes = (("text 8x8x88 valid82", (8, 8, 88, 82, False)),
              ("idiomatic 8x8x77 causal", (8, 8, 77, 77, True)),
              ("vit-l-336 4x16x584 valid577", (4, 16, 584, 577, False)),
              ("long 1x16x4096 valid4000", (1, 16, 4096, 4000, False)),
              ("long 1x16x4096 valid4000 causal", (1, 16, 4096, 4000, True)))

    def report(name, case):
        results[name]["cases"].append(case)
        print(f"flash kernel {name} [{case['shape']} {case['dtype']}]: "
              + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in case.items() if k not in ("shape", "dtype")), flush=True)

    for dtype, bwd_tol in ((torch.float32, BWD_F32_TOL), (torch.bfloat16, BWD_BF16_TOL)):
        dname = str(dtype).replace("torch.", "")
        for label, (B, H, T, valid, causal) in shapes:
            iters = 5 if T > 2048 else 20
            q, k, v, g = (torch.randn((B, H, T, 64), generator=gen, device="cuda").to(dtype) for _ in range(4))
            valid_t = torch.full((B,), valid, dtype=torch.int32, device="cuda")
            mask = key_mask(B, T, valid, causal)
            pairs = H * attn_pairs(B, T, valid, causal)
            rows = 4 * B * H * T  # one f32 [B, H, T] row vector
            with torch.no_grad():
                out, _ = fused_attention(q, k, v, causal=causal, kv_valid_len=valid_t)
                lse = attention_lse_reference(q, k, valid_t, causal)
                delta = attention_delta(out, g)
                dk, dv, dq = (torch.empty_like(q) for _ in range(3))
                kern = {
                    "flash_lse": lambda: _flash_lse_cuda(q, k, valid_t, causal),
                    "flash_bwd_dkv": lambda: _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, valid_t, causal, dk, dv),
                    "flash_bwd_dq": lambda: _flash_bwd_dq_cuda(q, k, v, g, lse, delta, valid_t, causal, dq),
                }
                plain = {
                    "flash_lse": lambda: attention_lse_reference(q, k, valid_t, causal),
                    "flash_bwd_dkv": lambda: attention_bwd_dkv_reference(q, k, v, g, lse, delta, valid_t, causal),
                    "flash_bwd_dq": lambda: attention_bwd_dq_reference(q, k, v, g, lse, delta, valid_t, causal),
                }
                # (bytes in and out, operations): 2 FLOP per multiply-add over the visible pairs.
                work = {"flash_lse": (nbytes(q, k) + rows, 2 * 64 * pairs),
                        "flash_bwd_dkv": (nbytes(q, k, v, g) + 2 * rows + 2 * nbytes(q), 8 * 64 * pairs),
                        "flash_bwd_dq": (nbytes(q, k, v, g) + 2 * rows + nbytes(q), 6 * 64 * pairs)}
                library_ms = time_ms(_sdpa_bwd(q, k, v, g, mask), iters, 1)
                chain_ms = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, g, valid_t, causal), iters, 1)
                for name in ("flash_lse", "flash_bwd_dkv", "flash_bwd_dq"):
                    got, want = kern[name](), plain[name]()
                    torch.cuda.synchronize()
                    if name == "flash_lse":  # f32 math on the same inputs in both dtypes
                        err = compare(f"{name} {label} {dname}", got, want, F32_TOL)
                        err["max_rel_err"] = _rel_errors([got], [want])[0]
                    else:
                        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                        rel, ab = _rel_errors(got, want)
                        require(rel <= bwd_tol, f"{name} {label} {dname}: norm-relative error {rel:.3e} > {bwd_tol}")
                        err = {"max_abs_err": ab, "max_rel_err": rel}
                    report(name, {"shape": label, "dtype": dname, **err,
                                  "ms": time_ms(kern[name], iters, 1), "plain_ms": time_ms(plain[name], iters, 1),
                                  "library_ms": None if name == "flash_lse" else library_ms,
                                  "chain_ms": chain_ms, **bound(*work[name], dname)})
                # The whole chain (delta, LSE, dK/dV, dQ) against the single-block formula.
                chain = flash_attention_bwd_cuda(q, k, v, out, g, valid_t, causal)
                rel, ab = _rel_errors(chain, attention_bwd_reference(q, k, v, g, valid_t, causal))
                print(f"flash chain [{label} {dname}]: vs the single-block formula norm-rel err {rel:.3e}, "
                      f"max abs {ab:.3e}; chain {chain_ms:.4g} ms vs SDPA backward {library_ms:.4g} ms",
                      flush=True)
                require(rel <= bwd_tol, f"flash chain {label} {dname}: norm-relative error {rel:.3e} > {bwd_tol}")

            if T > 2048:  # K3 where the JAX package runs its blockwise forward
                eot = torch.full((B,), valid - 1, device="cuda")
                with torch.inference_mode():
                    got = fused_attention(q, k, v, causal=causal, kv_valid_len=valid_t, attn_to_idx=eot)
                    want = attention_reference(q, k, v, causal=causal, kv_valid_len=valid_t, attn_to_idx=eot)
                    torch.cuda.synchronize()
                    err = {}
                    for part, a, b in (("out", got[0], want[0]), ("aux", got[1], want[1])):
                        rel, ab = _rel_errors([a], [b])
                        limit = K3_LONG_TOL[dname][part]
                        require(rel <= limit, f"K3 {label} {dname} {part}: norm-relative error {rel:.3e} > {limit}")
                        err[f"{part}_rel_err"], err[f"{part}_abs_err"] = rel, ab
                    report("fused_attention_aux_long", {
                        "shape": label, "dtype": dname, **err,
                        "max_abs_err": max(err["out_abs_err"], err["aux_abs_err"]),
                        "max_rel_err": max(err["out_rel_err"], err["aux_rel_err"]),
                        "ms": time_ms(lambda: fused_attention(q, k, v, causal=causal, kv_valid_len=valid_t,
                                                              attn_to_idx=eot), iters, 1),
                        "plain_ms": time_ms(lambda: attention_reference(q, k, v, causal=causal, kv_valid_len=valid_t,
                                                                         attn_to_idx=eot), iters, 1),
                        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                              iters, 1),
                        **bound(4 * nbytes(q) + 4 * B * T, 4 * 64 * pairs, dname)})
            del q, k, v, g, out, lse, delta, dk, dv, dq
            torch.cuda.empty_cache()
    return results


def check_long_repairs() -> dict:
    """B7 and B4 past their [T, T] tile, at the ViT-L/14-336 vision shape
    (4 x 584, valid 577, W 1024, 16 heads), f32 and bf16: the autograd
    Functions' backward (the flash chain on the packed strides; the split
    composition) against the plain backward, with launch counts and times."""
    import torch

    from tapclip_tpu_torch.ops.flash_attention import fused_attention
    from tapclip_tpu_torch.ops.fused_mha import (
        attn_block_bwd_reference,
        fused_attn_block,
        fused_mha,
        fused_mha_bwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    B, T, W, nh, valid = 4, 584, 1024, 16, 577
    label = f"vit-l-336 {B}x{T}x{W} h{nh} valid{valid}"
    out = {}

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    for dtype, tol in ((torch.float32, BWD_F32_TOL), (torch.bfloat16, BWD_BF16_TOL)):
        dname = str(dtype).replace("torch.", "")
        qkv = (0.5 * rn(B, T, 3 * W)).to(dtype).requires_grad_()
        g = rn(B, T, W).to(dtype)
        reset_counts()
        y = fused_mha(qkv, nh, valid_len=valid)
        (got,) = torch.autograd.grad(y, [qkv], g, retain_graph=True)
        torch.cuda.synchronize()
        launches = read_counts()
        _expect(f"B7 past its tile {dname}", launches, {"fused_mha": 1, "fused_mha_bwd": 0, "flash_lse": 1,
                                                        "flash_bwd_dkv": 1, "flash_bwd_dq": 1})
        with torch.no_grad():
            want = fused_mha_bwd_reference(qkv, g, nh, valid, False)
            rel, ab = _rel_errors([got], [want])
            case = {"shape": label, "dtype": dname, "max_rel_err": rel, "max_abs_err": ab,
                    "ms": time_ms(lambda: torch.autograd.grad(y, [qkv], g, retain_graph=True), 10, 2),
                    "plain_ms": time_ms(lambda: fused_mha_bwd_reference(qkv, g, nh, valid, False), 10, 2)}
        out[f"fused_mha_bwd {dname}"] = case
        print(f"B7 past its tile [{label} {dname}]: flash chain on the packed strides vs plain B7 "
              + ", ".join(f"{k}={v:.4g}" for k, v in case.items() if isinstance(v, float)), flush=True)
        require(rel <= tol, f"B7 past its tile {dname}: norm-relative error {rel:.3e} > {tol}")

        x, gx = rn(B, T, W).to(dtype), rn(B, T, W).to(dtype)
        p = [1.0 + rn(W, s=0.1), rn(W, s=0.1), rn(W, 3 * W, s=W ** -0.5), rn(3 * W, s=0.1),
             rn(W, W, s=W ** -0.5), rn(W, s=0.1)]
        leaves = [t.clone().requires_grad_() for t in [x, *p]]
        reset_counts()
        y = fused_attn_block(leaves[0], {"scale": leaves[1], "bias": leaves[2]},
                             dict(zip(("w_qkv", "b_qkv", "w_out", "b_out"), leaves[3:])), nh, valid_len=valid)
        got = torch.autograd.grad(y, leaves, gx, retain_graph=True)
        torch.cuda.synchronize()
        launches = read_counts()
        _expect(f"B4 past its tile {dname}", launches, {"fused_attn_block": 1, "fused_attn_block_bwd": 0,
                                                        "fused_mha": 1, "flash_bwd_dq": 1})
        with torch.no_grad():
            want = attn_block_bwd_reference(x, gx, *p[:5], nh, valid, 1e-5)
            rel, ab = _rel_errors(got, want)
            case = {"shape": label, "dtype": dname, "max_rel_err": rel, "max_abs_err": ab,
                    "ms": time_ms(lambda: torch.autograd.grad(y, leaves, gx, retain_graph=True), 10, 2),
                    "plain_ms": time_ms(lambda: attn_block_bwd_reference(x, gx, *p[:5], nh, valid, 1e-5), 10, 2)}
        out[f"fused_attn_block_bwd {dname}"] = case
        print(f"B4 past its tile [{label} {dname}]: split composition (B6 + flash chain) vs plain B4, all seven "
              "outputs " + ", ".join(f"{k}={v:.4g}" for k, v in case.items() if isinstance(v, float)), flush=True)
        require(rel <= tol, f"B4 past its tile {dname}: norm-relative error {rel:.3e} > {tol}")
        del qkv, g, y, got, want, x, gx, p, leaves
        torch.cuda.empty_cache()
    return out


def pallas_train_phase(clip_params, base_cfg, dtype: str) -> dict:
    """Prompt tuning with ``attn_impl="pallas"`` in both text modes (cached
    features, batch 32, the five classes in a bank of 8) against ``"xla"``
    on the card, same weights and batches.  Per step the kernel path must
    launch K3 24 times (12 attribution + 12 encode blocks; causal in
    idiomatic mode), the flash chain's three kernels 12 times each (the
    encode pass's backward), and nothing else."""
    import torch

    from tapclip_tpu_torch.config import PromptConfig, TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel, full_model_forward
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step

    n = PALLAS_STEPS
    out = {}
    for mode, tol in (("ref_compat", TRAIN_TOL[dtype]), ("idiomatic", IDIOMATIC_TOL[dtype])):
        cfg = base_cfg.replace(dtype=dtype, attn_impl="pallas")
        pcfg = PromptConfig(text_mode=mode)
        rng = np.random.default_rng(6)
        batches = [(rng.standard_normal((32, cfg.embed_dim)).astype(np.float32),
                    rng.integers(0, len(TRAIN_CLASSES), 32)) for _ in range(n)]
        mask = np.ones(32, bool)
        paths = {}
        for path, c in (("kernel", cfg), ("plain", cfg.replace(attn_impl="xla"))):
            model = FullModel(TRAIN_CLASSES, clip_params, c, prompt_cfg=pcfg)
            state = init_train_state(model.trainable, make_optimizer(TrainConfig(batch_size=32)))
            step = make_train_step(c, pcfg)
            ctx0 = model.trainable["ctx"].clone().requires_grad_()
            fwd = full_model_forward(
                clip_params, dict(model.trainable, ctx=ctx0), model.prompt_learner.bank, None,
                torch.from_numpy(batches[0][1]).cuda(), clip_cfg=c, prompt_cfg=pcfg, with_loss=True,
                image_feats=torch.from_numpy(batches[0][0]).cuda())
            grad0 = torch.autograd.grad(fwd["loss"], [ctx0])[0].float().cpu().numpy()
            rec = {"loss": [], "grad_norm": [], "step_ms": [], "grad0": grad0,
                   "ctx0": model.trainable["ctx"].detach().float().cpu().numpy()}
            reset_counts()
            for x, y in batches:
                (state, metrics), ms = _sync_ms(lambda: step(clip_params, state, model.prompt_learner.bank, x, y, mask))
                rec["loss"].append(float(metrics["loss"]))
                rec["grad_norm"].append(float(metrics["grad_norm"]))
                rec["step_ms"].append(ms)
            rec["launches"] = read_counts()
            rec["ctx"] = state.params["ctx"].detach().float().cpu().numpy()
            paths[path] = rec
        k, p = paths["kernel"], paths["plain"]
        _expect(f"pallas train {mode} {dtype}", k["launches"], {
            "fused_attention_aux": 24 * n, "fused_attention_aux_causal": 24 * n * (mode == "idiomatic"),
            "flash_lse": 12 * n, "flash_bwd_dkv": 12 * n, "flash_bwd_dq": 12 * n,
            "fused_mlp": 0, "fused_attn_block": 0, "fused_attn_block_bwd": 0, "fused_mlp_bwd": 0,
            "fused_mha": 0, "fused_mha_bwd": 0})
        require(all(v == 0 for v in p["launches"].values()), f"plain path launched kernels {p['launches']}")
        errs = {
            "loss": max(abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"])),
            "grad_norm": max(abs(a - b) / abs(b) for a, b in zip(k["grad_norm"], p["grad_norm"])),
            "grad": float(np.abs(k["grad0"] - p["grad0"]).max() / np.abs(p["grad0"]).max()),
            "ctx_step": _step_err(k["ctx"], k["ctx0"], p["ctx"], p["ctx0"]),
        }
        print(f"pallas train {mode} {dtype}: {n} cached-feature steps per path; kernel-path launches "
              f"{k['launches']}", flush=True)
        print(f"pallas train {mode} {dtype}: step ms (batch 32, incl. host) kernel "
              f"{[round(v, 2) for v in k['step_ms']]} vs plain {[round(v, 2) for v in p['step_ms']]}; loss kernel "
              f"{[round(v, 5) for v in k['loss']]} plain {[round(v, 5) for v in p['loss']]}; kernel vs plain: "
              + ", ".join(f"{key} {err:.3e} (tol {tol.get(key)})" for key, err in errs.items()), flush=True)
        for path in (k, p):
            require(all(np.isfinite(path["loss"] + path["grad_norm"])), "non-finite pallas-path loss")
        for key, err in errs.items():
            if key in tol:
                require(err <= tol[key], f"pallas train {mode} {dtype}: kernel vs plain {key} error "
                                         f"{err:.3e} > {tol[key]}")
        out[mode] = {"launches": k["launches"], "errors": errs,
                     "step_ms": {"kernel": k["step_ms"], "plain": p["step_ms"]}}
    return out



# --- the int8 eval tower (B13, B14), its variants (S5) and the int8 product (S6) ---


def int8_bound(n_bytes: int, int8_ops: float, f32_flops: float = 0.0) -> dict:
    """As :func:`bound`, with int8 products at the tensor cores' int8 peak and
    the f32 work (the attention core) at the f32 peak outside them."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * (int8_ops / PEAK_INT8_OPS + f32_flops / PEAK_FLOPS["float32"])
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _update_rel(got, want, x) -> float:
    """Norm-relative error of a block's update: ||got - want|| / ||want - x||."""
    got, want, x = got.float(), want.float(), x.float()
    return float((got - want).norm() / (want - x).norm())


def _int8_case(gen, B, T, W, nh, dtype):
    """x, LayerNorm, float MLP / attention weights and their quantized forms."""
    import torch

    from tapclip_tpu_torch.ops.int8_attn import quantize_attn
    from tapclip_tpu_torch.ops.int8_mlp import quantize_mlp

    H = 4 * W

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    x = rn(B, T, W).to(dtype)
    ln = {"scale": 1.0 + rn(W, s=0.1), "bias": rn(W, s=0.1)}
    mlp = {"w_fc": rn(W, H, s=W ** -0.5), "b_fc": rn(H, s=0.1), "w_proj": rn(H, W, s=H ** -0.5),
           "b_proj": rn(W, s=0.1)}
    attn = {"w_qkv": rn(W, 3 * W, s=W ** -0.5), "b_qkv": rn(3 * W, s=0.1), "w_out": rn(W, W, s=W ** -0.5),
            "b_out": rn(W, s=0.1)}
    return x, ln, mlp, attn, quantize_mlp(mlp), quantize_attn(attn)


def _weight_only(q, w, s):
    return q[w].float() * q[s]


def check_int8_kernels() -> dict:
    """B13 and B14 against their plain versions with the same draws, f32 and
    bf16, stochastic and round to nearest, at ViT-B/16 (8 x 200, W 768; B14
    valid 197, and the pruned back blocks at 8 x 96 with no mask) and ViT-L/14
    (8 x 264, W 1024, H 4,096; 16 heads, valid 257), with CUDA-event times of
    the kernel, its plain version and the wrapper (weights quantized on the
    fly) at the ViT-B/16 shape; then, in f32, the 64-seed mean of each
    stochastic block against the weight-only-quantized float block."""
    import torch

    from tapclip_tpu_torch.ops.fused_mha import attn_block_reference
    from tapclip_tpu_torch.ops.int8_attn import int8_attn_block, int8_attn_cuda, int8_attn_plain
    from tapclip_tpu_torch.ops.int8_mlp import gelu, int8_mlp_block, int8_mlp_cuda, int8_mlp_plain, ln_f32

    gen = torch.Generator(device="cuda").manual_seed(7)
    results = {"int8_mlp": {"cases": []}, "int8_attn": {"cases": []}}
    shapes = (("image 8x200x768 h12 valid197", (8, 200, 768, 12, 197), True),
              ("pruned 8x96x768 h12", (8, 96, 768, 12, 96), False),
              ("vit-l 8x264x1024 h16 valid257", (8, 264, 1024, 16, 257), False))
    f32, bf16 = torch.float32, torch.bfloat16
    keep = {}
    for dtype in (f32, bf16):
        dname = str(dtype).replace("torch.", "")
        for label, (B, T, W, nh, valid), timed in shapes:
            x, ln, mlp, attn, qm, qa = _int8_case(gen, B, T, W, nh, dtype)
            g, b = ln["scale"], ln["bias"]
            R, H = B * T, 4 * W
            vec = 4 * (2 * W + 2 * H + 2 * W)
            mlp_work = int8_bound(nbytes(x, x, qm["w_fc"], qm["w_proj"]) + vec, 4 * R * W * H)
            attn_work = int8_bound(nbytes(x, x, qa["w_qkv"], qa["w_out"]) + 4 * 10 * W, 8 * R * W * W,
                                   4 * W * attn_pairs(B, T, valid))
            for det in (False, True):
                mode = "round-to-nearest" if det else "stochastic"
                runs = {"int8_mlp": (lambda: int8_mlp_cuda(x, g, b, qm, deterministic=det),
                                     lambda: int8_mlp_plain(x, g, b, qm, deterministic=det),
                                     lambda: int8_mlp_block(x, ln, mlp, deterministic=det), mlp_work),
                        "int8_attn": (lambda: int8_attn_cuda(x, g, b, qa, nh, valid, deterministic=det),
                                      lambda: int8_attn_plain(x, g, b, qa, nh, valid, deterministic=det),
                                      lambda: int8_attn_block(x, ln, attn, nh, valid_len=valid, deterministic=det),
                                      attn_work)}
                for name, (kern, plain, wrapper, work) in runs.items():
                    if name == "int8_mlp" and label.startswith("pruned"):
                        continue  # the MLP sees rows only: the image shape covers it
                    shape = label if name == "int8_attn" else f"{label.split(' h')[0]} H{H}"
                    with torch.inference_mode():
                        got, want = kern(), plain()
                        torch.cuda.synchronize()
                        require(bool(torch.isfinite(got.float()).all()), f"{name} {label}: not finite")
                        case = {"shape": shape, "dtype": dname, "mode": mode,
                                "update_rel_err": _update_rel(got, want, x),
                                "max_rel_err": float((got.float() - want.float()).norm() / want.float().norm()),
                                "max_abs_err": float((got.float() - want.float()).abs().max())}
                        if timed:
                            case.update(ms=time_ms(kern), plain_ms=time_ms(plain, 10, 2),
                                        wrapper_ms=time_ms(wrapper), library_ms=None, **work)
                    results[name]["cases"].append(case)
                    print(f"int8 kernel {name} [{shape} {dname} {mode}]: "
                          + ", ".join(f"{k}={v:.4g}" for k, v in case.items() if isinstance(v, float)),
                          flush=True)
            if dtype == f32 and timed:
                keep = {"x": x, "ln": ln, "qm": qm, "qa": qa, "nh": nh, "valid": valid}

    # The stochastic blocks' mean over 64 seeds, f32, ViT-B/16.
    x, ln, qm, qa, nh, valid = (keep[k] for k in ("x", "ln", "qm", "qa", "nh", "valid"))
    g, b = ln["scale"], ln["bias"]
    with torch.inference_mode():
        y = ln_f32(x, g, b, 1e-5)
        wo_mlp = x + (gelu(y @ _weight_only(qm, "w_fc", "s_fc") + qm["b_fc"])
                      @ _weight_only(qm, "w_proj", "s_proj") + qm["b_proj"])
        wo_attn = attn_block_reference(x, g, b, _weight_only(qa, "w_qkv", "s_qkv"), qa["b_qkv"],
                                       _weight_only(qa, "w_out", "s_out"), qa["b_out"], nh, valid, 1e-5)
        stats = {}
        for name, run, ref in (("int8_mlp", lambda s: int8_mlp_cuda(x, g, b, qm, seed=s), wo_mlp),
                               ("int8_attn", lambda s: int8_attn_cuda(x, g, b, qa, nh, valid, seed=s), wo_attn)):
            one = run(0)
            mean = sum(run(s).double() for s in range(INT8_SEEDS)) / INT8_SEEDS
            e1, em = _update_rel(one, ref, x), _update_rel(mean, ref, x)
            stats[name] = {"one_draw_rel_err": e1, "mean_rel_err": em, "gain": e1 / em}
            print(f"int8 {name}: vs the weight-only-quantized f32 block, one draw {e1:.3e}, mean of "
                  f"{INT8_SEEDS} seeds {em:.3e}: {e1 / em:.2f}x closer (need {INT8_MEAN_GAIN}x)", flush=True)
    for name, res in results.items():
        for c in res["cases"]:
            tol = INT8_TOL[c["dtype"]]
            require(c["update_rel_err"] <= tol, f"{name} {c['shape']} {c['dtype']} {c['mode']}: update "
                                                f"norm-relative error {c['update_rel_err']:.3e} > {tol}")
        results[name]["mean_of_seeds"] = stats[name]
        require(stats[name]["gain"] >= INT8_MEAN_GAIN,
                f"{name}: the {INT8_SEEDS}-seed mean is only {stats[name]['gain']:.2f}x closer than one draw")
    return results


def check_int8_variants() -> dict:
    """S5: B13's erf3 / recipmul variants against the base kernel (same draws)
    and against their own plain versions, timed in turns, f32, ViT-B/16."""
    from tapclip_tpu_torch.scripts.int8_mlp_ab import run

    res = run(B=8, model="ViT-B-16", reps=3)
    for name, v in res["variants"].items():
        print(f"int8 variant {name} [{res['shape']} {res['dtype']}]: median {v['median_ms']:.4g} ms "
              f"(x{v['ratio']:.3f} of base), plain {v['plain_ms']:.4g} ms, vs base {v['vs_base_rel_err']:.3e}, "
              f"vs its plain version (update) {v['vs_plain_update_rel_err']:.3e}", flush=True)
        require(v["vs_base_rel_err"] <= INT8_VARIANT_TOL,
                f"int8 variant {name}: {v['vs_base_rel_err']:.3e} from the base > {INT8_VARIANT_TOL}")
        require(v["vs_plain_update_rel_err"] <= INT8_TOL["float32"],
                f"int8 variant {name}: {v['vs_plain_update_rel_err']:.3e} from its plain version")
    return res


def check_int8_gemm() -> dict:
    """S6 at the probe's shape (exact against float64, timed beside gemm.cu in
    bf16, torch._int_mm and torch.matmul in bf16) and at B13's two product
    shapes."""
    from tapclip_tpu_torch.scripts.int8_probe import PROBE_SHAPE, probe

    out = {}
    for label, shape, iters in (("probe", PROBE_SHAPE, 3), ("b13 fc", (1600, 768, 3072), 10),
                                ("b13 proj", (1600, 3072, 768), 10)):
        out[label] = probe(*shape, iters=iters)
        print(f"int8 gemm [{label} {out[label]['shape']}]: "
              + ", ".join(f"{k}={v:.4g}" for k, v in out[label].items() if isinstance(v, float)), flush=True)
    return out


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn(original, *args, **kwargs)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, lambda *a, **k: fn(orig, *a, **k))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def plain_int8():
    """The int8 blocks of ``block_forward`` run their plain versions on the
    card (the wrappers launch the kernels on a CUDA tensor)."""
    from tapclip_tpu_torch.models import layers
    from tapclip_tpu_torch.ops.int8_attn import int8_attn_plain, quantize_attn
    from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_plain, quantize_mlp

    def mlp(_, x, ln, p, *, eps=1e-5, seed=0, deterministic=False):
        return int8_mlp_plain(x, ln["scale"], ln["bias"], quantize_mlp(p), eps=eps, seed=seed,
                              deterministic=deterministic)

    def attn(_, x, ln, p, n_heads, *, valid_len=None, eps=1e-5, seed=0, deterministic=False):
        valid = x.shape[1] if valid_len is None else valid_len
        return int8_attn_plain(x, ln["scale"], ln["bias"], quantize_attn(p), n_heads, valid, eps=eps,
                               seed=seed, deterministic=deterministic)

    with patched(layers, "int8_mlp_block", mlp), patched(layers, "int8_attn_block", attn):
        yield


@contextlib.contextmanager
def block_lengths(record: list):
    """Record the sequence length of every vision/text block's attention and
    MLP half (kernel or plain) that ``block_forward`` runs."""
    from tapclip_tpu_torch.models import layers

    def spy(kind):
        def call(orig, x, *a, **k):
            record.append((kind, x.shape[1]))
            return orig(x, *a, **k)
        return call

    with contextlib.ExitStack() as stack:
        for name, kind in (("int8_attn_block", "attn"), ("fused_attn_block", "attn"),
                           ("int8_mlp_block", "mlp"), ("fused_mlp_block", "mlp")):
            stack.enter_context(patched(layers, name, spy(kind)))
        yield


def _http_drive(model, images) -> dict:
    """Add a class, 16 concurrent uint8 /predict (two batches of 8), 8 more
    (one batch, text side cached), one /explain, over HTTP on localhost.
    Launch counts: set to 0 just before, read after the 16, after the 8 and
    at the end."""
    import torch

    from tapclip_tpu_torch.serve import PredictService, make_http_server

    service = PredictService(model, batch_size=8, max_latency_ms=2000.0)
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_counts()
        t0 = time.perf_counter()
        names = _post(base + "/classes", {"name": "Clipboards"})["classes"]
        with ThreadPoolExecutor(16) as pool:
            wave1 = list(pool.map(lambda j: _post(base + "/predict", {"pixels": images[j % 8].tolist()}),
                                  range(16)))
            torch.cuda.synchronize()
            after1 = read_counts()
            wave2 = list(pool.map(lambda j: _post(base + "/predict", {"pixels": images[j].tolist()}), range(8)))
        torch.cuda.synchronize()
        after2 = read_counts()
        explain = _post(base + "/explain", {"pixels": images[0].tolist()})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = read_counts()
        stats = service.stats()
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    require(names == CLASSES + ["Clipboards"], f"/classes returned {names}")
    for r in wave1 + wave2 + [explain]:
        probs = np.array([r["probs"][n] for n in names])
        require(bool(np.isfinite(probs).all()) and abs(probs.sum() - 1.0) < 1e-4, f"probabilities {probs}")
    batch = {k: after2[k] - after1[k] for k in total}
    return {"names": names, "wave2": wave2, "explain": explain, "stats": stats, "wall_s": wall,
            "launches": total, "batch_launches": batch}


def _image_features(params, cfg, x):
    import torch

    from tapclip_tpu_torch.models import clip as clip_model

    with torch.inference_mode():
        return clip_model.l2_normalize(clip_model.encode_image(params, cfg, x)).float()


def int8_serve_phase(model, images: np.ndarray) -> dict:
    """ViT-B/16 with ``quantize_tower`` served through ``PredictService`` and
    HTTP, f32 and bf16, stochastic and round to nearest: per image batch
    exactly 12 B13 + 12 B14 and no K1, K2; served probabilities against the
    same model on the plain int8 versions on the card; image features against
    the float tower; image-batch ms of the int8 kernels, their plain versions
    and the float kernels (K1/K2)."""
    import torch

    from tapclip_tpu_torch.models.model_wrapper import FullModel, text_features_with_attribution
    from tapclip_tpu_torch.serve import predict_batch

    params = model.clip_params
    x = torch.from_numpy(images).cuda()
    out = {}
    for dtype in ("float32", "bfloat16"):
        for det in (False, True):
            mode = "round-to-nearest" if det else "stochastic"
            cfg = model.clip_cfg.replace(dtype=dtype)
            cfg_q = cfg.replace(quantize_tower=True, int8_deterministic=det)
            kern = FullModel(CLASSES, params, cfg_q)
            drive = _http_drive(kern, images)
            L = cfg.vision_layers
            _expect(f"int8 serving {dtype} {mode}, one image batch", drive["batch_launches"],
                    {"int8_mlp": L, "int8_attn": L, "fused_mlp": 0, "fused_attn_block": 0,
                     "fused_attention_aux": 0, "fused_mha": 0})
            plain = FullModel(CLASSES, params, cfg_q.replace(attn_impl="xla"))
            plain.add_class_prompt("Clipboards")
            n = len(images)
            placed = np.zeros((n, n, len(CLASSES) + 1))  # [batch position, image, class]
            with torch.inference_mode():
                with plain_int8():
                    want = plain(images)
                    # The stochastic draws are keyed on the batch row, and
                    # concurrent requests fill a batch in arrival order: the
                    # plain path at every position of every image (rotations;
                    # round to nearest does not depend on the position).
                    for r in range(1 if det else n):
                        order = [(pos - r) % n for pos in range(n)]
                        probs = _plain_probs(plain(images[order])["logits"].float().cpu().numpy())
                        placed[np.arange(n), order] = probs
                got = kern(images)
                got_feats = _image_features(params, cfg_q, x)
                with plain_int8():
                    plain_feats = _image_features(params, cfg_q, x)
            names = drive["names"]
            want_logits = want["logits"].float().cpu().numpy()
            logit_err = float(np.abs(got["logits"].float().cpu().numpy() - want_logits).max())
            served = np.array([[r["probs"][n] for n in names] for r in drive["wave2"]])
            # Each served image against the plain path at the batch position
            # that matches it best; the spread is how much the position moves it.
            if det:  # image j at position j, the same at every position
                placed[:] = placed[np.arange(n), np.arange(n)]
            pos_err = np.abs(placed - served[None]).max(-1)  # [position, image]
            prob_err = float(pos_err.min(0).max())
            spread = float(np.abs(placed - placed[:1]).max())
            plain_cos = float((plain_feats * got_feats).sum(-1).min())
            served_attr = np.array([drive["explain"]["attribution"][n] for n in names])
            attr_err = float(np.abs(served_attr - want["attribution"].float().cpu().numpy()).max())
            cos_min = float((got_feats * _image_features(params, cfg, x)).sum(-1).min())
            float_model = FullModel(CLASSES, params, cfg)
            float_model.add_class_prompt("Clipboards")
            with torch.inference_mode():
                float_logits = float_model(images)["logits"].float().cpu().numpy()
            int8_gap = float(np.abs(got["logits"].float().cpu().numpy() - float_logits).max())

            with torch.inference_mode():
                text = text_features_with_attribution(params, kern.trainable["ctx"], kern.prompt_learner.bank,
                                                      cfg, kern.prompt_cfg, kern.trainable["adjustor"])[0]
                bank = kern.prompt_learner.bank
                scale = kern.trainable["logit_scale"]
                timing = {"int8_kernel": time_ms(lambda: predict_batch(params, cfg_q, text, scale, bank.class_mask, x),
                                                 10, 2),
                          "float_kernel": time_ms(lambda: predict_batch(params, cfg, text, scale, bank.class_mask, x),
                                                  10, 2)}
                with plain_int8():
                    timing["int8_plain"] = time_ms(
                        lambda: predict_batch(params, cfg_q, text, scale, bank.class_mask, x), 5, 1)
            tol = INT8_SERVE_TOL[dtype]
            print(f"int8 serve {dtype} {mode}: 1 add_class + 24 /predict + 1 /explain in {drive['wall_s']:.2f} s; "
                  f"stats {drive['stats']}; launches per image batch {drive['batch_launches']}; whole drive "
                  f"{drive['launches']}", flush=True)
            print(f"int8 serve {dtype} {mode}: vs the plain int8 path on the card: logits max abs err "
                  f"{logit_err:.3e} (tol {tol['logits']}; the int8 tower's own gap to the float tower's logits "
                  f"{int8_gap:.3e}), served probs at their best batch position {prob_err:.3e} (tol {tol['probs']}; "
                  f"spread over positions {spread:.3e}), features min cosine {plain_cos:.6f}, /explain "
                  f"attribution {attr_err:.3e} (tol {ATTR_TOL}); image "
                  f"features vs the float tower: min cosine {cos_min:.5f} (need {FEATURE_COS}); image batch of 8 "
                  f"ms (CUDA events, no HTTP): " + ", ".join(f"{k}={v:.3f}" for k, v in timing.items()),
                  flush=True)
            require(logit_err <= tol["logits"], f"int8 {dtype} {mode}: logits differ from plain by {logit_err:.3e}")
            require(prob_err <= tol["probs"], f"int8 {dtype} {mode}: served probs differ by {prob_err:.3e}")
            require(attr_err <= ATTR_TOL, f"int8 {dtype} {mode}: attribution differs by {attr_err:.3e}")
            require(drive["explain"]["index"] == int(want_logits[0].argmax()), f"int8 {dtype} {mode}: /explain class")
            require(cos_min >= FEATURE_COS, f"int8 {dtype} {mode}: feature cosine {cos_min:.5f} < {FEATURE_COS}")
            out[f"{dtype} {mode}"] = {"launches": drive["launches"], "batch_launches": drive["batch_launches"],
                                      "logit_err": logit_err, "prob_err": prob_err, "attr_err": attr_err,
                                      "cos_min": cos_min, "plain_cos_min": plain_cos, "int8_gap": int8_gap,
                                      "position_spread": spread,
                                      "timing_ms": timing, "stats": drive["stats"]}
    return out


def pruned_serve_phase(model, images: np.ndarray) -> dict:
    """``--token-keep-ratio 0.5`` (``token_prune_layer`` 4) with and without
    ``--int8`` (f32, stochastic), through ``PredictService`` and HTTP: per
    image batch 4 front blocks at T 200 and 8 back blocks at T 96 (12 launches
    of each block kernel); the kept tokens against the plain path's; image
    features against the unpruned tower."""
    import torch

    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel, text_features_with_attribution
    from tapclip_tpu_torch.serve import predict_batch

    params = model.clip_params
    x = torch.from_numpy(images).cuda()
    out = {}
    for label, kw in (("float", {}), ("int8", {"quantize_tower": True})):
        cfg = model.clip_cfg.replace(**kw)
        cfg_p = cfg.replace(token_keep_ratio=0.5)
        kern = FullModel(CLASSES, params, cfg_p)
        drive = _http_drive(kern, images)
        L, k = cfg.vision_layers, cfg_p.token_prune_layer
        T = (cfg.vision_seq_len + 7) // 8 * 8
        # The kept count of clip.py:480-490 (a multiple of 8, no more than the real tokens).
        n_keep = min(max(8, int(T * 0.5) // 8 * 8), max(cfg.vision_seq_len // 8 * 8, 8))
        want = {"int8_mlp": L, "int8_attn": L, "fused_mlp": 0, "fused_attn_block": 0} if kw else \
            {"int8_mlp": 0, "int8_attn": 0, "fused_mlp": L, "fused_attn_block": L}
        _expect(f"pruned serving {label}, one image batch", drive["batch_launches"], want)

        def kept(c, plain):
            seen = []

            def spy(orig, *a):
                idx = orig(*a)
                seen.append(idx)
                return idx

            with patched(clip_model, "token_keep_indices", spy), \
                    (plain_int8() if plain else contextlib.nullcontext()):
                feats = _image_features(params, c, x)
            return feats, torch.sort(seen[0], dim=-1).values.cpu().numpy()

        lengths = []
        with block_lengths(lengths):
            got, idx = kept(cfg_p, False)
        plain_cfg = cfg_p if kw else cfg_p.replace(attn_impl="xla")
        _, plain_idx = kept(plain_cfg, bool(kw))
        want_lengths = [("attn", T), ("mlp", T)] * k + [("attn", n_keep), ("mlp", n_keep)] * (L - k)
        require(lengths == want_lengths, f"pruned {label}: block lengths {lengths}")
        agree = [len(np.intersect1d(a, b)) / len(a) for a, b in zip(idx, plain_idx)]
        cos_min = float((got * _image_features(params, cfg, x)).sum(-1).min())
        with torch.inference_mode():
            text = text_features_with_attribution(params, kern.trainable["ctx"], kern.prompt_learner.bank,
                                                  cfg, kern.prompt_cfg, kern.trainable["adjustor"])[0]
            bank, scale = kern.prompt_learner.bank, kern.trainable["logit_scale"]
            timing = {"pruned": time_ms(lambda: predict_batch(params, cfg_p, text, scale, bank.class_mask, x), 10, 2),
                      "unpruned": time_ms(lambda: predict_batch(params, cfg, text, scale, bank.class_mask, x), 10, 2)}
        print(f"pruned serve {label}: 1 add_class + 24 /predict + 1 /explain in {drive['wall_s']:.2f} s; launches "
              f"per image batch {drive['batch_launches']}; blocks at T {T}: {lengths.count(('attn', T))}, at "
              f"T {n_keep}: {lengths.count(('attn', n_keep))}; kept {idx.shape[1]} tokens, agreement with the plain path "
              f"per image {[round(a, 4) for a in agree]}; features vs the unpruned tower: min cosine {cos_min:.5f}; "
              f"image batch of 8 ms " + ", ".join(f"{k}={v:.3f}" for k, v in timing.items()), flush=True)
        require(idx.shape[1] == n_keep and bool((idx[:, 0] == 0).all()), f"pruned {label}: kept {idx.shape}")
        require(min(agree) >= (INT8_KEEP_AGREE if kw else 1.0),
                f"pruned {label}: kept tokens differ from the plain path's: {agree}")
        require(cos_min >= FEATURE_COS, f"pruned {label}: feature cosine {cos_min:.5f} < {FEATURE_COS}")
        out[label] = {"launches": drive["launches"], "batch_launches": drive["batch_launches"],
                      "keep_agreement": agree, "cos_min": cos_min, "timing_ms": timing}
    return out


def adaptive_phase(model, images: np.ndarray) -> dict:
    """``adaptive_logits`` with the int8 pruned tower as the cheap path: at
    margin inf it equals the full path, at -inf the cheap path."""
    import torch

    from tapclip_tpu_torch.models.model_wrapper import FullModel, full_model_forward
    from tapclip_tpu_torch.utils.adaptive_eval import adaptive_logits

    m = FullModel(CLASSES, model.clip_params, model.clip_cfg)
    cheap = m.clip_cfg.replace(token_keep_ratio=0.5, quantize_tower=True)
    x = torch.from_numpy(images).cuda()
    want = {}
    with torch.inference_mode():
        for name, c in (("full", m.clip_cfg), ("cheap", cheap)):
            want[name] = full_model_forward(m.clip_params, m.trainable, m.prompt_learner.bank, x, None,
                                            clip_cfg=c, prompt_cfg=m.prompt_cfg)["logits"].float().cpu().numpy()
    errs, stats = {}, {}
    for name, margin in (("full", np.inf), ("cheap", -np.inf)):
        got, stats[name] = adaptive_logits(m, images, margin=margin, cheap_cfg=cheap)
        errs[name] = float(np.abs(got - want[name]).max())
    print(f"adaptive_logits: margin inf vs the full path max abs err {errs['full']:.3e} ({stats['full']}), "
          f"-inf vs the cheap path {errs['cheap']:.3e} ({stats['cheap']}); cheap vs full "
          f"{float(np.abs(want['cheap'] - want['full'])[:, :len(CLASSES)].max()):.3e}", flush=True)
    require(errs["full"] <= 1e-5 and stats["full"]["n_rescued"] == len(images), "adaptive_logits at margin inf")
    require(errs["cheap"] <= 1e-5 and stats["cheap"]["n_rescued"] == 0, "adaptive_logits at margin -inf")
    return {"errors": errs, "stats": stats}


def int8_record(int8_kernels: dict, variants: dict, gemm: dict, launches: dict) -> list:
    """The kernels-line entries of B13, B14, S5 and S6: launches on the int8
    serving drive (f32, stochastic), errors and times at ViT-B/16 (B13, B14,
    S5) and at the probe's shape (S6)."""
    def main_case(name, dtype, mode):
        return [c for c in int8_kernels[name]["cases"]
                if c["dtype"] == dtype and c["mode"] == mode and "ms" in c][0]

    out = []
    for name in ("int8_mlp", "int8_attn"):
        c = main_case(name, "float32", "stochastic")
        rtn, bf, bf_rtn = (main_case(name, d, m) for d, m in (("float32", "round-to-nearest"),
                                                            ("bfloat16", "stochastic"),
                                                            ("bfloat16", "round-to-nearest")))
        cases = int8_kernels[name]["cases"]
        out.append({
            "name": name, "route": "cuda", **INT8_KERNELS[name], "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in cases if x["dtype"] == "float32"),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None, "shape": c["shape"], "wrapper_ms": c["wrapper_ms"],
            "update_rel_err": max(x["update_rel_err"] for x in cases if x["dtype"] == "float32"),
            "rtn_ms": rtn["ms"], "rtn_plain_ms": rtn["plain_ms"],
            "bf16_ms": bf["ms"], "bf16_plain_ms": bf["plain_ms"], "bf16_rtn_ms": bf_rtn["ms"],
            "bf16_update_rel_err": max(x["update_rel_err"] for x in cases if x["dtype"] == "bfloat16"),
            "mean_of_seeds": int8_kernels[name]["mean_of_seeds"],
        })
    base = main_case("int8_mlp", "float32", "stochastic")
    for vname, key in (("int8_mlp_erf3", "erf3"), ("int8_mlp_recipmul", "recipmul"),
                       ("int8_mlp_erf3_recipmul", "both")):
        v = variants["variants"][key]
        out.append({"name": vname, "route": "cuda", **INT8_KERNELS[vname], "launches": launches["int8_mlp_variants"],
                    "max_abs_err": v["max_abs_err"], "ms": v["median_ms"], "plain_ms": v["plain_ms"],
                    "bound_ms": base["bound_ms"], "bound_by": base["bound_by"], "library_ms": None,
                    "shape": variants["shape"], "base_ms": variants["variants"]["base"]["median_ms"],
                    "vs_base_rel_err": v["vs_base_rel_err"]})
    p = gemm["probe"]
    out.append({"name": "int8_gemm", "route": "cuda", **INT8_KERNELS["int8_gemm"], "launches": launches["int8_gemm"],
                "max_abs_err": max(p["max_abs_err_int32"], p["max_abs_err_f32"]), "ms": p["ms"],
                "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
                "library_ms": p["library_ms"], "shape": p["shape"], "ms_f32_out": p["ms_f32_out"],
                "matmul_bf16_ms": p["matmul_bf16_ms"], "gemm_cu_bf16_ms": p["gemm_cu_bf16_ms"],
                "b13_products_ms": {k: gemm[k]["ms"] for k in ("b13 fc", "b13 proj")}})
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    try:
        from tapclip_tpu_torch.config import VIT_B_16
        from tapclip_tpu_torch.ops import _build
        from tapclip_tpu_torch.serve import build_model
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    _build.library()
    log = _build.build_log
    print(f"build: {log['seconds']:.1f} s ({'cached' if log['cached'] else 'nvcc'}) -> {log['path']}",
          flush=True)
    if log["ptxas"]:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log["ptxas"])]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log["ptxas"]))
        print(f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers per thread, "
              f"{spills} bytes of spill stores", flush=True)

    phase_s = {"build": log["seconds"]}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    kernels = phase("kernels", check_kernels)
    kernels.update(phase("backward", check_backward))
    kernels.update(phase("text kernels", check_text_kernels))
    kernels.update(phase("flash kernels", check_flash_kernels))
    repairs = phase("long repairs", check_long_repairs)
    int8_kernels = phase("int8 kernels", check_int8_kernels)
    variants = phase("int8 variants", check_int8_variants)
    gemm = phase("int8 gemm", check_int8_gemm)
    t0 = time.perf_counter()
    model = build_model(VIT_B_16, CLASSES, "cuda", seed=0)
    print(f"serve: built {VIT_B_16.name} (width {VIT_B_16.vision_width}/{VIT_B_16.text_width}, "
          f"{VIT_B_16.vision_layers}+{VIT_B_16.text_layers} layers, {VIT_B_16.dtype}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    served = phase("serve", serve_path, model)
    images = served["images"]
    phase("serve bf16", serve_bf16, model, images, served["served_logits"])
    phase("text", text_path, model, images)
    split = phase("fused_split", fused_split_phase, model, images)
    trained = {dtype: phase(f"train {dtype}", train_phase, model.clip_params, VIT_B_16, dtype)
               for dtype in ("float32", "bfloat16")}
    idiomatic = {dtype: phase(f"idiomatic {dtype}", idiomatic_train_phase, model.clip_params, VIT_B_16, dtype)
                 for dtype in ("float32", "bfloat16")}
    pallas = {dtype: phase(f"pallas {dtype}", pallas_train_phase, model.clip_params, VIT_B_16, dtype)
              for dtype in ("float32", "bfloat16")}
    int8_served = phase("int8 serve", int8_serve_phase, model, images)
    pruned = phase("pruned serve", pruned_serve_phase, model, images)
    phase("adaptive", adaptive_phase, model, images)

    record = []
    for name, meta in KERNELS.items():
        f32_cases = [c for c in kernels[name]["cases"] if c["dtype"] == "float32"]
        bf16_cases = [c for c in kernels[name]["cases"] if c["dtype"] == "bfloat16"]
        timed = [c for c in f32_cases if "ms" in c][0]
        bf16_timed = [c for c in bf16_cases if "ms" in c][0]
        # Each kernel's launches on its main path: the ref_compat serving
        # drive for the forward kernels, the ref_compat training for their
        # backward, the idiomatic training for the text tower's kernels, the
        # ref_compat pallas training for the flash family's.
        main_path = (served if name in FORWARD else trained["float32"] if name in BACKWARD
                     else pallas["float32"]["ref_compat"] if name in FLASH else idiomatic["float32"])

        def launches(run):
            return run["launches"].get(name, 0)

        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": launches(main_path),
            "max_abs_err": max(c["max_abs_err"] for c in f32_cases),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "shape": timed["shape"],
            "bf16_max_abs_err": max(c["max_abs_err"] for c in bf16_cases),
            "bf16_ms": bf16_timed["ms"], "bf16_plain_ms": bf16_timed["plain_ms"],
            "bf16_bound_ms": bf16_timed["bound_ms"], "bf16_library_ms": bf16_timed["library_ms"],
            "train_launches": launches(trained["float32"]),
            "idiomatic_train_launches": launches(idiomatic["float32"]),
            "pallas_idiomatic_train_launches": launches(pallas["float32"]["idiomatic"]),
        }
        if name in BACKWARD or name in FLASH[:3]:
            entry.update(max_rel_err=max(c["max_rel_err"] for c in f32_cases),
                         bf16_max_rel_err=max(c["max_rel_err"] for c in bf16_cases))
        if name in BACKWARD:
            entry["ms_dx_only"] = timed["ms_dx_only"]
        if "chain_ms" in timed:  # the flash chain; beside B7, on B7's packed strides
            entry["chain_ms"] = timed["chain_ms"]
        if "launcher_ms" in timed:
            entry["launcher_ms"] = timed["launcher_ms"]
        if f"{name} float32" in repairs:  # B7 / B4 past their [T, T] tile
            entry["long_t"] = {dt: repairs[f"{name} {dt}"] for dt in ("float32", "bfloat16")}
        if name == "fused_mha":
            entry["fused_split_launches"] = split["launches"][name]
        record.append(entry)
    record += int8_record(int8_kernels, variants, gemm, int8_served["float32 stochastic"]["launches"])
    print("chip_smoke: phase seconds " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()), flush=True)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
