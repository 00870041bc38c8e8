"""Drive the PyTorch + CUDA port's serving, training, text and int8 paths, the reference
workloads from files, the offline inference and evaluation entry points, the few-shot
adaptation zoo, CoCoOp, base-to-new, CLIPWrapper and the RN50 tower, CLIP
pretraining and the MoE towers, once on one NVIDIA GPU.

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
   bf16; B6 with its launch alone and its bound at the bf16 MMA rate; B7
   with its two launches alone and its bounds at the FMA and the bf16 MMA
   rates.  Every kernel's time is printed beside its plain version's, one
   library call's (SDPA for the attention kernels, where one computes the
   same function) and its bound (bytes over 3.35 TB/s or operations over
   the dtype's peak, whichever is larger).  K1 (on the tensor cores: three
   launches, LayerNorm, fc, proj) and K2 (four: LayerNorm, the QKV product,
   the attention tiles, the out-projection), at the image and text shapes,
   also carry their launches alone through the C interface (``launch_ms``)
   and the MMA bound (``mma_bound_ms``, as K3's in 12), and the kernels line
   lists their every timed case.  B5 (five launches on the tensor cores)
   and B4 (seven: LayerNorm, the QKV and gh products, the attention core's
   row and column kernels, dy, the LayerNorm backward) carry the bounds of
   dx alone beside those of all seven outputs (``bound_dx_only_ms``,
   ``mma_bound_dx_only_ms``) and their launches alone for dx
   (``launch_ms_dx_only``).  The ptxas report of the tensor-core half-block
   kernels (K1, K2, B5), B4's and B13's is printed kernel by kernel:
   registers, spill bytes.
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
    its output and aux column (K3_LONG_TOL).  K3's and the chain's cases
    also carry the launch alone through the C interface (``launch_ms``,
    beside the wrapper's ``ms``) and a second bound at the rate of the
    products they run on the tensor cores (``mma_bound_ms``: their bf16
    MMAs, six per f32 product, at 989 TFLOP/s), and the kernels line lists
    every timed case (both dtypes, T 584, T 4096).
13. The B7 and B4 backwards at ViT-L/14-336's T 584 (W 1024, 16 heads),
    past B4's routing limit: B7's kernels (they take every T), and B4's
    split composition (projections in torch around B6, differentiated on
    B7), against their plain backward.
14. Prompt tuning with ``attn_impl="pallas"`` in both text modes, f32 and
    bf16, 3 cached-feature steps at batch 32, against ``"xla"`` on the card:
    per step 24 K3 launches (causal in idiomatic mode), 12 each of LSE,
    dK/dV and dQ, and none of K1, K2, B4, B5, B6, B7.
15. B7_BITS and B6_BITS: B7's and B6's outputs, bit for bit, against
    digests taken from them on the tensor cores (six shapes, f32 and bf16;
    a pin from one build to the next).  K2_BITS and B4_BITS: K2's output and B4's dx against digests
    taken before their attention kernels moved into the headers they share
    with B14 and B7 (the three non-causal B7_BITS shapes, f32 and bf16).
    The int8 kernels B13 (MLP) and B14 (attention) against their plain
    versions with the same random draws, f32 and bf16, stochastic and round
    to nearest, at ViT-B/16 (8 x 200, W 768; B14 also at the pruned 8 x 96)
    and ViT-L/14 (8 x 264, W 1024, H 4096, 16 heads), by the norm-relative
    error of the block's update (INT8_TOL), with CUDA-event times of the
    kernel, the plain version and the wrapper, and the launches alone on
    weights laid out once (B13's four, B14's five; B14 also its bound at
    the int8 and bf16 MMA rates); the 64-seed mean of each stochastic
    block at least INT8_MEAN_GAIN times closer than one draw to the
    weight-only-quantized float block.  B13_BITS: B13's output against
    digests read from the one-launch __dp4a walk it replaced, both modes and
    dtypes, at the image and pruned (8 x 96) shapes.
16. S5 (B13's launches with the erf3 / recipmul switches) in f32 and bf16
    against B13, its parent (INT8_VARIANT_TOL), and its plain versions
    (INT8_TOL), timed in turns with B13 through the wrappers and as the
    launches alone, and against S5_BITS (digests read from the walk's
    variants, stochastic, both dtypes, both shapes); S6 (the
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
20. The A/B variants, off every main path (0 launches there): the four card
    drivers' ``run()`` (``tapclip_tpu_torch/scripts/``: S1 the one-launch
    fused layer on K1's and K2's tensor-core tiles, S2 K1's launches with
    the TPU script's switches, S3 and S4 K2's launches with theirs) at
    ViT-B/16, batch 8, f32 and bf16.  Each distinct variant kernel is held
    against its plain version (AB_TOL: the parents' F32_TOL / BF16_TOL), each
    variant whose output is the parent's (its configuration, S2's 128-row
    tiles, S3's and S4's variants that are K2's arithmetic in the dtype:
    ``_bench_util.k2_keys``) against the parent bit for bit and each against
    a second call bit
    for bit, each timed in turns with the parent (CUDA events) beside its plain
    version, the bound and the MMA bound (``mma_bound_ms``: the operations
    as bf16 MMAs, six a product in f32).  The parents (``AB_PARENTS``): K2
    then K1 for S1, K1 for S2, K2 for S3 and S4, each held against its plain
    version.  The ptxas lines of ``fused_layer.cu`` and
    ``attn_variants_{online,two_pass}.cu`` give S1's and S3/S4's registers
    and spills.

21. The reference workloads from files ("files"), ViT-B/16 f32 (the
    reference_train preset with ``--model ViT-B-16``): two seeded state
    dicts written in open_clip layout by ``save_openclip_checkpoint`` (and a
    third with projections half as wide) under a temporary directory, an
    OfficeHome-shaped tree (the four domains x the five train classes +
    Clipboards x 8 JPEGs at 224 px); ``train`` (2 epochs, 4 shots, batch 8,
    a snapshot per epoch, one kept): history, best and periodic
    checkpoints, K1/K2/K3/B4/B5 launches per epoch exactly, and a
    ``--resume`` from the epoch-1 snapshot whose epoch-2 loss equals the
    uninterrupted run's (TRAIN_TOL); ``test_cross_domain2`` over the four
    domains with the unseen class (the full 8-cell grid); ``serve
    --pretrained --ckpt`` over HTTP against an in-memory plain model from
    the same files (LOGIT_TOL / PROB_TOL, equal argmax), a refused
    ``/reload`` of mismatched shapes (400, answers unchanged) and a
    ``/reload`` of the second state dict against a fresh model from it.
    The card has PIL and pandas but no matplotlib and no libjpeg headers:
    the loaders decode with PIL and ``train`` and ``test_cross_domain2`` run
    their ``parse`` and
    ``run`` (``main`` without the plots).  Prints the load + convert
    seconds, ms per epoch, the loader's images/s and the device's busy /
    idle share over one file-fed epoch (a ``torch.profiler`` trace), each
    beside the card's name and power limit.
22. The offline inference and evaluation entry points from files ("eval"),
    ViT-B/16 f32: a seeded state dict and a reference prompt ``.pt`` of
    seeded context under a temporary directory, two domains x the five train
    classes x 32 JPEGs at 224 px (one file copied under a second name) and a
    shard dir of 64 captioned JPEGs.  ``featurize`` of the first domain and
    of the shards with ``--embed-text`` (rows against the plain path within
    EMB_TOL), ``search`` by row, by text (scores against float64 of the bf16
    operands, SEARCH_TOL) and with ``--dedup`` (the copied file's pair must
    be found), ``predict`` float and ``--int8`` (every class's probability
    against the plain path, PROB_TOL, and the plain int8 versions,
    INT8_SERVE_TOL), the saliency forward's features against
    ``encode_image`` on the kernels (F32_TOL), ``patch_saliency`` (rollout,
    last) and ``/explain`` with ``"saliency"`` over HTTP, ``zero_shot_eval``
    over the two domains, ``evaluate_adaptive`` (the int8 pruned cheap path,
    margins inf and -inf), ``robustness`` (clean, gaussian_noise, pixelate x
    severities 1, 5) and a two-cell ``sweep``, each against the plain path
    (accuracies within one image).  Every kernel's launches are set to 0
    before each driver and must equal what its shapes give (K1 and K2 12 per
    image batch, K1 and B6 12 per text batch, B13 and B14 12 per int8 batch,
    B4 and B5 12 per sweep step, 24 K1 + 23 K2 + 1 K3 per attribution and
    encode text pass pair).  Then ``SearchIndex.search`` over a 1,000,000 x
    512 bf16 index made on the card at Q = 1 and 64 and ``find_duplicates``
    over 65,536 of its rows (one planted pair).  Prints featurize's and
    predict's images/s (decode included), the device's busy share over one
    predict pass, and the search and dedup times beside the index's bound.
23. The few-shot adaptation zoo ("adapt"), ViT-B/16 f32, from a seeded
    state dict and a 5-class tree of 8 JPEGs a class: the CE-only, kg, scl
    and ProGrad cached-feature steps (batch 32, 5 steps) on the kernels and
    on the plain path, loss, ctx displacement (TRAIN_TOL) and
    prograd_conflict per step, 12 B4 + 12 B5 a step and 24 + 24 for ProGrad
    (its two pullbacks); MaPLe's step (J 3, P 2, batch 8 uint8 images: the
    image tower at T 199 padded to 200, B4's route printed) against the
    plain path (loss, grad norm, displacement at MAPLE_STEP_TOL), 24 B4 +
    24 B5 a step; one TPT batch (16 images x 8 views, 1 step) from the same
    drawn views, logits at LOGIT_TOL, 12 K1 + 12 K2 for the B*V views;
    ``fewshot.run`` with all eleven methods against
    ``run_fewshot_benchmark`` on the plain path (accuracies within one
    image); ``train`` with every anchor and three templates, launches
    exactly as counted from the shapes.  Prints ms per step of each step
    kind, TPT images/s and each method's TrainSeconds.
24. CoCoOp, base-to-new, ``CLIPWrapper`` and RN50 ("cocoop_rn"), from
    seeded state dicts (ViT-B/16 f32 unless RN50): a CoCoOp model at init
    against the unconditioned one (LOGIT_TOL); the CoCoOp cached-feature
    step (batch 32, 5 classes at capacity 8: 256 text rows; ctx and the
    meta-net trained) in both text modes and once with kg + ProGrad, 5 steps
    on the kernels and on the plain path (loss, first grad norm, the ctx +
    meta-net displacement at TRAIN_TOL), launches per step exactly (24 K1 +
    23 K2 + 1 K3 + 12 B4 + 12 B5 ref_compat, 24 K1 + 23 B6 + 1 causal K3 +
    12 B7 + 12 B5 idiomatic, the backward twice for ProGrad), ms per step
    timed in turns with the class-level CE step, ``evaluate_cached`` at its
    batch of 256 (2,048 text rows) with its peak memory; a conditioned
    CoCoOp model served over HTTP (a /predict batch of 8: 36 K1 + 35 K2 + 1
    K3; an /embed batch one tower more; /explain rows against the plain
    path, two images' rows apart by more than that error);
    ``predict_corpus`` (attribution None, probabilities against the plain
    path); ``base_to_new``'s ``parse`` + ``run`` on a 4-class tree against
    ``run_base_to_new`` on the plain path (within one image) and its CSV
    header; ``CLIPWrapper``'s encoders against featurize's, its bare map's
    column T-1 against K3's aux (ATTR_TOL); RN50 at 224 px: an 8-image
    batch's logits (LOGIT_TOL), the cached-feature step (text W 512, embed
    1,024) with exact launches, /explain with saliency, ms per image batch.
25. CLIP pretraining ("pretrain"), ViT-B/16 with random weights, both
    towers trained: 3 InfoNCE steps at batch 32 (AdamW, lr 1e-4) on the
    kernels and on the plain path from one tree, f32 and bf16 (the losses,
    step 1's gradients by global norm and leaf by leaf, the parameters'
    displacement, at PRETRAIN_TOL), exactly 24 K1 + 12 K2 + 12 B6 + 24 B5
    + 12 B4 + 12 B7 + 72 gemm.cu dW products + 108 column sums a step; one
    step per option against the plain path with exact launches: SigLIP,
    LoRA r8 (no column sum; the base tree bit-identical), BitFit (no dW
    product; the weights bit-identical), the image lock (no image-tower
    backward; the tower bit-identical), 2 unlocked groups, GradCache at
    K = 2 (the one-shot step's loss and update), patch dropout 0.5 (T 99),
    VPT-deep 8 (T 205) and shallow 16 (T 213: B4's split composition),
    remat (twice the forward launches, the gradients of no remat),
    distillation from a ViT-B/16 teacher, RN50; ``pretrain_cli.main`` for 2
    epochs over 64 JPEGs (cosine, clip, EMA, snapshots, zero-shot), then
    ``--resume`` for a third, ``featurize --pretrained`` on the final tree
    (EMB_TOL), a ``--shard-dir`` and a ``--csv-path`` epoch; the step timed
    in turns with the class-level CE step (f32, bf16); gemm.cu's four dW
    products at 1,600 and 6,400 rows against torch.mm and their bound, B4
    and B5 at the image shape with every gradient beside dx alone; one
    traced step (profile_kernels.pretrain_trace: the device's busy share,
    each wrapper's device time, gemm.cu's dW products on their own).
26. The MoE towers ("moe", ``models/moe.py``), ViT-B/16 with 8 experts a
    block (capacity 32 vision, 16 text) and random weights: 3 InfoNCE +
    load-balance steps at batch 32, f32 and bf16, on the kernels (exactly
    24 B6 + 24 B7 a step, nothing else), on the plain path fed the kernel
    path's routing (``moe.route`` patched; held at PRETRAIN_TOL) and on the
    plain path routing on its own (held at ``_moe_free_tol`` of the flip
    share it measures, the share at MOE_FLIP_CAP), with step 1's
    gradients, the share of tokens routed to another expert and the share
    dropped over capacity per tower, the losses falling and every router
    moving; one cached-feature prompt-tuning step (exactly 23 B6 + 1 K3 +
    12 B7) against the plain path with the routing replayed (TRAIN_TOL); the
    MoE step's CUDA-event ms in f32 and bf16 in turns with the dense f32
    step; ``pretrain_cli --moe-experts 8`` for one epoch (exact launches,
    the ``.pt`` tree read back, refused under the dense config); one traced
    step (profile_kernels.moe_trace: B6, B7, router, dispatch, combine,
    expert products, AdamW, the device's busy share).

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
# B13 and S5 must compute what the one-launch __dp4a walk they replaced
# computed, bit for bit: sha256 (first 16 hex digits) of the output on
# numpy-seeded inputs (``int8_digest``), read on an NVIDIA H100 80GB HBM3
# (CUDA 12.8) from the walk itself.  B13_BITS: the flags-off walk,
# stochastic and round to nearest; S5_BITS: its erf3, recipmul and both
# variants (stochastic).  f32 and bf16, at the image and pruned shapes.
INT8_BITS_CASES = {"image 8x200x768": (8, 200, 768), "pruned 8x96x768": (8, 96, 768)}
B13_BITS = {
    ("float32", "image 8x200x768", "stochastic"): "8c913bffae042f87",
    ("float32", "image 8x200x768", "round-to-nearest"): "66947e655d7d0570",
    ("float32", "pruned 8x96x768", "stochastic"): "3832de6fd320c93e",
    ("float32", "pruned 8x96x768", "round-to-nearest"): "14ad70f7ed2553c6",
    ("bfloat16", "image 8x200x768", "stochastic"): "bd554d64868b2041",
    ("bfloat16", "image 8x200x768", "round-to-nearest"): "2e721ce47880fac7",
    ("bfloat16", "pruned 8x96x768", "stochastic"): "7c5ebeb9c6e15878",
    ("bfloat16", "pruned 8x96x768", "round-to-nearest"): "9162abaa2145d705",
}
S5_BITS = {
    ("float32", "image 8x200x768", "erf3"): "e6a30f135cf95c4f",
    ("float32", "image 8x200x768", "recipmul"): "23d5e41277b55b60",
    ("float32", "image 8x200x768", "both"): "59107892337da71b",
    ("float32", "pruned 8x96x768", "erf3"): "2d607926aaf19fb4",
    ("float32", "pruned 8x96x768", "recipmul"): "1f7b4dbaa320a6aa",
    ("float32", "pruned 8x96x768", "both"): "63e45655e72025f6",
    ("bfloat16", "image 8x200x768", "erf3"): "46717f37f4bb3073",
    ("bfloat16", "image 8x200x768", "recipmul"): "0d4a91f9c211a865",
    ("bfloat16", "image 8x200x768", "both"): "ee55b90dbfd4a6fa",
    ("bfloat16", "pruned 8x96x768", "erf3"): "aec8d14576755f6c",
    ("bfloat16", "pruned 8x96x768", "recipmul"): "2effef75b68aa9c4",
    ("bfloat16", "pruned 8x96x768", "both"): "c3f1f07b23024927",
}

# B7 (the packed-QKV core's backward) must repeat its bits from one build
# to the next: sha256 (first 16 hex digits) of B7's dqkv on numpy-seeded
# inputs (``b7_digest``), read on an NVIDIA H100 80GB HBM3 (CUDA 12.8) from
# B7 on B4's row and column kernels.
B7_BITS_CASES = {"idiomatic 8x77x512 h8 causal": (8, 77, 512, 8, 77, True),
                 "text 64x80x512 h8 valid77 causal": (64, 80, 512, 8, 77, True),
                 "image 8x200x768 h12 valid197": (8, 200, 768, 12, 197, False),
                 "dh32 3x33x128 h4 valid30 causal": (3, 33, 128, 4, 30, True),
                 "dh128 2x65x256 h2 valid60": (2, 65, 256, 2, 60, False),
                 "dh16 1x40x64 h4": (1, 40, 64, 4, 40, False)}
# B6 (the packed-QKV core) likewise: its output on the same qkv
# (``b6_digest``), read on an NVIDIA H100 80GB HBM3 from B6 on K2's attention
# walk (attn_core_mma.cuh).
B6_BITS = {
    ("float32", "idiomatic 8x77x512 h8 causal"): "9447e67875bbebb0",
    ("float32", "text 64x80x512 h8 valid77 causal"): "33764a9576056d10",
    ("float32", "image 8x200x768 h12 valid197"): "84fd1f078214062a",
    ("float32", "dh32 3x33x128 h4 valid30 causal"): "00661bfed5aaed6d",
    ("float32", "dh128 2x65x256 h2 valid60"): "94748c42073d11d6",
    ("float32", "dh16 1x40x64 h4"): "c635c9dcea4854a2",
    ("bfloat16", "idiomatic 8x77x512 h8 causal"): "a8ca64fd7426702a",
    ("bfloat16", "text 64x80x512 h8 valid77 causal"): "26e6b6a12b38aae0",
    ("bfloat16", "image 8x200x768 h12 valid197"): "03857513538494d1",
    ("bfloat16", "dh32 3x33x128 h4 valid30 causal"): "2215e8d6e6a74be0",
    ("bfloat16", "dh128 2x65x256 h2 valid60"): "cd0937527bfb660a",
    ("bfloat16", "dh16 1x40x64 h4"): "fee2d073c94b8979",
}
B7_BITS = {
    ("float32", "idiomatic 8x77x512 h8 causal"): "a82c3e9855c93e5f",
    ("float32", "text 64x80x512 h8 valid77 causal"): "6d1e956c1290c697",
    ("float32", "image 8x200x768 h12 valid197"): "f0bdb2c3aefe73fa",
    ("float32", "dh32 3x33x128 h4 valid30 causal"): "642afa731dcc659b",
    ("float32", "dh128 2x65x256 h2 valid60"): "ab5f43d16fec2403",
    ("float32", "dh16 1x40x64 h4"): "63c3861dc60d2846",
    ("bfloat16", "idiomatic 8x77x512 h8 causal"): "cb6978e2085f246c",
    ("bfloat16", "text 64x80x512 h8 valid77 causal"): "7df55fef41643ce0",
    ("bfloat16", "image 8x200x768 h12 valid197"): "222671cec5394ed2",
    ("bfloat16", "dh32 3x33x128 h4 valid30 causal"): "c60fad2de845c8ce",
    ("bfloat16", "dh128 2x65x256 h2 valid60"): "ccca20d9035d3a2c",
    ("bfloat16", "dh16 1x40x64 h4"): "1716e3256b02dd10",
}

# K2 (the attention half-block) and B4 (its backward) must not move a bit
# now that their attention kernels live in shared headers (attn_core_mma.cuh,
# attn_bwd_mma.cuh) beside B14's and B7's: sha256 (first 16 hex digits) of
# K2's output and of B4's dx on numpy-seeded inputs (``k2_digest``,
# ``b4_digest``) at B7_BITS_CASES' non-causal shapes, read on an NVIDIA H100
# 80GB HBM3 from the kernels as they were before the move.
BLOCK_BITS_CASES = {label: case[:5] for label, case in B7_BITS_CASES.items() if not case[5]}
K2_BITS = {
    ("float32", "image 8x200x768 h12 valid197"): "02dd4d709888b4a4",
    ("float32", "dh128 2x65x256 h2 valid60"): "024abc62cb7100da",
    ("float32", "dh16 1x40x64 h4"): "b5cb7f32e2cff165",
    ("bfloat16", "image 8x200x768 h12 valid197"): "8ceb5470eda79a51",
    ("bfloat16", "dh128 2x65x256 h2 valid60"): "dfcb46f3ceee291c",
    ("bfloat16", "dh16 1x40x64 h4"): "9c9ef3184d447a17",
}
B4_BITS = {
    ("float32", "image 8x200x768 h12 valid197"): "7360c3ecc58b8e6b",
    ("float32", "dh128 2x65x256 h2 valid60"): "bce8c0fe9b75a5f2",
    ("float32", "dh16 1x40x64 h4"): "dccb845270b28386",
    ("bfloat16", "image 8x200x768 h12 valid197"): "ec1fb8087292fba1",
    ("bfloat16", "dh128 2x65x256 h2 valid60"): "2f61056b7860e7ed",
    ("bfloat16", "dh16 1x40x64 h4"): "c45f0d98e22d7ed5",
}

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
# K3 and the chain (csrc/flash_mma.cuh): the kernels line lists each timed case.
K3_AND_CHAIN = ("fused_attention_aux", "fused_attention_aux_causal") + FLASH
# The kernels on the tensor cores: K3, the chain, K1, K2, B5, B4, B7 and B6.
MMA_KERNELS = K3_AND_CHAIN + ("fused_mlp", "fused_attn_block", "fused_mlp_bwd", "fused_attn_block_bwd",
                               "fused_mha_bwd", "fused_mha")
CASE_KEYS = ("shape", "dtype", "ms", "ms_dx_only", "launcher_ms", "launch_ms", "launch_ms_dx_only", "plain_ms",
             "library_ms", "chain_ms", "bound_ms", "bound_dx_only_ms", "fma_bound_ms", "mma_bound_ms",
             "mma_bound_dx_only_ms", "max_abs_err", "max_rel_err")
# The sources whose kernels' ptxas report (registers, spills) is printed one by one:
# the half-blocks' and B4's on the tensor cores, B7's and B6's, B13's (with S5's switches) and B14's,
# S1's persistent layer and S2's interleaved steps on their tiles, and S3/S4's walks.
PTXAS_SOURCES = ("fused_mlp.cu", "attn_block.cu", "mlp_bwd.cu", "attn_block_bwd.cu", "mha_bwd.cu", "mha.cu",
                 "int8_mlp.cu", "int8_attn.cu", "fused_layer.cu", "fused_mlp_variants.cu",
                 "attn_variants_online.cu", "attn_variants_two_pass.cu")
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


# The A/B variants (S1-S4): each distinct variant kernel against its plain
# version, atol = rtol, per dtype: the parents' limits, except the "bf16"
# softmax in f32, which rounds (s - m) to bf16 before exp2, so an f32 ulp of
# difference in s moves p by a bf16 step (reading on the CPU against the TPU
# kernel, tests/port/test_torch_ab.py: 1.8e-4).
AB_TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
AB_BF16_SOFTMAX_F32_TOL = 1e-3
AB_DRIVERS = ("fused_layer_ab", "mlp_kernel_ab", "attn_kernel_ab", "attn_softmax_ab")
AB_PARENTS = {"fused_layer_ab": "K2 then K1", "mlp_kernel_ab": "K1", "attn_kernel_ab": "K2", "attn_softmax_ab": "K2"}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _counters():
    """Each kernel's launch counter: (wrapper, attribute)."""
    from tapclip_tpu_torch.ops.flash_attention import fused_attention
    from tapclip_tpu_torch.ops.fused_layer import fused_layer
    from tapclip_tpu_torch.ops.fused_mha import attn_block_variant, fused_attn_block, fused_mha
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_variant
    from tapclip_tpu_torch.ops.gemm import col_sum, gemm_f32
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
        # gemm.cu's weight-gradient products and column sums inside B4 and B5
        # (pretraining: the first main path where the CLIP weights train).
        "gemm_f32": (gemm_f32, "launches"),
        "col_sum": (col_sum, "launches"),
        "int8_mlp": (int8_mlp_block, "launches"),
        "int8_attn": (int8_attn_block, "launches"),
        "int8_mlp_variants": (int8_mlp_block, "variant_launches"),  # S5, off the serving path
        "int8_gemm": (int8_gemm, "launches"),  # S6, off the serving path
        "fused_layer": (fused_layer, "launches"),  # S1-S4, off every main path
        "fused_mlp_variant": (fused_mlp_variant, "launches"),
        "attn_block_variant": (attn_block_variant, "launches"),
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


# Partial products per product of K3, the flash chain, K1 and B5's dx on the
# tensor cores (csrc/flash_mma.cuh), (f32, bf16): in f32 each product splits
# both operands into three bf16 terms (six MMAs); in bf16 q k^T, dO v^T,
# K3's rounded p v, K1's two products, B5's three and B6's two (bf16 q, k, v
# and p's rounding) are one MMA, the chain's p and ds products two (the
# dK/dV kernel's four products 1 + 1 + 2 + 2, the dQ kernel's three
# 1 + 1 + 2).  K2's mix is k2_mma_flops.
MMA_PRODUCTS = {"fused_attention_aux": (6, 1), "flash_lse": (6, 1), "flash_bwd_dkv": (6, 1.5),
                "flash_bwd_dq": (6, 4 / 3), "fused_mlp": (6, 1), "fused_mlp_bwd": (6, 1), "fused_mha": (6, 1),
                "gemm_f32": (6, 1)}


def mma_bound(n_bytes: int, flops: float, dtype: str, kernel: str) -> dict:
    """The bound at the rate of the products the kernel runs: its bf16 MMAs
    (``MMA_PRODUCTS`` times the function's operations) at the tensor cores'
    bf16 peak, or its bytes, whichever is larger."""
    return mma_bound_of(n_bytes, flops * MMA_PRODUCTS[kernel][dtype == "bfloat16"])


def mma_bound_of(n_bytes: int, mma_flops: float) -> dict:
    """The larger of the bytes over the memory rate and ``mma_flops``, the
    operations of the bf16 MMAs run, over the tensor cores' bf16 peak."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * mma_flops / PEAK_FLOPS["bfloat16"]
    return {"mma_bound_ms": max(by_bytes, by_ops), "mma_bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def k2_mma_flops(B: int, T: int, W: int, pairs: int, dtype: str) -> float:
    """Operations of K2's bf16 MMAs: in f32 six a product; in bf16 one for
    the two projections (8 B T W^2) and p . v (2 W a pair), six for q . k^T
    (2 W a pair: q and k are f32 values, split into three terms)."""
    proj, half = 8 * B * T * W * W, 2 * W * pairs
    return 6 * (proj + 2 * half) if dtype == "float32" else proj + 6 * half + half


def b4_mma_flops(B: int, T: int, W: int, pairs: int, dtype: str, dx_only: bool) -> float:
    """Operations of the bf16 MMAs of B4's function on the tensor cores: its
    products (dx alone the three dx products, 2 R W 3W + 2 R W^2 + 2 R 3W W;
    with every gradient also dW_qkv and dW_out, 8 R W^2, counted as if they
    ran there) and the attention core, 2 W a (query, valid key) pair for each
    of its six products (five without o, dx alone): in f32 six MMAs a
    product; in bf16 one for the projections and for the products whose
    operands the TPU kernel rounds (o = p v, dv = p^T gh), six for the rest
    (q, k, v, gh, dp and ds are f32 values, split into three terms)."""
    proj, pair = (14 if dx_only else 22) * B * T * W * W, 2 * W * pairs
    if dtype == "float32":
        return 6 * (proj + (5 if dx_only else 6) * pair)
    return proj + (4 * 6 + (1 if dx_only else 2)) * pair


def ptxas_kernels(log: str, sources=PTXAS_SOURCES) -> list:
    """(source, kernel, registers, spill store bytes) of each kernel that
    ``sources`` compile, from ``-Xptxas -v``'s report (one section a source,
    ``_build.build_log["ptxas_by_source"]``).  The spills of the functions
    ptxas lists after a kernel, which it calls without inlining them (S1's
    phases), count with the kernel's own."""
    out = []
    for src in sources:
        kernel = None
        spill = 0
        for line in log.get(src, "").splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                kernel, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                if kernel is None and out and out[-1][0] == src:  # a called function's
                    out[-1] = out[-1][:3] + (out[-1][3] + int(m.group(1)),)
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out.append((src, kernel, int(m.group(1)), spill))
                kernel = None
    return out


def bare_launch(fn_name: str, args: tuple):
    """One kernel's launch alone through the C interface on arguments checked
    once: a closure to time (it counts no launch)."""
    from tapclip_tpu_torch.ops import _build

    fn = getattr(_build.library(), fn_name)
    return lambda: fn(*args)


def k3_launch(q, k, v, causal, valid, eot):
    """K3's launch alone on buffers allocated once (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops.flash_attention import _attn_aux_call

    B, H, T, _ = q.shape
    aux = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if eot is not None else None
    return bare_launch("tapclip_attn_aux", _attn_aux_call(q, k, v, causal, valid, eot, torch.empty_like(q), aux))


def k1_launch(x, ln, mlp):
    """K1's launches alone (LayerNorm, fc, proj) through the C interface on
    buffers allocated once (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops import _build

    W, H = x.shape[-1], mlp["w_fc"].shape[-1]
    R = x.numel() // W
    ws = torch.empty(R * (H + W), dtype=x.dtype, device=x.device)
    w = {k: mlp[k].to(x.dtype) for k in ("w_fc", "w_proj")}
    out = torch.empty_like(x)
    launch = bare_launch("tapclip_fused_mlp", (
        x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), w["w_fc"].data_ptr(), mlp["b_fc"].data_ptr(),
        w["w_proj"].data_ptr(), mlp["b_proj"].data_ptr(), out.data_ptr(), ws.data_ptr(), R, W, H, 1e-5,
        _build.dtype_code(x.dtype), _build.stream_handle(x.device)))

    def run(_buffers=(out, ws, w)):  # the buffers live as long as the closure
        return launch()

    return run


def k2_launch(x, ln, attn, nh, valid):
    """K2's launches alone (LayerNorm, QKV, attention, out-projection)
    through the C interface on buffers allocated once (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops import _build

    B, T, W = x.shape
    w = {k: attn[k].to(x.dtype) for k in ("w_qkv", "w_out")}
    out, ya = torch.empty_like(x), torch.empty_like(x)
    qkv = torch.empty((B * T, 3 * W), dtype=torch.float32, device=x.device)
    launch = bare_launch("tapclip_attn_block", (
        x.data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(), w["w_qkv"].data_ptr(), attn["b_qkv"].data_ptr(),
        w["w_out"].data_ptr(), attn["b_out"].data_ptr(), out.data_ptr(), qkv.data_ptr(), ya.data_ptr(),
        B, T, W, nh, valid, 1e-5, _build.dtype_code(x.dtype), _build.stream_handle(x.device)))

    def run(_buffers=(out, ya, qkv, w)):  # the buffers live as long as the closure
        return launch()

    return run


def b5_launch(x, g, ln, mlp):
    """B5's launches alone for dx (no weight gradients) through the C
    interface on buffers allocated once, at the wrapper's split
    (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops import _build

    W, H = x.shape[-1], mlp[0].shape[-1]
    R = x.numel() // W
    lib = _build.library()
    S = lib.tapclip_mlp_bwd_split(R, W, H, _build.dtype_code(x.dtype))
    w_fc, w_proj = mlp[0].to(x.dtype), mlp[2].to(x.dtype)
    dx = torch.empty_like(x)
    ws = torch.empty(R * H + S * R * W + 2 * R, dtype=torch.float32, device=x.device)
    wsd = torch.empty(R * (H + W), dtype=x.dtype, device=x.device)
    launch = bare_launch("tapclip_mlp_bwd", (
        x.data_ptr(), g.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(), w_fc.data_ptr(), mlp[1].data_ptr(),
        w_proj.data_ptr(), dx.data_ptr(), ws.data_ptr(), wsd.data_ptr(), None, None, R, W, H, 1e-5, S, 0,
        _build.dtype_code(x.dtype), _build.stream_handle(x.device)))

    def run(_buffers=(dx, ws, wsd, w_fc, w_proj)):  # the buffers live as long as the closure
        return launch()

    return run


def b4_launch(x, g, ln, attn, nh, valid):
    """B4's launches alone for dx (no weight gradients) through the C
    interface on buffers allocated once, at the wrapper's split
    (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops import _build

    B, T, W = x.shape
    R, code = B * T, _build.dtype_code(x.dtype)
    S = _build.library().tapclip_attn_block_bwd_split(R, W, code)
    w_qkv, w_out = attn[0].to(x.dtype), attn[2].to(x.dtype)
    dx = torch.empty_like(x)
    ws = torch.empty(R * (4 * W + S * W + 2 + 2 * nh), dtype=torch.float32, device=x.device)
    wsd = torch.empty(R * 4 * W, dtype=x.dtype, device=x.device)
    launch = bare_launch("tapclip_attn_block_bwd", (
        x.data_ptr(), g.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(), w_qkv.data_ptr(), attn[1].data_ptr(),
        w_out.data_ptr(), dx.data_ptr(), ws.data_ptr(), wsd.data_ptr(), None, B, T, W, nh, valid, 1e-5, S, 0, code,
        _build.stream_handle(x.device)))

    def run(_buffers=(dx, ws, wsd, w_qkv, w_out)):  # the buffers live as long as the closure
        return launch()

    return run


def b13_launch(x, gamma, beta, q, deterministic):
    """B13's four launches alone through the C interface on weights laid out
    once and scratch allocated once (``bare_launch``)."""
    from tapclip_tpu_torch.scripts.int8_mlp_ab import launch_args

    args, keep = launch_args(x, gamma, beta, q, deterministic)
    launch = bare_launch("tapclip_int8_mlp", args)

    def run(_buffers=keep):  # the buffers live as long as the closure
        return launch()

    return run


def b14_launch(x, gamma, beta, q, nh, valid, deterministic):
    """B14's five launches alone through the C interface on weights laid out
    once and scratch allocated once (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.int8_mlp import k_major

    B, T, W = x.shape
    R, Wp = B * T, _build.library().tapclip_int8_gemm_kp(W)
    w = (k_major(q["w_qkv"], Wp), k_major(q["w_out"], Wp))
    bufs = (torch.empty_like(x), torch.empty((R, 3 * W), device=x.device), torch.empty((R, W), device=x.device),
            torch.empty((R, Wp), dtype=torch.int8, device=x.device), torch.empty((3, R), device=x.device))
    launch = bare_launch("tapclip_int8_attn", (
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w[0].data_ptr(), q["s_qkv"].data_ptr(),
        q["b_qkv"].data_ptr(), w[1].data_ptr(), q["s_out"].data_ptr(), q["b_out"].data_ptr(),
        *(t.data_ptr() for t in bufs), B, T, W, nh, valid, 1e-5, 0, int(deterministic), _build.dtype_code(x.dtype),
        _build.stream_handle(x.device)))

    def run(_buffers=(w, bufs)):  # the buffers live as long as the closure
        return launch()

    return run


def b7_launch(qkv, g, nh, valid, causal):
    """B7's two launches alone through the C interface on scratch allocated
    once (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops import _build

    B, T, W3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    ws = torch.empty(2 * B * nh * T, device=qkv.device)  # lse, delta
    launch = bare_launch("tapclip_mha_bwd", (
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), ws.data_ptr(), B, T, W3 // 3, nh, valid, int(causal),
        _build.dtype_code(qkv.dtype), _build.stream_handle(qkv.device)))

    def run(_buffers=(dqkv, ws)):  # the buffers live as long as the closure
        return launch()

    return run


def b6_launch(qkv, nh, valid, causal):
    """B6's launch alone through the C interface on an output allocated once
    (``bare_launch``)."""
    import torch

    from tapclip_tpu_torch.ops import _build

    B, T, W3 = qkv.shape
    out = torch.empty((B, T, W3 // 3), dtype=qkv.dtype, device=qkv.device)
    launch = bare_launch("tapclip_mha", (qkv.data_ptr(), out.data_ptr(), B, T, W3 // 3, nh, valid, int(causal),
                                         _build.dtype_code(qkv.dtype), _build.stream_handle(qkv.device)))

    def run(_buffers=(out,)):  # the buffer lives as long as the closure
        return launch()

    return run


def b7_mma_flops(W: int, pairs: int, dtype: str) -> float:
    """Operations of the bf16 MMAs of B7's function on the tensor cores: its
    five products, 2 W a (query, visible key) pair each; in f32 six MMAs a
    product; in bf16 one for q k^T, g v^T and p^T g (bf16 values and p's
    rounding), three for ds k and ds^T q (ds f32 in three terms)."""
    return (6 * 5 if dtype == "float32" else 1 + 1 + 1 + 3 + 3) * 2 * W * pairs


def b14_mma_bound(n_bytes: int, R: int, W: int, pairs: int, dtype: str, deterministic: bool) -> dict:
    """B14's bound at the rates of the units it runs on: its two int8
    products (8 R W^2) at the tensor cores' int8 peak plus its attention's
    bf16 MMAs at the bf16 peak (q k^T six a product, q and k f32 in three
    terms; p v six, or one where the stochastic mode in bf16 rounds p), or
    its bytes, whichever is larger."""
    pv = 1 if dtype == "bfloat16" and not deterministic else 6
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * (8 * R * W * W / PEAK_INT8_OPS + (6 + pv) * 2 * W * pairs / PEAK_FLOPS["bfloat16"])
    return {"mma_bound_ms": max(by_bytes, by_ops), "mma_bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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
            work = (nbytes(*p) + nbytes(x), 16 * B * T * W * W)
            record("fused_mlp", label, dtype,
                   lambda: fused_mlp_block(x, ln, mlp, eps=1e-5),
                   lambda: fused_mlp_reference(*p, eps=1e-5), tol, timed, work=work)
            case = results["fused_mlp"]["cases"][-1]
            with torch.inference_mode():
                case["launch_ms"] = time_ms(k1_launch(x, ln, mlp))
            case.update(mma_bound(*work, case["dtype"], "fused_mlp"))
            print(f"kernel fused_mlp [{label} {case['dtype']}]: launches alone {case['launch_ms']:.4g} ms, "
                  f"mma bound {case['mma_bound_ms']:.4g} ms", flush=True)
        # K2: image T=200 (valid 197), 12 heads; text T=88 (valid 82), 8 heads.
        for label, (B, T, W, nh, valid), timed in (
            ("image 8x200x768 h12 valid197", (8, 200, 768, 12, 197), True),
            ("text 8x88x512 h8 valid82", (8, 88, 512, 8, 82), True),
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
            work = (nbytes(*args[:7]) + nbytes(x), 8 * B * T * W * W + 4 * W * attn_pairs(B, T, valid))
            record("fused_attn_block", label, dtype,
                   lambda: fused_attn_block(x, ln, attn, nh, valid_len=valid, eps=1e-5),
                   lambda: attn_block_reference(*args), tol, timed, work=work)
            case = results["fused_attn_block"]["cases"][-1]
            with torch.inference_mode():
                case["launch_ms"] = time_ms(k2_launch(x, ln, attn, nh, valid))
            case.update(mma_bound_of(work[0], k2_mma_flops(B, T, W, attn_pairs(B, T, valid), case["dtype"])))
            print(f"kernel fused_attn_block [{label} {case['dtype']}]: launches alone {case['launch_ms']:.4g} ms, "
                  f"mma bound {case['mma_bound_ms']:.4g} ms", flush=True)
        # K3: attribution pass, 8 classes x 8 heads, T=88 (valid 82, column 81);
        # and ViT-L/14@336 length T=584 with per-row valid/column.
        for label, (B, H, T, valid, eot), timed in (
            ("text 8x8x88 valid82 eot81", (8, 8, 88, 82, 81), True),
            ("long 2x16x584 per-row valid/eot", (2, 16, 584, [577, 300], [576, 17]), True),
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
            if timed:  # without the autograd Function around it; the launch alone
                case = results["fused_attention_aux"]["cases"][-1]
                with torch.inference_mode():
                    case["launcher_ms"] = time_ms(lambda: _fused_attention_cuda(q, k, v, False, valid, eot))
                    case["launch_ms"] = time_ms(k3_launch(q, k, v, False, valid, eot))
                case.update(mma_bound(*work, case["dtype"], "fused_attention_aux"))
                print(f"kernel fused_attention_aux [{label} {dtype}]: launcher {case['launcher_ms']:.4g} ms, "
                      f"launch alone {case['launch_ms']:.4g} ms, mma bound {case['mma_bound_ms']:.4g} ms", flush=True)
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
                    if name == "fused_mlp_bwd":  # dx alone: three products of 2 R W H on the tensor cores
                        dx_work = (in_bytes + nbytes(got[0]), 24 * B * T * W * W)
                        case["bound_dx_only_ms"] = bound(*dx_work, dname)["bound_ms"]
                        case["mma_bound_dx_only_ms"] = mma_bound(*dx_work, dname, name)["mma_bound_ms"]
                        case["launch_ms_dx_only"] = time_ms(b5_launch(x, g, ln, mlp))
                    else:  # dx alone: the three dx products and the attention core
                        pairs = attn_pairs(B, T, valid)
                        dx_bytes = in_bytes + nbytes(got[0])
                        case["bound_dx_only_ms"] = bound(dx_bytes, 14 * B * T * W * W + 12 * W * pairs,
                                                         dname)["bound_ms"]
                        case["mma_bound_ms"] = mma_bound_of(
                            in_bytes + nbytes(*got), b4_mma_flops(B, T, W, pairs, dname, False))["mma_bound_ms"]
                        case["mma_bound_dx_only_ms"] = mma_bound_of(
                            dx_bytes, b4_mma_flops(B, T, W, pairs, dname, True))["mma_bound_ms"]
                        case["launch_ms_dx_only"] = time_ms(b4_launch(x, g, ln, attn, nh, valid))
                results[name]["cases"].append(case)
                print(f"backward {name} [{shape} {dname}]: "
                      + ", ".join(f"{k}={v:.4g}" for k, v in case.items() if isinstance(v, float)),
                      flush=True)
                require(rel <= tol and rel_dx <= tol,
                        f"{name} {shape} {dname}: norm-relative error {max(rel, rel_dx):.3e} > {tol}")
    return results


def _core_case(dtype: str, B: int, T: int, W: int, valid: int):
    """qkv [B, T, 3W] and the cotangent g [B, T, W] of one B6/B7 bits case,
    numpy-seeded, in ``dtype``."""
    import torch

    rng = np.random.default_rng(B * T + W + valid)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(getattr(torch, dtype))

    return f(B, T, 3 * W), f(B, T, W)


def b7_digest(dtype: str, B: int, T: int, W: int, nh: int, valid: int, causal: bool) -> str:
    """sha256 (first 16 hex digits) of B7's packed dqkv on numpy-seeded qkv and cotangent."""
    import torch

    from tapclip_tpu_torch.ops.fused_mha import _fused_mha_bwd_cuda

    qkv, g = _core_case(dtype, B, T, W, valid)
    with torch.no_grad():
        return _sha16(_fused_mha_bwd_cuda(qkv, g, nh, valid, causal))


def b6_digest(dtype: str, B: int, T: int, W: int, nh: int, valid: int, causal: bool) -> str:
    """sha256 (first 16 hex digits) of B6's output on B7's numpy-seeded qkv."""
    import torch

    from tapclip_tpu_torch.ops.fused_mha import _fused_mha_cuda

    qkv, _ = _core_case(dtype, B, T, W, valid)
    with torch.no_grad():
        return _sha16(_fused_mha_cuda(qkv, nh, valid, causal))


def _sha16(t) -> str:
    """sha256 (first 16 hex digits) of a tensor's bytes."""
    import hashlib

    import torch

    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def _bits_block_case(dtype: str, B: int, T: int, W: int, valid: int):
    """x, the cotangent g, LayerNorm and attention weights of one bits case,
    numpy-seeded, at the card tests' scales (x and g in ``dtype``)."""
    import torch

    rng = np.random.default_rng(B * T + W + valid + 1)

    def f(*shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(s)).cuda()

    dt = getattr(torch, dtype)
    x, g = f(B, T, W).to(dt), f(B, T, W).to(dt)
    ln = {"scale": 1.0 + f(W, s=0.1), "bias": f(W, s=0.1)}
    attn = {"w_qkv": f(W, 3 * W, s=W ** -0.5), "b_qkv": f(3 * W, s=0.1), "w_out": f(W, W, s=W ** -0.5),
            "b_out": f(W, s=0.1)}
    return x, g, ln, attn


def k2_digest(dtype: str, B: int, T: int, W: int, nh: int, valid: int) -> str:
    """sha256 (first 16 hex digits) of K2's output on numpy-seeded inputs."""
    import torch

    from tapclip_tpu_torch.ops.fused_mha import fused_attn_block

    x, _, ln, attn = _bits_block_case(dtype, B, T, W, valid)
    with torch.inference_mode():
        return _sha16(fused_attn_block(x, ln, attn, nh, valid_len=valid))


def b4_digest(dtype: str, B: int, T: int, W: int, nh: int, valid: int) -> str:
    """sha256 (first 16 hex digits) of B4's dx (no weight gradients) on numpy-seeded inputs."""
    import torch

    from tapclip_tpu_torch.ops.fused_mha import _attn_block_bwd_cuda

    x, g, ln, attn = _bits_block_case(dtype, B, T, W, valid)
    with torch.no_grad():
        dx = _attn_block_bwd_cuda(x, g, ln["scale"], ln["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"], nh,
                                  valid, 1e-5, weight_grads=False)[0]
    return _sha16(dx)


def check_block_bits() -> dict:
    """K2_BITS and B4_BITS: K2's output and B4's dx bit for bit as before
    their kernels moved into shared headers, f32 and bf16."""
    out = {}
    for name, fn, want in (("K2", k2_digest, K2_BITS), ("B4", b4_digest, B4_BITS)):
        for dt in ("float32", "bfloat16"):
            for label, case in BLOCK_BITS_CASES.items():
                digest = fn(dt, *case)
                print(f"{name}_BITS [{label} {dt}]: {digest} (want {want[(dt, label)]})", flush=True)
                require(digest == want[(dt, label)],
                        f"{name}'s output changed at {label} {dt}: {digest} != {want[(dt, label)]}")
                out[f"{name} {label} {dt}"] = digest
    return out


def check_core_bits(name: str = "B7") -> dict:
    """B7_BITS (or B6_BITS): B7's (B6's) output bit for bit as its digests,
    f32 and bf16, at B7_BITS_CASES' shapes."""
    digest_of, want = (b7_digest, B7_BITS) if name == "B7" else (b6_digest, B6_BITS)
    got = {(dt, label): digest_of(dt, *case) for dt in ("float32", "bfloat16")
           for label, case in B7_BITS_CASES.items()}
    for key, digest in got.items():
        print(f"{name}_BITS [{key[1]} {key[0]}]: {digest} (want {want[key]})", flush=True)
        require(digest == want[key], f"{name}'s output changed at {key[1]} {key[0]}: {digest} != {want[key]}")
    return {f"{label} {dt}": d for (dt, label), d in got.items()}


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
        all_launches = read_counts()
        launches = {name: n for name, n in all_launches.items() if name in FORWARD}
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
    return {"launches": launches, "all_launches": all_launches, "stats": stats, "wall_s": wall, "logit_err": logit_err,
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
    idiomatic step's shape (8 classes at T 77, causal), the fused_split
    image shape (8 x 200, valid 197, W 768, 12 heads) and the MoE towers'
    two shapes (32 x 200 x 768, 12 heads, valid 197; 32 x 80 x 512, 8 heads,
    valid 77, causal); causal K3 at the
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
              ("image 8x200x768 h12 valid197", (8, 200, 768, 12, 197, False)),
              ("moe image 32x200x768 h12 valid197", (32, 200, 768, 12, 197, False)),
              ("moe text 32x80x512 h8 valid77 causal", (32, 80, 512, 8, 77, True)))
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
                        "launch_ms": time_ms(b6_launch(qkv, nh, valid, causal)),
                        **bound(nbytes(qkv, got), 4 * nh * Dh * pairs, dname),
                        **mma_bound(nbytes(qkv, got), 4 * nh * Dh * pairs, dname, "fused_mha")}
            report("fused_mha", case)

            with torch.no_grad():
                got = _fused_mha_bwd_cuda(qkv, g, nh, valid, causal)
                want = fused_mha_bwd_reference(qkv, g, nh, valid, causal)
                torch.cuda.synchronize()
                rel, ab = _rel_errors([got], [want])
                ms = time_ms(lambda: _fused_mha_bwd_cuda(qkv, g, nh, valid, causal))
                plain_ms = time_ms(lambda: fused_mha_bwd_reference(qkv, g, nh, valid, causal))
            leaves = [t.detach().clone().requires_grad_() for t in heads]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            g_heads = g.view(B, T, nh, Dh).transpose(1, 2)
            library_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g_heads, retain_graph=True))
            with torch.no_grad():
                launch_ms = time_ms(b7_launch(qkv, g, nh, valid, causal))
            b7_bytes = nbytes(qkv, g, got)
            report("fused_mha_bwd", {"shape": label, "dtype": dname, "max_rel_err": rel,
                                     "max_abs_err": ab, "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
                                     "library_ms": library_ms,
                                     **bound(b7_bytes, 10 * nh * Dh * pairs, dname),
                                     "fma_bound_ms": 1e3 * 10 * nh * Dh * pairs / PEAK_FLOPS[dname],
                                     **mma_bound_of(b7_bytes, b7_mma_flops(W, pairs, dname))})
            require(rel <= bwd_tol, f"fused_mha_bwd {label} {dname}: norm-relative error {rel:.3e} > {bwd_tol}")

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
                    "launch_ms": time_ms(k3_launch(q, k, v, True, None, eot_t)),
                    **bound(4 * nbytes(q) + 4 * B * T, 4 * H * 64 * attn_pairs(B, T, T, True), dname),
                    **mma_bound(4 * nbytes(q) + 4 * B * T, 4 * H * 64 * attn_pairs(B, T, T, True), dname,
                                "fused_attention_aux")}
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
        _flash_bwd_dkv_call,
        _flash_bwd_dkv_cuda,
        _flash_bwd_dq_call,
        _flash_bwd_dq_cuda,
        _flash_lse_call,
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
                bare = {  # each launch alone, on buffers allocated once
                    "flash_lse": bare_launch("tapclip_flash_lse", _flash_lse_call(q, k, valid_t, causal,
                                                                                  torch.empty_like(lse))),
                    "flash_bwd_dkv": bare_launch("tapclip_flash_bwd_dkv", _flash_bwd_dkv_call(
                        q, k, v, g, lse, delta, valid_t, causal, dk, dv)),
                    "flash_bwd_dq": bare_launch("tapclip_flash_bwd_dq", _flash_bwd_dq_call(
                        q, k, v, g, lse, delta, valid_t, causal, dq)),
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
                                  "ms": time_ms(kern[name], iters, 1), "launch_ms": time_ms(bare[name], iters, 1),
                                  "plain_ms": time_ms(plain[name], iters, 1),
                                  "library_ms": None if name == "flash_lse" else library_ms,
                                  "chain_ms": chain_ms, **bound(*work[name], dname),
                                  **mma_bound(*work[name], dname, name)})
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
                        "launch_ms": time_ms(k3_launch(q, k, v, causal, valid_t, eot), iters, 1),
                        **bound(4 * nbytes(q) + 4 * B * T, 4 * 64 * pairs, dname),
                        **mma_bound(4 * nbytes(q) + 4 * B * T, 4 * 64 * pairs, dname, "fused_attention_aux")})
            del q, k, v, g, out, lse, delta, dk, dv, dq
            torch.cuda.empty_cache()
    return results


def check_long_repairs() -> dict:
    """B7 and B4 at the ViT-L/14-336 vision shape (4 x 584, valid 577, W
    1024, 16 heads), past B4's routing limit, f32 and bf16: the autograd
    Functions' backward (B7's kernels; B4's split composition around B6,
    differentiated on B7) against the plain backward, with launch counts and
    times."""
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
        _expect(f"B7 at T {T} {dname}", launches, {"fused_mha": 1, "fused_mha_bwd": 1, "flash_lse": 0,
                                                   "flash_bwd_dkv": 0, "flash_bwd_dq": 0})
        with torch.no_grad():
            want = fused_mha_bwd_reference(qkv, g, nh, valid, False)
            rel, ab = _rel_errors([got], [want])
            case = {"shape": label, "dtype": dname, "max_rel_err": rel, "max_abs_err": ab,
                    "ms": time_ms(lambda: torch.autograd.grad(y, [qkv], g, retain_graph=True), 10, 2),
                    "plain_ms": time_ms(lambda: fused_mha_bwd_reference(qkv, g, nh, valid, False), 10, 2)}
        out[f"fused_mha_bwd {dname}"] = case
        print(f"B7 at T {T} [{label} {dname}]: B7's kernels vs plain B7 "
              + ", ".join(f"{k}={v:.4g}" for k, v in case.items() if isinstance(v, float)), flush=True)
        require(rel <= tol, f"B7 at T {T} {dname}: norm-relative error {rel:.3e} > {tol}")

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
                                                        "fused_mha": 1, "fused_mha_bwd": 1, "flash_bwd_dq": 0})
        with torch.no_grad():
            want = attn_block_bwd_reference(x, gx, *p[:5], nh, valid, 1e-5)
            rel, ab = _rel_errors(got, want)
            case = {"shape": label, "dtype": dname, "max_rel_err": rel, "max_abs_err": ab,
                    "ms": time_ms(lambda: torch.autograd.grad(y, leaves, gx, retain_graph=True), 10, 2),
                    "plain_ms": time_ms(lambda: attn_block_bwd_reference(x, gx, *p[:5], nh, valid, 1e-5), 10, 2)}
        out[f"fused_attn_block_bwd {dname}"] = case
        print(f"B4 past its tile [{label} {dname}]: split composition (B6 + B7) vs plain B4, all seven "
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
                            if name == "int8_mlp":  # the four launches alone, weights laid out once
                                case["launch_ms"] = time_ms(b13_launch(x, g, b, qm, det))
                            else:  # the five launches alone, weights laid out once; the MMA bound
                                case["launch_ms"] = time_ms(b14_launch(x, g, b, qa, nh, valid, det))
                                case.update(b14_mma_bound(nbytes(x, x, qa["w_qkv"], qa["w_out"]) + 4 * 10 * W, R,
                                                          W, attn_pairs(B, T, valid), dname, det))
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


def int8_digest(dtype: str, B: int, T: int, W: int, **flags) -> str:
    """sha256 (first 16 hex digits) of B13's output (``flags`` none or
    ``deterministic``) or S5's (``erf3`` / ``recipmul``) on numpy-seeded
    inputs, H = 4 W."""
    import torch

    from tapclip_tpu_torch.ops.int8_mlp import int8_mlp_cuda, int8_mlp_variant, quantize_mlp

    rng = np.random.default_rng(B * T + W + 13)
    H = 4 * W

    def f(*shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(s)).cuda()

    x = f(B, T, W).to(getattr(torch, dtype))
    gamma, beta = 1.0 + f(W, s=0.1), f(W, s=0.1)
    q = quantize_mlp({"w_fc": f(W, H, s=W ** -0.5), "b_fc": f(H, s=0.1), "w_proj": f(H, W, s=H ** -0.5),
                      "b_proj": f(W, s=0.1)})
    with torch.inference_mode():
        if flags.get("erf3") or flags.get("recipmul"):
            return _sha16(int8_mlp_variant(x, gamma, beta, q, **flags))
        return _sha16(int8_mlp_cuda(x, gamma, beta, q, **flags))


def check_int8_variants() -> dict:
    """S5: the driver (``scripts/int8_mlp_ab.py``) at ViT-B/16, batch 8, f32
    and bf16: each variant against B13, its parent (same draws), and against
    its plain version, timed in turns through the wrappers and as the
    launches alone; then S5_BITS."""
    import torch

    from tapclip_tpu_torch.scripts.int8_mlp_ab import VARIANTS, port_flags, run

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        res = run(B=8, model="ViT-B-16", reps=3, dtype=dtype)
        dt = res["dtype"]
        out[dt] = res
        par, launch = res["parent"], res["launch_ms"]["ms"]
        print(f"int8 variants [{res['shape']} {dt}]: parent B13 {par['ms']:.4g} ms through the wrapper, "
              f"{launch['parent']:.4g} launches alone (plain {par['plain_ms']:.4g}), bound {res['bound_ms']:.4g} ms "
              f"({res['bound_by']}), vs its plain version (update) {par['update_rel_err']:.3e}", flush=True)
        require(par["update_rel_err"] <= INT8_TOL[dt], f"int8 variants {dt}: B13 {par['update_rel_err']:.3e} "
                                                       f"from its plain version")
        for name, v in res["variants"].items():
            print(f"int8 variant {name} [{dt}]: {v['ms']:.4g} ms (x{v['ratio']:.3f} of B13), launches alone "
                  f"{launch[name]:.4g} (x{launch[name] / launch['parent']:.3f}), plain {v['plain_ms']:.4g} ms, vs "
                  f"B13 {v['vs_parent']['rel_err']:.3e}, vs its plain version (update) "
                  f"{v['vs_plain']['update_rel_err']:.3e}"
                  + (f", bit-equal to B13: {v['bit_equal_parent']}" if "bit_equal_parent" in v else "")
                  + f", repeats: {v['repeats']}", flush=True)
            require(v["vs_plain"]["finite"], f"int8 variant {name} {dt}: output is not finite")
            require(v["vs_parent"]["rel_err"] <= INT8_VARIANT_TOL,
                    f"int8 variant {name} {dt}: {v['vs_parent']['rel_err']:.3e} from B13 > {INT8_VARIANT_TOL}")
            require(v["vs_plain"]["update_rel_err"] <= INT8_TOL[dt],
                    f"int8 variant {name} {dt}: {v['vs_plain']['update_rel_err']:.3e} from its plain version")
            require(v.get("bit_equal_parent", True), f"int8 variant {name} {dt}: differs from B13, whose output it is")
            require(v["repeats"], f"int8 variant {name} {dt}: a second call differs")
    bits = {}
    for (dt, label, name), want in S5_BITS.items():
        digest = int8_digest(dt, *INT8_BITS_CASES[label], **port_flags(VARIANTS[name]))
        print(f"S5_BITS [{label} {dt} {name}]: {digest} (want {want})", flush=True)
        require(digest == want, f"S5 {name}'s output changed at {label} {dt}: {digest} != {want}")
        bits[f"{label} {dt} {name}"] = digest
    out["bits"] = bits
    return out


def check_b13_bits() -> dict:
    """B13_BITS: B13's output bit for bit as the __dp4a walk it replaced,
    stochastic and round to nearest, f32 and bf16, at the image shape (8 x
    200, W 768) and the pruned one (8 x 96, ``--token-keep-ratio 0.5``)."""
    out = {}
    for (dt, label, mode), want in B13_BITS.items():
        digest = int8_digest(dt, *INT8_BITS_CASES[label], deterministic=mode == "round-to-nearest")
        print(f"B13_BITS [{label} H{4 * INT8_BITS_CASES[label][2]} {dt} {mode}]: {digest} (want {want})", flush=True)
        require(digest == want, f"B13's output changed at {label} {dt} {mode}: {digest} != {want}")
        out[f"{label} {dt} {mode}"] = digest
    return out


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


def check_ab_variants() -> dict:
    """S1-S4: the four A/B drivers at ViT-B/16, batch 8, f32 and bf16."""
    import importlib

    import torch

    out = {}
    for driver in AB_DRIVERS:
        mod = importlib.import_module(f"tapclip_tpu_torch.scripts.{driver}")
        for dtype in (torch.float32, torch.bfloat16):
            res = mod.run(B=8, model="ViT-B-16", reps=3, dtype=dtype)
            dt = res["dtype"]
            out[(driver, dt)] = res
            par = res["parent"]
            print(f"ab {driver} [{res['shape']} {dt}]: parent ({AB_PARENTS[driver]}) {par['ms']:.4g} ms "
                  f"(plain {par['plain_ms']:.4g}), bound {res['bound_ms']:.4g} ms ({res['bound_by']}), "
                  f"MMA bound {res['mma_bound_ms']:.4g} ms"
                  + (f", cooperative grid {res['grid']}" if "grid" in res else ""), flush=True)
            if AB_PARENTS[driver] == "K2":  # S3's and S4's parent, held against its plain version
                require(par["finite"] and par["tol_needed"] <= AB_TOL[dt],
                        f"ab {driver} parent K2 {dt}: {par['tol_needed']:.3e} from its plain version")
            for name, v in res["variants"].items():
                if "same_as" in v:
                    print(f"ab {driver} {name} [{dt}]: same kernel as {v['same_as']}", flush=True)
                    continue
                tol = AB_TOL[dt]
                if dt == "float32" and v["flags"].get("softmax_opt") == "bf16":
                    tol = AB_BF16_SOFTMAX_F32_TOL
                print(f"ab {driver} {name} [{dt}]: {v['ms']:.4g} ms (x{v['ratio']:.3f} of the parent), "
                      f"plain {v['plain_ms']:.4g} ms, vs plain max abs {v['vs_plain']['max_abs_err']:.3e} "
                      f"(needs {v['vs_plain']['tol_needed']:.3e}, limit {tol}), vs parent max abs "
                      f"{v['vs_parent']['max_abs_err']:.3e} rel {v['vs_parent']['rel_err']:.3e}"
                      + (f", bit-equal to the parent: {v['bit_equal_parent']}" if "bit_equal_parent" in v else "")
                      + f", repeats: {v['repeats']}",
                      flush=True)
                require(v["vs_plain"]["finite"], f"ab {driver} {name} {dt}: output is not finite")
                require(v["vs_plain"]["tol_needed"] <= tol,
                        f"ab {driver} {name} {dt}: {v['vs_plain']['tol_needed']:.3e} from its plain version > {tol}")
                require(v.get("bit_equal_parent", True),
                        f"ab {driver} {name} {dt}: differs from the parent, whose output it is")
                require(v["repeats"], f"ab {driver} {name} {dt}: a second call differs (no atomics: it must not)")
    return out


def _ab_source(driver: str, flags: dict) -> str:
    if driver == "fused_layer_ab":
        return "tapclip_tpu_torch/csrc/fused_layer.cu"
    if driver == "mlp_kernel_ab":
        return "tapclip_tpu_torch/csrc/fused_mlp_variants.cu"
    online = flags["form"] == "softmax" or flags.get("softmax_opt") is True
    return f"tapclip_tpu_torch/csrc/attn_variants_{'online' if online else 'two_pass'}.cu"


def ab_record(ab: dict, launches: dict) -> list:
    """The kernels-line entries of S1-S4: one per distinct variant kernel, with
    its launches on the serving drive (0: no main path reaches it), f32 error
    and times, bf16 beside them."""
    import importlib

    counter = {"fused_layer_ab": "fused_layer", "mlp_kernel_ab": "fused_mlp_variant",
               "attn_kernel_ab": "attn_block_variant", "attn_softmax_ab": "attn_block_variant"}
    out = []
    for driver in AB_DRIVERS:
        mod = importlib.import_module(f"tapclip_tpu_torch.scripts.{driver}")
        f32, bf16 = ab[(driver, "float32")], ab[(driver, "bfloat16")]
        for name, v in f32["variants"].items():
            if "same_as" in v:
                continue
            replaces = mod.REPLACES if isinstance(mod.REPLACES, str) else mod.REPLACES[mod.VARIANTS[name][0]]
            b = bf16["variants"][name]
            out.append({
                "name": f"{driver[:-3]}:{name}", "route": "cuda", "source": _ab_source(driver, v["flags"]),
                "replaces": replaces, "launches": launches[counter[driver]],
                "max_abs_err": v["vs_plain"]["max_abs_err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
                "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"], "library_ms": None,
                "mma_bound_ms": f32["mma_bound_ms"], "bf16_mma_bound_ms": bf16["mma_bound_ms"],
                "shape": f32["shape"], "flags": v["flags"],
                "same_as_this": [n for n, w in f32["variants"].items() if w.get("same_as") == name],
                "parent": AB_PARENTS[driver], "parent_ms": f32["parent"]["ms"], "ratio": v["ratio"],
                "vs_parent_rel_err": v["vs_parent"]["rel_err"], "bit_equal_parent": v.get("bit_equal_parent"),
                "bf16_ms": b["ms"], "bf16_plain_ms": b["plain_ms"], "bf16_max_abs_err": b["vs_plain"]["max_abs_err"],
                "bf16_bound_ms": bf16["bound_ms"], "bf16_parent_ms": bf16["parent"]["ms"],
                "bf16_bit_equal_parent": b.get("bit_equal_parent"),
            })
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


# The "files" phase: the reference workloads driven from files at ViT-B/16
# f32 (the reference_train preset with --model ViT-B-16).  The card's machine
# has PIL and pandas but neither matplotlib nor the libjpeg/libpng headers
# (checked once on the card): the loaders decode with PIL, and the phase runs
# train's and test_cross_domain2's parse and run, the functions their mains
# call before plotting.
FILES_MODEL = "ViT-B-16"
FILES_DEVICE = "cuda"
FILES_SIZE = 224  # the tree's images, px
FILES_UNSEEN = "Clipboards"
FILES_IMAGES = 8  # per class and domain
FILES_SHOTS = 4
FILES_BATCH = 8
FILES_EPOCHS = 2
FILES_EVAL_BATCH = 256  # trainer.evaluate_cached
# Kernels per text pass pair (the attribution pass: 11 K2, K3 at the last
# block, 12 K1; the encode pass: 12 K2, 12 K1), per image batch (12 K2, 12
# K1) and per train step's backward (12 B4, 12 B5) of ViT-B/16 in ref_compat.
TEXT_PASS = {"fused_mlp": 24, "fused_attn_block": 23, "fused_attention_aux": 1}
IMAGE_BATCH = {"fused_mlp": 12, "fused_attn_block": 12}
STEP_BWD = {"fused_attn_block_bwd": 12, "fused_mlp_bwd": 12}
FILES_KERNELS = FORWARD + BACKWARD


def _counts(n_text: int = 0, n_image: int = 0, n_steps: int = 0) -> dict:
    want = {name: 0 for name in FILES_KERNELS}
    for table, n in ((TEXT_PASS, n_text), (IMAGE_BATCH, n_image), (STEP_BWD, n_steps)):
        for name, k in table.items():
            want[name] += k * n
    return want


def _delta(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in FILES_KERNELS}


def _write_tree(root: str, domains, classes, per_class: int = FILES_IMAGES) -> int:
    """Class-colored ``FILES_SIZE`` px JPEGs, ``per_class`` per class and domain."""
    import os

    from PIL import Image

    rng = np.random.default_rng(0)
    n = 0
    for dom in domains:
        for ci, name in enumerate(classes):
            d = os.path.join(root, dom, name)
            os.makedirs(d)
            base = np.zeros(3)
            base[ci % 3] = 60 + 30 * ci
            for i in range(per_class):
                arr = np.clip(base + rng.normal(0, 25, (FILES_SIZE, FILES_SIZE, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"))
                n += 1
    return n


def _busy_share(fn) -> dict:
    """Device busy and idle share of one call of ``fn`` from a
    ``torch.profiler`` trace: the union of the kernels' intervals over the
    call's host span (``scripts/profile_kernels.py``'s method)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    from tapclip_tpu_torch.scripts.profile_kernels import _union_us

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("files.epoch"):
            out = fn()
            torch.cuda.synchronize()
    window, spans, kernels = None, [], 0
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if str(getattr(ev, "device_type", "")) == "DeviceType.CUDA":
            if getattr(ev, "is_user_annotation", False) or ev.name == "files.epoch":
                continue
            spans.append((a, b))
            kernels += not ev.name.startswith(("Memcpy", "Memset"))
        elif ev.name == "files.epoch":
            window = (a, b)
    require(window is not None and kernels > 0, "the profiler trace holds no device time")
    busy = _union_us([(max(a, window[0]), min(b, window[1])) for a, b in spans if b > window[0] and a < window[1]])
    span = window[1] - window[0]
    return {"out": out, "span_ms": span / 1e3, "busy_share": busy / span, "idle_share": 1.0 - busy / span,
            "device_ops": kernels}


def _served(base: str, images: np.ndarray) -> list:
    with ThreadPoolExecutor(len(images)) as pool:
        return list(pool.map(lambda j: _post(base + "/predict", {"pixels": images[j].tolist()}),
                             range(len(images))))


def _probs_of(answers: list, names) -> np.ndarray:
    return np.array([[r["probs"][n] for n in names] for r in answers])


def files_phase(card: str) -> dict:
    """The reference workloads from files on the card (ViT-B/16, f32): an
    open_clip state dict written with ``save_openclip_checkpoint``, an
    OfficeHome-shaped ImageFolder tree, ``train`` (2 epochs, 4 shots, batch
    8, a snapshot per epoch, one kept) with its launches per epoch and a
    ``--resume`` from the epoch-1 snapshot, ``test_cross_domain2`` over the
    four domains with the unseen class, and ``serve --pretrained --ckpt``
    over HTTP with ``POST /reload``."""
    import os
    import shutil
    import tempfile

    import torch

    from tapclip_tpu_torch import test_cross_domain2, train
    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.data import native
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader
    from tapclip_tpu_torch.data.preprocess import make_preprocess
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import encode_dataset_features
    from tapclip_tpu_torch.serve import PredictService, build_model, make_http_server
    from tapclip_tpu_torch.test_cross_domain import DEFAULT_DOMAINS
    from tapclip_tpu_torch.utils import checkpoint as ckpt_mod
    from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint, save_openclip_checkpoint

    cfg, dev = MODEL_PRESETS[FILES_MODEL], FILES_DEVICE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        # 1. Two seeded state dicts in open_clip layout, and one whose
        # projections are half as wide (a reload that must be refused).
        sd, t0 = {}, time.perf_counter()
        for seed in (1, 2):
            params = clip_model.init_clip_params(torch.Generator(device=dev).manual_seed(seed), cfg)
            sd[seed] = save_openclip_checkpoint(params, cfg, os.path.join(tmp, f"open_clip_{seed}.bin"))
        half = cfg.embed_dim // 2
        params["visual"]["proj"] = params["visual"]["proj"][:, :half]
        params["text"]["text_projection"] = params["text"]["text_projection"][:, :half]
        sd["bad"] = save_openclip_checkpoint(params, cfg, os.path.join(tmp, "open_clip_half.bin"))
        del params
        write_s = time.perf_counter() - t0
        mb = os.path.getsize(sd[1]) / 2 ** 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_openclip_checkpoint(sd[1], cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"files: wrote 3 {cfg.name} state dicts of {mb:.0f} MB in {write_s:.2f} s; load + convert onto the "
              f"card {load_s:.3f} s ({card})", flush=True)

        # 2. The tree: 4 domains x (5 train classes + the unseen one) x 8.
        tree = os.path.join(tmp, "OfficeHome")
        classes = TRAIN_CLASSES + [FILES_UNSEEN]
        n_files = _write_tree(tree, DEFAULT_DOMAINS, classes)
        files = [p for d in DEFAULT_DOMAINS for p, _ in ImageFolderIndex.scan(os.path.join(tree, d)).samples]
        require(len(files) == n_files == 4 * 6 * FILES_IMAGES, f"tree holds {len(files)} images")

        # 3. train: parse + run (main's steps before plotting), launch counts
        # read at each epoch's snapshot; the epoch-1 snapshot is copied aside
        # before the retention sweep (keep 1) deletes it.
        common = ["--preset", "reference_train", "--model", FILES_MODEL, "--dtype", "float32", "--device", dev,
                  "--pretrained", sd[1], "--classes", *TRAIN_CLASSES, "--num-shots", str(FILES_SHOTS),
                  "--batch-size", str(FILES_BATCH), "--data-root", os.path.join(tree, DEFAULT_DOMAINS[0])]
        snaps = []  # (time the epoch ended, launch counts, time its snapshot was written)
        epoch1 = os.path.join(tmp, "epoch1.pt")
        save = ckpt_mod.CheckpointManager.save

        def recording_save(self, **kw):
            torch.cuda.synchronize()
            ended, counts = time.perf_counter(), read_counts()
            path = save(self, **kw)
            if kw["extra_meta"]["epoch"] == 1:
                shutil.copy(path, epoch1)
            snaps.append((ended, counts, time.perf_counter()))
            return path

        ckpt_mod.CheckpointManager.save = recording_save
        try:
            args, tcfg = train.parse(common + ["--epochs", str(FILES_EPOCHS), "--save-every", "1", "--keep-last-n", "1",
                                               "--output-root", os.path.join(tmp, "train")])
            reset_counts()
            t0 = time.perf_counter()
            out = train.run(args, tcfg)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = read_counts()
        finally:
            ckpt_mod.CheckpointManager.save = save
        res = out["result"]
        n_train = n_val = len(TRAIN_CLASSES) * FILES_SHOTS
        steps = -(-n_train // FILES_BATCH)
        per_epoch = _counts(n_text=steps + 1 + -(-n_val // FILES_EVAL_BATCH), n_steps=steps)
        caching = _counts(n_image=-(-n_train // FILES_BATCH) + -(-n_val // FILES_BATCH))
        require(len(snaps) == FILES_EPOCHS, f"{len(snaps)} snapshots in {FILES_EPOCHS} epochs")
        _expect("files train epoch 1 (+ the image tower over the splits)", _delta(snaps[0][1], {k: 0 for k in FILES_KERNELS}),
                {k: per_epoch[k] + caching[k] for k in FILES_KERNELS})
        _expect("files train epoch 2", _delta(snaps[1][1], snaps[0][1]), per_epoch)
        _expect("files train run (+ the attribution rows)", launches,
                {k: caching[k] + FILES_EPOCHS * per_epoch[k] + _counts(n_text=1)[k] for k in FILES_KERNELS})
        epoch_ms = 1e3 * (snaps[1][0] - snaps[0][2])
        paths = out["paths"]
        history = json.load(open(os.path.join(paths["csv_dir"], "history.json")))
        kept = sorted(os.listdir(os.path.join(paths["model_dir"], "checkpoints")))
        require(history["loss"] == res.loss_history and len(history["acc"]) == FILES_EPOCHS, f"history {history}")
        require(all(np.isfinite(history["loss"])), f"non-finite loss {history['loss']}")
        require(kept == ["manager_index.json", f"step_{2 * steps:08d}.pt"], f"checkpoints kept: {kept}")
        require(os.path.isfile(out["ckpt"]) and ckpt_mod.restore_prompt_checkpoint(out["ckpt"])["meta"]["class_names"]
                == TRAIN_CLASSES, f"best checkpoint {out['ckpt']}")
        print(f"files: train {FILES_EPOCHS} epochs in {train_s:.2f} s ({1e3 * (snaps[0][0] - t0):.1f} ms from the "
              f"start of the run to the end of epoch 1: the state dict's load, the image tower over {n_train + n_val} "
              f"files and epoch 1; {epoch_ms:.1f} ms for epoch 2, {steps} steps at batch {FILES_BATCH}); loss "
              f"{res.loss_history}, acc {res.acc_history}; launches per epoch {per_epoch}, whole run "
              f"{_delta(launches, {k: 0 for k in FILES_KERNELS})}; the loaders' decode path: {out['decoder']} ({card})",
              flush=True)
        require(out["decoder"] == "pil", f"train's loaders took the {out['decoder']} path")

        # The resume: epoch 2 again from the epoch-1 snapshot.
        args, tcfg = train.parse(common + ["--epochs", "1", "--resume", epoch1,
                                           "--output-root", os.path.join(tmp, "resume")])
        resumed = train.run(args, tcfg)["result"]
        err = abs(resumed.loss_history[0] - res.loss_history[1]) / abs(res.loss_history[1])
        print(f"files: --resume from epoch 1: epoch-2 loss {resumed.loss_history[0]} vs {res.loss_history[1]} "
              f"uninterrupted, rel err {err:.3e} (tol {TRAIN_TOL['float32']['loss']}); acc "
              f"{resumed.acc_history} vs {res.acc_history[1:]}", flush=True)
        require(err <= TRAIN_TOL["float32"]["loss"], f"resumed epoch-2 loss differs by {err:.3e}")
        require(resumed.final_state.step == res.final_state.step, "the resumed run ends at another step")

        # 4. test_cross_domain2: the four domains, the unseen class joining the bank.
        args, xcfg = test_cross_domain2.parse(
            ["--preset", "reference_train", "--model", FILES_MODEL, "--dtype", "float32", "--device", dev,
             "--pretrained", sd[1], "--checkpoint", out["ckpt"], "--domain-root", tree,
             "--domains", *DEFAULT_DOMAINS, "--shots", "0", str(FILES_SHOTS), "--seen-classes", *classes,
             "--batch-size", str(FILES_BATCH), "--output-root", os.path.join(tmp, "xd2")])
        reset_counts()
        t0 = time.perf_counter()
        grid = test_cross_domain2.run(args, xcfg)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        grid_launches = read_counts()
        cells = {(r["Domain"], r["Shots"]) for r in grid["results"]}
        require(cells == {(d, s) for d in DEFAULT_DOMAINS for s in ("Zero-Shot", f"{FILES_SHOTS}-shot")}
                and len(grid["results"]) == 8, f"grid {grid['results']}")
        require(all(0.0 <= r["Accuracy"] <= 100.0 for r in grid["results"]), f"grid {grid['results']}")
        require(open(grid["csv"]).readline().strip() == "Domain,Shots,Accuracy", "cross-domain CSV header")
        for name in FILES_KERNELS:
            require(grid_launches[name] > 0, f"{name} was not launched on the cross-domain grid")
        print(f"files: test_cross_domain2 grid in {grid_s:.2f} s: "
              + ", ".join(f"{r['Domain']}/{r['Shots']} {r['Accuracy']:.2f}" for r in grid["results"])
              + f"; launches {_delta(grid_launches, {k: 0 for k in FILES_KERNELS})} ({card})", flush=True)

        # 5. serve --pretrained --ckpt (main's model loading), /reload.
        t0 = time.perf_counter()
        model = build_model(cfg, TRAIN_CLASSES, dev, pretrained=sd[1], ckpt=out["ckpt"])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        service = PredictService(model, batch_size=8, max_latency_ms=2000.0)
        server = make_http_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        images = np.random.default_rng(1).integers(0, 256, (8, FILES_SIZE, FILES_SIZE, 3), dtype=np.uint8)

        def against(ref, label):
            with torch.inference_mode():
                want = ref(images)["logits"].float().cpu().numpy()
                got = service.model(images)["logits"].float().cpu().numpy()
            served = _served(base, images)
            logit_err = float(np.abs(got - want).max())
            prob_err = float(np.abs(_probs_of(served, TRAIN_CLASSES) - _plain_probs(want)).max())
            same = [r["index"] for r in served] == want.argmax(-1).tolist()
            print(f"files: serve {label}: logits max abs err {logit_err:.3e} (tol {LOGIT_TOL}), served probs "
                  f"{prob_err:.3e} (tol {PROB_TOL}), argmax equal {same}", flush=True)
            require(logit_err <= LOGIT_TOL and prob_err <= PROB_TOL and same, f"serve {label} differs")
            return served

        try:
            reset_counts()
            plain_cfg = cfg.replace(attn_impl="xla")
            ref = FullModel(TRAIN_CLASSES, load_openclip_checkpoint(sd[1], plain_cfg, device=dev), plain_cfg)
            ckpt_mod.apply_prompt_checkpoint(ref, out["ckpt"])
            before = against(ref, "--pretrained --ckpt vs an in-memory plain model from the same files")
            serve_launches = read_counts()
            bad = _post_status(base + "/reload", {"path": sd["bad"]})
            after_bad = _served(base, images)
            drift = float(np.abs(_probs_of(after_bad, TRAIN_CLASSES) - _probs_of(before, TRAIN_CLASSES)).max())
            require(bad[0] == 400 and "shape mismatches" in bad[1].get("error", ""), f"mismatched /reload: {bad}")
            require(drift <= 1e-6 and [r["index"] for r in after_bad] == [r["index"] for r in before],
                    f"a refused /reload changed the served answers by {drift:.3e}")
            t0 = time.perf_counter()
            ok = _post_status(base + "/reload", {"path": sd[2]})
            reload_s = time.perf_counter() - t0
            require(ok == (200, {"reloaded": True, "classes": TRAIN_CLASSES}), f"/reload: {ok}")
            fresh = build_model(cfg, TRAIN_CLASSES, dev, pretrained=sd[2], ckpt=out["ckpt"])
            after = against(fresh, "after POST /reload vs a fresh model from the second state dict")
            moved = float(np.abs(_probs_of(after, TRAIN_CLASSES) - _probs_of(before, TRAIN_CLASSES)).max())
            require(moved > 1e-3, "the reload did not change the served answers")
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=10)
        for name in FORWARD:
            require(serve_launches[name] > 0, f"{name} was not launched serving from files")
        print(f"files: serve built from the files in {build_s:.2f} s; refused /reload answered 400 "
              f"({bad[1]['error'][:80]}...), answers unchanged (max diff {drift:.1e}); /reload of the second state "
              f"dict {reload_s:.2f} s; launches {_delta(serve_launches, {k: 0 for k in FILES_KERNELS})} ({card})",
              flush=True)

        # 6. The loader alone, and one file-fed epoch through the tower, traced.
        rates = {}
        for path, use_native in (("pil", False), ("native", True)):
            if use_native and not native.available():
                rates[path] = f"unavailable: {native.build_error()[:60]}"
                continue
            loader = Loader([(p, 0) for p in files], FILES_BATCH, image_size=FILES_SIZE, use_native=use_native)
            t0 = time.perf_counter()
            n = sum(int(m.sum()) for _, _, m in loader)
            rates[path] = n / (time.perf_counter() - t0)
            require(n == len(files), f"{path} loader decoded {n} of {len(files)}")
        loader = Loader([(p, 0) for p in files], FILES_BATCH, image_size=FILES_SIZE,
                        preprocess=make_preprocess(FILES_SIZE))
        traced = _busy_share(lambda: encode_dataset_features(model.clip_params, cfg, loader))
        feats = traced["out"][0]
        require(feats.shape == (len(files), cfg.embed_dim) and np.isfinite(feats).all(), "file-fed features")
        print(f"files: loader images/s at {FILES_SIZE} px, batch {FILES_BATCH}, 4 workers: "
              + ", ".join(f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}" for k, v in rates.items())
              + f"; one file-fed epoch ({len(files)} files -> PIL decode -> prefetch -> the image tower) "
              f"{traced['span_ms']:.1f} ms traced, {1e3 * len(files) / traced['span_ms']:.1f} images/s, device busy "
              f"{traced['busy_share']:.3f} / idle {traced['idle_share']:.3f} ({traced['device_ops']} device ops) "
              f"({card})", flush=True)
        return {"launches": launches, "per_epoch": per_epoch, "epoch_ms": epoch_ms, "load_s": load_s,
                "loader_images_per_s": rates, "busy_share": traced["busy_share"],
                "grid_launches": grid_launches, "serve_launches": serve_launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The "eval" phase: the offline inference and evaluation entry points from
# files at ViT-B/16 f32 (random weights from a seed, saved as an open_clip
# state dict; a reference prompt .pt of seeded context), each held against
# the same model on the plain versions (attn_impl="xla") on the card, with
# every kernel's launches read around each driver.
EVAL_DOMAINS = ["Real World", "Art"]
EVAL_IMAGES = 32  # per class and domain
EVAL_BATCH = 32
EVAL_CAPTIONS = 64  # captioned JPEGs in the shard dir, shards of 32
EVAL_CACHE_BATCH = 128  # trainer.PathFeatureCache
SEARCH_ROWS = 1_000_000
SEARCH_QUERIES = (1, 64)
DEDUP_ROWS = 65_536
# featurize stores float16 unit-norm rows: a kernel-vs-plain difference of
# 1e-6 can land a value on the other side of a float16 rounding step (4.9e-4
# near 0.25), so the rows are held at a few steps.
EMB_TOL = 2e-3
# Scores of the bf16 index, f32 on the card against float64 of the same bf16
# values: only the order of the f32 sum differs (512 terms).
SEARCH_TOL = 1e-5
# Per text batch of the causal tower (12 B6, 12 K1) and per int8 image
# batch (12 B13, 12 B14).
TEXT_BATCH = {"fused_mlp": 12, "fused_mha": 12}
INT8_BATCH = {"int8_mlp": 12, "int8_attn": 12}
EVAL_KERNELS = FORWARD + BACKWARD + ("fused_mha", "int8_mlp", "int8_attn")


def _eval_counts(text_pass: int = 0, image: int = 0, text_batch: int = 0, int8: int = 0, steps: int = 0) -> dict:
    want = {name: 0 for name in EVAL_KERNELS}
    for table, n in ((TEXT_PASS, text_pass), (IMAGE_BATCH, image), (TEXT_BATCH, text_batch), (INT8_BATCH, int8),
                     (STEP_BWD, steps)):
        for name, k in table.items():
            want[name] += k * n
    return want


def _counted(where: str, want: dict, fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before and read
    just after: the counts of EVAL_KERNELS must be ``want`` exactly.
    Returns (the result, the counts, seconds)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_counts()
    _expect(where, got, want)
    return out, {name: got[name] for name in EVAL_KERNELS}, seconds


def _write_shards(path: str) -> list:
    """EVAL_CAPTIONS noise JPEGs (224 x 256) with class captions, shards of 32."""
    import io

    from PIL import Image

    from tapclip_tpu_torch.data.shards import write_shards

    rng = np.random.default_rng(4)
    samples = []
    for i in range(EVAL_CAPTIONS):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (FILES_SIZE, FILES_SIZE + 32, 3), dtype=np.uint8)).save(buf, "JPEG")
        samples.append((buf.getvalue(), f"a photo of a {TRAIN_CLASSES[i % len(TRAIN_CLASSES)].replace('_', ' ')}"))
    write_shards(samples, path, shard_size=32)
    return [c for _, c in samples]


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output (``search``'s result lines) dropped."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _by_label(row: dict) -> dict:
    return dict(zip(row["labels"], row["scores"]))


def _rows_err(got: list, want: list) -> tuple:
    """Max abs difference of the per-class probabilities of two predict runs
    (top-k = every class), and the rows whose top-1 differs where the plain
    run's top-2 gap exceeds twice that difference."""
    err = max(abs(_by_label(g)[n] - p) for g, w in zip(got, want) for n, p in _by_label(w).items())
    flips = [w["path"] for g, w in zip(got, want)
             if g["labels"][0] != w["labels"][0] and w["scores"][0] - w["scores"][1] > 2 * err]
    return err, flips


def eval_phase(card: str) -> dict:
    """The offline inference and evaluation entry points on the card
    (ViT-B/16, f32), from files under a temporary directory: ``featurize``
    (an ImageFolder domain with one duplicated file; a shard dir with
    ``--embed-text``), ``search`` (by row, by text, ``--dedup``),
    ``predict`` (float and ``--int8``), ``patch_saliency`` and ``/explain``
    with ``"saliency"`` over HTTP, ``zero_shot_eval`` over two domains,
    ``evaluate_adaptive``, ``robustness`` (clean, gaussian_noise and
    pixelate at severities 1 and 5) and a ``sweep`` of two cells; then
    ``SearchIndex`` at 1,000,000 x 512 and ``find_duplicates`` over 65,536
    rows."""
    import csv
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    from tapclip_tpu_torch import featurize, predict, robustness, search, sweep, zero_shot_eval
    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.data.imagefolder import ImageFolderIndex, Loader, few_shot_split
    from tapclip_tpu_torch.data.tokenizer import get_tokenizer
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.serve import PredictService, make_http_server
    from tapclip_tpu_torch.utils.adaptive_eval import evaluate_adaptive
    from tapclip_tpu_torch.utils.checkpoint import apply_prompt_checkpoint
    from tapclip_tpu_torch.utils.saliency import patch_saliency, vision_attention_forward
    from tapclip_tpu_torch.utils.torch_convert import (
        load_openclip_checkpoint,
        save_openclip_checkpoint,
        save_reference_prompt_checkpoint,
    )

    cfg, dev = MODEL_PRESETS[FILES_MODEL], FILES_DEVICE
    plain_cfg = cfg.replace(attn_impl="xla")
    model_args = ["--model", FILES_MODEL, "--device", dev]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    launches, seconds = {}, {}

    def counted(name, want, fn, *args):
        out, launches[name], seconds[name] = _counted(f"eval {name}", want, fn, *args)
        return out

    try:
        # 1. The files: a state dict, a prompt .pt, the tree (+ one duplicated
        # JPEG), the shard dir.
        params = clip_model.init_clip_params(torch.Generator(device=dev).manual_seed(3), cfg)
        sd = save_openclip_checkpoint(params, cfg, os.path.join(tmp, "open_clip.bin"))
        del params
        ctx = 0.02 * np.random.default_rng(3).standard_normal((len(TRAIN_CLASSES), 5, cfg.text_width))
        ckpt = save_reference_prompt_checkpoint(ctx.astype(np.float32), TRAIN_CLASSES, os.path.join(tmp, "p.pt"))
        tree = os.path.join(tmp, "OfficeHome")
        _write_tree(tree, EVAL_DOMAINS, TRAIN_CLASSES, EVAL_IMAGES)
        dom0 = os.path.join(tree, EVAL_DOMAINS[0])
        shutil.copy(os.path.join(dom0, TRAIN_CLASSES[0], "0.jpg"), os.path.join(dom0, TRAIN_CLASSES[0], "dup.jpg"))
        samples0 = ImageFolderIndex.scan(dom0).samples
        n0 = len(samples0)
        shard_dir = os.path.join(tmp, "shards")
        captions = _write_shards(shard_dir)
        kparams = load_openclip_checkpoint(sd, cfg, device=dev)
        tok = get_tokenizer(None, cfg.context_length)
        batches = lambda n, b=EVAL_BATCH: -(-n // b)  # noqa: E731

        def loader(samples, b=EVAL_BATCH):
            return Loader(samples, b, image_size=cfg.image_size, output_dtype="uint8")

        def prompt_model(c):
            m = FullModel(TRAIN_CLASSES, kparams, c)
            apply_prompt_checkpoint(m, ckpt)
            return m

        # 2. featurize: the domain (uint8 transport), the shard dir with --embed-text.
        feats = os.path.join(tmp, "feats")
        counted("featurize", _eval_counts(image=batches(n0)), featurize.main,
                ["--image-root", dom0, "--out", feats, "--pretrained", sd, "--batch-size", str(EVAL_BATCH),
                 *model_args])
        got = np.load(os.path.join(feats, "image_embeddings.npy")).astype(np.float32)
        want = featurize.featurize_images(kparams, plain_cfg, iter(loader(samples0))).astype(np.float32)
        emb_err = float(np.abs(got - want).max())
        require(got.shape == (n0, cfg.embed_dim) and emb_err <= EMB_TOL, f"featurize: {got.shape}, err {emb_err:.3e}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        featurize.featurize_images(kparams, cfg, iter(loader(samples0)))
        featurize_ips = n0 / (time.perf_counter() - t0)
        shard_feats = os.path.join(tmp, "shard_feats")
        counted("featurize shards", _eval_counts(image=batches(EVAL_CAPTIONS), text_batch=batches(EVAL_CAPTIONS)),
                featurize.main, ["--shard-dir", shard_dir, "--embed-text", "--out", shard_feats, "--pretrained", sd,
                                 "--batch-size", str(EVAL_BATCH), *model_args])
        with open(os.path.join(shard_feats, "manifest.csv")) as f:
            require([r.split(",", 1)[1] for r in f.read().splitlines()[1:]] == captions, "shard manifest captions")
        got = np.load(os.path.join(shard_feats, "text_embeddings.npy")).astype(np.float32)
        want = featurize.featurize_texts(kparams, plain_cfg, captions, tok.tokenize, EVAL_BATCH).astype(np.float32)
        text_err = float(np.abs(got - want).max())
        require(got.shape == (EVAL_CAPTIONS, cfg.embed_dim) and text_err <= EMB_TOL, f"text rows err {text_err:.3e}")
        print(f"eval: featurize {n0} JPEGs in {seconds['featurize']:.2f} s (main: state dict load, PIL decode, "
              f"batch {EVAL_BATCH}), featurize_images alone {featurize_ips:.1f} images/s decode included; rows vs the "
              f"plain path max abs err {emb_err:.2e} (tol {EMB_TOL}); shards {EVAL_CAPTIONS} images + captions in "
              f"{seconds['featurize shards']:.2f} s, text rows err {text_err:.2e}; launches {launches['featurize']}, "
              f"{launches['featurize shards']} ({card})", flush=True)

        # 3. search: by row, by text (the text tower: one batch), --dedup.
        index = search.SearchIndex.load(feats, device=dev)
        # Random weights map these images to nearly one direction (cosines
        # within a bf16 step of 1), so the row's own score must reach the top
        # score within that step; it is not always ranked first.
        by_row = _quiet(search.main, ["--index", feats, "--row", "5", "-k", str(n0), "--device", dev])
        own = [r["score"] for r in by_row if r["row"] == 5]
        require(own and by_row[0]["score"] - own[0] <= 2 ** -8, f"--row 5: {by_row[:3]}, own score {own}")
        text = "a photo of a Backpack"
        by_text = counted("search --text", _eval_counts(text_batch=1), _quiet, search.main,
                          ["--index", feats, "--text", text, "-k", "5", "--pretrained", sd, *model_args])
        q = featurize.make_text_embed_fn(plain_cfg)(kparams, tok.tokenize([text])).cpu().numpy()
        scores, rows = index.search(q, k=5)
        ref = (index._index[torch.as_tensor(rows[0], device=dev)].double()
               @ torch.as_tensor(q, device=dev).to(torch.bfloat16).double().T)[:, 0].cpu().numpy()
        score_err = float(np.abs(scores[0] - ref).max())
        require(score_err <= SEARCH_TOL, f"search scores vs float64: {score_err:.3e}")
        require(np.abs(np.array([r["score"] for r in by_text]) - scores[0]).max() <= 1e-4
                and (by_text[0]["row"] == rows[0][0] or scores[0][0] - scores[0][1] <= 1e-4),
                f"search --text vs the plain tower: {by_text}")
        pairs = search.main(["--index", feats, "--dedup", "0.99", "--device", dev])
        manifest = [m[1] for m in index.manifest]
        orig = manifest.index(os.path.join(dom0, TRAIN_CLASSES[0], "0.jpg"))
        dup = manifest.index(os.path.join(dom0, TRAIN_CLASSES[0], "dup.jpg"))
        found = [p for p in pairs if (p["row_a"], p["row_b"]) == (min(orig, dup), max(orig, dup))]
        require(len(found) == 1 and found[0]["score"] >= 0.99, f"--dedup missed the duplicated file ({len(pairs)})")
        print(f"eval: search --row 5: own score {own[0]}, top-1 row {by_row[0]['row']} at {by_row[0]['score']}; --text top-5 rows {rows[0].tolist()} scores vs float64 of the bf16 "
              f"operands max abs err {score_err:.2e} (tol {SEARCH_TOL}); --dedup 0.99: {len(pairs)} pairs, the "
              f"duplicated file at {found[0]['score']} ({card})", flush=True)

        # 4. predict, float and --int8 (top-k = every class), against the plain paths.
        paths = predict.list_images(dom0)
        pred_args = ["--image-root", dom0, "--pretrained", sd, "--ckpt", ckpt, "--classes", *TRAIN_CLASSES,
                     "--batch-size", str(EVAL_BATCH), "--top-k", str(len(TRAIN_CLASSES)), "--json", *model_args]
        plain_model = prompt_model(plain_cfg)
        out = {}
        for label, extra, want_counts, ref_cfg, tol in (
                ("predict", [], _eval_counts(text_pass=1, image=batches(n0)), plain_cfg, PROB_TOL),
                ("predict --int8", ["--int8"], _eval_counts(text_pass=1, int8=batches(n0)),
                 plain_cfg.replace(quantize_tower=True), INT8_SERVE_TOL["float32"]["probs"])):
            res = counted(label, want_counts, predict.main, pred_args + extra + ["--out", os.path.join(tmp, label)])
            got = json.load(open(res["json"]))["predictions"]
            with plain_int8():
                want, _ = predict.predict_corpus(prompt_model(ref_cfg), paths, batch_size=EVAL_BATCH,
                                                 top_k=len(TRAIN_CLASSES))
            err, flips = _rows_err(got, want)
            require(res["n"] == n0 and [r["path"] for r in got] == paths, f"{label}: {res['n']} rows")
            require(err <= tol and not flips, f"{label}: probabilities err {err:.3e} (tol {tol}), top-1 {flips}")
            out[label] = err
        model_k = prompt_model(cfg)
        t0 = time.perf_counter()
        predict.predict_corpus(model_k, paths, batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        predict_ips = n0 / (time.perf_counter() - t0)
        traced = _busy_share(lambda: predict.predict_corpus(model_k, paths, batch_size=EVAL_BATCH))
        print(f"eval: predict {n0} JPEGs in {seconds['predict']:.2f} s (main), predict_corpus alone "
              f"{predict_ips:.1f} images/s decode included; one traced predict_corpus pass {traced['span_ms']:.1f} ms, "
              f"device busy {traced['busy_share']:.3f} / idle {traced['idle_share']:.3f} ({traced['device_ops']} "
              f"device ops); probabilities vs the plain path max abs err {out['predict']:.2e} (tol {PROB_TOL}), "
              f"--int8 vs the plain int8 versions {out['predict --int8']:.2e} (tol "
              f"{INT8_SERVE_TOL['float32']['probs']}); launches {launches['predict']}, {launches['predict --int8']} "
              f"({card})", flush=True)

        # 5. Saliency: the plain forward's features equal the kernel path's;
        # /explain with "saliency" over HTTP equals patch_saliency.
        x = next(iter(loader(samples0[:8], 8)))[0]
        with torch.inference_mode():
            sal_feats, probs = vision_attention_forward(kparams, cfg, x)
            kern_feats = clip_model.encode_image(kparams, cfg, torch.from_numpy(x).to(dev))
        sal = compare("saliency forward's features vs encode_image on the kernels", sal_feats, kern_feats, F32_TOL)
        require(float((probs.sum(-1) - 1).abs().max()) <= 1e-5, "saliency probabilities are not row-stochastic")
        grids = {m: patch_saliency(kparams, cfg, x, method=m) for m in ("rollout", "last")}
        g = cfg.image_size // cfg.patch_size
        for m, grid in grids.items():
            require(grid.shape == (8, g, g) and np.isfinite(grid).all() and grid.min() == 0.0 and grid.max() == 1.0,
                    f"patch_saliency {m}: {grid.shape}")
        service = PredictService(model_k, batch_size=8, max_latency_ms=5.0)
        server = make_http_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            explained = {}
            for m in ("rollout", "last"):
                explained[m] = counted(f"/explain {m}", _eval_counts(text_pass=1, image=1), _post, base + "/explain",
                                       {"pixels": x[0].tolist(), "saliency": m})
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=10)
        # /explain runs one image: held against patch_saliency of the same one-image batch.
        grid_err = max(float(np.abs(np.asarray(explained[m]["saliency"])
                                    - patch_saliency(kparams, cfg, x[:1], method=m)[0]).max()) for m in grids)
        with torch.inference_mode():
            want = _plain_probs(plain_model(x[:1])["logits"].float().cpu().numpy())[0]
        prob_err = float(np.abs(_probs_of([explained["rollout"]], TRAIN_CLASSES)[0] - want).max())
        require(grid_err <= 1e-6 and prob_err <= PROB_TOL, f"/explain: grid err {grid_err:.2e}, probs {prob_err:.2e}")
        print(f"eval: saliency forward's features vs encode_image on the kernels max abs err {sal['max_abs_err']:.2e} "
              f"(tol {F32_TOL}); /explain with saliency (rollout, last) over HTTP: grids vs patch_saliency "
              f"{grid_err:.1e}, probabilities vs the plain model {prob_err:.2e}; launches "
              f"{launches['/explain rollout']} ({card})", flush=True)

        # 6. zero_shot_eval over two domains, against the plain tower.
        zargs = ["--preset", "reference_train", "--dtype", "float32", "--pretrained", sd, "--classes",
                 *TRAIN_CLASSES, "--domain-root", tree, "--domains", *EVAL_DOMAINS, *model_args]
        args, zcfg = zero_shot_eval.parse(zargs + ["--output-root", os.path.join(tmp, "zs")])
        n_val = [len(few_shot_split(ImageFolderIndex.scan(os.path.join(tree, d)), TRAIN_CLASSES, 0).val)
                 for d in EVAL_DOMAINS]
        zs = counted("zero_shot_eval", _eval_counts(text_batch=1, image=sum(batches(n, EVAL_CACHE_BATCH)
                                                                           for n in n_val)),
                     zero_shot_eval.run, args, zcfg)
        args, _ = zero_shot_eval.parse(zargs + ["--output-root", os.path.join(tmp, "zs_plain")])
        zs_plain = zero_shot_eval.run(args, dataclasses.replace(zcfg, model=plain_cfg))
        for r, p, n in zip(zs["results"], zs_plain["results"], n_val):
            require(abs(r["Accuracy"] - p["Accuracy"]) <= 100.0 / n + 1e-9, f"zero_shot_eval {r} vs plain {p}")
        print("eval: zero_shot_eval " + ", ".join(f"{r['Domain']} {r['Accuracy']:.2f} (plain {p['Accuracy']:.2f})"
                                                   for r, p in zip(zs["results"], zs_plain["results"]))
              + f" in {seconds['zero_shot_eval']:.2f} s; launches {launches['zero_shot_eval']} ({card})", flush=True)

        # 7. evaluate_adaptive (the int8 pruned tower as the cheap path) on the
        # second domain: margin inf rescues every image, -inf none.
        val1 = few_shot_split(ImageFolderIndex.scan(os.path.join(tree, EVAL_DOMAINS[1])), TRAIN_CLASSES, 0).val
        cheap = cfg.replace(token_keep_ratio=0.5, quantize_tower=True)
        nb = batches(len(val1))
        acc_inf, st_inf = counted("evaluate_adaptive inf", _eval_counts(text_pass=2 * nb, image=nb, int8=nb),
                                  lambda: evaluate_adaptive(model_k, loader(val1), margin=np.inf, cheap_cfg=cheap))
        acc_cheap, st_cheap = counted("evaluate_adaptive -inf", _eval_counts(text_pass=nb, int8=nb),
                                      lambda: evaluate_adaptive(model_k, loader(val1), margin=-np.inf,
                                                                cheap_cfg=cheap))
        acc_full, _ = evaluate_adaptive(plain_model, loader(val1), margin=-np.inf, cheap_cfg=plain_cfg)
        require(st_inf["rescued"] == len(val1) and st_cheap["rescued"] == 0, f"rescues {st_inf} {st_cheap}")
        require(abs(acc_inf - acc_full) <= 100.0 / len(val1) + 1e-9, f"adaptive at inf {acc_inf} vs plain {acc_full}")
        print(f"eval: evaluate_adaptive over {len(val1)} images: margin inf {acc_inf:.2f} ({st_inf}) vs the plain "
              f"full tower {acc_full:.2f}; margin -inf (int8 pruned) {acc_cheap:.2f} ({st_cheap}) ({card})", flush=True)

        # 8. robustness: clean + gaussian_noise + pixelate at severities 1 and 5.
        rargs = robustness.parse(["--val-root", dom0, "--pretrained", sd, "--ckpt", ckpt, "--corruptions",
                                  "gaussian_noise", "pixelate", "--severities", "1", "5", "--batch-size", "64",
                                  "--model", FILES_MODEL, "--device", dev])
        rob = counted("robustness", _eval_counts(text_pass=1, image=5 * batches(n0, 64)), robustness.run, rargs)
        index0 = ImageFolderIndex.scan(dom0)
        plain_rob = FullModel(index0.classes, kparams, plain_cfg)
        apply_prompt_checkpoint(plain_rob, ckpt)
        rows_plain = robustness.evaluate_robustness(plain_rob, index0.samples, corruptions=("gaussian_noise", "pixelate"),
                                                    severities=(1, 5), batch_size=64, verbose=False)
        for r, p in zip(rob["rows"], rows_plain):
            require((r["Corruption"], r["Severity"]) == (p["Corruption"], p["Severity"])
                    and abs(r["Accuracy"] - p["Accuracy"]) <= 100.0 / n0 + 0.01, f"robustness {r} vs plain {p}")
        print("eval: robustness " + ", ".join(f"{r['Corruption']}/{r['Severity']} {r['Accuracy']:.2f} "
                                               f"(plain {p['Accuracy']:.2f})" for r, p in zip(rob["rows"], rows_plain))
              + f" in {seconds['robustness']:.2f} s; launches {launches['robustness']} ({card})", flush=True)

        # 9. sweep: two cells (lr), 4 shots, 2 epochs; one feature cache.
        split = few_shot_split(index0, TRAIN_CLASSES, FILES_SHOTS)
        steps = batches(len(split.train))
        epoch = dict(text_pass=steps + 1 + batches(len(split.val), FILES_EVAL_BATCH), steps=steps)
        want_counts = _eval_counts(image=batches(len(split.train), EVAL_CACHE_BATCH)
                                   + batches(len(split.val), EVAL_CACHE_BATCH),
                                   **{k: 2 * FILES_EPOCHS * v for k, v in epoch.items()})
        swept = counted("sweep", want_counts, sweep.main,
                        ["--data-root", dom0, "--classes", *TRAIN_CLASSES, "--out", os.path.join(tmp, "sweep"),
                         "--pretrained", sd, "--lrs", "2e-3", "5e-3", "--shots", str(FILES_SHOTS), "--epochs",
                         str(FILES_EPOCHS), *model_args])
        with open(swept["csv"]) as f:
            cells = list(csv.DictReader(f))
        plain_cells = sweep.run_sweep(kparams, plain_cfg, data_root=dom0, class_names=TRAIN_CLASSES,
                                      base_prompt_cfg=zcfg.prompt, base_train_cfg=zcfg.train, tokenizer=tok,
                                      lrs=(2e-3, 5e-3), shots=(FILES_SHOTS,), epochs=FILES_EPOCHS)
        for c, p in zip(cells, plain_cells):
            require(int(c["epochs_run"]) == p["epochs_run"] == FILES_EPOCHS
                    and abs(float(c["best_acc"]) - p["best_acc"]) <= 100.0 / len(split.val) + 1e-3,
                    f"sweep cell {c} vs plain {p}")
        print("eval: sweep " + ", ".join(f"lr {c['lr']} best {float(c['best_acc']):.2f} (plain {p['best_acc']:.2f})"
                                          for c, p in zip(cells, plain_cells))
              + f" in {seconds['sweep']:.2f} s; launches {launches['sweep']} ({card})", flush=True)

        # 10. Retrieval at scale: a 1,000,000 x 512 bf16 index made on the card.
        gen = torch.Generator(device=dev).manual_seed(5)
        emb = torch.randn(SEARCH_ROWS, cfg.embed_dim, generator=gen, device=dev)
        emb /= emb.norm(dim=-1, keepdim=True)
        big = search.SearchIndex(emb, [()] * SEARCH_ROWS, device=dev)
        del emb
        index_gb, index_bound = nbytes(big._index) / 1e9, 1e3 * nbytes(big._index) / HBM_BYTES_PER_S
        timings = {}
        for n_q in SEARCH_QUERIES:
            picked = np.random.default_rng(n_q).choice(SEARCH_ROWS, n_q, replace=False)
            q = big._index[torch.as_tensor(picked, device=dev)].float().cpu().numpy()
            s, r = big.search(q, k=10)
            require((r[:, 0] == picked).all(), f"Q={n_q}: a row is not its own top-1")
            ref = torch.einsum("qkd,qd->qk", big._index[torch.as_tensor(r, device=dev)].double(),
                               torch.as_tensor(q, device=dev).double()).cpu().numpy()
            qt = torch.as_tensor(q, device=dev).to(torch.bfloat16)
            timings[n_q] = {
                "search_ms": time_ms(lambda: big.search(q, k=10), iters=10, warmup=2),
                "device_ms": time_ms(lambda: torch.topk(big._scores(qt), 10, dim=-1), iters=10, warmup=2),
                "max_abs_err": float(np.abs(s - ref).max()),
            }
            require(timings[n_q]["max_abs_err"] <= SEARCH_TOL, f"Q={n_q} scores: {timings[n_q]['max_abs_err']:.2e}")
        dedup_index = big._index[:DEDUP_ROWS].clone()
        dedup_index[-1] = dedup_index[7]
        small = search.SearchIndex(dedup_index, [()] * DEDUP_ROWS, device=dev)
        del big
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dupes = small.find_duplicates(0.96)
        dedup_ms = 1e3 * (time.perf_counter() - t0)
        require([(i, j) for i, j, _ in dupes] == [(7, DEDUP_ROWS - 1)] and dupes[0][2] >= 0.99,
                f"find_duplicates over {DEDUP_ROWS} rows: {dupes[:5]}")
        print(f"eval: SearchIndex {SEARCH_ROWS:,} x {cfg.embed_dim} bf16 ({index_gb:.2f} GB): " + "; ".join(f"Q={n} search {t['search_ms']:.3f} ms (host round trip), product + top-10 on the "
                                   f"card {t['device_ms']:.3f} ms, bound {index_bound:.3f} ms (the index's bytes), "
                                   f"scores err {t['max_abs_err']:.1e}" for n, t in timings.items())
              + f"; find_duplicates over {DEDUP_ROWS:,} rows (chunks of 1024) {dedup_ms:.1f} ms, the planted pair "
              f"at {dupes[0][2]:.4f} ({card})", flush=True)
        total = {name: sum(c[name] for c in launches.values()) for name in EVAL_KERNELS}
        return {"launches": total, "by_driver": launches, "featurize_images_per_s": featurize_ips,
                "predict_images_per_s": predict_ips, "busy_share": traced["busy_share"], "search": timings,
                "search_bound_ms": index_bound, "dedup_ms": dedup_ms}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


ADAPT_MODEL = "ViT-B-16"
ADAPT_DEVICE = "cuda"
ADAPT_IMAGES = 8  # per class: 4 shots train, 4 held out
ADAPT_SHOTS = 4
ADAPT_EPOCHS = 2
ADAPT_BATCH = 32
ADAPT_STEPS = 5  # steps per anchored variant and per MaPLe check; the first is not timed
MAPLE_DEPTH, MAPLE_PROMPT_LEN = 3, 2
TPT_VIEWS, TPT_BATCH = 8, 16
ADAPT_TEMPLATES = ("a photo of a {}", "a drawing of a {}", "a painting of a {}")
# Per anchored step on cached features: one text pass pair, and ProGrad's
# second pullback runs the text tower's backward again.
ANCHORED = {"ce": {}, "kg": {"kg_lambda": 0.5}, "scl": {"scl_lambda": 1.0}, "prograd": {"prograd_lambda": 1.0}}
ADAPT_KERNELS = FORWARD + BACKWARD + ("fused_mha", "fused_mha_bwd")
# MaPLe's step differentiates the image tower into 1.18M projection
# entries (proj_w [3, 512, 768]) under AdamW, which moves an entry by about
# lr whatever its gradient's size: an entry whose gradient is near 0 moves
# another way on each path, so the displacement is held at 1e-3 (readings
# 1.085e-4 after 3 steps and 8.9e-5 after 5 on an H100 80GB HBM3 at 700 W,
# where the text-only step reads 1e-5).  The loss of every step and the
# gradient norm of the first (both paths from equal parameters) are held at
# TRAIN_TOL's; a later step's gradient norm is taken where AdamW has already
# moved the two paths apart (2.1e-5 at step 5) and is printed.
MAPLE_STEP_TOL = 1e-3


def _adapt_counts(text_pass: int = 0, image: int = 0, text_batch: int = 0, steps: int = 0) -> dict:
    want = {name: 0 for name in ADAPT_KERNELS}
    for table, n in ((TEXT_PASS, text_pass), (IMAGE_BATCH, image), (TEXT_BATCH, text_batch), (STEP_BWD, steps)):
        for name, k in table.items():
            want[name] += k * n
    return want


def _flat(tree) -> np.ndarray:
    """A copy of every leaf of a nested dict of tensors, flattened in
    sorted-key order (the optimizer updates the leaves in place)."""
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    return np.array(tree.detach().float().cpu().numpy().reshape(-1), copy=True)


def _anchored_steps(kparams, cfg, plain_cfg, card: str) -> dict:
    """CE-only, kg, scl and ProGrad cached-feature steps at batch 32 on the
    kernels and on the plain path: loss, ctx displacement and
    prograd_conflict per step, launches per step, ms per step."""
    from tapclip_tpu_torch.config import TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step

    rng = np.random.default_rng(7)
    anchor = rng.standard_normal((8, cfg.embed_dim)).astype(np.float32)
    anchor /= np.linalg.norm(anchor, axis=-1, keepdims=True)
    batches = []
    for _ in range(ADAPT_STEPS):  # each image near the anchor row of the class after its label
        y = rng.integers(0, len(TRAIN_CLASSES), ADAPT_BATCH)
        x = 3.0 * anchor[(y + 1) % len(TRAIN_CLASSES)] + 0.5 * rng.standard_normal((ADAPT_BATCH, cfg.embed_dim))
        batches.append((x.astype(np.float32), y))
    mask = np.ones(ADAPT_BATCH, bool)
    tol = TRAIN_TOL["float32"]
    out = {}
    for name, terms in ANCHORED.items():
        runs = {}
        for path, c in (("kernel", cfg), ("plain", plain_cfg)):
            model = FullModel(TRAIN_CLASSES, kparams, c)
            kw = dict(terms, kg_feats=anchor, anchor_scale=float(model.trainable["logit_scale"])) if terms else {}
            step = make_train_step(c, model.prompt_cfg, **kw)
            state = init_train_state(model.trainable, make_optimizer(TrainConfig(lr=2e-3)))
            ctx0 = _flat(state.params["ctx"])
            rec = {"loss": [], "conflict": [], "ms": []}
            reset_counts()
            for x, y in batches:
                (state, m), ms = _sync_ms(lambda: step(kparams, state, model.prompt_learner.bank, x, y, mask))
                rec["loss"].append(float(m["loss"]))
                rec["conflict"].append(float(m.get("prograd_conflict", 0.0)))
                rec["ms"].append(ms)
            rec["launches"] = read_counts()
            rec["ctx0"], rec["ctx"] = ctx0, _flat(state.params["ctx"])
            runs[path] = rec
        k, p = runs["kernel"], runs["plain"]
        pulls = 2 if "prograd_lambda" in terms else 1
        _expect(f"adapt {name} steps", k["launches"],
                _adapt_counts(text_pass=ADAPT_STEPS, steps=pulls * ADAPT_STEPS))
        require(all(n == 0 for n in p["launches"].values()), f"adapt {name}: the plain path launched kernels")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"]))
        step_err = _step_err(k["ctx"], k["ctx0"], p["ctx"], p["ctx0"])
        require(np.isfinite(k["loss"]).all() and loss_err <= tol["loss"] and step_err <= tol["ctx_step"],
                f"adapt {name}: loss rel err {loss_err:.3e}, ctx displacement err {step_err:.3e}")
        require(k["conflict"] == p["conflict"], f"adapt {name}: prograd_conflict {k['conflict']} vs {p['conflict']}")
        out[name] = {"ms": float(np.median(k["ms"][1:])), "plain_ms": float(np.median(p["ms"][1:])),
                     "loss_err": loss_err, "ctx_step_err": step_err, "conflict": k["conflict"],
                     "launches_per_step": {n: k["launches"][n] // ADAPT_STEPS for n in BACKWARD}}
    require(1.0 in out["prograd"]["conflict"], f"ProGrad's projection never engaged: {out['prograd']['conflict']}")
    print("adapt: cached-feature steps at batch 32 (ViT-B/16 f32 text tower, 5 classes at capacity 8), median ms "
          f"per step of the last {ADAPT_STEPS - 1} of {ADAPT_STEPS} on the host clock, kernel vs plain: "
          + "; ".join(f"{n} {r['ms']:.2f} vs {r['plain_ms']:.2f} (B4/B5 per step {r['launches_per_step']}, loss rel "
                      f"err {r['loss_err']:.1e}, ctx displacement err {r['ctx_step_err']:.1e})" for n, r in out.items())
          + f"; ProGrad conflicts {out['prograd']['conflict']} on both paths (tol loss {tol['loss']}, ctx "
          f"{tol['ctx_step']}) ({card})", flush=True)
    return out


def _maple_steps(kparams, cfg, plain_cfg, card: str) -> dict:
    """MaPLe steps (J 3, P 2) on raw uint8 images at batch 8, kernels vs
    plain: every leaf's displacement, launches per step (the image tower's
    12 B4 + 12 B5 at T 197 + 2 -> 200 beside the text tower's)."""
    import functools

    import torch

    from tapclip_tpu_torch.config import PromptConfig
    from tapclip_tpu_torch.maple import MAPLE_KEYS, make_maple_train_step
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.ops.fused_mha import _tile_fits
    from tapclip_tpu_torch.parallel.train_step import init_train_state

    rng = np.random.default_rng(8)
    batches = [(rng.integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8),
                rng.integers(0, len(TRAIN_CLASSES), 8)) for _ in range(ADAPT_STEPS)]
    mask = np.ones(8, bool)
    pcfg = PromptConfig(maple_depth=MAPLE_DEPTH, prompt_len=MAPLE_PROMPT_LEN)
    opt = functools.partial(torch.optim.AdamW, lr=2e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    runs = {}
    for path, c in (("kernel", cfg), ("plain", plain_cfg)):
        model = FullModel(TRAIN_CLASSES, kparams, c, prompt_cfg=pcfg, generator=torch.Generator().manual_seed(0))
        state = init_train_state(model.trainable, opt, MAPLE_KEYS)
        step = make_maple_train_step(c, pcfg)
        p0 = _flat({k: state.params[k] for k in MAPLE_KEYS})
        rec = {"loss": [], "grad_norm": [], "ms": []}
        reset_counts()
        for x, y in batches:
            (state, m), ms = _sync_ms(lambda: step(kparams, state, model.prompt_learner.bank, x, y, mask))
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["ms"].append(ms)
        rec["launches"] = read_counts()
        rec["p0"], rec["p"] = p0, _flat({k: state.params[k] for k in MAPLE_KEYS})
        runs[path] = rec
    k, p = runs["kernel"], runs["plain"]
    T = cfg.vision_seq_len + MAPLE_PROMPT_LEN
    Tp = (T + 7) // 8 * 8
    route = "B4's kernels" if _tile_fits(Tp, cfg.vision_width // cfg.vision_heads) else "the split composition (B7)"
    want = _adapt_counts(text_pass=ADAPT_STEPS, image=ADAPT_STEPS, steps=2 * ADAPT_STEPS)  # text + image backward
    _expect("adapt MaPLe steps", k["launches"], want)
    require(all(n == 0 for n in p["launches"].values()), "adapt MaPLe: the plain path launched kernels")
    tol = TRAIN_TOL["float32"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"]))
    norm_errs = [abs(a - b) / abs(b) for a, b in zip(k["grad_norm"], p["grad_norm"])]
    step_err = _step_err(k["p"], k["p0"], p["p"], p["p0"])
    require(np.isfinite(k["loss"]).all() and loss_err <= tol["loss"] and norm_errs[0] <= tol["grad_norm"]
            and step_err <= MAPLE_STEP_TOL, f"adapt MaPLe: loss rel err {loss_err:.3e}, first grad norm rel err "
            f"{norm_errs[0]:.3e}, prompt displacement err {step_err:.3e}")
    out = {"ms": float(np.median(k["ms"][1:])), "plain_ms": float(np.median(p["ms"][1:])), "loss_err": loss_err,
           "grad_norm_errs": norm_errs, "step_err": step_err, "image_T": T, "image_T_padded": Tp, "b4_route": route}
    print(f"adapt: MaPLe step (J {MAPLE_DEPTH}, P {MAPLE_PROMPT_LEN}, batch 8 uint8 images, the image tower at T {T} "
          f"padded to {Tp}: {route}) {out['ms']:.2f} ms vs plain {out['plain_ms']:.2f} ms (median of the last "
          f"{ADAPT_STEPS - 1} of {ADAPT_STEPS}, host clock); launches per step {({n: k['launches'][n] // ADAPT_STEPS for n in ADAPT_KERNELS})}; "
          f"loss rel err {loss_err:.1e}, grad norm rel err {norm_errs[0]:.1e} at step 1 (tol {tol['grad_norm']}), "
          f"{max(norm_errs):.1e} at most over the steps, ctx + maple "
          f"displacement err {step_err:.1e} (tol {MAPLE_STEP_TOL}) ({card})",
          flush=True)
    return out


def _tpt_batch(kparams, cfg, plain_cfg, card: str) -> dict:
    """One TPT batch (16 images x 8 views, 1 step) on the kernels and the
    plain path from the same drawn views: the clean view's logits, the
    baseline logits, both entropies; launches; images/s."""
    import torch

    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.tpt import TPTConfig, make_tpt_predict_fn, make_views

    rng = np.random.default_rng(9)
    images = torch.as_tensor(rng.standard_normal((TPT_BATCH, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
                             device=ADAPT_DEVICE)
    tpt = TPTConfig(n_views=TPT_VIEWS, steps=1)
    views = make_views(torch.Generator().manual_seed(0), images, tpt)
    out = {}
    for path, c in (("kernel", cfg), ("plain", plain_cfg)):
        model = FullModel(TRAIN_CLASSES, kparams, c)
        predict = make_tpt_predict_fn(c, model.prompt_cfg, tpt)
        reset_counts()
        (logits, aux), ms = _sync_ms(lambda: predict(kparams, model.trainable, model.prompt_learner.bank, images,
                                                     views=views))
        out[path] = {"logits": logits.float().cpu().numpy(), "launches": read_counts(), "ms": ms,
                     "base": aux["baseline_logits"].float().cpu().numpy(),
                     "ent": (float(aux["entropy_before"]), float(aux["entropy_after"]))}
        if path == "kernel":
            _, out[path]["ms"] = _sync_ms(lambda: predict(kparams, model.trainable, model.prompt_learner.bank,
                                                          images, torch.Generator().manual_seed(1)))
    k, p = out["kernel"], out["plain"]
    n = len(TRAIN_CLASSES)
    _expect("adapt TPT batch", k["launches"], _adapt_counts(text_pass=2, image=1, steps=1))
    err = max(float(np.abs(k["logits"][:, :n] - p["logits"][:, :n]).max()),
              float(np.abs(k["base"][:, :n] - p["base"][:, :n]).max()))
    ent_err = max(abs(a - b) for a, b in zip(k["ent"], p["ent"]))
    require(np.isfinite(k["logits"][:, :n]).all() and err <= LOGIT_TOL and ent_err <= LOGIT_TOL,
            f"adapt TPT: logits err {err:.3e}, entropy err {ent_err:.3e}")
    ips = TPT_BATCH / (k["ms"] / 1e3)
    print(f"adapt: TPT batch ({TPT_BATCH} images x {TPT_VIEWS} views, 1 Adam step on {TPT_BATCH} x 8 text rows) "
          f"{k['ms']:.1f} ms = {ips:.1f} images/s (views drawn on the host included), plain {p['ms']:.1f} ms; "
          f"launches {({m: k['launches'][m] for m in ADAPT_KERNELS})} (the image tower once over "
          f"{TPT_BATCH * TPT_VIEWS} views); logits err {err:.2e} (tol {LOGIT_TOL}), entropy {k['ent']} vs "
          f"{p['ent']} ({card})", flush=True)
    return {"ms": k["ms"], "images_per_s": ips, "logits_err": err}


def adapt_phase(card: str) -> dict:
    """The few-shot adaptation zoo on the card (ViT-B/16, f32) from files: a
    seeded open_clip state dict and a 5-class JPEG tree; the anchored steps,
    MaPLe's step and a TPT batch held against the plain path with exact
    launch counts; ``fewshot.run`` with all eleven methods against
    ``run_fewshot_benchmark`` on the plain path (accuracies within one
    image); ``train`` with every anchor, with exact launch counts."""
    import os
    import shutil
    import tempfile

    import torch

    from tapclip_tpu_torch import fewshot, train
    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint, save_openclip_checkpoint

    cfg, dev = MODEL_PRESETS[ADAPT_MODEL], ADAPT_DEVICE
    plain_cfg = cfg.replace(attn_impl="xla")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_adapt_")
    try:
        params = clip_model.init_clip_params(torch.Generator(device=dev).manual_seed(6), cfg)
        sd = save_openclip_checkpoint(params, cfg, os.path.join(tmp, "open_clip.bin"))
        del params
        kparams = load_openclip_checkpoint(sd, cfg, device=dev)
        tree = os.path.join(tmp, "tree")
        _write_tree(tree, ["Real World"], TRAIN_CLASSES, ADAPT_IMAGES)
        root = os.path.join(tree, "Real World")

        steps = _anchored_steps(kparams, cfg, plain_cfg, card)
        maple = _maple_steps(kparams, cfg, plain_cfg, card)
        tpt = _tpt_batch(kparams, cfg, plain_cfg, card)

        # fewshot: every method through the CLI's parse + run on the kernels,
        # run_fewshot_benchmark on the plain path; the draws (splits, W0,
        # MaPLe's init, TPT's views) come from the same seeded host
        # generators on both.
        fargs = ["--train-root", root, "--shots", str(ADAPT_SHOTS), "--model", ADAPT_MODEL, "--pretrained", sd,
                 "--batch-size", str(ADAPT_BATCH), "--epochs", str(ADAPT_EPOCHS), "--maple-depth", str(MAPLE_DEPTH),
                 "--maple-prompt-len", str(MAPLE_PROMPT_LEN), "--tpt-views", str(TPT_VIEWS), "--device", dev,
                 "--out", os.path.join(tmp, "fewshot")]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rows = fewshot.run(fewshot.parse(fargs))
        torch.cuda.synchronize()
        fewshot_s = time.perf_counter() - t0
        launches = read_counts()
        t0 = time.perf_counter()
        plain_rows = fewshot.run_fewshot_benchmark(
            root, shots=ADAPT_SHOTS, cfg=plain_cfg, params=kparams, batch_size=ADAPT_BATCH, epochs=ADAPT_EPOCHS,
            maple_depth=MAPLE_DEPTH, maple_prompt_len=MAPLE_PROMPT_LEN, tpt_views=TPT_VIEWS, verbose=False)
        plain_s = time.perf_counter() - t0
        n_val = len(TRAIN_CLASSES) * (ADAPT_IMAGES - ADAPT_SHOTS)
        require([r["Method"] for r in rows] == [r["Method"] for r in plain_rows] == list(fewshot.ALL_METHODS),
                f"fewshot methods {[r['Method'] for r in rows]}")
        for r, q in zip(rows, plain_rows):
            require(0.0 <= r["Accuracy"] <= 100.0 and abs(r["Accuracy"] - q["Accuracy"]) <= 100.0 / n_val + 0.01,
                    f"fewshot {r} vs plain {q}")
        require(open(os.path.join(tmp, "fewshot", "fewshot.csv")).readline().strip()
                == ",".join(fewshot.CSV_COLUMNS), "fewshot.csv header")
        for name in ADAPT_KERNELS[:-1]:  # B7 runs only in idiomatic mode or past B4's limit
            require(launches[name] > 0, f"{name} was not launched by fewshot")
        print(f"adapt: fewshot.run, 11 methods on {len(TRAIN_CLASSES)} classes x {ADAPT_SHOTS} shots "
              f"({n_val} held out), {ADAPT_EPOCHS} epochs, in {fewshot_s:.2f} s (plain path {plain_s:.2f} s): "
              + ", ".join(f"{r['Method']} {r['Accuracy']:.2f} (plain {q['Accuracy']:.2f}, {r['TrainSeconds']:.2f} s)"
                          for r, q in zip(rows, plain_rows))
              + f"; launches {({n: launches[n] for n in ADAPT_KERNELS})} ({card})", flush=True)

        # train with every anchor: exact launches.
        targs, tcfg = train.parse(
            ["--preset", "reference_train", "--model", ADAPT_MODEL, "--dtype", "float32", "--device", dev,
             "--pretrained", sd, "--classes", *TRAIN_CLASSES, "--num-shots", str(ADAPT_SHOTS), "--batch-size", "8",
             "--data-root", root, "--epochs", str(ADAPT_EPOCHS), "--kg-lambda", "0.1", "--prograd-lambda", "1",
             "--scl-lambda", "1", "--anchor-templates", *ADAPT_TEMPLATES, "--output-root", os.path.join(tmp, "train")])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trained = train.run(targs, tcfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got = read_counts()
        n_train = len(TRAIN_CLASSES) * ADAPT_SHOTS
        n_steps = -(-n_train // 8)
        per_epoch = _adapt_counts(text_pass=n_steps + 2, steps=2 * n_steps)  # + entropy, eval; 2 pullbacks
        want = {n: (_adapt_counts(image=2 * n_steps, text_pass=len(ADAPT_TEMPLATES) + 1)[n]
                    + ADAPT_EPOCHS * per_epoch[n]) for n in ADAPT_KERNELS}
        _expect("adapt train with every anchor", got, want)
        res = trained["result"]
        require(np.isfinite(res.loss_history).all() and res.final_state.step == ADAPT_EPOCHS * n_steps,
                f"anchored train: loss {res.loss_history}, {res.final_state.step} steps")
        print(f"adapt: train --kg-lambda 0.1 --prograd-lambda 1 --scl-lambda 1 --anchor-templates x "
              f"{len(ADAPT_TEMPLATES)}: {ADAPT_EPOCHS} epochs of {n_steps} steps in {train_s:.2f} s, loss "
              f"{res.loss_history}, acc {res.acc_history}; launches {({n: got[n] for n in ADAPT_KERNELS})} ({card})",
              flush=True)
        return {"launches": launches, "steps": steps, "maple": maple, "tpt": tpt,
                "train_seconds": {r["Method"]: r["TrainSeconds"] for r in rows}, "fewshot_s": fewshot_s,
                "train_launches": got}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


COCOOP_MODEL, RN_MODEL = "ViT-B-16", "RN50"
COCOOP_DEVICE = "cuda"
COCOOP_BATCH = 32
COCOOP_STEPS = 5  # per variant; the first is not timed
COCOOP_TURNS = 6  # CoCoOp and class-level CE steps timed in turns; the first pair is warm-up
COCOOP_KEYS = ("ctx", "meta_net")
COCOOP_EVAL = 256  # trainer.evaluate_cached's batch: 2,048 text rows at capacity 8
COCOOP_VARIANTS = (("ref_compat", "ce", {}), ("idiomatic", "ce", {}),
                   ("ref_compat", "kg+prograd", {"kg_lambda": 0.5, "prograd_lambda": 1.0}))
B2N_CLASSES = ["Alarm_Clock", "Backpack", "Laptop", "Mug"]  # alphabetical halves
B2N_IMAGES, B2N_SHOTS, B2N_EPOCHS = 8, 4, 2
RN_BATCH = 8
COCOOP_KERNELS = FORWARD + BACKWARD + TEXT
# Per text pass pair of the idiomatic (causal) tower, and per step's pullback.
IDIOMATIC_PASS = {"fused_mlp": 24, "fused_mha": 23, "fused_attention_aux": 1, "fused_attention_aux_causal": 1}
IDIOMATIC_BWD = {"fused_mha_bwd": 12, "fused_mlp_bwd": 12}
# A meta-net that conditions: w1 at 30x its init scale and w2 nonzero, so
# each image shifts the context by its own vector, about 0.1 a dimension
# apart between two random images (the token embeddings' scale is 0.02).
META_W1_GAIN, META_W2_STD = 30.0, 0.05
# The meta-net's displacement after COCOOP_STEPS steps, held apart from
# ctx's (TRAIN_TOL): its output layer starts at 0, so w1's and b1's first
# gradients are exactly 0 and their next ones are made through w2 entries
# that AdamW's first step set to +-lr; AdamW then moves an entry whose
# gradient sits near the f32 noise of its sum over the batch and the classes
# by a different share of lr on each path.  The norm-relative displacement
# read 2.1e-3 (ref_compat CE, H100 80GB HBM3 at 700 W) with no entry apart
# by more than lr, so it is held at COCOOP_META_TOL and the share of entries
# apart by more than lr at COCOOP_FLIP_SHARE; the loss of every step and the
# first gradient norm stay at TRAIN_TOL, ctx's displacement too.
COCOOP_META_TOL = 1e-2
COCOOP_FLIP_SHARE = 1e-3


def _cocoop_counts(mode: str, passes: int = 0, pullbacks: int = 0) -> dict:
    want = {name: 0 for name in COCOOP_KERNELS}
    fwd, bwd = (IDIOMATIC_PASS, IDIOMATIC_BWD) if mode == "idiomatic" else (TEXT_PASS, STEP_BWD)
    for table, n in ((fwd, passes), (bwd, pullbacks)):
        for name, k in table.items():
            want[name] += k * n
    return want


def _conditioned(model, seed: int):
    """``model``'s meta-net set to a seeded one that conditions (see META_W1_GAIN)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    mn = model.trainable["meta_net"]
    E, h = mn["w1"].shape
    dev = mn["w1"].device
    model.trainable = dict(model.trainable, meta_net=dict(
        mn, w1=(torch.randn(E, h, generator=g) * META_W1_GAIN * E ** -0.5).to(dev),
        w2=(torch.randn(tuple(mn["w2"].shape), generator=g) * META_W2_STD).to(dev)))
    return model


def _cocoop_steps(kparams, cfg, plain_cfg, card: str) -> dict:
    """The CoCoOp cached-feature step (batch 32, 5 classes at capacity 8: 256
    text rows) in both text modes and with kg + ProGrad, on the kernels and
    on the plain path: loss, first grad norm, the ctx + meta_net
    displacement, exact launches; then ms per step timed in turns with the
    class-level CE step; then ``evaluate_cached`` at its batch of 256."""
    import torch

    from tapclip_tpu_torch.config import PromptConfig, TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step
    from tapclip_tpu_torch.trainer import CachedSet, evaluate_cached

    rng = np.random.default_rng(10)
    anchor = rng.standard_normal((8, cfg.embed_dim)).astype(np.float32)
    anchor /= np.linalg.norm(anchor, axis=-1, keepdims=True)
    batches = []
    for _ in range(COCOOP_STEPS):
        y = rng.integers(0, len(TRAIN_CLASSES), COCOOP_BATCH)
        x = 3.0 * anchor[(y + 1) % len(TRAIN_CLASSES)] + 0.5 * rng.standard_normal((COCOOP_BATCH, cfg.embed_dim))
        batches.append((x.astype(np.float32), y))
    mask = np.ones(COCOOP_BATCH, bool)
    tol = TRAIN_TOL["float32"]
    out = {}
    launches = {n: 0 for n in COCOOP_KERNELS}

    def setup(c, mode, terms, keys=COCOOP_KEYS, conditioned=True):
        model = FullModel(TRAIN_CLASSES, kparams, c,
                          prompt_cfg=PromptConfig(image_conditioned=conditioned, text_mode=mode))
        kw = dict(terms, kg_feats=anchor, anchor_scale=float(model.trainable["logit_scale"])) if terms else {}
        step = make_train_step(c, model.prompt_cfg, trainable_keys=keys, **kw)
        return model, step, init_train_state(model.trainable, make_optimizer(TrainConfig(lr=2e-3)), keys)

    for mode, name, terms in COCOOP_VARIANTS:
        runs = {}
        for path, c in (("kernel", cfg), ("plain", plain_cfg)):
            model, step, state = setup(c, mode, terms)
            p0 = {k: _flat(state.params[k]) for k in COCOOP_KEYS}
            rec = {"loss": [], "grad_norm": [], "ms": []}
            reset_counts()
            for x, y in batches:
                (state, m), ms = _sync_ms(lambda: step(kparams, state, model.prompt_learner.bank, x, y, mask))
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                rec["ms"].append(ms)
            rec["launches"] = read_counts()
            rec["p0"], rec["p"] = p0, {k: _flat(state.params[k]) for k in COCOOP_KEYS}
            runs[path] = rec
        k, p = runs["kernel"], runs["plain"]
        pulls = 2 if "prograd_lambda" in terms else 1
        _expect(f"cocoop {mode} {name} steps", k["launches"],
                _cocoop_counts(mode, COCOOP_STEPS, pulls * COCOOP_STEPS))
        require(all(n == 0 for n in p["launches"].values()), f"cocoop {mode} {name}: the plain path launched kernels")
        for n in launches:
            launches[n] += k["launches"][n]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"]))
        norm_err = abs(k["grad_norm"][0] - p["grad_norm"][0]) / abs(p["grad_norm"][0])
        ctx_err, meta_err = (_step_err(k["p"][key], k["p0"][key], p["p"][key], p["p0"][key]) for key in COCOOP_KEYS)
        apart = np.abs((k["p"]["meta_net"] - k["p0"]["meta_net"]) - (p["p"]["meta_net"] - p["p0"]["meta_net"]))
        flips = float((apart > 2e-3).mean())  # moved apart by more than lr (2e-3)
        require(np.isfinite(k["loss"]).all() and loss_err <= tol["loss"] and norm_err <= tol["grad_norm"]
                and ctx_err <= tol["ctx_step"] and meta_err <= COCOOP_META_TOL and flips <= COCOOP_FLIP_SHARE,
                f"cocoop {mode} {name}: loss rel err {loss_err:.3e}, first grad norm rel err {norm_err:.3e}, ctx "
                f"displacement err {ctx_err:.3e}, meta_net {meta_err:.3e} with {flips:.2e} of its entries apart")
        out[f"{mode} {name}"] = {"ms": float(np.median(k["ms"][1:])), "plain_ms": float(np.median(p["ms"][1:])),
                                 "loss_err": loss_err, "grad_norm_err": norm_err, "ctx_step_err": ctx_err,
                                 "meta_step_err": meta_err, "meta_entries_apart": flips,
                                 "launches_per_step": {n: k["launches"][n] // COCOOP_STEPS for n in COCOOP_KERNELS
                                                       if k["launches"][n]}}
    print("cocoop: cached-feature steps at batch 32 (5 classes at capacity 8: 256 text rows, ViT-B/16 f32 text "
          f"tower, ctx + meta_net trained), median ms of the last {COCOOP_STEPS - 1} of {COCOOP_STEPS}, kernel vs "
          "plain: " + "; ".join(f"{n} {r['ms']:.2f} vs {r['plain_ms']:.2f} (launches per step {r['launches_per_step']}, "
                                f"loss rel err {r['loss_err']:.1e}, first grad norm {r['grad_norm_err']:.1e}, "
                                f"ctx displacement {r['ctx_step_err']:.1e}, meta_net {r['meta_step_err']:.1e} with "
                                f"{r['meta_entries_apart']:.1e} of its entries apart)" for n, r in out.items())
          + f" (tol loss {tol['loss']}, grad norm {tol['grad_norm']}, ctx displacement {tol['ctx_step']}, meta_net "
          f"{COCOOP_META_TOL}, entries apart {COCOOP_FLIP_SHARE}) ({card})",
          flush=True)

    # ms per step in turns: the CoCoOp CE step, then the class-level CE step.
    timed = {"cocoop": setup(cfg, "ref_compat", {}), "class-level": setup(cfg, "ref_compat", {}, ("ctx",), False)}
    ms = {key: [] for key in timed}
    for i in range(COCOOP_TURNS):
        x, y = batches[i % len(batches)]
        for key, (model, step, state) in timed.items():
            _, t = _sync_ms(lambda: step(kparams, state, model.prompt_learner.bank, x, y, mask))
            ms[key].append(t)
    turns = {key: float(np.median(v[1:])) for key, v in ms.items()}
    print(f"cocoop: ref_compat CE step in turns, median of {COCOOP_TURNS - 1} after one: CoCoOp {turns['cocoop']:.2f} "
          f"ms, class-level {turns['class-level']:.2f} ms ({turns['cocoop'] / turns['class-level']:.1f}x) ({card})",
          flush=True)

    # evaluate_cached at its batch of 256: 2,048 text rows per pass.
    ev = CachedSet(feats=(3.0 * anchor[rng.integers(0, len(TRAIN_CLASSES), COCOOP_EVAL)]
                          + 0.5 * rng.standard_normal((COCOOP_EVAL, cfg.embed_dim))).astype(np.float32),
                   labels=rng.integers(0, len(TRAIN_CLASSES), COCOOP_EVAL).astype(np.int32))
    accs = {}
    for path, c in (("kernel", cfg), ("plain", plain_cfg)):
        model = _conditioned(FullModel(TRAIN_CLASSES, kparams, c, prompt_cfg=PromptConfig(image_conditioned=True)), 3)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (acc, _), s = _sync_ms(lambda: evaluate_cached(model, ev))
        accs[path] = (acc, s, read_counts(), torch.cuda.max_memory_allocated() / 2 ** 30)
    _expect("cocoop evaluate_cached", accs["kernel"][2], _cocoop_counts("ref_compat", 1))
    for n in launches:
        launches[n] += accs["kernel"][2][n]
    require(abs(accs["kernel"][0] - accs["plain"][0]) <= 100.0 / COCOOP_EVAL + 1e-6,
            f"cocoop evaluate_cached: {accs['kernel'][0]} vs plain {accs['plain'][0]}")
    print(f"cocoop: evaluate_cached over {COCOOP_EVAL} features in one batch ({COCOOP_EVAL * 8} text rows a pass): "
          f"{accs['kernel'][1]:.1f} ms, peak {accs['kernel'][3]:.2f} GiB allocated, accuracy {accs['kernel'][0]:.2f} "
          f"(plain {accs['plain'][0]:.2f}, {accs['plain'][1]:.1f} ms, peak {accs['plain'][3]:.2f} GiB) ({card})",
          flush=True)
    return {"steps": out, "turns_ms": turns, "launches": launches,
            "eval": {"ms": accs["kernel"][1], "plain_ms": accs["plain"][1], "peak_gib": accs["kernel"][3]}}


def _cocoop_serve(kparams, cfg, plain_cfg, card: str) -> dict:
    """A CoCoOp model with a conditioning meta-net served over HTTP: 8
    concurrent /predict (one batch), 8 /embed riding a second batch, two
    /explain; probabilities and attribution rows against the plain path;
    exact launches per batch; the per-image attribution rows equal at init
    and apart with the meta-net."""
    import torch

    from tapclip_tpu_torch.config import PromptConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.serve import PredictService, make_http_server

    pcfg = PromptConfig(image_conditioned=True)
    model = _conditioned(FullModel(CLASSES, kparams, cfg, prompt_cfg=pcfg), 4)
    plain = FullModel(CLASSES, kparams, plain_cfg, prompt_cfg=pcfg)
    plain.trainable = model.trainable
    images = np.random.default_rng(11).integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    service = PredictService(model, batch_size=8, max_latency_ms=2000.0)
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_counts()
        answers = _served(base, images)
        torch.cuda.synchronize()
        batch_launches = read_counts()
        with ThreadPoolExecutor(8) as pool:
            embeds = list(pool.map(lambda j: _post(base + "/embed", {"pixels": images[j].tolist()}), range(8)))
        torch.cuda.synchronize()
        served_launches = read_counts()
        embed_launches = {n: v - batch_launches[n] for n, v in served_launches.items()}
        explains = [_post(base + "/explain", {"pixels": images[j].tolist()}) for j in (0, 1)]
        stats = service.stats()
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    require(stats["batches"] == 2 and stats["requests"] == 16, f"cocoop serving: {stats}")
    per_batch = {"fused_mlp": 36, "fused_attn_block": 35, "fused_attention_aux": 1}  # tower + 2 text passes
    _expect("cocoop serving /predict batch", batch_launches, per_batch)
    _expect("cocoop serving /embed batch", embed_launches, {n: v + IMAGE_BATCH.get(n, 0) for n, v in per_batch.items()})
    with torch.inference_mode():
        want = plain(images)
        rows = model(images)["attribution"].float().cpu().numpy()  # [8, C, P] on the kernels, unrounded
        at_init = FullModel(CLASSES, kparams, cfg, prompt_cfg=pcfg)(images)["attribution"].float().cpu().numpy()
    want_probs = _plain_probs(want["logits"].float().cpu().numpy())
    prob_err = float(np.abs(_probs_of(answers, CLASSES) - want_probs).max())
    want_attr = want["attribution"].float().cpu().numpy()
    attr_err = max(float(np.abs(np.array([ex["attribution"][n] for n in CLASSES]) - want_attr[j]).max())
                   for j, ex in zip((0, 1), explains))
    # The conditioning shows in the rows: at init (w2 = 0) every image's rows
    # are the same bits; with the meta-net they part.  They part little:
    # the attribution column T-1 is a padding slot whose key ~70 identical
    # padding keys share, and the rows are a softmax of those probabilities,
    # so they sit at 1/P within about 1e-6 (under the /explain JSON's
    # 6-decimal rounding), and the spread is read on the unrounded rows.
    spread = float(np.abs(rows - rows[:1]).max())
    spread0 = float(np.abs(at_init - at_init[:1]).max())
    feats = _image_features(kparams, plain_cfg, torch.as_tensor(images, device=COCOOP_DEVICE)).cpu().numpy()
    emb_err = float(np.abs(np.array([e["embedding"] for e in embeds]) - feats).max())
    require(prob_err <= PROB_TOL and attr_err <= ATTR_TOL and emb_err <= EMB_TOL,
            f"cocoop serving vs plain: probs {prob_err:.3e}, attribution {attr_err:.3e}, embeddings {emb_err:.3e}")
    require(spread0 == 0.0 and spread > 0.0,
            f"cocoop attribution rows: {spread0:.3e} apart at init, {spread:.3e} with the meta-net")
    print(f"cocoop: served (batch 8, a conditioning meta-net): /predict probs err {prob_err:.2e} (tol {PROB_TOL}), "
          f"/explain rows err {attr_err:.2e} (tol {ATTR_TOL}); the 8 images' attribution rows apart by {spread:.2e} "
          f"(at init {spread0:.1e}); /embed err "
          f"{emb_err:.2e}; launches per /predict batch {per_batch}, per /embed batch one more tower; stats {stats} "
          f"({card})", flush=True)
    return {"prob_err": prob_err, "attr_err": attr_err, "row_spread": spread, "row_spread_at_init": spread0,
            "batch_launches": per_batch,
            "launches": served_launches,
            "mean_batch_ms": stats["mean_batch_ms"]}


def cocoop_rn_phase(card: str) -> dict:
    """CoCoOp end to end, ``base_to_new``, ``CLIPWrapper`` and the RN50
    tower on the card ("cocoop_rn"), from seeded open_clip state dicts
    written by ``save_openclip_checkpoint`` and loaded back; ViT-B/16 f32
    unless RN50."""
    import os
    import shutil
    import tempfile

    import torch

    from tapclip_tpu_torch import base_to_new, predict
    from tapclip_tpu_torch.config import MODEL_PRESETS, PromptConfig
    from tapclip_tpu_torch.featurize import make_image_embed_fn, make_text_embed_fn
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.clip_wrapper import CLIPWrapper
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint, save_openclip_checkpoint

    cfg, dev = MODEL_PRESETS[COCOOP_MODEL], COCOOP_DEVICE
    plain_cfg = cfg.replace(attn_impl="xla")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cocoop_")
    launches = {n: 0 for n in COCOOP_KERNELS}

    def add(counts):
        for n in launches:
            launches[n] += counts.get(n, 0)

    try:
        params = clip_model.init_clip_params(torch.Generator(device=dev).manual_seed(12), cfg)
        sd = save_openclip_checkpoint(params, cfg, os.path.join(tmp, "open_clip.bin"))
        del params
        kparams = load_openclip_checkpoint(sd, cfg, device=dev)

        # Zero-init identity: CoCoOp at init equals the unconditioned model.
        images = np.random.default_rng(13).integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
        with torch.inference_mode():
            base = FullModel(TRAIN_CLASSES, kparams, cfg)(images)["logits"].float().cpu().numpy()
            cond = FullModel(TRAIN_CLASSES, kparams, cfg,
                             prompt_cfg=PromptConfig(image_conditioned=True))(images)["logits"].float().cpu().numpy()
        ident_err = float(np.abs(cond - base).max())
        require(ident_err <= LOGIT_TOL, f"cocoop at init vs the unconditioned model: logits err {ident_err:.3e}")
        print(f"cocoop: at init (w2 = 0) the logits of 8 images equal the unconditioned model's within "
              f"{ident_err:.2e} (tol {LOGIT_TOL}) ({card})", flush=True)

        steps = _cocoop_steps(kparams, cfg, plain_cfg, card)
        add(steps["launches"])
        served = _cocoop_serve(kparams, cfg, plain_cfg, card)
        add(served["launches"])

        # predict_corpus on a CoCoOp model: no attribution, rows as the plain path's.
        tree = os.path.join(tmp, "tree")
        _write_tree(tree, ["Real World"], B2N_CLASSES, B2N_IMAGES)
        root = os.path.join(tree, "Real World")
        paths = predict.list_images(root)
        rows = {}
        for path, c in (("kernel", cfg), ("plain", plain_cfg)):
            model = _conditioned(FullModel(CLASSES, kparams, c, prompt_cfg=PromptConfig(image_conditioned=True)), 4)
            torch.cuda.synchronize()
            reset_counts()
            (rows[path], s) = _sync_ms(lambda: predict.predict_corpus(model, paths, batch_size=EVAL_BATCH,
                                                                     top_k=len(CLASSES)))
            rows[path] += (s, read_counts())
        (krows, kattr, ks, kl), (prows, pattr, _, _) = rows["kernel"], rows["plain"]
        n_batches = -(-len(paths) // EVAL_BATCH)
        want = {n: (IMAGE_BATCH.get(n, 0) + TEXT_PASS.get(n, 0)) * n_batches for n in COCOOP_KERNELS}
        _expect("cocoop predict_corpus", kl, want)
        add(kl)
        err, flips = _rows_err(krows, prows)
        require(kattr is None and pattr is None and len(krows) == len(paths) and err <= PROB_TOL and not flips,
                f"cocoop predict_corpus: attribution {kattr}, {len(krows)} rows, probs err {err:.3e}, flips {flips}")
        print(f"cocoop: predict_corpus over {len(paths)} JPEGs (batch {EVAL_BATCH}) in {ks:.1f} ms, attribution None, "
              f"probs err {err:.2e} (tol {PROB_TOL}) ({card})", flush=True)

        # base_to_new through parse + run against run_base_to_new on the plain path.
        out_dir = os.path.join(tmp, "b2n")
        bargs = base_to_new.parse(["--root", root, "--model", COCOOP_MODEL, "--pretrained", sd, "--shots",
                                   str(B2N_SHOTS), "--epochs", str(B2N_EPOCHS), "--batch-size", str(COCOOP_BATCH),
                                   "--out", out_dir, "--device", dev])
        torch.cuda.synchronize()
        reset_counts()
        b2n, b2n_ms = _sync_ms(lambda: base_to_new.run(bargs))
        add(read_counts())
        plain_b2n = base_to_new.run_base_to_new(root, shots=B2N_SHOTS, cfg=plain_cfg, params=kparams,
                                                batch_size=COCOOP_BATCH, epochs=B2N_EPOCHS, verbose=False)
        half = len(B2N_CLASSES) // 2
        n_base, n_new = half * (B2N_IMAGES - B2N_SHOTS) // 2, half * B2N_IMAGES
        for key, n in (("Base", n_base), ("New", n_new)):
            require(abs(b2n[key] - plain_b2n[key]) <= 100.0 / n + 0.01, f"base_to_new {b2n} vs plain {plain_b2n}")
        require(abs(b2n["H"] - base_to_new.harmonic_mean(b2n["Base"], b2n["New"])) <= 0.01, f"base_to_new H {b2n}")
        require(open(os.path.join(out_dir, "base_to_new.csv")).readline().strip()
                == ",".join(base_to_new.CSV_COLUMNS), "base_to_new.csv header")
        print(f"cocoop: base_to_new ({len(B2N_CLASSES)} classes, {B2N_SHOTS} shots, {B2N_EPOCHS} epochs) in "
              f"{b2n_ms / 1e3:.2f} s: {b2n} (plain path {plain_b2n}) ({card})", flush=True)

        # CLIPWrapper: its encoders are featurize's; transformer_raw's map, column T-1, is K3's aux.
        wrapper = CLIPWrapper(COCOOP_MODEL, pretrained_path=sd, device=dev)
        tok = wrapper.get_tokenizer()
        ids = np.asarray(tok.tokenize([f"a photo of a {c.replace('_', ' ')}" for c in TRAIN_CLASSES],
                                      cfg.context_length))
        text_err = float((clip_model.l2_normalize(wrapper.encode_text(ids)).float()
                          - make_text_embed_fn(cfg)(kparams, ids)).abs().max())
        img_err = float((clip_model.l2_normalize(wrapper.encode_image(images)).float()
                         - make_image_embed_fn(cfg)(kparams, images)).abs().max())
        require(tuple(wrapper.get_attention_map().shape) == (len(TRAIN_CLASSES), 77, 77),
                f"CLIPWrapper map {tuple(wrapper.get_attention_map().shape)}")
        T = 82  # ref_compat: 5 context tokens + 77
        emb = torch.as_tensor(np.random.default_rng(14).standard_normal((8, T, cfg.text_width)).astype(np.float32)
                              * 0.02, device=dev)
        wrapper.transformer_raw(emb)
        with torch.inference_mode():
            reset_counts()
            _, aux = clip_model.text_forward_embeds(kparams, cfg, emb, mode="ref_compat", attn_to_idx=T - 1)
            torch.cuda.synchronize()
            aux_launches = read_counts()
        map_err = float((wrapper.get_attention_map()[:, :, T - 1] - aux.float()).abs().max())
        require(aux_launches["fused_attention_aux"] == 1, f"K3 did not compute the aux: {aux_launches}")
        require(text_err <= 1e-6 and img_err <= 1e-6 and map_err <= ATTR_TOL,
                f"CLIPWrapper: text {text_err:.3e}, image {img_err:.3e}, map column vs K3 aux {map_err:.3e}")
        print(f"cocoop: CLIPWrapper encode_text / encode_image vs featurize's embed functions {text_err:.1e} / "
              f"{img_err:.1e}; transformer_raw's map column T-1 vs K3's aux {map_err:.2e} (tol {ATTR_TOL}) ({card})",
              flush=True)
        del wrapper

        rn = _rn50_phase(tmp, card)
        add(rn["launches"])
        return {"launches": launches, "steps": steps, "served": served, "predict_ms": ks,
                "base_to_new": b2n, "base_to_new_s": b2n_ms / 1e3, "rn50": rn}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rn50_phase(tmp: str, card: str) -> dict:
    """RN50 at full width, 224 px, from a seeded state dict: an 8-image
    batch's logits, the cached-feature step (text W 512, embed 1024) with
    exact launches, /explain with saliency, ms per image batch."""
    import os

    import torch

    from tapclip_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step
    from tapclip_tpu_torch.serve import PredictService
    from tapclip_tpu_torch.utils.torch_convert import load_openclip_checkpoint, save_openclip_checkpoint

    cfg, dev = MODEL_PRESETS[RN_MODEL], COCOOP_DEVICE
    plain_cfg = cfg.replace(attn_impl="xla")
    params = clip_model.init_clip_params(torch.Generator(device=dev).manual_seed(15), cfg)
    sd = save_openclip_checkpoint(params, cfg, os.path.join(tmp, "rn50.bin"))
    del params
    rparams = load_openclip_checkpoint(sd, cfg, device=dev)
    images = np.random.default_rng(16).integers(0, 256, (RN_BATCH, cfg.image_size, cfg.image_size, 3),
                                                dtype=np.uint8)
    model, plain = FullModel(CLASSES, rparams, cfg), FullModel(CLASSES, rparams, plain_cfg)
    with torch.inference_mode():
        reset_counts()
        got = model(images)
        torch.cuda.synchronize()
        batch_launches = read_counts()
        want = plain(images)
    _expect("RN50 image batch", batch_launches, {n: TEXT_PASS.get(n, 0) for n in FORWARD})  # the tower is convolutions
    logit_err = float((got["logits"] - want["logits"]).abs().max())
    require(bool(torch.isfinite(got["logits"]).all()) and logit_err <= LOGIT_TOL, f"RN50 logits err {logit_err:.3e}")

    rng = np.random.default_rng(17)
    batches = [(rng.standard_normal((COCOOP_BATCH, cfg.embed_dim)).astype(np.float32),
                rng.integers(0, len(CLASSES), COCOOP_BATCH)) for _ in range(COCOOP_STEPS)]
    mask = np.ones(COCOOP_BATCH, bool)
    runs = {}
    for path, c in (("kernel", cfg), ("plain", plain_cfg)):
        m = FullModel(CLASSES, rparams, c)
        step = make_train_step(c, m.prompt_cfg)
        state = init_train_state(m.trainable, make_optimizer(TrainConfig(lr=2e-3)))
        ctx0 = _flat(state.params["ctx"])
        rec = {"loss": [], "grad_norm": [], "ms": []}
        reset_counts()
        for x, y in batches:
            (state, met), ms = _sync_ms(lambda: step(rparams, state, m.prompt_learner.bank, x, y, mask))
            rec["loss"].append(float(met["loss"]))
            rec["grad_norm"].append(float(met["grad_norm"]))
            rec["ms"].append(ms)
        rec["launches"], rec["ctx0"], rec["ctx"] = read_counts(), ctx0, _flat(state.params["ctx"])
        runs[path] = rec
    k, p = runs["kernel"], runs["plain"]
    _expect("RN50 cached-feature steps", k["launches"], _cocoop_counts("ref_compat", COCOOP_STEPS, COCOOP_STEPS))
    tol = TRAIN_TOL["float32"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"]))
    norm_err = abs(k["grad_norm"][0] - p["grad_norm"][0]) / abs(p["grad_norm"][0])
    step_err = _step_err(k["ctx"], k["ctx0"], p["ctx"], p["ctx0"])
    require(loss_err <= tol["loss"] and norm_err <= tol["grad_norm"] and step_err <= tol["ctx_step"],
            f"RN50 steps: loss rel err {loss_err:.3e}, grad norm {norm_err:.3e}, ctx displacement {step_err:.3e}")

    explained = {}
    for key, mdl in (("kernel", model), ("plain", plain)):
        svc = PredictService(mdl, batch_size=RN_BATCH)
        try:
            explained[key] = svc.explain(images[0], saliency=True)
        finally:
            svc.close()
    sal = np.asarray(explained["kernel"]["saliency"])
    g = cfg.image_size // 32
    sal_err = float(np.abs(sal - np.asarray(explained["plain"]["saliency"])).max())  # one plain-torch computation
    attr_err = max(abs(a - b) for n in CLASSES for a, b in zip(explained["kernel"]["attribution"][n],
                                                               explained["plain"]["attribution"][n]))
    require(sal.shape == (g, g) and sal.min() == 0.0 and sal.max() == 1.0 and sal_err <= ATTR_TOL and attr_err <= ATTR_TOL,
            f"RN50 /explain: saliency {sal.shape} err {sal_err:.3e}, attribution err {attr_err:.3e}")

    x = torch.as_tensor(images, device=dev)
    with torch.inference_mode():
        batch_ms = time_ms(lambda: clip_model.encode_image(rparams, cfg, x), iters=20, warmup=3)
    ips = RN_BATCH / (batch_ms / 1e3)
    print(f"rn50: 224 px, {RN_BATCH}-image batch logits err {logit_err:.2e} (tol {LOGIT_TOL}), launches {batch_launches} "
          f"(the text passes; the tower is cuDNN convolutions, TF32 off); cached-feature step (text W 512, embed "
          f"{cfg.embed_dim}) {float(np.median(k['ms'][1:])):.2f} ms vs plain {float(np.median(p['ms'][1:])):.2f}, "
          f"loss rel err {loss_err:.1e}, grad norm {norm_err:.1e}, ctx displacement {step_err:.1e}; /explain "
          f"saliency {g}x{g} err {sal_err:.1e} against the plain path's, attribution err {attr_err:.1e}; image tower "
          f"{batch_ms:.3f} ms a batch of {RN_BATCH} (CUDA events) = {ips:.1f} images/s ({card})", flush=True)
    return {"logit_err": logit_err, "step_ms": float(np.median(k["ms"][1:])),
            "plain_step_ms": float(np.median(p["ms"][1:])), "batch_ms": batch_ms, "images_per_s": ips,
            "launches": {n: batch_launches.get(n, 0) + k["launches"][n] for n in k["launches"]}}


def _post_status(url: str, obj: dict) -> tuple:
    """(HTTP status, JSON body) of a POST, error answers included."""
    import urllib.error

    try:
        return 200, _post(url, obj)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# --- "pretrain": CLIP pretraining of both towers (pretrain.py, peft.py, distill.py, pretrain_cli) ---------

PRETRAIN_MODEL = "ViT-B-16"
PRETRAIN_DEVICE = "cuda"
PRETRAIN_BATCH = 32
PRETRAIN_STEPS = 3
PRETRAIN_LR, PRETRAIN_WD = 1e-4, 0.1
PRETRAIN_TURNS = 6  # the pretraining steps and the class-level CE step timed in turns; the first turn is warm-up
PRETRAIN_CLI_IMAGES = 64  # the synthetic ImageFolder of pretrain_cli: 4 classes of 16
PRETRAIN_KERNELS = ("fused_mlp", "fused_attn_block", "fused_mha", "fused_mlp_bwd", "fused_attn_block_bwd",
                    "fused_mha_bwd", "gemm_f32", "col_sum")
# One InfoNCE step at ViT-B/16 with every leaf trained: the image tower's 12
# blocks run K2 + K1 forward and B4 + B5 backward, the text tower's 12 run
# B6 (between torch projections) + K1 forward and B7 + B5 backward; each B4
# and B5 with its weight gradients runs gemm.cu's two dW products and three
# column sums (the LayerNorm's gamma and beta from one, the two biases).
PRETRAIN_STEP = {"fused_mlp": 24, "fused_attn_block": 12, "fused_mha": 12, "fused_mlp_bwd": 24,
                 "fused_attn_block_bwd": 12, "fused_mha_bwd": 12, "gemm_f32": 72, "col_sum": 108}
# Kernel path against the plain path (attn_impl="xla", the same weights and
# draws).  loss / grad_norm: relative errors of the losses and of step 1's
# global gradient norm; grad: the largest norm-relative error of a leaf's
# step-1 gradient; step: the norm-relative error of the parameters'
# displacement after the steps (_step_err).  AdamW turns a gradient entry
# that is rounding noise into a move of up to about lr a step either way
# (the key third of b_qkv always: the loss does not depend on a key bias),
# so the displacement is also held entry by entry within 2 lr a step; the
# share of entries past that must stay under PRETRAIN_APART.
PRETRAIN_TOL = {"float32": {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-3, "step": 2e-2},
                "bfloat16": {"loss": 2e-2, "grad_norm": 0.1, "grad": 0.3, "step": 0.6}}
PRETRAIN_APART = 1e-4


def _pretrain_counts(**scale) -> dict:
    """Launches of ``steps`` InfoNCE steps, with each count's extra terms."""
    steps = scale.pop("steps", 1)
    out = {n: steps * c for n, c in PRETRAIN_STEP.items()}
    for n, extra in scale.items():
        out[n] = extra
    return out


def _pretrain_batch(cfg, n: int, seed: int):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    ids = rng.integers(1, cfg.vocab_size - 2, (n, cfg.context_length)).astype(np.int32)
    ids[:, 0] = cfg.vocab_size - 2
    ids[np.arange(n), rng.integers(4, cfg.context_length, n)] = cfg.vocab_size - 1  # EOT: the largest id
    return images, ids


def _tree_copy(params):
    from tapclip_tpu_torch.pretrain import detached_copy

    return detached_copy(params)


def _grads(params, cfg, images, ids, loss: str = "infonce"):
    """(loss, {path: gradient}) of one batch over every leaf of ``params``."""
    import torch

    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.models import clip as clip_model

    leaves = P.set_trainable(params)
    x = torch.as_tensor(images, device=params["logit_scale"].device)
    total = P.pair_loss(loss, params, clip_model.encode_image(params, cfg, x), clip_model.encode_text(params, cfg, ids))
    gs = torch.autograd.grad(total, [t for _, t in leaves])
    return float(total.detach()), {p: g.float() for (p, _), g in zip(leaves, gs)}


def _grad_errors(k: dict, p: dict) -> tuple:
    """(global-norm rel err, largest per-leaf norm-rel err and its leaf)."""
    import torch

    kn = float(torch.sqrt(sum(g.square().sum() for g in k.values())))
    pn = float(torch.sqrt(sum(g.square().sum() for g in p.values())))
    per = {path: float((k[path] - p[path]).norm() / p[path].norm().clamp_min(1e-30)) for path in p
           if float(p[path].norm()) > 0}
    worst = max(per, key=per.get)
    return abs(kn - pn) / pn, per[worst], worst


def _displacement(k1, k0, p1, p0, lr: float, steps: int) -> tuple:
    """(norm-rel error of the displacement, share of entries apart by more
    than 2 lr a step, largest entry apart) over every leaf.  The norm leaves
    out the key biases (the key third of attn/b_qkv, the RN pool's
    k_proj/b): the loss does not depend on them, so their gradient is
    rounding noise that AdamW scales to about lr a step on either path."""
    import torch

    from tapclip_tpu_torch.pretrain import named_leaves

    num = den = 0.0
    apart, n, worst = 0, 0, 0.0
    for (path, a1), (_, a0), (_, b1), (_, b0) in zip(named_leaves(k1), named_leaves(k0), named_leaves(p1),
                                                     named_leaves(p0)):
        a1, a0, b1, b0 = (t.detach().float() for t in (a1, a0, b1, b0))
        d = ((a1 - a0) - (b1 - b0)).abs()
        ref = (b1 - b0).square()
        apart += int((d > 2 * lr * steps).sum())
        n += d.numel()
        worst = max(worst, float(d.max()))
        if path.endswith("attnpool/k_proj/b"):
            continue
        if path.endswith("attn/b_qkv"):
            W = d.shape[0] // 3
            d, ref = torch.cat([d[:W], d[2 * W:]]), torch.cat([ref[:W], ref[2 * W:]])
        num += float(d.square().sum())
        den += float(ref.sum())
    return (num / den) ** 0.5, apart / n, worst


def _run_steps(cfg, params, batches, *, trainable=None, loss="infonce", accum=0, draws=None, lora=None,
               teacher=None):
    """``len(batches)`` steps of the step the options name, in place on
    ``params`` (or on the adapters ``lora``): (losses, ms per step, launches)."""
    import torch

    from tapclip_tpu_torch import distill, peft
    from tapclip_tpu_torch import pretrain as P

    if lora is not None:
        P.set_trainable(params, {p: False for p, _ in P.named_leaves(params)})
        leaves = P.set_trainable(lora)
    else:
        leaves = P.set_trainable(params, trainable)
    opt = P.PretrainOptimizer(leaves, lr=PRETRAIN_LR, weight_decay=PRETRAIN_WD)
    if lora is not None:
        step = peft.make_lora_pretrain_step(cfg, opt, loss=loss)
    elif teacher is not None:
        step = distill.make_distill_step(cfg, cfg, opt, tau=2.0)
    elif accum:
        step = P.make_accum_pretrain_step(cfg, opt, accum, loss=loss)
    else:
        step = P.make_pretrain_step(cfg, opt, loss=loss)
    losses, ms = [], []
    torch.cuda.synchronize()
    reset_counts()
    for i, (x, ids) in enumerate(batches):
        if lora is not None:
            call = lambda: step(params, lora, x, ids)  # noqa: E731
        elif teacher is not None:
            call = lambda: step(params, teacher, x, ids)  # noqa: E731
        else:
            call = lambda: step(params, x, ids, **(draws[i] if draws else {}))  # noqa: E731
        m, t = _sync_ms(call)
        losses.append(float(m["loss"]))
        ms.append(t)
    return losses, ms, read_counts()


def _pretrain_main_steps(kparams, cfg, card: str) -> dict:
    """Three InfoNCE steps at batch 32 on the kernels and on the plain path
    from one tree: losses, step 1's gradients, the displacement, exact
    launches per step."""
    plain_cfg = cfg.replace(attn_impl="xla")
    tol = PRETRAIN_TOL[cfg.dtype]
    batches = [_pretrain_batch(cfg, PRETRAIN_BATCH, 30 + i) for i in range(PRETRAIN_STEPS)]
    kl, kg = _grads(_tree_copy(kparams), cfg, *batches[0])
    pl, pg = _grads(_tree_copy(kparams), plain_cfg, *batches[0])
    norm_err, leaf_err, leaf = _grad_errors(kg, pg)
    del kg, pg
    runs = {}
    for path, c in (("kernel", cfg), ("plain", plain_cfg)):
        tree = _tree_copy(kparams)
        runs[path] = _run_steps(c, tree, batches) + (tree,)
    (kls, kms, kc, k1), (pls, pms, pc, p1) = runs["kernel"], runs["plain"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip([kl] + kls, [pl] + pls))
    step_err, apart, worst = _displacement(k1, kparams, p1, kparams, PRETRAIN_LR, PRETRAIN_STEPS)
    _expect(f"pretrain {cfg.dtype} steps", kc, _pretrain_counts(steps=PRETRAIN_STEPS))
    require(all(n == 0 for n in pc.values()), f"pretrain {cfg.dtype}: the plain path launched kernels {pc}")
    require(np.isfinite(kls).all() and kls[-1] < kls[0], f"pretrain {cfg.dtype}: losses {kls}")
    print(f"pretrain {cfg.dtype}: {PRETRAIN_STEPS} InfoNCE steps at batch {PRETRAIN_BATCH} (every leaf trained, "
          f"AdamW lr {PRETRAIN_LR}): loss kernel {[round(v, 5) for v in kls]} plain {[round(v, 5) for v in pls]}, rel "
          f"err {loss_err:.2e} (tol {tol['loss']}); step-1 gradients: global norm rel err {norm_err:.2e} (tol "
          f"{tol['grad_norm']}), worst leaf {leaf} norm-rel err {leaf_err:.2e} (tol {tol['grad']}); displacement "
          f"after {PRETRAIN_STEPS} steps norm-rel err {step_err:.2e} (tol {tol['step']}), entries apart by more than "
          f"2 lr a step {apart:.2e} (tol {PRETRAIN_APART}), largest {worst:.2e}; ms per step kernel "
          f"{[round(v, 1) for v in kms]} plain {[round(v, 1) for v in pms]}; launches per step "
          f"{ {n: kc[n] // PRETRAIN_STEPS for n in PRETRAIN_KERNELS} } ({card})", flush=True)
    require(loss_err <= tol["loss"] and norm_err <= tol["grad_norm"] and leaf_err <= tol["grad"]
            and step_err <= tol["step"] and apart <= PRETRAIN_APART,
            f"pretrain {cfg.dtype}: kernel vs plain loss {loss_err:.3e}, grad norm {norm_err:.3e}, leaf {leaf} "
            f"{leaf_err:.3e}, displacement {step_err:.3e}, entries apart {apart:.2e}")
    return {"launches": kc, "errors": {"loss": loss_err, "grad_norm": norm_err, "grad_leaf": leaf_err,
                                       "step": step_err, "apart": apart},
            "ms": kms, "plain_ms": pms}


def _pretrain_options(kparams, cfg, card: str) -> dict:
    """One step per option on the kernels and on the plain path (f32, batch
    32): exact launches, the loss and the trained leaves' displacement
    against the plain path, and each option's own invariant."""
    import torch

    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.peft import init_lora_params

    tol = PRETRAIN_TOL["float32"]
    batch = [_pretrain_batch(cfg, PRETRAIN_BATCH, 40)]
    out, launches = {}, {n: 0 for n in PRETRAIN_KERNELS}

    def both(name, c, want, *, params=None, trainable=None, lora=False, check=None, batches=None, **kw):
        runs = {}
        for path, cc in (("kernel", c), ("plain", c.replace(attn_impl="xla"))):
            tree = _tree_copy(kparams if params is None else params)
            adapters = (init_lora_params(torch.Generator(device=PRETRAIN_DEVICE).manual_seed(3), tree, rank=8)
                        if lora else None)
            trained = adapters if lora else tree
            before, trained0 = _tree_copy(tree), _tree_copy(trained)
            losses, ms, counts = _run_steps(cc, tree, batches or batch, lora=adapters,
                                            trainable=trainable(tree) if trainable else None, **kw)
            runs[path] = {"loss": losses, "ms": ms, "counts": counts, "tree": tree, "before": before,
                          "trained": trained, "trained0": trained0}
        k, p = runs["kernel"], runs["plain"]
        _expect(f"pretrain {name}", k["counts"], want)
        require(all(n == 0 for n in p["counts"].values()), f"pretrain {name}: the plain path launched kernels")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"]))
        step_err, apart, _ = _displacement(k["trained"], k["trained0"], p["trained"], p["trained0"], PRETRAIN_LR,
                                           len(k["loss"]))
        extra = check(runs) if check else {}
        require(np.isfinite(k["loss"]).all() and loss_err <= tol["loss"] and step_err <= tol["step"]
                and apart <= PRETRAIN_APART,
                f"pretrain {name}: loss rel err {loss_err:.3e}, displacement {step_err:.3e}, entries apart {apart:.2e}")
        for n in launches:
            launches[n] += k["counts"].get(n, 0)
        out[name] = {"loss": k["loss"], "loss_err": loss_err, "step_err": step_err, "apart": apart, "ms": k["ms"],
                     "plain_ms": p["ms"], "launches": {n: k["counts"][n] for n in PRETRAIN_KERNELS if k["counts"][n]},
                     **extra}
        print(f"pretrain option {name}: loss {[round(v, 5) for v in k['loss']]} rel err {loss_err:.2e}, displacement "
              f"norm-rel err {step_err:.2e} ({apart:.1e} of its entries apart), ms kernel "
              f"{[round(v, 1) for v in k['ms']]} plain {[round(v, 1) for v in p['ms']]}, launches "
              f"{out[name]['launches']}" + (f", {extra}" if extra else "") + f" ({card})", flush=True)

    def unchanged(frozen_of):
        """The leaves ``frozen_of(tree)`` names are bit-identical after the kernel path's step."""
        def check(runs):
            k = runs["kernel"]
            old, new = dict(P.named_leaves(k["before"])), dict(P.named_leaves(k["tree"]))
            paths = frozen_of(k["before"])
            require(paths and all(torch.equal(old[q], new[q]) for q in paths),
                    f"frozen leaves moved ({len(paths)} checked)")
            return {"frozen_bit_identical": len(paths)}
        return check

    def lock(**kw):
        return lambda tree: P.lock_tower_trainable(tree, **kw)

    both("siglip", cfg, _pretrain_counts(), params=P.add_siglip_params(kparams), loss="siglip")
    # LoRA: every adapted weight wants its gradient (through the merge), no bias or LayerNorm does.
    both("lora r8", cfg, _pretrain_counts(col_sum=0), lora=True,
         check=unchanged(lambda t: [q for q, _ in P.named_leaves(t)]))
    # BitFit: the biases (and LayerNorm betas) want theirs, no weight does: no dW product runs.
    both("bitfit", cfg, _pretrain_counts(gemm_f32=0), trainable=P.bitfit_trainable,
         check=unchanged(lambda t: [q for q, tr in P.bitfit_trainable(t).items() if not tr]))
    both("lock image", cfg, _pretrain_counts(fused_attn_block_bwd=0, fused_mlp_bwd=12, gemm_f32=24, col_sum=36),
         trainable=lock(lock_image=True),
         check=unchanged(lambda t: [q for q, _ in P.named_leaves(t) if q.startswith("visual/")]))
    both("lock image, 2 groups unlocked", cfg,
         _pretrain_counts(fused_attn_block_bwd=1, fused_mlp_bwd=13, gemm_f32=28, col_sum=42),
         trainable=lock(lock_image=True, unlocked_groups=2),
         check=unchanged(lambda t: [q for q, tr in P.lock_tower_trainable(t, lock_image=True,
                                                                          unlocked_groups=2).items() if not tr]))

    def same_as_one_shot(runs):
        """GradCache at K = 2 (two micro-batches of 16) takes the one-shot batch-32 step."""
        tree = _tree_copy(kparams)
        one_loss, _, _ = _run_steps(cfg, tree, batch)
        k = runs["kernel"]
        err = abs(k["loss"][0] - one_loss[0]) / abs(one_loss[0])
        step_err, _, _ = _displacement(k["tree"], k["before"], tree, k["before"], PRETRAIN_LR, 1)
        require(err <= 1e-6 and step_err <= tol["step"],
                f"GradCache vs the one-shot step: loss {err:.3e}, displacement {step_err:.3e}")
        return {"one_shot_loss_err": err, "one_shot_step_err": step_err}

    both("gradcache k2", cfg, _pretrain_counts(fused_mlp=96, fused_attn_block=48, fused_mha=48, fused_mlp_bwd=48,
                                               fused_attn_block_bwd=24, fused_mha_bwd=24, gemm_f32=144, col_sum=216),
         accum=2, check=same_as_one_shot)
    pd = cfg.replace(patch_dropout=0.5)
    idx = clip_model.patch_dropout_indices(torch.Generator(device=PRETRAIN_DEVICE).manual_seed(5), PRETRAIN_BATCH,
                                           pd.grid_size ** 2, 0.5)
    n_keep = round(pd.grid_size ** 2 * 0.5)  # 98 of ViT-B/16's 196: T 99
    require(tuple(idx.shape) == (PRETRAIN_BATCH, n_keep), f"patch dropout keeps {tuple(idx.shape)}")
    both("patch dropout 0.5 (T 99)", pd, _pretrain_counts(), draws=[{"patch_idx": idx}])
    deep = cfg.replace(vpt_tokens=8, vpt_deep=True)
    both("vpt deep 8 (T 205)", deep, _pretrain_counts(), params=clip_model.ensure_vpt_params(kparams, deep, seed=6))
    shallow = cfg.replace(vpt_tokens=16)
    # T 213 pads to 216, past B4's routing limit of 210: the image blocks'
    # attention halves differentiate the split composition (B6 again + B7).
    both("vpt shallow 16 (T 213, split composition)", shallow,
         _pretrain_counts(fused_mha=24, fused_attn_block_bwd=0, fused_mha_bwd=24, gemm_f32=48, col_sum=72),
         params=clip_model.ensure_vpt_params(kparams, shallow, seed=7))

    def remat_equal(runs):
        """remat's gradients are no remat's (the kernels are deterministic)."""
        _, plain_g = _grads(_tree_copy(kparams), cfg, *batch[0])
        _, remat_g = _grads(_tree_copy(kparams), cfg.replace(remat="full"), *batch[0])
        worst = max(float((remat_g[q] - plain_g[q]).norm() / plain_g[q].norm().clamp_min(1e-30)) for q in plain_g)
        require(worst <= 1e-6, f"remat changed a gradient: norm-rel {worst:.3e}")
        return {"remat_grad_norm_rel_diff": worst}

    both("remat full", cfg.replace(remat="full"),
         _pretrain_counts(fused_mlp=48, fused_attn_block=24, fused_mha=24), check=remat_equal)
    teacher = clip_model.init_clip_params(torch.Generator(device=PRETRAIN_DEVICE).manual_seed(8), cfg)
    both("distill from ViT-B/16", cfg, _pretrain_counts(fused_mlp=48, fused_attn_block=24, fused_mha=24),
         teacher=teacher)
    del teacher
    rn_cfg = MODEL_PRESETS["RN50"]
    both("RN50", rn_cfg, {"fused_mlp": 12, "fused_attn_block": 0, "fused_mha": 12, "fused_mlp_bwd": 12,
                          "fused_attn_block_bwd": 0, "fused_mha_bwd": 12, "gemm_f32": 24, "col_sum": 36},
         params=clip_model.init_clip_params(torch.Generator(device=PRETRAIN_DEVICE).manual_seed(9), rn_cfg),
         batches=[_pretrain_batch(rn_cfg, PRETRAIN_BATCH, 41)])
    return {"options": out, "launches": launches}


def _pretrain_cli(card: str, tmp: str) -> dict:
    """``pretrain_cli.main`` end to end at ViT-B/16 f32 on a synthetic
    ImageFolder: 2 epochs (cosine schedule, warmup, clip, EMA, a snapshot
    each epoch, zero-shot each epoch), ``--resume`` for a third, ``featurize
    --pretrained`` on the final tree, then one ``--shard-dir`` and one
    ``--csv-path`` epoch over the same images."""
    import csv
    import io
    import os

    import torch
    from PIL import Image

    from tapclip_tpu_torch import featurize, pretrain_cli
    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.data.preprocess import preprocess_pil_uint8
    from tapclip_tpu_torch.data.shards import write_shards
    from tapclip_tpu_torch.pretrain import named_leaves
    from tapclip_tpu_torch.utils.checkpoint import load_clip_tree

    cfg = MODEL_PRESETS[PRETRAIN_MODEL]
    classes = CLASSES + ["Mug"]
    root = os.path.join(tmp, "cli_tree")
    _write_tree(root, ["all"], classes, PRETRAIN_CLI_IMAGES // len(classes))
    tree = os.path.join(root, "all")
    base = ["--model", PRETRAIN_MODEL, "--device", PRETRAIN_DEVICE, "--batch-size", str(PRETRAIN_BATCH),
            "--lr", str(PRETRAIN_LR), "--weight-decay", str(PRETRAIN_WD)]
    args = base + ["--data-root", tree, "--epochs", "2", "--schedule", "cosine", "--warmup-steps", "1",
                   "--grad-clip", "1", "--ema-decay", "0.9", "--save-every", "1", "--zeroshot-val-root", tree,
                   "--output-root", os.path.join(tmp, "cli")]
    torch.cuda.synchronize()
    reset_counts()
    first, s1 = _sync_ms(lambda: pretrain_cli.main(args))
    counts = read_counts()
    for n in PRETRAIN_KERNELS:
        require(counts[n] > 0, f"pretrain_cli: {n} was not launched ({counts})")
    with open(os.path.join(first["paths"]["csv_dir"], "pretrain_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    require([r["epoch"] for r in rows] == ["1", "2"] and all(r["zeroshot_acc_ema"] for r in rows)
            and all(np.isfinite(first["loss_history"])), f"pretrain_cli rows {rows}")
    snaps = [f for f in os.listdir(first["paths"]["model_dir"]) if f.startswith("pretrain_snapshot")]
    require(snaps == ["pretrain_snapshot_e000002.pt"], f"pretrain_cli snapshots {snaps}")
    resumed, s2 = _sync_ms(lambda: pretrain_cli.main(args[:args.index("--epochs")] + [
        "--epochs", "3", "--resume", os.path.join(first["paths"]["model_dir"], snaps[0])]
        + args[args.index("--epochs") + 2:]))
    require(len(resumed["loss_history"]) == 1, f"resume ran {resumed['loss_history']}")
    loaded = load_clip_tree(resumed["ckpt"], cfg, device=PRETRAIN_DEVICE)
    same = all(torch.equal(a, b.detach()) for (_, a), (_, b) in zip(named_leaves(loaded),
                                                                      named_leaves(resumed["params"])))
    require(same, "the saved tree is not the trained tree")
    out_dir = os.path.join(tmp, "feats")
    featurize.main(["--image-root", tree, "--out", out_dir, "--model", PRETRAIN_MODEL, "--pretrained",
                    resumed["ckpt"], "--device", PRETRAIN_DEVICE, "--batch-size", str(PRETRAIN_BATCH)])
    emb = np.load(os.path.join(out_dir, "image_embeddings.npy")).astype(np.float32)
    with open(os.path.join(out_dir, "manifest.csv")) as f:
        paths = [r["path"] for r in csv.DictReader(f)]
    pixels = np.stack([preprocess_pil_uint8(Image.open(p).convert("RGB"), cfg.image_size) for p in paths])
    want = featurize.make_image_embed_fn(cfg)(loaded, pixels).cpu().numpy()
    feat_err = float(np.abs(emb - want).max())
    require(feat_err <= EMB_TOL, f"featurize --pretrained on the final tree: {feat_err:.3e}")
    # The same images as webdataset shards and as a TSV manifest.
    samples, lines = [], ["filepath\ttitle"]
    for p in paths:
        buf = io.BytesIO()
        Image.open(p).save(buf, format="JPEG")
        caption = f"a photo of a {os.path.basename(os.path.dirname(p)).lower()}"
        samples.append((buf.getvalue(), caption))
        lines.append(f"{p}\t{caption}")
    write_shards(samples, os.path.join(tmp, "shards"), shard_size=32)
    with open(os.path.join(tmp, "pairs.tsv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    streamed = {}
    for key, extra in (("shards", ["--shard-dir", os.path.join(tmp, "shards"), "--shuffle-buffer", "16"]),
                       ("csv", ["--csv-path", os.path.join(tmp, "pairs.tsv")])):
        res, s = _sync_ms(lambda: pretrain_cli.main(base + ["--epochs", "1", "--output-root",
                                                           os.path.join(tmp, key)] + extra))
        require(len(res["loss_history"]) == 1 and np.isfinite(res["loss_history"][0]), f"{key}: {res}")
        streamed[key] = {"loss": res["loss_history"][0], "s": s / 1e3}
    print(f"pretrain_cli: 2 epochs over {PRETRAIN_CLI_IMAGES} images at batch {PRETRAIN_BATCH} (cosine, warmup 1, "
          f"clip 1, EMA 0.9, snapshot and zero-shot each epoch) in {s1 / 1e3:.1f} s: rows "
          f"{[{k: r[k] for k in ('epoch', 'loss', 'zeroshot_acc', 'zeroshot_acc_ema')} for r in rows]}; resumed "
          f"epoch 3 in {s2 / 1e3:.1f} s, loss {resumed['loss_history'][0]:.5f}; featurize --pretrained on the final "
          f"tree vs encode_image {feat_err:.2e} (tol {EMB_TOL}); one --shard-dir and one --csv-path epoch {streamed}; "
          f"launches of the 2-epoch run { {n: counts[n] for n in PRETRAIN_KERNELS} } ({card})", flush=True)
    return {"launches": counts, "s": s1 / 1e3, "resume_s": s2 / 1e3, "feat_err": feat_err, "streamed": streamed}


def _pretrain_turns(kparams, cfg, card: str) -> dict:
    """ms per step on the host clock (ended by a synchronisation), in turns:
    the InfoNCE step in f32 and in bf16, and the class-level CE step
    (prompt tuning on cached features) at batch 32."""
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.config import TrainConfig
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step

    steps = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        tree = _tree_copy(kparams)
        step = P.make_pretrain_step(c, P.PretrainOptimizer(P.set_trainable(tree), lr=PRETRAIN_LR,
                                                           weight_decay=PRETRAIN_WD))
        x, ids = _pretrain_batch(c, PRETRAIN_BATCH, 50)
        steps[f"pretrain {dtype}"] = (lambda step=step, tree=tree, x=x, ids=ids: step(tree, x, ids))
    model = FullModel(TRAIN_CLASSES, kparams, cfg)
    ce = make_train_step(cfg, model.prompt_cfg)
    state = init_train_state(model.trainable, make_optimizer(TrainConfig(lr=2e-3)))
    rng = np.random.default_rng(51)
    feats = rng.standard_normal((PRETRAIN_BATCH, cfg.embed_dim)).astype(np.float32)
    y = rng.integers(0, len(TRAIN_CLASSES), PRETRAIN_BATCH)
    mask = np.ones(PRETRAIN_BATCH, bool)
    steps["class-level CE"] = lambda: ce(kparams, state, model.prompt_learner.bank, feats, y, mask)
    ms = {k: [] for k in steps}
    for _ in range(PRETRAIN_TURNS):
        for k, fn in steps.items():
            ms[k].append(_sync_ms(fn)[1])
    turns = {k: float(np.median(v[1:])) for k, v in ms.items()}
    print(f"pretrain: ms per step in turns, median of {PRETRAIN_TURNS - 1} after one, batch {PRETRAIN_BATCH} at "
          f"ViT-B/16: " + ", ".join(f"{k} {v:.2f}" for k, v in turns.items())
          + f"; the f32 pretraining step is {turns['pretrain float32'] / turns['class-level CE']:.1f}x the "
          f"class-level CE step ({card})", flush=True)
    return turns


def _gemm_dw(card: str) -> dict:
    """gemm.cu's weight-gradient products at the pretraining image shape (8 x
    200 rows = 1,600; ViT-B/16's widths) and at batch 32 (6,400 rows): each
    against its plain version (``gemm_reference``: A^T.B of the operands
    widened to f32) and torch.mm (f32 out), with CUDA-event ms, the bound at
    the dtype's peak (f32: the FMA units) and at the MMAs it runs (six a
    product in f32), and the split of the rows it takes; then B4's and B5's
    call with every gradient beside dx alone at the image shape."""
    import torch

    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.fused_mha import _attn_block_bwd_cuda
    from tapclip_tpu_torch.ops.fused_mlp import _fused_mlp_bwd_cuda
    from tapclip_tpu_torch.ops.gemm import gemm_f32, gemm_reference

    gen = torch.Generator(device=PRETRAIN_DEVICE).manual_seed(60)
    W = 768
    cases = []
    for rows in (1_600, 6_400):
        for label, (M, N) in (("y^T.dqkv (B4)", (W, 3 * W)), ("o^T.g (B4)", (W, W)), ("y^T.dh (B5)", (W, 4 * W)),
                              ("h^T.g (B5)", (4 * W, W))):
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                a = torch.randn((rows, M), generator=gen, device=PRETRAIN_DEVICE).to(dt)
                b = torch.randn((rows, N), generator=gen, device=PRETRAIN_DEVICE).to(dt)
                got = gemm_f32(a, b, trans_a=True)
                want = gemm_reference(a, b, trans_a=True)
                err = compare(f"gemm_f32 {label} {rows} {dtype}", got, want, 1e-4 * rows ** 0.5)
                split = _build.library().tapclip_gemm_f32_split(M, N, rows, _build.dtype_code(dt))
                lib = (lambda: torch.mm(a.T, b, out_dtype=torch.float32)) if dtype == "bfloat16" else (
                    lambda: torch.mm(a.T, b))
                try:
                    library_ms = time_ms(lib)
                except (RuntimeError, TypeError):  # a torch without out_dtype
                    library_ms = None
                work = (nbytes(a, b) + 4 * M * N, 2.0 * M * N * rows)
                cases.append({"shape": f"{label} {M}x{N}x{rows}", "dtype": dtype, **err, "split": split,
                              "ms": time_ms(lambda: gemm_f32(a, b, trans_a=True)),
                              "plain_ms": time_ms(lambda: gemm_reference(a, b, trans_a=True)),
                              "library_ms": library_ms, **bound(*work, dtype), **mma_bound(*work, dtype, "gemm_f32")})
    halves = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        x, g = (torch.randn((8, 200, W), generator=gen, device=PRETRAIN_DEVICE).to(dt) for _ in range(2))

        def rnd(*s, sc=1.0):
            return torch.randn(s, generator=gen, device=PRETRAIN_DEVICE) * sc

        pa = (1 + rnd(W, sc=0.1), rnd(W, sc=0.1), rnd(W, 3 * W, sc=W ** -0.5), rnd(3 * W, sc=0.1), rnd(W, W, sc=W ** -0.5))
        pm = (1 + rnd(W, sc=0.1), rnd(W, sc=0.1), rnd(W, 4 * W, sc=W ** -0.5), rnd(4 * W, sc=0.1),
              rnd(4 * W, W, sc=(4 * W) ** -0.5))
        halves[dtype] = {
            "B4 all": time_ms(lambda: _attn_block_bwd_cuda(x, g, *pa, 12, 197, 1e-5)),
            "B4 dx": time_ms(lambda: _attn_block_bwd_cuda(x, g, *pa, 12, 197, 1e-5, weight_grads=False)),
            "B5 all": time_ms(lambda: _fused_mlp_bwd_cuda(x, g, *pm, eps=1e-5)),
            "B5 dx": time_ms(lambda: _fused_mlp_bwd_cuda(x, g, *pm, eps=1e-5, weight_grads=False)),
        }
    print("pretrain: gemm.cu's dW products, CUDA-event ms vs plain (f32 widened) vs torch.mm vs bound vs MMA "
          "bound: "
          + "; ".join(f"{c['shape']} {c['dtype']} split {c['split']} {c['ms']:.3f} / {c['plain_ms']:.3f} / "
                      f"{c['library_ms'] if c['library_ms'] is None else round(c['library_ms'], 3)} / "
                      f"{c['bound_ms']:.3f} ({c['bound_by']}) / {c['mma_bound_ms']:.3f}, max abs err "
                      f"{c['max_abs_err']:.1e}" for c in cases)
          + f" ({card})", flush=True)
    print("pretrain: B4 and B5 at the image shape 8x200x768 (12 heads, valid 197), ms with every gradient vs dx "
          "alone: " + "; ".join(f"{dt} " + ", ".join(f"{k} {v:.3f}" for k, v in h.items()) for dt, h in halves.items())
          + f" ({card})", flush=True)
    return {"cases": cases, "halves": halves}


def pretrain_phase(card: str) -> dict:
    """CLIP pretraining on the card ("pretrain"), ViT-B/16 f32 with random
    weights unless said: the InfoNCE step on the kernels against the plain
    path (f32 and bf16), one step per option, ``pretrain_cli`` end to end,
    the step timed in turns with the class-level CE step, gemm.cu's dW
    products and B4/B5 at the image shape timed, one traced step."""
    import shutil
    import tempfile

    import torch

    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.models import clip as clip_model

    cfg = MODEL_PRESETS[PRETRAIN_MODEL]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    try:
        kparams = clip_model.init_clip_params(torch.Generator(device=PRETRAIN_DEVICE).manual_seed(20), cfg)
        main_f32 = _pretrain_main_steps(kparams, cfg, card)
        main_bf16 = _pretrain_main_steps(kparams, cfg.replace(dtype="bfloat16"), card)
        options = _pretrain_options(kparams, cfg, card)
        cli = _pretrain_cli(card, tmp)
        turns = _pretrain_turns(kparams, cfg, card)
        del kparams
        gemm = _gemm_dw(card)
        from tapclip_tpu_torch.scripts.profile_kernels import pretrain_trace

        trace = pretrain_trace(5)
        fam = trace.get("families_us", {})
        dw = fam.get("gemm_f32", 0.0)  # the device time inside gemm_f32's spans: its products and their sums
        require(dw > 0, f"the trace holds no gemm.cu dW product: {fam}")
        print(f"pretrain: one traced InfoNCE step (f32, batch {PRETRAIN_BATCH}): {trace['step_ms']:.1f} ms traced, "
              f"{trace['step_ms_unprofiled']:.1f} ms untraced, device busy {trace['busy_share']:.3f} "
              f"(untraced {trace['busy_share_unprofiled']:.3f}); device us per step by wrapper "
              + ", ".join(f"{k} {v:.0f}" for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
              + f"; gemm.cu's dW products (gemm_f32's spans) {dw:.0f} us, {dw / trace['kernels_sum_us']:.3f} of "
              f"{trace['kernels_sum_us']:.0f} us of kernels; host ms {trace['host_ms']} ({card})", flush=True)
        return {"launches": main_f32["launches"], "f32": main_f32, "bf16": main_bf16, "options": options, "cli": cli,
                "turns_ms": turns, "gemm": gemm, "trace": trace}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- "moe": the MoE towers (models/moe.py), pretrained and prompt-tuned ------------------------

MOE_DEVICE = "cuda"
MOE_EXPERTS = 8  # C = 32 in the vision tower (197 tokens), 16 in the text tower (77): multiples of 8
MOE_STEPS = 3
MOE_TURNS = 6  # the MoE steps (f32, bf16) and the dense f32 step timed in turns; the first turn is warm-up
MOE_KERNELS = ("fused_mha", "fused_mha_bwd", "fused_attention_aux")
# The free-running comparison (each path routes on its own attention's
# output): a token whose top two router logits lie within the paths'
# rounding goes to another expert on one of them, and through the queue's
# cumulative sum that can move which later tokens overflow; such a token's
# MLP output is another expert's.  Read on an H100 80GB HBM3 at 700 W
# (this phase): f32, no token of 315,648 flipped and the figures
# equal the replayed ones; bf16, 4.14% of the vision tokens and 2.22% of
# the text ones flipped, and the step moved by 1.35e-3 (loss), 5.8e-3
# (step 1's gradient norm), 0.39 (its worst leaf, an expert's b_proj) and
# 0.33 (the displacement): per unit of the larger flip share, the
# coefficients below.  So the free-running figures are held at
# MOE_FREE_HEADROOM times the coefficient times the flip share the run
# measures, never below PRETRAIN_TOL, and the flip share at MOE_FLIP_CAP
# (f32 1e-3, the predicted bound; bf16 0.1, 2.4 times the reading).
MOE_FLIP_COEF = {"loss": 0.033, "grad_norm": 0.14, "grad": 9.5, "step": 8.0}
MOE_FLIP_CAP = {"float32": 1e-3, "bfloat16": 0.1}
MOE_FREE_HEADROOM = 3.0


def _moe_free_tol(dtype: str, flip_share: float) -> dict:
    """The free-running limits at a flip share (see MOE_FLIP_COEF)."""
    return {k: max(PRETRAIN_TOL[dtype][k], MOE_FREE_HEADROOM * c * flip_share) for k, c in MOE_FLIP_COEF.items()}


def _moe_counts(cfg, steps: int = 0, tune_steps: int = 0) -> dict:
    """Exact launches (every other counter 0) of ``steps`` InfoNCE steps on
    MoE towers, where every block runs B6 between torch's QKV and
    out-projections, then the expert bank in torch, and B7 backward (at
    ViT-B/16: 12 vision blocks at 32 x 200 x 768, 12 heads, valid 197, and
    12 text blocks at 32 x 80 x 512, 8 heads, valid 77, causal: 24 B6 + 24
    B7), and of ``tune_steps`` cached-feature prompt-tuning steps
    (ref_compat, T 88, valid 82), whose attribution pass runs the text
    blocks but the last on B6 and the last on K3, and whose encode pass runs
    every block on B6, differentiated into ctx through B7 (23 B6 + 1 K3 + 12
    B7).  No K1, K2, B4, B5 and no gemm.cu product: they fuse a dense MLP or
    a LayerNorm'd attention block."""
    blocks, text = cfg.vision_layers + cfg.text_layers, cfg.text_layers
    want = {name: 0 for name in _counters()}
    want.update(fused_mha=blocks * steps + (2 * text - 1) * tune_steps, fused_mha_bwd=blocks * steps + text * tune_steps,
                fused_attention_aux=tune_steps)
    return want


def _recording(calls: list):
    """A ``patched`` replacement of ``moe.route`` that records each call's
    decisions: (width, valid_len, expert, pos, keep)."""
    def fn(orig, x, p, capacity_factor=1.25, valid_len=None):
        r = orig(x, p, capacity_factor, valid_len)
        calls.append((x.shape[-1], valid_len, r.expert, r.pos, r.keep))
        return r
    return fn


def _replaying(calls: list):
    """A ``patched`` replacement of ``moe.route`` that takes the recorded
    decisions in order (expert, position, keep) and its own router's
    probabilities: the gate is its probability of the recorded expert, so
    the router's gradient is its own."""
    queue = list(calls)

    def fn(orig, x, p, capacity_factor=1.25, valid_len=None):
        r = orig(x, p, capacity_factor, valid_len)
        require(bool(queue), "the replay ran out of recorded routing")
        width, vl, expert, pos, keep = queue.pop(0)
        require(width == x.shape[-1] and vl == valid_len, "the replay's calls are out of order")
        return r._replace(expert=expert, pos=pos, keep=keep, gate=r.probs.gather(-1, expert[..., None])[..., 0])
    return fn, queue


def _route_shares(calls: list, cfg, other: list = None) -> dict:
    """Per tower: the valid tokens routed, the share dropped over capacity
    and, against ``other`` (the same calls on another path), the share
    routed to another expert.  Each pass routes the vision blocks, then the
    text blocks."""
    import torch

    out = {}
    for i, (_, vl, expert, pos, keep) in enumerate(calls):
        tower = "vision" if i % (cfg.vision_layers + cfg.text_layers) < cfg.vision_layers else "text"
        T = expert.shape[1]
        valid = (torch.arange(T, device=expert.device) < (vl or T))[None].expand_as(expert)
        t = out.setdefault(tower, {"tokens": 0, "dropped": 0, "flipped": 0})
        t["tokens"] += int(valid.sum())
        t["dropped"] += int((valid & ~keep).sum())
        if other is not None:
            t["flipped"] += int((valid & (expert != other[i][2])).sum())
    return {tower: {"tokens": t["tokens"], "drop_share": t["dropped"] / t["tokens"],
                    **({"flip_share": t["flipped"] / t["tokens"]} if other is not None else {})}
            for tower, t in out.items()}


def _moe_grads(params, cfg, images, ids):
    """(loss, {path: gradient}) of InfoNCE + the load-balance term of one
    batch over every leaf of ``params``."""
    import torch

    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.models import clip as clip_model

    leaves = P.set_trainable(params)
    x = torch.as_tensor(images, device=params["logit_scale"].device)
    aux = []
    total = P.pair_loss("infonce", params, clip_model.encode_image(params, cfg, x, moe_loss_out=aux),
                        clip_model.encode_text(params, cfg, ids, moe_loss_out=aux))
    total = total + cfg.moe_aux_weight * sum(aux)
    gs = torch.autograd.grad(total, [t for _, t in leaves])
    return float(total.detach()), {p: g.float() for (p, _), g in zip(leaves, gs)}


def _moe_main_steps(kparams, cfg, card: str) -> dict:
    """Three InfoNCE + load-balance steps at batch 32 on MoE towers: on the
    kernels, on the plain path with the kernel path's routing replayed (held
    at PRETRAIN_TOL, as the dense step), and on the plain path routing on
    its own (held at ``_moe_free_tol`` of the flip share); step 1's
    gradients likewise; exact
    launches; the flip and drop shares per tower."""
    import torch

    from tapclip_tpu_torch.models import moe
    from tapclip_tpu_torch.pretrain import named_leaves

    plain_cfg = cfg.replace(attn_impl="xla")
    tol = PRETRAIN_TOL[cfg.dtype]
    batches = [_pretrain_batch(cfg, PRETRAIN_BATCH, 70 + i) for i in range(MOE_STEPS)]
    recorded = []
    with patched(moe, "route", _recording(recorded)):
        kl, kg = _moe_grads(_tree_copy(kparams), cfg, *batches[0])
    replay, left = _replaying(recorded)
    with patched(moe, "route", replay):
        pl, pg = _moe_grads(_tree_copy(kparams), plain_cfg, *batches[0])
    require(not left, f"moe {cfg.dtype}: {len(left)} recorded routings not replayed")
    fl, fg = _moe_grads(_tree_copy(kparams), plain_cfg, *batches[0])
    grad_err = {"replayed": _grad_errors(kg, pg), "free": _grad_errors(kg, fg)}
    del kg, pg, fg
    runs, calls = {}, {}
    for path, c in (("kernel", cfg), ("replayed", plain_cfg), ("free", plain_cfg)):
        calls[path] = []
        if path == "replayed":
            fn, left = _replaying(calls["kernel"])
        else:
            fn = _recording(calls[path])
        tree = _tree_copy(kparams)
        with patched(moe, "route", fn):
            runs[path] = _run_steps(c, tree, batches) + (tree,)
        if path == "replayed":
            require(not left, f"moe {cfg.dtype}: {len(left)} recorded routings not replayed")
    (kls, kms, kc, k1) = runs["kernel"]
    errs = {}
    for path, l1 in (("replayed", pl), ("free", fl)):
        ls, _, counts, t1 = runs[path]
        require(all(n == 0 for n in counts.values()), f"moe {cfg.dtype} {path}: the plain path launched {counts}")
        norm_err, leaf_err, leaf = grad_err[path]
        step_err, apart, worst = _displacement(k1, kparams, t1, kparams, PRETRAIN_LR, MOE_STEPS)
        errs[path] = {"loss": max(abs(a - b) / abs(b) for a, b in zip([kl] + kls, [l1] + ls)),
                      "grad_norm": norm_err, "grad": leaf_err, "grad_leaf": leaf, "step": step_err,
                      "apart": apart, "largest": worst, "losses": ls}
    _expect(f"moe {cfg.dtype} steps", kc, _moe_counts(cfg, steps=MOE_STEPS))
    require(np.isfinite(kls).all() and kls[-1] < kls[0], f"moe {cfg.dtype}: losses {kls}")
    routers = [(path, t) for path, t in named_leaves(k1) if path.endswith("router/w")]
    start = dict(named_leaves(kparams))
    require(len(routers) == cfg.vision_layers + cfg.text_layers
            and all(not torch.equal(t.detach(), start[path]) for path, t in routers),
            f"moe {cfg.dtype}: a router did not move")
    shares = _route_shares(calls["kernel"], cfg, calls["free"])
    flip = max(t["flip_share"] for t in shares.values())
    free_tol = _moe_free_tol(cfg.dtype, flip)
    r, f = errs["replayed"], errs["free"]
    print(f"moe {cfg.dtype}: {MOE_STEPS} InfoNCE + load-balance steps at batch {PRETRAIN_BATCH}, {MOE_EXPERTS} experts "
          f"a block (every leaf trained, AdamW lr {PRETRAIN_LR}): loss kernel {[round(v, 5) for v in kls]}, plain "
          f"with the kernel's routing {[round(v, 5) for v in r['losses']]}, plain routing on its own "
          f"{[round(v, 5) for v in f['losses']]}; routing replayed: loss rel err {r['loss']:.2e} (tol {tol['loss']}), "
          f"step-1 gradient norm {r['grad_norm']:.2e} (tol {tol['grad_norm']}), worst leaf {r['grad_leaf']} "
          f"{r['grad']:.2e} (tol {tol['grad']}), displacement {r['step']:.2e} (tol {tol['step']}), entries apart "
          f"{r['apart']:.2e} (tol {PRETRAIN_APART}); free-running: loss {f['loss']:.2e} (tol {free_tol['loss']}), "
          f"gradient norm {f['grad_norm']:.2e} (tol {free_tol['grad_norm']}), worst leaf {f['grad_leaf']} "
          f"{f['grad']:.2e} (tol {free_tol['grad']:.3g}), displacement {f['step']:.2e} (tol {free_tol['step']:.3g}), "
          f"entries apart {f['apart']:.2e} (tol {PRETRAIN_APART}); per tower tokens routed, share dropped over capacity, share flipped "
          f"(kernel vs free plain) {shares}; ms per step kernel {[round(v, 1) for v in kms]}; launches per step "
          f"{ {n: kc[n] // MOE_STEPS for n in MOE_KERNELS} } ({card})", flush=True)
    require(r["loss"] <= tol["loss"] and r["grad_norm"] <= tol["grad_norm"] and r["grad"] <= tol["grad"]
            and r["step"] <= tol["step"] and r["apart"] <= PRETRAIN_APART,
            f"moe {cfg.dtype}, routing replayed: loss {r['loss']:.3e}, grad norm {r['grad_norm']:.3e}, leaf "
            f"{r['grad_leaf']} {r['grad']:.3e}, displacement {r['step']:.3e}, entries apart {r['apart']:.2e}")
    require(flip <= MOE_FLIP_CAP[cfg.dtype] and all(f[k] <= free_tol[k] for k in free_tol)
            and f["apart"] <= PRETRAIN_APART,
            f"moe {cfg.dtype}, free-running: flip share {flip:.3e} (cap {MOE_FLIP_CAP[cfg.dtype]}), "
            f"{ {k: f[k] for k in free_tol} } against {free_tol}, entries apart {f['apart']:.2e}")
    return {"launches": kc, "errors": {p: {k: v for k, v in e.items() if k != "losses"} for p, e in errs.items()},
            "shares": shares, "ms": kms, "losses": kls}


def _moe_cli(card: str, tmp: str) -> dict:
    """``pretrain_cli.main --moe-experts 8`` for one epoch over 64 JPEGs at
    batch 32: exact launches, the ``.pt`` tree read back equal to the
    trained one, and refused under the dense config."""
    import os

    import torch

    from tapclip_tpu_torch import pretrain_cli
    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.pretrain import named_leaves
    from tapclip_tpu_torch.utils.checkpoint import load_clip_tree

    dense = MODEL_PRESETS[PRETRAIN_MODEL]
    cfg = dense.replace(moe_experts=MOE_EXPERTS)
    classes = CLASSES + ["Mug"]
    root = os.path.join(tmp, "moe_tree")
    _write_tree(root, ["all"], classes, PRETRAIN_CLI_IMAGES // len(classes))
    args = ["--model", PRETRAIN_MODEL, "--device", MOE_DEVICE, "--batch-size", str(PRETRAIN_BATCH), "--lr",
            str(PRETRAIN_LR), "--weight-decay", str(PRETRAIN_WD), "--moe-experts", str(MOE_EXPERTS), "--data-root",
            os.path.join(root, "all"), "--epochs", "1", "--output-root", os.path.join(tmp, "moe_cli")]
    torch.cuda.synchronize()
    reset_counts()
    out, ms = _sync_ms(lambda: pretrain_cli.main(args))
    counts = read_counts()
    steps = PRETRAIN_CLI_IMAGES // PRETRAIN_BATCH
    _expect("pretrain_cli --moe-experts", counts, _moe_counts(cfg, steps=steps))
    require(len(out["loss_history"]) == 1 and np.isfinite(out["loss_history"][0]), f"moe cli: {out['loss_history']}")
    t0 = time.perf_counter()
    loaded = load_clip_tree(out["ckpt"], cfg, device=MOE_DEVICE)
    load_s = time.perf_counter() - t0
    same = all(torch.equal(a, b.detach()) for (_, a), (_, b) in zip(named_leaves(loaded),
                                                                      named_leaves(out["params"])))
    require(same and "moe" in loaded["visual"]["blocks"][0], "moe cli: the saved tree is not the trained tree")
    del loaded
    try:
        load_clip_tree(out["ckpt"], dense, device=MOE_DEVICE)
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "does not fit" in refused, "moe cli: the dense config took the MoE tree")
    size = os.path.getsize(out["ckpt"])
    print(f"moe: pretrain_cli --moe-experts {MOE_EXPERTS}, 1 epoch over {PRETRAIN_CLI_IMAGES} images at batch "
          f"{PRETRAIN_BATCH} in {ms / 1e3:.1f} s, loss {out['loss_history'][0]:.5f}; the .pt tree "
          f"({size / 2 ** 30:.2f} GiB) read back in {load_s:.1f} s equal to the trained tree, refused under the dense "
          f"config ({refused.split(':', 1)[-1].strip()[:80]}...); launches "
          f"{ {n: counts[n] for n in MOE_KERNELS} } ({card})", flush=True)
    return {"launches": counts, "s": ms / 1e3, "load_s": load_s, "bytes": size}


def _moe_prompt_step(kparams, cfg, card: str) -> dict:
    """One cached-feature prompt-tuning step (ref_compat, f32, batch 32) on
    the MoE towers, on the kernels and on the plain path with the kernel
    path's routing replayed: exact launches (``_moe_counts``), the loss, the
    gradient norm and ctx's displacement at TRAIN_TOL."""
    from tapclip_tpu_torch.config import TrainConfig
    from tapclip_tpu_torch.models import moe
    from tapclip_tpu_torch.models.model_wrapper import FullModel
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_optimizer, make_train_step

    rng = np.random.default_rng(71)
    feats = rng.standard_normal((PRETRAIN_BATCH, cfg.embed_dim)).astype(np.float32)
    y = rng.integers(0, len(TRAIN_CLASSES), PRETRAIN_BATCH)
    mask = np.ones(PRETRAIN_BATCH, bool)
    recorded, out = [], {}
    for path, c in (("kernel", cfg), ("plain", cfg.replace(attn_impl="xla"))):
        model = FullModel(TRAIN_CLASSES, kparams, c)
        step = make_train_step(c, model.prompt_cfg)
        state = init_train_state(model.trainable, make_optimizer(TrainConfig(lr=2e-3)))
        ctx0 = model.trainable["ctx"].detach().float().cpu().numpy()
        fn, left = (_recording(recorded), []) if path == "kernel" else _replaying(recorded)
        reset_counts()
        with patched(moe, "route", fn):
            (state, metrics), ms = _sync_ms(lambda: step(kparams, state, model.prompt_learner.bank, feats, y, mask))
        require(not left, f"moe prompt step: {len(left)} recorded routings not replayed")
        out[path] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "ms": ms,
                     "ctx0": ctx0, "ctx": state.params["ctx"].detach().float().cpu().numpy(),
                     "launches": read_counts()}
    k, p = out["kernel"], out["plain"]
    tol = TRAIN_TOL["float32"]
    errs = {"loss": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
            "grad_norm": abs(k["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"]),
            "ctx_step": _step_err(k["ctx"], k["ctx0"], p["ctx"], p["ctx0"])}
    _expect("moe prompt step", k["launches"], _moe_counts(cfg, tune_steps=1))
    require(all(n == 0 for n in p["launches"].values()), f"moe prompt step: the plain path launched {p['launches']}")
    print(f"moe: one cached-feature prompt-tuning step (ref_compat, f32, batch {PRETRAIN_BATCH}, "
          f"{len(TRAIN_CLASSES)} classes) on the MoE towers: loss {k['loss']:.6f} vs plain with the kernel's routing "
          f"{p['loss']:.6f}, rel err {errs['loss']:.2e} (tol {tol['loss']}), grad norm {errs['grad_norm']:.2e} (tol "
          f"{tol['grad_norm']}), ctx displacement {errs['ctx_step']:.2e} (tol {tol['ctx_step']}); ms kernel "
          f"{k['ms']:.1f} plain {p['ms']:.1f}; launches { {n: k['launches'][n] for n in MOE_KERNELS} } ({card})",
          flush=True)
    require(all(errs[key] <= tol[key] for key in errs), f"moe prompt step: kernel vs plain {errs} against {tol}")
    return {"launches": k["launches"], "errors": errs, "ms": k["ms"], "plain_ms": p["ms"]}


def _event_ms(fn) -> float:
    """CUDA-event ms of one call of ``fn`` (the device's timeline from before
    its first launch to after its last, host gaps included)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _moe_turns(kparams, cfg, card: str) -> dict:
    """ms per step with CUDA events, in turns: the MoE step in f32 and in
    bf16 and the dense f32 step (random ViT-B/16 weights), batch 32, every
    leaf trained; median of the turns after the first."""
    import torch

    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.models import clip as clip_model

    dense = MODEL_PRESETS[PRETRAIN_MODEL]
    trees = {"moe float32": (cfg, _tree_copy(kparams)), "moe bfloat16": (cfg.replace(dtype="bfloat16"),
                                                                          _tree_copy(kparams)),
             "dense float32": (dense, clip_model.init_clip_params(torch.Generator(device=MOE_DEVICE).manual_seed(20),
                                                                  dense))}
    steps = {}
    for key, (c, tree) in trees.items():
        step = P.make_pretrain_step(c, P.PretrainOptimizer(P.set_trainable(tree), lr=PRETRAIN_LR,
                                                           weight_decay=PRETRAIN_WD))
        x, ids = _pretrain_batch(c, PRETRAIN_BATCH, 80)
        steps[key] = (lambda step=step, tree=tree, x=x, ids=ids: step(tree, x, ids))
    ms = {k: [] for k in steps}
    for _ in range(MOE_TURNS):
        for k, fn in steps.items():
            ms[k].append(_event_ms(fn))
    turns = {k: float(np.median(v[1:])) for k, v in ms.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"moe: ms per step with CUDA events in turns, median of {MOE_TURNS - 1} after one, batch {PRETRAIN_BATCH} "
          f"at ViT-B/16: " + ", ".join(f"{k} {v:.2f} (turns {[round(t, 2) for t in ms[k]]})" for k, v in turns.items())
          + f"; the MoE f32 step is {turns['moe float32'] / turns['dense float32']:.2f}x the dense f32 step; peak "
          f"device memory so far {peak:.1f} GiB ({card})", flush=True)
    return {"median_ms": turns, "turns_ms": ms, "peak_gib": peak}


def moe_phase(card: str) -> dict:
    """The MoE towers on the card ("moe"), ViT-B/16 with 8 experts a block
    and random weights: the InfoNCE + load-balance step on the kernels
    against the plain path (routing replayed and free-running), f32 and
    bf16; ``pretrain_cli --moe-experts 8``; one prompt-tuning step; the step
    timed in turns with the dense one; one traced step."""
    import shutil
    import tempfile

    import torch

    from tapclip_tpu_torch.config import MODEL_PRESETS
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.pretrain import named_leaves

    cfg = MODEL_PRESETS[PRETRAIN_MODEL].replace(moe_experts=MOE_EXPERTS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        kparams = clip_model.init_clip_params(torch.Generator(device=MOE_DEVICE).manual_seed(21), cfg)
        n_params = sum(t.numel() for _, t in named_leaves(kparams))
        print(f"moe: ViT-B/16 with {MOE_EXPERTS} experts a block, capacity factor {cfg.moe_capacity_factor}: "
              f"{n_params / 1e6:.1f} M parameters ({card})", flush=True)
        main_f32 = _moe_main_steps(kparams, cfg, card)
        main_bf16 = _moe_main_steps(kparams, cfg.replace(dtype="bfloat16"), card)
        tuned = _moe_prompt_step(kparams, cfg, card)
        turns = _moe_turns(kparams, cfg, card)
        del kparams
        cli = _moe_cli(card, tmp)
        from tapclip_tpu_torch.scripts.profile_kernels import moe_trace

        trace = moe_trace(5)
        fam = trace.get("families_us", {})
        require(fam.get("B6", 0) > 0 and fam.get("B7", 0) > 0 and fam.get("products", 0) > 0,
                f"the MoE trace misses B6, B7 or the expert products: {fam}")
        print(f"moe: one traced step (f32, batch {PRETRAIN_BATCH}): {trace['step_ms']:.1f} ms traced, "
              f"{trace['step_ms_unprofiled']:.1f} ms untraced, device busy {trace['busy_share']:.3f} (untraced "
              f"{trace['busy_share_unprofiled']:.3f}); device us per step "
              + ", ".join(f"{k} {v:.0f}" for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
              + f" of {trace['kernels_sum_us']:.0f} us of kernels; host ms {trace['host_ms']}; largest kernels "
              f"{ {k: round(v) for k, v in list(trace['kernels_us'].items())[:6]} } ({card})", flush=True)
        launches = {n: main_f32["launches"][n] + tuned["launches"][n] for n in main_f32["launches"]}
        return {"launches": launches, "f32": main_f32, "bf16": main_bf16, "prompt_step": tuned, "turns": turns,
                "cli": cli, "trace": {k: trace[k] for k in ("step_ms_unprofiled", "busy_share_unprofiled",
                                                            "kernels_sum_us", "families_us")}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The export phase's loader, run in a fresh interpreter: it imports
# utils/model_export.py alone (and with it the tapclip op registrations and
# their launchers), never the model code, while the caller exports; once the
# caller has made the file ``ready``, it loads the programs named in
# EXPORT_FRESH, runs each on the card with the launch counts set to 0 just
# before and read just after, and saves what they return.
EXPORT_FRESH = ("encode_image", "full_forward")
EXPORT_LOADER = r"""
import os, sys, time
t0 = time.perf_counter()
import torch
sys.path.insert(0, sys.argv[4])
from tapclip_tpu_torch.utils.model_export import load_exported
import_s = time.perf_counter() - t0
def banned():
    return sorted(m for m in sys.modules if m.startswith("tapclip_tpu_torch.models") or m.split(".")[0] == "jax")
before = banned()
torch.backends.cuda.matmul.allow_tf32 = False
while not os.path.exists(sys.argv[6]):
    time.sleep(0.05)
t0 = time.perf_counter()
fns, load_by_fn = {}, {}
for name in sys.argv[5].split(","):
    t1 = time.perf_counter()
    fns.update(load_exported(sys.argv[1], functions=(name,)))
    load_by_fn[name] = time.perf_counter() - t1
load_s = time.perf_counter() - t0
a = torch.load(sys.argv[2], map_location="cuda")
ops = sys.modules
counters = {"fused_mlp": (ops["tapclip_tpu_torch.ops.fused_mlp"].fused_mlp_block, "launches"),
            "fused_attn_block": (ops["tapclip_tpu_torch.ops.fused_mha"].fused_attn_block, "launches"),
            "fused_mha": (ops["tapclip_tpu_torch.ops.fused_mha"].fused_mha, "launches"),
            "fused_attention_aux": (ops["tapclip_tpu_torch.ops.flash_attention"].fused_attention, "launches"),
            "fused_attention_aux_causal": (ops["tapclip_tpu_torch.ops.flash_attention"].fused_attention,
                                           "causal_launches")}
calls = {"encode_image": (a["params"], a["images"]), "encode_text": (a["params"], a["tokens"]),
         "classify": (a["params"], a["text_feats"], a["logit_scale"], a["class_mask"], a["images"]),
         "full_forward": (a["params"], a["trainable"], a["bank"], a["images"])}
out = {"outputs": {}, "launches": {}}
for name, args in calls.items():
    if name not in fns:
        continue
    for w, attr in counters.values():
        setattr(w, attr, 0)
    out["outputs"][name] = fns[name](*args)
    torch.cuda.synchronize()
    out["launches"][name] = {k: getattr(w, attr) for k, (w, attr) in counters.items()}
out.update(load_s=load_s, import_s=import_s, load_by_fn=load_by_fn, banned_before=before, banned_after=banned())
torch.save(out, sys.argv[3])
"""


def _tree_bytes(tree) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(tree))


def _export_tools(params, cfg, tmp: str, card: str) -> dict:
    """``convert_checkpoint``'s round trip (open_clip .bin -> CLIP tree .pt
    -> .bin, every tensor back bit for bit) and a two-ingredient uniform
    ``model_soup`` on ViT-B/16 trees (every leaf the float64 mean of the
    two, cast back), through their ``main``."""
    import os

    import torch

    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.scripts import convert_checkpoint, model_soup
    from tapclip_tpu_torch.utils.checkpoint import load_clip_tree, save_clip_tree
    from tapclip_tpu_torch.utils.torch_convert import save_openclip_checkpoint

    paths = {k: os.path.join(tmp, k) for k in ("vitb16.bin", "tree.pt", "back.bin", "other.pt", "soup.pt")}
    t0 = time.perf_counter()
    save_openclip_checkpoint(params, cfg, paths["vitb16.bin"])
    convert_checkpoint.main(["clip", "--src", paths["vitb16.bin"], "--model", cfg.name, "--dst", paths["tree.pt"]])
    convert_checkpoint.main(["export", "--src", paths["tree.pt"], "--model", cfg.name, "--dst", paths["back.bin"]])
    src, back = torch.load(paths["vitb16.bin"]), torch.load(paths["back.bin"])
    require(set(src) == set(back) and all(torch.equal(src[k], back[k]) for k in src),
            "convert_checkpoint: the .bin -> .pt -> .bin round trip changed a tensor")
    convert_s = time.perf_counter() - t0
    del src, back
    t0 = time.perf_counter()
    other = clip_model.init_clip_params(torch.Generator(device="cuda").manual_seed(7), cfg)
    save_clip_tree(paths["other.pt"], other, cfg)
    model_soup.main(["--inputs", paths["tree.pt"], paths["other.pt"], "--out", paths["soup.pt"], "--model",
                     cfg.name, "--device", "cuda"])
    soup = load_clip_tree(paths["soup.pt"], cfg, device="cuda")
    flat = lambda t: dict(torch.utils._pytree.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b, c = flat(params), flat(other), flat(soup)
    require(set(a) == set(c) and all(torch.equal(c[k], ((a[k].double() + b[k].double()) / 2).float()) for k in a),
            "model_soup: a soup leaf is not the mean of its two ingredients")
    soup_s = time.perf_counter() - t0
    sizes = {k: os.path.getsize(v) for k, v in paths.items()}
    print(f"export tools: convert_checkpoint clip + export round trip of {sizes['vitb16.bin']} bytes bit for bit "
          f"in {convert_s:.1f} s; uniform soup of 2 {cfg.name} trees ({len(c)} leaves, each the mean) in "
          f"{soup_s:.1f} s ({card})", flush=True)
    return {"convert_s": convert_s, "soup_s": soup_s, "bytes": sizes}


def export_phase(model, card: str) -> dict:
    """The port's export ("export") at ViT-B/16 f32 on the served weights:
    the four functions exported at batch 8 on the card (timed), saved; each
    ``.pt2`` under 1% of the parameter bytes; ``EXPORT_FRESH`` loaded in a
    fresh interpreter that imports ``utils/model_export.py`` alone (no model
    code before or after its calls) and run there, the other two run here
    from the programs in memory, every output equal to the eager call's bit
    for bit and the launches equal to its; a CPU-exported
    ``encode_image`` moved to the card, launching K1 and K2; the checkpoint
    tools on ViT-B/16 trees (these two beside the loader); then the eager
    and exported image batch, and K1's and K2's wrapper, op and launcher, in
    CUDA-event ms and in host us to enqueue one call."""
    import os
    import shutil
    import tempfile

    import torch

    from tapclip_tpu_torch.models.model_wrapper import text_features_with_attribution
    from tapclip_tpu_torch.ops.fused_mha import _fused_attn_block_cuda, fused_attn_block
    from tapclip_tpu_torch.ops.fused_mlp import _fused_mlp_cuda, fused_mlp_block
    from tapclip_tpu_torch.utils import model_export as ME

    cfg, pcfg = model.clip_cfg, model.prompt_cfg
    params, trainable, bank = model.clip_params, model.trainable, model.prompt_learner.bank
    B = 8
    gen = torch.Generator(device="cuda").manual_seed(23)
    images = torch.randn((B, cfg.image_size, cfg.image_size, 3), generator=gen, device="cuda")
    tokens = torch.as_tensor(model.tokenizer.tokenize([f"a photo of a {n}." for n in OFFICE_HOME[:B]],
                                                      cfg.context_length), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        text_feats = text_features_with_attribution(params, trainable["ctx"], bank, cfg, pcfg,
                                                    trainable["adjustor"])[0].float()
    inputs = {"params": params, "trainable": trainable, "bank": ME._bank_to_plain(bank), "images": images,
              "tokens": tokens, "text_feats": text_feats, "logit_scale": trainable["logit_scale"],
              "class_mask": bank.class_mask}
    calls = {"encode_image": ("params", "images"), "encode_text": ("params", "tokens"),
             "classify": ("params", "text_feats", "logit_scale", "class_mask", "images"),
             "full_forward": ("params", "trainable", "bank", "images")}
    eager, eager_launches = {}, {}
    for name, keys in calls.items():
        fn = ME._build_fn(name, cfg, pcfg)
        reset_counts()
        with torch.no_grad():
            eager[name] = fn(*(inputs[k] for k in keys))
        torch.cuda.synchronize()
        eager_launches[name] = read_counts()
    _expect("eager encode_image", eager_launches["encode_image"],
            {"fused_mlp": 12, "fused_attn_block": 12, "fused_mha": 0, "fused_attention_aux": 0})

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        out_dir, in_path, out_path, ready = (os.path.join(tmp, n) for n in ("export", "inputs.pt", "outputs.pt",
                                                                             "ready"))
        torch.save(inputs, in_path)
        root = os.path.dirname(os.path.abspath(__file__))
        # The loader imports while this process exports, then loads and runs
        # the programs while this process exports on the CPU and runs the
        # tools (none of which it counts); the timings below wait for it.
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", EXPORT_LOADER, out_dir, in_path, out_path, root,
                                 ",".join(EXPORT_FRESH), ready],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
        try:
            t1 = time.perf_counter()
            exported = ME.export_functions(params, cfg, pcfg, trainable, bank, batch=B, functions=tuple(calls))
            export_s = time.perf_counter() - t1
            ME.save_exported(out_dir, exported, cfg, {"batch": B})
            open(ready, "w").close()
            manifest = ME.load_manifest(out_dir)
            param_bytes = _tree_bytes(params)
            sizes = {name: meta["bytes"] for name, meta in manifest["functions"].items()}
            print(f"export: 4 functions of {cfg.name} f32 at batch {B} exported on the card in {export_s:.1f} s; "
                  f".pt2 bytes {sizes} against {param_bytes} bytes of parameters ({card})", flush=True)
            for name, n in sizes.items():
                require(n < 0.01 * param_bytes, f"export: {name}.pt2 holds {n} bytes, over 1% of the parameters'")
            # The functions the loader leaves out, from the programs in memory.
            here_outputs, here_launches = {}, {}
            for name, keys in calls.items():
                if name in EXPORT_FRESH:
                    continue
                program = ME._Loaded(exported[name].module())
                reset_counts()
                with torch.no_grad():
                    here_outputs[name] = program(*(inputs[k] for k in keys))
                torch.cuda.synchronize()
                here_launches[name] = read_counts()
            # A program exported on the CPU, moved to the card at load time.
            cpu_params = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
            t1 = time.perf_counter()
            cpu_dir = ME.export_model(os.path.join(tmp, "cpu_export"), cpu_params, cfg, batch=B,
                                      functions=("encode_image",))
            cpu_export_s = time.perf_counter() - t1
            require(ME.load_manifest(cpu_dir)["device"] == "cpu", "export: the CPU export names another device")
            moved = ME.load_exported(cpu_dir, device="cuda")["encode_image"]
            reset_counts()
            moved_out = moved(params, images)
            torch.cuda.synchronize()
            moved_launches = read_counts()
            _expect("CPU-exported encode_image on the card", moved_launches,
                    {"fused_mlp": 12, "fused_attn_block": 12, "fused_mha": 0, "fused_attention_aux": 0})
            require(torch.equal(moved_out, eager["encode_image"]),
                    "export: the moved CPU program differs from eager")
            print(f"export: encode_image exported on the CPU in {cpu_export_s:.1f} s, moved to cuda at load: 12 K1 "
                  f"+ 12 K2 launches, equal to the eager call ({card})", flush=True)
            tools = _export_tools(params, cfg, tmp, card)
            _, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        subprocess_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"export: the fresh loader failed:\n{stderr[-3000:]}")
        got = torch.load(out_path, map_location="cuda")
        require(not got["banned_before"] and not got["banned_after"],
                f"export: the loader imported model code or jax: {got['banned_before']} / {got['banned_after']}")
        got["outputs"].update(here_outputs)
        got["launches"].update(here_launches)
        errors, launches = {}, {}
        for name in calls:
            want_leaves = torch.utils._pytree.tree_leaves(eager[name])
            got_leaves = torch.utils._pytree.tree_leaves(got["outputs"][name])
            errors[name] = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got_leaves, want_leaves))
            require(len(got_leaves) == len(want_leaves) and all(
                torch.equal(g, w) for g, w in zip(got_leaves, want_leaves)),
                f"export: exported {name} differs from the eager call by {errors[name]:.3e}")
            for k, n in got["launches"][name].items():
                require(n == eager_launches[name][k],
                        f"export: exported {name} launched {k} {n} times, the eager call {eager_launches[name][k]}")
            for k, n in got["launches"][name].items():
                launches[k] = launches.get(k, 0) + n
        print(f"export: fresh loader (utils.model_export alone, no model code before or after) loaded "
              f"{', '.join(EXPORT_FRESH)} in {got['load_s']:.2f} s ("
              + ", ".join(f"{k} {v:.2f} s" for k, v in got["load_by_fn"].items())
              + f"; the import before, beside the export, {got['import_s']:.2f} s; {subprocess_s:.1f} s with the "
              f"interpreter, the inputs and the calls, beside the export, the CPU export and the tools), the other "
              f"two run from memory; outputs equal to the eager calls bit for bit (max abs diff "
              f"{max(errors.values()):.1e}); launches per function {got['launches']}, as the eager calls ({card})",
              flush=True)

        # The host cost of the op dispatch: the exported and eager image
        # batch, and K1's / K2's wrapper (autograd Function -> launcher, the
        # dispatcher left out by ``_build.run``) and op against the launcher
        # called directly.
        loaded = ME.load_exported(out_dir, functions=("encode_image",))["encode_image"]
        x = torch.randn((B, 200, cfg.vision_width), generator=gen, device="cuda")
        blk = params["visual"]["blocks"][0]
        ln1, ln2, attn, mlp = blk["ln_1"], blk["ln_2"], blk["attn"], blk["mlp"]
        k1 = (x, ln2["scale"], ln2["bias"], mlp["w_fc"], mlp["b_fc"], mlp["w_proj"], mlp["b_proj"], 1e-5)
        k2 = (x, ln1["scale"], ln1["bias"], attn["w_qkv"], attn["b_qkv"], attn["w_out"], attn["b_out"], 12, 197,
              1e-5)
        eager_image = ME._build_fn("encode_image", cfg, pcfg)
        calls = {
            "image_batch8_eager": lambda: eager_image(params, images),
            "image_batch8_exported": lambda: loaded(params, images),
            "k1_wrapper": lambda: fused_mlp_block(x, ln2, mlp),
            "k1_op": lambda: torch.ops.tapclip.fused_mlp.default(*k1),
            "k1_launcher": lambda: _fused_mlp_cuda(*k1),
            "k2_wrapper": lambda: fused_attn_block(x, ln1, attn, 12, valid_len=197),
            "k2_op": lambda: torch.ops.tapclip.attn_block.default(*k2),
            "k2_launcher": lambda: _fused_attn_block_cuda(*k2),
        }
        timing, host, queued = {}, {}, {}
        with torch.no_grad():
            for name, fn in calls.items():
                batch = name.startswith("image")
                timing[name] = time_ms(fn, 20 if batch else 50, 3 if batch else 5)
                # The host's us to enqueue one call on an idle device.
                total, n = 0.0, 20 if batch else 100
                for _ in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    total += time.perf_counter() - t0
                host[name] = total / n * 1e6
                torch.cuda.synchronize()
            # The host's us a call with the device busy: 100 calls enqueued
            # behind a sleeping kernel (at most 400 launches, under the
            # queue's depth), so neither side waits on the other; 5 rounds,
            # the kernels' three routes in turn.
            for _ in range(5):
                for name, fn in calls.items():
                    if name.startswith("image"):
                        continue
                    torch.cuda.synchronize()
                    torch.cuda._sleep(200_000_000)
                    t0 = time.perf_counter()
                    for _ in range(100):
                        fn()
                    queued.setdefault(name, []).append((time.perf_counter() - t0) / 100 * 1e6)
                    torch.cuda.synchronize()
        med = {k: sorted(v)[len(v) // 2] for k, v in queued.items()}
        print("export: ms (CUDA events) " + ", ".join(f"{k}={v:.4f}" for k, v in timing.items())
              + "; host us to enqueue one call on an idle device " + ", ".join(f"{k}={v:.1f}" for k, v in
                                                                             host.items())
              + "; host us a call behind a busy device, median of 5 rounds of 100 (range) "
              + ", ".join(f"{k}={med[k]:.2f} ({min(v):.2f}-{max(v):.2f})" for k, v in queued.items())
              + f"; over the launcher: K1 wrapper {med['k1_wrapper'] - med['k1_launcher']:.2f} us, op "
              f"{med['k1_op'] - med['k1_launcher']:.2f} us; K2 wrapper {med['k2_wrapper'] - med['k2_launcher']:.2f} "
              f"us, op {med['k2_op'] - med['k2_launcher']:.2f} us ({card})", flush=True)
        return {"launches": launches, "eager_launches": eager_launches, "export_s": export_s, "bytes": sizes,
                "param_bytes": param_bytes, "load_s": got["load_s"], "subprocess_s": subprocess_s,
                "cpu_export_s": cpu_export_s, "errors": errors, "timing_ms": timing, "host_us": host,
                "host_us_queued": queued, "import_s": got["import_s"], "load_by_fn": got["load_by_fn"],
                "tools": tools}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gemm_record(pretrained: dict) -> dict:
    """The kernels-line entry of gemm.cu's weight-gradient products: launches
    on the pretraining drive (3 InfoNCE steps), the B5 product h^T.g at the
    batch-32 image shape (6,400 rows) in f32 as the timed case, every case."""
    cases = pretrained["gemm"]["cases"]
    f32 = [c for c in cases if c["dtype"] == "float32"]
    timed = [c for c in f32 if c["shape"].startswith("h^T.g") and c["shape"].endswith("x6400")][0]
    return {
        "name": "gemm_f32", "route": "cuda", "source": "tapclip_tpu_torch/csrc/gemm.cu",
        "replaces": "tapclip_tpu/ops/fused_mha.py:628, tapclip_tpu/ops/fused_mlp.py:119",
        "launches": pretrained["launches"]["gemm_f32"], "max_abs_err": max(c["max_abs_err"] for c in f32),
        "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"], "library_ms": timed["library_ms"], "shape": timed["shape"],
        "mma_bound_ms": timed["mma_bound_ms"], "split": timed["split"],
        "col_sum_launches": pretrained["launches"]["col_sum"], "pretrain_launches": pretrained["launches"]["gemm_f32"],
        "cases": cases, "b4_b5_image_ms": pretrained["gemm"]["halves"],
        "pretrain_step_ms": pretrained["turns_ms"],
        "pretrain_trace": {k: pretrained["trace"][k] for k in ("step_ms_unprofiled", "busy_share_unprofiled",
                                                                "kernels_sum_us") if k in pretrained["trace"]}
        | {"families_us": pretrained["trace"].get("families_us", {}), "gemm_cu_us": pretrained["trace"]["gemm_cu_us"]},
    }


def int8_record(int8_kernels: dict, variants: dict, gemm: dict, launches: dict, b13_bits: dict) -> list:
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
        out[-1].update(launch_ms=c["launch_ms"], rtn_launch_ms=rtn["launch_ms"], bf16_launch_ms=bf["launch_ms"],
                       bf16_rtn_launch_ms=bf_rtn["launch_ms"])
        if name == "int8_attn":
            out[-1].update(mma_bound_ms=c["mma_bound_ms"], bf16_mma_bound_ms=bf["mma_bound_ms"])
        if name == "int8_mlp":
            out[-1].update(bits_equal_walk=b13_bits, in_turns_ms=variants["float32"]["parent"]["ms"],
                           in_turns_launch_ms=variants["float32"]["launch_ms"]["ms"]["parent"])
    for vname, key in (("int8_mlp_erf3", "erf3"), ("int8_mlp_recipmul", "recipmul"),
                       ("int8_mlp_erf3_recipmul", "both")):
        f32, bf16 = variants["float32"], variants["bfloat16"]
        v, b = f32["variants"][key], bf16["variants"][key]
        out.append({"name": vname, "route": "cuda", **INT8_KERNELS[vname], "launches": launches["int8_mlp_variants"],
                    "max_abs_err": v["vs_plain"]["max_abs_err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
                    "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"], "library_ms": None,
                    "shape": f32["shape"], "launch_ms": f32["launch_ms"]["ms"][key],
                    "parent_ms": f32["parent"]["ms"], "parent_launch_ms": f32["launch_ms"]["ms"]["parent"],
                    "ratio": v["ratio"], "vs_parent_rel_err": v["vs_parent"]["rel_err"],
                    "update_rel_err": v["vs_plain"]["update_rel_err"],
                    "bf16_ms": b["ms"], "bf16_launch_ms": bf16["launch_ms"]["ms"][key],
                    "bf16_plain_ms": b["plain_ms"], "bf16_max_abs_err": b["vs_plain"]["max_abs_err"],
                    "bf16_vs_parent_rel_err": b["vs_parent"]["rel_err"],
                    "bf16_update_rel_err": b["vs_plain"]["update_rel_err"], "bf16_bound_ms": bf16["bound_ms"],
                    "bits_equal_walk": {k: d for k, d in variants["bits"].items() if k.endswith(" " + key)}})
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
        for src, kernel, n_regs, spill in ptxas_kernels(log["ptxas_by_source"]):
            print(f"ptxas {src}: {n_regs} registers, {spill} bytes spill stores: {kernel}", flush=True)

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
    b7_bits = phase("B7 bits", check_core_bits, "B7")
    b6_bits = phase("B6 bits", check_core_bits, "B6")
    block_bits = phase("K2 and B4 bits", check_block_bits)
    int8_kernels = phase("int8 kernels", check_int8_kernels)
    b13_bits = phase("B13 bits", check_b13_bits)
    variants = phase("int8 variants", check_int8_variants)
    gemm = phase("int8 gemm", check_int8_gemm)
    ab = phase("ab variants", check_ab_variants)
    print(f"ab variants: {phase_s['ab variants']:.1f} s, on kernels built in {log['seconds']:.1f} s", flush=True)
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
    files = phase("files", files_phase, card)
    evaluated = phase("eval", eval_phase, card)
    adapted = phase("adapt", adapt_phase, card)
    cocoop = phase("cocoop_rn", cocoop_rn_phase, card)
    pretrained = phase("pretrain", pretrain_phase, card)
    moe = phase("moe", moe_phase, card)
    exported = phase("export", export_phase, model, card)

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
            "files_train_launches": launches(files),
            "eval_launches": launches(evaluated),
            "adapt_launches": launches(adapted),
            "cocoop_rn_launches": cocoop["launches"].get(name, 0),
            "pretrain_launches": pretrained["launches"].get(name, 0),
            "moe_launches": moe["launches"].get(name, 0),
            "export_launches": exported["launches"].get(name, 0),
        }
        if name in BACKWARD or name in FLASH[:3]:
            entry.update(max_rel_err=max(c["max_rel_err"] for c in f32_cases),
                         bf16_max_rel_err=max(c["max_rel_err"] for c in bf16_cases))
        if name in BACKWARD:
            entry["ms_dx_only"] = timed["ms_dx_only"]
        if "chain_ms" in timed:  # the flash chain
            entry["chain_ms"] = timed["chain_ms"]
        for key in ("launcher_ms", "launch_ms", "launch_ms_dx_only", "fma_bound_ms", "mma_bound_ms",
                    "bound_dx_only_ms", "mma_bound_dx_only_ms"):
            if key in timed:
                entry[key] = timed[key]
        if name in MMA_KERNELS:  # every timed reading: both dtypes, T 584, T 4096; K1's three shapes
            entry["cases"] = [{key: c[key] for key in CASE_KEYS if key in c}
                              for c in kernels[name]["cases"] if "ms" in c]
        if f"{name} float32" in repairs:  # B7 / B4 past their routing limit
            entry["long_t"] = {dt: repairs[f"{name} {dt}"] for dt in ("float32", "bfloat16")}
        if name in ("fused_mha_bwd", "fused_mha"):
            entry["bits_repeat"] = b7_bits if name == "fused_mha_bwd" else b6_bits
        if name in ("fused_attn_block", "fused_attn_block_bwd"):
            prefix = "K2 " if name == "fused_attn_block" else "B4 "
            entry["bits_unchanged"] = {k[len(prefix):]: v for k, v in block_bits.items() if k.startswith(prefix)}
        if name == "fused_mha":
            entry["fused_split_launches"] = split["launches"][name]
        record.append(entry)
    record.append(gemm_record(pretrained))
    record += int8_record(int8_kernels, variants, gemm, int8_served["float32 stochastic"]["launches"], b13_bits)
    record += ab_record(ab, served["all_launches"])
    for entry in record:  # the int8 kernels' launches on the eval drive (predict --int8, evaluate_adaptive)
        if entry["name"] in ("int8_mlp", "int8_attn"):
            entry["eval_launches"] = evaluated["launches"][entry["name"]]
    print("chip_smoke: phase seconds " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()), flush=True)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
