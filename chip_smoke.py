"""Drive the PyTorch + CUDA port's serving and training paths once on one NVIDIA GPU.

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
   so must the final context vectors (TRAIN_TOL).  Prints ms per step.

Prints one JSON line of per-kernel results before the last line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

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
# Training, kernel path vs plain path on the same weights and batches:
# relative error of each step's loss and grad norm, and max abs error of the
# final context vectors.  Set from a reading on the same card of 3.6e-7 /
# 2.0e-6 / 3.5e-6 in f32 and 2.6e-4 / 1.7e-2 / 7.5e-3 in bf16 (AdamW moves
# each context element by about lr = 2e-3 a step, whatever the gradient's
# size, so bf16 noise in a small gradient moves ctx by up to that).
TRAIN_TOL = {"float32": {"loss": 5e-6, "grad_norm": 2e-5, "ctx": 5e-5},
             "bfloat16": {"loss": 2e-3, "grad_norm": 1e-1, "ctx": 5e-2}}
TRAIN_CLASSES = ["Backpack", "Alarm_Clock", "Laptop", "Pen", "Mug"]  # bench.py:126

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
}
FORWARD = ("fused_mlp", "fused_attn_block", "fused_attention_aux")
BACKWARD = ("fused_attn_block_bwd", "fused_mlp_bwd")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _counters():
    """Each kernel's launch counter: (wrapper, attribute)."""
    from tapclip_tpu_torch.ops.flash_attention import fused_attention
    from tapclip_tpu_torch.ops.fused_mha import fused_attn_block
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block

    return {
        "fused_mlp": (fused_mlp_block, "launches"),
        "fused_attn_block": (fused_attn_block, "launches"),
        "fused_attention_aux": (fused_attention, "launches"),
        "fused_attn_block_bwd": (fused_attn_block, "bwd_launches"),
        "fused_mlp_bwd": (fused_mlp_block, "bwd_launches"),
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
    from tapclip_tpu_torch.ops.flash_attention import fused_attention
    from tapclip_tpu_torch.ops.fused_mha import attn_block_reference, fused_attn_block
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: {"cases": []} for name in KERNELS}
    f32, bf16 = torch.float32, torch.bfloat16

    def record(name, label, dtype, kern, plain, tol, timed):
        with torch.inference_mode():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if isinstance(got, tuple):  # (out, aux)
                err = compare(f"{name} {label} out", got[0], want[0], tol)
                if got[1] is not None:
                    aux_err = compare(f"{name} {label} aux", got[1], want[1], tol)
                    err = {k: max(err[k], aux_err[k]) for k in err}
            else:
                err = compare(f"{name} {label}", got, want, tol)
            case = {"shape": label, "dtype": str(dtype).replace("torch.", ""), **err}
            if timed:
                case["ms"] = time_ms(kern)
                case["plain_ms"] = time_ms(plain)
        results[name]["cases"].append(case)
        print(f"kernel {name} [{label} {case['dtype']}]: "
              + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in case.items() if k not in ("shape", "dtype")),
              flush=True)

    for dtype, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        # K1: image tower rows B*T = 8*200 at W=768; text rows 8*88 at W=512.
        for label, (B, T, W), timed in (("image 8x200x768", (8, 200, 768), True),
                                        ("text 8x88x512", (8, 88, 512), False)):
            x, ln, mlp = _mlp_case(gen, B, T, W, dtype)
            p = (x, ln["scale"], ln["bias"], mlp["w_fc"], mlp["b_fc"], mlp["w_proj"], mlp["b_proj"])
            record("fused_mlp", label, dtype,
                   lambda: fused_mlp_block(x, ln, mlp, eps=1e-5),
                   lambda: fused_mlp_reference(*p, eps=1e-5), tol, timed)
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
                   lambda: attn_block_reference(*args), tol, timed)
        # K3: attribution pass, 8 classes x 8 heads, T=88 (valid 82, column 81);
        # and ViT-L/14@336 length T=584 with per-row valid/column.
        for label, (B, H, T, valid, eot), timed in (
            ("text 8x8x88 valid82 eot81", (8, 8, 88, 82, 81), True),
            ("long 2x16x584 per-row valid/eot", (2, 16, 584, [577, 300], [576, 17]), False),
        ):
            q, k, v = (torch.randn((B, H, T, 64), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            if isinstance(valid, list):
                valid = torch.tensor(valid, device="cuda")
                eot = torch.tensor(eot, device="cuda")
            record("fused_attention_aux", label, dtype,
                   lambda: fused_attention(q, k, v, kv_valid_len=valid, attn_to_idx=eot),
                   lambda: attention_reference(q, k, v, kv_valid_len=valid, attn_to_idx=eot),
                   tol, timed)
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
                    lambda: fused_mlp_bwd_reference(x, g, *ln, *mlp, 1e-5)),
                "fused_attn_block_bwd": (
                    lambda w=True: _attn_block_bwd_cuda(x, g, *ln, *attn, nh, valid, 1e-5, weight_grads=w),
                    lambda: attn_block_bwd_reference(x, g, *ln, *attn, nh, valid, 1e-5)),
            }
            for name, (kern, plain) in cases.items():
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
                            "plain_ms": time_ms(plain)}
                results[name]["cases"].append(case)
                print(f"backward {name} [{shape} {dname}]: "
                      + ", ".join(f"{k}={v:.4g}" for k, v in case.items() if isinstance(v, float)),
                      flush=True)
                require(rel <= tol and rel_dx <= tol,
                        f"{name} {shape} {dname}: norm-relative error {max(rel, rel_dx):.3e} > {tol}")
    return results


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
    return {"loss": losses, "grad_norm": norms, "pixel_step_ms": step_ms, "pixel_ctx": pixel_ctx,
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
        "ctx": float(max(np.abs(k["pixel_ctx"] - p["pixel_ctx"]).max(),
                         np.abs(k["fit_ctx"] - p["fit_ctx"]).max())),
    }
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
          f"rel err {errs['grad_norm']:.3e} (tol {tol['grad_norm']}), ctx max abs err {errs['ctx']:.3e} "
          f"(tol {tol['ctx']})", flush=True)
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


def main() -> int:
    import torch

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

    kernels = check_kernels()
    kernels.update(check_backward())
    t0 = time.perf_counter()
    model = build_model(VIT_B_16, CLASSES, "cuda", seed=0)
    print(f"serve: built {VIT_B_16.name} (width {VIT_B_16.vision_width}/{VIT_B_16.text_width}, "
          f"{VIT_B_16.vision_layers}+{VIT_B_16.text_layers} layers, {VIT_B_16.dtype}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    served = serve_path(model)
    serve_bf16(model, served["images"], served["served_logits"])
    trained = {dtype: train_phase(model.clip_params, VIT_B_16, dtype) for dtype in ("float32", "bfloat16")}

    record = []
    for name, meta in KERNELS.items():
        f32_cases = [c for c in kernels[name]["cases"] if c["dtype"] == "float32"]
        bf16_cases = [c for c in kernels[name]["cases"] if c["dtype"] == "bfloat16"]
        timed = [c for c in f32_cases if "ms" in c][0]
        bf16_timed = [c for c in bf16_cases if "ms" in c][0]
        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            # The backward kernels' main path is training; the forward ones'
            # is serving (their training-path counts ride along).
            "launches": (trained["float32"] if name in BACKWARD else served)["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in f32_cases),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"], "shape": timed["shape"],
            "bf16_max_abs_err": max(c["max_abs_err"] for c in bf16_cases),
            "bf16_ms": bf16_timed["ms"], "bf16_plain_ms": bf16_timed["plain_ms"],
            "train_launches": trained["float32"]["launches"][name],
        }
        if name in BACKWARD:
            entry.update(max_rel_err=max(c["max_rel_err"] for c in f32_cases),
                         bf16_max_rel_err=max(c["max_rel_err"] for c in bf16_cases),
                         ms_dx_only=timed["ms_dx_only"])
        record.append(entry)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
