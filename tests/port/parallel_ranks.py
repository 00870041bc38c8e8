"""The rank side of ``test_torch_parallel.py``: the port's mesh forms run in
gloo process groups.

Each rank is a process of its own (``python parallel_ranks.py LEGS INPUTS
OUT``, with ``torchrun``'s environment: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), one torch thread, importing the port and
never jax.  It reads the inputs the test wrote (the JAX package's trees and
batches as NumPy arrays), runs every leg named in them on its mesh, and
writes its results as NumPy arrays to ``OUT/rank{r}.pt``.  :func:`spawn`
starts a group and :func:`wait` joins it with a timeout, failing on any
rank's non-zero exit code.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
LR_PROMPT, LR_PRE, WD_PRE = 1e-2, 1e-4, 0.1
# The "clip" leg's max norm: far below the tree's gradient norm (about 50), so
# every step clips, and small enough that AdamW's eps (1e-8) is of the order
# of the clipped entries, so the update reads the clip's scale.
GRAD_CLIP = 1e-5
CLASSES = ["Backpack", "Pen", "Mug"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(dp: int, tp: int, inputs: str, out_dir: str, legs: str = "legs"):
    """Start the ``dp x tp`` ranks of one gloo group running ``legs`` on ``inputs``."""
    world = dp * tp
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    os.makedirs(out_dir, exist_ok=True)
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "parallel_ranks.py"), legs, inputs, out_dir,
                              str(dp), str(tp)],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait(procs, out_dir: str, timeout: float = 240.0):
    """Join every rank (one deadline for all); kill the rest and raise on a
    timeout or any non-zero exit code.  Returns each rank's results."""
    deadline = time.monotonic() + timeout
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"rank {procs.index(p)} did not finish in {timeout} s")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(logs))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(len(procs))]


# --- the legs ------------------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _leaves(tree):
    from tapclip_tpu_torch.pretrain import named_leaves

    return {p: _np(t) for p, t in named_leaves(tree)}


def _port_cfg(fields):
    from tapclip_tpu_torch import config as tcfg

    return tcfg.CLIPConfig(**fields)


def _prompt_state(entry):
    from tapclip_tpu_torch.utils.jax_bridge import prompt_state_from_jax

    return prompt_state_from_jax(entry["trainable"], SimpleNamespace(**entry["bank"]))


def _prompt_leg(inp, mesh, key, pcfg, keys=("ctx",), feats=False, steps=2, **extra):
    """Prompt tuning (pixels-in or cached features) on the mesh (None: one
    process on the whole batch): per-step loss and grad_norm, the trained
    leaves after ``steps``."""
    from tapclip_tpu_torch.parallel.sharding import shard_batch, shard_params
    from tapclip_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp[key]
    cfg = _port_cfg(e["cfg"])
    local = params_from_jax(e["tree"], cfg)
    local = local if mesh is None else shard_params(local, mesh)
    trainable, bank = _prompt_state(e)
    opt = _adamw(inp.get(key + "_wd", 0.01))
    state = init_train_state(trainable, opt, keys)
    step = make_train_step(cfg, pcfg, opt, keys, use_image_feats=feats, mesh=mesh, **extra)
    batch = (e["x"], e["labels"], e["mask"])
    x, labels, mask = batch if mesh is None else shard_batch(batch, mesh)
    out = {"loss": [], "grad_norm": [], "metrics": []}
    for _ in range(steps):
        state, m = step(local, state, bank, x, labels, mask)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = {k: _leaves(state.params[k]) if isinstance(state.params[k], dict) else _np(state.params[k])
                     for k in keys}
    if key == "prompt":  # the eval step's counts over data against one process on the whole batch
        from tapclip_tpu_torch.parallel.train_step import make_eval_step

        got = make_eval_step(cfg, pcfg, use_image_feats=feats, mesh=mesh)(local, state.params, bank, x, labels, mask)
        one = make_eval_step(cfg, pcfg, use_image_feats=feats)(
            params_from_jax(e["tree"], cfg), state.params, bank, e["x"], e["labels"], e["mask"])
        out["eval"] = {k: (_np(got[k]), _np(one[k])) for k in ("correct", "total", "per_class_correct",
                                                               "per_class_total")}
    return out


def _adamw(wd):
    import functools

    return functools.partial(torch.optim.AdamW, lr=LR_PROMPT, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)


def _pretrain_leg(inp, mesh, key, loss="infonce", k=1, lock_image=False, steps=2, grad_clip=0.0):
    """A pretraining step on the mesh: per-step loss, the whole tree
    (``gather_params``) after ``steps``, and this rank's local tree."""
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.parallel.sharding import gather_params, shard_batch, shard_micro_batches, shard_params
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp[key]
    cfg = _port_cfg(e["cfg"])
    local = shard_params(params_from_jax(e["tree"], cfg), mesh)
    mask = P.lock_tower_trainable(local, lock_image=True) if lock_image else None
    opt = P.PretrainOptimizer(P.set_trainable(local, mask), lr=LR_PRE, weight_decay=WD_PRE, grad_clip=grad_clip)
    if k > 1:
        step = P.make_accum_pretrain_step(cfg, opt, k, loss=loss, mesh=mesh)
        x, ids = shard_micro_batches((e["x"], e["ids"]), mesh, k)
    else:
        step = P.make_pretrain_step(cfg, opt, loss=loss, mesh=mesh)
        x, ids = shard_batch((e["x"], e["ids"]), mesh)
    losses = [float(step(local, x, ids)["loss"]) for _ in range(steps)]
    return {"loss": losses, "tree": _leaves(gather_params(local, mesh)), "local": _leaves(local)}


def _collectives_leg(inp, mesh):
    """The autograd all-gather and ring shift over ``data``: values and the
    gradients of a weighted sum."""
    from tapclip_tpu_torch.parallel import collectives as C

    g, r = mesh.data_group, mesh.data_index
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2).add(10.0 * r).requires_grad_(True)
    w = torch.linspace(-1.0, 1.0, 6 * mesh.dp).reshape(3 * mesh.dp, 2)
    gathered = C.all_gather(x, g)
    (dx,) = torch.autograd.grad((gathered * w).sum() * (r + 1), [x])
    y = x.detach().clone().requires_grad_(True)
    shifted = C.ring_shift(y, g)
    (dy,) = torch.autograd.grad((shifted * (r + 1)).sum(), [y])
    return {"gathered": _np(gathered), "dx": _np(dx), "shifted": _np(shifted), "dy": _np(dy)}


def _roundtrip_leg(inp, mesh):
    """``shard_params`` then ``gather_params`` of the TINY tree: whether the
    gathered tree is the tree bit for bit, and this rank's block-0 shards."""
    from tapclip_tpu_torch.parallel.sharding import gather_params, shard_params
    from tapclip_tpu_torch.pretrain import named_leaves
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    tree = params_from_jax(inp["infonce"]["tree"], _port_cfg(inp["infonce"]["cfg"]))
    local = shard_params(tree, mesh)
    back = dict(named_leaves(gather_params(local, mesh)))
    equal = all(torch.equal(back[p], t) for p, t in named_leaves(tree)) and len(back) == len(named_leaves(tree))
    blk = local["visual"]["blocks"][0]
    return {"equal": equal, "block0": {f"{sub}/{k}": _np(blk[sub][k]) for sub in ("attn", "mlp") for k in blk[sub]}}


def _global_losses_leg(inp, mesh):
    """InfoNCE and SigLIP over ``data``: this rank's share and the gradients
    of the shares' sum in its rows, the scale and the bias."""
    from tapclip_tpu_torch import pretrain as P

    e = inp["losses"]
    n = e["img"].shape[0] // mesh.dp
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    out = {}
    for loss in ("infonce", "siglip"):
        img = torch.from_numpy(e["img"][rows]).requires_grad_(True)
        txt = torch.from_numpy(e["txt"][rows]).requires_grad_(True)
        scale = torch.tensor(e["scale"]).requires_grad_(True)
        bias = torch.tensor(e["bias"]).requires_grad_(True)
        params = {"logit_scale": scale, "logit_bias": bias}
        share = P.pair_loss(loss, params, img, txt, mesh.data_group)
        grads = torch.autograd.grad(share, [img, txt, scale, bias], allow_unused=True)
        out[loss] = {"share": float(share), "grads": [None if g is None else _np(g) for g in grads]}
    return out


def _peft_distill_leg(inp, mesh):
    """LoRA and distillation steps over ``data`` against the same steps in
    one process on the whole batch (every rank runs both): per-step losses
    and the trained leaves' largest difference."""
    from tapclip_tpu_torch import distill, peft
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.parallel.sharding import shard_batch
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp["infonce"]
    cfg = _port_cfg(e["cfg"])
    out = {}
    for form in ("lora", "distill"):
        runs = {}
        for m in (None, mesh):
            tree = params_from_jax(e["tree"], cfg)
            x, ids = (e["x"], e["ids"]) if m is None else shard_batch((e["x"], e["ids"]), m)
            if form == "lora":
                lora = peft.init_lora_params(torch.Generator().manual_seed(1), tree, rank=2)
                P.set_trainable(tree, {p: False for p, _ in P.named_leaves(tree)})
                opt = P.PretrainOptimizer(P.set_trainable(lora), lr=LR_PRE, weight_decay=WD_PRE)
                step = peft.make_lora_pretrain_step(cfg, opt, mesh=m)
                losses = [float(step(tree, lora, x, ids)["loss"]) for _ in range(2)]
                trained = lora
            else:
                teacher = params_from_jax(e["tree"], cfg)
                student = distill.init_distill_params(torch.Generator().manual_seed(2), tree, cfg.embed_dim,
                                                      cfg.embed_dim)
                opt = P.PretrainOptimizer(P.set_trainable(student), lr=LR_PRE, weight_decay=WD_PRE)
                step = distill.make_distill_step(cfg, cfg, opt, tau=2.0, mesh=m)
                losses = [float(step(student, teacher, x, ids)["loss"]) for _ in range(2)]
                trained = student
            runs[m is None] = (losses, _leaves(trained))
        (one_l, one_t), (mesh_l, mesh_t) = runs[True], runs[False]
        out[form] = {"losses": mesh_l, "one_losses": one_l,
                     "max_diff": max(float(np.abs(mesh_t[p] - one_t[p]).max()) for p in one_t)}
    out["stochastic"] = _stochastic_form(inp, mesh)
    return out


def _stochastic_form(inp, mesh):
    """The InfoNCE step with augment and patch dropout 0.5 on the mesh and
    in one process, each from a generator of one seed: the mesh draws for
    the global batch and keeps its rows, so the losses and trees agree."""
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.data.augment import AugmentConfig
    from tapclip_tpu_torch.parallel.sharding import shard_batch
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp["infonce"]
    cfg = _port_cfg(e["cfg"]).replace(patch_dropout=0.5)
    runs = {}
    for m in (None, mesh):
        tree = params_from_jax(e["tree"], cfg)
        opt = P.PretrainOptimizer(P.set_trainable(tree), lr=LR_PRE, weight_decay=WD_PRE)
        step = P.make_pretrain_step(cfg, opt, augment=AugmentConfig(scale=(0.5, 1.0), hflip=0.5), mesh=m)
        x, ids = (e["x"], e["ids"]) if m is None else shard_batch((e["x"], e["ids"]), m)
        losses = [float(step(tree, x, ids, torch.Generator().manual_seed(s))["loss"]) for s in range(2)]
        runs[m is None] = (losses, _leaves(tree))
    (one_l, one_t), (mesh_l, mesh_t) = runs[True], runs[False]
    return {"losses": mesh_l, "one_losses": one_l,
            "max_diff": max(float(np.abs(mesh_t[p] - one_t[p]).max()) for p in one_t)}


def _grads_leg(inp, mesh):
    """The gradients a mesh InfoNCE / SigLIP step hands its optimizer
    (captured, no update), gathered whole, against the one-process
    gradients of the whole batch's loss: the largest norm-relative error
    over the leaves (``errs``).  (AdamW divides out a constant factor, so
    only the gradients themselves show one: averaging over ``data`` as well
    as the all-gather's backward would halve every leaf's.)  ``norms``: the
    clip's global norm of the local gradients, as the step's optimizer
    reads it, beside the whole batch's gradients' norm."""
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.parallel.sharding import gather_params, map_with_path, shard_batch, shard_params
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    out = {"errs": {}, "norms": {}}
    for loss in ("infonce", "siglip"):
        e = inp[loss]
        cfg = _port_cfg(e["cfg"])
        local = shard_params(params_from_jax(e["tree"], cfg), mesh)
        opt = P.PretrainOptimizer(P.set_trainable(local), lr=LR_PRE, weight_decay=WD_PRE)
        box = {}
        opt.update = lambda grads: box.setdefault("g", dict(zip(opt.paths, grads))) and False
        P.make_pretrain_step(cfg, opt, loss=loss, mesh=mesh)(local, *shard_batch((e["x"], e["ids"]), mesh))
        got = dict(P.named_leaves(gather_params(map_with_path(lambda p, t: box["g"][p], local), mesh)))
        whole = params_from_jax(e["tree"], cfg)
        leaves = P.set_trainable(whole)
        x = torch.as_tensor(e["x"])
        total = P.pair_loss(loss, whole, clip_model.encode_image(whole, cfg, x), clip_model.encode_text(whole, cfg, e["ids"]))
        want = dict(zip([p for p, _ in leaves], torch.autograd.grad(total, [t for _, t in leaves])))
        norm = P.global_norm([box["g"][p] for p in opt.paths], opt.shard_axes, opt.norm_groups)
        out["norms"][loss] = (float(norm), float(P.global_norm(list(want.values()))))
        out["errs"][loss] = max(float((got[p] - w).norm() / w.norm().clamp_min(1e-30)) for p, w in want.items()
                        if float(w.norm()) > 1e-12 and not p.endswith("attn/b_qkv"))
    return out


def _multihost_leg(inp, mesh):
    """``make_multihost_mesh`` with two ranks a node (``LOCAL_WORLD_SIZE``):
    the grid and this rank's place."""
    from tapclip_tpu_torch.parallel.mesh import make_multihost_mesh

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    m = make_multihost_mesh(tp=2)
    return {"grid": m.grid.tolist(), "shape": m.shape, "place": (m.data_index, m.model_index)}


def legs(inp, dp, tp):
    from tapclip_tpu_torch import config as tcfg
    from tapclip_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dp, tp=tp)
    pcfg = tcfg.PromptConfig(max_classes=8)
    run = {
        "collectives": lambda: _collectives_leg(inp, mesh),
        "roundtrip": lambda: _roundtrip_leg(inp, mesh),
        "global_losses": lambda: _global_losses_leg(inp, mesh),
        "peft_distill": lambda: _peft_distill_leg(inp, mesh) if mesh.tp == 1 else None,
        "grads": lambda: _grads_leg(inp, mesh),
        "multihost": lambda: _multihost_leg(inp, mesh) if dp * tp == 4 else None,
        "prompt": lambda: _prompt_leg(inp, mesh, "prompt", pcfg),
        "idiomatic": lambda: _prompt_leg(inp, mesh, "idiomatic", tcfg.PromptConfig(max_classes=8,
                                                                                   text_mode="idiomatic")),
        "anchored": lambda: _prompt_leg(inp, mesh, "anchored", pcfg, feats=True, kg_lambda=0.5,
                                        kg_feats=inp["anchored"]["kg_feats"], prograd_lambda=1.0,
                                        anchor_scale=inp["anchored"]["anchor_scale"], scl_lambda=0.5),
        "maple": lambda: _prompt_leg(inp, mesh, "maple", tcfg.PromptConfig(max_classes=8, maple_depth=2,
                                                                           prompt_len=2), keys=("ctx", "maple")),
        "flagship": lambda: _prompt_leg(inp, mesh, "flagship", pcfg),
        "pallas": lambda: _prompt_leg(inp, mesh, "pallas", pcfg),
        "infonce": lambda: _pretrain_leg(inp, mesh, "infonce"),
        "clip": lambda: _pretrain_leg(inp, mesh, "infonce", grad_clip=GRAD_CLIP),
        "siglip": lambda: _pretrain_leg(inp, mesh, "siglip", loss="siglip"),
        "gradcache": lambda: _pretrain_leg(inp, mesh, "gradcache", k=2),
        "vpt": lambda: _pretrain_leg(inp, mesh, "vpt", lock_image=True),
    }
    return {name: run[name]() for name in inp["legs"]}


# --- the pipe axis, sequence parallelism and FSDP (test_torch_pipeline.py) -----------------------


def _pipe_layers_leg(inp, mesh):
    """``pipeline_transformer_forward`` over pp = 2 for each M of the
    inputs: the output (every stage's) and this stage's blocks' gradients
    of ``sum(y ** 2)``."""
    from tapclip_tpu_torch.parallel.pipeline import pipeline_transformer_forward

    e = inp["pipe_layers"]
    out = {}
    for M in e["micro"]:
        blocks = [{k: {kk: torch.from_numpy(np.asarray(v[kk])).requires_grad_(True) for kk in v} for k, v in blk.items()}
                  for blk in e["blocks"]]
        L, S = len(blocks), mesh.pp
        mine = blocks[mesh.pipe_index * L // S:(mesh.pipe_index + 1) * L // S]
        y, _ = pipeline_transformer_forward(torch.from_numpy(e["x"]), mine, e["heads"], mesh=mesh, n_microbatches=M,
                                            act="gelu")
        leaves = [(f"{mesh.pipe_index * L // S + i}/{k}/{kk}", t) for i, blk in enumerate(mine)
                  for k, v in blk.items() for kk, t in v.items()]
        grads = torch.autograd.grad((y.float() ** 2).sum(), [t for _, t in leaves])
        out[M] = {"y": _np(y), "grads": {p: _np(g) for (p, _), g in zip(leaves, grads)}}
    return out


def _seq_layers_leg(inp, mesh):
    """``layers.transformer_forward(seq_parallel=True)`` over tp = 2 at T 197
    (padded to 198 inside, the pad keys masked) and causal, against the same
    call with no mesh: outputs and the blocks' gradients (whole: the rank's
    heads' cuts gathered)."""
    from tapclip_tpu_torch.models import layers
    from tapclip_tpu_torch.parallel import collectives
    from tapclip_tpu_torch.parallel.sharding import gather_params, shard_params

    e = inp["seq_layers"]
    x = torch.from_numpy(e["x"])
    out = {}
    for causal in (False, True):
        whole = [{k: {kk: torch.from_numpy(np.asarray(v[kk])) for kk in v} for k, v in blk.items()}
                 for blk in e["blocks"]]
        tree = {"visual": {"blocks": whole}}
        local = shard_params(tree, mesh)
        leaves = [t.requires_grad_(True) for _, t in _named(local)]
        with collectives.tensor_parallel(mesh.model_group):
            y, _ = layers.transformer_forward(x, local["visual"]["blocks"], e["heads"], act="gelu", causal=causal,
                                              seq_parallel=True)
        grads = torch.autograd.grad((y.float() ** 2).sum(), leaves)
        gtree = gather_params(_rebuild(local, grads), mesh)
        out[causal] = {"y": _np(y), "grads": {p: _np(g) for p, g in _named(gtree)}}
    return out


def _named(tree):
    from tapclip_tpu_torch.pretrain import named_leaves

    return named_leaves(tree)


def _rebuild(tree, values):
    """``tree``'s structure with its leaves replaced, in ``named_leaves``' order."""
    from tapclip_tpu_torch.parallel.sharding import map_with_path

    index = {p: v for (p, _), v in zip(_named(tree), values)}
    return map_with_path(lambda p, t: index[p], tree)


def _form_leg(inp, mesh, key, pp_microbatches=0, seq_parallel=False, fsdp=False, steps=2, attn_impl=None):
    """A pretraining form on the mesh: per-step loss, the gathered whole tree
    after ``steps``, the first step's gradients (captured on their way to
    the optimizer, gathered whole) against one process's gradients of the
    whole batch (the largest norm-relative error, the key biases aside),
    the clip's global norm as this rank reads it beside the whole batch's,
    and the local leaves' and AdamW moments' shapes."""
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.parallel.sharding import gather_params, map_with_path, shard_batch, shard_params
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp[key]
    cfg = _port_cfg(e["cfg"])
    if attn_impl:
        cfg = cfg.replace(attn_impl=attn_impl)
    local = shard_params(params_from_jax(e["tree"], cfg), mesh, fsdp=fsdp)
    opt = P.PretrainOptimizer(P.set_trainable(local), lr=LR_PRE, weight_decay=WD_PRE)
    step = P.make_pretrain_step(cfg, opt, mesh=mesh, pp_microbatches=pp_microbatches, seq_parallel=seq_parallel,
                                fsdp=fsdp)
    box, update = {}, opt.update

    def record(grads):
        box.setdefault("g", [g.detach().clone() for g in grads])
        return update(grads)

    opt.update = record
    x, ids = shard_batch((e["x"], e["ids"]), mesh)
    losses = [float(step(local, x, ids)["loss"]) for _ in range(steps)]
    got = dict(_named(gather_params(map_with_path(lambda p, t: box["g"][opt.paths.index(p)], local), mesh, fsdp)))
    whole = params_from_jax(e["tree"], cfg)
    leaves = P.set_trainable(whole)
    total = P.pair_loss("infonce", whole, clip_model.encode_image(whole, cfg, torch.as_tensor(e["x"])),
                        clip_model.encode_text(whole, cfg, e["ids"]))
    want = dict(zip([p for p, _ in leaves], torch.autograd.grad(total, [t for _, t in leaves])))
    err = max(float((got[p] - w).norm() / w.norm()) for p, w in want.items()
              if float(w.norm()) > 1e-12 and not p.endswith("attn/b_qkv"))
    norm = float(P.global_norm(box["g"], opt.shard_axes, opt.norm_groups))
    moments = opt.state_dict()["moments"]
    return {"loss": losses, "tree": _leaves(gather_params(local, mesh, fsdp)), "grad_err": err,
            "norms": (norm, float(P.global_norm(list(want.values())))),
            "local_shapes": {p: tuple(t.shape) for p, t in _named(local)},
            "moment_shapes": {p: tuple(m["exp_avg"].shape) for p, m in moments.items()},
            "place": (mesh.data_index, mesh.pipe_index, mesh.model_index)}


def _roundtrip3_leg(inp, mesh):
    """``shard_params`` / ``gather_params`` and ``shard_opt_state`` /
    ``gather_opt_state`` of the TINY tree (moments made from the leaves) on
    the 3-axis mesh, with and without FSDP: whether each gathered tree is
    the whole one bit for bit."""
    from tapclip_tpu_torch.parallel.sharding import gather_opt_state, gather_params, shard_opt_state, shard_params
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    tree = params_from_jax(inp["infonce"]["tree"], _port_cfg(inp["infonce"]["cfg"]))
    whole = dict(_named(tree))
    state = {"count": 3, "mini_step": 0, "acc": {p: t * 3.0 for p, t in whole.items()},
             "moments": {p: {"step": 3.0, "exp_avg": t * 2.0, "exp_avg_sq": t * t} for p, t in whole.items()}}
    out = {}
    for fsdp in (False, True):
        local = shard_params(tree, mesh, fsdp=fsdp)
        back = dict(_named(gather_params(local, mesh, fsdp)))
        st = gather_opt_state(shard_opt_state(state, mesh, fsdp, params=tree), mesh, local, fsdp)
        out[fsdp] = {
            "params": sorted(back) == sorted(whole) and all(torch.equal(back[p], t) for p, t in whole.items()),
            "moments": sorted(st["moments"]) == sorted(whole) and all(
                torch.equal(st["moments"][p][k], state["moments"][p][k]) for p in whole for k in ("exp_avg", "exp_avg_sq")),
            "acc": all(torch.equal(st["acc"][p], state["acc"][p]) for p in whole),
            "local_blocks": len(local["visual"]["blocks"])}
    return out


#: (dp, pp, tp, form options) of each pretraining form of test_torch_pipeline.py
PIPE_FORMS = {
    "dp2": (2, 1, 1, {}),
    "dp2pp2": (2, 2, 1, dict(pp_microbatches=4)),
    "tp2sp": (1, 1, 2, dict(seq_parallel=True)),
    "tp2sp197": (1, 1, 2, dict(seq_parallel=True, key="t197")),
    "pp2tp2sp": (1, 2, 2, dict(pp_microbatches=4, seq_parallel=True)),
    "dp2fsdp": (2, 1, 1, dict(fsdp=True)),
    "dp2tp2fsdp": (2, 1, 2, dict(fsdp=True)),
    "3axis_sp": (2, 2, 2, dict(pp_microbatches=4, seq_parallel=True)),
    "3axis_fsdp": (2, 2, 2, dict(pp_microbatches=4, fsdp=True)),
    "pp2pallas": (1, 2, 1, dict(pp_microbatches=4, attn_impl="pallas")),
}


def pipeline_legs(inp, dp, tp):
    """Every leg of test_torch_pipeline.py, each on the sub-mesh of its size:
    all ranks build each mesh (``new_group`` is collective), the ranks
    without a cell wait, as JAX takes ``devices[:k]``."""
    from tapclip_tpu_torch.parallel.mesh import make_mesh

    def in_grid(m):
        return bool((m.grid == m.rank).any())

    out = {}
    meshes = {}

    def mesh_of(dp, pp, tp):
        if (dp, pp, tp) not in meshes:
            meshes[dp, pp, tp] = make_mesh(dp=dp, tp=tp, pp=pp)
        return meshes[dp, pp, tp]

    m = mesh_of(1, 2, 1)
    if in_grid(m):
        out["pipe_layers"] = _pipe_layers_leg(inp, m)
    m = mesh_of(1, 1, 2)
    if in_grid(m):
        out["seq_layers"] = _seq_layers_leg(inp, m)
    m = mesh_of(2, 2, 2)
    out["roundtrip3"] = _roundtrip3_leg(inp, m)
    for name, (dp_, pp_, tp_, kw) in PIPE_FORMS.items():
        m = mesh_of(dp_, pp_, tp_)
        if in_grid(m):
            kw = dict(kw)
            out[name] = _form_leg(inp, m, kw.pop("key", "infonce"), **kw)
    return out


# --- expert parallelism, LoRA and distillation under tp, VPT-deep under SP, the sharded snapshot ------
# (test_torch_expert_parallel.py and test_torch_sharded_snapshot.py)

#: (dp, tp, options) of each form of test_torch_expert_parallel.py: the input entry, FSDP, SP, GradCache's k,
#: the image lock
EXPERT_FORMS = {
    "moe_tp2": (1, 2, dict(key="moe")),
    "moe_dp2": (2, 1, dict(key="moe")),
    "moe_dp2tp2": (2, 2, dict(key="moe")),
    "moe_dp2fsdp": (2, 1, dict(key="moe", fsdp=True)),
    "moe_tp2sp": (1, 2, dict(key="moe", seq_parallel=True)),
    "moe_gradcache_dp2": (2, 1, dict(key="moe_gc", k=2)),
    "vpt_deep_sp": (1, 2, dict(key="vpt_deep", seq_parallel=True, lock_image=True)),
    "lora_tp2": (1, 2, dict(key="lora")),
    "lora_moe_tp2": (1, 2, dict(key="lora_moe")),
    "distill_tp2": (1, 2, dict(key="distill")),
}
LORA_ALPHA, LORA_RANK = 8.0, 2
DISTILL_KW = dict(tau=2.0, w_task=1.0, w_kd=0.5, w_feat=0.5)


def _expert_form(inp, mesh, key, fsdp=False, seq_parallel=False, k=1, lock_image=False, steps=2):
    """A form of EXPERT_FORMS on ``mesh``, beside the same form in one
    process (mesh None) on the whole batch: per-step losses, the trained
    tree (gathered whole; LoRA's adapters as they are), the local leaves'
    shapes."""
    from tapclip_tpu_torch import distill, peft
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.parallel.sharding import gather_params, shard_batch, shard_micro_batches, shard_params
    from tapclip_tpu_torch.utils.jax_bridge import lora_from_jax, params_from_jax

    e = inp[key]
    cfg = _port_cfg(e["cfg"])
    out = {}
    for m in (mesh, None):
        x, ids = (e["x"], e["ids"]) if m is None else (
            shard_micro_batches((e["x"], e["ids"]), m, k) if k > 1 else shard_batch((e["x"], e["ids"]), m))
        tree = params_from_jax(e["tree"], cfg)
        local = tree if m is None else shard_params(tree, m, fsdp=fsdp)
        if key.startswith("lora"):
            P.set_trainable(local, {p: False for p, _ in P.named_leaves(local)})
            trained = lora_from_jax(e["lora"])
            opt = P.PretrainOptimizer(P.set_trainable(trained), lr=LR_PRE, weight_decay=WD_PRE)
            step = peft.make_lora_pretrain_step(cfg, opt, alpha=LORA_ALPHA, mesh=m)
            losses = [[float(step(local, trained, x, ids)["loss"])] for _ in range(steps)]
            tree_out = _leaves(trained)
        elif key == "distill":
            tcfg = _port_cfg(e["teacher_cfg"])
            teacher = params_from_jax(e["teacher"], tcfg)
            teacher = teacher if m is None else shard_params(teacher, m)
            opt = P.PretrainOptimizer(P.set_trainable(local), lr=LR_PRE, weight_decay=WD_PRE)
            step = distill.make_distill_step(cfg, tcfg, opt, mesh=m, **DISTILL_KW)
            losses = []
            for _ in range(steps):
                r = step(local, teacher, x, ids)
                losses.append([float(r[n]) for n in ("loss", "task", "kd", "feat")])
            tree_out = _leaves(local if m is None else gather_params(local, m))
        else:
            mask = P.lock_tower_trainable(local, lock_image=True) if lock_image else None
            opt = P.PretrainOptimizer(P.set_trainable(local, mask), lr=LR_PRE, weight_decay=WD_PRE)
            if k > 1:
                step = P.make_accum_pretrain_step(cfg, opt, k, mesh=m)
            else:
                step = P.make_pretrain_step(cfg, opt, mesh=m, seq_parallel=seq_parallel and m is not None,
                                            fsdp=fsdp and m is not None)
            losses = [[float(step(local, x, ids)["loss"])] for _ in range(steps)]
            tree_out = _leaves(local if m is None else gather_params(local, m, fsdp and m is not None))
        out["mesh" if m is not None else "one"] = {"loss": losses, "tree": tree_out}
        if m is not None:
            out["local_shapes"] = {p: tuple(t.shape) for p, t in _named(local)}
            out["moment_shapes"] = {p: tuple(v["exp_avg"].shape) for p, v in opt.state_dict()["moments"].items()}
    return out


def _snapshot_leg(inp, meshes, out_dir):
    """The MoE InfoNCE step on dp 2 x tp 2 with FSDP: one step, a sharded
    snapshot (``save_sharded_snapshot``, every rank its shards), the
    gathered tree, a second step.  Then the snapshot resumed on tp 2
    (ranks 0 and 1) and in one process (rank 0), each into a fresh tree
    and optimizer: whether the resumed tree is the gathered one bit for
    bit, its moments equal to the saved ones gathered, and the second step's
    loss and tree."""
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.parallel.sharding import gather_opt_state, gather_params, shard_batch, shard_params
    from tapclip_tpu_torch.utils import checkpoint as ckpt_io
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp["moe"]
    cfg = _port_cfg(e["cfg"])
    snap = os.path.join(out_dir, "snapshot")
    out = {}
    m4 = meshes[2, 2]
    local = shard_params(params_from_jax(e["tree"], cfg), m4, fsdp=True)
    opt = P.PretrainOptimizer(P.set_trainable(local), lr=LR_PRE, weight_decay=WD_PRE)
    step = P.make_pretrain_step(cfg, opt, mesh=m4, fsdp=True)
    x, ids = shard_batch((e["x"], e["ids"]), m4)
    step(local, x, ids)
    ckpt_io.save_sharded_snapshot(snap, params=local, opt_state=opt.state_dict(), epoch=1, gstep=1, mesh=m4,
                                  fsdp=True)
    saved = dict(_named(gather_params(local, m4, True)))
    saved_moments = gather_opt_state(opt.state_dict(), m4, local, True)["moments"]
    loss = float(step(local, x, ids)["loss"])
    out["uninterrupted"] = {"loss": loss, "tree": _leaves(gather_params(local, m4, True)),
                            "files": sorted(os.listdir(snap)),
                            "local_bank": tuple(local["visual"]["blocks"][0]["moe"]["w_fc"].shape)}
    for name, m in (("tp2", meshes[1, 2]), ("one", None)):
        if m is not None and not bool((m.grid == m.rank).any()):
            continue
        if m is None and torch.distributed.get_rank() != 0:
            continue
        tree = params_from_jax(e["tree"], cfg)  # the step-0 tree: every leaf overwritten by the resume
        fresh = tree if m is None else shard_params(tree, m)
        opt2 = P.PretrainOptimizer(P.set_trainable(fresh), lr=LR_PRE, weight_decay=WD_PRE)
        got = ckpt_io.restore_sharded_snapshot(snap, ckpt_io.abstract_target(fresh, m), m, trained=opt2.paths)
        with torch.no_grad():
            for p, t in _named(fresh):
                t.copy_(got["params"][p])
        opt2.load_state_dict(got["opt_state"])
        whole = dict(_named(fresh if m is None else gather_params(fresh, m)))
        st = opt2.state_dict()
        moments = st if m is None else gather_opt_state(st, m, fresh)
        step2 = P.make_pretrain_step(cfg, opt2, mesh=m)
        xb, ib = (e["x"], e["ids"]) if m is None else shard_batch((e["x"], e["ids"]), m)
        out[name] = {
            "equal": sorted(whole) == sorted(saved) and all(torch.equal(whole[p], saved[p]) for p in saved),
            "moments_equal": sorted(moments["moments"]) == sorted(saved_moments) and all(
                torch.equal(moments["moments"][p][k], saved_moments[p][k]) for p in saved_moments
                for k in ("exp_avg", "exp_avg_sq")),
            "count": opt2.count, "epoch": got["epoch"], "gstep": got["gstep"],
            "loss": float(step2(fresh, xb, ib)["loss"]),
            "tree": _leaves(fresh if m is None else gather_params(fresh, m))}
    return out


def expert_legs(inp, dp, tp):
    """Every leg of test_torch_expert_parallel.py (``inp["legs"]``) and
    test_torch_sharded_snapshot.py (``"snapshot"``), each on the sub-mesh
    of its size: every rank builds every mesh, the ranks without a cell
    wait."""
    from tapclip_tpu_torch.parallel.mesh import make_mesh

    meshes = {(d, t): make_mesh(dp=d, tp=t) for d, t in ((1, 2), (2, 1), (2, 2))}
    out = {}
    for name in inp["legs"]:
        if name == "snapshot":
            out[name] = _snapshot_leg(inp, meshes, inp["out_dir"])
            continue
        d, t, kw = EXPERT_FORMS[name]
        m = meshes[d, t]
        if bool((m.grid == m.rank).any()):
            out[name] = _expert_form(inp, m, **kw)
    return out


# --- the int8 tower, token pruning and the RN tower under tp (test_torch_tp_eval.py) -----------------

#: (dp, tp) of each mesh of test_torch_tp_eval.py
TP_EVAL_MESHES = {"tp2": (1, 2), "dp2tp2": (2, 2)}
#: the image-tower forms of the "eval" entry: the config's changes
TP_EVAL_FORMS = {
    "int8": dict(quantize_tower=True, int8_deterministic=True),
    "int8_sr": dict(quantize_tower=True),
    "pruned": dict(token_keep_ratio=0.5, token_prune_layer=1),
    "int8_pruned": dict(quantize_tower=True, int8_deterministic=True, token_keep_ratio=0.5, token_prune_layer=1),
}


def _recording(module, name, box):
    """``module.name`` replaced by a function that appends each result to
    ``box`` (the original returned, to put back)."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        box.append(out)
        return out

    setattr(module, name, spy)
    return orig


def _tower_form(inp, mesh, form):
    """One image-tower form of the "eval" entry on ``mesh`` and in one
    process on this rank's rows: the features (``make_image_encoder(mesh=)``,
    and ``featurize.make_image_embed_fn(mesh=)`` for the stochastic tower),
    pruning's kept indices and scores; for "int8" also the eval step
    (pixels in) with its logits (spied at ``full_model_forward``) and
    counts, the one process's counts over the whole batch beside them."""
    from tapclip_tpu_torch import config as tcfg
    from tapclip_tpu_torch import featurize
    from tapclip_tpu_torch.models import clip as clip_model
    from tapclip_tpu_torch.parallel import train_step as ts
    from tapclip_tpu_torch.parallel.sharding import shard_batch, shard_params
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp["eval"]
    cfg = _port_cfg(e["cfg"]).replace(**TP_EVAL_FORMS[form])
    whole = params_from_jax(e["tree"], cfg)
    local = shard_params(whole, mesh)
    x = shard_batch((e["x"],), mesh)[0]
    out = {}
    for where, params, m in (("mesh", local, mesh), ("one", whole, None)):
        kept, scored = [], []
        undo = [_recording(clip_model, "token_keep_indices", kept), _recording(clip_model, "token_keep_scores", scored)]
        try:
            if form == "int8_sr":
                feats = featurize.make_image_embed_fn(cfg, m)(params, x)
            else:
                feats = ts.make_image_encoder(cfg, m)(params, x)
        finally:
            clip_model.token_keep_indices, clip_model.token_keep_scores = undo
        out[where] = {"feats": _np(feats), "kept": [_np(k) for k in kept], "scores": [_np(t[0]) for t in scored]}
    if form == "int8":
        trainable, bank = _prompt_state(e)
        pcfg = tcfg.PromptConfig(max_classes=8)
        for where, params, m in (("mesh", local, mesh), ("one", whole, None)):
            seen = []
            undo = _recording(ts, "full_model_forward", seen)
            try:
                batch = (e["x"], e["labels"], e["mask"])
                got = ts.make_eval_step(cfg, pcfg, use_image_feats=False, mesh=m)(
                    params, trainable, bank, *(batch if m is None else shard_batch(batch, m)))
            finally:
                ts.full_model_forward = undo
            out[where]["logits"] = _np(seen[0]["logits"])
            out[where]["counts"] = {k: _np(got[k]) for k in ("correct", "total", "per_class_correct",
                                                             "per_class_total")}
    return out


def _int8_seq_form(inp, mesh):
    """The int8 tower's blocks under sequence parallelism on ``mesh``'s
    ``model`` group (each int8 half-block gathers the rank's rows and keeps
    them after), in both modes, against the same blocks in one process."""
    from tapclip_tpu_torch.models import layers
    from tapclip_tpu_torch.parallel.sharding import shard_params
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp["eval"]
    cfg = _port_cfg(e["cfg"])
    whole = params_from_jax(e["tree"], cfg)
    local = shard_params(whole, mesh)
    x = torch.from_numpy(e["seq_x"])
    out = {}
    for det in (False, True):
        kw = dict(act=cfg.act, kv_valid_len=21, quantize=True, quantize_deterministic=det)
        with torch.inference_mode():
            got = layers.transformer_forward(x, local["visual"]["blocks"], cfg.vision_heads, tp_group=mesh.model_group,
                                             seq_parallel=True, **kw)[0]
            want = layers.transformer_forward(x, whole["visual"]["blocks"], cfg.vision_heads, **kw)[0]
        out[det] = {"mesh": _np(got), "one": _np(want)}
    return out


def _rn_infonce(inp, mesh, steps=2):
    """The RN tower's InfoNCE step on ``mesh`` (None: one process on the
    whole batch), every leaf trained: per-step losses, the gathered tree, the
    first step's gradients of the RN leaves (``visual/``, captured on their
    way to the optimizer: a replica's whole, or doubled where a step sums it
    over ``model``), the clip's global norm as the rank reads it, and the
    local shapes of the RN leaves."""
    from tapclip_tpu_torch import pretrain as P
    from tapclip_tpu_torch.parallel.sharding import gather_params, shard_batch, shard_params
    from tapclip_tpu_torch.utils.jax_bridge import params_from_jax

    e = inp["rn_pre"]
    cfg = _port_cfg(e["cfg"])
    local = params_from_jax(e["tree"], cfg)
    local = local if mesh is None else shard_params(local, mesh)
    opt = P.PretrainOptimizer(P.set_trainable(local), lr=LR_PRE, weight_decay=WD_PRE)
    box, update = {}, opt.update

    def record(grads):
        box.setdefault("g", [g.detach().clone() for g in grads])
        return update(grads)

    opt.update = record
    step = P.make_pretrain_step(cfg, opt, mesh=mesh)
    x, ids = (e["x"], e["ids"]) if mesh is None else shard_batch((e["x"], e["ids"]), mesh)
    losses = [float(step(local, x, ids)["loss"]) for _ in range(steps)]
    grads = {p: _np(g) for p, g in zip(opt.paths, box["g"]) if p.startswith("visual/")}
    norm = float(P.global_norm(box["g"], opt.shard_axes, opt.norm_groups)) if mesh is not None else float(
        P.global_norm(box["g"]))
    return {"loss": losses, "tree": _leaves(local if mesh is None else gather_params(local, mesh)),
            "rn_grads": grads, "norm": norm,
            "rn_local_shapes": {p: tuple(t.shape) for p, t in _named(local) if p.startswith("visual/")}}


def tp_eval_legs(inp, dp, tp):
    """Every leg of test_torch_tp_eval.py on each mesh of TP_EVAL_MESHES (the
    ranks without a cell wait): the image-tower forms beside one process on
    the rank's rows, the RN prompt-tune and InfoNCE steps, and on tp 2 the
    int8 blocks under sequence parallelism; then rank 0 alone runs the RN
    steps in one process on the whole batch ("one")."""
    import torch.distributed as dist

    from tapclip_tpu_torch import config as tcfg
    from tapclip_tpu_torch.parallel.mesh import make_mesh

    pcfg = tcfg.PromptConfig(max_classes=8)
    out = {}
    for name, (d, t) in TP_EVAL_MESHES.items():
        m = make_mesh(dp=d, tp=t)
        if not bool((m.grid == m.rank).any()):
            continue
        res = {form: _tower_form(inp, m, form) for form in TP_EVAL_FORMS}
        res["rn_prompt"] = _prompt_leg(inp, m, "rn_prompt", pcfg)
        res["rn_infonce"] = _rn_infonce(inp, m)
        if t > 1 and d == 1:
            res["int8_seq"] = _int8_seq_form(inp, m)
        res["place"] = (m.data_index, m.model_index)
        out[name] = res
    if dist.get_rank() == 0:
        out["one"] = {"rn_prompt": _prompt_leg(inp, None, "rn_prompt", pcfg), "rn_infonce": _rn_infonce(inp, None)}
    return out


def _main(which: str, inputs: str, out_dir: str, dp: str, tp: str) -> None:
    import torch.distributed as dist

    from tapclip_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu")
    try:
        out = globals()[which](torch.load(inputs, weights_only=False), int(dp), int(tp))
        torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:6])
