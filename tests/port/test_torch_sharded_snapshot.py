"""The sharded snapshot (``--sharded-snapshot``, ``utils/checkpoint.py``) on
the CPU.

One gloo world of 4 ranks is spawned once for the module
(``parallel_ranks.expert_legs`` with the ``"snapshot"`` leg): the MoE
InfoNCE step (4 experts a block) on dp 2 x tp 2 with FSDP takes a step,
every rank writes its shards, and the step after is the uninterrupted one;
the snapshot is then resumed on tp 2 and in one process, each into a fresh
tree and optimizer.  Each resumed tree must be the gathered one bit for bit
(the expert banks come back from pieces cut over ``model`` and ``data`` and
are cut again over ``model`` alone, or not at all), and the next step must
equal the uninterrupted one at ``TRAJ_TOL``.  Beside it, a thread runs
``torchrun --nproc-per-node 2 -m tapclip_tpu_torch.pretrain_cli --dp 2
--fsdp --moe-experts 2 --sharded-snapshot`` for one epoch, resumed for a
second in one process, against one process's two uninterrupted epochs.

In this process: the moments matched by key path (an optimizer whose leaves
come in another order gets each leaf's own moments), the fresh-moments
fallback with its counts, the params tree that does not match, and each
wrong-format resume, by name.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import parallel_ranks as R
from test_torch_expert_parallel import J_MOE, TRAJ_TOL, _assert_tree, _entry

from tapclip_tpu_torch import config as tcfg
from tapclip_tpu_torch import pretrain as tpre
from tapclip_tpu_torch.utils import checkpoint as ckpt_io

torch.set_num_threads(1)

ARGS = ["--preset", "tiny", "--synthetic-data", "--device", "cpu", "--batch-size", "8", "--lr", "1e-4"]


class _Cli:
    """``pretrain_cli`` in a thread, one run after another: torchrun dp 2 +
    FSDP saving a sharded snapshot after epoch 1, that snapshot resumed for
    epoch 2 in one process, and two uninterrupted epochs in one process."""

    def __init__(self, root):
        self.root, self.out, self.procs = root, {}, []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _start(self, name, launcher, extra):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([R.ROOT, os.environ.get("PYTHONPATH", "")]),
                   OMP_NUM_THREADS="1")
        p = subprocess.Popen([sys.executable, *launcher, "-m", "tapclip_tpu_torch.pretrain_cli", *ARGS,
                              "--moe-experts", "2", *extra, "--output-root", str(self.root / name)],
                             env=env, cwd=R.ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.procs.append(p)
        return p

    def _finish(self, name, p):
        try:
            log = p.communicate(timeout=180)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            log = "timeout"
        self.out[name] = (p.returncode, log)
        return p.returncode == 0

    def _run(self):
        straight = self._start("straight", [], ["--epochs", "2"])  # beside the other two
        torchrun = ["-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-port", str(R.free_port())]
        if self._finish("saved", self._start("saved", torchrun, ["--dp", "2", "--fsdp", "--sharded-snapshot",
                                                                 "--save-every", "1", "--epochs", "1"])):
            snap = os.path.join(self.model_dir("saved"), "pretrain_snapshot_e000001")
            self._finish("resumed", self._start("resumed", [], ["--sharded-snapshot", "--epochs", "2",
                                                                "--resume", snap]))
        self._finish("straight", straight)

    def model_dir(self, name):
        (run,) = os.listdir(self.root / name)
        return os.path.join(self.root, name, run, "models")

    def join(self):
        self.thread.join(timeout=400)
        return dict(self.out)

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """``([rank results], cli runs, cli root)``: the ranks and the CLI runs
    go on together; each join has a timeout."""
    d = tmp_path_factory.mktemp("snapshot")
    cli = _Cli(d / "cli")
    procs = []
    try:
        import jax

        from tapclip_tpu.models import clip as jclip

        moe = jclip.init_clip_params(jax.random.PRNGKey(1), J_MOE)
        inp = {"legs": ("snapshot",), "out_dir": str(d), "moe": _entry(J_MOE, moe, np.random.default_rng(0))}
        path = str(d / "inputs.pt")
        torch.save(inp, path)
        procs = R.spawn(4, 1, path, str(d / "ranks"), legs="expert_legs")
        got = R.wait(procs, str(d / "ranks"), timeout=240.0)
        runs = cli.join()
    finally:
        cli.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
    return got, runs, cli


@pytest.mark.parametrize("where", ["tp2", "one"])
def test_resume_on_another_topology_is_bit_for_bit(legs, where):
    """The dp 2 x tp 2 FSDP snapshot (one file a rank, nothing gathered)
    resumed on tp 2 and in one process: the tree is the gathered tree bit
    for bit, the moments the gathered moments bit for bit, the counters
    restored; the next step equals the uninterrupted step at TRAJ_TOL."""
    got = legs[0]
    first = got[0]["snapshot"]["uninterrupted"]
    assert first["files"] == ["manifest.json"] + [f"rank{r}.pt" for r in range(4)]
    assert first["local_bank"] == (2, 32, 256)  # 4 experts over model, dimension 1 over data
    ranks = [r["snapshot"][where] for r in got if where in r["snapshot"]]
    assert len(ranks) == (2 if where == "tp2" else 1)
    for r in ranks:
        assert r["equal"] and r["moments_equal"]
        assert (r["count"], r["epoch"], r["gstep"]) == (1, 1, 1)
        np.testing.assert_allclose(r["loss"], first["loss"], **TRAJ_TOL)
        _assert_tree(r["tree"], first["tree"], steps=1)
    for r in got:  # every rank of the uninterrupted run reads the same loss
        assert r["snapshot"]["uninterrupted"]["loss"] == first["loss"]


def test_pretrain_cli_resumes_a_torchrun_snapshot_in_one_process(legs):
    """``pretrain_cli --sharded-snapshot`` under torchrun (dp 2, FSDP, MoE)
    writes the epoch-1 directory; one process resumes it for epoch 2, whose
    loss and final tree equal two uninterrupted epochs in one process."""
    _, runs, cli = legs
    for name in ("saved", "resumed", "straight"):
        assert runs[name][0] == 0, runs[name][1][-3000:]
    assert "(epoch 1, sharded)" in runs["resumed"][1]
    assert sorted(os.listdir(os.path.join(cli.model_dir("saved"), "pretrain_snapshot_e000001"))) == [
        "manifest.json", "rank0.pt", "rank1.pt"]

    def loss(log):
        return [float(line.rsplit(":", 1)[1]) for line in log.splitlines() if "contrastive loss:" in line]

    np.testing.assert_allclose(loss(runs["resumed"][1]), loss(runs["straight"][1])[1:], **TRAJ_TOL)
    cfg = tcfg.TINY_TEST.replace(moe_experts=2)
    trees = [dict(tpre.named_leaves(ckpt_io.load_clip_tree(os.path.join(cli.model_dir(n), "clip_pretrained.pt"),
                                                           cfg))) for n in ("resumed", "straight")]
    _assert_tree(trees[0], trees[1], steps=2 * 120 // 8)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One process's epoch-1 snapshots of the tiny tree: sharded and whole."""
    from tapclip_tpu_torch import pretrain_cli

    d = tmp_path_factory.mktemp("formats")
    out = {}
    for name, flag in (("sharded", ["--sharded-snapshot"]), ("whole", [])):
        run = pretrain_cli.main([*ARGS, "--epochs", "1", "--save-every", "1", *flag, "--output-root", str(d / name)])
        model_dir = run["paths"]["model_dir"]
        (snap,) = [f for f in os.listdir(model_dir) if f.startswith("pretrain_snapshot")]
        out[name] = (os.path.join(model_dir, snap), run)
    return d, out


def test_moments_are_matched_by_key_path(saved):
    """An optimizer whose leaves come in the reverse order gets each leaf's
    own moments back (matched by key path; by order they would land on
    other leaves), and the params are the saved tree's."""
    from tapclip_tpu_torch.models import clip as clip_model

    _, out = saved
    path, run = out["sharded"]
    assert ckpt_io.snapshot_format(path) == "sharded" and ckpt_io.snapshot_format(out["whole"][0]) == "host"
    tree = clip_model.init_clip_params(torch.Generator().manual_seed(3), tcfg.TINY_TEST)
    leaves = tpre.set_trainable(tree)
    opt = tpre.PretrainOptimizer(list(reversed(leaves)), lr=1e-4, weight_decay=0.1)
    got = ckpt_io.restore_sharded_snapshot(path, ckpt_io.abstract_target(tree), trained=opt.paths)
    want = torch.load(os.path.join(path, "rank0.pt"), weights_only=True)["opt_state"]
    assert list(got["opt_state"]["moments"]) == opt.paths != list(want["moments"])
    for p, st in got["opt_state"]["moments"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], want["moments"][p][k]), (p, k)
    trained = dict(tpre.named_leaves(run["params"]))
    assert all(torch.equal(got["params"][p], t.detach()) for p, t in trained.items())
    assert (got["epoch"], got["gstep"], got["opt_state"]["count"]) == (1, 0, 120 // 8)


def test_fresh_moments_when_the_trained_leaves_differ(saved, capfd):
    """A resume that trains other leaves (the image tower locked) takes the
    params and fresh moments, with a warning that gives the counts."""
    from tapclip_tpu_torch import pretrain_cli

    d, out = saved
    run = pretrain_cli.main([*ARGS, "--epochs", "2", "--sharded-snapshot", "--resume", out["sharded"][0],
                             "--lock-image-tower", "--output-root", str(d / "fresh")])
    assert len(run["loss_history"]) == 1
    n_all = len(tpre.named_leaves(out["sharded"][1]["params"]))
    n_text = n_all - sum(p.startswith("visual/") for p, _ in tpre.named_leaves(out["sharded"][1]["params"]))
    err = capfd.readouterr().err
    assert f"({n_all} moments) does not match this run's {n_text} trained leaves" in err
    assert "FRESH optimizer state" in err


@pytest.mark.parametrize("case", ["whole_with_flag", "sharded_without_flag", "params_drifted", "not_a_snapshot"])
def test_wrong_resumes_exit_by_name(saved, case, tmp_path):
    """A whole ``.pt`` with ``--sharded-snapshot``, a sharded directory
    without it, a sharded snapshot of another params tree (MoE towers now)
    and a directory that is no snapshot: each exits by name."""
    from tapclip_tpu_torch import pretrain_cli

    _, out = saved
    argv, match = {
        "whole_with_flag": (["--sharded-snapshot", "--resume", out["whole"][0]],
                            "host-format snapshot (saved WITHOUT --sharded-snapshot) — resume it without "
                            "--sharded-snapshot"),
        "sharded_without_flag": (["--resume", out["sharded"][0]],
                                 "a sharded snapshot directory (saved WITH --sharded-snapshot) — resume it with "
                                 "--sharded-snapshot"),
        "params_drifted": (["--sharded-snapshot", "--resume", out["sharded"][0], "--moe-experts", "2"],
                           "sharded snapshot does not match this run beyond its optimizer state — the PARAMS tree "
                           "also drifted"),
        "not_a_snapshot": (["--sharded-snapshot", "--resume", str(tmp_path)],
                           "not a readable sharded snapshot directory"),
    }[case]
    with pytest.raises(SystemExit, match=match.replace("(", "[(]").replace(")", "[)]")):
        pretrain_cli.main([*ARGS, "--epochs", "2", *argv, "--output-root", str(tmp_path / "out")])
