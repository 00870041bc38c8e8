"""Where S1's time goes: its seven phases, and the design's alternatives, on the card.

    python3 tapclip_tpu_torch/scripts/fused_layer_phases.py [--variants built,inline,...] [--reps N]

Builds ``csrc/fused_layer.cu`` alone, once per variant, into
``build/fused_layer_phases/<variant>/`` (one ``nvcc`` each, all started
together), with block 0 reading the card's ``%globaltimer`` at the start,
after each of the six grid barriers and after a seventh barrier added at the
end: the differences are the phases' times, each with the wait for the
slowest block (LN1, QKV, attention, out-projection, LN2, fc, proj).  Each
variant is the source as it stands but for one text substitution:

* ``built``: none;
* ``inline``: the phases inlined into the kernel (``__forceinline__``);
* ``one_block``: one block an SM (``__launch_bounds__(256, 1)``: 255
  registers a thread);
* ``f32_wide``: f32 with the bf16 tiles (64 x 64 out-projection and proj,
  64 x 128 fc);
* ``bf16_narrow``: bf16 with the f32 tiles (32 x 64 out-projection and proj,
  64 x 64 fc);
* ``bf16_w3``: bf16 with w_out in three terms (six MMAs a product in the
  out-projection, two of its terms zero).

At ViT-B/16 batch 8, f32 and bf16, each variant's output is held against the
built kernel's (``bit_equal``: the variants change the schedule or add zero
products only, except ``bf16_w3``'s sums), and each is timed with CUDA
events in turns with K2 then K1 (``fused_attn_block`` then
``fused_mlp_block``, the A/B's parent) and the built wrapper.  Prints the
card's name and power limit, each variant's ptxas registers and spills, then
one JSON line per dtype and variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "tapclip_tpu_torch" / "csrc"
OUT = ROOT / "build" / "fused_layer_phases"
PHASES = ("ln1", "qkv", "attention", "out_proj", "ln2", "fc", "proj")
VARIANTS = {
    "built": [],
    "inline": [("__device__ __noinline__", "__device__ __forceinline__")],
    "one_block": [("__launch_bounds__(kThreads, 2) fused_layer_kernel",
                   "__launch_bounds__(kThreads, 1) fused_layer_kernel")],
    "f32_wide": [("kQkvM = 64, kQkvN = 128, kOutM = 32, kOutN = 64, kFcM = 64, kFcN = 64, kProjM = 32,",
                  "kQkvM = 64, kQkvN = 128, kOutM = 64, kOutN = 64, kFcM = 64, kFcN = 128, kProjM = 64,")],
    "bf16_narrow": [("kQkvM = 64, kQkvN = 128, kOutM = 64, kOutN = 64, kFcM = 64, kFcN = 128, kProjM = 64,",
                     "kQkvM = 64, kQkvN = 128, kOutM = 32, kOutN = 64, kFcM = 64, kFcN = 64, kProjM = 32,")],
    "bf16_w3": [("static constexpr int kOutWTerms = 1;", "static constexpr int kOutWTerms = mma::kF32Terms;")],
}
STAMP = ('if (blockIdx.x == 0 && threadIdx.x == 0) {{ unsigned long long t_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_stamps[{k}] = t_; }}')


def stamped_source(subs) -> str:
    """fused_layer.cu with the substitutions and the timer reads."""
    s = (CSRC / "fused_layer.cu").read_text()
    for old, new in subs:
        if old not in s:
            raise ValueError(f"fused_layer.cu no longer holds {old!r}")
        s = s.replace(old, new)
    s = s.replace("namespace {\n", "__device__ unsigned long long g_stamps[8];\n\nnamespace {\n", 1)
    start = s.index("fused_layer_kernel(LayerArgs<T> a) {")
    end = s.index("cudaError_t max_grid", start)
    body = s[start:end]
    body = body.replace("auto grid = cooperative_groups::this_grid();",
                        "auto grid = cooperative_groups::this_grid();\n  " + STAMP.format(k=0), 1)
    n = iter(range(1, 7))
    body = re.sub(r"grid\.sync\(\);", lambda m: m.group(0) + "\n  " + STAMP.format(k=next(n)), body)
    close = body.rindex("}\n\ntemplate")
    body = body[:close] + "  grid.sync();\n  " + STAMP.format(k=7) + "\n" + body[close:]
    return (s[:start] + body + s[end:] + '\nextern "C" int tapclip_layer_stamps(unsigned long long* out) {\n'
            '  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n')


def start_builds(names) -> dict:
    """One nvcc per variant, all started together: name -> process."""
    from tapclip_tpu_torch.ops import _build

    procs = {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        src = d / "fused_layer.cu"
        src.write_text(stamped_source(VARIANTS[name]))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(d / "lib.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def finish_builds(procs) -> dict:
    """name -> (ctypes library, ptxas: each kernel's registers, and the spill
    stores and loads of every function in the file)."""
    from tapclip_tpu_torch.ops import _build

    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.tapclip_fused_layer.argtypes = list(_build._SIGNATURES["tapclip_fused_layer"])
        lib.tapclip_fused_layer_max_grid.argtypes = list(_build._SIGNATURES["tapclip_fused_layer_max_grid"])
        lib.tapclip_layer_stamps.argtypes = [ctypes.c_void_p]
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        out[name] = (lib, {"registers": [int(r) for r in re.findall(r"Used (\d+) registers", log)],
                           "spill_stores": sum(int(s) for s, _ in spills),
                           "spill_loads": sum(int(v) for _, v in spills)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_layer_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from tapclip_tpu_torch.ops import _build
    from tapclip_tpu_torch.ops.fused_layer import fused_layer
    from tapclip_tpu_torch.ops.fused_mha import fused_attn_block
    from tapclip_tpu_torch.ops.fused_mlp import fused_mlp_block
    from tapclip_tpu_torch.scripts._bench_util import card_line, time_ms, vit_layer, vit_shape

    procs = start_builds(args.variants.split(","))
    _build.library()  # the port's own kernels, built meanwhile
    libs = finish_builds(procs)
    print(card_line(), flush=True)
    for name, (_, ptxas) in libs.items():
        print(f"ptxas {name}: {json.dumps(ptxas)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, valid, _, heads, _ = vit_shape("ViT-B-16")
    real = _build.library
    for dtype in (torch.float32, torch.bfloat16):
        x, ln1, attn, ln2, mlp = vit_layer(8, "ViT-B-16", dtype, "cuda", 0)

        def layer(lib=None):
            if lib is not None:
                _build.library = lambda: lib
            try:
                return fused_layer(x, ln1, attn, ln2, mlp, heads, valid)
            finally:
                _build.library = real

        calls = {"parent": lambda: fused_mlp_block(fused_attn_block(x, ln1, attn, heads, valid_len=valid), ln2, mlp),
                 "wrapper": layer}
        calls.update({name: (lambda lib=lib: layer(lib)) for name, (lib, _) in libs.items()})
        rows = {}
        with torch.inference_mode():
            want = layer()
            for name, (lib, _) in libs.items():
                got = layer(lib)
                torch.cuda.synchronize()
                st = (ctypes.c_ulonglong * 8)()
                lib.tapclip_layer_stamps(ctypes.addressof(st))
                rows[name] = {"bit_equal": bool(torch.equal(got, want)),
                              "grid": lib.tapclip_fused_layer_max_grid(x.shape[1], x.shape[2],
                                                                       _build.dtype_code(dtype)),
                              "phases_us": dict(zip(PHASES, ((st[i + 1] - st[i]) / 1e3 for i in range(7))))}
            reps = {name: [] for name in calls}
            for _ in range(args.reps):
                for name, fn in calls.items():
                    reps[name].append(time_ms(fn, 10, 2))
        for name in calls:
            row = rows.setdefault(name, {})
            row.update(ms=statistics.median(reps[name]), ms_reps=reps[name])
            print(json.dumps({"dtype": str(dtype).replace("torch.", ""), "variant": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
