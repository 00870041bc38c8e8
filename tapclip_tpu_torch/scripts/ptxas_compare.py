"""Compare every kernel's registers and spills between two checkouts of the port.

    python3 tapclip_tpu_torch/scripts/ptxas_compare.py --parent DIR [--root DIR]

Builds the kernels of each checkout (``ops/_build.py``, ``-Xptxas -v``) in a
process of its own, both at once, each into a fresh temporary directory so
that neither load is a cached one, and compares ptxas's report kernel by
kernel: registers, spill stores and spill loads.  Kernel names are demangled
(``c++filt``) and the templates that gained a defaulted parameter are read
under their earlier spellings (``gemm::Epi<T, T>`` as ``Epi<T>``,
``ln_rows_kernel<T, false>`` as ``ln_rows_kernel<T>``, and the int8 row
passes' ``ln_quant_kernel<T, SR, false>`` and ``quant_rows_kernel<SR,
false>`` as ``<T, SR>`` and ``<SR>``).  Prints one JSON
line: the counts of kernels alike, differing and only in one checkout, and
each that differs.  A refactor that must leave the compiled kernels alone
shows none differing.  Needs ``nvcc``, not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

_BUILD = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from tapclip_tpu_torch.ops import _build
with tempfile.TemporaryDirectory() as tmp:
    _build.BUILD_ROOT = Path(tmp)
    _build.library()
    print(json.dumps(_build.build_log["ptxas_by_source"]))
"""


def _demangle(name: str) -> str:
    out = subprocess.run(["c++filt", name], capture_output=True, text=True, check=True).stdout.strip()
    out = re.sub(r"Epi<(float|__nv_bfloat16), \1>", r"Epi<\1>", out)
    out = re.sub(r"(ln_quant_kernel<(?:float|__nv_bfloat16), (?:true|false)), false>", r"\1>", out)
    out = re.sub(r"quant_rows_kernel<(true|false), false>", r"quant_rows_kernel<\1>", out)
    return re.sub(r"ln_rows_kernel<(float|__nv_bfloat16), false>", r"ln_rows_kernel<\1>", out)


def kernels(report: dict) -> dict:
    """(source, demangled kernel) -> (registers, spill stores, spill loads)."""
    out = {}
    for src, log in report.items():
        kernel, spill = None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                kernel, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and kernel:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out[(src, _demangle(kernel))] = (int(m.group(1)),) + spill
                kernel = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    roots = {"parent": str(Path(args.parent).resolve()), "change": str(Path(args.root).resolve())}
    procs = {k: subprocess.Popen([sys.executable, "-c", _BUILD, root], stdout=subprocess.PIPE, text=True)
             for k, root in roots.items()}
    reports = {}
    for k, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            print(f"ptxas_compare: the build of {roots[k]} failed", file=sys.stderr)
            return 1
        reports[k] = kernels(json.loads(out.strip().splitlines()[-1]))
    old, new = reports["parent"], reports["change"]
    both = old.keys() & new.keys()
    differ = sorted(k for k in both if old[k] != new[k])
    print(json.dumps({
        "roots": roots, "alike": len(both) - len(differ), "differ": len(differ),
        "only_parent": sorted(f"{s}: {k}" for s, k in old.keys() - new.keys()),
        "only_change": sorted(f"{s}: {k}" for s, k in new.keys() - old.keys()),
        "differing": [{"source": s, "kernel": k, "parent": old[(s, k)], "change": new[(s, k)]} for s, k in differ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
