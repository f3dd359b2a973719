"""Compare the kernels of two source trees: registers, spills and MMA counts.

    python umfa_tpu_torch/utils/sass_compare.py --tree PARENT [--libs LIB,...] [--new-bool]

Builds each library (default flash_fwd, flash_bwd, ring_attn, quant_bwd,
quant_attn_fwd, fused_qattn) of this file's tree and of PARENT (such as a
parent commit unpacked with `git archive`) with this tree's nvcc flags, one
nvcc per source, all at once; reads each kernel's registers and spills from
ptxas -v and counts its HMMA, IMMA and DMMA instructions in its cuobjdump
SASS. Prints a line for every kernel that differs ("DIFF": parent, change),
is new ("NEW") or is gone ("GONE"), then a JSON summary {"same", "differ"}.
Kernel names are demangled. --new-bool: this tree may have added a trailing
bool template parameter; a `false` instantiation whose name the parent
lacks is matched to the parent's name without it.

Needs nvcc (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MMA = ("HMMA", "IMMA", "DMMA")
KEYS = ("registers", "spill_stores", "spill_loads") + tuple(m.lower() for m in MMA)


def ptxas_report(log: str) -> dict:
    """{mangled entry: {registers, spill_stores, spill_loads}} from ptxas -v."""
    res, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            res[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if fn and m:
            res[fn]["spill_stores"], res[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if fn and m:
            res[fn]["registers"] = int(m.group(1))
    return res


def mma_counts(sass: str) -> dict:
    """{mangled function: {"hmma", "imma", "dmma"}}: its tensor-core
    instructions of each kind in the SASS."""
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys((k.lower() for k in MMA), 0)
        elif fn:
            for kind in MMA:
                if kind in ln:
                    counts[fn][kind.lower()] += 1
    return counts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="the parent tree")
    ap.add_argument("--libs",
                    default="flash_fwd,flash_bwd,ring_attn,quant_bwd,quant_attn_fwd,fused_qattn")
    ap.add_argument("--new-bool", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from torch.utils.cpp_extension import CUDA_HOME

    from umfa_tpu_torch import _kernels

    nvcc = _kernels._nvcc()
    trees = {"parent": os.path.abspath(args.tree), "change": HERE}
    tmp = tempfile.mkdtemp()
    procs = {}
    for label, tree in trees.items():
        for lib in args.libs.split(","):
            out = os.path.join(tmp, f"{label}_{lib}.so")
            src = os.path.join(tree, "umfa_tpu_torch", "csrc", f"{lib}.cu")
            procs[(label, lib)] = (subprocess.Popen(
                [nvcc, *_kernels.NVCC_FLAGS, "-o", out, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    kernels = {}
    for (label, lib), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"build failed: {label} {lib}\n{log[-6000:]}")
        report = ptxas_report(log)
        sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", out],
                              capture_output=True, text=True, check=True).stdout
        mma = mma_counts(sass)
        names = subprocess.run(["c++filt"], input="\n".join(report), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        for name, (mangled, res) in zip(names, report.items()):
            short = name.replace("(anonymous namespace)::", "").replace("umfa::", "").split("(")[0]
            counts = mma.get(mangled, dict.fromkeys((k.lower() for k in MMA), -1))
            kernels.setdefault((lib, short), {})[label] = dict(res, **counts)
    if args.new_bool:
        for (lib, short) in list(kernels):
            bare = re.sub(r", (false|\(bool\)0)>$", ">", short)
            v = kernels[(lib, short)]
            if bare != short and "parent" not in v and "parent" in kernels.get((lib, bare), {}):
                kernels[(lib, bare)]["change"] = kernels.pop((lib, short))["change"]
    same = differ = 0
    for (lib, name), v in sorted(kernels.items()):
        p, c = v.get("parent"), v.get("change")
        if p and c:
            ok = all(p.get(k) == c.get(k) for k in KEYS)
            same += ok
            differ += not ok
            if not ok:
                print("DIFF", lib, name, {k: (p.get(k), c.get(k)) for k in KEYS})
        elif c:
            print("NEW ", lib, name, {k: c.get(k) for k in KEYS})
        else:
            print("GONE", lib, name)
    print(json.dumps({"same": same, "differ": differ}))


if __name__ == "__main__":
    main()
