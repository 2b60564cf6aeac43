#!/usr/bin/env python3
"""Build cost of the port's block-sparse kernel source
(deepspeed_tpu_torch/csrc/block_sparse_attention.cu) against an earlier
commit's, on the machine that builds it.

    python3 scripts/torch_build_times.py --parent DIR

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``).  For the checkout's source and DIR's,
in turn, each nvcc with the port's flags (``build.NVCC_FLAGS``) into
build/torch_kernels/times/ (nothing there is loaded):
  alone      the source compiled alone: seconds, and nvcc's own time of
             each phase (``--time``: cicc, ptxas, host compiler) in ms;
  instances  its PTX (``nvcc -ptx``) through ptxas one entry function at a
             time (``ptxas -e``): seconds per kernel instance;
  sass       the sources that share device code with it through
             csrc/hopper.cuh (ds_flash_bwd.cu, decode_attention.cu) as
             cubins, change against DIR's: their SASS (``cuobjdump -sass``)
             line for line, the lines that differ counted, those naming a
             function apart (its anonymous namespace's hash follows the
             file's bytes).
chip_smoke.py's phase 1 reports the whole parallel build (``build_s``,
each source's seconds to its own end in ``build_s_by_source``).

Prints one JSON line per reading, then the CPU count and a summary line.
Needs nvcc; no GPU and nothing of JAX.
"""
import argparse
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deepspeed_tpu_torch.ops.kernels import build  # noqa: E402

SOURCE = "block_sparse_attention"
SHARING = ("ds_flash_bwd", "decode_attention")
OUT = build.BUILD_DIR / "times"


def run(cmd):
    """Seconds of one command; raises on failure."""
    t0 = time.monotonic()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({p.returncode}):\n{p.stdout}")
    return time.monotonic() - t0


def alone(src: Path, tag: str):
    """The source alone, with nvcc's time of each phase (ms, summed over
    the phase's steps)."""
    rows_at = OUT / f"alone-{tag}.csv"
    dt = run([build.find_nvcc(), *build.NVCC_FLAGS, "--time", str(rows_at),
              "-o", str(OUT / f"alone-{tag}.so"), str(src)])
    with open(rows_at) as f:
        head, *rows = [[c.strip() for c in r] for r in csv.reader(f) if r]
    i_name, i_ms = head.index("phase name"), head.index("metric")
    phases = {}
    for r in rows:
        name = r[i_name].split(" (")[0]
        phases[name] = phases.get(name, 0.0) + float(r[i_ms])
    return {"seconds": dt, "phase_ms": phases}


def instances(src: Path, tag: str):
    """Each entry function of the source through ptxas on its own."""
    ptx = OUT / f"inst-{tag}.ptx"
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    t_ptx = run([build.find_nvcc(), *flags, "-ptx", "-o", str(ptx),
                 str(src)])
    ptxas = str(Path(build.find_nvcc()).with_name("ptxas"))
    names = re.findall(r"^(?:\.\w+\s+)*\.entry\s+(\S+?)\s*\(",
                       ptx.read_text(), re.M)
    out = {n: run([ptxas, "-arch=sm_90a", "-O3", "-e", n, "-o",
                   str(OUT / f"inst-{tag}.cubin"), str(ptx)])
           for n in names}
    return {"ptx_s": t_ptx, "ptxas_total_s": sum(out.values()),
            "ptxas_s_by_instance": dict(sorted(out.items(),
                                               key=lambda kv: -kv[1]))}


def sass(name: str, trees):
    """SASS lines of ``name`` that differ between the trees' cubins."""
    text = {}
    for tag, d in trees:
        cubin = OUT / f"sass-{name}-{tag}.cubin"
        run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-cubin", "-o", str(cubin),
             str(d / f"{name}.cu")])
        dump = subprocess.run(
            [str(Path(build.find_nvcc()).with_name("cuobjdump")), "-sass",
             str(cubin)], capture_output=True, text=True, check=True).stdout
        text[tag] = dump.splitlines()
    a, b = text.values()
    differ = [i for i in range(max(len(a), len(b)))
              if i >= len(a) or i >= len(b) or a[i] != b[i]]
    named = sum(1 for i in differ if i < len(a) and "Function :" in a[i])
    return {"lines": len(a), "lines_parent": len(b),
            "differing_lines": len(differ), "differing_function_names": named,
            "differing_other_lines": len(differ) - named}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier commit's csrc directory")
    args = ap.parse_args()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    trees = (("change", build.CSRC_DIR), ("parent", Path(args.parent)))
    summary = {}
    for tag, d in trees:
        src = d / f"{SOURCE}.cu"
        a = alone(src, tag)
        i = instances(src, tag)
        per = i["ptxas_s_by_instance"].values()
        summary[tag] = {"alone_s": a["seconds"], **a["phase_ms"],
                        "instances": len(per),
                        "ptxas_one_instance_s": [min(per), max(per)]}
        print(json.dumps({"reading": "alone", "tree": tag, **a}), flush=True)
        print(json.dumps({"reading": "instances", "tree": tag, **i}),
              flush=True)
    for name in SHARING:
        summary[name] = sass(name, trees)
        print(json.dumps({"reading": "sass", "source": name,
                          **summary[name]}), flush=True)
    print(json.dumps({"cpus": os.cpu_count()}), flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
