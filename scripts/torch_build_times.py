#!/usr/bin/env python3
"""Build cost of the port's kernel sources against an earlier commit's, on
the machine that builds them.

    python3 scripts/torch_build_times.py --parent DIR

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``).  Every nvcc takes the port's flags
(``build.NVCC_FLAGS``) and writes under build/torch_kernels/times/
(nothing there is loaded).  Readings:
  alone      the block-sparse source (block_sparse_attention.cu) compiled
             alone, the checkout's and DIR's: seconds, and nvcc's own time
             of each phase (``--time``: cicc, ptxas, host compiler) in ms;
  instances  its PTX (``nvcc -ptx``) through ptxas one entry function at a
             time (``ptxas -e``): seconds per kernel instance;
  parts      each compilation of the checkout's libraries built in pieces
             (``build.PARTS``: the fused decode layer's entry source and its
             eight dtype instances) alone, one after another: seconds each;
  build      the whole parallel build, the checkout's (``build.build`` of
             every library chip_smoke.py builds, into a fresh directory)
             and DIR's (each of its sources, all started together): the
             wall and each compilation's seconds to its own end, as
             chip_smoke.py's phase 1 reports them (``build_s``,
             ``build_s_by_source``);
  sass       the flash, decode, fused decode and block-sparse kernels as
             cubins (the fused layer: the checkout's eight instance
             compilations against DIR's one source; the block-sparse
             source's functions with a namesake in DIR's: its backward
             and fp32 kernels), change against DIR: each
             function's SASS (``cuobjdump -sass``) against DIR's function
             of the same name, line for line, with every anonymous
             namespace's name (its hash follows the file, and it shows in
             the names of functions and of the symbols they call) read as
             one token and the columns' padding (it follows the longest
             name) as one space; the functions and lines that differ
             counted.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deepspeed_tpu_torch.ops.kernels import build  # noqa: E402

SOURCE = "block_sparse_attention"
#: the libraries whose machine code must not change with the block-sparse
#: forward or the fused decode layer's split (the block-sparse source's
#: other kernels too)
SASS = ("ds_flash_fwd", "ds_flash_bwd", "decode_attention", "fused_decode",
        "block_sparse_attention")
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


def parts():
    """Each compilation of every library built in pieces, alone."""
    out = {}
    for name in build.PARTS:
        for i, (tag, src, flags) in enumerate(build.units(name)):
            out[tag] = run([build.find_nvcc(), *build.OBJECT_FLAGS, *flags,
                            "-o", str(OUT / f"part-{name}-{i}.o"),
                            str(build.CSRC_DIR / f"{src}.cu")])
    return out


def whole_build_change():
    """``build.build`` of every library chip_smoke.py builds, into a fresh
    directory: its wall and each compilation's seconds."""
    from chip_smoke import KERNEL_SOURCES
    saved = build.BUILD_DIR
    build.BUILD_DIR = OUT / "build-change"
    build.build_log.clear()
    try:
        t0 = time.monotonic()
        build.build(KERNEL_SOURCES)
        wall = time.monotonic() - t0
    finally:
        build.BUILD_DIR = saved
    return {"build_s": wall, "build_s_by_source": {
        n: r["seconds"] for n, r in build.build_log.items()}}


def whole_build_parent(d: Path):
    """Every source of DIR, one nvcc each, all started together."""
    dst = OUT / "build-parent"
    dst.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {src.stem: subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o",
         str(dst / f"{src.stem}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for src in sorted(d.glob("*.cu"))}
    ends = {}

    def wait(item):
        n, p = item
        p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"parent {n}.cu did not build")
        ends[n] = time.monotonic() - t0
    with ThreadPoolExecutor(len(procs)) as ex:
        list(ex.map(wait, procs.items()))
    return {"build_s": time.monotonic() - t0,
            "build_s_by_source": dict(sorted(ends.items(),
                                             key=lambda kv: kv[1]))}


def anon(line: str) -> str:
    """``line`` with each mangled anonymous namespace name (``<n>_GLOBAL__N__
    ...``, n characters) read as ``ANON``."""
    out, i = [], 0
    for m in re.finditer(r"(\d+)(_GLOBAL__N__)", line):
        if m.start() < i:
            continue
        out.append(line[i:m.start()] + "ANON")
        i = m.start(2) + int(m.group(1))
    return "".join(out) + line[i:]


def cubin_sass(src: Path, inc: Path, flags, tag):
    """One source's cubin as SASS: {function name: its body lines}, both
    with anonymous namespaces read as one token (:func:`anon`) and runs of
    spaces as one."""
    cubin = OUT / f"sass-{tag}.cubin"
    run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", *flags, "-I", str(inc), "-cubin", "-o",
         str(cubin), str(src)])
    dump = subprocess.run(
        [str(Path(build.find_nvcc()).with_name("cuobjdump")), "-sass",
         str(cubin)], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for ln in dump.splitlines():
        ln = " ".join(anon(ln).split())
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip()
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(ln)
    return funcs


def sass(name: str, parent: Path):
    """The functions of ``name``'s build and of DIR's, matched by name:
    those with no namesake, those whose SASS differs, and its lines."""
    if name in build.PARTS:
        units = [(src, flags) for _, src, flags in build.units(name)]
    else:
        units = [(name, ())]
    jobs = [(build.CSRC_DIR / f"{src}.cu", build.CSRC_DIR, flags,
             f"{name}-change-{i}") for i, (src, flags) in enumerate(units)]
    # the parent's pieces of the same units (a library built in pieces
    # keeps its kernels in its parts), where DIR has them
    jobs += [(parent / f"{src}.cu", parent, flags, f"{name}-parent-{i}")
             for i, (src, flags) in enumerate(units)
             if (parent / f"{src}.cu").exists()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        dumps = list(ex.map(lambda j: cubin_sass(*j), jobs))
    change = {f: b for d in dumps[:len(units)] for f, b in d.items()}
    par = {f: b for d in dumps[len(units):] for f, b in d.items()}
    differ = {f: sum(x != y for x, y in zip(b, par[f]))
              + abs(len(b) - len(par[f]))
              for f, b in change.items() if f in par and b != par[f]}
    first = next(((x, y) for f in differ
                  for x, y in zip(change[f], par[f]) if x != y), None)
    return {"functions": len(change), "functions_parent": len(par),
            "lines": sum(len(b) for b in change.values()),
            "lines_parent": sum(len(b) for b in par.values()),
            "functions_without_namesake": sorted(set(change) ^ set(par)),
            "functions_differing": len(differ),
            "functions_differing_names": sorted(differ),
            "differing_lines": sum(differ.values()),
            "first_differing_line": first}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier commit's csrc directory")
    args = ap.parse_args()
    parent = Path(args.parent).resolve()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    summary = {}
    for tag, d in (("change", build.CSRC_DIR), ("parent", parent)):
        src = d / f"{SOURCE}.cu"
        a = alone(src, tag)
        i = instances(src, tag)
        per = i["ptxas_s_by_instance"].values()
        summary[f"{SOURCE}_{tag}"] = {
            "alone_s": a["seconds"], **a["phase_ms"], "instances": len(per),
            "ptxas_one_instance_s": [min(per), max(per)]}
        print(json.dumps({"reading": "alone", "tree": tag, **a}), flush=True)
        print(json.dumps({"reading": "instances", "tree": tag, **i}),
              flush=True)
    summary["parts_alone_s"] = parts()
    print(json.dumps({"reading": "parts",
                      "seconds": summary["parts_alone_s"]}), flush=True)
    for tag, fn in (("change", whole_build_change),
                    ("parent", lambda: whole_build_parent(parent))):
        summary[f"build_{tag}"] = fn()
        print(json.dumps({"reading": "build", "tree": tag,
                          **summary[f"build_{tag}"]}), flush=True)
    for name in SASS:
        summary[f"sass_{name}"] = sass(name, parent)
        print(json.dumps({"reading": "sass", "source": name,
                          **summary[f"sass_{name}"]}), flush=True)
    print(json.dumps({"cpus": os.cpu_count()}), flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
