"""Build the port's CUDA kernels from ``deepspeed_tpu_torch/csrc`` at
first use and load them with ``ctypes``.

Each ``<name>.cu`` compiles on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``build/torch_kernels/<name>-<hash>.so`` under the repository root; the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited kernel rebuilds and an unchanged one loads from disk.  A
library listed in :data:`PARTS` is compiled in pieces instead (its own
source and each part, ``-c``, all started with the other sources) and
linked into one.  The sources expose a plain C interface
(pointers and the stream as ``void*``, each returning the launch's
``cudaError_t``), which keeps a build to seconds: no PyTorch headers.
There is no fallback: a missing ``nvcc`` or a failed build raises.
:func:`scratch` holds the split workspace and counters the GEMM and decode
attention wrappers share.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the flags of one piece of a library in PARTS (an object, linked after)
OBJECT_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)
#: libraries compiled in pieces, started together with the other sources
#: and linked into one: name -> its parts (the log's name for the part, its
#: source in csrc/, its -D flags), beside the library's own source (its C
#: entry points).  The fused decode layer's eight (compute, weight, cache)
#: dtype instances, compiled together, were the whole build's wall.
PARTS = {"fused_decode": tuple(
    (f"fused_decode_layer[{t},{w},{c}]", "fused_decode_layer",
     (f"-DDS_FUSED_BF16={int(t == 'bf16')}",
      f"-DDS_FUSED_W8={int(w == 'int8')}",
      f"-DDS_FUSED_C8={int(c == 'int8')}"))
    for t in ("f32", "bf16") for w in (t, "int8") for c in (t, "int8"))}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel source: build seconds and the compiler's resource report
#: (registers, shared memory, spills), from this process's builds
build_log: Dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of ``nvcc`` (``PATH``, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``); raises when none exists."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "deepspeed_tpu_torch: nvcc not found (searched PATH, $CUDA_HOME/bin "
        "and /usr/local/cuda/bin); the port's CUDA kernels are built from "
        "source at first use and need the CUDA toolkit")


def units(name: str):
    """The compilations of library ``name``: (log name, source, -D flags)
    of its own source, then of each of its :data:`PARTS`."""
    return ((name, name, ()), *PARTS.get(name, ()))


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for _, src, flags in units(name):
        h.update((CSRC_DIR / f"{src}.cu").read_bytes())
        h.update(" ".join(flags).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _run_all(jobs):
    """Start every job's command together, read each one's output as it
    ends (``build_log``: seconds from the start to its own end, and its
    output) -> {tag: message} of the jobs that failed."""
    t0 = time.monotonic()
    procs = [(tag, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for tag, cmd in jobs]

    def finish(tag, p):   # each job's own end, its pipe read as due
        log, _ = p.communicate()
        build_log[tag] = {"seconds": time.monotonic() - t0, "log": log}
    waits = [threading.Thread(target=finish, args=job) for job in procs]
    for t in waits:
        t.start()
    for t in waits:
        t.join()
    return {tag: f"--- {tag} (exit {p.returncode})\n{build_log[tag]['log']}"
            for tag, p in procs if p.returncode != 0}


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel library not yet built, one ``nvcc``
    process per source (per piece for a library in :data:`PARTS`, linked
    once its pieces are done), all started together; returns name ->
    library path.  Raises RuntimeError with the compiler output on
    failure."""
    names = list(names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    tmp = {n: out[n].with_suffix(f".{os.getpid()}.tmp") for n in todo}
    jobs, objects, lib_of = [], {}, {}
    for n in todo:
        if n not in PARTS:
            jobs.append((n, [nvcc, *NVCC_FLAGS, "-o", str(tmp[n]),
                             str(CSRC_DIR / f"{n}.cu")]))
            lib_of[n] = n
            continue
        objects[n] = []
        for i, (tag, src, flags) in enumerate(units(n)):
            obj = tmp[n].with_suffix(f".{i}.o")
            objects[n].append(obj)
            jobs.append((tag, [nvcc, *OBJECT_FLAGS, *flags, "-o", str(obj),
                               str(CSRC_DIR / f"{src}.cu")]))
            lib_of[tag] = n
    failed = _run_all(jobs)
    link = [(f"{n} (link)", [nvcc, "-shared", "-o", str(tmp[n]),
                             *map(str, objs)])
            for n, objs in objects.items()
            if not any(lib_of[t] == n for t in failed)]
    if link:
        failed.update(_run_all(link))
        for tag, _ in link:     # seconds from the build's start
            build_log[tag]["seconds"] = time.monotonic() - t0
            lib_of[tag] = tag[:-len(" (link)")]
    for objs in objects.values():
        for obj in objs:
            obj.unlink(missing_ok=True)
    bad = {lib_of[t] for t in failed}
    for n in todo:
        if n in bad:
            tmp[n].unlink(missing_ok=True)
        else:
            os.replace(tmp[n], out[n])
    if failed:
        raise RuntimeError("deepspeed_tpu_torch: kernel build failed\n"
                           + "\n".join(failed.values()))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def check(rc: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"deepspeed_tpu_torch: {what} launch failed "
                           f"(cudaError_t {rc})")


_workspace = {}


def scratch(device, n_floats: int, n_counters: int):
    """Per-device split-K workspace (fp32 partial tiles) and per-tile
    arrival counters, shared by the split-K kernels (``qgemm``,
    ``ds_ggemm_slots``), the split-sequence decode attention (its chunk
    partials and per-(row, kv head) counters) and the Hopper grouped
    kernels (their work-unit counters): each kernel returns every counter
    to 0, so both are allocated once, grown when a launch needs more, and
    reused in stream order."""
    ws = _workspace.get(device)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_counters:
        nf = max(n_floats, ws[0].numel() if ws else 0)
        nc = max(n_counters, ws[1].numel() if ws else 0)
        ws = (torch.empty(nf, dtype=torch.float32, device=device),
              torch.zeros(nc, dtype=torch.int32, device=device))
        _workspace[device] = ws
    return ws
