"""Build the port's CUDA kernels from ``deepspeed_tpu_torch/csrc`` at
first use and load them with ``ctypes``.

Each ``<name>.cu`` compiles on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``build/torch_kernels/<name>-<hash>.so`` under the repository root; the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited kernel rebuilds and an unchanged one loads from disk.  The sources expose a plain C interface
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


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel source not yet built, one ``nvcc``
    process per source, all started together; returns name -> library
    path.  Raises RuntimeError with the compiler output on failure."""
    names = list(names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.monotonic())

    def finish(n, p, t0):   # each source's own end, its pipe read as due
        log, _ = p.communicate()
        build_log[n] = {"seconds": time.monotonic() - t0, "log": log}
    waits = [threading.Thread(target=finish, args=(n, p, t0))
             for n, (_, p, t0) in procs.items()]
    for t in waits:
        t.start()
    for t in waits:
        t.join()
    errors = []
    for n, (tmp, p, _) in procs.items():
        log = build_log[n]["log"]
        if p.returncode != 0:
            errors.append(f"--- {n}.cu (exit {p.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("deepspeed_tpu_torch: kernel build failed\n"
                           + "\n".join(errors))
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
