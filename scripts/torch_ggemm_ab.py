#!/usr/bin/env python3
"""Same-call A/B of the port's bf16 grouped GEMM kernels (deepspeed_tpu_torch/
csrc/grouped_gemm_hopper.cu: ds_ggemm, ds_ggemm_t, ds_tgmm) against an
earlier commit's (csrc/grouped_gemm.cu's layout_tile kernels) on one GPU.

    python3 scripts/torch_ggemm_ab.py --parent DIR [--reps N]

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``); its grouped_gemm.cu is built with
its own headers into build/torch_kernels/ab/ and launched through a copy
of that commit's wrapper (the same checks, output allocation and C entry
points ds_ggemm / ds_ggemm_t / ds_tgmm); "change" is the checkout's
wrapper, which sends these bf16 shapes to the Hopper kernels.

Shapes: mixtral:1b-moe's training projections (gate/in K 1024, N 3584;
out K 3584, N 1024) at R 16,384 routed rows over 8 experts (random
routing, as the main path's router gives): forward, dx and dW; and
Mixtral-8x7B's prefill forward (K 4096, N 14336, R 1800).  Per shape,
kernel and build: the device time per call (torch.profiler, each call one
kernel, mean over 20 calls; chip_smoke.py's ``device_ms``), median over
``--reps`` rounds, each round running parent, change, change, parent;
the wrapper's host time per call; the outputs against each other and
against the plain versions; and ``torch._grouped_mm`` on the same rows
sorted by expert (device time, context only: the port never calls it).

Prints one JSON line per measurement, then the nvidia-smi line and a
summary line.  Needs a GPU and nvcc; imports nothing of JAX.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

E = 8
#: (name, K, N, R, kernels timed)
SHAPES = (("train_gate_in", 1024, 3584, 16384, ("fwd", "dx", "dw")),
          ("train_out", 3584, 1024, 16384, ("fwd", "dx", "dw")),
          ("prefill_8x7b_gate_in", 4096, 14336, 1800, ("fwd",)))


def parent_calls(torch, gg, lib, x, w, dy, plan):
    """The earlier commit's wrapper on ``lib`` (its checks, which this
    checkout's wrapper keeps, its output allocation and its C entry
    points): the bf16 forward, dx and dW launches of its layout_tile
    kernels."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr, n_int in (("ds_ggemm", 5, 5), ("ds_ggemm_t", 5, 5),
                               ("ds_tgmm", 5, 6)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
        fn.restype = i32

    def launch(name, *args):
        with torch.cuda.device(x.device):
            rc = getattr(lib, name)(
                *args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent {name}: cudaError_t {rc}")

    Mp, K = x.shape
    N = w.shape[2]
    gint = gg._group_ints(plan)
    ints = (plan.block_group_ids.data_ptr(), plan.tile_rows.data_ptr())

    def fwd():
        gg._check_common("ds_ggemm", x, w, gint)
        gg._check_group_fit("ds_ggemm", x, E, plan)
        out = torch.empty((Mp, N), dtype=x.dtype, device=x.device)
        launch("ds_ggemm", x.data_ptr(), w.data_ptr(), *ints, out.data_ptr(),
               plan.num_blocks, K, N, E, 1)
        return out

    def dx():
        gg._check_t("ds_ggemm_t", dy, w, gint)
        gg._check_group_fit("ds_ggemm_t", dy, E, plan)
        out = torch.empty((Mp, K), dtype=x.dtype, device=x.device)
        launch("ds_ggemm_t", dy.data_ptr(), w.data_ptr(), *ints,
               out.data_ptr(), plan.num_blocks, K, N, E, 1)
        return out

    def dw():
        gg._check_tgmm(x, dy, plan, x.dtype)
        gg._check_placed("ds_tgmm", x, (("dy", dy),),
                         (("group_sizes", plan.group_sizes),
                          ("counts", plan.counts)))
        out = torch.empty((E, K, N), dtype=x.dtype, device=x.device)
        launch("ds_tgmm", x.data_ptr(), dy.data_ptr(),
               plan.group_sizes.data_ptr(), plan.counts.data_ptr(),
               out.data_ptr(), Mp, K, N, E, 1, 0)
        return out
    return {"fwd": fwd, "dx": dx, "dw": dw}


def change_calls(gg, x, w, dy, plan):
    return {"fwd": lambda: gg.ggemm_cuda(x, w, plan),
            "dx": lambda: gg.ggemm_t_cuda(dy, w, plan),
            "dw": lambda: gg.tgmm_cuda(x, dy, plan)}


def library_calls(torch, xr, dyr, w, e):
    """torch._grouped_mm on the routed rows sorted by expert (context)."""
    order = torch.argsort(e.long(), stable=True)
    xs, dys = xr[order].contiguous(), dyr[order].contiguous()
    offs = torch.cumsum(torch.bincount(e.long(), minlength=E),
                        0).to(torch.int32)
    wt = w.transpose(-2, -1)
    return {"fwd": lambda: torch._grouped_mm(xs, w, offs=offs),
            "dx": lambda: torch._grouped_mm(dys, wt, offs=offs),
            "dw": lambda: torch._grouped_mm(xs.t(), dys, offs=offs)}


def plain_calls(gg, x, w, dy, plan):
    return {"fwd": lambda: gg.ggemm_plain(x, w, plan),
            "dx": lambda: gg.ggemm_t_plain(dy, w, plan),
            "dw": lambda: gg.tgmm_plain(x, dy, plan)}


def ab(torch, parent_lib, reps):
    from chip_smoke import device_ms, host_ms_per_call, train_routed
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    g = torch.Generator(device="cuda").manual_seed(12)
    dt = torch.bfloat16
    summary = {}
    for name, K, N, R, kernels in SHAPES:
        w = (torch.randn(E, K, N, generator=g, device="cuda")
             * 0.02).to(dt)
        e = train_routed(torch, g, R, E, "random")
        plan = gg.make_group_plan(e, E)
        xr = torch.randn(R, K, generator=g, device="cuda").to(dt)
        dyr = (torch.randn(R, N, generator=g, device="cuda") * 1e-3).to(dt)
        x, dy = gg.scatter_to_groups(xr, plan), gg.scatter_to_groups(dyr,
                                                                     plan)
        calls = {"parent": parent_calls(torch, gg, parent_lib, x, w, dy,
                                        plan),
                 "change": change_calls(gg, x, w, dy, plan)}
        lib = library_calls(torch, xr, dyr, w, e)
        plain = plain_calls(gg, x, w, dy, plan)
        for k in kernels:
            ref = plain[k]()
            got = {b: calls[b][k]() for b in calls}
            torch.cuda.synchronize()
            scale = max(float(ref.float().abs().max()), 1e-30)
            rel = {b: float((t.float() - ref.float()).abs().max()) / scale
                   for b, t in got.items()}
            diff = float((got["change"].float() - got["parent"].float())
                         .abs().max()) / scale
            del ref, got
            times = {"parent": [], "change": []}
            for _ in range(reps):
                for b in ("parent", "change", "change", "parent"):
                    times[b].append(device_ms(torch, [calls[b][k]], reps=20,
                                              one_kernel=True)[0])
            med = {b: statistics.median(t) for b, t in times.items()}
            lib_ms, lib_n = device_ms(torch, [lib[k]], reps=20)
            host = {b: host_ms_per_call(torch, calls[b][k], n=50)
                    for b in ("parent", "change")}
            row = {"shape": name, "kernel": k, "K": K, "N": N, "R": R,
                   "padded_rows": plan.padded_rows, "device_ms": med,
                   "device_ms_all": times, "parent_over_change":
                   med["parent"] / med["change"],
                   "grouped_mm_device_ms": lib_ms,
                   "grouped_mm_kernels_per_call": lib_n,
                   "change_over_grouped_mm": med["change"] / lib_ms,
                   "host_ms": host, "rel_err_vs_plain": rel,
                   "change_vs_parent_rel": diff}
            print(json.dumps(row), flush=True)
            summary[f"{name}.{k}"] = {**med, "grouped_mm": lib_ms,
                                      "host_ms": host}
        del w, x, dy, xr, dyr, calls, lib, plain
        torch.cuda.empty_cache()
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a csrc directory "
                    "holding an earlier grouped_gemm.cu (and its headers)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ggemm_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch_flash_fwd_ab import build_variants
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    parent = build_variants("grouped_gemm", {}, args.parent)["parent"]
    summary = ab(torch, parent, args.reps)
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
