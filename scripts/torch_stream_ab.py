#!/usr/bin/env python3
"""Same-call A/B of the port's streaming expert kernels (deepspeed_tpu_torch/
csrc/grouped_gemm_stream.cu: bf16 ds_ggemm_slots, int8-expert ds_ggemm_q
under bf16 rows) against an earlier commit's (csrc/grouped_gemm.cu's
slot_kernel and ggemm_kernel<bf16, int8>) on one GPU.

    python3 scripts/torch_stream_ab.py --parent DIR [--reps N] [--sass]

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``); its grouped_gemm.cu is built with its
own headers into build/torch_kernels/ab/ and launched through its C entry
points ds_ggemm_slots (the workspace its ds_ggemm_slots_splits asks for)
and ds_ggemm_q; "change" is the checkout's wrapper, which sends these bf16
shapes to the streaming kernels.

Shapes: Mixtral-8x7B's expert projections (gate/in K 4096, N 14336; out K
14336, N 4096, 8 experts): the slot kernel at a decode step of 8
sequences (R 16, rows on all 8 experts), the int8 kernel at the 96-sequence
arm's step (R 192, random routing; codes and scales from
block_quantize_int8).  Per shape and kernel: the device time per call
(torch.profiler, one kernel a call, mean over 20 calls; chip_smoke.py's
``device_ms``) and CUDA events (chip_smoke.py's ``time_ms``), medians over
``--reps`` rounds of parent, change, change, parent; the bytes bound;
``torch._grouped_mm`` on the same rows sorted by expert (the bf16 stack;
for the int8 kernel the dequantized bf16 stack, which reads twice the
bytes; device time, context only: the port never calls it); the outputs
against each other and against the plain versions.  ``--sass``: the SASS of
grouped_gemm.cu (ds_ggemm_slots_q, the fp32 slot and group forms, the int8
group form now off the main path), grouped_gemm_hopper.cu and the other
sources that include csrc/hopper.cuh, function by function against DIR's
(scripts/torch_build_times.py ``sass``).

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
#: (name, kernel, K, N, R)
SHAPES = (("gate_in", "slots", 4096, 14336, 16),
          ("out", "slots", 14336, 4096, 16),
          ("gate_in", "q", 4096, 14336, 192),
          ("out", "q", 14336, 4096, 192))
#: sources whose machine code this change must leave as DIR's
SASS = ("grouped_gemm", "grouped_gemm_hopper", "ds_flash_fwd",
        "ds_flash_bwd", "decode_attention", "block_sparse_attention")


def parent_entry(lib):
    """The earlier commit's C entry points, typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr, n_int, stream in (("ds_ggemm_slots", 9, 6, True),
                                       ("ds_ggemm_q", 6, 6, True),
                                       ("ds_ggemm_slots_splits", 0, 4,
                                        False)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr] * stream
        fn.restype = i32
    return lib


def parent_slots(torch, lib, x, w, plan):
    """The parent's bf16 slot launch (its own workspace and counters)."""
    R, K = x.shape
    N = w.shape[2]
    nsplit = lib.ds_ggemm_slots_splits(K, N, 0, 1)
    ws = torch.empty(nsplit * R * N, dtype=torch.float32, device="cuda")
    cnt = torch.zeros(-(-N // 128), dtype=torch.int32, device="cuda")

    def call():
        out = torch.empty((R, N), dtype=x.dtype, device="cuda")
        rc = lib.ds_ggemm_slots(
            x.data_ptr(), w.data_ptr(), plan.active.data_ptr(),
            plan.valid.data_ptr(), plan.row_order.data_ptr(),
            plan.slot_offsets.data_ptr(), out.data_ptr(), ws.data_ptr(),
            cnt.data_ptr(), R, K, N, E, plan.num_slots, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent ds_ggemm_slots: cudaError_t {rc}")
        return out
    return call


def parent_q(torch, lib, x, q, s, plan):
    """The parent's int8 group launch (bf16 rows)."""
    Mp, K = x.shape
    N = q.shape[2]

    def call():
        out = torch.empty((Mp, N), dtype=x.dtype, device="cuda")
        rc = lib.ds_ggemm_q(
            x.data_ptr(), q.data_ptr(), s.data_ptr(),
            plan.block_group_ids.data_ptr(), plan.tile_rows.data_ptr(),
            out.data_ptr(), plan.num_blocks, K, N, E, s.shape[2], 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent ds_ggemm_q: cudaError_t {rc}")
        return out
    return call


def grouped_mm(torch, xr, w, e):
    """torch._grouped_mm on the routed rows sorted by expert."""
    order = torch.argsort(e.long(), stable=True)
    xs = xr[order].contiguous()
    offs = torch.cumsum(torch.bincount(e.long(), minlength=E),
                        0).to(torch.int32)
    return lambda: torch._grouped_mm(xs, w, offs=offs)


def ab(torch, parent, reps):
    from chip_smoke import HBM_BPS, device_ms, time_ms
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    from deepspeed_tpu_torch.ops.kernels.quantization import \
        block_quantize_int8
    g = torch.Generator(device="cuda").manual_seed(16)
    dt = torch.bfloat16
    summary = {}
    for name, kern, K, N, R in SHAPES:
        w = (torch.randn(E, K, N, generator=g, device="cuda") * 0.02).to(dt)
        xr = torch.randn(R, K, generator=g, device="cuda").to(dt)
        if kern == "slots":
            e = (torch.arange(R, device="cuda") % E).int()
            plan = gg.make_slot_plan(e, E)
            calls = {"parent": parent_slots(torch, parent, xr, w, plan),
                     "change": lambda: gg.ggemm_slots_cuda(xr, w, plan)}
            plain = gg.ggemm_slots_plain(xr, w, plan)
            lib = grouped_mm(torch, xr, w, e)
            experts = int(plan.valid.sum())
            nbytes = experts * K * N * 2 + R * K * 2 + R * N * 2
        else:
            e = torch.randint(0, E, (R,), generator=g, device="cuda").int()
            plan = gg.make_group_plan(e, E)
            x = gg.scatter_to_groups(xr, plan)
            q, s = block_quantize_int8(w)
            wdq = gg.dequant_experts(q, s, dt)
            calls = {"parent": parent_q(torch, parent, x, q, s, plan),
                     "change": lambda: gg.ggemm_q_cuda(x, q, s, plan)}
            plain = gg.ggemm_q_plain(x, q, s, plan)
            lib = grouped_mm(torch, xr, wdq, e)
            experts = int((plan.counts > 0).sum())
            nbytes = experts * K * (N + s.shape[2] * 4) + R * K * 2 \
                + x.shape[0] * N * 2
        got = {b: c() for b, c in calls.items()}
        torch.cuda.synchronize()
        scale = max(float(plain.float().abs().max()), 1e-30)
        rel = {b: float((t.float() - plain.float()).abs().max()) / scale
               for b, t in got.items()}
        diff = float((got["change"].float() - got["parent"].float())
                     .abs().max()) / scale
        del got, plain
        dev = {"parent": [], "change": []}
        ev = {"parent": [], "change": []}
        for _ in range(reps):
            for b in ("parent", "change", "change", "parent"):
                dev[b].append(device_ms(torch, [calls[b]], reps=20,
                                        one_kernel=True)[0])
                ev[b].append(time_ms(calls[b], reps=5, inner=5))
        med = {b: statistics.median(t) for b, t in dev.items()}
        med_ev = {b: statistics.median(t) for b, t in ev.items()}
        lib_ms, lib_n = device_ms(torch, [lib], reps=20)
        bound = nbytes / HBM_BPS * 1e3
        row = {"kernel": f"ds_ggemm_{kern}", "proj": name, "K": K, "N": N,
               "R": R, "experts": experts, "device_ms": med,
               "device_ms_all": dev, "events_ms": med_ev,
               "events_ms_all": ev,
               "parent_over_change": med["parent"] / med["change"],
               "bound_ms": bound, "bound_by": "bytes",
               "change_over_bound": med["change"] / bound,
               "grouped_mm_device_ms": lib_ms,
               "grouped_mm_kernels_per_call": lib_n,
               "grouped_mm_on": "bf16 stack" if kern == "slots"
               else "dequantized bf16 stack",
               "change_over_grouped_mm": med["change"] / lib_ms,
               "rel_err_vs_plain": rel, "change_vs_parent_rel": diff}
        print(json.dumps(row), flush=True)
        summary[f"{kern}.{name}"] = {**med, "events": med_ev,
                                     "grouped_mm": lib_ms, "bound": bound}
        del w, xr, calls, lib
        torch.cuda.empty_cache()
    return summary


def sass_equal(parent_dir):
    """Each SASS source's functions against DIR's namesakes."""
    from torch_build_times import OUT, sass
    OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    for name in SASS:
        out[name] = sass(name, parent_dir)
        print(json.dumps({"reading": "sass", "source": name, **out[name]}),
              flush=True)
    return {n: r["functions_differing"] for n, r in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a csrc directory "
                    "holding an earlier grouped_gemm.cu (and its headers)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", action="store_true",
                    help="also compare the SASS of the unchanged kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_stream_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch_flash_fwd_ab import build_variants
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    parent = parent_entry(build_variants("grouped_gemm", {},
                                         args.parent)["parent"])
    summary = ab(torch, parent, args.reps)
    if args.sass:
        summary["sass_functions_differing"] = sass_equal(
            Path(args.parent).resolve())
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
