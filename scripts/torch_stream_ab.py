#!/usr/bin/env python3
"""Same-call A/B of the port's streaming int8 expert kernels (deepspeed_tpu_
torch/csrc/grouped_gemm_stream.cu: ds_ggemm_slots_q and ds_ggemm_q under
bf16 rows) against an earlier commit's, on one GPU.

    python3 scripts/torch_stream_ab.py --parent DIR [--reps N] [--sass]

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``); its grouped_gemm.cu and
grouped_gemm_stream.cu are built with its own headers into
build/torch_kernels/ab/ and launched through their C entry points
ds_ggemm_slots_q (the workspace its ds_ggemm_slots_splits asks for) and
ds_ggemm_q_s (the split its own rule gives: ops/kernels/grouped_gemm.py
ggemm_q_stream_splits, unchanged); "change" is the checkout's wrapper, which
sends these bf16 shapes to the streaming kernels.

Shapes: Mixtral-8x7B's expert projections (gate/in K 4096, N 14336; out K
14336, N 4096, 8 experts, codes and scales from block_quantize_int8): the
int8 slot kernel at R 2 (a one-row generate's two routed rows, 2 experts),
R 16 (a decode step of 8 sequences, rows on all 8 experts) and R 128
(random routing), the int8 group kernel at the 96-sequence arm's R 192
(random routing).  Per shape and kernel: the device time per call
(torch.profiler, one kernel a call, mean over 20 calls; chip_smoke.py's
``device_ms``) and CUDA events (chip_smoke.py's ``time_ms``), medians over
``--reps`` rounds of parent, change, change, parent; the bytes bound (codes
and scales of the experts with rows, the rows, the output); the plain
version; ``torch._grouped_mm`` on the same rows sorted by expert against
the dequantized bf16 stack (device time; context only, another function
that reads twice the bytes: the port never calls it); the outputs against
each other and the plain versions; the slot kernel's rows against the
group kernel's for the same rows (bit for bit).  Also the fp32-row slot
form (grouped_gemm.cu, the parity path: the whole K a row) at R 2 and 16,
parent and change.  ``--sass``: the SASS of the sources this change leaves
alone, and of grouped_gemm.cu (where only the fp32-row int8 slot kernel,
``slot_kernel<float, signed char>``, may differ), function by function
against DIR's (scripts/torch_build_times.py ``sass``).

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
SHAPES = tuple((proj, "slots_q", K, N, R)
               for proj, K, N in (("gate_in", 4096, 14336),
                                  ("out", 14336, 4096))
               for R in (2, 16, 128)) + (
    ("gate_in", "q", 4096, 14336, 192), ("out", "q", 14336, 4096, 192))
#: sources whose machine code this change must leave as DIR's
SASS = ("grouped_gemm_hopper", "ds_flash_fwd", "ds_flash_bwd",
        "decode_attention", "block_sparse_attention", "qgemm",
        "quantization", "fused_decode")
#: changed sources whose functions are compared all the same (grouped_gemm:
#: the fp32-row int8 slot kernel alone may differ)
SASS_CHANGED = ("grouped_gemm",)


def parent_entry(libs):
    """The earlier commit's C entry points, typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib, name, n_ptr, n_int, stream in (
            (libs["grouped_gemm"], "ds_ggemm_slots_q", 10, 7, True),
            (libs["grouped_gemm"], "ds_ggemm_slots_splits", 0, 4, False),
            (libs["grouped_gemm_stream"], "ds_ggemm_q_s", 8, 7, True)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr] * stream
        fn.restype = i32
    return libs


def parent_slots_q(torch, libs, x, q, s, plan):
    """The parent's int8 slot launch (its own workspace and counters)."""
    lib = libs["grouped_gemm"]
    R, K = x.shape
    N = q.shape[2]
    bf16 = int(x.dtype == torch.bfloat16)
    nsplit = lib.ds_ggemm_slots_splits(K, N, 1, bf16)
    ws = torch.empty(nsplit * R * N, dtype=torch.float32, device="cuda")
    cnt = torch.zeros(-(-N // 128), dtype=torch.int32, device="cuda")

    def call():
        out = torch.empty((R, N), dtype=x.dtype, device="cuda")
        rc = lib.ds_ggemm_slots_q(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), plan.active.data_ptr(),
            plan.valid.data_ptr(), plan.row_order.data_ptr(),
            plan.slot_offsets.data_ptr(), out.data_ptr(), ws.data_ptr(),
            cnt.data_ptr(), R, K, N, E, plan.num_slots, s.shape[2], bf16,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent ds_ggemm_slots_q: cudaError_t {rc}")
        return out
    return call


def parent_q(torch, gg, libs, x, q, s, plan):
    """The parent's int8 group launch (bf16 rows, its streaming kernel at
    the split rule's K ranges)."""
    lib = libs["grouped_gemm_stream"]
    Mp, K = x.shape
    N = q.shape[2]
    nsplit, kper = gg.ggemm_q_stream_splits(K, N, E, gg._sm_count(x.device))
    ws = torch.empty(max(1, nsplit * Mp * N), dtype=torch.float32,
                     device="cuda")
    cnt = torch.zeros(2 + plan.num_blocks * -(-N // 256), dtype=torch.int32,
                      device="cuda")

    def call():
        out = torch.empty((Mp, N), dtype=x.dtype, device="cuda")
        rc = lib.ds_ggemm_q_s(
            x.data_ptr(), q.data_ptr(), s.data_ptr(),
            plan.block_group_ids.data_ptr(), plan.tile_rows.data_ptr(),
            out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), plan.num_blocks,
            K, N, E, s.shape[2], nsplit, kper,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent ds_ggemm_q_s: cudaError_t {rc}")
        return out
    return call


def grouped_mm(torch, xr, w, e):
    """torch._grouped_mm on the routed rows sorted by expert."""
    order = torch.argsort(e.long(), stable=True)
    xs = xr[order].contiguous()
    offs = torch.cumsum(torch.bincount(e.long(), minlength=E),
                        0).to(torch.int32)
    return lambda: torch._grouped_mm(xs, w, offs=offs)


def routing(torch, g, R):
    """Expert ids of R routed rows: every expert in turn up to 16 rows (a
    decode step's spread), random above."""
    if R <= 16:
        return (torch.arange(R, device="cuda") % E).int()
    return torch.randint(0, E, (R,), generator=g, device="cuda").int()


def ab(torch, parent, reps):
    from chip_smoke import HBM_BPS, device_ms, time_ms
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    from deepspeed_tpu_torch.ops.kernels.quantization import \
        block_quantize_int8
    g = torch.Generator(device="cuda").manual_seed(16)
    dt = torch.bfloat16
    summary = {}
    weights = {}
    for name, kern, K, N, R in SHAPES:
        if name not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            w = (torch.randn(E, K, N, generator=g, device="cuda")
                 * 0.02).to(dt)
            q, s = block_quantize_int8(w)
            del w
            weights[name] = (q, s, gg.dequant_experts(q, s, dt))
        q, s, wdq = weights[name]
        e = routing(torch, g, R)
        xr = torch.randn(R, K, generator=g, device="cuda").to(dt)
        if kern == "slots_q":
            plan = gg.make_slot_plan(e, E)
            calls = {"parent": parent_slots_q(torch, parent, xr, q, s, plan),
                     "change": lambda: gg.ggemm_slots_q_cuda(xr, q, s, plan)}
            plain = gg.ggemm_slots_q_plain(xr, q, s, plan)
            experts = int(plan.valid.sum())
            out_rows = R
        else:
            plan = gg.make_group_plan(e, E)
            x = gg.scatter_to_groups(xr, plan)
            calls = {"parent": parent_q(torch, gg, parent, x, q, s, plan),
                     "change": lambda: gg.ggemm_q_cuda(x, q, s, plan)}
            plain = gg.ggemm_q_plain(x, q, s, plan)
            experts = int((plan.counts > 0).sum())
            out_rows = x.shape[0]
        nbytes = experts * K * (N + s.shape[2] * 4) + R * K * 2 \
            + out_rows * N * 2
        lib = grouped_mm(torch, xr, wdq, e)
        got = {b: c() for b, c in calls.items()}
        torch.cuda.synchronize()
        scale = max(float(plain.float().abs().max()), 1e-30)
        rel = {b: float((t.float() - plain.float()).abs().max()) / scale
               for b, t in got.items()}
        diff = float((got["change"].float() - got["parent"].float())
                     .abs().max()) / scale
        row = {}
        if kern == "slots_q":
            # the same rows through the group kernel: bit for bit
            gp = gg.make_group_plan(e, E)
            rows = gg.gather_from_groups(gg.ggemm_q_cuda(
                gg.scatter_to_groups(xr, gp), q, s, gp), gp)
            row["rows_equal_ds_ggemm_q"] = bool(torch.equal(got["change"],
                                                            rows))
            del rows
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
               "change_over_parent": med["change"] / med["parent"],
               "bound_ms": bound, "bound_by": "bytes",
               "change_over_bound": med["change"] / bound,
               "grouped_mm_device_ms": lib_ms,
               "grouped_mm_kernels_per_call": lib_n,
               "grouped_mm_on": "dequantized bf16 stack",
               "change_over_grouped_mm": med["change"] / lib_ms,
               "rel_err_vs_plain": rel, "change_vs_parent_rel": diff, **row}
        plain = (lambda: gg.ggemm_slots_q_plain(xr, q, s, plan)) \
            if kern == "slots_q" else (lambda: gg.ggemm_q_plain(x, q, s, plan))
        row["plain_ms"] = time_ms(plain, reps=3, inner=2)
        print(json.dumps(row), flush=True)
        summary[f"{kern}.{name}.R{R}"] = {**med, "events": med_ev,
                                          "grouped_mm": lib_ms,
                                          "bound": bound,
                                          "plain": row["plain_ms"],
                                          **({"rows_equal_ds_ggemm_q":
                                              row["rows_equal_ds_ggemm_q"]}
                                             if "rows_equal_ds_ggemm_q" in row
                                             else {})}
        del xr, calls, lib
    weights.clear()
    torch.cuda.empty_cache()
    summary["fp32_slots_q"] = fp32_rows(torch, gg, parent, g)
    return summary


def fp32_rows(torch, gg, parent, g):
    """The fp32-row int8 slot form (the parity path), parent and change:
    device ms at R 2 and 16 at both projections."""
    from chip_smoke import device_ms
    from deepspeed_tpu_torch.ops.kernels.quantization import \
        block_quantize_int8
    out = {}
    for name, K, N in (("gate_in", 4096, 14336), ("out", 14336, 4096)):
        q, s = block_quantize_int8(torch.randn(E, K, N, generator=g,
                                               device="cuda") * 0.02)
        for R in (2, 16):
            e = routing(torch, g, R)
            x = torch.randn(R, K, generator=g, device="cuda")
            plan = gg.make_slot_plan(e, E)
            calls = {"parent": parent_slots_q(torch, parent, x, q, s, plan),
                     "change": lambda: gg.ggemm_slots_q_cuda(x, q, s, plan)}
            t = {b: device_ms(torch, [c], reps=3, one_kernel=True)[0]
                 for b, c in calls.items()}
            row = {"kernel": "ds_ggemm_slots_q", "rows": "fp32",
                   "proj": name, "R": R, "device_ms": t}
            print(json.dumps(row), flush=True)
            out[f"{name}.R{R}"] = t
        del q, s
        torch.cuda.empty_cache()
    return out


def sass_equal(parent_dir):
    """Each SASS source's functions against DIR's namesakes."""
    from torch_build_times import OUT, sass
    OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    for name in SASS + SASS_CHANGED:
        out[name] = sass(name, parent_dir)
        print(json.dumps({"reading": "sass", "source": name,
                          "left_alone": name in SASS, **out[name]}),
              flush=True)
    return {n: r["functions_differing"] for n, r in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a csrc directory "
                    "holding an earlier grouped_gemm.cu and "
                    "grouped_gemm_stream.cu (and their headers)")
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
    parent = parent_entry({
        src: build_variants(src, {}, args.parent)["parent"]
        for src in ("grouped_gemm", "grouped_gemm_stream")})
    summary = ab(torch, parent, args.reps)
    if args.sass:
        summary["sass_functions_differing"] = sass_equal(
            Path(args.parent).resolve())
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
