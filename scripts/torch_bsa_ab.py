#!/usr/bin/env python3
"""Same-call A/B of the port's bf16 block-sparse kernels (the forward, dQ
and dK/dV of deepspeed_tpu_torch/csrc/block_sparse_attention.cu) against
an earlier commit's on one GPU.

    python3 scripts/torch_bsa_ab.py --parent DIR [--reps N]

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``); its block_sparse_attention.cu is
built with its own headers into build/torch_kernels/ab/ and launched
through a copy of that commit's wrappers (the same checks and output
allocation): its bf16 forward ``bsa_fwd`` over the plan's idx / cnt /
order arrays (the trailing is_bf16 argument set), its dQ and dK/dV
``bsa_dq_h`` / ``bsa_dkv_h`` over the same tile plan and workspace as the
checkout's; "change" is the checkout's wrappers on the checkout's build.

At chip_smoke.py phase 27d's shape (B 1, S 16384, H 16, hd 96, bf16,
causal), for the Fixed (block 16) and BigBird (block 64) path layouts:
each kernel's time by CUDA events (chip_smoke.py ``time_ms``) and by
device time (torch.profiler, one kernel a call, ``device_ms``), median
over ``--reps`` rounds of parent, change, change, parent; SDPA with the
layout expanded to a boolean [S, S] mask, its forward and its backward
(forward + backward less forward), by events and by profiler windows that
saw every kernel (context only, the port never calls it); the port's
dense causal flash forward and backward pair at the same shape
(``ds_flash_fwd.cu``, ``ds_flash_bwd.cu``; events and device time); the
bounds (chip_smoke.py ``sparse_bound``, ``attn_bound``); the change's
tile plans (fill per side); and both builds' outputs against the plain
versions and against each other.

Prints one JSON line per layout, then the nvidia-smi line and a summary
line.  Needs a GPU and nvcc; imports nothing of JAX.
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

from chip_smoke import (SP_B, SP_H, SP_HD, SP_S, attn_bound,  # noqa: E402
                        device_ms, path_errs, sparse_bound,
                        sparse_path_configs, tile_plan_report, time_ms,
                        whole_device_ms)

ORDER = ("parent", "change", "change", "parent")
KERNELS = ("fwd", "dq", "dkv")


def parent_calls(torch, bs, lib):
    """A copy of the earlier commit's bf16 wrappers on ``lib``: the
    forward's C entry point (8 pointers, 6 ints, the strides, causal, the
    scale, is_bf16 and the stream) over the plan's lists, and the dQ and
    dK/dV entry points over the tile plan (the checkout's argument
    types)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsa_fwd.argtypes = [p] * 8 + [i] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), i, ctypes.c_float, i, p]
    for name in ("bsa_dq_h", "bsa_dkv_h"):
        getattr(lib, name).argtypes = bs._ARGTYPES[name] + [p]
    for name in ("bsa_fwd", "bsa_dq_h", "bsa_dkv_h"):
        getattr(lib, name).restype = ctypes.c_int

    def stream(q):
        return torch.cuda.current_stream(q.device).cuda_stream

    def check(rc, name):
        if rc != 0:
            raise RuntimeError(f"parent {name}: cudaError_t {rc}")

    def fwd(q, k, v, plan, sm_scale=None):
        B, S, H, hd, block = bs._check_cuda(q, k, v, plan)
        o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            check(lib.bsa_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), plan.kv_idx.data_ptr(),
                plan.kv_cnt.data_ptr(), plan.q_order.data_ptr(),
                *bs._tail(B, S, H, hd, block, plan.max_active,
                          bs._strides(q, k, v), plan, sm_scale), 1,
                stream(q)), "bsa_fwd")
        return o, lse

    def bwd(side, q, k, v, do, lse, dsum, plan, sm_scale=None):
        B, S, H, hd, block = bs._check_cuda(q, k, v, plan, (("dO", do),))
        lse, dsum = bs._check_rows(lse, dsum, B, H, S, q)
        outs = [torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
                for _ in range(2 if side == "dkv" else 1)]
        (items, own, tiles, ws, counters), ints = bs._hopper_args(
            plan.tile_plan(block, side), B, S, H, hd, q, side)
        with torch.cuda.device(q.device):
            check(getattr(lib, f"bsa_{side}_h")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dsum.data_ptr(), items, own, tiles,
                *[o.data_ptr() for o in outs], ws, counters, *ints,
                bs._strides(q, k, v, do), bs._scale(hd, sm_scale),
                stream(q)), f"bsa_{side}_h")
        return outs[0] if side == "dq" else tuple(outs)
    return {"fwd": fwd,
            "dq": lambda *a: bwd("dq", *a),
            "dkv": lambda *a: bwd("dkv", *a)}


def inputs(torch, sa, bs, cfg):
    """The path's seeded inputs (chip_smoke.py phase 27c's draw), the
    plan, and the change's forward lse and dsum (both builds' backward
    read these)."""
    g = torch.Generator(device="cuda").manual_seed(272)
    bf = torch.bfloat16
    q, k = (torch.randn(SP_B, SP_S, SP_H, SP_HD, generator=g,
                        device="cuda").to(bf) for _ in range(2))
    v, do = ((torch.rand(SP_B, SP_S, SP_H, SP_HD, generator=g,
                         device="cuda") * 2 - 1).to(bf) for _ in range(2))
    plan = sa.cached_plan(cfg, SP_S, True, "cuda")
    o, lse = bs.block_sparse_attention_fwd_cuda(q, k, v, plan)
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, dsum, plan)


def sdpa(torch, F, sa, cfg, q, k, v, do):
    """SDPA with the layout as a boolean mask: its forward and its
    backward (forward + backward less forward), events ms and device ms
    (whole profiler windows, None where none saw every kernel)."""
    mask = sa.layout_to_mask(sa.cached_layout(cfg, SP_S)[:1], SP_S, "cuda")
    mask = (mask & torch.tril(torch.ones(SP_S, SP_S, dtype=torch.bool,
                                         device="cuda")))[None]
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (ql, kl, vl), dot)
    f_ms = time_ms(fwd, reps=5, inner=2)
    events = time_ms(fwd_bwd, reps=5, inner=2) - f_ms
    both, _ = whole_device_ms(torch, fwd_bwd, reps=3)
    only, _ = whole_device_ms(torch, fwd, reps=3)
    return {"fwd": {"events_ms": f_ms, "device_ms": only},
            "bwd": {"events_ms": events,
                    "device_ms": None if both is None or only is None
                    else both - only}}


def dense_flash(torch, fa, q, k, v, do):
    """The port's dense causal flash kernels at the same shape: events and
    device ms of the forward and of each backward kernel, and the
    bounds."""
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    out = {}
    for name, fn, args in (
            ("fwd", fa.flash_attention_fwd_cuda, (q, k, v)),
            ("dkv", fa.flash_attention_bwd_dkv_cuda,
             (q, k, v, do, lse, delta)),
            ("dq", fa.flash_attention_bwd_dq_cuda,
             (q, k, v, do, lse, delta))):
        def call(fn=fn, args=args):
            return fn(*args)
        out[name] = {"events_ms": time_ms(call, reps=3, inner=1),
                     "device_ms": device_ms(torch, [call], reps=5,
                                            one_kernel=True)[0]}
    out["pair_events_ms"] = out["dkv"]["events_ms"] + out["dq"]["events_ms"]
    out["pair_device_ms"] = out["dkv"]["device_ms"] + out["dq"]["device_ms"]
    out["fwd_bound_ms"] = attn_bound(SP_B, SP_S, SP_H, SP_H, SP_HD, 2, True,
                                     2, 2, 1)[0]
    out["pair_bound_ms"] = attn_bound(SP_B, SP_S, SP_H, SP_H, SP_HD, 7, True,
                                      3, 4, 2)[0]
    return out


def errors(torch, bs, args, outs):
    """Each build's o, lse, dq, dk, dv against the plain versions (max abs
    error, over the plain tensor's max, and the relative norm of the
    difference; lse on its finite rows), and the change against the
    parent (o and lse bit for bit, gradients over the parent's max)."""
    q, k, v, do, lse, dsum, plan = args
    po, plse = bs.block_sparse_attention_fwd_plain(q, k, v, plan)
    plain = (po, plse, bs.block_sparse_attention_dq_plain(*args),
             *bs.block_sparse_attention_dkv_plain(*args))
    names = ("o", "lse", "dq", "dk", "dv")
    fin = torch.isfinite(plse)
    res = {}
    for n, got in outs.items():
        res[n] = {}
        for name, a, b in zip(names, got, plain):
            if name == "lse":
                res[n][name] = {"max_abs_err": float(
                    (a[fin] - b[fin]).abs().max()), "inf_where_plain": bool(
                    torch.equal(torch.isinf(a), ~fin))}
                continue
            e = path_errs(torch, a, b)
            res[n][name] = {k_: e[k_] for k_ in ("max_abs_err",
                                                  "rel_norm_err")}
            res[n][name]["max_abs_over_max"] = e["max_abs_err"] / max(
                float(b.float().abs().max()), 1e-30)
    res["change_vs_parent"] = {
        name: (bool(torch.equal(a, b)) if name in ("o", "lse") else
               float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30))
        for name, a, b in zip(names, outs["change"], outs["parent"])}
    return res


def ab(torch, F, sa, bs, fa, calls, reps, prepared):
    summary = {}
    for label, cfg in sparse_path_configs(sa).items():
        args = prepared[label]
        q, k, v, do, _, _, plan = args
        outs = {n: (*c["fwd"](q, k, v, plan), c["dq"](*args),
                    *c["dkv"](*args)) for n, c in calls.items()}
        torch.cuda.synchronize()
        errs = errors(torch, bs, args, outs)
        del outs
        times = {n: {f"{kern}_{how}": [] for kern in KERNELS
                     for how in ("events", "device")} for n in calls}
        for _ in range(reps):
            for n in ORDER:
                for kern in KERNELS:
                    if kern == "fwd":
                        def call(f=calls[n]["fwd"]):
                            return f(q, k, v, plan)
                    else:
                        def call(f=calls[n][kern]):
                            return f(*args)
                    times[n][f"{kern}_events"].append(
                        time_ms(call, reps=5, inner=3))
                    times[n][f"{kern}_device"].append(
                        device_ms(torch, [call], reps=5, one_kernel=True)[0])
        med = {n: {m: statistics.median(x) for m, x in t.items()}
               for n, t in times.items()}
        for n in med:
            for how in ("events", "device"):
                med[n][f"pair_{how}"] = med[n][f"dq_{how}"] \
                    + med[n][f"dkv_{how}"]
                med[n][f"fwd_bwd_{how}"] = med[n][f"fwd_{how}"] \
                    + med[n][f"pair_{how}"]
        bounds = {kind: sparse_bound(bs, plan, SP_B, SP_S, SP_H, SP_HD,
                                     kind) for kind in KERNELS}
        lib = sdpa(torch, F, sa, cfg, q, k, v, do)
        dense = dense_flash(torch, fa, q, k, v, do)
        ch = med["change"]
        row = {"layout": label, "block": cfg.block,
               "shape": [SP_B, SP_S, SP_H, SP_HD], "dtype": "bfloat16",
               "causal": True, "live_blocks": plan.live, "ms": med,
               "ms_all": times, "bound_ms": bounds,
               "sdpa_with_layout_mask": lib,
               "dense_causal_flash": dense,
               "tile_plan": tile_plan_report(plan.tile_plans(cfg.block),
                                             SP_HD),
               "parent_over_change": {
                   m: med["parent"][m] / ch[m]
                   for m in ("fwd_events", "fwd_device", "dq_device",
                             "dkv_device", "pair_device", "fwd_bwd_events")},
               "change_fwd_over_dense_flash_fwd":
               ch["fwd_events"] / dense["fwd"]["events_ms"],
               "change_fwd_over_sdpa_fwd":
               ch["fwd_events"] / lib["fwd"]["events_ms"],
               "change_fwd_over_dq": ch["fwd_events"] / ch["dq_events"],
               "change_fwd_over_bound": ch["fwd_device"] / bounds["fwd"][0],
               "change_pair_over_dense_flash_pair":
               ch["pair_events"] / dense["pair_events_ms"],
               "errors": errs}
        print(json.dumps(row), flush=True)
        summary[label] = {"change": ch, "parent": med["parent"],
                          "bound": bounds, "sdpa": lib,
                          "dense_flash_fwd_events_ms":
                          dense["fwd"]["events_ms"],
                          "dense_flash_fwd_device_ms":
                          dense["fwd"]["device_ms"],
                          "dense_flash_pair_events_ms":
                          dense["pair_events_ms"],
                          "change_vs_parent": errs["change_vs_parent"]}
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a csrc directory "
                    "holding an earlier block_sparse_attention.cu (and its "
                    "headers)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_bsa_ab: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from torch_flash_fwd_ab import build_variants
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    bs.build.build(["block_sparse_attention", "ds_flash_fwd",
                    "ds_flash_bwd"])
    # the change's forward (lse, dsum) before the parent's library loads
    prepared = {label: inputs(torch, sa, bs, cfg)
                for label, cfg in sparse_path_configs(sa).items()}
    parent = build_variants("block_sparse_attention", {},
                            args.parent)["parent"]
    calls = {"parent": parent_calls(torch, bs, parent),
             "change": {"fwd": bs.block_sparse_attention_fwd_cuda,
                        "dq": bs.block_sparse_attention_dq_cuda,
                        "dkv": bs.block_sparse_attention_dkv_cuda}}
    summary = ab(torch, F, sa, bs, fa, calls, args.reps, prepared)
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
