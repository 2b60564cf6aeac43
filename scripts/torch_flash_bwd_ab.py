#!/usr/bin/env python3
"""Same-call A/B of the port's bf16 flash backward pair (deepspeed_tpu_torch/
csrc/ds_flash_bwd.cu: the dK/dV and dQ kernels) against an earlier
commit's on one GPU: builds both side by side and times each at the
port's training shapes, interleaved.

    python3 scripts/torch_flash_bwd_ab.py --parent DIR [--reps N]

Builds (one nvcc each, started together, into build/torch_kernels/ab/):
  change          the checkout's source as the port builds it
  parent          DIR/ds_flash_bwd.cu, built with DIR's headers (an
                  earlier commit's csrc, e.g. unpacked by
                  ``git archive <commit> deepspeed_tpu_torch/csrc``)

Shapes: GPT-2 760M's training shape (H 16, hd 96, causal, q/k/v strided
views of one fused QKV tensor) at B 2 / 4 / 8 / 12, mixtral:1b-moe's (H 16
/ KV 8, hd 64) at B 8 / 16, and S 1024 at hd 80 and hd 128 (B 8, H 16).
Per shape and build: each kernel's device time per call, launched through
the port's wrapper (torch.profiler, each call one kernel, mean over 20
calls; chip_smoke.py's ``device_ms``), median over ``--reps`` rounds, each
round running the builds in order and then in reverse; each build's
outputs against the change's and against the plain backward; and SDPA's
backward beside them (chip_smoke.py's ``sdpa_bwd_device_ms``: its forward
+ backward less its forward, from profiler windows that saw every kernel).

Prints one JSON line per measurement, then the nvidia-smi line and a
summary line.  Needs a GPU and nvcc; imports nothing of JAX.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def shapes():
    """(name, B, S, H, KV, hd, fused-QKV views), all causal at S 1024."""
    out = [(f"gpt2_train_b{b}", b, 1024, 16, 16, 96, True)
           for b in (2, 4, 8, 12)]
    out += [("moe_train_b8", 8, 1024, 16, 8, 64, False),
            ("moe_train_b16", 16, 1024, 16, 8, 64, False),
            ("hd80_b8", 8, 1024, 16, 16, 80, False),
            ("hd128_b8", 8, 1024, 16, 16, 128, False)]
    return out


def inputs(torch, fa, g, B, S, H, KV, hd, fused):
    """bf16 q, k, v (strided views of one fused tensor when ``fused``),
    dO, and the forward kernel's lse with delta = rowsum(dO * O)."""
    dt = torch.bfloat16
    if fused:
        qkv = torch.randn(B, S, 3 * H * hd, generator=g).to("cuda", dt)
        q, k, v = (t.unflatten(-1, (H, hd))
                   for t in qkv.split(H * hd, dim=-1))
    else:
        q, k, v = (torch.randn(B, S, h, hd, generator=g).to("cuda", dt)
                   for h in (H, KV, KV))
    do = (torch.rand(B, S, H, hd, generator=g) * 2 - 1).to("cuda", dt)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def callers(fa, lib, args):
    """The dK/dV and dQ launches of library ``lib`` through the port's own
    wrappers (their checks and allocations included)."""
    def dkv():
        fa._bwd_lib = lambda: lib
        return fa.flash_attention_bwd_dkv_cuda(*args)

    def dq():
        fa._bwd_lib = lambda: lib
        return fa.flash_attention_bwd_dq_cuda(*args)
    return {"dkv": dkv, "dq": dq}


def kernel_ab(torch, libs, reps):
    from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    own = fa._bwd_lib
    try:
        return _kernel_ab(torch, fa, libs, reps)
    finally:
        fa._bwd_lib = own


def _kernel_ab(torch, fa, libs, reps):
    import torch.nn.functional as F
    from chip_smoke import device_ms, sdpa_bwd_device_ms
    g = torch.Generator(device="cpu").manual_seed(11)
    names = list(libs)
    summary = {}
    for (name, B, S, H, KV, hd, fused) in shapes():
        args = inputs(torch, fa, g, B, S, H, KV, hd, fused)
        calls = {n: callers(fa, libs[n], args) for n in names}
        plain = fa.flash_attention_bwd_plain(*args)
        ref, agree, rel = None, {}, {}
        for n in names:   # both builds compute the same dq, dk, dv
            dk, dv = calls[n]["dkv"]()
            got = (calls[n]["dq"](), dk, dv)
            torch.cuda.synchronize()
            if ref is None:
                ref = [t.float().clone() for t in got]
            agree[n] = [float((a.float() - b).abs().max())
                        for a, b in zip(got, ref)]
            rel[n] = [float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                      for a, b in zip(got, plain)]
        del plain
        times = {f"{n}.{k}": [] for n in names for k in ("dkv", "dq")}
        how = set()
        for _ in range(reps):
            for order in (names, names[::-1]):
                for n in order:
                    for k in ("dkv", "dq"):
                        t, per = device_ms(torch, [calls[n][k]], reps=20,
                                           one_kernel=True)
                        times[f"{n}.{k}"].append(t)
                        how.add("events" if per is None else "profiler")
        med = {n: statistics.median(t) for n, t in times.items()}
        pair = {n: med[f"{n}.dkv"] + med[f"{n}.dq"] for n in names}
        sdpa = sdpa_bwd_device_ms(torch, F, *args[:4], enable_gqa=H != KV)
        row = {"shape": name, "B": B, "S": S, "H": H, "KV": KV, "hd": hd,
               "fused_qkv_views": fused, "device_ms": med,
               "pair_device_ms": pair, "sdpa_bwd_ms": sdpa["library"],
               "sdpa_kernels_per_call": sdpa["library_kernels_per_call"],
               "timed_by": sorted(how), "device_ms_all": times,
               "max_abs_diff_vs_change_dq_dk_dv": agree,
               "rel_err_vs_plain_dq_dk_dv": rel}
        print(json.dumps(row), flush=True)
        summary[name] = {"pair": pair, "sdpa_bwd_ms": row["sdpa_bwd_ms"],
                         **med}
        del args, calls
        torch.cuda.empty_cache()
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a csrc directory "
                    "holding an earlier ds_flash_bwd.cu (and its headers)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    from torch_flash_fwd_ab import build_variants
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    libs = {n: fa.bind_bwd(lib) for n, lib in build_variants(
        "ds_flash_bwd", {"change": []}, args.parent).items()}
    summary = {"kernel_device_ms": kernel_ab(torch, libs, args.reps)}
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
