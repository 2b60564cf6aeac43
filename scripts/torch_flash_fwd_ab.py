#!/usr/bin/env python3
"""Same-call A/B of the port's bf16 flash forward (deepspeed_tpu_torch/
csrc/ds_flash_fwd.cu) on one GPU: builds variants of the source side by
side and times each at the port's shapes, the variants interleaved.

    python3 scripts/torch_flash_fwd_ab.py [--parent DIR] [--reps N]

Variants (one nvcc each, all started together, into
build/torch_kernels/ab/):
  change          the checkout's source as the port builds it
  by_level        -DDS_FLASH_FWD_ORDER=0 (every launch in level order)
  by_batch_head   -DDS_FLASH_FWD_ORDER=1 (by (batch, head) where it runs)
  nofold          -DDS_FLASH_FWD_FOLD=0 (the scores scaled before the
                  softmax, not sm_scale folded into the exponent's FFMA)
  parent          with --parent DIR: DIR/ds_flash_fwd.cu, built with DIR's
                  headers (an earlier commit's csrc, e.g. unpacked by
                  ``git archive <commit> deepspeed_tpu_torch/csrc``)

Per shape and variant: the kernel's device time per call, launched
through the port's wrapper (torch.profiler, each call one kernel, mean
over 20 calls), median over ``--reps`` rounds; each round runs the
variants in order and then in reverse.  With
--parent, also the GPT-2 760M bf16 prefill at each serving prompt bucket
through the model's own ``prefill_fn`` (24 layers, random weights from
the seeded init; host clock around one synchronised call, median of 10),
the port's flash wrapper pointed at the parent's library and at the
change's in turn (parent, change, change, parent).

Prints one JSON line per measurement, then the nvidia-smi line and a
summary line.  Needs a GPU and nvcc; imports nothing of JAX.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the serving path's prompt buckets (chip_smoke.py's PROMPT_LENS rounded
#: up to the scheduler's 16-token bucket)
BUCKETS = (16, 64, 144, 256, 304, 512, 704, 912)

VARIANTS = {"change": [], "by_level": ["-DDS_FLASH_FWD_ORDER=0"],
            "by_batch_head": ["-DDS_FLASH_FWD_ORDER=1"],
            "nofold": ["-DDS_FLASH_FWD_FOLD=0"]}


def shapes():
    """(name, B, S, H, KV, hd, fused-QKV views): the main path's shapes,
    GPT-2's training shape at smaller batches (k / v from 12.6 to 75.5 MB,
    across the tile-order threshold), MoE's at B 16 (33.6 MB) and the B 1
    prefill at hd 64 and 80."""
    out = [(f"prefill_s{s}", 1, s, 16, 16, 96, False) for s in BUCKETS]
    out += [("prefill_s1024", 1, 1024, 16, 16, 96, False),
            ("prefill_hd64_s1024", 1, 1024, 16, 16, 64, False),
            ("prefill_hd80_s1024", 1, 1024, 16, 16, 80, False),
            ("llama_prefill_hd128", 1, 1024, 32, 32, 128, False)]
    out += [(f"gpt2_train_b{b}", b, 1024, 16, 16, 96, True)
            for b in (2, 4, 8, 12)]
    out += [("moe_train_b8", 8, 1024, 16, 8, 64, False),
            ("moe_train_b16", 16, 1024, 16, 8, 64, False)]
    return out


def build_variants(source, variants, parent):
    """Build csrc/<source>.cu once per entry of ``variants`` (name: extra
    nvcc flags) and, with ``parent`` (an earlier commit's csrc
    directory), DIR/<source>.cu against DIR's headers as "parent": one
    nvcc each, all started together, into build/torch_kernels/ab/.
    Prints each build's ptxas report lines; returns {name: ctypes.CDLL}."""
    from deepspeed_tpu_torch.ops.kernels import build
    csrc = ROOT / "deepspeed_tpu_torch" / "csrc"
    out_dir = ROOT / "build" / "torch_kernels" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {n: (csrc / f"{source}.cu", csrc, flags)
            for n, flags in variants.items()}
    if parent:
        p = Path(parent).resolve()
        jobs["parent"] = (p / f"{source}.cu", p, [])
    nvcc = build.find_nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n, (src, inc, flags) in jobs.items():
        so = out_dir / f"{source}_{n}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, *flags, "-I", str(inc), "-o",
               str(so), str(src)]
        procs[n] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True))
    libs = {}
    for n, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{source} {n} did not build:\n{log}")
        print(json.dumps({"built": n, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "C75" in ln]}),
            flush=True)
        libs[n] = ctypes.CDLL(str(so))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    return libs


def inputs(torch, g, B, S, H, KV, hd, fused):
    dt = torch.bfloat16
    if fused:
        qkv = torch.randn(B, S, 3 * H * hd, generator=g).to("cuda", dt)
        return [t.unflatten(-1, (H, hd)) for t in qkv.split(H * hd, dim=-1)]
    return [torch.randn(B, S, h, hd, generator=g).to("cuda", dt)
            for h in (H, KV, KV)]


def caller(fa, fn, q, k, v):
    """One launch of library function ``fn`` through the port's own
    wrapper (its checks and allocations included), returning (o, lse)."""
    def call():
        fa._fwd_lib = lambda: fn
        return fa.flash_attention_fwd_cuda(q, k, v)
    return call


def device_ms(torch, call, n=20):
    """Mean kernel time per call (each call launches one kernel), and how
    it was read: the profiler's kernel records, or, when CUPTI returns
    no record three times (twice with device activity alone, once with
    host activity too), CUDA events around ``n`` back-to-back calls (host
    gaps included)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    dev, both = [ProfilerActivity.CUDA], [ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]
    for acts in (dev, dev, both):   # CUPTI now and then returns nothing
        with profile(activities=acts) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        ts = [e.device_time for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ts:
            return sum(ts) / len(ts) / 1e3, "profiler"
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, "events"


def kernel_ab(torch, fns, reps):
    from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(7)
    own = fa._fwd_lib
    try:
        return _kernel_ab(torch, fa, fns, reps, g)
    finally:
        fa._fwd_lib = own


def _kernel_ab(torch, fa, fns, reps, g):
    names = list(fns)
    summary = {}
    for (name, B, S, H, KV, hd, fused) in shapes():
        q, k, v = inputs(torch, g, B, S, H, KV, hd, fused)
        calls = {n: caller(fa, fns[n], q, k, v) for n in names}
        ref_o, ref_l = None, None
        agree = {}
        for n in names:   # every variant computes the same o and lse
            o, lse = calls[n]()
            torch.cuda.synchronize()
            if ref_o is None:
                ref_o, ref_l = o.float().clone(), lse.clone()
            agree[n] = [float((o.float() - ref_o).abs().max()),
                        float((lse - ref_l).abs().max())]
        times = {n: [] for n in names}
        how = set()
        for _ in range(reps):
            for order in (names, names[::-1]):
                for n in order:
                    t, h = device_ms(torch, calls[n])
                    times[n].append(t)
                    how.add(h)
        med = {n: statistics.median(t) for n, t in times.items()}
        row = {"shape": name, "B": B, "S": S, "H": H, "KV": KV, "hd": hd,
               "fused_qkv_views": fused, "kv_mb": 4 * B * KV * S * hd / 1e6,
               "device_ms": med, "timed_by": sorted(how),
               "device_ms_all": times,
               "max_abs_diff_vs_first_variant_o_lse": agree}
        print(json.dumps(row), flush=True)
        summary[name] = med
        del q, k, v, calls
        torch.cuda.empty_cache()
    return summary


def prefill_ab(torch, fns):
    """GPT-2 760M bf16 prefill per bucket, the wrapper's library swapped
    between the parent's and the change's (parent, change, change,
    parent); returns {bucket: {variant: median ms}}."""
    import numpy as np
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    model = gpt2_model("760m", dtype="bfloat16")
    eng = dt.init_inference(model, {"dtype": "bfloat16"})
    rng = np.random.default_rng(1)
    own = fa._fwd_lib
    out = {}
    try:
        for sp in BUCKETS:
            ids = torch.from_numpy(rng.integers(
                1, model.config.vocab_size, (1, sp)).astype(np.int32)
            ).to("cuda")

            def prefill():
                cache = model.init_cache_fn(1, -(-sp // 64) * 64,
                                            torch.bfloat16, "cuda")
                with torch.no_grad():
                    model.prefill_fn(eng.params, {"input_ids": ids}, cache)
            times = {"parent": [], "change": []}
            for n in ("parent", "change", "change", "parent"):
                fa._fwd_lib = lambda f=fns[n]: f
                prefill()
                torch.cuda.synchronize()
                for _ in range(5):
                    t0 = time.perf_counter()
                    prefill()
                    torch.cuda.synchronize()
                    times[n].append((time.perf_counter() - t0) * 1e3)
            med = {n: statistics.median(t) for n, t in times.items()}
            print(json.dumps({"prefill_bucket": sp, "ms": med,
                              "ms_all": times}), flush=True)
            out[str(sp)] = med
    finally:
        fa._fwd_lib = own
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a csrc directory holding an earlier "
                    "ds_flash_fwd.cu (and its headers)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_fwd_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    fns = {n: fa.bind_fwd(lib) for n, lib in build_variants(
        "ds_flash_fwd", VARIANTS, args.parent).items()}
    summary = {"kernel_device_ms": kernel_ab(torch, fns, args.reps)}
    if "parent" in fns:
        summary["gpt2_prefill_ms"] = prefill_ab(torch, fns)
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
