#!/usr/bin/env python3
"""On-GPU smoke of deepspeed_tpu_torch: builds the CUDA kernels from the
checkout, holds each against its plain PyTorch version on the card, then
serves GPT-2 760M (random weights from the seeded host init) through the
port's own entry points.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):
  1. device: card name and power limit, torch/CUDA versions, kernel build
     seconds;
  2. kernels at the serving path's shapes: max |kernel - plain| within the
     stated tolerance, then median times of the kernel, the plain version
     and the PyTorch library call (scaled_dot_product_attention, timed
     here only) beside the least time the card could take;
  3. fp32 at full width: init_inference -> scheduler with a pool small
     enough to force a preemption; eight greedy requests must be
     token-identical to the static generate, two last-step decode logits
     within 1e-3 of a full forward with the plain attention, and the
     kernel launch counts must be 24 per prefill / per decode step;
  4. bf16 over HTTP (the main path): eight concurrent requests, one of
     them sampled and repeated; prefill / decode / gather times, tokens/s
     and TTFT.
Earlier lines are JSON objects; the line before the last two is the
``kernels`` object, then the nvidia-smi line, and the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA device; exits 2
without one.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core flop/s,
# fp32 (non-tensor-core) flop/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
LAYERS = 24                 # gpt2:760m
PROMPT_LENS = [7, 64, 129, 256, 300, 511, 700, 900]
MAX_NEW = 64
DECODE_LENS = [1, 17, 255, 256, 511, 700, 1023, 1024]
TOL = {"float32": {"o": 1e-4, "lse": 1e-4},
       "bfloat16": {"o": 2e-2, "lse": 1e-3}}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, reps=15, inner=10, warmup=3):
    """Milliseconds per call: CUDA events around ``inner`` back-to-back
    calls (so the device queue stays full and host launch gaps drop
    out), median over ``reps`` such runs.  Inputs stay warm in L2."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: no output"


# ----------------------------------------------------------------- kernels
def kernel_phase(torch, da, fa):
    dev = "cuda"
    g = torch.Generator(device="cpu").manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    def unif(*shape):
        # v in [-1, 1): outputs stay below 1 in magnitude, where one bf16
        # ulp is 2^-7, so the bf16 tolerance measures the kernel and not
        # the output rounding of large values
        return torch.rand(*shape, generator=g) * 2 - 1

    errs = {"decode_attention": 0.0, "ds_flash_fwd": 0.0}
    tol_used = {"decode_attention": 0.0, "ds_flash_fwd": 0.0}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        tol = TOL[dt_name]
        for (B, H, KV, hd, S, lens) in [
                (8, 16, 16, 96, 1024, DECODE_LENS),
                (8, 32, 8, 128, 1024, DECODE_LENS)]:
            q = randn(B, H, hd).to(dev, dt)
            k = randn(B, S, KV, hd).to(dev, dt)
            v = unif(B, S, KV, hd).to(dev, dt)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            o = da.decode_attention_cuda(q, k, v, L)
            r = da.decode_attention_plain(q, k, v, L)
            torch.cuda.synchronize()
            e = float((o.float() - r.float()).abs().max())
            emit({"check": "decode_attention", "dtype": dt_name,
                  "shape": [B, H, KV, hd, S], "max_abs_err": e,
                  "tol": tol["o"]})
            check(e <= tol["o"], f"decode_attention {dt_name} "
                  f"{(B, H, KV, hd, S)}: err {e} > {tol['o']}")
            errs["decode_attention"] = max(errs["decode_attention"], e)
            tol_used["decode_attention"] = max(tol_used["decode_attention"],
                                               tol["o"])
        cases = [(1, S, 16, 16, 96, True, False, False)
                 for S in (16, 272, 1024)]
        cases.append((2, 272, 16, 4, 96, False, True, False))
        # the prefill's own layout: q/k/v strided views of one fused
        # [B, S, 3 * H * hd] projection, at the largest prompt bucket
        cases.append((1, 912, 16, 16, 96, True, False, True))
        for (B, S, H, KV, hd, causal, seg, fused) in cases:
            if fused:
                qkv = randn(B, S, 3 * H * hd)
                qkv[..., 2 * H * hd:] = unif(B, S, H * hd)
                q, k, v = (t.unflatten(-1, (H, hd)) for t in
                           qkv.to(dev, dt).split(H * hd, dim=-1))
            else:
                q = randn(B, S, H, hd).to(dev, dt)
                k = randn(B, S, KV, hd).to(dev, dt)
                v = unif(B, S, KV, hd).to(dev, dt)
            sg = None
            if seg:     # three packed segments, the first a segment-0 pad
                sg = torch.zeros(B, S, dtype=torch.int32)
                sg[:, S // 3:] = 1
                sg[:, 2 * S // 3:] = 2
                sg = sg.to(dev)
            o, lse = fa.flash_attention_fwd_cuda(q, k, v, sg, causal)
            ro, rl = fa.flash_attention_fwd_plain(q, k, v, sg, causal)
            torch.cuda.synchronize()
            eo = float((o.float() - ro.float()).abs().max())
            el = float((lse - rl).abs().max())
            emit({"check": "ds_flash_fwd", "dtype": dt_name,
                  "shape": [B, S, H, KV, hd], "causal": causal,
                  "segments": seg, "fused_qkv_views": fused,
                  "max_abs_err_o": eo,
                  "max_abs_err_lse": el, "tol_o": tol["o"],
                  "tol_lse": tol["lse"]})
            check(eo <= tol["o"] and el <= tol["lse"],
                  f"ds_flash_fwd {dt_name} {(B, S, H, KV, hd)}: o err {eo}, "
                  f"lse err {el}")
            errs["ds_flash_fwd"] = max(errs["ds_flash_fwd"], eo)
            tol_used["ds_flash_fwd"] = max(tol_used["ds_flash_fwd"],
                                           tol["o"])
    return errs, tol_used


def kernel_times(torch, F, da, fa):
    """Times at the 760M serving shapes (bf16): decode B=8, H=KV=16,
    hd=96, S_max=1024 over DECODE_LENS; flash B=1, H=16, hd=96, S=1024
    causal."""
    dev = "cuda"
    dt = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(99)
    B, H, hd, S = 8, 16, 96, 1024
    q = torch.randn(B, H, hd, generator=g).to(dev, dt)
    k = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
    v = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
    L = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    mask = (torch.arange(S, device=dev)[None, :] < L[:, None])[:, None, None]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    dec = {
        "kernel_ms": time_ms(lambda: da.decode_attention_cuda(q, k, v, L)),
        "plain_ms": time_ms(lambda: da.decode_attention_plain(q, k, v, L)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
    }
    bytes_ = sum(DECODE_LENS) * 2 * H * hd * 2 + 2 * B * H * hd * 2 + 4 * B
    flops = 4 * sum(DECODE_LENS) * H * hd
    dec["bound_ms"] = max(bytes_ / HBM_BPS, flops / BF16_FLOPS) * 1e3
    dec["bound_by"] = "bytes" if bytes_ / HBM_BPS >= flops / BF16_FLOPS \
        else "operations"

    def flash_at(S, B=1):
        q = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
        k = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
        v = torch.randn(B, S, H, hd, generator=g).to(dev, dt)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        r = {"kernel_ms": time_ms(
            lambda: fa.flash_attention_fwd_cuda(q, k, v))}
        flops = 4 * B * H * hd * S * S / 2
        bytes_ = 4 * B * S * H * hd * 2 + B * H * S * 4
        r["bound_ms"] = max(flops / BF16_FLOPS, bytes_ / HBM_BPS) * 1e3
        r["bound_by"] = ("operations" if flops / BF16_FLOPS
                         >= bytes_ / HBM_BPS else "bytes")
        return r, (q, k, v, qt, kt, vt)

    fl, (q, k, v, qt, kt, vt) = flash_at(1024)
    fl["plain_ms"] = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v))
    fl["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    per_s = {}
    for n in PROMPT_LENS:
        sp = -(-n // 16) * 16
        per_s[str(sp)] = flash_at(sp)[0]["kernel_ms"]
    return dec, fl, per_s


# -------------------------------------------------------------- the slice
def prompts_for(lens, vocab, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def fp32_phase(torch, dt, da, fa):
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             RequestState, SamplingParams)
    t0 = time.perf_counter()
    model = gpt2_model("760m", dtype="float32")
    eng = dt.init_inference(model, {"dtype": "float32"})
    init_s = time.perf_counter() - t0
    cfg = model.config
    prompts = prompts_for(PROMPT_LENS, cfg.vocab_size)
    # 139 usable blocks of 16: the first admissions take 127, decode
    # growth then runs the pool dry and forces a preemption
    scfg = ServingConfig(num_blocks=140)
    sched = ContinuousBatchingScheduler(model, eng.params, scfg)
    da.decode_attention.launches = 0
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts]
    sched.run_until_idle()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    c = sched.metrics.counters
    launches = {"decode_attention": da.decode_attention.launches,
                "ds_flash_fwd": fa.flash_attention_fwd.launches}
    emit({"phase": "fp32_serve", "init_s": init_s, "serve_s": serve_s,
          "prefills": c["prefills"], "decode_steps": c["decode_steps"],
          "preemptions": c["preemptions"], "resumed": c["resumed"],
          "launches": launches})
    check(all(r.state == RequestState.FINISHED
              and r.num_generated == MAX_NEW for r in reqs),
          "fp32: not every request finished with its full length")
    check(c["preemptions"] >= 1, "fp32: the pool did not force a preemption")
    check(launches["ds_flash_fwd"] == LAYERS * c["prefills"],
          f"fp32: flash launches {launches['ds_flash_fwd']} != "
          f"{LAYERS} x {c['prefills']} prefills")
    check(launches["decode_attention"] == LAYERS * c["decode_steps"],
          f"fp32: decode launches {launches['decode_attention']} != "
          f"{LAYERS} x {c['decode_steps']} decode steps")
    mismatched = []
    for p, r in zip(prompts, reqs):
        ref = eng.generate(p, max_new_tokens=MAX_NEW)[0, p.size:]
        if list(ref) != list(r.output_ids):
            mismatched.append(int(p.size))
    emit({"phase": "fp32_parity", "requests": len(reqs),
          "token_identical": not mismatched, "mismatched_prompts":
          mismatched})
    check(not mismatched, f"fp32: scheduler != static generate for prompt "
          f"lengths {mismatched}")
    # decode-path logits at the last step vs a full forward with the
    # plain attention (selected explicitly)
    plain = gpt2_model("760m", dtype="float32", attention_impl="plain")
    worst = 0.0
    with torch.no_grad():
        for i in (2, 6):
            toks = list(prompts[i]) + list(reqs[i].output_ids[:-1])
            n = len(prompts[i])
            ids = torch.tensor([toks], dtype=torch.int32, device="cuda")
            cache = model.init_cache_fn(1, -(-len(toks) // 64) * 64,
                                        torch.float32, "cuda")
            logits, cache = model.prefill_fn(
                eng.params, {"input_ids": ids[:, :n]}, cache)
            for pos in range(n, len(toks)):
                logits, cache = model.decode_fn(
                    eng.params, ids[:, pos],
                    cache, torch.tensor([pos], dtype=torch.int32,
                                        device="cuda"))
            full = plain.apply(eng.params, {"input_ids": ids})[:, -1]
            e = float((logits - full).abs().max())
            worst = max(worst, e)
            emit({"phase": "fp32_logits", "prompt_len": n,
                  "max_abs_err": e, "tol": 1e-3})
    check(worst <= 1e-3, f"fp32: decode logits differ from the plain "
          f"forward by {worst}")
    return eng


def post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def bf16_phase(torch, eng32, da, fa):
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.serving.server import make_server
    model = gpt2_model("760m", dtype="bfloat16")
    eng = InferenceEngine(model, DeepSpeedInferenceConfig(dtype="bfloat16"),
                          model_parameters=eng32.params)
    sched = ContinuousBatchingScheduler(model, eng.params, ServingConfig())
    httpd, loop = make_server(sched, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    loop.start()
    server.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        prompts = prompts_for(PROMPT_LENS, model.config.vocab_size, seed=1)
        bodies = [{"input_ids": p.tolist(), "max_new_tokens": MAX_NEW}
                  for p in prompts]
        bodies[3].update(do_sample=True, seed=4242, temperature=0.8,
                         top_k=50, top_p=0.95)
        results = [None] * len(bodies)

        def worker(i):
            results[i] = post(base + "/generate", bodies[i])

        # the main path: counts set to 0 just before, read just after
        da.decode_attention.launches = 0
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall_s = time.perf_counter() - t0
        launches = {"decode_attention": da.decode_attention.launches,
                    "ds_flash_fwd": fa.flash_attention_fwd.launches}
        check(all(r is not None and r[0] == 200 for r in results),
              f"bf16: not every /generate returned 200: "
              f"{[r and r[0] for r in results]}")
        outs = [r[1] for r in results]
        check(all(len(o["output_ids"]) == MAX_NEW for o in outs),
              "bf16: a request came back short")
        vocab = model.config.vocab_size
        check(all(0 <= t < vocab for o in outs for t in o["output_ids"]),
              "bf16: token id out of range")
        check(all(v > 0 for v in launches.values()),
              f"bf16: a kernel was not launched on the main path "
              f"{launches}")
        _, again = post(base + "/generate", bodies[3])
        check(again["output_ids"] == outs[3]["output_ids"],
              "bf16: the sampled request did not repeat identically")
        hs, hbody = get(base + "/healthz")
        ms, mbody = get(base + "/metrics")
        check(hs == 200 and json.loads(hbody)["state"] == "ready",
              f"bf16: /healthz {hs} {hbody}")
        check(ms == 200 and "kernel_launches{kernel=\"decode_attention\"}"
              in mbody and "serving_generated_tokens" in mbody,
              "bf16: /metrics is not the expected Prometheus text")
    finally:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    busy = profile_decode(torch, sched, prompts)
    m = sched.metrics
    prefill_ms = {}
    for n, sp, s in m.prefill_s:
        prefill_ms.setdefault(str(n), []).append(s * 1e3)
    steps = sum(k for k, _, _ in m.decode_window_s)
    decode_ms_per_step = sum(s for _, _, s in m.decode_window_s) \
        / max(steps, 1) * 1e3
    gen = sum(len(o["output_ids"]) for o in outs)
    ttft = sorted(o["ttft_ms"] for o in outs)
    # the dense pool gather the decode step runs per step (k and v)
    pos_idx = torch.randint(0, sched.pool["k"].shape[1],
                            (sched.cfg.max_num_seqs, sched.s_pad),
                            device="cuda")
    gather_ms = time_ms(lambda: [p[:, pos_idx] for p in sched.pool.values()])
    report = {"phase": "bf16_http", "requests": len(outs),
              "decode_profile": busy,
              "wall_s": wall_s, "generated_tokens": gen,
              "tokens_per_s": gen / wall_s,
              "ttft_p50_ms": statistics.median(ttft),
              "prefill_ms_by_prompt_len": prefill_ms,
              "decode_ms_per_step": decode_ms_per_step,
              "decode_steps": steps, "gather_ms_per_step": gather_ms,
              "launches": launches,
              "sampled_repeat_identical": True}
    emit(report)
    return launches, report


def profile_decode(torch, sched, prompts):
    """torch.profiler over one decode window of the bf16 scheduler with
    all eight requests active: the device's busy share of the window's
    wall time and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.serving import RequestState, SamplingParams
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in prompts]
    while not all(r.state == RequestState.DECODE for r in reqs):
        sched.step()
    torch.cuda.synchronize()
    steps0 = sched.metrics.counters["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = sched.metrics.counters["decode_steps"] - steps0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    sched.run_until_idle()
    return {"window_steps": steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deepspeed_tpu_torch as dt
        from deepspeed_tpu_torch.ops.kernels import build
        from deepspeed_tpu_torch.ops.kernels import decode_attention as da
        from deepspeed_tpu_torch.ops.kernels import ds_flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the deepspeed_tpu_torch package is not next to "
              f"this script ({e})", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    build.build(["decode_attention", "ds_flash_fwd"])
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "build_s_by_source": {n: r["seconds"]
                                for n, r in build.build_log.items()}})

    errs, tols = kernel_phase(torch, da, fa)
    dec_t, fl_t, flash_by_s = kernel_times(torch, F, da, fa)
    emit({"phase": "kernel_times", "decode_attention": dec_t,
          "ds_flash_fwd_s1024": fl_t, "ds_flash_fwd_ms_by_bucket":
          flash_by_s})

    eng32 = fp32_phase(torch, dt, da, fa)
    launches, report = bf16_phase(torch, eng32, da, fa)
    del eng32
    torch.cuda.empty_cache()

    kernels = []
    for name, t, src, replaces in (
            ("decode_attention", dec_t,
             "deepspeed_tpu_torch/csrc/decode_attention.cu",
             "deepspeed_tpu/ops/pallas/decode_attention.py:40"),
            ("ds_flash_fwd", fl_t, "deepspeed_tpu_torch/csrc/ds_flash_fwd.cu",
             "deepspeed_tpu/ops/pallas/ds_flash_attention.py:35")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "tpu_kernel": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "tol": tols[name], "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
