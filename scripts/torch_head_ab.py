#!/usr/bin/env python3
"""Same-call A/B of the fp32 LM head on the port's serving paths: the
models' ``head_dot`` on ``rows_matmul`` (ops/kernels/grouped_gemm.py: the
grouped GEMM's fp32 kernel over one group, a row's bits independent of the
rows beside it) against cuBLAS's ``x @ w`` in its place (the head before
rows_matmul), on chip_smoke.py's phase 4 and phase 12 workloads, one GPU.

    python3 scripts/torch_head_ab.py [--rounds N]

Workloads (chip_smoke.py's prompts, pools and lengths):
  - phase 4: GPT-2 760M fp32 through init_inference -> the scheduler,
    eight prompts (PROMPT_LENS), 64 new tokens each, a pool of 140 blocks
    that forces a preemption;
  - phase 12: Mixtral-8x7B widths at 2 layers, fp32, float cache, fused
    decode off, the same prompts (seed 5) and pool.
Arms, in the order kernel, cublas, cublas, kernel each round: ``kernel``
is the port as it ships, ``cublas`` swaps ``rows_matmul`` for the plain
product.  A short warm-up run of each arm comes first.  Readings per run:
the scheduler's wall, the sums of its prefill walls and of its decode
windows' walls (``sched.metrics``), prefills, decode steps, and whether
the tokens equal the first kernel run's.  Prints one JSON line per run,
then the medians per workload and arm with the ratios, the nvidia-smi
line, and a summary line.  Needs a GPU and nvcc; imports nothing of JAX.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def serve(torch, model, params, prompts, max_new):
    """One scheduler run; returns its readings and the tokens."""
    from deepspeed_tpu_torch.runtime.config import ServingConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchingScheduler,
                                             SamplingParams)
    sched = ContinuousBatchingScheduler(model, params,
                                        ServingConfig(num_blocks=140))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m, c = sched.metrics, sched.metrics.counters
    return ({"wall_s": wall,
             "prefill_s": sum(t for _, _, t in m.prefill_s),
             "decode_s": sum(t for _, _, t in m.decode_window_s),
             "prefills": c["prefills"], "decode_steps": c["decode_steps"],
             "preemptions": c["preemptions"]},
            [list(r.output_ids) for r in reqs])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_head_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.ops.kernels import build
    from deepspeed_tpu_torch.ops.kernels import grouped_gemm as gg
    build.build(smoke.KERNEL_SOURCES)
    kernel_head = gg.rows_matmul

    def cublas_head(x, w, transpose_w=False):
        return x @ (w.T if transpose_w else w)
    heads = {"kernel": kernel_head, "cublas": cublas_head}
    workloads = {
        "phase4_gpt2_760m": (lambda: gpt2_model("760m", dtype="float32"),
                             0),
        "phase12_mixtral_8x7b_2_layers": (
            lambda: mixtral_model("8x7b", num_layers=smoke.MIX_PARITY_LAYERS,
                                  dtype="float32"), 5)}
    summary = {}
    for wname, (make, seed) in workloads.items():
        model = make()
        eng = dt.init_inference(model, {"dtype": "float32"})
        prompts = smoke.prompts_for(smoke.PROMPT_LENS,
                                    model.config.vocab_size, seed=seed)
        for arm, head in heads.items():      # warm-up, not kept
            gg.rows_matmul = head
            serve(torch, model, eng.params, prompts[:2], 4)
        runs, first = {a: [] for a in heads}, None
        for _ in range(args.rounds):
            for arm in ("kernel", "cublas", "cublas", "kernel"):
                gg.rows_matmul = heads[arm]
                row, toks = serve(torch, model, eng.params, prompts,
                                  smoke.MAX_NEW)
                first = toks if first is None else first
                row.update(workload=wname, arm=arm,
                           tokens_equal_first_kernel_run=toks == first)
                emit(row)
                runs[arm].append(row)
        gg.rows_matmul = kernel_head
        med = {arm: {k: statistics.median(r[k] for r in rs)
                     for k in ("wall_s", "prefill_s", "decode_s")}
               for arm, rs in runs.items()}
        med["kernel_over_cublas"] = {
            k: med["kernel"][k] / med["cublas"][k]
            for k in ("wall_s", "prefill_s", "decode_s")}
        summary[wname] = med
        emit({"workload": wname, "medians": med})
        del eng, model
        torch.cuda.empty_cache()
    print(smoke.nvidia_smi_line(), flush=True)
    emit({"summary": summary})


if __name__ == "__main__":
    main()
