#!/usr/bin/env python3
"""Same-call A/B of the port's decode attention kernel (deepspeed_tpu_torch/
csrc/decode_attention.cu) against an earlier commit's on one GPU.

    python3 scripts/torch_decode_ab.py --parent DIR [--reps N]

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``); its decode_attention.cu is built
with its own headers into build/torch_kernels/ab/ and launched through a
copy of that commit's wrapper (the same checks, output allocation and C
entry points, which take no workspace); "change" is the checkout's wrapper
on the checkout's build.

Cases (bf16 queries, S_max 1024, cache lengths DECODE_LENS), each over a
bf16 and an int8 cache and timed over the model's own layers' caches:
GPT-2 760M (B 8, H 16, hd 96; 24 layers), BLOOM-560m with ALiBi (B 8, H
16, hd 64; 24), GPT-Neo 2.7B's local layers (B 8, H 20, hd 128, window
256, sm_scale 1; 32) and Mixtral-8x7B's GQA (B 8, H 32 over KV 8, hd 128;
32).  Per case and build: the device time per call (torch.profiler, one
kernel a call, chip_smoke.py's ``device_ms`` over a sweep of the layers),
median over ``--reps`` rounds of parent, change, change, parent; SDPA's
device time with the same mask on the bf16 cache (context only: the port
never calls it); the bound (bytes read once at 3.35 TB/s); the wrapper's
host ms a call (``host_ms_per_call`` over 100 unsynchronised calls,
median of the same interleaved rounds); and the outputs against the plain
version and against each other.

Prints one JSON line per case, then the nvidia-smi line and a summary
line.  Needs a GPU and nvcc; imports nothing of JAX.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import threading
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import (DECODE_LENS, HBM_BPS, device_ms,  # noqa: E402
                        host_ms_per_call)

#: (name, B, H, KV, hd, layers, window, alibi, sm_scale)
CASES = (("gpt2_760m", 8, 16, 16, 96, 24, None, False, None),
         ("bloom_560m_alibi", 8, 16, 16, 64, 24, None, True, None),
         ("gptneo_2.7b_windowed", 8, 20, 20, 128, 32, 256, False, 1.0),
         ("mixtral_8x7b_gqa", 8, 32, 8, 128, 32, None, False, None))
S_MAX = 1024


def parent_call(torch, da, lib):
    """A copy of the earlier commit's wrapper on ``lib``: the checks, the
    output allocation, its library lookup (``build.load``'s lock and
    table) and C entry points (no workspace: 7 or 9 pointers, 6 ints, the
    scale and the stream), and its launch counts."""
    lock, libs = threading.Lock(), {"decode_attention": lib}
    counts = types.SimpleNamespace(launches=0, int8_launches=0,
                                   alibi_launches=0, windowed_launches=0)

    def _lib(quantized):
        with lock:
            found = libs.get("decode_attention")
        fn = found.ds_decode_attention_int8 if quantized \
            else found.ds_decode_attention
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * (9 if quantized else 7)
                           + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        return fn

    def call(q, k_cache, v_cache, cache_len, sm_scale=None, k_scale=None,
             v_scale=None, alibi_slopes=None, min_pos=None):
        B, H, KV, S_max, hd, quantized = da.check_args(
            q, k_cache, v_cache, cache_len, k_scale, v_scale, alibi_slopes,
            min_pos)
        if sm_scale is None:
            sm_scale = hd ** -0.5
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            ptrs = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()]
            if quantized:
                ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
            ptrs += [cache_len.data_ptr(),
                     0 if alibi_slopes is None else alibi_slopes.data_ptr(),
                     0 if min_pos is None else min_pos.data_ptr()]
            rc = _lib(quantized)(*ptrs, out.data_ptr(), B, H, KV, S_max, hd,
                                 int(q.dtype == torch.bfloat16),
                                 float(sm_scale), stream)
        if rc != 0:
            raise RuntimeError(f"parent decode_attention: cudaError_t {rc}")
        if alibi_slopes is not None:
            counts.alibi_launches += 1
        if min_pos is not None:
            counts.windowed_launches += 1
        if alibi_slopes is None and min_pos is None:
            if quantized:
                counts.int8_launches += 1
            else:
                counts.launches += 1
        return out
    return call


def case_inputs(torch, da, g, B, H, KV, hd, layers, window, alibi, int8):
    """The layers' caches (each its own), q, lengths and the extras."""
    L = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    extra = {}
    if alibi:
        from deepspeed_tpu_torch.models.bloom import slopes_on
        extra["alibi_slopes"] = slopes_on(H, "cuda")
    if window:
        extra["min_pos"] = torch.clamp(L - window, min=0).to(torch.int32)
    caches = []
    for _ in range(layers):
        k = torch.randn(B, S_MAX, KV, hd, generator=g, device="cuda")
        v = torch.rand(B, S_MAX, KV, hd, generator=g, device="cuda") * 2 - 1
        if int8:
            (kq, ks), (vq, vs) = da.quantize_kv(k), da.quantize_kv(v)
            caches.append((kq, vq, dict(k_scale=ks, v_scale=vs)))
        else:
            caches.append((k.to(torch.bfloat16), v.to(torch.bfloat16), {}))
    return q, L, extra, caches


def sdpa_ms(torch, F, q, L, extra, caches, H, KV, sm_scale):
    """SDPA's device time per call with the same mask (bf16 cache)."""
    pos = torch.arange(S_MAX, device="cuda")
    first = extra.get("min_pos", torch.zeros_like(L))
    valid = (pos[None] < L[:, None]) & (pos[None] >= first[:, None])
    if "alibi_slopes" in extra:
        mask = torch.where(valid[:, None, None],
                           extra["alibi_slopes"][None, :, None, None]
                           * pos.float(), float("-inf")).to(torch.bfloat16)
    else:
        mask = valid[:, None, None]
    kt = [(c[0].transpose(1, 2), c[1].transpose(1, 2)) for c in caches]
    qt = q[:, :, None]
    return device_ms(torch, [
        lambda a=a: F.scaled_dot_product_attention(
            qt, a[0], a[1], attn_mask=mask, scale=sm_scale,
            enable_gqa=H != KV) for a in kt])


def ab(torch, da, calls, reps):
    """Every case over both caches, parent and change interleaved."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(13)
    order = ["parent", "change"]
    summary = {}
    for name, B, H, KV, hd, layers, window, alibi, sm in CASES:
        for int8 in (False, True):
            q, L, extra, caches = case_inputs(torch, da, g, B, H, KV, hd,
                                              layers, window, alibi, int8)
            kw = [dict(sm_scale=sm, **c[2], **extra) for c in caches]
            c0, w0 = caches[0], kw[0]
            ref = da.decode_attention_plain(q, c0[0], c0[1], L, **w0)
            outs = {n: calls[n](q, c0[0], c0[1], L, **w0) for n in order}
            torch.cuda.synchronize()
            scale = max(float(ref.float().abs().max()), 1e-30)
            rel = {n: float((o.float() - ref.float()).abs().max()) / scale
                   for n, o in outs.items()}
            diff = float((outs["change"].float() - outs["parent"].float())
                         .abs().max()) / scale
            sweeps = {n: [lambda c=c, w=w, f=calls[n]: f(q, c[0], c[1], L,
                                                         **w)
                          for c, w in zip(caches, kw)] for n in order}
            times = {n: [] for n in order}
            per_call = {n: set() for n in order}
            for _ in range(reps):
                for n in ("parent", "change", "change", "parent"):
                    ms, k = device_ms(torch, sweeps[n], one_kernel=True)
                    times[n].append(ms)
                    per_call[n].add(k)
            med = {n: statistics.median(t) for n, t in times.items()}
            first = extra.get("min_pos", torch.zeros_like(L))
            npos = int((L - first).sum())
            per_pos = KV * hd * 2 * (1 if int8 else 2) + (KV * 8 if int8
                                                          else 0)
            bytes_ = (npos * per_pos + 2 * B * H * hd * 2 + 4 * B
                      + (4 * H if alibi else 0) + (4 * B if window else 0))
            host = {"parent": [], "change": []}
            for _ in range(reps):
                for n in ("parent", "change", "change", "parent"):
                    host[n].append(host_ms_per_call(
                        torch, lambda f=calls[n]: f(q, c0[0], c0[1], L,
                                                    **w0), n=100))
            host = {n: statistics.median(h) for n, h in host.items()}
            row = {"case": name, "cache": "int8" if int8 else "bf16",
                   "B": B, "H": H, "KV": KV, "hd": hd, "layers": layers,
                   "attended_positions": npos,
                   "chunk_positions": da.chunk_positions(
                       hd, torch.int8 if int8 else torch.bfloat16),
                   "device_ms": med, "device_ms_all": times,
                   "kernels_per_call": {n: sorted(v)
                                        for n, v in per_call.items()},
                   "parent_over_change": med["parent"] / med["change"],
                   "bound_ms": bytes_ / HBM_BPS * 1e3,
                   "change_over_bound": med["change"] / (bytes_ / HBM_BPS
                                                         * 1e3),
                   "host_ms": host, "rel_err_vs_plain": rel,
                   "change_vs_parent_rel": diff}
            if not int8:
                s_ms, s_n = sdpa_ms(torch, F, q, L, extra, caches, H, KV, sm)
                row.update(sdpa_device_ms=s_ms, sdpa_kernels_per_call=s_n,
                           change_over_sdpa=med["change"] / s_ms)
            print(json.dumps(row), flush=True)
            summary[f"{name}.{row['cache']}"] = {
                **med, "sdpa": row.get("sdpa_device_ms"),
                "bound": row["bound_ms"], "host_ms": host}
            del caches, sweeps, outs, ref
            torch.cuda.empty_cache()
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a csrc directory "
                    "holding an earlier decode_attention.cu (and headers)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch_flash_fwd_ab import build_variants
    from deepspeed_tpu_torch.ops.kernels import decode_attention as da
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    parent = build_variants("decode_attention", {}, args.parent)["parent"]
    da.build.build(["decode_attention"])
    calls = {"parent": parent_call(torch, da, parent),
             "change": da.decode_attention_cuda}
    summary = ab(torch, da, calls, args.reps)
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
