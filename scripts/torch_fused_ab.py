#!/usr/bin/env python3
"""Same-call A/B of the port's fused decode layer (deepspeed_tpu_torch/csrc/
fused_decode.cuh) and int8 qgemm (csrc/qgemm.cu), the decode weight stream's
two users, against an earlier commit's on one GPU.

    python3 scripts/torch_fused_ab.py --parent DIR [--reps N] [--sass]

DIR is an earlier commit's csrc directory (e.g. unpacked by ``git archive
<commit> deepspeed_tpu_torch/csrc``).  Its fused_decode library (the C
entry points and the eight dtype instances, as ops/kernels/build.py PARTS
builds them) and its qgemm.cu are built with its own headers into
build/torch_kernels/ab/; the parent's fused layer is launched through the
checkout's wrapper with the argument block cut to the parent's layout (the
fields before the attention workspace), its qgemm through its own C entry
point with its own workspace.

Readings, medians over ``--reps`` rounds of parent, change, change, parent:
  - each fused spec's layer at B 8, W 1, DECODE_LENS (<= 1023), bf16
    compute, over the model's own layers' weights and caches (GPT-2 760M
    int8 weights and cache, Llama-2 7B bf16, Mixtral-8x7B's attention half
    int8, GPT-NeoX-20B bf16 and int8, BLOOM-560m bf16): the device time a
    call (torch.profiler, one kernel a call; chip_smoke.py's ``device_ms``)
    and each phase's time from the kernel's own stamps (median over the
    layers), with the GEMM phases' weight bytes over their time (TB/s);
    beside them the decode attention kernel's device time over the same
    caches at lengths + 1 (the attention phase's yardstick) and the bytes
    bound;
  - qgemm at M 8, bf16 rows, GPT-2 760M's four projections over 24 layers'
    own weights: each projection's device time, parent and change, beside
    torch.matmul on the weights dequantized to bf16 (context: it reads
    twice the bytes; the port never calls it) and the bound;
  - the outputs of parent and change against the plain versions.
``--sass``: the sources this change does not mean to alter, function by
function against DIR's (scripts/torch_build_times.py ``sass``).

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
sys.path.insert(0, str(ROOT / "scripts"))

#: sources whose machine code this change must leave as DIR's
SASS = ("ds_flash_fwd", "ds_flash_bwd", "decode_attention", "grouped_gemm",
        "grouped_gemm_hopper", "grouped_gemm_stream",
        "block_sparse_attention", "quantization")
#: (name, family, int8 weights, int8 cache, layers timed)
SPECS = (("gpt2_760m", "gpt2", True, True, 12),
         ("llama_7b", "llama_7b", False, False, 6),
         ("mixtral_8x7b_attn", "mixtral_8x7b", True, True, 12),
         ("neox_20b", "neox_20b", False, False, 4),
         ("neox_20b_int8", "neox_20b", True, True, 6),
         ("bloom_560m", "bloom_560m", False, False, 12))
#: the GEMM phases and their projections' weight keys
GEMM_PHASES = {"qkv_gemm": ("wqkv", "wq", "wk", "wv"),
               "out_proj_gemm": ("wo",),
               "mlp_in_gemm": ("w_in", "w_gate", "w_up"),
               "mlp_out_gemm": ("w_out", "w_down")}


def build_parent_fused(parent):
    """DIR's fused_decode library: its entry source and eight instances,
    one nvcc each, all started together, then linked."""
    from deepspeed_tpu_torch.ops.kernels import build
    out = ROOT / "build" / "torch_kernels" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    t0 = time.perf_counter()
    procs, objs = [], []
    for i, (tag, src, flags) in enumerate(build.units("fused_decode")):
        obj = out / f"fused_parent_{i}.o"
        objs.append(obj)
        procs.append((tag, subprocess.Popen(
            [nvcc, *build.OBJECT_FLAGS, *flags, "-I", str(parent), "-o",
             str(obj), str(parent / f"{src}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for tag, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"parent {tag} did not build:\n{log}")
    so = out / "fused_decode_parent.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                   check=True)
    print(json.dumps({"built": "parent fused_decode",
                      "build_s": time.perf_counter() - t0}), flush=True)
    return ctypes.CDLL(str(so))


def parent_fused_fn(fd, lib):
    """A stand-in for the wrapper's entry point that hands the parent its
    own argument layout (every field before the attention workspace)."""
    fields = fd._FusedArgs._fields_
    cut = [n for n, _ in fields].index("attn_ws")

    class ParentArgs(ctypes.Structure):
        _fields_ = fields[:cut]
    if lib.ds_fused_layer_args_size() != ctypes.sizeof(ParentArgs):
        raise SystemExit("the parent's FusedArgs is not the leading fields "
                         "of the change's")
    fn = lib.ds_fused_layer
    i32 = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ParentArgs), i32, i32, i32,
                   ctypes.c_void_p]
    fn.restype = i32

    def call(args, is_bf16, w8, c8, stream):
        a = args._obj
        pa = ParentArgs()
        for name, _ in ParentArgs._fields_:
            setattr(pa, name, getattr(a, name))
        return fn(ctypes.byref(pa), is_bf16, w8, c8, stream)
    return call


def parent_qgemm(torch, lib):
    fn = lib.ds_qgemm
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i32] * 5 + [p]
    fn.restype = i32

    def make(x, q, s):
        M, K = x.shape
        N, nb = q.shape[1], s.shape[1]
        tiles = -(-N // 64) * -(-M // 64)
        ws = torch.empty(max(8 * tiles * 4096, 16 * -(-N // 256) * 2048),
                         dtype=torch.float32, device="cuda")
        cnt = torch.zeros(tiles, dtype=torch.int32, device="cuda")

        def call():
            out = torch.empty((M, N), dtype=x.dtype, device="cuda")
            rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), cnt.data_ptr(), M, N, K, nb, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent ds_qgemm: cudaError_t {rc}")
            return out
        return call
    return make


def specs_by_family():
    import chip_smoke as cs
    from deepspeed_tpu_torch.models.gpt2 import _fused_spec, gpt2_model
    out = {"gpt2": (_fused_spec(gpt2_model("760m").config), cs.M760, 0.02)}
    for name, spec, M in cs.family_specs():
        out[name] = (spec, M, 0.02)
    for name, spec, M, res in cs.slice7_specs():
        out[name] = (spec, M, res)
    return out


def fused_ab(torch, fd, da, qz, parent_fn, reps):
    import chip_smoke as cs
    from deepspeed_tpu_torch.models.bloom import slopes_on
    g = torch.Generator(device="cuda").manual_seed(17)
    dt = torch.bfloat16
    lens = torch.tensor([min(n, 1023) for n in cs.DECODE_LENS],
                        dtype=torch.int32, device="cuda")
    fams = specs_by_family()
    change_fn = fd._lib()
    summary = {}
    for name, fam, w8, c8, L in SPECS:
        spec, M, res = fams[fam]
        if fam == "gpt2":
            layers = [cs.fused_weights(torch, g, dt, w8, qz)
                      for _ in range(L)]
        else:
            layers = [cs.spec_weights(torch, g, spec, M, dt, w8, qz, res)
                      for _ in range(L)]
        caches = [cs.spec_cache(torch, g, dt, c8, da, spec.num_kv_heads,
                                spec.head_dim) for _ in range(L)]
        sl = slopes_on(spec.num_heads, "cuda") if spec.alibi else None
        x = torch.randn(8, 1, spec.d_model, generator=g,
                        device="cuda").to(dt)
        which = {"parent": parent_fn, "change": change_fn}

        def run(branch, cw, c, stamps=None):
            fd._lib = lambda: which[branch]
            return fd.fused_layer_cuda(x, cw, c[0], c[1], lens, spec, c[2],
                                       c[3], sl, stamps=stamps)
        ref = fd.fused_layer_plain(x, layers[0], *caches[0][:2], lens, spec,
                                   *caches[0][2:], sl)
        err = {}
        for b in which:
            got = run(b, layers[0], caches[0])
            torch.cuda.synchronize()
            err[b] = cs.err_of(torch, got[0], ref[0], "bfloat16")[1]
        dev = {"parent": [], "change": []}
        phases = {"parent": [], "change": []}
        st = torch.zeros(len(fd.PHASES) + 1, dtype=torch.int64,
                         device="cuda")
        for _ in range(reps):
            for b in ("parent", "change", "change", "parent"):
                fns = [lambda cw=cw, c=c, b=b: run(b, cw, c)
                       for cw, c in zip(layers, caches)]
                dev[b].append(cs.device_ms(torch, fns, one_kernel=True)[0])
                rows = []
                for cw, c in zip(layers, caches):
                    run(b, cw, c, st)
                    t = st.tolist()
                    rows.append([(v1 - v0) / 1e3 for v0, v1 in zip(t, t[1:])])
                phases[b].append({n: statistics.median(r[i] for r in rows)
                                  for i, n in enumerate(fd.PHASES)})
        fd._lib = lambda: change_fn
        med = {b: statistics.median(t) for b, t in dev.items()}
        ph = {b: {n: statistics.median(p[n] for p in phases[b])
                  for n in fd.PHASES} for b in phases}
        wbytes = {k: cs.nbytes(v) for k, v in layers[0].items()}
        tbs = {b: {n: sum(wbytes.get(k, 0) for k in keys)
                   / (ph[b][n] * 1e-6) / 1e12 if ph[b][n] > 0 else None
                   for n, keys in GEMM_PHASES.items()} for b in ph}
        # the decode attention kernel over the same caches (lengths + 1)
        q = torch.randn(8, spec.num_heads, spec.head_dim, generator=g,
                        device="cuda").to(dt)
        dec = [lambda c=c: da.decode_attention_cuda(
            q, c[0], c[1], lens + 1, spec.sm_scale, c[2], c[3], sl)
            for c in caches]
        dec_ms = cs.device_ms(torch, dec, one_kernel=True)[0]
        bound, by, wb, cb = cs.fused_bound(spec, M, layers[0], lens, c8)
        row = {"kernel": "ds_fused_layer", "spec": name, "int8_weights": w8,
               "int8_cache": c8, "layers": L, "device_ms": med,
               "device_ms_all": dev,
               "parent_over_change": med["parent"] / med["change"],
               "phase_us": ph, "gemm_phase_tb_s": tbs,
               "decode_attention_device_ms": dec_ms,
               "attention_over_decode": ph["change"]["attention"] / 1e3
               / dec_ms,
               "bound_ms": bound, "bound_by": by, "weight_bytes": wb,
               "cache_bytes": cb, "change_over_bound": med["change"] / bound,
               "held_vs_plain": err}
        print(json.dumps(row), flush=True)
        summary[name] = {**med, "bound": bound, "decode_ms": dec_ms,
                         "attention_us": ph["change"]["attention"],
                         "gemm_tb_s": tbs["change"]}
        del layers, caches, dec
        torch.cuda.empty_cache()
    return summary


def qgemm_ab(torch, qg, qz, make_parent, reps):
    import chip_smoke as cs
    g = torch.Generator(device="cuda").manual_seed(18)
    L = cs.LAYERS
    summary = {}
    for name, (K, N) in cs.PROJ_SHAPES.items():
        w = (torch.randn(L, K, N, generator=g, device="cuda")
             * 0.02).to(torch.bfloat16)
        q, s = qz.block_quantize_int8(w)
        deq = qz.block_dequantize_int8(q, s).to(torch.bfloat16)
        x = torch.randn(8, K, generator=g, device="cuda").to(torch.bfloat16)
        calls = {"parent": [make_parent(x, q[l], s[l]) for l in range(L)],
                 "change": [lambda l=l: qg.qgemm_cuda(x, q[l], s[l])
                            for l in range(L)]}
        ref = qg.qgemm_plain(x, q[0], s[0])
        err = {b: cs.err_of(torch, c[0](), ref, "bfloat16")[1]
               for b, c in calls.items()}
        dev = {"parent": [], "change": []}
        for _ in range(reps):
            for b in ("parent", "change", "change", "parent"):
                dev[b].append(cs.device_ms(torch, calls[b],
                                           one_kernel=True)[0])
        med = {b: statistics.median(t) for b, t in dev.items()}
        mm = cs.device_ms(torch, [lambda l=l: x @ deq[l]
                                  for l in range(L)])[0]
        nb = s.shape[-1]
        bound, by = cs.bound_of(K * N + K * nb * 4 + 8 * K * 2 + 8 * N * 2,
                                2 * 8 * K * N, cs.BF16_FLOPS)
        row = {"kernel": "qgemm", "proj": name, "M": 8, "K": K, "N": N,
               "device_ms": med, "device_ms_all": dev,
               "matmul_bf16_device_ms": mm, "bound_ms": bound,
               "bound_by": by, "held_vs_plain": err,
               "route": qg.qgemm_route(8, K, N, nb, torch.bfloat16)}
        print(json.dumps(row), flush=True)
        summary[name] = {**med, "matmul": mm, "bound": bound}
        del w, q, s, deq, calls
        torch.cuda.empty_cache()
    summary["layer"] = {k: sum(v[k] for v in summary.values())
                        for k in ("parent", "change", "matmul", "bound")}
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
                    "holding an earlier fused_decode.cu and qgemm.cu (and "
                    "their headers)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--sass", action="store_true",
                    help="also compare the SASS of the unchanged kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch_flash_fwd_ab import build_variants
    from deepspeed_tpu_torch.ops.kernels import build
    from deepspeed_tpu_torch.ops.kernels import decode_attention as da
    from deepspeed_tpu_torch.ops.kernels import fused_decode as fd
    from deepspeed_tpu_torch.ops.kernels import qgemm as qg
    from deepspeed_tpu_torch.ops.kernels import quantization as qz
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    parent = Path(args.parent).resolve()
    build.build(["fused_decode", "qgemm", "decode_attention",
                 "quantization"])
    pf = parent_fused_fn(fd, build_parent_fused(parent))
    pq = parent_qgemm(torch, build_variants("qgemm", {}, str(parent))
                      ["parent"])
    summary = {"fused": fused_ab(torch, fd, da, qz, pf, args.reps),
               "qgemm": qgemm_ab(torch, qg, qz, pq, args.reps)}
    if args.sass:
        summary["sass_functions_differing"] = sass_equal(parent)
    print(smi, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
