"""deepspeed_tpu_torch fused per-layer decode vs the JAX package.

The port's plain fused layer (what ``ds_fused_layer`` runs for CPU
tensors; the CUDA megakernel is held against it on the card by
chip_smoke.py) is compared with the JAX Pallas ``_fused_kernel`` in
interpret mode and with the JAX reference composition
``_ref_fused_layer``, on the same seeded numpy inputs: the GPT-2 spec,
the Llama spec (RMSNorm, split Q/K/V, full rotary, GQA rep 2, SwiGLU;
with and without the InternLM biases), Mixtral's attention-half spec
(``mlp="none"``), the GPT-NeoX specs (head-major QKV, partial rotary,
exact GELU; the parallel residual at head_dim 96 with 24 rotary dims,
the serial one at head_dim 64 with 16) and the BLOOM spec (head-major
QKV, ALiBi), each in the four weight x cache combinations (float /
int8 weights x float / int8 cache) at window W = 1 and W = 3; and one
spec feature at a time on the GPT-2 spec.

Tolerances (fp32): x_out and float K/V within 2e-4 abs of the Pallas
kernel (the JAX package's own kernel-vs-reference bound: the kernel
streams the cache in blocks with an online softmax and dequantizes
weights through a selector matmul), within 1e-5 of the reference
composition; int8 K/V codes within one code and their scales within
1e-6 relative of both.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.models.bloom import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.models.model import QuantizedTensor as JaxQuantized
from deepspeed_tpu.ops.pallas.decode_attention import \
    quantize_kv as jax_quantize_kv
from deepspeed_tpu.ops.pallas.fused_decode import \
    FusedLayerSpec as JaxSpec
from deepspeed_tpu.ops.pallas.fused_decode import (_ref_fused_layer,
                                                   _weight_order)
from deepspeed_tpu.ops.pallas.fused_decode import \
    ds_fused_layer as jax_fused_layer
from deepspeed_tpu.ops.pallas.quantization import _ref_quantize
from deepspeed_tpu_torch.models import gpt2 as pgpt2
from deepspeed_tpu_torch.models.gpt2 import gpt2_model
from deepspeed_tpu_torch.models.model import QuantizedTensor
from deepspeed_tpu_torch.ops.kernels import fused_decode as fd

D, H, HD, M = 32, 4, 8, 128
ATOL_KERNEL = 2e-4
ATOL_REF = 1e-5
#: the Llama spec at GQA rep 2 (the reference's llama.py:290-296 wiring)
LLAMA = dict(num_kv_heads=2, norm="rms", qkv="split", qkv_bias=False,
             out_bias=False, mlp="swiglu", mlp_bias=False, rotary_dims=HD)
#: Mixtral's attention half (mixtral.py:220-226): the experts run outside
MIXTRAL = dict(LLAMA, mlp="none")
#: GPT-NeoX (neox.py:233-243): head-major QKV, partial rotary, exact GELU,
#: the parallel residual; at NeoX-20B's head_dim 96 with its 24 rotary
#: dims (12 pairs), and the serial form at Pythia's head_dim 64 / 16
NEOX = dict(num_heads=2, num_kv_heads=2, head_dim=96, d_model=192,
            qkv="headmajor", mlp="gelu_exact", residual="parallel",
            rotary_dims=24)
NEOX_SERIAL = dict(NEOX, head_dim=64, d_model=128, residual="serial",
                   rotary_dims=16)
#: BLOOM (bloom.py:217-222): head-major QKV, ALiBi, tanh GELU
BLOOM = dict(qkv="headmajor", alibi=True)


def _spec(mod, **kw):
    args = dict(num_heads=H, num_kv_heads=H, head_dim=HD, d_model=D,
                norm="ln", qkv="fused", mlp="gelu_tanh")
    args.update(kw)
    return mod(**args)


def _shape(key, spec):
    D, HD = spec.d_model, spec.head_dim
    Dq, Dk = spec.num_heads * HD, spec.num_kv_heads * HD
    return {"n1_s": (D,), "n1_b": (D,), "n2_s": (D,), "n2_b": (D,),
            "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wq": (D, Dq),
            "wk": (D, Dk), "wv": (D, Dk), "bq": (Dq,), "bk": (Dk,),
            "bv": (Dk,), "wo": (Dq, D), "bo": (D,), "w_in": (D, M),
            "b_in": (M,), "w_out": (M, D), "b_out": (D,), "w_gate": (D, M),
            "w_up": (D, M), "w_down": (M, D)}[key]


def _weights(seed, spec=None):
    """Seeded canonical weights of ``spec`` (the GPT-2 spec when None):
    norm scales near 1, everything else N(0, 0.2) at d_model 32 and
    N(0, 0.2 * sqrt(32 / d_model)) wider, so the layer's outputs keep the
    magnitude the fp32 tolerances are stated for."""
    spec = spec or _spec(JaxSpec)
    rng = np.random.default_rng(seed)
    std = 0.2 * (D / spec.d_model) ** 0.5
    cw = {}
    for key in _weight_order(spec):
        v = rng.standard_normal(_shape(key, spec), dtype=np.float32)
        cw[key] = v * 0.1 + 1 if key.endswith("_s") else v * std
    return cw


def _is_mat(key):
    return key.startswith("w")


def _both(cw, int8_weights):
    """The same weights as JAX arrays and torch tensors; int8 weights
    quantized once (16-lane groups) and handed to both as the same
    bytes."""
    jw, pw = {}, {}
    for k, v in cw.items():
        if int8_weights and _is_mat(k):
            q, s = (np.asarray(a) for a in _ref_quantize(jnp.asarray(v), 16))
            jw[k] = JaxQuantized(jnp.asarray(q), jnp.asarray(s), "float32")
            pw[k] = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s),
                                    torch.float32)
        else:
            jw[k], pw[k] = jnp.asarray(v), torch.from_numpy(v.copy())
    return jw, pw


def _inputs(W, int8_cache, seed, B=2, S=64, KV=H, D=D, HD=HD):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, W, D), dtype=np.float32) * 0.2
    k = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    lengths = np.asarray([5, 17][:B], np.int32)
    if int8_cache:
        kq, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v)))
        return x, kq, vq, lengths, ks, vs
    return x, k, v, lengths, None, None


def _run(W, int8_weights, int8_cache, seed=3, **kw):
    spec_j, spec_p = _spec(JaxSpec, **kw), _spec(fd.FusedLayerSpec, **kw)
    jw, pw = _both(_weights(seed, spec_j), int8_weights)
    x, k, v, L, ks, vs = _inputs(W, int8_cache, seed + 1,
                                 KV=spec_p.num_kv_heads, D=spec_p.d_model,
                                 HD=spec_p.head_dim)
    sl = (np.asarray(jax_alibi_slopes(spec_p.num_heads), np.float32)
          if spec_p.alibi else None)
    J = lambda a: None if a is None else jnp.asarray(a)      # noqa: E731
    T = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    kern = jax_fused_layer(J(x), jw, J(k), J(v), J(L), spec_j, ks_l=J(ks),
                           vs_l=J(vs), alibi_slopes=J(sl), interpret=True)
    ref = _ref_fused_layer(J(x), jw, J(k), J(v), J(L), spec_j, J(ks), J(vs),
                           J(sl))
    got = fd.ds_fused_layer(T(x), pw, T(k), T(v), T(L), spec_p, ks_l=T(ks),
                            vs_l=T(vs), alibi_slopes=T(sl))
    return got, kern, ref


def _close(got, want, atol):
    names = ("x_out", "new_k", "new_v", "new_ks", "new_vs")
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a = a.float().numpy() if a.is_floating_point() else a.numpy()
        b = np.asarray(b)
        if b.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1, (name, d.max())
        elif name in ("new_ks", "new_vs"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b.astype(np.float32), atol=atol,
                                       rtol=0, err_msg=name)


COMBOS = [(w8, c8, W) for w8 in (False, True) for c8 in (False, True)
          for W in (1, 3)]


@pytest.mark.parametrize("int8_weights,int8_cache,W", COMBOS)
def test_plain_matches_pallas_interpret_and_reference(int8_weights,
                                                      int8_cache, W):
    got, kern, ref = _run(W, int8_weights, int8_cache)
    assert got[0].shape == (2, W, D)
    assert got[1].dtype == (torch.int8 if int8_cache else torch.float32)
    _close(got, kern, ATOL_KERNEL)
    _close(got, ref, ATOL_REF)


#: the Llama, Mixtral, GPT-NeoX and BLOOM specs (Llama with and without
#: the InternLM biases) in every weight x cache x window combination
FAMILY_SPECS = {"llama": LLAMA,
                "llama_biased": dict(LLAMA, qkv_bias=True, out_bias=True),
                "mixtral": MIXTRAL, "neox": NEOX, "neox_serial": NEOX_SERIAL,
                "bloom": BLOOM}


@pytest.mark.parametrize("family", sorted(FAMILY_SPECS))
@pytest.mark.parametrize("int8_weights,int8_cache,W", COMBOS)
def test_family_specs_match_pallas_interpret_and_reference(
        family, int8_weights, int8_cache, W):
    kw = FAMILY_SPECS[family]
    got, kern, ref = _run(W, int8_weights, int8_cache, seed=5, **kw)
    assert got[1].shape == (2, W, kw.get("num_kv_heads", H),
                            kw.get("head_dim", HD))
    _close(got, kern, ATOL_KERNEL)
    _close(got, ref, ATOL_REF)


@pytest.mark.parametrize("kw", [
    {"norm": "rms"}, {"qkv": "split"},
    {"qkv": "split", "num_kv_heads": 2}, {"rotary_dims": HD},
    {"mlp": "swiglu"}, {"mlp": "none"}, {"qkv_bias": False},
    {"alibi": True}, {"residual": "parallel"}, {"qkv": "headmajor"},
    {"rotary_dims": HD // 2}])
def test_one_spec_feature_matches_pallas_interpret_and_reference(kw):
    """Each feature of the Llama, Mixtral, GPT-NeoX and BLOOM specs alone
    on the GPT-2 spec, int8 cache, W 3."""
    got, kern, ref = _run(3, False, True, seed=7, **kw)
    _close(got, kern, ATOL_KERNEL)
    _close(got, ref, ATOL_REF)


def test_weight_order_matches_the_reference():
    for kw in ({}, {"mlp": "relu"}, {"qkv_bias": False}, LLAMA, MIXTRAL,
               dict(LLAMA, qkv_bias=True, out_bias=True), NEOX, NEOX_SERIAL,
               BLOOM):
        assert fd._weight_order(_spec(fd.FusedLayerSpec, **kw)) == \
            _weight_order(_spec(JaxSpec, **kw))


@pytest.mark.parametrize("kw", [
    {"rotary_dims": HD, "rotary_interleaved": True}])
def test_non_gpt2_specs_raise(kw):
    """GPT-J's interleaved rotary stays refused, as the reference's kernel
    refuses it (``fused_decode.py:114``): the plain version and the CUDA
    wrapper both raise, saying so."""
    spec = _spec(fd.FusedLayerSpec, **kw)
    assert not spec.supported()
    _, pw = _both(_weights(0), False)
    x, k, v, L, _, _ = _inputs(1, False, 1)
    args = (torch.from_numpy(x), pw, torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(L), spec)
    for fn in (fd.ds_fused_layer, fd.fused_layer_cuda):
        with pytest.raises(NotImplementedError,
                           match="as the reference's kernel does not"):
            fn(*args)


def test_alibi_slopes_go_with_an_alibi_spec():
    """An ALiBi spec needs its slopes, and no other spec takes them."""
    _, pw = _both(_weights(0), False)
    x, k, v, L, _, _ = _inputs(1, False, 1)
    T = torch.from_numpy
    for kw, sl in (({"alibi": True}, None), ({}, torch.ones(H))):
        for fn in (fd.ds_fused_layer, fd.fused_layer_cuda):
            with pytest.raises(ValueError, match="alibi_slopes"):
                fn(T(x), pw, T(k), T(v), T(L), _spec(fd.FusedLayerSpec, **kw),
                   alibi_slopes=sl)


def test_cuda_wrapper_validates_before_any_launch():
    spec = _spec(fd.FusedLayerSpec)
    _, pw = _both(_weights(0), True)
    x, k, v, L, ks, vs = _inputs(1, True, 2)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="ks_l and vs_l"):
        fd.fused_layer_cuda(T(x), pw, T(k), T(v), T(L), spec, ks_l=T(ks))
    with pytest.raises(ValueError, match="lengths"):
        fd.fused_layer_cuda(T(x), pw, T(k), T(v), T(L).long(), spec,
                            ks_l=T(ks), vs_l=T(vs))
    mixed = dict(pw, wo=torch.zeros(D, D))
    with pytest.raises(ValueError, match="all int8 or all float"):
        fd.fused_layer_cuda(T(x), mixed, T(k), T(v), T(L), spec, ks_l=T(ks),
                            vs_l=T(vs))
    # the phase stamps take one int64 per phase boundary
    with pytest.raises(ValueError, match="stamps"):
        fd.fused_layer_cuda(T(x), pw, T(k), T(v), T(L), spec, ks_l=T(ks),
                            vs_l=T(vs), stamps=torch.zeros(
                                len(fd.PHASES), dtype=torch.int64))


# ------------------------------------------------------ the decode step
def _tiny(dtype="float32"):
    return gpt2_model("custom", vocab_size=128, max_seq_len=64, num_layers=2,
                      num_heads=H, d_model=D, dtype=dtype)


def _params(model, int8_weights):
    from deepspeed_tpu_torch.inference.config import \
        DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(model, DeepSpeedInferenceConfig(
        dtype="float32", quant={"enabled": int8_weights}),
        device="cpu").params


class _Count:
    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("int8_weights,int8_cache",
                         [(w8, c8) for w8 in (False, True)
                          for c8 in (False, True)])
def test_fused_decode_step_matches_unfused(monkeypatch, int8_weights,
                                           int8_cache):
    """Teacher-forced decode: the fused step's logits and cache equal the
    unfused step's (the plain fused layer is the unfused composition), and
    each path calls what it should: fused = L fused layers and no decode
    attention or qgemm; unfused = 4 L qgemm (int8 weights) and L decode
    attentions per step; prefill no qgemm."""
    from deepspeed_tpu_torch.ops.kernels import qgemm as qg
    model = _tiny()
    params = _params(model, int8_weights)
    L_ = model.config.num_layers
    cdt = "int8" if int8_cache else None
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(1, 128, (2, 12)).astype(np.int32))
    counts = {"fused": _Count(fd.ds_fused_layer),
              "decode": _Count(pgpt2.decode_attention),
              "qgemm": _Count(qg.qgemm)}
    monkeypatch.setattr(fd, "ds_fused_layer", counts["fused"])
    monkeypatch.setattr(pgpt2, "decode_attention", counts["decode"])
    monkeypatch.setattr(qg, "qgemm", counts["qgemm"])
    runs = {}
    for fused in (False, True):
        cache = model.init_cache_fn(2, 64, cdt, "cpu")
        _, cache = model.prefill_fn(params, {"input_ids": toks[:, :6]},
                                    cache)
        assert counts["qgemm"].n == 0          # prefill dequantizes
        before = {k: c.n for k, c in counts.items()}
        logits = []
        for pos in range(6, 12):
            lg, cache = model.decode_fn(
                params, toks[:, pos], cache,
                torch.full((2,), pos, dtype=torch.int32), fused=fused)
            logits.append(lg)
        steps = 6
        got = {k: c.n - before[k] for k, c in counts.items()}
        if fused:
            assert got == {"fused": L_ * steps, "decode": 0, "qgemm": 0}
        else:
            assert got == {"fused": 0, "decode": L_ * steps,
                           "qgemm": 4 * L_ * steps if int8_weights else 0}
        for c in counts.values():
            c.n = 0
        runs[fused] = (torch.stack(logits), cache)
    (lu, cu), (lf, cf) = runs[False], runs[True]
    torch.testing.assert_close(lf, lu, atol=1e-6, rtol=0)
    for name in cu:
        torch.testing.assert_close(cf[name], cu[name], atol=1e-6, rtol=0)
