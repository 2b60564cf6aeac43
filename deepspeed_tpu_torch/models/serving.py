"""KV-cache serving paths shared by the model families (counterpart of
``deepspeed_tpu/models/serving.py``): ``write_token`` / ``select_token`` /
``init_cache``, the int8-weights routing, the fused per-layer pass, and
the generic hook-driven ``prefill`` (:416) and ``decode_step`` (:466)
that Llama, Mixtral, GPT-NeoX and BLOOM serve through (GPT-2 and GPT-Neo
keep their own in ``models/gpt2.py``).  BLOOM's ALiBi rides two hooks:
an ``attn_fn`` prefill attention and the decode kernel's
``alibi_slopes`` form.

The reference is functional: a write returns a new cache.  Here the
cache is updated in place — ``index_put_`` on one layer's slice — which
saves a copy of the whole cache per decode step.

Cache dict: ``{"k", "v"}`` [L, B, S, KV, hd], plus ``{"k_s", "v_s"}``
[L, B, S, KV] fp32 for an int8 cache (one symmetric scale per cached head
vector, ``ops/kernels/decode_attention.py`` helpers).

The reference's scan-form decode for large int8 models
(``use_scan_decode`` / ``quant_scan_threshold``) is not ported: with the
qgemm kernel consuming every quantized projection and router in place,
and the int8 grouped GEMMs every expert stack, nothing is left to
dequantize inside the decode loop, and the reference keeps its unrolled
loop in that case too (int8 Mixtral at any scale).  Prefill dequantizes
each layer whole, as the reference's prefill does.
"""
import torch

from deepspeed_tpu_torch.models.model import (QuantizedTensor, layer_params,
                                              maybe_stream)
from deepspeed_tpu_torch.ops.attention import causal_attention
from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, quantize_kv, quantize_prefill_into_cache)


def select_token(c_l, new, lengths):
    """Write ``new`` [B, ...] at per-row positions ``lengths`` [B] into one
    layer's cache slice ``c_l`` [B, S, ...], in place; returns ``c_l``."""
    rows = torch.arange(c_l.shape[0], device=c_l.device)
    c_l[rows, lengths.long()] = new.to(c_l.dtype)
    return c_l


def write_token(c, l, new, lengths):
    """One decode step's vectors ``new`` [B, ...] into layer ``l`` of the
    stacked cache ``c`` [L, B, S, ...] at positions ``lengths`` [B], in
    place (see :func:`select_token`); returns ``c``."""
    select_token(c[l], new, lengths)
    return c


def init_cache(num_layers, num_kv_heads, head_dim, batch_size, max_len,
               dtype, device):
    """Zero cache of shape [L, batch_size, max_len, KV, head_dim]:
    ``{"k", "v"}`` in ``dtype``, or for ``dtype="int8"`` int8 ``k``/``v``
    plus fp32 ``k_s``/``v_s`` [L, batch_size, max_len, KV] of ones."""
    shape = (num_layers, batch_size, max_len, num_kv_heads, head_dim)
    if str(dtype) in ("int8", "torch.int8"):
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device),
                "v_s": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def qgemm_active(blocks) -> bool:
    """Whether the decode path hands the layer's int8 weights to the
    kernels that consume them in place — projections and routers
    (``QuantizedTensor`` leaves of [L, in, out], nested dicts such as
    Mixtral's ``moe`` included) to qgemm, and, through the same flag,
    expert stacks ([L, E, in, out]) to the int8 grouped GEMMs — in place
    of a dequantized copy.  The reference turns this on where its kernels
    are real (TPU); the port's wrappers are real on CUDA and their plain
    versions on the CPU compute the same dequantize-then-matmul as the
    reference's jnp path, so it is on whenever the blocks are quantized."""
    def any_stacked_projection(tree):
        return any(any_stacked_projection(w) if isinstance(w, dict)
                   else isinstance(w, QuantizedTensor) and w.q.dim() == 3
                   for w in tree.values())
    return any_stacked_projection(blocks)


def fused_decode_active(spec, fused_decode) -> bool:
    """Whether decode takes the fused per-layer path: the caller asked for
    it (``serving.fused_decode``).  ``None`` and ``False`` are the unfused
    path (the reference turns ``None`` on by default on a TPU; the port
    leaves it off until the fused step is measured against CUDA graphs).
    An explicit request on a family the fused kernel does not take raises
    ``NotImplementedError`` naming why: GPT-J's interleaved rotary (the
    spec refuses it) and GPT-Neo (it wires no spec: its windowed layers).
    The reference's kernel never fuses either and quietly runs them
    unfused; the port never does so quietly."""
    if not fused_decode:
        return False
    why = "the family wires no fused-layer spec" if spec is None \
        else spec.unsupported()
    if why is not None:
        raise NotImplementedError(
            f"serving.fused_decode=true: {why}: the fused layer kernel does "
            "not take it, as the reference's kernel does not (it runs GPT-J's "
            "interleaved rotary and GPT-Neo's windowed layers unfused); serve "
            "with fused_decode off")
    return True


def _fused_keep_quantized(blocks) -> bool:
    """Int8 projection weights stay ``QuantizedTensor`` into the fused
    path: the kernel dequantizes them inside (CUDA), and the plain
    version's projections go through qgemm's plain version (CPU): the
    same condition as :func:`qgemm_active`."""
    return qgemm_active(blocks)


def _fused_layer_pass(params, x, cache, lengths, *, spec, weights_fn,
                      moe_tail_fn=None, alibi_slopes=None):
    """The fused per-layer loop (W = 1 for decode): ONE ``ds_fused_layer``
    call per layer replaces the QKV / rotary / cache write / decode
    attention / finish composition, then the window's new K/V (and, for
    an int8 cache, their scales) land in the stacked cache with
    ``write_token``.  ``moe_tail_fn(x, layer) -> x`` runs a family's
    routed-expert FFN after the kernel (``mlp="none"`` specs: the experts
    stay on the grouped-GEMM kernels), as the reference's; an ``alibi``
    spec takes its ``alibi_slopes`` [H].  Returns (x [B, W, D], cache)."""
    from deepspeed_tpu_torch.ops.kernels.fused_decode import ds_fused_layer
    blocks = params["blocks"]
    quantized = "k_s" in cache
    keep_q = _fused_keep_quantized(blocks)
    kc, vc = cache["k"], cache["v"]
    ksc, vsc = (cache["k_s"], cache["v_s"]) if quantized else (None, None)
    W = x.shape[1]
    for l in range(kc.shape[0]):
        layer = maybe_stream(layer_params(blocks, l), keep_quantized=keep_q)
        x, nk, nv, nks, nvs = ds_fused_layer(
            x, weights_fn(layer), kc[l], vc[l], lengths, spec,
            ks_l=ksc[l] if quantized else None,
            vs_l=vsc[l] if quantized else None, alibi_slopes=alibi_slopes)
        for j in range(W):
            write_token(kc, l, nk[:, j], lengths + j)
            write_token(vc, l, nv[:, j], lengths + j)
            if quantized:
                write_token(ksc, l, nks[:, j], lengths + j)
                write_token(vsc, l, nvs[:, j], lengths + j)
        if moe_tail_fn is not None:
            x = moe_tail_fn(x, layer)
    return x, cache


def prefill(params, batch, cache, *, embed_fn, qkv_fn, finish_fn, head_fn,
            num_heads, attention_impl, attn_fn=None):
    """Causal forward over right-padded prompts [B, S] filling cache
    positions [0, S) in place (the reference's hook-driven ``prefill``;
    an int8 cache gets the quantized K/V).  ``qkv_fn(x, layer, positions)``
    -> q [B, S, H, hd], k/v [B, S, KV, hd] (KV heads not repeated: the
    cache stays compact); ``finish_fn(x, attn [B, S, H * hd], layer)`` ->
    x; ``attn_fn(q, k, v)`` replaces the causal attention (BLOOM's ALiBi
    form).  Returns (logits [B, S, V], cache)."""
    tokens = batch["input_ids"]
    B, S = tokens.shape
    x = embed_fn(params, tokens)
    quantized = "k_s" in cache
    for l in range(cache["k"].shape[0]):
        layer = maybe_stream(layer_params(params["blocks"], l))
        q, kk, v = qkv_fn(x, layer, None)
        attn = (causal_attention(q, kk, v, impl=attention_impl)
                if attn_fn is None else attn_fn(q, kk, v))
        if quantized:
            quantize_prefill_into_cache(
                {name: c[l:l + 1] for name, c in cache.items()}, kk[None],
                v[None])
        else:
            cache["k"][l, :, :S] = kk
            cache["v"][l, :, :S] = v
        x = finish_fn(x, attn.reshape(B, S, num_heads * q.shape[-1]), layer)
    return head_fn(params, x), cache


def decode_step(params, tokens, cache, lengths, *, embed_fn, qkv_fn,
                finish_fn, head_fn, num_heads, fused=False, fused_spec=None,
                fused_weights_fn=None, moe_tail_fn=None, alibi_slopes=None):
    """One decode step (the reference's hook-driven ``decode_step``):
    tokens [B], lengths [B] int32 = current cache fill per row.  Rotary
    positions are per row (``lengths``); the GQA cache stays compact and
    the decode-attention kernel maps query heads to KV heads.  Int8
    blocks keep their projections, routers and expert stacks quantized
    into qgemm and the int8 grouped GEMMs (:func:`qgemm_active`).  Writes
    the new K/V (quantized for an int8 cache) into ``cache`` in place and
    returns (logits [B, V], cache).  ``fused=True`` (checked by
    :func:`fused_decode_active`): one ``ds_fused_layer`` per layer with
    ``fused_spec`` over ``fused_weights_fn(layer)``, then
    ``moe_tail_fn`` where the family has one (Mixtral's experts).
    ``alibi_slopes`` [H] fp32 selects the decode kernel's ALiBi form (and
    goes to the fused layer of an ``alibi`` spec)."""
    B = tokens.shape[0]
    x = embed_fn(params, tokens[:, None])[:, 0]                 # [B, D]
    if fused_decode_active(fused_spec, fused):
        x, cache = _fused_layer_pass(params, x[:, None, :], cache, lengths,
                                     spec=fused_spec,
                                     weights_fn=fused_weights_fn,
                                     moe_tail_fn=moe_tail_fn,
                                     alibi_slopes=alibi_slopes)
        return head_fn(params, x)[:, 0], cache
    quantized = "k_s" in cache
    keep_q = qgemm_active(params["blocks"])
    kc, vc = cache["k"], cache["v"]
    fill = (lengths + 1).to(torch.int32)
    for l in range(kc.shape[0]):
        layer = maybe_stream(layer_params(params["blocks"], l),
                             keep_quantized=keep_q)
        q, kk, v = qkv_fn(x[:, None, :], layer, lengths[:, None])
        hd = q.shape[-1]
        if quantized:
            kq, ks1 = quantize_kv(kk[:, 0])
            vq, vs1 = quantize_kv(v[:, 0])
            write_token(kc, l, kq, lengths)
            write_token(vc, l, vq, lengths)
            write_token(cache["k_s"], l, ks1, lengths)
            write_token(cache["v_s"], l, vs1, lengths)
            attn = decode_attention(q[:, 0].contiguous(), kc[l], vc[l], fill,
                                    k_scale=cache["k_s"][l],
                                    v_scale=cache["v_s"][l],
                                    alibi_slopes=alibi_slopes)
        else:
            write_token(kc, l, kk[:, 0], lengths)
            write_token(vc, l, v[:, 0], lengths)
            attn = decode_attention(q[:, 0].contiguous(), kc[l], vc[l], fill,
                                    alibi_slopes=alibi_slopes)
        x = finish_fn(x[:, None, :],
                      attn.reshape(B, 1, num_heads * hd).to(x.dtype),
                      layer)[:, 0, :]
    return head_fn(params, x[:, None, :])[:, 0], cache
