"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``
``InferenceEngine``): casts and places the params on one device and runs
the static generate loop.

KV-cache path (default): prefill fills a [L, B, S_max, KV, hd] cache and
each decode step runs the decode-attention kernel per layer, so a token
costs O(S) cache streaming.  ``use_cache=False`` keeps the O(S^2)
full-recompute loop as the numerics oracle; a model without the KV-cache
surface (BERT) takes that loop, as in the reference.  Sampling: greedy /
temperature / top-k / top-p with EOS early-stop.

Int8 serving, as the reference: ``quant.enabled`` stores every >= 3-dim
floating leaf of the stacked ``blocks`` (nested dicts such as Mixtral's
``moe`` included) as a ``QuantizedTensor`` (int8 codes plus fp32
per-256-lane scales from the block-quantization kernel), quantized from
the COMPUTE dtype and leaf by leaf — a 4-D expert stack [L, E, K, N]
slice by [layer, expert] slice — so peak device memory is the int8 total
plus one full-precision leaf (or expert slice); biases, norms, ``wte``,
``wpe`` and ``lm_head`` stay in the compute dtype.  A model with a device
init draws its int8 weights with ``Model.quantized_init_fn`` when no
params are given (Mixtral-8x7B: all 32 layers on one 80 GB card).
``kv_cache_dtype="int8"`` gives the static generate an int8 KV cache.
``generate(fused_decode=True)`` decodes with one fused-layer kernel per
layer.

Mixture-of-experts models (Mixtral) serve with float or int8 weights and
a float or int8 KV cache; their params are drawn on the device
(``Model.init_fn``) when none are given.

Refused here (not ported yet): tensor parallelism
(``tensor_parallel.tp_size > 1``), expert parallelism
(``moe.ep_size > 1``), and a float KV cache in a dtype other than the
compute dtype.
"""
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint.jax_params import block_leaf, to_tensor
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.sampling import sample
from deepspeed_tpu_torch.models.model import QuantizedTensor, quantized_parts
from deepspeed_tpu_torch.ops.kernels.quantization import (block_quantize_int8,
                                                          block_quantize_stack)
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.tree import tree_map


def torch_dtype(name) -> torch.dtype:
    """"bfloat16" / "float32" / torch.dtype -> torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unsupported dtype {name!r}")
    return dt


def _is_float(a) -> bool:
    """Whether a tensor or numpy leaf holds floating values (ml_dtypes'
    bfloat16 included)."""
    if torch.is_tensor(a):
        return a.is_floating_point()
    dt = np.asarray(a).dtype
    return dt.kind == "f" or dt.name == "bfloat16"


def refuse_unported(config: DeepSpeedInferenceConfig):
    """NotImplementedError for inference settings not ported yet, naming
    the ROADMAP.md item that brings them."""
    tp = (config.tensor_parallel.tp_size
          if config.tensor_parallel.enabled else 1)
    checks = (
        (config.moe.ep_size > 1, f"moe.ep_size={config.moe.ep_size}",
         "Queue A: data parallel, ZeRO and model parallelism"),
        (config.kv_cache_dtype not in (None, "int8", config.dtype),
         f"kv_cache_dtype={config.kv_cache_dtype!r} (a float cache in "
         "another dtype than the compute dtype)",
         "Queue A: serving extensions"),
        (tp > 1, f"tensor_parallel.tp_size={tp}",
         "Queue A: tensor-parallel serving"),
    )
    for on, what, item in checks:
        if on:
            raise NotImplementedError(
                f"{what}: not ported to deepspeed_tpu_torch yet "
                f"(ROADMAP.md {item})")


class InferenceEngine:
    def __init__(self, model, config: DeepSpeedInferenceConfig,
                 model_parameters=None, device=None):
        """``model_parameters``: a params tree of tensors or of numpy
        arrays (e.g. ``jax.device_get`` of the reference engine's
        params); None draws the model's seeded host init (seed 0)."""
        refuse_unported(config)
        self.model = model
        self._config = config
        self.device = resolve_device(device)
        self.dtype = torch_dtype(config.dtype)
        cfg_dtype = getattr(model.config, "dtype", None)
        if cfg_dtype is not None and torch_dtype(cfg_dtype) != self.dtype:
            raise ValueError(
                f"InferenceEngine: config dtype {config.dtype} differs from "
                f"the model's compute dtype {cfg_dtype}; build the model "
                f"with dtype={config.dtype!r}")
        #: the static generate's KV cache: "int8" or the compute dtype
        self.cache_dtype = ("int8" if config.kv_cache_dtype == "int8"
                            else self.dtype)
        if config.quant.enabled:
            if config.quant.bits != 8:
                logger.warning(f"quant.bits={config.quant.bits}: only 8-bit "
                               "weight quantization is implemented; using 8")
            if model_parameters is None \
                    and model.quantized_init_fn is not None:
                params = model.quantized_init_fn(0, self.device, self.dtype)
            else:
                params = self._quantized_params(
                    model.numpy_init_fn(0) if model_parameters is None
                    else model_parameters)
        elif model_parameters is None:
            params = model.init(0, self.device, self.dtype)
        else:
            leaf = model_parameters["wte"]
            if isinstance(leaf, np.ndarray):
                params = model.params_from_numpy_fn(
                    model_parameters, self.device, self.dtype)
            else:
                params = tree_map(
                    lambda t: t.to(self.device, self.dtype)
                    if t.is_floating_point() else t.to(self.device),
                    model_parameters)
        self.params = params
        logger.info(f"InferenceEngine: device={self.device}, "
                    f"dtype={self.dtype}, int8 weights="
                    f"{config.quant.enabled}, kv cache={self.cache_dtype}")

    def _quantized_params(self, tree) -> dict:
        """Place ``tree`` (numpy arrays or tensors) with the stacked
        ``blocks`` weights int8, leaf by leaf (the reference's
        ``engine.py:79-163``; nested dicts such as Mixtral's ``moe``
        included): each >= 3-dim floating leaf goes to the device in the
        compute dtype, is quantized there and freed before the next one —
        a 4-D expert stack one [layer, expert] slice at a time, into
        preallocated int8 / fp32 stacks — so peak device memory is the
        int8 total plus one full-precision leaf.  Leaves already quantized
        (a JAX int8 engine's ``QuantizedTensor``, a ``(q, s)`` pair) keep
        their bytes; every other leaf is cast to the compute dtype."""
        dev, dt = self.device, self.dtype
        if "blocks" not in tree:
            logger.warning("quant.enabled: params tree has no 'blocks' "
                           "subtree — nothing to quantize, serving at full "
                           "precision")
            return {k: to_tensor(v, dev, dt) for k, v in tree.items()}

        def pack(leaf):
            if isinstance(leaf, dict):
                return {k: pack(v) for k, v in leaf.items()}
            if quantized_parts(leaf) is not None:
                return block_leaf(leaf, dev, dt)
            if not _is_float(leaf) or len(leaf.shape) < 3:
                return to_tensor(leaf, dev, dt)
            if len(leaf.shape) == 3:       # [L, in, out]: one launch
                q, s = block_quantize_int8(to_tensor(leaf, dev, dt))
            else:                          # expert stacks: by slice
                q, s = block_quantize_stack(
                    tuple(leaf.shape),
                    lambda idx: to_tensor(leaf[idx], dev, dt), dev)
            return QuantizedTensor(q, s, dt)

        out = {k: to_tensor(v, dev, dt) for k, v in tree.items()
               if k != "blocks"}
        out["blocks"] = pack(tree["blocks"])
        return out

    # --------------------------------------------------------------- generate
    @staticmethod
    def _pad_bucket(n: int,
                    quantum: int = ContinuousBatchingScheduler.PROMPT_BUCKET
                    ) -> int:
        """The prefill length of an n-token prompt: the scheduler's own
        bucket, so both prefill at the same GEMM shapes (the reference
        pads generate's prompts to 64)."""
        return max(quantum, -(-n // quantum) * quantum)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 use_cache: bool = True, fused_decode: bool = False):
        """Autoregressive generation; returns int32 numpy
        [B, S + max_new_tokens].  Sampling draws from one
        ``torch.Generator`` seeded with ``seed``.  ``fused_decode``: decode
        steps run one fused-layer kernel per layer (the scheduler's
        ``serving.fused_decode``)."""
        input_ids = np.asarray(input_ids)
        if input_ids.ndim == 1:
            input_ids = input_ids[None]
        B, S = input_ids.shape
        max_ctx = getattr(self.model.config, "max_seq_len",
                          S + max_new_tokens)
        if S + max_new_tokens > max_ctx:
            raise ValueError(
                f"generate: prompt {S} + max_new_tokens {max_new_tokens} "
                f"exceeds model context {max_ctx}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sampler = dict(do_sample=do_sample, temperature=temperature,
                       top_k=int(top_k), top_p=float(top_p))
        cached_ok = (use_cache and self.model.init_cache_fn is not None
                     and self.model.prefill_fn is not None
                     and self.model.decode_fn is not None)
        if cached_ok:
            out = self._generate_cached(input_ids, max_new_tokens, gen,
                                        sampler, eos_token_id, max_ctx,
                                        fused_decode)
        else:
            out = self._generate_recompute(input_ids, max_new_tokens, gen,
                                           sampler, eos_token_id)
        return out.cpu().numpy()

    def _generate_cached(self, input_ids, max_new, gen, sampler, eos_id,
                         max_ctx, fused):
        """Prefill + per-token decode over the KV cache; the prompt pads
        to the scheduler's 16-token bucket (:meth:`_pad_bucket`) and the
        cache to a 64 multiple."""
        B, S = input_ids.shape
        dev = self.device
        prompt_pad = min(self._pad_bucket(S), max_ctx - max_new)
        if prompt_pad < S:
            prompt_pad = S
        total = prompt_pad + max_new
        cache_size = -(-total // 64) * 64
        tokens = torch.zeros((B, prompt_pad), dtype=torch.int32)
        tokens[:, :S] = torch.from_numpy(input_ids.astype(np.int32))
        tokens = tokens.to(dev)
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        cache = self.model.init_cache_fn(B, cache_size, self.cache_dtype,
                                         dev)
        logits, cache = self.model.prefill_fn(
            self.params, {"input_ids": tokens}, cache)
        rows = torch.arange(B, device=dev)
        nxt = sample(logits[rows, lengths.long() - 1], gen, **sampler)
        done = (torch.zeros(B, dtype=torch.bool, device=dev)
                if eos_id is None else nxt == eos_id)
        gen_tokens = [nxt]
        lens = lengths
        for _ in range(max_new - 1):
            logits, cache = self.model.decode_fn(self.params, nxt, cache,
                                                 lens, fused=fused)
            new = sample(logits, gen, **sampler)
            if eos_id is not None:
                new = torch.where(done, torch.full_like(new, eos_id), new)
                done = done | (new == eos_id)
            gen_tokens.append(new)
            nxt, lens = new, lens + 1
        out = torch.zeros((B, S + max_new), dtype=torch.int32, device=dev)
        out[:, :S] = tokens[:, :S]
        out[:, S:] = torch.stack(gen_tokens, dim=1)
        return out

    def _generate_recompute(self, input_ids, max_new, gen, sampler,
                            eos_id):
        """O(S^2) loop: a full forward per generated token (the oracle)."""
        B, S = input_ids.shape
        dev = self.device
        total = S + max_new
        toks = torch.zeros((B, total), dtype=torch.int32)
        toks[:, :S] = torch.from_numpy(input_ids.astype(np.int32))
        toks = toks.to(dev)
        rows = torch.arange(B, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for cur in range(S, total):
            logits = self.model.apply(self.params, {"input_ids": toks})
            nxt = sample(logits[rows, cur - 1], gen, **sampler)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            toks[:, cur] = nxt
        return toks
