"""Model protocol for the port's engines (counterpart of
``deepspeed_tpu/models/model.py`` ``Model``: the serving surface, the
training loss and the accounting the training engine reads; and the
int8 serving weights: ``QuantizedTensor``, ``qdot``, ``maybe_stream``).

A model is a set of plain functions over a params dict of tensors with
the reference's names and stacked ``[L, ...]`` block layout, so weights
carry across from the JAX package unchanged
(``checkpoint/jax_params.py``)."""
import inspect
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.utils.tree import tree_map


class QuantizedTensor:
    """Weight-only int8 storage for serving (the reference's
    ``QuantizedTensor``): int8 ``q`` [..., in, out] plus fp32 per-group
    ``s`` [..., in, ceil(out / group)] in the ``block_quantize_int8``
    layout, and the compute ``dtype`` the weight dequantizes to.
    Indexing slices the leading (layer) dim of both."""

    def __init__(self, q, s, dtype):
        self.q, self.s, self.dtype = q, s, dtype

    def __getitem__(self, idx):
        return QuantizedTensor(self.q[idx], self.s[idx], self.dtype)

    @property
    def device(self):
        return self.q.device

    def dequantize(self):
        """The weight in its compute dtype (plain PyTorch)."""
        from deepspeed_tpu_torch.ops.kernels.quantization import \
            block_dequantize_int8
        return block_dequantize_int8(self.q, self.s).to(self.dtype)


def quantized_parts(leaf):
    """``(q, s)`` of an int8 weight leaf (a ``QuantizedTensor``, a
    ``(q, s)`` pair, or any object with ``q`` / ``s`` arrays such as the
    JAX package's ``QuantizedTensor``), else None."""
    if isinstance(leaf, tuple) and len(leaf) == 2:
        return leaf
    q, s = getattr(leaf, "q", None), getattr(leaf, "s", None)
    if q is not None and s is not None:
        return q, s
    return None


#: fp32 projections of at most this many rows (a decode step's batch)
#: run one row at a time on the card (qgemm's decode path takes the same)
ROW_INDEPENDENT_ROWS = 8


def qdot(x, w):
    """Projection matmul that consumes int8 weights in place:
    ``QuantizedTensor`` leaves go to the fused-dequant qgemm kernel
    (``ops/kernels/qgemm.py``; its plain version for CPU tensors), plain
    tensors take ``x @ w.to(x.dtype)``.  On the card, fp32 rows of a
    decode-sized product (2 to ``ROW_INDEPENDENT_ROWS``) take one product
    each: cuBLAS's fp32 GEMM sums a row in an order that depends on the
    row count, so a decode row would otherwise change with the rows
    beside it and part from the one-row static generate (an int8 KV
    cache turns a last bit into a code step)."""
    if isinstance(w, QuantizedTensor):
        from deepspeed_tpu_torch.ops.kernels.qgemm import qgemm
        return qgemm(x, w.q, w.s)
    w = w.to(x.dtype)
    rows = x.numel() // x.shape[-1]
    if x.is_cuda and x.dtype == torch.float32 \
            and 1 < rows <= ROW_INDEPENDENT_ROWS:
        flat = x.reshape(rows, x.shape[-1])
        return torch.cat([r @ w for r in flat.split(1)]).reshape(
            *x.shape[:-1], w.shape[-1])
    return x @ w


def head_dot(x, w, transpose_w: bool = False):
    """The LM head's product, ``x @ w`` (``transpose_w``: ``x @ w.T``, a
    tied head such as GPT-2's ``wte`` [V, D]).  On the card in fp32
    outside autograd (serving, evaluation) at any row count it takes
    ``rows_matmul`` (``ops/kernels/grouped_gemm.py``: the grouped GEMM's
    fp32 kernel, a row's bits following its own x row alone), where
    cuBLAS's fp32 GEMM would give a row other logits beside other rows;
    an int8 head goes to qgemm as :func:`qdot`'s."""
    if isinstance(w, QuantizedTensor):
        return qdot(x, w)
    w = w.to(x.dtype)
    if x.is_cuda and x.dtype == torch.float32 \
            and not torch.is_grad_enabled():
        from deepspeed_tpu_torch.ops.kernels.grouped_gemm import rows_matmul
        return rows_matmul(x, w, transpose_w=transpose_w)
    return x @ (w.T if transpose_w else w)


def maybe_stream(layer, keep_quantized: bool = False):
    """One layer's params with ``QuantizedTensor`` leaves rebuilt in their
    compute dtype (plain PyTorch, the reference's ``_maybe_dequant``),
    nested dicts (Mixtral's ``moe``) included.  ``keep_quantized`` (the
    decode paths): quantized leaves stay quantized for the kernels that
    consume them in place — 2-D projections and routers for qgemm and
    the fused decode kernel, 3-D [E, K, N] expert stacks for the int8
    grouped GEMMs (the reference's ``keep_gemm_weights`` and
    ``keep_moe_weights`` together).  The reference's host/NVMe param
    streaming modes are not ported (ROADMAP.md Queue A: offload)."""
    def dq(w):
        if isinstance(w, dict):
            return {k: dq(v) for k, v in w.items()}
        if not isinstance(w, QuantizedTensor) or keep_quantized:
            return w
        return w.dequantize()
    return dq(layer)


def layer_params(blocks, l: int) -> dict:
    """Layer ``l`` of the stacked ``[L, ...]`` blocks: views (int8 leaves
    slice both their codes and scales), nested dicts such as Mixtral's
    ``moe`` keeping their structure."""
    return tree_map(lambda a: a[l], blocks)


#: the reference's remat policies (``models/gpt2.py`` ``remat_policy``);
#: only full per-layer remat ("nothing") is ported
REMAT_POLICIES = ("nothing", "nothing_saveable", "save_attn", "dots",
                  "dots_saveable", "offload_attn")


def check_remat_policy(name):
    """Refuse an unknown policy (ValueError, as the reference) and an
    unported one (NotImplementedError naming its ROADMAP item)."""
    if name not in REMAT_POLICIES and name is not None:
        raise ValueError(f"unknown remat policy {name!r}")
    if name not in (None, "nothing", "nothing_saveable"):
        raise NotImplementedError(
            f"remat_policy={name!r}: not ported to deepspeed_tpu_torch yet "
            "(ROADMAP.md Queue A: remat policies); the port runs full "
            "per-layer remat (\"nothing\")")


def run_block(block_fn, remat: bool, *args):
    """``block_fn(*args)``, one layer of a training forward.  ``remat``:
    under ``torch.utils.checkpoint`` (non-reentrant), the reference's
    ``jax.checkpoint`` with the "nothing" policy: only the layer's inputs
    are kept, and the backward pass runs the whole layer again (its
    attention kernel's forward included) before differentiating it."""
    if remat:
        return checkpoint(block_fn, *args, use_reentrant=False)
    return block_fn(*args)


def seeded_device_init(shapes: dict, seed, device, dtype,
                       quantize: bool) -> dict:
    """A params tree drawn ON ``device`` from a ``torch.Generator`` seeded
    with ``seed``: ``shapes`` maps each leaf to ``(shape, scale)``, drawn
    N(0, scale) into ``dtype`` (fp32 when None), ones for scale None and
    zeros for scale 0.  Stacked leaves fill one slice of their last two
    dims at a time, so the fp32 draw never exceeds one slice.
    ``quantize``: every >= 3-dim leaf under ``blocks`` is stored as a
    ``QuantizedTensor`` whose codes and scales are ``block_quantize_int8``
    of each slice as it is drawn, into preallocated int8 / fp32 stacks.
    Not the JAX package's values (``jax.random`` and torch draw different
    numbers from a seed)."""
    from deepspeed_tpu_torch.ops.kernels.quantization import \
        block_quantize_stack
    dev = resolve_device(device)
    dt = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def leaf(spec, in_blocks):
        if isinstance(spec, dict):
            return {k: leaf(v, in_blocks or k == "blocks")
                    for k, v in spec.items()}
        shape, scale = spec
        if scale is None:
            return torch.ones(shape, dtype=dt, device=dev)
        if scale == 0:
            return torch.zeros(shape, dtype=dt, device=dev)

        def draw(idx):
            return (torch.randn(shape[-2:], generator=gen, device=dev,
                                dtype=torch.float32) * scale).to(dt)
        if quantize and in_blocks and len(shape) >= 3:
            return QuantizedTensor(*block_quantize_stack(shape, draw, dev),
                                   dt)
        out = torch.empty(shape, dtype=dt, device=dev)
        for idx in itertools.product(*map(range, shape[:-2])):
            out[idx].copy_(draw(idx))
        return out

    return leaf(shapes, False)


def numpy_seeded_init(shapes: dict, seed) -> dict:
    """The host counterpart of :func:`seeded_device_init`: a numpy fp32
    params tree drawn with numpy's PCG64 from ``seed`` in the order of
    ``shapes`` (N(0, scale); ones for scale None, zeros for scale 0), for
    families whose reference draws with ``jax.random`` (the tests hand
    the same tree to both packages)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if isinstance(spec, dict):
            return {k: leaf(v) for k, v in spec.items()}
        shape, scale = spec
        if scale is None:
            return np.ones(shape, np.float32)
        if scale == 0:
            return np.zeros(shape, np.float32)
        return rng.standard_normal(shape, dtype=np.float32) * scale
    return leaf(shapes)


def resolve_size(sizes: dict, size: str, family: str) -> dict:
    """Look up a size preset, refusing typos; ``size="custom"`` opts into
    the config defaults + overrides explicitly."""
    if size in sizes:
        return dict(sizes[size])
    if size == "custom":
        return {}
    raise ValueError(
        f"{family}: unknown size {size!r}; valid sizes: "
        f"{sorted(sizes)} or 'custom' (config defaults + overrides)")


@dataclass
class Model:
    config: Any = None
    #: (seed) -> numpy params dict, the reference's host initializer
    #: (the same values ``deepspeed_tpu`` draws for the same seed)
    numpy_init_fn: Optional[Callable] = None
    #: (numpy params dict, device, dtype) -> torch params dict
    params_from_numpy_fn: Optional[Callable] = None
    #: (params, batch) -> logits [B, S, V]
    apply_fn: Callable = None
    #: (params, batch) -> scalar fp32 loss; defaults to the causal-LM
    #: cross-entropy over ``apply_fn`` logits (:func:`default_lm_loss`)
    loss_fn: Optional[Callable] = None
    #: approximate training flops per token (6 N for dense LMs)
    flops_per_token: Optional[float] = None
    #: extra metadata (``n_params``, ``name``)
    meta: dict = field(default_factory=dict)
    #: KV-cache serving surface:
    #: init_cache_fn(batch_size, max_len, dtype, device) -> cache dict;
    #: prefill_fn(params, batch, cache) -> (logits [B, S, V], cache);
    #: decode_fn(params, tokens [B], cache, lengths [B], fused=False) ->
    #: (logits [B, V], cache), writing the new K/V into ``cache`` in place
    #: (``fused``: one fused-layer kernel per layer)
    init_cache_fn: Optional[Callable] = None
    prefill_fn: Optional[Callable] = None
    decode_fn: Optional[Callable] = None
    #: (seed, device, dtype) -> params drawn on the device, for families
    #: too large for a host init (Mixtral); None: ``numpy_init_fn``
    init_fn: Optional[Callable] = None
    #: (seed, device, dtype) -> ``init_fn``'s params with the >= 3-dim
    #: block leaves int8 (quantized slice by slice as they are drawn), for
    #: the int8 engine's load; None: quantize the host init leaf by leaf
    quantized_init_fn: Optional[Callable] = None
    #: the family's fused-layer spec (``ops/kernels/fused_decode.py``
    #: ``FusedLayerSpec``), checked when a caller asks for fused decode
    fused_spec: Any = None

    def __post_init__(self):
        if self.loss_fn is None and self.apply_fn is not None:
            self.loss_fn = default_lm_loss(self.apply_fn)
        self._loss_takes_rng = self.loss_fn is not None and "rng" in \
            inspect.signature(self.loss_fn).parameters

    def init(self, seed: int = 0, device=None, dtype=None):
        """Seeded params on ``device`` (``None``: the GPU, see
        ``resolve_device``) in ``dtype`` (floating leaves): the family's
        device init where it has one, else the reference's host init."""
        if self.init_fn is not None:
            return self.init_fn(seed, resolve_device(device), dtype)
        return self.params_from_numpy_fn(self.numpy_init_fn(seed),
                                         resolve_device(device), dtype)

    def apply(self, params, batch):
        return self.apply_fn(params, batch)

    def loss(self, params, batch, rng=None):
        """The training loss; ``rng`` (a :func:`noise_seed` key) reaches a
        loss that draws noise (the MoE noisy gate) and is dropped for the
        rest."""
        if rng is not None and self._loss_takes_rng:
            return self.loss_fn(params, batch, rng=rng)
        return self.loss_fn(params, batch)


def noise_seed(key, layer: int) -> int:
    """A generator seed for one layer's training noise from ``key`` =
    (config seed, global step, micro-step): a fixed mix of the four
    numbers, so a resumed run draws the same noise without saved
    generator state (the reference splits a JAX key it saves instead)."""
    h = 0
    for v in (*key, layer):
        h = (h * 0x100000001B3 + int(v) + 0x9E3779B9) % (1 << 63)
    return h


def default_lm_loss(apply_fn):
    """The reference's ``_default_lm_loss``: fp32 cross-entropy of
    ``logits[:, :-1]`` against ``input_ids[:, 1:]``, masked by
    ``attention_mask[:, 1:]`` and, for packed sequences, by
    ``segment_ids[:, 1:] == segment_ids[:, :-1]`` (the last token of one
    segment is not scored against the first of the next); the mean over
    the mask with a floor of one token."""

    def loss_fn(params, batch):
        tokens = batch["input_ids"]
        logits = apply_fn(params, batch)[:, :-1].float()
        targets = tokens[:, 1:].long()
        losses = F.cross_entropy(logits.flatten(0, 1), targets.flatten(),
                                 reduction="none").view(targets.shape)
        m = None
        mask = batch.get("attention_mask")
        if mask is not None:
            m = mask[:, 1:].float()
        seg = batch.get("segment_ids")
        if seg is not None:
            same = (seg[:, 1:] == seg[:, :-1]).float()
            m = same if m is None else m * same
        if m is not None:
            return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)
        return losses.mean()

    return loss_fn
