"""Weights carried across from the JAX package.

``gpt2_params_from_numpy`` turns a GPT-2 params tree as numpy arrays —
``jax.device_get(engine.params)`` from ``deepspeed_tpu``, or the output
of ``numpy_init_params`` — into the port's tree of tensors: the same
names, the same stacked ``[L, ...]`` block layout, and the reference's
``[in, out]`` orientation for every projection weight (the port computes
``x @ w`` as the reference does; nothing is transposed anywhere).
``gpt2_params_to_numpy`` is the way back, so trained params compare leaf
by leaf with the JAX engine's.  ``mixtral_params_from_numpy`` /
``mixtral_params_to_numpy`` do the same for a Mixtral tree, whose
``blocks`` nest the experts' stacks under ``moe``, and
``llama_params_from_numpy`` / ``llama_params_to_numpy`` for a Llama tree
(with or without the ``attn_bias`` biases), ``neox_params_from_numpy`` /
``neox_params_to_numpy`` for a GPT-NeoX tree (the untied ``embed_out``,
and ``embed_out_b`` where GPT-J's ``head_bias`` gives one) and
``bloom_params_from_numpy`` / ``bloom_params_to_numpy`` for a BLOOM tree
(the embedding LayerNorm, the head tied to ``wte``), and
``bert_params_from_numpy`` / ``bert_params_to_numpy`` for a BERT tree (the
MLM head's decoder tied to ``wte``: one leaf, no copy).  GPT-Neo has
GPT-2's layout and takes GPT-2's converters.

An int8 engine's block weights carry across as they are: a leaf given as
a ``(q, s)`` pair, or as any object with ``q`` and ``s`` arrays (the JAX
package's ``QuantizedTensor`` after ``jax.device_get``), becomes the
port's ``QuantizedTensor`` with the same int8 codes and fp32 scales, so
both packages serve the same bytes (for Mixtral: the 3-D projections and
router, and the 4-D expert stacks under ``moe``; for Llama: the seven
projections).  The ``*_to_numpy``
functions give such leaves back as ``(q, s)`` pairs.
"""
import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models.model import QuantizedTensor, quantized_parts

GPT2_TOP_KEYS = ("wte", "wpe", "blocks", "lnf_scale", "lnf_bias")
GPT2_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "proj_w",
                   "proj_b", "ln2_scale", "ln2_bias", "mlp_in_w",
                   "mlp_in_b", "mlp_out_w", "mlp_out_b")


def to_tensor(a, device, dtype):
    """A numpy array or tensor as a new tensor on ``device`` (floating
    values cast to ``dtype`` when given)."""
    if isinstance(a, torch.Tensor):
        if dtype is None or not a.is_floating_point():
            dtype = a.dtype
        return a.detach().to(device=device, dtype=dtype, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: no numpy bridge
        a = a.astype(np.float32)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")     # torch.from_numpy needs both
    t = torch.from_numpy(a)
    if dtype is None or not t.is_floating_point():
        dtype = t.dtype
    # always a copy: a CPU tensor must not share the caller's array (the
    # training engine updates its params in place)
    return t.to(device=device, dtype=dtype, copy=True)


MIXTRAL_TOP_KEYS = ("wte", "blocks", "final_norm", "lm_head")
MIXTRAL_BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "moe")
MIXTRAL_MOE_KEYS = ("router", "w_gate", "w_in", "w_out")


def _check_keys(tree: dict, want, where: str, fn="gpt2_params_from_numpy"):
    got = set(tree)
    if got != set(want):
        raise ValueError(
            f"{fn}: {where} keys {sorted(got)} != expected {sorted(want)}")


def gpt2_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """numpy GPT-2 params tree -> the port's params (floating leaves cast
    to ``dtype`` when given, all placed on ``device``; ``None`` is the
    GPU, see ``resolve_device``)."""
    _check_keys(tree, GPT2_TOP_KEYS, "top-level")
    _check_keys(tree["blocks"], GPT2_BLOCK_KEYS, "blocks")
    device = resolve_device(device)
    out = {k: to_tensor(v, device, dtype) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = {k: block_leaf(v, device, dtype)
                     for k, v in tree["blocks"].items()}
    return out


def block_leaf(v, device, dtype):
    """One block leaf on ``device``: int8 leaves (see
    :func:`quantized_parts`) as a ``QuantizedTensor`` dequantizing to
    ``dtype`` (fp32 when None), others as :func:`to_tensor`."""
    parts = quantized_parts(v)
    if parts is None:
        return to_tensor(v, device, dtype)
    q, s = parts
    return QuantizedTensor(to_tensor(q, device, None),
                           to_tensor(s, device, torch.float32),
                           dtype or torch.float32)


def gpt2_params_to_numpy(params: dict) -> dict:
    """The reverse of :func:`gpt2_params_from_numpy`: the port's params ->
    a numpy tree with the same names and layout (fp32 for floating
    leaves, since numpy has no bfloat16)."""
    return _to_numpy(params)


def _to_numpy(t):
    """A params tree of tensors -> numpy (fp32 for floating leaves; a
    ``QuantizedTensor`` as its ``(q, s)`` pair)."""
    if isinstance(t, dict):
        return {k: _to_numpy(v) for k, v in t.items()}
    if isinstance(t, QuantizedTensor):
        return _to_numpy(t.q), _to_numpy(t.s)
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def mixtral_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """numpy Mixtral params tree (``jax.device_get`` of the JAX engine's
    params) -> the port's params: the same names and nested layout, every
    leaf copied onto ``device`` (``None``: the GPU), floating leaves cast
    to ``dtype`` when given; int8 block leaves as ``QuantizedTensor``s
    (:func:`block_leaf`)."""
    fn = "mixtral_params_from_numpy"
    _check_keys(tree, MIXTRAL_TOP_KEYS, "top-level", fn)
    _check_keys(tree["blocks"], MIXTRAL_BLOCK_KEYS, "blocks", fn)
    _check_keys(tree["blocks"]["moe"], MIXTRAL_MOE_KEYS, "blocks.moe", fn)
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return block_leaf(t, device, dtype)
    out = {k: to_tensor(v, device, dtype) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = conv(tree["blocks"])
    return out


def mixtral_params_to_numpy(params: dict) -> dict:
    """The reverse of :func:`mixtral_params_from_numpy` (fp32 for floating
    leaves, since numpy has no bfloat16; int8 leaves as ``(q, s)``)."""
    return _to_numpy(params)


LLAMA_TOP_KEYS = ("wte", "blocks", "final_norm", "lm_head")
LLAMA_BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                    "w_gate", "w_up", "w_down")
#: the ``attn_bias`` (InternLM) variant's extra block leaves
LLAMA_BIAS_KEYS = ("wq_b", "wk_b", "wv_b", "wo_b")


def llama_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """numpy Llama params tree (``jax.device_get`` of the JAX engine's
    params, or ``numpy_init_params``) -> the port's params: the same names
    and layout, every leaf copied onto ``device`` (``None``: the GPU),
    floating leaves cast to ``dtype`` when given; int8 block leaves as
    ``QuantizedTensor``s (:func:`block_leaf`)."""
    fn = "llama_params_from_numpy"
    _check_keys(tree, LLAMA_TOP_KEYS, "top-level", fn)
    blocks = tree["blocks"]
    want = LLAMA_BLOCK_KEYS + (LLAMA_BIAS_KEYS if "wq_b" in blocks else ())
    _check_keys(blocks, want, "blocks", fn)
    device = resolve_device(device)
    out = {k: to_tensor(v, device, dtype) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = {k: block_leaf(v, device, dtype)
                     for k, v in blocks.items()}
    return out


def llama_params_to_numpy(params: dict) -> dict:
    """The reverse of :func:`llama_params_from_numpy` (fp32 for floating
    leaves, since numpy has no bfloat16; int8 leaves as ``(q, s)``)."""
    return _to_numpy(params)


NEOX_TOP_KEYS = ("wte", "blocks", "lnf_scale", "lnf_bias", "embed_out")
#: the block leaves of GPT-NeoX and BLOOM (one layout)
NEOX_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
                   "qkv_w", "qkv_b", "dense_w", "dense_b", "mlp_in_w",
                   "mlp_in_b", "mlp_out_w", "mlp_out_b")
BLOOM_TOP_KEYS = ("wte", "emb_ln_scale", "emb_ln_bias", "blocks",
                  "lnf_scale", "lnf_bias")


def _flat_family_from_numpy(tree, top, fn, device, dtype):
    """A tree with one flat ``blocks`` dict of NEOX_BLOCK_KEYS: keys
    checked, every leaf copied onto ``device`` (floating leaves cast to
    ``dtype`` when given), int8 block leaves as ``QuantizedTensor``s."""
    _check_keys(tree, top, "top-level", fn)
    _check_keys(tree["blocks"], NEOX_BLOCK_KEYS, "blocks", fn)
    device = resolve_device(device)
    out = {k: to_tensor(v, device, dtype) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = {k: block_leaf(v, device, dtype)
                     for k, v in tree["blocks"].items()}
    return out


def neox_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """numpy GPT-NeoX params tree (``jax.device_get`` of the JAX engine's
    params, or ``numpy_init_params``) -> the port's params: the untied
    ``embed_out`` head, and ``embed_out_b`` where the tree has it (GPT-J's
    ``head_bias``)."""
    top = NEOX_TOP_KEYS + (("embed_out_b",) if "embed_out_b" in tree
                           else ())
    return _flat_family_from_numpy(tree, top, "neox_params_from_numpy",
                                   device, dtype)


def neox_params_to_numpy(params: dict) -> dict:
    """The reverse of :func:`neox_params_from_numpy` (fp32 for floating
    leaves; int8 leaves as ``(q, s)``)."""
    return _to_numpy(params)


def bloom_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """numpy BLOOM params tree -> the port's params: the embedding
    LayerNorm, the NeoX block layout, and no head leaf (tied to
    ``wte``)."""
    return _flat_family_from_numpy(tree, BLOOM_TOP_KEYS,
                                   "bloom_params_from_numpy", device, dtype)


def bloom_params_to_numpy(params: dict) -> dict:
    """The reverse of :func:`bloom_params_from_numpy` (fp32 for floating
    leaves; int8 leaves as ``(q, s)``)."""
    return _to_numpy(params)


BERT_TOP_KEYS = ("wte", "wpe", "wtype", "emb_ln_scale", "emb_ln_bias",
                 "blocks", "mlm_dense_w", "mlm_dense_b", "mlm_ln_scale",
                 "mlm_ln_bias", "mlm_bias")
BERT_BLOCK_KEYS = ("qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_scale",
                   "ln1_bias", "mlp_in_w", "mlp_in_b", "mlp_out_w",
                   "mlp_out_b", "ln2_scale", "ln2_bias")


def bert_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """numpy BERT params tree (``jax.device_get`` of the JAX package's
    ``init_params`` or engine params) -> the port's params: the same names
    and stacked layout on ``device`` (``None``: the GPU), floating leaves
    cast to ``dtype`` when given.  The MLM decoder has no leaf of its own:
    it is ``wte``, so the tied weight stays one tensor."""
    fn = "bert_params_from_numpy"
    _check_keys(tree, BERT_TOP_KEYS, "top-level", fn)
    _check_keys(tree["blocks"], BERT_BLOCK_KEYS, "blocks", fn)
    device = resolve_device(device)
    out = {k: to_tensor(v, device, dtype) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = {k: block_leaf(v, device, dtype)
                     for k, v in tree["blocks"].items()}
    return out


def bert_params_to_numpy(params: dict) -> dict:
    """The reverse of :func:`bert_params_from_numpy` (fp32 for floating
    leaves, since numpy has no bfloat16)."""
    return _to_numpy(params)
