"""BERT family in PyTorch (counterpart of ``deepspeed_tpu/models/bert.py``):
the encoder and the masked-LM head, BERT-Large pretraining being the
reference's flagship benchmark.

Plain functions over a params dict with the reference's names and stacked
``[L, ...]`` block layout, every projection ``[in, out]`` (``x @ w``):
word + learned position + token-type embeddings and a LayerNorm, post-LN
encoder blocks (fused QKV, bidirectional attention, a GELU MLP), and the
MLM head (dense, GELU, LayerNorm, the decoder tied to ``wte`` plus
``mlm_bias``).  The MLM loss (:func:`mlm_loss`) is unshifted and ignores
``labels == -100``.

Attention runs the flash kernels non-causal (``ops/attention.py
bidirectional_attention``); a padded batch's ``attention_mask`` becomes
their segment ids, so pad queries see only pads where the plain route
(``attention_impl="plain"``) lets them see the real keys.  Real-token rows
agree between the routes; the loss and gradients agree when ``labels`` are
-100 at the pads (without labels every position is scored, pads included).

With ``remat`` each layer runs under ``torch.utils.checkpoint``
(``models/model.py run_block``; the "nothing" policy).  Training goes
through ``initialize`` -> ``train_batch`` with the model's own loss.
There is no KV-cache serving surface (an encoder), as in the reference:
the scheduler refuses the model.

Initialisation: :func:`init_params` draws the weights on the device from
a ``torch.Generator`` (``models/model.py seeded_device_init``), with the
reference's scales (all 0.02; norms ones, biases zeros).  The reference
draws with ``jax.random``, so the tests carry its init across as numpy
(``checkpoint/jax_params.py bert_params_from_numpy``).  Random-LTD and
progressive layer drop stay refused by the training config.
"""
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.gpt2 import _layer_norm
from deepspeed_tpu_torch.models.model import (Model, check_remat_policy,
                                              layer_params, maybe_stream,
                                              resolve_size, run_block,
                                              seeded_device_init)
from deepspeed_tpu_torch.ops.attention import (ATTENTION_IMPLS,
                                               bidirectional_attention)


@dataclass(frozen=True)
class BertConfig:
    """The reference's ``BertConfig``, same fields and defaults."""
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    layer_norm_eps: float = 1e-12
    gelu_approximate: bool = True   # False = erf gelu (HF BERT default)
    dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "nothing"
    attention_impl: str = "auto"    # auto | flash (kernel) | plain

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"BertConfig.attention_impl="
                             f"{self.attention_impl!r}: choose one of "
                             f"{ATTENTION_IMPLS}")
        if self.remat:
            check_remat_policy(self.remat_policy)

    @property
    def d_mlp(self) -> int:
        return 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


BERT_SIZES = {
    "base": dict(num_layers=12, num_heads=12, d_model=768),
    "large": dict(num_layers=24, num_heads=16, d_model=1024),
}


def _shapes(config: BertConfig) -> dict:
    """Leaf shapes and init scales (None: ones, 0: zeros) of the params
    tree, the reference's (every weight N(0, 0.02))."""
    D, V, S, L, M = (config.d_model, config.vocab_size, config.max_seq_len,
                     config.num_layers, config.d_mlp)
    std = 0.02
    return {
        "wte": ((V, D), std), "wpe": ((S, D), std),
        "wtype": ((config.type_vocab_size, D), std),
        "emb_ln_scale": ((D,), None), "emb_ln_bias": ((D,), 0),
        "blocks": {
            "qkv_w": ((L, D, 3 * D), std), "qkv_b": ((L, 3 * D), 0),
            "proj_w": ((L, D, D), std), "proj_b": ((L, D), 0),
            "ln1_scale": ((L, D), None), "ln1_bias": ((L, D), 0),
            "mlp_in_w": ((L, D, M), std), "mlp_in_b": ((L, M), 0),
            "mlp_out_w": ((L, M, D), std), "mlp_out_b": ((L, D), 0),
            "ln2_scale": ((L, D), None), "ln2_bias": ((L, D), 0)},
        "mlm_dense_w": ((D, D), std), "mlm_dense_b": ((D,), 0),
        "mlm_ln_scale": ((D,), None), "mlm_ln_bias": ((D,), 0),
        "mlm_bias": ((V,), 0)}


def init_params(config: BertConfig, seed: int = 0, device=None,
                dtype=None) -> dict:
    """Seeded normal init drawn on ``device`` (``None``: the GPU) into
    ``dtype`` (fp32 when None), one [layer] slice at a time.  Not the JAX
    package's values (``jax.random`` and torch draw different numbers)."""
    return seeded_device_init(_shapes(config), seed, device, dtype,
                              quantize=False)


def _gelu(h, config: BertConfig):
    return F.gelu(h, approximate="tanh" if config.gelu_approximate
                  else "none")


def _block(x, layer, pad_mask, config: BertConfig):
    """Post-LN encoder block: x [B, S, D]."""
    B, S, D = x.shape
    H, hd = config.num_heads, config.head_dim
    dt = x.dtype
    qkv = x @ layer["qkv_w"].to(dt) + layer["qkv_b"].to(dt)
    q, kk, v = qkv.split(D, dim=-1)
    attn = bidirectional_attention(
        q.unflatten(-1, (H, hd)), kk.unflatten(-1, (H, hd)),
        v.unflatten(-1, (H, hd)), pad_mask=pad_mask,
        impl=config.attention_impl).reshape(B, S, D)
    x = _layer_norm(
        x + attn @ layer["proj_w"].to(dt) + layer["proj_b"].to(dt),
        layer["ln1_scale"], layer["ln1_bias"], config.layer_norm_eps)
    h = _gelu(x @ layer["mlp_in_w"].to(dt) + layer["mlp_in_b"].to(dt),
              config)
    return _layer_norm(
        x + h @ layer["mlp_out_w"].to(dt) + layer["mlp_out_b"].to(dt),
        layer["ln2_scale"], layer["ln2_bias"], config.layer_norm_eps)


def embed(params, batch, config: BertConfig):
    """Word + position + token-type embeddings (``token_type_ids`` None:
    type 0 everywhere), then the embedding LayerNorm."""
    tokens = batch["input_ids"]
    dt = config.torch_dtype
    types = batch.get("token_type_ids")
    wtype = params["wtype"].to(dt)
    x = (params["wte"].to(dt)[tokens.long()]
         + params["wpe"].to(dt)[:tokens.shape[1]]
         + (wtype[types.long()] if types is not None else wtype[0]))
    return _layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"],
                       config.layer_norm_eps)


def head(params, x, config: BertConfig):
    """The MLM head: dense, GELU, LayerNorm, then the decoder tied to
    ``wte`` plus ``mlm_bias``."""
    dt = x.dtype
    h = _gelu(x @ params["mlm_dense_w"].to(dt)
              + params["mlm_dense_b"].to(dt), config)
    h = _layer_norm(h, params["mlm_ln_scale"], params["mlm_ln_bias"],
                    config.layer_norm_eps)
    return h @ params["wte"].to(dt).T + params["mlm_bias"].to(dt)


def forward(params, batch, config: BertConfig):
    """``input_ids`` [B, S] (and optional ``attention_mask`` /
    ``token_type_ids``) -> MLM logits [B, S, V]."""
    x = embed(params, batch, config)
    pad_mask = batch.get("attention_mask")
    for l in range(config.num_layers):
        x = run_block(_block, config.remat, x,
                      maybe_stream(layer_params(params["blocks"], l)),
                      pad_mask, config)
    return head(params, x, config)


def mlm_loss(apply_fn):
    """The masked-LM objective (the reference's ``mlm_loss``): the mean
    fp32 cross-entropy over positions with ``labels != -100``, unshifted;
    without ``labels`` every position is scored against ``input_ids``."""

    def loss_fn(params, batch):
        logits = apply_fn(params, batch).float()
        labels = batch.get("labels")
        m = None
        if labels is None:
            labels = batch["input_ids"]
        else:
            m = labels != -100
            labels = torch.where(m, labels, torch.zeros_like(labels))
        losses = F.cross_entropy(logits.flatten(0, 1),
                                 labels.long().flatten(),
                                 reduction="none").view(labels.shape)
        if m is None:
            return losses.mean()
        m = m.float()
        return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)

    return loss_fn


def count_params(config: BertConfig) -> int:
    """The reference's ``count_params``."""
    D, V, S, L, M = (config.d_model, config.vocab_size, config.max_seq_len,
                     config.num_layers, config.d_mlp)
    per_layer = 3 * D * D + 3 * D + D * D + D + 2 * D * M + M + D + 4 * D
    head_p = D * D + D + 2 * D + V
    return (V * D + S * D + config.type_vocab_size * D + 2 * D
            + L * per_layer + head_p)


def bert_model(size: str = "base", **overrides) -> Model:
    """``bert:<size>`` (base, large) with config overrides, e.g.
    ``bert_model("large", max_seq_len=128, dtype="bfloat16",
    remat=True)``."""
    from deepspeed_tpu_torch.checkpoint.jax_params import \
        bert_params_from_numpy
    cfg_kwargs = resolve_size(BERT_SIZES, size, "bert")
    cfg_kwargs.update(overrides)
    config = BertConfig(**cfg_kwargs)
    n_params = count_params(config)
    apply_fn = lambda p, b: forward(p, b, config)  # noqa: E731
    return Model(
        config=config,
        init_fn=partial(init_params, config),
        params_from_numpy_fn=bert_params_from_numpy,
        apply_fn=apply_fn,
        loss_fn=mlm_loss(apply_fn),
        flops_per_token=6.0 * n_params,
        meta={"name": f"bert-{size}", "n_params": n_params,
              "supports_random_ltd": True, "supports_pld": True})
