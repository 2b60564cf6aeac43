"""Training of the port's families against the JAX package: Llama (GQA,
rotary), GPT-NeoX (partial rotary, the parallel residual), BLOOM (ALiBi,
plain attention), GPT-Neo (banded, unscaled attention) and BERT (the MLM
loss on a padded batch with token types).

At tiny sizes (2 layers, d 32) and fp32, each family's loss and every
leaf's gradient with ``remat=True`` (each layer under
``torch.utils.checkpoint``; the flash route on the CPU, the kernels'
plain versions, for Llama, NeoX and BERT) against the JAX model's loss and
``jax.grad`` on the same params (the JAX init carried across as numpy for
BERT, whose reference draws with ``jax.random``; the port's host init for
the others); and remat against no remat in the port.  The causal
families' batches carry an ``attention_mask`` (the causal-LM loss masks
its pads).

Tolerances: loss <= 1e-6 relative, gradients <= 1e-5 abs (fp32 on both
sides, summation order only); remat against no remat <= 1e-6 abs (the
same arithmetic run twice).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import bloom as jbl
from deepspeed_tpu.models import gptneo as jgn
from deepspeed_tpu.models import llama as jll
from deepspeed_tpu.models import neox as jnx
from deepspeed_tpu_torch.models import bert as pbert
from deepspeed_tpu_torch.models import bloom as pbl
from deepspeed_tpu_torch.models import gptneo as pgn
from deepspeed_tpu_torch.models import llama as pll
from deepspeed_tpu_torch.models import neox as pnx
from deepspeed_tpu_torch.utils.tree import tree_leaves

B, S = 2, 32
BERT = dict(vocab_size=64, max_seq_len=32, num_layers=2, num_heads=4,
            d_model=32)

#: family -> (JAX model, port model factory taking remat, vocab size)
FAMILIES = {
    "llama": (lambda: jll.llama_model("tiny", dtype="float32",
                                      attention_impl="xla"),
              lambda remat: pll.llama_model("tiny", dtype="float32",
                                            remat=remat), 256),
    "neox": (lambda: jnx.neox_model("tiny", dtype="float32",
                                    attention_impl="xla"),
             lambda remat: pnx.neox_model("tiny", dtype="float32",
                                          remat=remat), 256),
    "bloom": (lambda: jbl.bloom_model("tiny", dtype="float32"),
              lambda remat: pbl.bloom_model("tiny", dtype="float32",
                                            remat=remat), 256),
    "gptneo": (lambda: jgn.gptneo_model("tiny", dtype="float32",
                                        attention_impl="xla"),
               lambda remat: pgn.gptneo_model("tiny", dtype="float32",
                                              remat=remat), 256),
    "bert": (lambda: jbert.bert_model("custom", dtype="float32",
                                      attention_impl="xla", **BERT),
             lambda remat: pbert.bert_model("custom", dtype="float32",
                                            remat=remat, **BERT), 64),
}


def _batch(family, vocab):
    rng = np.random.default_rng(9)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 21:] = 0
    b = {"input_ids": ids, "attention_mask": mask}
    if family == "bert":
        picked = (rng.random((B, S)) < 0.15) & (mask == 1)
        picked[:, 2] = True
        b["labels"] = np.where(picked, ids, -100).astype(np.int32)
        b["input_ids"] = np.where(picked, 3, ids).astype(np.int32)
        b["token_type_ids"] = (np.arange(S) >= 12).astype(np.int32)[None] \
            .repeat(B, 0)
    return b


@functools.lru_cache(maxsize=None)
def _params(family):
    """The numpy params both packages train from."""
    if family == "bert":
        return jax.device_get(FAMILIES["bert"][0]().init(
            jax.random.PRNGKey(0)))
    return FAMILIES[family][1](False).numpy_init_fn(0)


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_loss_and_grads(family, remat):
    pm = FAMILIES[family][1](remat)
    pt = pm.params_from_numpy_fn(_params(family), "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(family, FAMILIES[family][2]).items()}
    loss = pm.loss(pt, batch)
    grads = torch.autograd.grad(loss, tree_leaves(pt))
    names = list(_named(pt))
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_with_remat_match_jax(family):
    jm = FAMILIES[family][0]()
    batch = _batch(family, FAMILIES[family][2])
    loss_j, grads_j = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _params(family)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(family, remat=True)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    want = _named(jax.device_get(grads_j))
    assert set(want) == set(grads)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(g),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_matches_no_remat(family):
    a = _port_loss_and_grads(family, remat=True)
    b = _port_loss_and_grads(family, remat=False)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=1e-6)
    for name, g in b[1].items():
        torch.testing.assert_close(a[1][name], g, rtol=0, atol=1e-6,
                                   msg=name)
