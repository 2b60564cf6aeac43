"""deepspeed_tpu_torch GPT-2 vs deepspeed_tpu.models.gpt2 on the same
weights.

The JAX engine's params (``init_inference`` on the tiny test model) are
carried across with ``gpt2_params_from_numpy``; the same seeded token
batches go through both packages' ``forward``, ``prefill`` and three
chained ``decode_step`` calls.

Tolerances (fp32): caches <= 1e-5 abs (one projection each, same
operands); logits <= 1e-4 abs (a few matmuls and softmaxes deep, with a
different summation order in each framework).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as gpt2_jax
from deepspeed_tpu_torch.checkpoint.jax_params import gpt2_params_from_numpy
from deepspeed_tpu_torch.models import gpt2 as gpt2_port
from tests.util import tiny_gpt2

CACHE_ATOL = 1e-5
LOGIT_ATOL = 1e-4

VARIANTS = {
    "tiny": {},                                   # d 32, 4 heads, hd 8
    "hd24": {"d_model": 48, "num_heads": 2},      # hd 24
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    over = VARIANTS[request.param]
    jm = tiny_gpt2(**over)
    eng = deepspeed_tpu.init_inference(model=jm, config={"dtype": "float32"})
    params_np = jax.device_get(eng.params)
    cfg = jm.config
    pm = gpt2_port.gpt2_model(
        "custom", vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        d_model=cfg.d_model, dtype="float32")
    params_t = gpt2_params_from_numpy(params_np, "cpu")
    return jm, eng.params, pm, params_t


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def test_params_carried_across_unchanged(pair):
    jm, params_j, pm, params_t = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(params_j))
    for path, leaf in flat_j:
        node = params_t
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape          # [in, out] kept
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_forward_logits_match(pair):
    jm, params_j, pm, params_t = pair
    toks = _tokens(2, 24, jm.config.vocab_size, seed=1)
    ref = np.asarray(jm.apply(params_j, {"input_ids": jnp.asarray(toks)}))
    out = pm.apply(params_t, {"input_ids": torch.from_numpy(toks)}).numpy()
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL, rtol=0)


def test_prefill_and_chained_decode_match(pair):
    jm, params_j, pm, params_t = pair
    cfg_j, cfg_t = jm.config, pm.config
    B, S, S_max = 3, 16, 32
    toks = _tokens(B, S, cfg_j.vocab_size, seed=2)
    cache_j = gpt2_jax.init_cache(cfg_j, B, S_max)
    lg_j, cache_j = gpt2_jax.prefill(params_j, {"input_ids":
                                                jnp.asarray(toks)},
                                     cache_j, cfg_j)
    cache_t = gpt2_port.init_cache(cfg_t, B, S_max, device="cpu")
    lg_t, cache_t = gpt2_port.prefill(
        params_t, {"input_ids": torch.from_numpy(toks)}, cache_t, cfg_t)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                               atol=LOGIT_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]),
                                   atol=CACHE_ATOL, rtol=0)
    # ragged rows: each row continues from its own fill length
    lengths = np.array([S, 5, 11], np.int32)
    nxt = _tokens(3, B, cfg_j.vocab_size, seed=3)
    for step in range(3):
        t_np = nxt[step]
        lg_j, cache_j = gpt2_jax.decode_step(
            params_j, jnp.asarray(t_np), cache_j, jnp.asarray(lengths),
            cfg_j)
        lg_t, cache_t = gpt2_port.decode_step(
            params_t, torch.from_numpy(t_np), cache_t,
            torch.from_numpy(lengths), cfg_t)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   atol=LOGIT_ATOL, rtol=0)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache_t[name].numpy(),
                                       np.asarray(cache_j[name]),
                                       atol=CACHE_ATOL, rtol=0)
        lengths = lengths + 1


def test_numpy_init_is_the_reference_init():
    """The port's host init draws the reference's values for a seed."""
    cfg_kwargs = dict(vocab_size=64, max_seq_len=16, num_layers=2,
                      num_heads=2, d_model=16)
    ref = gpt2_jax.numpy_init_params(gpt2_jax.GPT2Config(**cfg_kwargs),
                                     seed=5)
    out = gpt2_port.numpy_init_params(gpt2_port.GPT2Config(**cfg_kwargs),
                                      seed=5)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(ref),
            jax.tree_util.tree_leaves_with_path(out)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_760m_preset_is_the_reference_shape():
    ref = gpt2_jax.gpt2_model("760m").config
    out = gpt2_port.gpt2_model("760m").config
    for f in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
              "d_model", "layer_norm_eps", "d_mlp", "head_dim"):
        assert getattr(out, f) == getattr(ref, f), f
    assert out.head_dim == 96
    with pytest.raises(ValueError, match="unknown size"):
        gpt2_port.gpt2_model("761m")
