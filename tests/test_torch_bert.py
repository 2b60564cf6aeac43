"""deepspeed_tpu_torch BERT against the JAX package (fp32, the same
weights in both: the JAX ``init_params`` draw, carried across as numpy).

- Attention: ``plain_bidirectional_attention`` against
  ``xla_bidirectional_attention`` with and without a pad mask; the flash
  route (on the CPU the kernels' plain versions, the mask as segment ids)
  against the JAX ``ds_flash_attention(segment_ids=pad_mask,
  causal=False)`` in Pallas interpret mode, forward and gradients, with
  the mask as bool, int32 and int64.
- The model: logits and ``mlm_loss`` against ``deepspeed_tpu.models.bert``
  on padded MLM batches with token types, and without types or pads; the
  loss and every leaf's gradient (the tied ``wte`` one leaf); the
  parameter counts of ``base`` and ``large``; the params' round trip
  through numpy; the reference's own checks (padding invariance, only the
  masked positions scored).
- The engine: a 3-step ``initialize`` -> ``train_batch`` trajectory (gas
  2, WarmupLR, clipping, remat) against the JAX engine, run in a
  subprocess of its own (``python tests/test_torch_bert.py --ref
  out.npz``; no torch beside a donated JAX train step, see
  tests/conftest.py).

Only real-token rows are compared between the flash and the plain / XLA
routes: with segment ids a pad query sees only the pads, with the XLA
mask it sees the real keys (the reference's own two routes differ so).
Losses and gradients agree because the MLM labels are -100 at the pads.

Tolerances: logits and outputs <= 1e-5 abs, losses <= 1e-6 relative,
gradients <= 1e-5 abs (fp32 on both sides; summation order only); the
engine's losses <= 1e-5 relative and params <= 1e-5 abs after 3 steps
(Adam moves each element ~lr = 1e-3 a step, gradient differences of
1e-6 relative move it far less).
"""
import os
import subprocess
import sys

import numpy as np

MODEL = dict(vocab_size=96, max_seq_len=32, num_layers=2, num_heads=4,
             d_model=32)
B, S = 3, 16
MICRO, GAS, STEPS, LR = 2, 2, 3, 1e-3


def mlm_batch(rng, rows, seq=S, pad=True, types=True):
    """A padded MLM batch: trailing pads of a different length in each
    row (none in row 0), 15 % of the real tokens masked (at least one a
    row; their input replaced by token 3), labels -100 elsewhere and at
    the pads, token types 0 then 1."""
    V = MODEL["vocab_size"]
    ids = rng.integers(4, V, (rows, seq)).astype(np.int32)
    mask = np.ones((rows, seq), np.int32)
    if pad:
        for r in range(1, rows):
            mask[r, seq - 2 - 3 * (r % 3):] = 0
    picked = (rng.random((rows, seq)) < 0.15) & (mask == 1)
    picked[:, 1] = True
    labels = np.where(picked, ids, -100).astype(np.int32)
    inp = np.where(picked, 3, ids).astype(np.int32)
    inp[mask == 0] = 0
    b = {"input_ids": inp, "labels": labels}
    if pad:
        b["attention_mask"] = mask
    if types:
        b["token_type_ids"] = (np.arange(seq)[None, :] >= seq // 2) \
            .astype(np.int32).repeat(rows, 0)
    return b


def engine_config() -> dict:
    return {"train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 2}},
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": 2},
            "steps_per_print": 0}


def step_batches(seed: int = 11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        mbs = [mlm_batch(rng, MICRO) for _ in range(GAS)]
        out.append({k: np.stack([m[k] for m in mbs]) for k in mbs[0]})
    return out


def _jax_reference(out_path: str) -> int:
    """The JAX init and the JAX engine's trajectory -> ``out_path``."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import deepspeed_tpu
    from deepspeed_tpu.models.bert import bert_model
    jm = bert_model("custom", dtype="float32", remat=True,
                    attention_impl="xla", **MODEL)
    init = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    eng, *_ = deepspeed_tpu.initialize(model=jm, config=engine_config(),
                                       model_parameters=init)
    res = {"loss": np.array([float(eng.train_batch(batch=b))
                             for b in step_batches()])}
    for tag, tree in (("init", init),
                      ("param", jax.device_get(eng.state["params"]))):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            res[f"{tag}/" + "/".join(p.key for p in path)] = \
                np.asarray(leaf, np.float32)
    np.savez(out_path, **res)
    return 0


if __name__ == "__main__":
    # the reference run, in a process without torch
    if sys.argv[1:2] != ["--ref"] or len(sys.argv) != 3:
        sys.exit("usage: python tests/test_torch_bert.py --ref out.npz")
    sys.exit(_jax_reference(sys.argv[2]))

import functools  # noqa: E402
import unittest.mock  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import bert as jbert  # noqa: E402
from deepspeed_tpu.ops import attention as jattn  # noqa: E402
from deepspeed_tpu.ops.pallas import ds_flash_attention as fa_jax  # noqa
from deepspeed_tpu_torch.checkpoint.jax_params import (  # noqa: E402
    bert_params_from_numpy, bert_params_to_numpy)
from deepspeed_tpu_torch.models import bert as pbert  # noqa: E402
from deepspeed_tpu_torch.ops.attention import (  # noqa: E402
    bidirectional_attention, plain_bidirectional_attention)
from deepspeed_tpu_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_init(seed=0):
    jm = jbert.bert_model("custom", dtype="float32", attention_impl="xla",
                          **MODEL)
    return jax.device_get(jm.init(jax.random.PRNGKey(seed)))


def _port_params(seed=0, grad=False):
    pt = bert_params_from_numpy(_jax_init(seed), "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_(grad)
    return pt


def _qkv(seed, H=4, hd=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd), dtype=np.float32)
            for _ in range(4)]


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("padded", [False, True])
def test_plain_bidirectional_matches_xla(padded):
    q, k, v, _ = _qkv(1)
    mask = mlm_batch(np.random.default_rng(2), B)["attention_mask"] \
        if padded else None
    ref = jattn.xla_bidirectional_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask))
    got = plain_bidirectional_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_ds_flash():
    """Inputs (dO zero on the pads), o and (dq, dk, dv) of the JAX kernel
    in interpret mode with the pad mask as segment ids, computed once."""
    q, k, v, do = _qkv(3)
    mask = mlm_batch(np.random.default_rng(4), B)["attention_mask"]
    do = do * mask.astype(bool)[:, :, None, None]
    with unittest.mock.patch.object(
            pl, "pallas_call",
            functools.partial(pl.pallas_call, interpret=True)):
        o_ref, vjp = jax.vjp(
            lambda a, b, c: fa_jax.ds_flash_attention(
                a, b, c, segment_ids=jnp.asarray(mask), causal=False),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        refs = vjp(jnp.asarray(do))
    return (q, k, v, do, mask), np.asarray(o_ref), [np.asarray(r)
                                                   for r in refs]


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32,
                                        torch.int64])
def test_flash_route_matches_jax_ds_flash(mask_dtype):
    """Forward and gradients of the flash route (CPU: the kernels' plain
    versions) against the JAX kernel with the mask as segment ids, held on
    the real rows (dO is zero on the pads); the same real rows against the
    plain route."""
    (q, k, v, do, mask), o_ref, refs = _jax_ds_flash()
    real = mask.astype(bool)
    tm = torch.from_numpy(mask).to(mask_dtype)
    outs = {}
    for impl in ("flash", "plain"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = bidirectional_attention(tq, tk, tv, pad_mask=tm, impl=impl)
        outs[impl] = [o] + list(torch.autograd.grad(o, (tq, tk, tv),
                                                    torch.from_numpy(do)))
    for impl, got in outs.items():
        np.testing.assert_allclose(got[0].detach().numpy()[real],
                                   o_ref[real], atol=1e-5,
                                   rtol=0, err_msg=impl)
        # dQ on real rows; dK / dV of the real keys (pad keys get their
        # gradient from pad queries on the flash route only)
        for g, r in zip(got[1:], refs):
            np.testing.assert_allclose(g.numpy()[real], r[real],
                                       atol=1e-5, rtol=0, err_msg=impl)


# ---------------------------------------------------------------- model
BATCHES = {"padded_types": dict(pad=True, types=True),
           "no_pads_no_types": dict(pad=False, types=False)}


def _jax_model():
    return jbert.bert_model("custom", dtype="float32", attention_impl="xla",
                            **MODEL)


@functools.lru_cache(maxsize=None)
def _jax_forward(kind):
    """(batch, logits, loss) of the JAX model (the XLA route), computed
    once for the port's two routes."""
    batch = mlm_batch(np.random.default_rng(5), B, **BATCHES[kind])
    jm = _jax_model()
    jp = jax.tree.map(jnp.asarray, _jax_init())
    return (batch, np.asarray(jax.jit(jm.apply)(jp, _j(batch))),
            float(jax.jit(jm.loss)(jp, _j(batch))))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    batch = mlm_batch(np.random.default_rng(6), B)
    loss, grads = jax.jit(jax.value_and_grad(_jax_model().loss))(
        jax.tree.map(jnp.asarray, _jax_init()), _j(batch))
    return batch, float(loss), {
        "/".join(p.key for p in path): np.asarray(g)
        for path, g in jax.tree_util.tree_leaves_with_path(grads)}


@pytest.mark.parametrize("impl", ["flash", "plain"])
@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_forward_and_loss_match_jax(impl, kind):
    batch, logits_j, loss_j = _jax_forward(kind)
    pm = pbert.bert_model("custom", dtype="float32", attention_impl=impl,
                          **MODEL)
    pt = _port_params()
    with torch.no_grad():
        logits = pm.apply(pt, _t(batch)).numpy()
        loss = float(pm.loss(pt, _t(batch)))
    real = batch.get("attention_mask", np.ones((B, S))).astype(bool)
    np.testing.assert_allclose(logits[real], logits_j[real], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-6)


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_loss_and_grads_match_jax(impl):
    """Every leaf's gradient, the tied ``wte`` (lookup + decoder) one
    leaf, remat on in the port."""
    batch, loss_j, want = _jax_loss_and_grads()
    pm = pbert.bert_model("custom", dtype="float32", attention_impl=impl,
                          remat=True, **MODEL)
    pt = _port_params(grad=True)
    loss = pm.loss(pt, _t(batch))
    grads = dict(zip(_paths(pt), torch.autograd.grad(loss,
                                                     tree_leaves(pt))))
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-6)
    assert set(want) == set(grads)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), g, atol=1e-5,
                                   rtol=0, err_msg=name)
    assert np.abs(want["wte"]).max() > 0


def _paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += (_paths(v, f"{prefix}{k}/") if isinstance(v, dict)
                else [prefix + k])
    return out


@pytest.mark.parametrize("size", ["base", "large"])
def test_counts_meta_and_refusals(size):
    ref, got = jbert.bert_model(size), pbert.bert_model(size)
    assert got.meta == ref.meta
    assert got.flops_per_token == ref.flops_per_token
    assert {"base": 109_514_298, "large": 335_174_458}[size] == \
        got.meta["n_params"]
    with pytest.raises(NotImplementedError, match="remat policies"):
        pbert.bert_model(size, remat=True, remat_policy="save_attn")
    with pytest.raises(ValueError, match="attention_impl"):
        pbert.bert_model(size, attention_impl="xla")


def test_params_round_trip_and_device_init():
    tree = _jax_init(3)
    back = bert_params_to_numpy(bert_params_from_numpy(tree, "cpu"))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="keys"):
        bert_params_from_numpy({**tree, "lm_head": tree["wte"]}, "cpu")
    # the seeded device init: the reference's tree, shapes and scales
    cfg = pbert.BertConfig(**MODEL)
    mine = pbert.init_params(cfg, 0, "cpu")
    assert sorted(_paths(mine)) == sorted(_paths(tree))
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        node = mine
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == a.shape
        if float(np.abs(a).max()) == 0 or np.all(a == 1):
            np.testing.assert_array_equal(node.numpy(), a)
        else:
            assert abs(float(node.std()) - 0.02) < 0.004
    assert torch.equal(pbert.init_params(cfg, 0, "cpu")["wte"], mine["wte"])


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_padding_invariance(impl):
    """The reference's check: pad tokens' content does not reach the real
    positions."""
    pm = pbert.bert_model("custom", dtype="float32", attention_impl=impl,
                          **MODEL)
    pt = _port_params()
    batch = mlm_batch(np.random.default_rng(7), B)
    other = dict(batch, input_ids=np.where(batch["attention_mask"] == 1,
                                           batch["input_ids"], 7))
    real = batch["attention_mask"].astype(bool)
    with torch.no_grad():
        a = pm.apply(pt, _t(batch)).numpy()
        b = pm.apply(pt, _t(other)).numpy()
    np.testing.assert_allclose(a[real], b[real], atol=1e-5, rtol=0)


def test_mlm_loss_scores_only_the_masked_positions():
    """The reference's check, made to bite: labels -100 are not scored
    (the loss is the mean cross-entropy over the labelled positions, and
    changing the inputs' labels elsewhere changes nothing); without
    labels every position is scored against ``input_ids``."""
    pm = pbert.bert_model("custom", dtype="float32", **MODEL)
    pt = _port_params()
    batch = mlm_batch(np.random.default_rng(8), B)
    with torch.no_grad():
        loss = float(pm.loss(pt, _t(batch)))
        logp = torch.log_softmax(pm.apply(pt, _t(batch)).double(), -1)
        nolabels = float(pm.loss(pt, _t({k: v for k, v in batch.items()
                                         if k != "labels"})))
    lab = batch["labels"]
    m = lab != -100
    want = -np.mean(logp.numpy()[m, lab[m]])
    assert np.isfinite(loss) and loss == pytest.approx(want, rel=1e-6)
    ids = batch["input_ids"]
    want_all = -np.mean(np.take_along_axis(logp.numpy(), ids[..., None],
                                           -1))
    assert nolabels == pytest.approx(want_all, rel=1e-6)


# --------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_bert") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "tests/test_torch_bert.py",
                           "--ref", str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _tree(flat, tag):
    """The nested numpy tree of the npz keys ``tag/...``."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(tag + "/"):
            continue
        node, parts = tree, key.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def test_engine_trajectory_matches_jax_engine(reference):
    """``initialize`` -> ``train_batch`` on padded MLM batches with token
    types (the flash route, segment ids on the CPU's plain versions)
    against the JAX engine (the XLA route): losses and every param."""
    pm = pbert.bert_model("custom", dtype="float32", remat=True, **MODEL)
    eng, *_ = dt.initialize(model=pm, config=engine_config(),
                            model_parameters=_tree(reference, "init"),
                            device="cpu")
    losses = [float(eng.train_batch(batch=b)) for b in step_batches()]
    assert eng.global_steps == STEPS
    np.testing.assert_allclose(losses, reference["loss"], rtol=1e-5)
    got = bert_params_to_numpy(eng.params)
    want = _tree(reference, "param")
    init = _tree(reference, "init")
    assert sorted(_paths(got)) == sorted(_paths(want))
    for name in _paths(want):
        a, w = got, want
        for p in name.split("/"):
            a, w = a[p], w[p]
        np.testing.assert_allclose(a, w, atol=1e-5, rtol=0, err_msg=name)
    # the step moved the tied embedding (lookup + decoder)
    assert np.abs(want["wte"] - init["wte"]).max() > 1e-4
