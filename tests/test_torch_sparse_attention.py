"""deepspeed_tpu_torch block-sparse attention vs the JAX package.

The port's layouts are held bit-identical to the reference's (every
``SparsityConfig`` class, seeded random blocks, per-head and
unidirectional layouts), its plans array-equal to ``_plan`` /
``_plan_transpose``, and its plain versions (what the kernel wrappers run
for CPU tensors; chip_smoke.py holds the CUDA kernels against them on the
card) against the JAX Pallas kernels in interpret mode on the same seeded
numpy inputs: the forward and lse of ``_call(..., with_lse=True)``, the
backward of ``_bwd_call``, and ``BlockSparseAttention``'s gradients
against ``jax.grad`` of ``block_sparse_attention_trainable``.

Tolerances: forward and lse 2e-5 abs, backward 1e-5 abs, autograd 1e-4
rel / 1e-5 abs, all fp32 — both sides accumulate in fp32; only the
summation order differs (online softmax against one max per row).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as J
from deepspeed_tpu.ops.pallas import block_sparse_attention as JB
from deepspeed_tpu_torch.ops import sparse_attention as T
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as TB

FWD_TOL = 2e-5
BWD_TOL = 1e-5
HD = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch side runs on one thread here.  Under CPU load from other
    processes (as in a parallel test run), a process's first multi-threaded
    CPU ``torch.exp`` was seen to return chunks of elements ~1e-4 off, with
    no JAX and no port code involved: a script that takes ``torch.exp`` of
    a [2, 40, 16, 16] tensor three times against float64 ``exp`` rounded
    to float32, beside a numpy matmul loop in another process, found the
    first call off in 12 of 40 fresh processes (torch 2.13 CPU build,
    errors 8e-5 to 1.4e-4) and every later call exact; on one thread, none
    of 40.  The plain versions add no floats from several threads into one
    place, so one thread hides no race of theirs; the inputs are a few
    thousand elements."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(mod, H=3):
    """The same configs built from either package's classes."""
    return {
        "dense": mod.DenseSparsityConfig(H, block=16),
        "fixed": mod.FixedSparsityConfig(H, block=16, num_local_blocks=2,
                                         num_global_blocks=1),
        "fixed_uni_horizontal": mod.FixedSparsityConfig(
            H, block=16, num_local_blocks=3, num_global_blocks=2,
            attention="unidirectional", horizontal_global_attention=True),
        "fixed_per_head": mod.FixedSparsityConfig(
            H, block=16, different_layout_per_head=True, num_local_blocks=2),
        "bigbird": mod.BigBirdSparsityConfig(H, block=16, seed=3),
        "bigbird_per_head_uni": mod.BigBirdSparsityConfig(
            H, block=16, different_layout_per_head=True, num_random_blocks=2,
            num_sliding_window_blocks=5, num_global_blocks=2,
            attention="unidirectional", seed=7),
        "bslongformer": mod.BSLongformerSparsityConfig(
            H, block=16, global_block_indices=[0, 5]),
        "bslongformer_ranges_uni": mod.BSLongformerSparsityConfig(
            H, block=16, different_layout_per_head=True,
            global_block_indices=[1, 6], global_block_end_indices=[3, 7],
            attention="unidirectional"),
        "variable": mod.VariableSparsityConfig(
            H, block=16, local_window_blocks=[1, 2, 4],
            global_block_indices=[0]),
        "variable_random_per_head": mod.VariableSparsityConfig(
            H, block=16, different_layout_per_head=True, num_random_blocks=2,
            local_window_blocks=[2, 3], global_block_indices=[1, 4],
            global_block_end_indices=[2, 6], horizontal_global_attention=True,
            seed=11),
    }


@pytest.mark.parametrize("seq_len", [128, 256])
@pytest.mark.parametrize("name", sorted(_configs(J)))
def test_layouts_bit_identical(name, seq_len):
    want = _configs(J)[name].make_layout(seq_len)
    got = _configs(T)[name].make_layout(seq_len)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_layout_rejects_ragged_seq_and_base_class():
    with pytest.raises(ValueError, match="not divisible"):
        T.FixedSparsityConfig(1, block=16).make_layout(40)
    with pytest.raises(NotImplementedError):
        T.SparsityConfig(1).make_layout(32)


def _empty_row_layout(H):
    """Causal: block row 0 sees only an above-diagonal block (its rows go
    empty), block 3 is attended by no row (its columns go empty)."""
    lay = np.zeros((H, 4, 4), np.int64)
    lay[:, 0, 1] = 1
    lay[:, 1, :2] = 1
    lay[:, 2, 1:3] = 1
    lay[:, 3, 0] = 1
    lay[-1, 2, 0] = 1          # the last head differs
    return lay


def _layouts(S=64, H=2):
    out = {name: cfg.make_layout(S) for name, cfg in _configs(T, H).items()
           if name in ("fixed", "bigbird_per_head_uni",
                       "variable_random_per_head")}
    out["empty_rows"] = _empty_row_layout(H)
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(_layouts()))
def test_plans_equal(name, causal):
    lay = _layouts()[name]
    for ours, ref in ((TB._plan, JB._plan),
                      (TB._plan_transpose, JB._plan_transpose)):
        got, want = ours(lay, causal), ref(lay, causal)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]
    plan = TB.BlockSparsePlan(lay, causal)
    kv_idx, kv_cnt, _ = JB._plan(lay, causal)
    q_idx, q_cnt, _ = JB._plan_transpose(lay, causal)
    for g, w in ((plan.kv_idx_np, kv_idx), (plan.kv_cnt_np, kv_cnt),
                 (plan.q_idx_np, q_idx), (plan.q_cnt_np, q_cnt)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(plan.kv_idx.numpy(), kv_idx)
    assert plan.live == int(kv_cnt.sum()) == int(q_cnt.sum())
    # the kernels' block order: a permutation, longest list first
    for order, cnt in ((plan.q_order, kv_cnt), (plan.k_order, q_cnt)):
        for h in range(lay.shape[0]):
            o = order[h].numpy()
            assert sorted(o) == list(range(lay.shape[1]))
            assert (np.diff(cnt[h][o]) <= 0).all()


def _inputs(B, S, H, seed, n=4, hd=HD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd), dtype=np.float32)
            for _ in range(n)]


def _ready(*xs):
    """The JAX results as numpy, computed to the end before any torch op
    runs (JAX dispatches asynchronously; the two frameworks' CPU thread
    pools are kept from overlapping)."""
    return [np.asarray(jax.block_until_ready(x)) for x in xs]


def _bhsd(*xs):
    return [jnp.asarray(x).transpose(0, 2, 1, 3) for x in xs]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _lse_close(got, want):
    """lse: +inf exactly where the reference has it, close elsewhere."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(_layouts()))
def test_plain_forward_matches_pallas(name, causal):
    lay = _layouts()[name]
    q, k, v = _inputs(2, 64, 2, seed=1, n=3)
    kv_idx, kv_cnt, _ = JB._plan(lay, causal)
    o, lse = _ready(*JB._call(*_bhsd(q, k, v), jnp.asarray(kv_idx),
                              jnp.asarray(kv_cnt), causal=causal, block=16,
                              sm_scale=None, interpret=True, with_lse=True))
    want, = _ready(JB.block_sparse_attention(
        *(jnp.asarray(x) for x in (q, k, v)), lay, causal=causal,
        interpret=True))
    plan = TB.BlockSparsePlan(lay, causal)
    to, tl = TB.block_sparse_attention_fwd(*_t(q, k, v), plan)
    np.testing.assert_allclose(to.numpy(), o.transpose(0, 2, 1, 3),
                               rtol=0, atol=FWD_TOL)
    _lse_close(tl, lse[..., 0])
    # the forward alone (the reference's with_lse=False path)
    got = TB.block_sparse_attention(*_t(q, k, v), lay, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_TOL)
    assert TB.block_sparse_attention_fwd(*_t(q, k, v), plan,
                                         with_lse=False)[1] is None


@pytest.mark.parametrize("causal,sm_scale", [(False, None), (True, None),
                                             (True, 0.3)])
def test_plain_backward_matches_pallas(causal, sm_scale):
    """dq over the plan, dk / dv over the transposed plan, given the
    reference's own lse and dsum."""
    lay = _layouts()["bigbird_per_head_uni"]
    q, k, v, do = _inputs(2, 64, 2, seed=2)
    kv_idx, kv_cnt, _ = JB._plan(lay, causal)
    q_idx, q_cnt, _ = JB._plan_transpose(lay, causal)
    args = [jnp.asarray(a) for a in (kv_idx, kv_cnt, q_idx, q_cnt)]
    qt, kt, vt, dot = _bhsd(q, k, v, do)
    o, lse = JB._call(qt, kt, vt, args[0], args[1], causal=causal, block=16,
                      sm_scale=sm_scale, interpret=True, with_lse=True)
    dsum = (dot * o).sum(-1, keepdims=True)
    dq, dk, dv, lse, dsum = _ready(*JB._bwd_call(
        qt, kt, vt, dot, lse, dsum, *args, causal=causal, block=16,
        sm_scale=sm_scale, interpret=True), lse, dsum)
    plan = TB.BlockSparsePlan(lay, causal)
    rows = [torch.from_numpy(x[..., 0].copy()) for x in (lse, dsum)]
    tq = TB.block_sparse_attention_dq(*_t(q, k, v, do), *rows, plan,
                                      sm_scale)
    tk, tv = TB.block_sparse_attention_dkv(*_t(q, k, v, do), *rows, plan,
                                           sm_scale)
    for got, want in ((tq, dq), (tk, dk), (tv, dv)):
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1, 3),
                                   rtol=0, atol=BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["fixed", "empty_rows"])
def test_plain_matches_pallas_at_head_dim_80(name, causal):
    """Head dim 80, which the CUDA kernels take (``HEAD_DIMS``) as the
    flash and decode kernels do: the plain forward, lse, dq, dk and dv
    against the Pallas kernels in interpret mode."""
    assert 80 in TB.HEAD_DIMS
    lay = _layouts()[name]
    q, k, v, do = _inputs(1, 64, 2, seed=5, hd=80)
    kv_idx, kv_cnt, _ = JB._plan(lay, causal)
    q_idx, q_cnt, _ = JB._plan_transpose(lay, causal)
    args = [jnp.asarray(a) for a in (kv_idx, kv_cnt, q_idx, q_cnt)]
    qt, kt, vt, dot = _bhsd(q, k, v, do)
    o, lse = JB._call(qt, kt, vt, args[0], args[1], causal=causal, block=16,
                      sm_scale=None, interpret=True, with_lse=True)
    dsum = (dot * o).sum(-1, keepdims=True)
    dq, dk, dv, o, lse, dsum = _ready(*JB._bwd_call(
        qt, kt, vt, dot, lse, dsum, *args, causal=causal, block=16,
        sm_scale=None, interpret=True), o, lse, dsum)
    plan = TB.BlockSparsePlan(lay, causal)
    to, tl = TB.block_sparse_attention_fwd(*_t(q, k, v), plan)
    np.testing.assert_allclose(to.numpy(), o.transpose(0, 2, 1, 3),
                               rtol=0, atol=FWD_TOL)
    _lse_close(tl, lse[..., 0])
    rows = [torch.from_numpy(x[..., 0].copy()) for x in (lse, dsum)]
    tq = TB.block_sparse_attention_dq(*_t(q, k, v, do), *rows, plan)
    tk, tv = TB.block_sparse_attention_dkv(*_t(q, k, v, do), *rows, plan)
    for got, want in ((tq, dq), (tk, dk), (tv, dv)):
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1, 3),
                                   rtol=0, atol=BWD_TOL)


@pytest.mark.parametrize("causal,name,sm_scale", [
    (False, "fixed", None), (True, "fixed", None),
    (True, "variable_random_per_head", 0.2), (False, "empty_rows", None),
    (True, "empty_rows", None)])
def test_autograd_matches_jax_grad(causal, name, sm_scale):
    lay = _layouts()[name]
    q, k, v, g = _inputs(2, 64, 2, seed=3)

    def loss(q, k, v):
        out = JB.block_sparse_attention_trainable(
            q, k, v, lay, causal=causal, sm_scale=sm_scale, interpret=True)
        return (out * jnp.asarray(g)).sum()
    want = _ready(*jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v))))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = TB.block_sparse_attention_trainable(tq, tk, tv, lay, causal=causal,
                                              sm_scale=sm_scale)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["fixed", "bigbird_per_head_uni",
                                  "bslongformer"])
def test_dense_path_matches_jax(name, causal):
    """impl="dense": forward and gradients against the JAX dense path, and
    impl="pallas" (the plain versions here) against both."""
    jcfg, tcfg = _configs(J, 2)[name], _configs(T, 2)[name]
    q, k, v, g = _inputs(2, 64, 2, seed=4)

    def loss(q, k, v):
        out = J.sparse_self_attention(q, k, v, jcfg, causal=causal)
        return (out * jnp.asarray(g)).sum(), out
    (_, want), gw = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    want, *gw = _ready(want, *gw)
    for impl in ("dense", "pallas"):
        tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
        out = T.sparse_self_attention(tq, tk, tv, tcfg, causal=causal,
                                      impl=impl)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=FWD_TOL)
        got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                  (tq, tk, tv))
        for a, b in zip(got, gw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


def test_poisoned_blocks_never_reach_the_plain_versions():
    """inf in every kv block outside the layout: the forward is bit-
    identical and the gradients stay finite and unchanged (the dense
    path would turn those blocks into 0 * inf = NaN)."""
    cfg = T.FixedSparsityConfig(1, block=16, num_local_blocks=1,
                                num_global_blocks=0)
    lay = cfg.make_layout(64)
    lay[:, :2, :] = 0
    lay[:, :2, :2] = np.tril(np.ones((2, 2), np.int64))  # blocks 2-3 unseen
    lay[:, 2:, :] = 0
    lay[:, 2:, 0] = 1
    q, k, v, g = _t(*_inputs(1, 64, 1, seed=8))
    k2, v2 = k.clone(), v.clone()
    k2[:, 32:], v2[:, 32:] = float("inf"), float("inf")
    outs = []
    for kk, vv in ((k, v), (k2, v2)):
        tq, tk, tv = (x.clone().requires_grad_() for x in (q, kk, vv))
        out = TB.block_sparse_attention_trainable(tq, tk, tv, lay)
        grads = torch.autograd.grad((out * g).sum(), (tq, tk, tv))
        outs.append((out.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.isfinite(b[:, :32]).all()
        assert torch.equal(a[:, :32], b[:, :32])
    # the reference's test, on the port: rows 0-31 see only kv block 0
    cfg_lay = cfg.make_layout(64)
    o1 = TB.block_sparse_attention(q, k, v, cfg_lay)
    o2 = TB.block_sparse_attention(q, k2, v2, cfg_lay)
    assert torch.equal(o1[:, :32], o2[:, :32])


def test_fully_masked_rows_emit_zero_both_paths():
    """A causal layout whose first block-row sees only an above-diagonal
    block: both impls emit exactly 0 there (lse +inf), and those rows'
    gradients and the unattended kv block's dk / dv are exactly 0."""
    lay = np.array([[[0, 1], [1, 1]]])

    class Cfg:
        def make_layout(self, seq_len):
            return lay

    q, k, v, g = _t(*_inputs(1, 32, 1, seed=11))
    dense = T.sparse_self_attention(q, k, v, Cfg(), causal=True)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    kern = T.sparse_self_attention(tq, tk, tv, Cfg(), causal=True,
                                   impl="pallas")
    assert torch.equal(dense[:, :16], torch.zeros_like(dense[:, :16]))
    assert torch.equal(kern[:, :16], torch.zeros_like(kern[:, :16]))
    torch.testing.assert_close(dense[:, 16:], kern[:, 16:].detach(),
                               rtol=0, atol=FWD_TOL)
    _, lse = TB.block_sparse_attention_fwd(
        q, k, v, TB.BlockSparsePlan(lay, True))
    assert torch.isinf(lse[..., :16]).all() and (lse[..., :16] > 0).all()
    dq, dk, dv = torch.autograd.grad((kern * g).sum(), (tq, tk, tv))
    assert torch.equal(dq[:, :16], torch.zeros_like(dq[:, :16]))
    # the dense path agrees
    dq2, dk2, dv2 = torch.autograd.grad(
        (T.sparse_self_attention(tq, tk, tv, Cfg(), causal=True) * g).sum(),
        (tq, tk, tv))
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    # a kv block no row attends (block 3 of this layout) gets dk = dv = 0
    q, k, v, g = (x.requires_grad_() for x in _t(*_inputs(1, 64, 2, 14)))
    out = TB.block_sparse_attention_trainable(q, k, v, _empty_row_layout(2),
                                              causal=True)
    assert torch.equal(out[:, :16].detach(), torch.zeros(1, 16, 2, HD))
    dq, dk, dv = torch.autograd.grad((out * g).sum(), (q, k, v))
    for t, rows in ((dq, slice(0, 16)), (dk, slice(48, 64)),
                    (dv, slice(48, 64))):
        assert torch.equal(t[:, rows], torch.zeros_like(t[:, rows]))


def test_bwd_noncausal_and_empty_rows():
    """The reference's test_pallas_block_sparse_bwd_noncausal_and_empty_rows
    on the port: non-causal gradients match jax.grad, and rows left empty
    by the causal tril get exactly zero dq."""
    cfg = T.FixedSparsityConfig(2, block=16, num_local_blocks=1,
                                num_global_blocks=1)
    lay = cfg.make_layout(32)
    q, k, v = _inputs(2, 32, 2, seed=12, n=3)

    def loss(q, k, v):
        return JB.block_sparse_attention_trainable(q, k, v, lay,
                                                   interpret=True).sum()
    want = _ready(*jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v))))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    got = torch.autograd.grad(
        TB.block_sparse_attention_trainable(tq, tk, tv, lay).sum(),
        (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    lay2 = np.array([[[0, 1], [1, 1]]] * 2)
    dq, = torch.autograd.grad(TB.block_sparse_attention_trainable(
        tq, tk, tv, lay2, causal=True).sum(), (tq,))
    assert torch.equal(dq[:, :16], torch.zeros_like(dq[:, :16]))


def test_module_and_impl_handling():
    cfg = T.FixedSparsityConfig(2, block=16, num_local_blocks=2)
    q, k, v = _t(*_inputs(1, 64, 2, seed=13, n=3))
    dense = T.SparseSelfAttention(cfg)
    assert isinstance(dense, torch.nn.Module)
    assert list(dense.parameters()) == [] and dense.impl == "dense"
    kern = T.SparseSelfAttention(cfg, attn_mask_mode="add", impl="pallas")
    assert kern.attn_mask_mode == "add"
    for causal in (False, True):
        torch.testing.assert_close(kern(q, k, v, causal=causal),
                                   dense(q, k, v, causal=causal),
                                   rtol=0, atol=FWD_TOL)
    with pytest.raises(ValueError, match="impl"):
        T.SparseSelfAttention(cfg, impl="triton")
    with pytest.raises(ValueError, match="impl"):
        T.sparse_self_attention(q, k, v, cfg, impl="flash")
    # a layout whose head count is not q's is refused
    with pytest.raises(ValueError, match="heads"):
        T.sparse_self_attention(q, k, v, T.FixedSparsityConfig(3, 16),
                                impl="pallas")


def test_plan_and_layout_built_once_per_config():
    cfg = T.BigBirdSparsityConfig(2, block=16, seed=1)
    p1 = T.cached_plan(cfg, 64, True, "cpu")
    assert T.cached_plan(cfg, 64, True, "cpu") is p1
    assert T.cached_layout(cfg, 64) is T.cached_layout(cfg, 64)
    assert T.cached_plan(cfg, 64, False, "cpu") is not p1
    assert T.cached_plan(cfg, 128, True, "cpu").n == 8
    cfg.seed = 2                       # a changed config builds anew
    p2 = T.cached_plan(cfg, 64, True, "cpu")
    assert p2 is not p1
    np.testing.assert_array_equal(
        T.cached_layout(cfg, 64),
        J.BigBirdSparsityConfig(2, block=16, seed=2).make_layout(64))
    with pytest.raises(ValueError, match="causal"):
        TB.as_plan(p1, False, "cpu")


def test_plain_versions_bit_identical_on_several_threads():
    """The module fixture keeps torch on one thread; here the plain
    versions run on four, at a size where torch splits their ops across
    threads, and two calls agree bit for bit: no race among threads.  One
    threaded ``exp`` first takes the first-call defect the fixture's
    docstring describes."""
    torch.set_num_threads(4)
    try:
        torch.exp(torch.zeros(1 << 16))
        cfg = T.FixedSparsityConfig(2, block=16, num_local_blocks=4,
                                    attention="unidirectional")
        plan = TB.BlockSparsePlan(cfg.make_layout(1024), True)
        q, k, v, do = _t(*_inputs(2, 1024, 2, seed=9))
        runs = []
        for _ in range(2):
            o, lse = TB.block_sparse_attention_fwd(q, k, v, plan)
            dsum = (do * o).sum(-1).transpose(1, 2).contiguous()
            runs.append((o, lse, TB.block_sparse_attention_dq(
                q, k, v, do, lse, dsum, plan),
                *TB.block_sparse_attention_dkv(q, k, v, do, lse, dsum,
                                               plan)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)
    finally:
        torch.set_num_threads(1)


def test_layout_to_mask_expands_blocks():
    cfg = T.FixedSparsityConfig(num_heads=1, block=4, num_local_blocks=1,
                                num_global_blocks=0)
    mask = T.layout_to_mask(cfg.make_layout(16), 16)
    assert mask.shape == (1, 16, 16) and mask.dtype == torch.bool
    assert bool(mask[0, 0, 3]) and not bool(mask[0, 0, 4])
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(J.layout_to_mask(cfg.make_layout(16), 16)))


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """Validation runs before any launch, so it is checkable here; CPU
    tensors never launch a kernel."""
    for name in ("fwd", "dq", "dkv"):
        getattr(TB, f"block_sparse_attention_{name}").launches = 0
    lay = np.ones((2, 4, 4), np.int64)
    plan = TB.BlockSparsePlan(lay, True)
    for S, hd, dt in ((32, 64, torch.float32),       # block 8
                      (64, 32, torch.float32),       # head_dim 32
                      (64, 64, torch.float16)):      # fp16
        x = torch.zeros(1, S, 2, hd, dtype=dt)
        with pytest.raises(NotImplementedError, match="no CUDA kernel"):
            TB.block_sparse_attention_fwd_cuda(x, x, x, plan)
        # the refusal names the ROADMAP item that would bring the shape
        with pytest.raises(NotImplementedError, match="Block-sparse shapes "
                           "the reference runs and the port refuses"):
            TB.block_sparse_attention_fwd_cuda(x, x, x, plan)
    x = torch.zeros(1, 64, 2, 66)[..., :64]          # 132-byte rows
    with pytest.raises(ValueError, match="strides"):
        TB.block_sparse_attention_fwd_cuda(x, x, x, plan)
    rows = torch.zeros(1, 2, 64)
    y = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="dsum"):
        TB.block_sparse_attention_dq_cuda(y, y, y, y, rows, rows[0], plan)
    x = torch.zeros(1, 64, 2, 64)
    o, lse = TB.block_sparse_attention_fwd(x, x, x, plan)
    TB.block_sparse_attention_dq(x, x, x, x, lse, rows, plan)
    TB.block_sparse_attention_dkv(x, x, x, x, lse, rows, plan)
    assert (TB.block_sparse_attention_fwd.launches
            == TB.block_sparse_attention_dq.launches
            == TB.block_sparse_attention_dkv.launches == 0)
