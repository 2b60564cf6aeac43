"""The port's loss scaler (``runtime/fp16/loss_scaler.py``) against the
JAX package's: the same sequence of overflow flags through both
``update_scale``s, and after every step the scale, the iteration, the
last overflow iteration and the hysteresis held equal, exactly (the
state is four scalars updated by selects on both sides).  Cases: a
static scale, the default dynamic one, a short growth window, the
minimum-scale floor, hysteresis with and without
``consecutive_hysteresis``, and the disabled scaler.  ``has_overflow``
against the reference's on finite, NaN and inf gradient trees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as pls

T, F = True, False
CASES = {
    "static": (dict(loss_scale=128.0), [T, F, T, T, F]),
    "dynamic_default": (dict(), [F, T, T, F, F, T, F]),
    "window": (dict(initial_scale_power=8, loss_scale_window=3),
               [F, F, F, F, T, F, F, F, F, F, F, T, T]),
    "min_scale": (dict(initial_scale_power=2, hysteresis=1,
                       min_loss_scale=1.0), [T] * 6 + [F, F]),
    "hysteresis_3": (dict(initial_scale_power=10, hysteresis=3,
                          loss_scale_window=4),
                     [T, F, T, T, T, F, F, F, F, T]),
    "consecutive_hysteresis": (dict(initial_scale_power=10, hysteresis=2,
                                    consecutive_hysteresis=True,
                                    loss_scale_window=4),
                               [T, F, T, F, T, T, T, F, F, F, F]),
    "disabled": (dict(enabled=False), [T, F, T]),
}


def _state(s):
    return (float(s.cur_scale), int(s.cur_iter), int(s.last_overflow_iter),
            int(s.cur_hysteresis))


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_scale_matches_jax(case):
    kw, flags = CASES[case]
    kw = dict(kw)
    enabled = kw.pop("enabled", True)
    js, jc = jls.create_loss_scaler(enabled, **kw)
    ps, pc = pls.create_loss_scaler(enabled, **kw)
    assert pc == pls.LossScalerConfig(**vars(jc))
    assert _state(ps) == _state(js)
    seen = set()
    for i, ov in enumerate(flags):
        js = jls.update_scale(js, jnp.bool_(ov), jc)
        ps = pls.update_scale(ps, torch.tensor(ov), pc)
        assert _state(ps) == _state(js), (case, i, _state(ps), _state(js))
        assert ps.cur_scale.dtype == torch.float32
        assert all(t.dtype == torch.int32 for t in ps[1:])
        seen.add(_state(ps)[0])
    if enabled and pc.dynamic:      # the case moved the scale
        assert len(seen) > 1


@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf])
def test_has_overflow_matches_jax(bad):
    a = np.ones(5, np.float32)
    if bad is not None:
        a[3] = bad
    tree = {"a": a, "b": {"c": np.zeros((2, 2), np.float32)}}
    want = bool(jls.has_overflow({"a": jnp.asarray(a),
                                  "b": {"c": jnp.zeros((2, 2))}}))
    got = pls.has_overflow({"a": torch.from_numpy(a),
                            "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    assert got.dtype == torch.bool and bool(got) == want == (bad is not None)
