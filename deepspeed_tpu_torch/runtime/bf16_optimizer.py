"""Mixed-precision AdamW (counterpart of
``deepspeed_tpu/runtime/bf16_optimizer.py`` ``mp_adamw``): Adam moments
stored in a chosen dtype (math in fp32), and optional Kahan-compensated
bf16 master weights.

The transform has the reference's optax shape: ``init(params) -> state``
and ``update(grads, state, params) -> (updates, state)``, where the engine
applies ``p + u`` cast to ``p``'s dtype.  Plain bf16 masters would drop
updates smaller than ~2^-8 of the weight; the compensation buffer carries
the rounding residual so tiny updates accumulate across steps.  The
residual is computed against the exact applied result by replaying the
bf16 casts of the apply, so any rounding there lands in the residual.
With fp32 masters and fp32 states it is plain AdamW.
"""
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)`` over nested-dict trees (optax's contract)."""
    init: Callable
    update: Callable


class MPAdamState(NamedTuple):
    count: int         # updates applied so far
    mu: Any
    nu: Any
    comp: Any          # Kahan residuals (None with fp32 masters)


def resolve_dtype(name) -> torch.dtype:
    """"bfloat16" / "float32" / None (fp32) / torch.dtype -> torch.dtype."""
    if name is None:
        return torch.float32
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unsupported dtype {name!r}")
    return dt


def scalar(x, device) -> torch.Tensor:
    """An fp32 0-d tensor on ``device`` (the reference's fp32 scalars)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def mp_adamw(learning_rate: Union[float, Callable], b1: float = 0.9,
             b2: float = 0.999, eps: float = 1e-8,
             weight_decay: float = 0.0, mu_dtype: Optional[str] = None,
             nu_dtype: Optional[str] = None,
             master_dtype: str = "float32") -> GradientTransformation:
    """AdamW with per-state storage dtypes and optional Kahan-compensated
    low-precision master weights.  ``learning_rate`` is a float or a
    ``step -> float`` schedule, read at the pre-increment count; the bias
    correction is 1-based like Adam's t."""
    mu_dt, nu_dt = resolve_dtype(mu_dtype), resolve_dtype(nu_dtype)
    comp_dt = resolve_dtype(master_dtype)
    kahan = comp_dt != torch.float32

    def init(params):
        def zeros(dt):
            return tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                  device=p.device), params)
        return MPAdamState(0, zeros(mu_dt), zeros(nu_dt),
                           zeros(comp_dt) if kahan else None)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("mp_adamw requires params")
        dev = tree_leaves(params)[0].device
        count = state.count + 1
        c = scalar(count, dev)
        lr = (learning_rate(state.count) if callable(learning_rate)
              else learning_rate)
        lr = scalar(lr, dev)
        bc1 = 1.0 - scalar(b1, dev) ** c
        bc2 = 1.0 - scalar(b2, dev) ** c

        def leaf(g, m, v, comp, p):
            g32 = g.float()
            m32 = b1 * m.float() + (1.0 - b1) * g32
            v32 = b2 * v.float() + (1.0 - b2) * g32 * g32
            p32 = p.float()
            step = -(lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                     + lr * weight_decay * p32)
            if not kahan:
                return step, m32.to(mu_dt), v32.to(nu_dt), None
            # Kahan: y = step - residual; apply; new residual =
            # (applied - p) - y, with "applied" replayed through the same
            # casts the apply performs
            y = step - comp.float()
            u = (p32 + y).to(p.dtype).float() - p32
            applied = (p32 + u.to(p.dtype).float()).to(p.dtype).float()
            return (u, m32.to(mu_dt), v32.to(nu_dt),
                    ((applied - p32) - y).to(comp_dt))

        comp = state.comp if kahan else tree_map(lambda g: None, grads)
        out = tree_map(leaf, grads, state.mu, state.nu, comp, params)

        def pick(i):
            return tree_map(lambda o: o[i], out)
        return pick(0), MPAdamState(count, pick(1), pick(2),
                                    pick(3) if kahan else None)

    return GradientTransformation(init, update)
