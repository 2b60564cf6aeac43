"""Optimizer registry (counterpart of
``deepspeed_tpu/runtime/optimizers.py`` ``build_optimizer``), Adam family
only: ``adam``, ``adamw``, ``fusedadam`` and ``deepspeedcpuadam`` map to
the same math (on the GPU "fused" is not a different algorithm): one
:func:`mp_adamw`, which with fp32 masters and states is optax's ``adam``
(no decay) / ``adamw`` up to fp32 rounding.  :func:`clip_by_global_norm`
is optax's (``g * max_norm / norm`` only when ``norm >= max_norm``).
Other optimizer names raise NotImplementedError.
"""
from typing import Optional

import torch

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.bf16_optimizer import (
    GradientTransformation, mp_adamw, resolve_dtype)
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

ADAM_FAMILY = (C.ADAM_OPTIMIZER, C.FUSED_ADAM, C.CPU_ADAM,
               C.ADAMW_OPTIMIZER)
#: names the reference builds that this port does not (ROADMAP queue A)
UNPORTED_OPTIMIZERS = (C.LAMB_OPTIMIZER, C.FUSED_LAMB, C.SGD_OPTIMIZER,
                       C.ADAGRAD_OPTIMIZER, C.LION_OPTIMIZER,
                       C.ONEBIT_ADAM_OPTIMIZER, C.ZERO_ONE_ADAM_OPTIMIZER,
                       C.ONEBIT_LAMB_OPTIMIZER)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's ``clip_by_global_norm``: the norm of the updates in their
    own dtype; updates scaled by ``max_norm / norm`` only when
    ``norm >= max_norm`` (no host sync: a select on the device)."""

    def update(grads, state, params=None):
        g_norm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(grads)))
        keep = g_norm < max_norm
        return tree_map(lambda t: torch.where(
            keep, t, (t / g_norm.to(t.dtype)) * max_norm), grads), state

    return GradientTransformation(lambda params: (), update)


def chain(*transforms) -> GradientTransformation:
    """optax's ``chain``: each transform's updates feed the next."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def _adam_args(params: dict):
    betas = params.get("betas", (0.9, 0.999))
    return dict(b1=float(betas[0]), b2=float(betas[1]),
                eps=float(params.get("eps", 1e-8)))


def build_optimizer(name: Optional[str], params: Optional[dict],
                    lr_schedule=None, mu_dtype=None, nu_dtype=None,
                    master_dtype: str = "float32") -> GradientTransformation:
    """The inner optimizer transform (the reference's ``build_optimizer``).
    ``lr_schedule`` overrides the config's static lr when given;
    ``mu_dtype``/``nu_dtype``/``master_dtype`` select the mixed-precision
    states of :func:`mp_adamw`."""
    params = dict(params or {})
    lr = (lr_schedule if lr_schedule is not None
          else float(params.get("lr", 1e-3)))
    name = (name or C.ADAM_OPTIMIZER).lower()
    wd = float(params.get("weight_decay", 0.0))
    mp_states = (mu_dtype or nu_dtype
                 or resolve_dtype(master_dtype) != torch.float32)
    if name not in ADAM_FAMILY:
        if mp_states:
            raise ValueError(
                "bf16.master_weights_dtype/optimizer_states_dtype require "
                f"an Adam-family optimizer, got {name!r}")
        if name in UNPORTED_OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer {name!r}: not ported to deepspeed_tpu_torch yet "
                "(ROADMAP.md Queue A: other optimizers); the port trains "
                f"with the Adam family {ADAM_FAMILY}")
        raise ValueError(f"Unknown optimizer {name!r} in DeepSpeed config")
    # Adam with adam_w_mode off drops the decay (the reference's optax.adam)
    if name != C.ADAMW_OPTIMIZER and not params.get("adam_w_mode", True):
        wd = 0.0
    return mp_adamw(lr, weight_decay=wd, mu_dtype=mu_dtype,
                    nu_dtype=nu_dtype, master_dtype=master_dtype,
                    **_adam_args(params))
