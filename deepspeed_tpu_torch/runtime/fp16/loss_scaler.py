"""Static and dynamic loss scaling (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The scaler's state (:class:`LossScaleState`) is four 0-d tensors on the
device, updated by selects as the reference's jitted update is, so no
step reads it on the host; its static knobs live in
:class:`LossScalerConfig`.  :func:`has_overflow` is one finite check over
every gradient (a single reduction per leaf into one flag on the device);
the engine reads that flag once a step to skip the update.
"""
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch


class LossScaleState(NamedTuple):
    cur_scale: torch.Tensor            # f32 scalar
    cur_iter: torch.Tensor             # i32 scalar
    last_overflow_iter: torch.Tensor   # i32 scalar
    cur_hysteresis: torch.Tensor       # i32 scalar


@dataclass(frozen=True)
class LossScalerConfig:
    dynamic: bool = True
    scale_window: int = 1000
    scale_factor: float = 2.0
    min_scale: float = 1.0
    delayed_shift: int = 2                  # hysteresis
    consecutive_hysteresis: bool = False    # refill on every good step


def _state(scale, it, last, hyst, device) -> LossScaleState:
    return LossScaleState(
        torch.tensor(scale, dtype=torch.float32, device=device),
        torch.tensor(it, dtype=torch.int32, device=device),
        torch.tensor(last, dtype=torch.int32, device=device),
        torch.tensor(hyst, dtype=torch.int32, device=device))


def create_loss_scaler(enabled: bool, loss_scale: float = 0.0,
                       initial_scale_power: int = 16,
                       loss_scale_window: int = 1000, hysteresis: int = 2,
                       min_loss_scale: float = 1.0,
                       consecutive_hysteresis: bool = False,
                       device="cpu"
                       ) -> Tuple[LossScaleState, LossScalerConfig]:
    """(state, config) as the reference builds them: disabled -> scale 1,
    static; ``loss_scale`` 0 -> dynamic from 2^initial_scale_power, else
    static at ``loss_scale``."""
    if not enabled:
        return (_state(1.0, 0, -1, 1, device),
                LossScalerConfig(dynamic=False))
    dynamic = loss_scale == 0.0
    init = float(2.0 ** initial_scale_power) if dynamic else float(loss_scale)
    cfg = LossScalerConfig(dynamic=dynamic,
                           scale_window=int(loss_scale_window),
                           min_scale=float(min_loss_scale),
                           delayed_shift=int(hysteresis),
                           consecutive_hysteresis=bool(consecutive_hysteresis))
    return _state(init, 0, -1, hysteresis, device), cfg


def has_overflow(grads) -> torch.Tensor:
    """A 0-d bool on the device: whether any gradient holds a NaN or an
    inf (the reference's ``has_overflow_serial``).  One reduction per
    leaf, summed on the device; nothing is read on the host."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    bad = [(~torch.isfinite(g)).any() for g in tree_leaves(grads)]
    return torch.stack(bad).any()


def update_scale(state: LossScaleState, overflow: torch.Tensor,
                 cfg: LossScalerConfig) -> LossScaleState:
    """The dynamic loss-scale update (the reference's
    ``LossScaler.update_scale``), in selects on the device."""
    if not cfg.dynamic:
        return state._replace(cur_iter=state.cur_iter + 1)
    i32 = torch.int32
    hysteresis_exhausted = state.cur_hysteresis <= 1
    shrink = overflow & hysteresis_exhausted
    new_hysteresis = torch.where(
        overflow, torch.clamp(state.cur_hysteresis - 1, min=0),
        state.cur_hysteresis)
    shrunk = torch.clamp(state.cur_scale / cfg.scale_factor,
                         min=cfg.min_scale)
    # growth fires on the scale_window-th consecutive good step:
    # (cur_iter - last_overflow_iter) reaches a multiple of scale_window
    # (last_overflow_iter starts at -1; evaluated before the increment)
    stable = torch.remainder(state.cur_iter - state.last_overflow_iter,
                             cfg.scale_window) == 0
    grow = ~overflow & stable
    new_scale = torch.where(shrink, shrunk,
                            torch.where(grow,
                                        state.cur_scale * cfg.scale_factor,
                                        state.cur_scale))
    new_last = torch.where(overflow, state.cur_iter,
                           state.last_overflow_iter)
    refill = torch.full_like(state.cur_hysteresis, cfg.delayed_shift)
    if cfg.consecutive_hysteresis:
        # the budget refills on every good step, so only consecutive
        # overflows can exhaust it and shrink the scale
        new_hysteresis = torch.where(~overflow, refill, new_hysteresis)
    else:
        # it refills on growth, not on shrink
        new_hysteresis = torch.where(grow, refill, new_hysteresis)
    return LossScaleState(new_scale, (state.cur_iter + 1).to(i32),
                          new_last.to(i32), new_hysteresis.to(i32))
