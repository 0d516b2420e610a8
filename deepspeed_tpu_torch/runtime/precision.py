"""Dynamic loss scaling (counterpart of deepspeed_tpu/runtime/precision.py).

fp16 trains with a loss scale: an overflow (a non-finite gradient) skips the
update and, once the hysteresis is used up, halves the scale;
``loss_scale_window`` clean steps double it.  bf16 and fp32 use the static
unit scale and only count skipped steps.  The reference keeps a device copy
and a host mirror of this state machine; the port needs one, on the host.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from deepspeed_tpu_torch.config import FP16Config


class LossScaleState(NamedTuple):
    scale: float          # current loss scale
    growth_counter: int   # consecutive clean steps
    hysteresis: int       # overflows still tolerated before a backoff
    skipped: int          # total skipped steps


def init_loss_scale(cfg: FP16Config) -> LossScaleState:
    if not cfg.enabled:
        scale = 1.0
    elif cfg.loss_scale > 0:        # static scale
        scale = cfg.loss_scale
    else:                           # dynamic
        scale = 2.0 ** cfg.initial_scale_power
    return LossScaleState(scale=float(scale), growth_counter=0,
                          hysteresis=int(cfg.hysteresis), skipped=0)


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """All-finite check over a list of gradients, as one bool tensor on the
    gradients' device (no host sync here; the caller reads it once)."""
    grads = list(grads)
    if not grads:
        return torch.tensor(True)
    # a sum of squares is finite iff every element is (an overflow of the
    # fp32 sum itself also reads as an overflow step, which is the safe side)
    norms = torch._foreach_norm(grads)
    return torch.isfinite(torch.stack(norms)).all()


def update_loss_scale(state: LossScaleState, finite: bool,
                      cfg: FP16Config) -> LossScaleState:
    """One step of the scaler.  A static scale (loss_scale > 0) or fp16
    off: the state is frozen except for the skipped counter."""
    if not cfg.enabled or cfg.loss_scale > 0:
        return state._replace(skipped=state.skipped + (0 if finite else 1))
    if finite:
        counter = state.growth_counter + 1
        grow = counter >= cfg.loss_scale_window
        return LossScaleState(
            scale=state.scale * 2.0 if grow else state.scale,
            growth_counter=0 if grow else counter,
            hysteresis=int(cfg.hysteresis), skipped=state.skipped)
    hyst = state.hysteresis - 1
    scale = (max(state.scale / 2.0, cfg.min_loss_scale) if hyst <= 0
             else state.scale)
    return LossScaleState(scale=scale, growth_counter=0,
                          hysteresis=max(hyst, 1), skipped=state.skipped + 1)
