"""The training engine (counterpart of deepspeed_tpu/engine.py, on one GPU).

``DeepSpeedEngine`` wraps a model — an ``nn.Module`` whose
``forward(batch)`` returns a scalar loss — with the config-driven training
step: the batch triad, bf16/fp16 with fp32 master weights and dynamic loss
scaling, gradient accumulation in fp32, global-norm clipping, the optimizer
and the LR schedule.  It runs on ``cuda:0`` unless the caller passes a
device (``device="cpu"`` for the plain path, as the tests do); without
CUDA the default raises.

One step, as in the reference: every micro-batch's gradients are taken of
``(loss · scale)`` cast to fp32, cast to fp32 and added; the sum is divided
once by ``scale · gas``; a non-finite gradient skips the update (the skipped
counter and, under fp16, the loss scale move; the step clock that the LR
schedule reads does not); otherwise the gradients are clipped and the
optimizer updates the parameters in place.  The reported ``grad_norm`` is
the norm before clipping (``OVERFLOW_GNORM`` on a skipped step), the
reported loss the mean of the unscaled micro-batch losses.

Each ``train_batch`` reads its scalars (gradient norm, loss) from the
device once — the one host sync of a step, which also decides the
overflow skip.  Steps run eagerly; parameters are updated in place.

Not ported yet, and raising rather than doing nothing: checkpoints, the
guardian, resilience and prefetch (ROADMAP A.9), telemetry and the flops
profiler (A.10), the hybrid engine (A.11), ZeRO sharding across GPUs (A.8).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.runtime import lr_schedules, optimizers
from deepspeed_tpu_torch.runtime.dataloader import tree_leaves, tree_map
from deepspeed_tpu_torch.runtime.precision import (init_loss_scale,
                                                   update_loss_scale)
from deepspeed_tpu_torch.utils.logging import logger


class StepMetrics(NamedTuple):
    loss: float
    grad_norm: float
    loss_scale: float
    skipped_steps: int


# grad_norm reported for an overflow-skipped step: a finite sentinel instead
# of the raw NaN/Inf, so that consumers keyed on the norm never see a
# non-finite value for a step whose update was skipped
OVERFLOW_GNORM = -1.0


class DeepSpeedEngine:
    """Config-driven training engine on one device.

    model contract: an ``nn.Module`` whose ``forward(batch)`` returns a
    scalar loss for a dict of tensors with micro-batch-shaped leaves (and
    accepts ``deterministic=True`` for evaluation).
    """

    def __init__(self, model: torch.nn.Module, config: DeepSpeedTPUConfig,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 client_optimizer: Optional[optimizers.Optimizer] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        config.check_implemented()
        # a model whose attention the CUDA kernels cannot take fails here,
        # with the reason, not at its first step
        problem = getattr(getattr(model, "cfg", None), "cuda_problem", None)
        if self.device.type == "cuda" and problem is not None \
                and problem() is not None:
            raise ValueError(f"initialize: {problem()}")
        self.dp_world_size = 1
        config.resolve_batch_size(self.dp_world_size)
        self.zero_stage = config.zero_optimization.stage
        self.compute_dtype = config.compute_dtype
        # master-weight mode iff low-precision parameters
        self.use_master_weights = bool(config.bf16.enabled
                                       or config.fp16.enabled)
        self.gas = int(config.gradient_accumulation_steps)

        self.model = model.to(self.device)
        if self.use_master_weights:
            # parameters are cast once at init; the fp32 master is the
            # upcast of the cast parameter
            for p in self.model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(self.compute_dtype)
        self.params: List[torch.nn.Parameter] = [
            p for p in self.model.parameters() if p.requires_grad]

        # ---- optimizer + schedule
        self.lr_schedule = lr_scheduler
        if self.lr_schedule is None and config.scheduler is not None:
            self.lr_schedule = lr_schedules.build_schedule(
                config.scheduler.type, config.scheduler.params)
        if client_optimizer is not None:
            if not isinstance(client_optimizer, optimizers.Optimizer):
                raise TypeError(
                    "optimizer must be a deepspeed_tpu_torch.runtime."
                    f"optimizers.Optimizer, got {type(client_optimizer)!r}")
            inner, self._opt_params = client_optimizer, {}
        else:
            inner, self._opt_params = optimizers.build_optimizer(
                config.optimizer.type, config.optimizer.params)
        self.optimizer = (optimizers.MasterWeights(inner)
                          if self.use_master_weights else inner)
        self.optimizer.init([p.data for p in self.params])

        self.loss_scale = init_loss_scale(config.fp16)
        self.step_clock = 0          # applied updates: what the schedule reads
        self.global_steps = 0        # train_batch / step() calls
        self._last_metrics: Optional[StepMetrics] = None
        # forward/backward/step trio state
        self._accum_grads: Optional[List[torch.Tensor]] = None
        self._micro_losses: List[torch.Tensor] = []
        self._micro_steps = 0

    # ------------------------------------------------------------ batches

    def _reshape_gas(self, batch):
        """[gas*micro, ...] → [gas, micro, ...]."""
        def r(x):
            return x.reshape((self.gas, x.shape[0] // self.gas)
                             + tuple(x.shape[1:]))
        return tree_map(r, batch)

    def _form_batch(self, batch):
        """Host-side batch preparation: normalise to the [gas, micro, ...]
        form."""
        batch = tree_map(_to_numpy, batch)
        first_shape = tuple(tree_leaves(batch)[0].shape)
        local_bs = self.config.train_batch_size
        micro_local = local_bs // self.gas
        # disambiguate [gas, micro, ...] from the flat [batch, ...] form by
        # the second dim too: when gas == batch the leading dim cannot
        if (first_shape[0] == self.gas and len(first_shape) > 1
                and first_shape[1] == micro_local):
            pass
        elif first_shape[0] == local_bs:
            batch = self._reshape_gas(batch)
        else:
            raise ValueError(
                f"train_batch leading dims {first_shape[:2]} match "
                f"neither [gas={self.gas}, micro_local={micro_local}, "
                f"...] nor the flat process-local batch [{local_bs}, "
                f"...] (train_batch_size={self.config.train_batch_size} "
                f"/ 1 processes)")
        return batch

    def _to_device(self, batch):
        def put(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x))
            return t.to(self.device, non_blocking=True)
        return tree_map(put, batch)

    # -------------------------------------------------------------- steps

    def _grads_one_micro(self, batch):
        """One micro-batch's (fp32 grads of the scaled loss, unscaled
        loss)."""
        loss = self.model(batch)
        scaled = (loss * self.loss_scale.scale).float()
        grads = torch.autograd.grad(scaled, self.params)
        return [g.float() for g in grads], loss.detach().float()

    def _accumulate(self, acc, grads):
        if acc is None:
            return grads
        torch._foreach_add_(acc, grads)
        return acc

    def _apply_update(self, grads, losses, n_micro: int) -> StepMetrics:
        """Unscale, check, clip, update.  ``grads``: the fp32 sum over the
        micro-batches, consumed."""
        torch._foreach_div_(grads, self.loss_scale.scale * n_micro)
        norm = optimizers.global_norm(grads)
        mean_loss = torch.stack(losses).mean()
        # the one host sync of the step: the norm decides the overflow skip
        norm_h, loss_h = torch.stack([norm, mean_loss]).tolist()
        finite = bool(np.isfinite(norm_h))
        self.loss_scale = update_loss_scale(self.loss_scale, finite,
                                            self.config.fp16)
        if finite:
            clip = self.config.gradient_clipping
            if clip and clip > 0:
                optimizers.clip_by_global_norm(grads, clip, norm)
            updates = self.optimizer.update(
                grads, [p.data for p in self.params], self._lr_at_clock())
            torch._foreach_add_([p.data for p in self.params], updates)
            # an overflow-skipped step does not advance the schedule clock
            self.step_clock += 1
        return StepMetrics(loss=loss_h,
                           grad_norm=norm_h if finite else OVERFLOW_GNORM,
                           loss_scale=self.loss_scale.scale,
                           skipped_steps=self.loss_scale.skipped)

    def _lr_at_clock(self) -> float:
        if self.lr_schedule is None:
            return float(self._opt_params.get("lr", 1e-3))
        return float(self.lr_schedule(self.step_clock))

    def _finish_step(self, metrics: StepMetrics) -> StepMetrics:
        self.global_steps += 1
        self._last_metrics = metrics
        spp = self.config.steps_per_print
        if spp and spp > 0 and self.global_steps % spp == 0:
            logger.info(f"step={self.global_steps} loss={metrics.loss:.4f} "
                        f"grad_norm={metrics.grad_norm:.4f} "
                        f"lr={self.get_lr()[0]:.3e} "
                        f"loss_scale={metrics.loss_scale:g} "
                        f"skipped={metrics.skipped_steps}")
        return metrics

    # ---------------------------------------------------------------- API

    def train_batch(self, batch) -> StepMetrics:
        """One full optimizer step over ``gas`` micro-batches.  ``batch``
        leaves are host arrays (or tensors) shaped [gas × micro, ...] or
        already [gas, micro, ...]."""
        batch = self._form_batch(batch)
        batch = self._to_device(batch)
        self.model.train()
        acc, losses = None, []
        for i in range(self.gas):
            grads, loss = self._grads_one_micro(
                tree_map(lambda x: x[i], batch))
            acc = self._accumulate(acc, grads)
            losses.append(loss)
        return self._finish_step(self._apply_update(acc, losses, self.gas))

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """Deterministic evaluation loss on one flat batch — no gradients,
        no state change.  Returns a float32 scalar tensor on the device."""
        batch = self._to_device(tree_map(_to_numpy, batch))
        return self.model(batch, deterministic=True).float()

    def forward(self, batch) -> torch.Tensor:
        """Compatibility trio part 1: loss and gradients of one
        micro-batch, the gradients accumulated."""
        batch = self._to_device(tree_map(_to_numpy, batch))
        self.model.train()
        grads, loss = self._grads_one_micro(batch)
        self._accum_grads = self._accumulate(self._accum_grads, grads)
        self._micro_losses.append(loss)
        self._micro_steps += 1
        return loss

    def backward(self, loss=None):
        """The gradients were taken in ``forward``; kept for API parity."""
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._micro_steps % self.gas == 0

    def step(self) -> Optional[StepMetrics]:
        """Apply the accumulated update at the gradient-accumulation
        boundary."""
        if not self.is_gradient_accumulation_boundary():
            return None
        if self._accum_grads is None:
            raise RuntimeError("call forward() before step()")
        metrics = self._apply_update(self._accum_grads, self._micro_losses,
                                     self.gas)
        self._accum_grads = None
        self._micro_losses = []
        self._micro_steps = 0
        return self._finish_step(metrics)

    # --------------------------------------------------------------- info

    @property
    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    @property
    def skipped_steps(self) -> int:
        return self.loss_scale.skipped

    def get_lr(self):
        """The schedule read at the step clock (applied updates so far;
        skipped steps do not advance it) — the rate the next update takes,
        as the reference reports it."""
        return [self._lr_at_clock() if self.lr_schedule is not None
                else float(self._opt_params.get("lr", 0.0))]

    def get_global_grad_norm(self) -> Optional[float]:
        return (None if self._last_metrics is None
                else self._last_metrics.grad_norm)

    # ------------------------------------------------- not ported yet

    def save_checkpoint(self, *a, **kw):
        raise NotImplementedError("checkpoints are not ported yet "
                                  "(ROADMAP A.9)")

    load_checkpoint = save_checkpoint

    def guardian(self, *a, **kw):
        raise NotImplementedError("the guardian is not ported yet "
                                  "(ROADMAP A.9)")

    def prefetch_loader(self, *a, **kw):
        raise NotImplementedError("device prefetch is not ported yet "
                                  "(ROADMAP A.9)")

    def hybrid_engine(self, *a, **kw):
        raise NotImplementedError("the hybrid engine is not ported yet "
                                  "(ROADMAP A.11)")

    def profile_comms(self, *a, **kw):
        raise NotImplementedError("comms profiling is not ported yet "
                                  "(ROADMAP A.10)")


def _to_numpy(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)
