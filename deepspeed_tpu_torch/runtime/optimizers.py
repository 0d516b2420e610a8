"""Optimizer factory (counterpart of deepspeed_tpu/runtime/optimizers.py and
of the master-weight wrapper of deepspeed_tpu/runtime/zero.py).

The reference builds optax transformations and leaves their elementwise
chains to XLA; the port writes the same update rules on lists of tensors
with ``torch._foreach_*`` (plain PyTorch is the port of what XLA fused).
The rules are optax's, not ``torch.optim``'s, so that a trajectory matches
the reference step for step:

- ``adamw``: bias-corrected moments, ``eps`` added to ``sqrt(nu_hat)``, the
  weight decay ``wd · p`` added to the update before the learning rate and
  applied to every leaf (no mask); ``p += -lr · u``.
- ``adam``: weight decay enters the gradient as L2 (``g + wd · p``).
- ``sgd``: optional momentum trace (``t = g + m · t``), optional nesterov.

An ``Optimizer`` owns its state (allocated by ``init``) and its update
count; ``update(grads, params, lr)`` returns the updates and may consume
``grads``.  ``clip_by_global_norm`` and ``MasterWeights`` are the other two
links of the engine's chain.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

# Names accepted in the "optimizer" config block → update rule
_CANON = {
    "adam": "adam",
    "adamw": "adamw",
    "fusedadam": "adamw",
    "lamb": "lamb",
    "fusedlamb": "lamb",
    "onebitadam": "adam",
    "onebitlamb": "lamb",
    "zerooneadam": "adam",
    "lion": "lion",
    "fusedlion": "lion",
    "adagrad": "adagrad",
    "sgd": "sgd",
    "muon": "muon",
}
_PORTED = ("adam", "adamw", "sgd")


def supported_optimizers():
    return sorted(set(_CANON))


def is_onebit(name: str) -> bool:
    """1-bit family: the reference engine chains error-feedback gradient
    compression for these names."""
    return name.lower().replace("_", "").startswith(("onebit", "zeroone"))


class Optimizer:
    """An update rule with its state.  ``init(params)`` allocates the state
    like ``params`` (fp32 masters when wrapped by ``MasterWeights``);
    ``update(grads, params, lr)`` returns the list of updates (``p += u``)
    and advances the count.  ``grads`` may be modified in place."""

    def __init__(self, **hyper):
        self.hyper = hyper
        self.count = 0

    def init(self, params: List[torch.Tensor]) -> None:
        raise NotImplementedError

    def update(self, grads, params, lr: float) -> List[torch.Tensor]:
        raise NotImplementedError


class Adam(Optimizer):
    """optax.adam (``decoupled=False``: weight decay as L2 into the
    gradient) and optax.adamw (``decoupled=True``)."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 decoupled=True):
        super().__init__(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                         decoupled=decoupled)

    def init(self, params):
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def update(self, grads, params, lr):
        h = self.hyper
        b1, b2, wd = h["b1"], h["b2"], h["weight_decay"]
        if wd and not h["decoupled"]:
            torch._foreach_add_(grads, params, alpha=wd)
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, h["eps"])
        u = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        torch._foreach_div_(u, denom)
        if wd and h["decoupled"]:
            torch._foreach_add_(u, params, alpha=wd)
        torch._foreach_mul_(u, -lr)
        return u


class SGD(Optimizer):
    """optax.sgd, with weight decay as L2 into the gradient."""

    def __init__(self, momentum=0.0, nesterov=False, weight_decay=0.0):
        super().__init__(momentum=momentum, nesterov=nesterov,
                         weight_decay=weight_decay)

    def init(self, params):
        self.trace = ([torch.zeros_like(p) for p in params]
                      if self.hyper["momentum"] else None)

    def update(self, grads, params, lr):
        h = self.hyper
        if h["weight_decay"]:
            torch._foreach_add_(grads, params, alpha=h["weight_decay"])
        self.count += 1
        if self.trace is None:
            u = grads
        else:
            torch._foreach_mul_(self.trace, h["momentum"])
            torch._foreach_add_(self.trace, grads)
            if h["nesterov"]:
                u = torch._foreach_add(grads, self.trace,
                                       alpha=h["momentum"])
            else:
                u = [t.clone() for t in self.trace]
        torch._foreach_mul_(u, -lr)
        return u


def build_optimizer(name: str, params: Optional[Dict[str, Any]] = None,
                    ) -> Tuple[Optimizer, Dict[str, Any]]:
    """Build an optimizer from a DeepSpeed-style "optimizer" block.
    Returns (optimizer, resolved_params); ``resolved_params["lr"]`` is the
    constant learning rate the engine uses when there is no schedule."""
    params = dict(params or {})
    key = name.lower().replace("_", "")
    canon = _CANON.get(key)
    if canon is None:
        raise ValueError(
            f"unknown optimizer {name!r}; supported: {supported_optimizers()}")
    if is_onebit(name):
        raise NotImplementedError(
            f"optimizer {name!r}: the 1-bit family runs error-feedback "
            f"gradient compression, which is not ported yet (ROADMAP A.11); "
            f"it must not quietly become plain Adam")
    if canon not in _PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} ({canon}) is not ported yet (ROADMAP A.11); "
            f"ported: {list(_PORTED)} and the fusedadam alias")

    lr = params.pop("lr", 1e-3)
    weight_decay = params.pop("weight_decay", 0.0)
    betas = tuple(params.pop("betas", (0.9, 0.999)))
    eps = params.pop("eps", 1e-8)
    if canon in ("adam", "adamw"):
        opt = Adam(b1=betas[0], b2=betas[1], eps=eps,
                   weight_decay=weight_decay, decoupled=canon == "adamw")
    else:
        opt = SGD(momentum=params.pop("momentum", 0.0) or 0.0,
                  nesterov=params.pop("nesterov", False),
                  weight_decay=weight_decay)
    resolved = dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps,
                    **params)
    return opt, resolved


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, fp32, on their device."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)).float())


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """optax.clip_by_global_norm in place: unchanged while the norm is
    below ``max_norm``, else ``g / norm · max_norm``.  No host sync: the
    factor stays on the device."""
    if norm is None:
        norm = global_norm(grads)
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(norm < max_norm, one, norm))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, one,
                                           torch.full_like(norm, max_norm)))


class MasterWeights:
    """fp32 master copy of low-precision parameters (the reference's
    ``with_master_weights``).  The master starts as the upcast of the
    (already cast) parameter; each step runs the inner rule on the master
    with fp32 gradients, then moves the parameter by
    ``delta = cast(new_master) − p`` computed in the parameter's dtype —
    the reference's arithmetic, which is not always ``cast(new_master)``."""

    def __init__(self, inner: Optimizer):
        self.inner = inner

    @property
    def count(self):
        return self.inner.count

    def init(self, params):
        self.master = [p.detach().float().clone() for p in params]
        self.inner.init(self.master)

    def update(self, grads, params, lr):
        updates = self.inner.update(grads, self.master, lr)
        torch._foreach_add_(self.master, updates)
        deltas = [m.to(p.dtype) for m, p in zip(self.master, params)]
        torch._foreach_sub_(deltas, params)
        return deltas
