"""Optimizers as functional updates on tensors, with optax's semantics.

The JAX package builds its optimizer from optax (``train/step.py:74-91``):
``MultiSteps(chain(clip_by_global_norm, adam | adamw | lion))``.  This module
writes the same transformations out over dicts of tensors (name → tensor),
so that the port computes the same updates in the same order:

  * ``clip_by_global_norm(m)``: g · m/‖g‖ when ‖g‖ ≥ m — no +1e-6, unlike
    ``torch.nn.utils.clip_grad_norm_``;
  * ``adam`` is ``optax.adam(lr)``: β = (0.9, 0.999), ε = 1e-8 outside the
    square root, bias-corrected moments; it ignores ``beta1``, ``beta2`` and
    ``weight_decay`` of the config, as the JAX package does;
  * ``adamw`` is ``optax.adamw(lr, beta1, beta2, weight_decay=…)``;
  * ``lion`` is ``optax.lion(lr, weight_decay=…)`` with β = (0.9, 0.99):
    sign((1−β1)·g + β1·m), then m ← (1−β2)·g + β2·m (torch has no Lion);
  * the learning rate is a constant or the warmup+cosine schedule evaluated
    in float32 at the optimizer's own update count;
  * ``MultiSteps(k)`` averages k gradients (Welford mean) and applies the
    inner optimizer on every k-th call, returning zero updates in between.

A transformation has ``init(params) → state`` and ``update(grads, state,
params) → (updates, state)``; states are nested dicts of tensors, so they
can be gated with ``tree_where`` and saved with ``torch.save``.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

from statecatcher_tpu_torch.config import OptimConfig


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_where(ok: torch.Tensor, new, old):
    """Leaf-wise ``torch.where(ok, new, old)``."""
    return tree_map(lambda n, o: torch.where(ok, n, o), new, old)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf (``optax.global_norm``)."""
    leaves = []
    tree_map(lambda x: leaves.append(x.square().sum()), tree)
    return torch.sqrt(torch.stack(leaves).sum())


def _count(params: dict) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _bias_correction(moment: torch.Tensor, decay: float, count: torch.Tensor) -> torch.Tensor:
    corr = 1 - torch.pow(torch.tensor(decay, dtype=moment.dtype, device=moment.device), count)
    return moment / corr


class ClipByGlobalNorm:
    """``norm`` computes the global norm of a gradient dict (``global_norm``;
    under tensor parallelism the norm over every rank's shard)."""

    def __init__(self, max_norm: float, norm: Callable = global_norm):
        self.max_norm = max_norm
        self.norm = norm

    def init(self, params):
        return {}

    def update(self, grads, state, params=None):
        g_norm = self.norm(grads)
        trigger = g_norm < self.max_norm
        return tree_map(lambda t: torch.where(trigger, t, (t / g_norm.to(t.dtype)) * self.max_norm),
                        grads), state


class ScaleByAdam:
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": _count(params), "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params=None):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g.square() + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        upd = tree_map(lambda m, v: _bias_correction(m, b1, count)
                       / (torch.sqrt(_bias_correction(v, b2, count)) + self.eps), mu, nu)
        return upd, {"count": count, "mu": mu, "nu": nu}


class ScaleByLion:
    def __init__(self, b1: float = 0.9, b2: float = 0.99):
        self.b1, self.b2 = b1, b2

    def init(self, params):
        return {"count": _count(params), "mu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params=None):
        b1, b2 = self.b1, self.b2
        upd = tree_map(lambda g, m: torch.sign((1.0 - b1) * g + b1 * m), grads, state["mu"])
        mu = tree_map(lambda g, m: (1 - b2) * g + b2 * m, grads, state["mu"])
        return upd, {"count": state["count"] + 1, "mu": mu}


class AddDecayedWeights:
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def init(self, params):
        return {}

    def update(self, grads, state, params=None):
        return tree_map(lambda g, p: g + self.weight_decay * p, grads, params), state


class ScaleByLearningRate:
    """−lr · updates; a schedule is evaluated at this transformation's own
    count (0 on the first update), in float32, then cast to each leaf."""

    def __init__(self, lr: Union[float, Callable]):
        self.lr = lr

    def init(self, params):
        return {"count": _count(params)} if callable(self.lr) else {}

    def update(self, grads, state, params=None):
        if not callable(self.lr):
            return tree_map(lambda g: g * (-self.lr), grads), state
        step_size = -1 * self.lr(state["count"])
        return (tree_map(lambda g: step_size.to(g.dtype) * g, grads),
                {"count": state["count"] + 1})


class Chain:
    def __init__(self, *transforms):
        self.transforms = transforms

    def init(self, params):
        return {str(i): t.init(params) for i, t in enumerate(self.transforms)}

    def update(self, grads, state, params=None):
        new = {}
        for i, t in enumerate(self.transforms):
            grads, new[str(i)] = t.update(grads, state[str(i)], params)
        return grads, new


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` with the gradient mean."""

    def __init__(self, inner, k: int):
        self.inner, self.k = inner, k

    def init(self, params):
        return {"mini_step": _count(params), "gradient_step": _count(params),
                "inner": self.inner.init(params), "acc": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params=None):
        mini = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / (mini + 1).to(g.dtype), grads, state["acc"])
        final, inner_new = self.inner.update(acc, state["inner"], params)
        emit = mini == self.k - 1
        new_state = {
            "mini_step": (mini + 1) % self.k,
            "gradient_step": state["gradient_step"] + emit.to(torch.int32),
            "inner": tree_where(emit, inner_new, state["inner"]),
            "acc": tree_map(lambda a: (~emit).to(a.dtype) * a, acc),
        }
        return tree_map(lambda u: emit.to(u.dtype) * u, final), new_state


def lr_schedule(optim: OptimConfig):
    """Warmup + cosine (the JAX package's ``lr_schedule``), or the constant
    learning rate when the scheduler is off."""
    if not optim.use_scheduler:
        return optim.lr

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.tensor(float(optim.warmup_steps), dtype=torch.float32, device=s.device)
        total = torch.tensor(float(optim.total_steps), dtype=torch.float32, device=s.device)
        warm_factor = s / torch.clamp(warm, min=1.0)
        progress = (s - warm) / torch.clamp(total - warm, min=1.0)
        cos_factor = 0.5 * (1.0 + torch.cos(math.pi * progress))
        return optim.lr * torch.where(s < warm, warm_factor, cos_factor)

    return fn


def build_optimizer(optim: OptimConfig, norm: Callable = global_norm):
    """adam | adamw | lion with the global-norm clip (of ``norm``) and
    optional accumulation, as ``statecatcher_tpu/train/step.py:build_optimizer``."""
    lr = lr_schedule(optim)
    if optim.optimizer == "adamw":
        tx = Chain(ScaleByAdam(optim.beta1, optim.beta2),
                   AddDecayedWeights(optim.weight_decay), ScaleByLearningRate(lr))
    elif optim.optimizer == "lion":
        tx = Chain(ScaleByLion(), AddDecayedWeights(optim.weight_decay),
                   ScaleByLearningRate(lr))
    elif optim.optimizer == "adam":
        tx = Chain(ScaleByAdam(), ScaleByLearningRate(lr))
    else:
        raise ValueError(f"Unknown optimizer {optim.optimizer!r}")
    tx = Chain(ClipByGlobalNorm(optim.max_grad_norm, norm), tx)
    if optim.accumulation_steps > 1:
        tx = MultiSteps(tx, optim.accumulation_steps)
    return tx
