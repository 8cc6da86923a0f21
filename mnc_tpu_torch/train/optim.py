"""Solver: SGD + momentum + step LR + weight decay + gradient accumulation —
port of ``mnc_tpu/train/optim.py`` (an optax chain there).

≙ the reference Caffe solver: base lr 0.001, momentum 0.9, weight decay
0.0005, ``lr_policy: step`` (×gamma every ``stepsize`` updates),
``iter_size`` gradient accumulation.  The Caffe layer rules are kept: weight
decay applies to kernels only and biases get twice the learning rate.

Order of one update, as in the optax chain: (1) scale all gradients when
their global norm exceeds ``clip_gradients``; (2) add ``weight_decay``·w to
the kernels' gradients; (3) double the biases' gradients; (4) momentum trace
t ← g + momentum·t; (5) w ← w − lr(count)·t, with lr = base_lr ·
gamma^⌊count / stepsize⌋ and ``count`` the number of updates applied so far.
A parameter with no gradient (a frozen trunk block) counts as a zero
gradient, so its kernel still decays — the JAX package freezes by
``stop_gradient``, unlike Caffe's ``lr_mult: 0``.  With ``iter_size`` > 1
the running mean of the micro-steps' gradients is kept and an update is
applied on every ``iter_size``-th call (``optax.MultiSteps``).  Parameters
are updated in place.
"""

from __future__ import annotations

import torch


def step_lr(base_lr: float, gamma: float, stepsize: int):
    """Caffe ``step`` policy: lr(count) = base * gamma^(count // stepsize)."""

    def schedule(count: int) -> float:
        return base_lr * gamma ** (count // stepsize)

    return schedule


class CaffeSGD:
    """``CaffeSGD(model.named_parameters(), ...)``; call :meth:`step` after
    ``backward`` (it reads ``p.grad`` and clears it)."""

    def __init__(self, named_params, base_lr: float = 0.001, momentum: float = 0.9,
                 weight_decay: float = 0.0005, gamma: float = 0.1, stepsize: int = 20000,
                 iter_size: int = 1, caffe_bias_rules: bool = True,
                 clip_gradients: float = -1.0):
        self.names, self.params = map(list, zip(*named_params))
        self.is_bias = [n.endswith("bias") for n in self.names]
        self.schedule = step_lr(base_lr, gamma, stepsize)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.iter_size = int(iter_size)
        self.caffe_bias_rules = caffe_bias_rules
        self.clip_gradients = clip_gradients
        self.count = 0  # updates applied
        self.mini_step = 0  # micro-steps since the last update
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.iter_size > 1 else None)

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grad_sq_norm=None) -> bool:
        """Consume the parameters' gradients; returns True when an update
        was applied (always, unless ``iter_size`` > 1).  ``grad_sq_norm``
        maps the gradients (in ``self.params`` order) to the squared global
        norm that clipping uses (default: their sum of squares; a
        tensor-parallel step sums its shards over the model axis)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        if self.iter_size > 1:
            # running mean of the micro-steps' gradients
            for a, g in zip(self.acc, grads):
                a.add_(g - a, alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.iter_size:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        if self.clip_gradients and self.clip_gradients > 0:
            norm = torch.sqrt(grad_sq_norm(grads) if grad_sq_norm is not None
                              else sum((g.float() ** 2).sum() for g in grads))
            # unchanged below the limit, else scaled onto it
            factor = torch.where(norm < self.clip_gradients, torch.ones_like(norm),
                                 self.clip_gradients / norm)
            grads = [g * factor for g in grads]
        lr = self.lr
        for p, g, t, bias in zip(self.params, grads, self.trace, self.is_bias):
            if self.weight_decay and not (bias and self.caffe_bias_rules):
                g = g.add(p, alpha=self.weight_decay)
            if bias and self.caffe_bias_rules:
                g = g * 2.0
            t.mul_(self.momentum).add_(g)
            p.add_(t, alpha=-lr)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "trace": dict(zip(self.names, self.trace)),
                "acc": dict(zip(self.names, self.acc)) if self.acc else None}

    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for n, t in zip(self.names, self.trace):
            t.copy_(state["trace"][n])
        if self.acc and state.get("acc"):
            for n, a in zip(self.names, self.acc):
                a.copy_(state["acc"][n])


def make_optimizer(model: torch.nn.Module, **kw) -> CaffeSGD:
    """The solver over every parameter of ``model`` (see :class:`CaffeSGD`)."""
    return CaffeSGD(model.named_parameters(), **kw)
