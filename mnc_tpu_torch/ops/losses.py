"""Loss functions with reference (Caffe) semantics — port of
``mnc_tpu/ops/losses.py``.

- ``smooth_l1_loss``: Huber loss with per-coordinate *inside* weights
  (multiply the diff; encode fg-only regression) and *outside* weights
  (multiply the loss; encode 1/N normalization).
- ``softmax_cross_entropy``: SoftmaxWithLoss with ``ignore_label`` semantics
  (ignored entries contribute neither loss nor normalization).
- ``sigmoid_cross_entropy``: SigmoidCrossEntropyLoss (mask loss, fg RoIs only
  via a per-RoI weight).
"""

from __future__ import annotations

import torch


def smooth_l1_loss(pred: torch.Tensor, targets: torch.Tensor,
                   inside_weights: torch.Tensor | None = None,
                   outside_weights: torch.Tensor | None = None,
                   sigma: float = 1.0) -> torch.Tensor:
    """Sum over all elements of outside_w * huber(inside_w * (pred - targets)).

    huber(x) = 0.5 * (sigma*x)^2 if |x| < 1/sigma^2 else |x| - 0.5/sigma^2.
    Normalization is the caller's business, through ``outside_weights``.
    """
    diff = pred - targets
    if inside_weights is not None:
        diff = diff * inside_weights
    sigma2 = sigma * sigma
    abs_diff = diff.abs()
    loss = torch.where(abs_diff < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       abs_diff - 0.5 / sigma2)
    if outside_weights is not None:
        loss = loss * outside_weights
    return loss.sum()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_label: int = -1, normalize: bool = True) -> torch.Tensor:
    """Softmax CE over the last axis; entries whose label equals
    ``ignore_label`` contribute neither loss nor count.  ``normalize``
    divides by the number of counted entries (at least 1)."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    if normalize:
        count = torch.maximum(valid.to(logits.dtype).sum(), logits.new_ones(()))
        return total / count
    return total


def sigmoid_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          weights: torch.Tensor | None = None,
                          normalize_by_weights: bool = True) -> torch.Tensor:
    """Elementwise sigmoid CE, max(x, 0) - x*t + log(1 + exp(-|x|));
    ``weights`` broadcasts (a per-RoI fg mask).  With
    ``normalize_by_weights`` the result is sum(loss * w) / max(sum(w), 1)."""
    x, t = logits, targets
    loss = torch.maximum(x, x.new_zeros(())) - x * t + torch.log1p(torch.exp(-x.abs()))
    if weights is not None:
        w = weights.to(logits.dtype).expand_as(logits)
        loss = loss * w
        if normalize_by_weights:
            return loss.sum() / torch.maximum(w.sum(), logits.new_ones(()))
        return loss.sum()
    return loss.mean()
