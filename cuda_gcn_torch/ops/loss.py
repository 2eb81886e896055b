"""Masked softmax cross-entropy, strict accuracy and the L2 penalty
(cuda_gcn_tpu/ops/loss.py:25-48, reference src/seq/module.cpp:126-161 and
src/seq/gcn.cpp:83-105). The CE and the accuracy are written once, as sums
over the nodes with truth >= 0, which the means divide by their count and
the sharded trainer all-reduces first (``masked_sums``)."""

from __future__ import annotations

import torch


def _safe(truth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """truth with the masked-out -1 as class 0, int64 (a gather index)."""
    return torch.where(mask, truth, torch.zeros_like(truth)).long()


def _ce_sum(logits, mask, safe_truth) -> torch.Tensor:
    logits32 = logits.float()
    shifted = logits32 - logits32.max(dim=1, keepdim=True).values.detach()
    log_z = torch.log(torch.exp(shifted).sum(dim=1))
    per_node = log_z - shifted.gather(1, safe_truth[:, None])[:, 0]
    return torch.where(mask, per_node, torch.zeros_like(per_node)).sum()


def _correct(logits, mask, safe_truth) -> torch.Tensor:
    """Masked nodes where no logit strictly exceeds the truth logit (ties
    count as correct), an f32 count."""
    truth_logit = logits.gather(1, safe_truth[:, None])[:, 0]
    return (mask & (logits.max(dim=1).values <= truth_logit)).float().sum()


def masked_sums(logits: torch.Tensor, truth: torch.Tensor):
    """(masked CE sum, correct count), f32 scalars, from one mask."""
    mask = truth >= 0
    safe_truth = _safe(truth, mask)
    return _ce_sum(logits, mask, safe_truth), _correct(logits, mask, safe_truth)


def masked_cross_entropy(logits: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Mean CE over nodes with truth >= 0. logits [N, C], truth [N] (-1 masked)."""
    mask = truth >= 0
    count = mask.sum()
    return _ce_sum(logits, mask, _safe(truth, mask)) / count


def strict_accuracy(logits: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Fraction of masked nodes where no logit strictly exceeds the truth logit."""
    mask = truth >= 0
    return _correct(logits, mask, _safe(truth, mask)) / mask.sum()


def l2_penalty(w1: torch.Tensor, weight_decay: float) -> torch.Tensor:
    """weight_decay/2 * ||W1||²: reported-loss term and, through the gradient,
    the decay term (the reference decays layer-1 weights only)."""
    return 0.5 * weight_decay * torch.sum(torch.square(w1.float()))
