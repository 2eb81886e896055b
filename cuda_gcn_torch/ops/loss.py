"""Masked softmax cross-entropy, strict accuracy and the L2 penalty
(cuda_gcn_tpu/ops/loss.py:25-48, reference src/seq/module.cpp:126-161 and
src/seq/gcn.cpp:83-105)."""

from __future__ import annotations

import torch


def masked_cross_entropy(logits: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Mean CE over nodes with truth >= 0. logits [N, C], truth [N] (-1 masked)."""
    mask = truth >= 0
    count = mask.sum()
    safe_truth = torch.where(mask, truth, torch.zeros_like(truth)).long()
    logits32 = logits.float()
    shifted = logits32 - logits32.max(dim=1, keepdim=True).values.detach()
    log_z = torch.log(torch.exp(shifted).sum(dim=1))
    per_node = log_z - shifted.gather(1, safe_truth[:, None])[:, 0]
    return torch.where(mask, per_node, torch.zeros_like(per_node)).sum() / count


def strict_accuracy(logits: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Fraction of masked nodes where no logit strictly exceeds the truth
    logit (ties count as correct)."""
    mask = truth >= 0
    safe_truth = torch.where(mask, truth, torch.zeros_like(truth)).long()
    truth_logit = logits.gather(1, safe_truth[:, None])[:, 0]
    correct = logits.max(dim=1).values <= truth_logit
    return (mask & correct).float().sum() / mask.sum()


def l2_penalty(w1: torch.Tensor, weight_decay: float) -> torch.Tensor:
    """weight_decay/2 * ||W1||²: reported-loss term and, through the gradient,
    the decay term (the reference decays layer-1 weights only)."""
    return 0.5 * weight_decay * torch.sum(torch.square(w1.float()))
