"""A run with the timed path broken underneath reads ``correct`` false, once
for each fault a training cell on one chip can have: a step that leaves its
state unchanged, half of the batch left out (the mean over the rest), an
answer altered where it is produced (the cross-entropy 1% high); and for
the dropout and the first layer: dropout skipped, kept values not scaled by
1/(1-p), one mask replayed every step, the first layer's gradient 0.9 of
itself. The runs skip the harness's look for a card and drive the rest of a
run on the CPU, at a tiny size, against the limits of each cell's file."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.conftest import run_tiny

CELLS = ["reddit-dense-100ep", "pubmed-200ep", "reddit-sparse-100ep"]


FAULTS = ["state_unchanged", "half_batch", "answer_altered", "dropout_skipped",
          "dropout_unscaled", "mask_replayed", "grad0_scaled"]


def _dropout(scaled=True, replayed=False):
    """Dropout broken: kept values left unscaled, or one mask every call."""
    def dropout(x, rate, generator, training):
        if not training or rate <= 0.0:
            return x
        if replayed:
            generator = torch.Generator(device=x.device).manual_seed(0)
        keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
        return torch.where(keep, x / (1.0 - rate) if scaled else x, torch.zeros(()))
    return dropout


def _break(monkeypatch, fault):
    from cuda_gcn_torch import train
    from cuda_gcn_torch.models import gcn
    from cuda_gcn_torch.ops import adam, loss

    if fault == "dropout_skipped":
        monkeypatch.setattr(gcn, "dropout", lambda x, rate, generator, training: x)
    elif fault == "dropout_unscaled":
        monkeypatch.setattr(gcn, "dropout", _dropout(scaled=False))
    elif fault == "mask_replayed":
        monkeypatch.setattr(gcn, "dropout", _dropout(replayed=True))
    elif fault == "grad0_scaled":
        step = adam.step

        def scaled(params, grads, state, hp):
            return step(params, dict(grads, w1=grads["w1"] * 0.9), state, hp)
        monkeypatch.setattr(adam, "step", scaled)

    elif fault == "state_unchanged":
        def unchanged(params, grads, state, hp):
            state.step += 1  # counted, but the weights and moments stay
        monkeypatch.setattr(adam, "step", unchanged)
    elif fault == "half_batch":
        def half(logits, truth):
            ids = torch.nonzero(truth >= 0)[:, 0]
            kept = truth.clone()
            kept[ids[len(ids) // 2:]] = -1
            return loss.masked_cross_entropy(logits, kept)
        monkeypatch.setattr(train, "masked_cross_entropy", half)
        monkeypatch.setattr(gcn, "masked_cross_entropy", half)
    elif fault == "answer_altered":
        def high(logits, truth):
            return loss.masked_cross_entropy(logits, truth) * 1.01
        monkeypatch.setattr(train, "masked_cross_entropy", high)
        monkeypatch.setattr(gcn, "masked_cross_entropy", high)


def _cell_settings(cell):
    from benchmark import registry

    entry = registry.workload(cell)
    config = registry.config(entry["config"])
    traffic = registry.traffic(entry["traffic"])
    return dict(backend=config["graphsum_backend"], feature_matmul=traffic["feature_matmul"],
                early_stopping=min(traffic["early_stopping"], 3), cell=cell)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_bench, capsys, cell):
    tiny_bench(**_cell_settings(cell))
    rc, line, _ = run_tiny(capsys)
    assert rc == 0 and line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_not_correct(tiny_bench, capsys, monkeypatch, cell, fault):
    tiny_bench(**_cell_settings(cell))
    _break(monkeypatch, fault)
    rc, line, _ = run_tiny(capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]
