"""What the GCN, the GAT and the sharded trainer share, on the CPU: the graph
backend a model runs on (models/gcn.py ``GraphModel.graph_backend``), the
layer loop's pair against its single forward, and the masked sums that the
CE and the accuracy divide (ops/loss.py)."""

import numpy as np
import pytest
import torch
from test_torch_gat import gat_config, skewed_dataset

from cuda_gcn_torch import train
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data.graph import DENSE_BACKEND_MAX_NODES
from cuda_gcn_torch.ops import loss

BACKENDS = ("segment", "ell", "pallas", "dense", "bsr")


def _written_rule(model: str, backend: str, n: int) -> str:
    """The rule as train.prepare, cli.main and prepare_sharded each wrote it
    before the model classes declared it."""
    if backend == "auto":
        return "ell" if model == "gat" else \
            "dense" if n <= DENSE_BACKEND_MAX_NODES else "bsr"
    if model == "gat" and backend not in ("ell", "pallas"):
        raise ValueError(f"model 'gat' attends over the ELL plan: graphsum_backend 'ell' "
                         f"or 'pallas', got {backend!r}")
    return backend


@pytest.mark.parametrize("backend", ("auto",) + BACKENDS)
@pytest.mark.parametrize("n", [1, DENSE_BACKEND_MAX_NODES, DENSE_BACKEND_MAX_NODES + 1, 232965])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_graph_backend_is_the_written_rule(model, n, backend):
    """Every model × node count × backend: the backend of before, or the
    GAT's refusal word for word; a part's interior takes tiles exactly where
    prepare_sharded gave them (bsr, or 'auto' above the dense bound)."""
    cls = train.model_class(GCNConfig(model=model))
    try:
        want = _written_rule(model, backend, n)
    except ValueError as refusal:
        with pytest.raises(ValueError) as got:
            cls.graph_backend(backend, n)
        assert str(got.value) == str(refusal)
        return
    assert cls.graph_backend(backend, n) == want
    if model == "gcn":
        tiles = backend == "bsr" or (backend == "auto" and n > DENSE_BACKEND_MAX_NODES)
        assert (cls.graph_backend(backend, n) == "bsr") == tiles


@pytest.mark.parametrize("setup", ["gcn-dense", "gcn-sparse", "gat"])
def test_pair_eval_half_is_the_eval_forward(setup):
    """At the same weights the evaluation half of ``apply_pair`` (dropout on
    the training half) is ``forward(training=False)``, within the pair's
    tolerance in test_torch_train.py; only the training half has a gradient."""
    if setup == "gat":
        cfg = gat_config(rate=0.6)
    else:
        cfg = GCNConfig(graphsum_backend="ell", dropout=0.5, reorder="none",
                        feature_matmul="sparse" if setup == "gcn-sparse" else "dense")
    cfg, graph, x, _ = train.prepare(cfg, skewed_dataset(), "cpu")
    model = train.create_state(cfg, "cpu").model
    lt, le = model.apply_pair(graph, x, dropout_rate=cfg.dropout,
                              generator=torch.Generator().manual_seed(1))
    assert lt.requires_grad and not le.requires_grad
    want = model(graph, x, training=False).detach()
    assert not torch.allclose(lt.detach(), want)  # the training half is dropped out
    np.testing.assert_allclose(le.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_sums_of_disjoint_halves_add_up(dtype):
    """The sums of two disjoint halves of a truth vector add up to the whole
    set's CE and accuracy times its count (ties count as correct)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(300, 7, generator=g).to(dtype)
    truth = torch.randint(-1, 7, (300,), generator=g)
    logits[:20] = logits[:20, :1]  # every logit tied with the truth logit
    half = torch.rand(300, generator=g) < 0.5
    parts = [loss.masked_sums(logits, torch.where(side, truth, -1)) for side in (half, ~half)]
    count = int((truth >= 0).sum())
    ce = float(parts[0][0] + parts[1][0])
    correct = float(parts[0][1] + parts[1][1])
    np.testing.assert_allclose(ce, float(loss.masked_cross_entropy(logits, truth)) * count,
                               rtol=1e-6)
    np.testing.assert_allclose(correct, float(loss.strict_accuracy(logits, truth)) * count,
                               rtol=1e-6)
    whole = loss.masked_sums(logits, truth)
    assert float(whole[1]) == correct >= int((truth[:20] >= 0).sum())
