"""CUDA graphs of the training epoch: the card's counterpart of the JAX
package's device programs that span epochs (``lax.scan`` in
cuda_gcn_tpu/train.py ``run_epochs``, ``lax.while_loop`` in ``run_epochs_es``).

``EpochGraph`` runs a callable that does one epoch on the card. The first
epoch runs eagerly; before the second, the callable is captured once into a
``torch.cuda.CUDAGraph``, and every later epoch is one replay of it: the
epoch's launches leave the host as one graph launch. Its rules:

* warm-up: the eager epoch is the run's epoch 1, not an extra step (that would
  move Adam's step, the weights and the dropout generator). It loads the kernel
  libraries, sets kernel 1's shared-memory attribute and makes the lazy
  allocations, so that none of this host work falls in the capture window;
* dropout: every generator the epoch draws from is registered with the graph
  (``register_generator_state``), so that a replay draws the Philox offsets the
  eager epoch would draw, and advances the generator as far;
* memory: the graph's private pool keeps the address of every tensor the epoch
  allocates, and the epoch reads its persistent inputs (features, graph,
  weights, Adam's moments and step) at their addresses. Kernel 1 encodes its
  TMA descriptors on the host at each launch, so the captured ones hold
  capture-time addresses: none of those tensors may be freed or reallocated
  while the graph lives;
* launch counts: a kernel's wrapper counts its launch when it is called, which
  under capture runs nothing. The capture's counts are taken back and added
  again at every replay, so that ``kernels.launches`` (and any other counter
  dict passed in) holds what the card ran;
* no fallback: a capture or a replay that fails raises;
* spans (utils/profiling.py ``span``): the eager epoch is ``graphs.eager`` and
  the capture, after the wait for the work before it, ``graphs.capture``, in
  the trace of a profiler that records meanwhile; a replay is the trace's
  ``cudaGraphLaunch`` and has none of its own.

A CUDA graph does not outlive its process, so nothing of it is primed
(train.prime_cache).
"""

from __future__ import annotations

import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.utils.profiling import span


class EpochGraph:
    """One epoch, run eagerly first and then by replays of its capture.

    ``step`` runs one epoch on the current stream and keeps every result in
    persistent tensors; ``generators`` are the CUDA generators it draws from;
    ``counters`` are dicts of counts that ``step`` advances per epoch
    (default: ``kernels.launches``)."""

    def __init__(self, step, generators=(), counters=None):
        self.step = step
        self.generators = tuple(generators)
        self.counters = (kernels.launches,) if counters is None else tuple(counters)
        self.graph = None
        self.deltas: list[dict] = []
        self.epochs = 0

    def run(self) -> None:
        """One epoch: the first eagerly, the later ones by replay (captured
        before the first of them)."""
        if self.epochs:
            if self.graph is None:
                self.capture()
            self.replay()
        else:
            with span("graphs.eager"):
                self.step()
        self.epochs += 1

    def capture(self) -> None:
        """Capture ``step`` on a side stream, after the device has finished
        the work before it (as ``torch.cuda.graph`` does, but without its
        ``empty_cache``, which costs the capture the release of every cached
        block: the graph's pool takes its memory beside the eager cache)."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = [dict(c) for c in self.counters]
        torch.cuda.synchronize()
        with span("graphs.capture"):
            try:
                with torch.cuda.stream(torch.cuda.Stream()):
                    graph.capture_begin()
                    try:
                        self.step()
                    finally:
                        graph.capture_end()
            finally:
                after = [dict(c) for c in self.counters]
                for c, b in zip(self.counters, before):
                    c.update(b)  # the capture ran nothing
            self.deltas = [{k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
                           for a, b in zip(after, before)]
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        for c, delta in zip(self.counters, self.deltas):
            for k, v in delta.items():
                c[k] += v
