"""The benchmark of ``cuda_gcn_torch`` on one H100: ``python3 -m benchmark.run``.

Nothing here imports ``cuda_gcn_torch`` at module level; ``reference.py``,
``compare.py``, ``roofline.py``, ``synth.py`` and ``trace.py`` import none of
it at all, nor does a family's reference (``families/<family>.py``
``reference_inputs``, ``follow``).
"""
