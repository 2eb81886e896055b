"""The benchmark of ``cuda_gcn_torch`` on one H100: ``python3 -m benchmark.run``.

Nothing here imports ``cuda_gcn_torch`` at module level; ``reference.py``,
``roofline.py``, ``synth.py`` and ``trace.py`` import none of it at all.
"""
