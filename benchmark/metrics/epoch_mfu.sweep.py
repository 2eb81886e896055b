"""``epoch_mfu`` of a cell of short jobs, which moves ``sweep_epoch_ms``: the same reader."""

from benchmark.registry import metric_reader

read = metric_reader("epoch_mfu")
