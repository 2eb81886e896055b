"""``device_idle_share`` of a cell of short jobs, which moves ``sweep_epoch_ms``: the same reader."""

from benchmark.registry import metric_reader

read = metric_reader("device_idle_share")
