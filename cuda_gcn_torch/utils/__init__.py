"""Utilities of the port (cuda_gcn_tpu/utils): phase timers, history dumps,
checkpoints and per-op profiling."""

from cuda_gcn_torch.utils.timer import PhaseTimer, timers

__all__ = ["PhaseTimer", "timers"]
