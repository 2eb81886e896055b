"""Probe kernels: single primitives measured alone on the card."""
