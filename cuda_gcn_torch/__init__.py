"""cuda_gcn_torch: the PyTorch/CUDA port of cuda_gcn_tpu for one NVIDIA H100.

Plain tensor code is PyTorch; the adjacency passes run on hand-written CUDA
kernels (cuda_gcn_torch/csrc, built at first use by cuda_gcn_torch.kernels).
The package imports neither jax nor cuda_gcn_tpu.
"""

from cuda_gcn_torch.config import GCNConfig, default_config

__all__ = ["GCNConfig", "default_config"]
