"""The program under test, ``cuda_gcn_torch``, as every family reaches it:
its caches and its dataset type. It imports the program only inside its
functions; what drives a model lies in the model's family
(``benchmark/families/<family>.py``).
"""

from __future__ import annotations

import os


def use_cache_dirs(root: str) -> None:
    """Point every build and kernel cache of the program at fixed directories
    under ``root``: nvcc and g++ libraries in ``root``/{kernels,native}
    (``utils.compile_cache.use_build_dir``), Triton's cache in ``root``/triton."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "triton")
    from cuda_gcn_torch.utils.compile_cache import use_build_dir

    use_build_dir(root)


def dataset_of(data: dict):
    """The program's dataset of a configuration's generated arrays."""
    from cuda_gcn_torch.data.dataset import CSR, GCNDataset

    return GCNDataset(graph=CSR(data["indptr"], data["indices"]),
                      feature_index=CSR(data["f_indptr"], data["f_indices"]),
                      feature_value=data["f_values"], label=data["label"],
                      split=data["split"], num_nodes=int(data["num_nodes"]),
                      input_dim=int(data["input_dim"]), output_dim=int(data["output_dim"]))
