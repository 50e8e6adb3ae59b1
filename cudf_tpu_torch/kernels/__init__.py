"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter (see the modules' docstrings)."""

from cudf_tpu_torch.kernels.hash_aggregate import onehot_groupby_aggregate

__all__ = ["onehot_groupby_aggregate"]
