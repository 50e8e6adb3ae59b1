"""The benchmark of cudf_tpu_torch on an NVIDIA GPU (see README.md).

Importing this package imports nothing of the port and touches no CUDA.
"""
