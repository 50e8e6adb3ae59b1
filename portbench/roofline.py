"""The device's peaks and the least time a number of bytes needs.

NVIDIA's data sheet for the H100 SXM (80 GB HBM3): 3.35 TB/s of memory
bandwidth at the full 700 W power limit.  A run records the card's name;
PERF.md records its power limit beside every number.
"""

HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
