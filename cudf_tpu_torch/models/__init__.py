"""Flagship query "models" (port of ``cudf_tpu/models/__init__.py``).

- ``g1_groupby`` is the db-benchmark G1 groupby's forward step: per-group
  sums and counts over int32 codes, dispatched by cardinality between the
  one-hot tier (kernel A) and the radix-partition tier (kernels B, F,
  G and D).
- ``j1_join`` is the db-benchmark J1 inner join's forward step against a
  unique-key dim table: gather maps from the window probe (kernel H) over
  tables built by kernel D, with the sorted partition route (kernels
  B, F and G; two passes above 2^20 keys) on both sides when the key
  domain spans more than one window.

``models/tpch.py`` holds the TPC-H tables and queries on the LazyFrame
engine and in pandas' form; ``models/g1.py`` the ten db-benchmark G1
groupby questions in the form of its pandas solution;
``models/frame_api.py`` the reshape, UDF, join-form and missing-data
requests the card runs, and ``models/strings_dt.py`` the string and
temporal ones, each beside its plain PyTorch version.
"""

from __future__ import annotations

from typing import Tuple

import torch


def g1_groupby(keys: torch.Tensor, vals: torch.Tensor, num_groups: int,
               low_card_threshold: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums[K], counts[K] int64) for int32 keys in [0, num_groups).
    Integer values give int64 sums, floats float64."""
    if num_groups <= low_card_threshold:
        from cudf_tpu_torch.kernels.hash_aggregate import onehot_groupby_aggregate

        s, c, _, _ = onehot_groupby_aggregate(keys, vals, num_groups,
                                              with_minmax=False)
        return s, c
    from cudf_tpu_torch.kernels.radix_partition import radix_groupby_sum_count

    return radix_groupby_sum_count(keys, vals, num_groups)


def j1_join(probe_keys: torch.Tensor, probe_row_ids: torch.Tensor,
            build_keys: torch.Tensor, key_domain: int) -> Tuple:
    """(probe_keys, probe_row_ids, build_row_ids, unique) in partitioned
    row order, for int32 key codes in [0, key_domain): build_row_ids is
    -1 where a probe row has no match (see
    ``kernels/radix_partition.py`` ``radix_join_inner_unique``)."""
    from cudf_tpu_torch.kernels.radix_partition import radix_join_inner_unique

    return radix_join_inner_unique(probe_keys, probe_row_ids, build_keys, key_domain)


__all__ = ["g1_groupby", "j1_join"]
