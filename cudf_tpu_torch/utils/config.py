"""Typed option registry (port of ``cudf_tpu/utils/config.py``).

Only the options the ported slice reads are registered.  Every option is
env-overridable as ``CUDF_TPU_TORCH__<UPPER_NAME>`` (dots become ``__``).
The reference's ``*.kernel_interpret`` options have no counterpart: the
port's kernel wrappers take their plain PyTorch version for CPU tensors,
with no switch.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass
class _Option:
    name: str
    default: Any
    description: str
    validator: Callable[[Any], bool]
    value: Any = None


_registry: Dict[str, _Option] = {}


def _register(name: str, default: Any, description: str,
              validator: Callable[[Any], bool] = lambda v: True) -> None:
    env = os.environ.get("CUDF_TPU_TORCH__" + name.upper().replace(".", "__"))
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _registry[name] = _Option(name, default, description, validator, value)


def get_option(name: str) -> Any:
    return _registry[name].value


def set_option(name: str, value: Any) -> None:
    opt = _registry[name]
    if not opt.validator(value):
        raise ValueError(f"invalid value {value!r} for option {name!r}")
    opt.value = value


@contextlib.contextmanager
def option_context(*args):
    if len(args) % 2:
        raise ValueError("option_context takes name/value pairs")
    pairs = list(zip(args[::2], args[1::2]))
    saved = [(n, get_option(n)) for n, _ in pairs]
    try:
        for n, v in pairs:
            set_option(n, v)
        yield
    finally:
        for n, v in saved:
            set_option(n, v)


_register("groupby.onehot_fast_path", True,
          "dispatch groupby aggs to the kernel tiers (one-hot K <= 4096, "
          "radix partition K <= 2^27); off, every groupby takes the sort "
          "tier (make_grouper)",
          lambda v: isinstance(v, bool))
_register("groupby.fast_path_min_rows", 0,
          "minimum rows before groupby dispatches to the kernel tiers; "
          "smaller frames take the sort tier (the default 0 serves every "
          "row count with the kernel tiers)",
          lambda v: isinstance(v, int) and v >= 0)
_register("join.radix_fast_path", True,
          "radix-partition + window-probe tier (kernels B, F, G, D and H) for "
          "single-int-key inner joins with a unique or bounded-fan-out "
          "build side (exact, left-row order)",
          lambda v: isinstance(v, bool))
_register("join.fast_path_min_rows", 1 << 16,
          "minimum probe rows before joins dispatch to the radix tier",
          lambda v: isinstance(v, int) and v >= 0)
_register("join.multi_fan_out_max", 4,
          "max build-side rows per key served by the stacked-table radix "
          "tier (0 disables; larger fan-out needs the sort-merge tier, "
          "which is not ported yet)",
          lambda v: isinstance(v, int) and 0 <= v <= 4)
_register("join.dense_fast_path", True,
          "direct-address inner join when the single-int build side is "
          "unique over a dense domain (exact, left-row order)",
          lambda v: isinstance(v, bool))
_register("spill", False,
          "let the partitioned executor spill cold partitions' device buffers to "
          "pinned host memory (utils/spill.py), coldest first, to the device budget",
          lambda v: isinstance(v, bool))
_register("spill.device_limit_fraction", 0.85,
          "the device budget as a fraction of the card's memory",
          lambda v: isinstance(v, (int, float)) and 0 < v <= 1)
_register("spill.device_limit_bytes", 0,
          "absolute device budget for the executor's spilling (0: use the fraction; "
          "on the CPU, 0 is unbounded)",
          lambda v: isinstance(v, int) and v >= 0)
_register("executor.target_partition_size", 1 << 28,
          "bytes of source data a partition of collect(streaming=True) or "
          "collect(mesh='auto') holds",
          lambda v: isinstance(v, int) and v > 0)
_register("executor.broadcast_limit", 1 << 25,
          "max bytes of a join's right side that the partitioned executor "
          "broadcasts to every left partition; larger sides are shuffled",
          lambda v: isinstance(v, int) and v >= 0)
_register("executor.fallback_mode", "warn",
          "what a plan that falls back to the partition-list executor does: "
          "'warn' (a PerformanceWarning), 'raise' or 'silent'; counted by "
          "engine.get_fallback_stats",
          lambda v: v in ("warn", "raise", "silent"))


_register("executor.spmd_lowering", True,
          "run a plan over a parallel.Mesh rank by rank with collectives (engine/spmd.py); "
          "off, every rank runs the one-process partitioned executor over the mesh's size "
          "in partitions",
          lambda v: isinstance(v, bool))
