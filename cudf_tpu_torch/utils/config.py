"""Typed option registry (port of ``cudf_tpu/utils/config.py``).

Every option of the reference is registered, with its default, except
``*.kernel_interpret``.  An option the reference reads nowhere is read
nowhere here either: its description says so, and it takes only its
default, so a setting the port would ignore raises.  Every option is
env-overridable as ``CUDF_TPU_TORCH__<UPPER_NAME>`` (dots become ``__``).
The reference's ``*.kernel_interpret`` options have no counterpart: the
port's kernel wrappers take their plain PyTorch version for CPU tensors,
with no switch, and an option that sent card tensors to the plain
version would hide the kernel.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


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
    if not validator(value):
        raise ValueError(f"invalid value {value!r} for option {name!r} in the environment")
    _registry[name] = _Option(name, default, description, validator, value)


def get_option(name: str) -> Any:
    return _registry[name].value


def set_option(name: str, value: Any) -> None:
    opt = _registry[name]
    if not opt.validator(value):
        raise ValueError(f"invalid value {value!r} for option {name!r}")
    opt.value = value


def describe_option(name: Optional[str] = None) -> None:
    """Print each option (or ``name``'s) with its description, default and
    current value."""
    for n in [name] if name else sorted(_registry):
        o = _registry[n]
        print(f"{o.name}: {o.description} (default {o.default!r}, current {o.value!r})")


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


def _flag(v) -> bool:
    return isinstance(v, bool)


def _only(default) -> Callable[[Any], bool]:
    """The validator of an option the port reads nowhere: its default alone."""
    return lambda v: type(v) is type(default) and v == default


# the IO tiers: each option chooses between the port's own reader or
# writer and pyarrow's (pandas' for JSON records), as the reference's does
_register("io.csv.device_tokenizer", True,
          "parse CSV with the device quote-state tokenizer (io/csv_device.py); off, or on "
          "ragged rows, pyarrow's parser", _flag)
_register("io.json.device_tokenizer", True,
          "parse JSON lines and record arrays with the device tokenizer (io/json_device.py); "
          "off, or on nested values, pyarrow's reader for lines and pandas' for records",
          _flag)
_register("io.orc.native_reader", True,
          "read flat ORC files with the native reader (io/orc_native.py); off, pyarrow's",
          _flag)
_register("io.orc.native_writer", True,
          "write ORC with the native writer (io/orc_writer.py) where it can; off, pyarrow's",
          _flag)
_register("io.parquet.native_reader", True,
          "read Parquet with the native reader (io/parquet_native.py: row-group, page-index "
          "and bloom pushdown, pages decoded on the device); off, pyarrow's", _flag)
_register("io.parquet.native_writer", True,
          "write Parquet with the native writer (io/parquet_writer.py) where it can; off, "
          "pyarrow's", _flag)
_register("io.parquet.hybrid_scan", True,
          "with a page index and filters, decode the filter columns first, evaluate the "
          "predicate exactly and read only the payload pages holding matches "
          "(parquet_native._hybrid_exact_intervals); off, the page index's intervals alone",
          _flag)
_register("io.parquet.device_decode", True,
          "decode pages on the device: the native reader has no host page decoder, so this "
          "is always on (the reference's default off sends its pages to host decoding); "
          "read nowhere", _only(True))
_register("io.parquet.chunk_read_limit", 0,
          "bytes per parquet pass (0 = whole file); registered as the reference registers "
          "it and, as in the reference, read nowhere (ParquetReader takes its own "
          "chunk_read_limit)", _only(0))

# registered as the reference registers them; the reference reads none of
# these, and neither does the port, so each takes only its default
_register("mode.pandas_compatible", True,
          "strict pandas semantics where they cost performance; read nowhere, as in the "
          "reference (the port follows pandas' semantics throughout)", _only(True))
_register("display.max_rows", 60, "rows shown in repr; read nowhere, as in the reference",
          _only(60))
_register("default_integer_bitwidth", 64,
          "default int width; read nowhere, as in the reference (integers default to int64)",
          _only(64))
_register("default_float_bitwidth", 64,
          "default float width; read nowhere, as in the reference (floats default to "
          "float64)", _only(64))
_register("strings.host_fallback", True,
          "allow host fallback for regex and non-ASCII string ops; read nowhere, as in the "
          "reference (the host routes are counted in ops/strings.py STRING_ROUTES)",
          _only(True))
