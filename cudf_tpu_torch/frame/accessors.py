"""The ``str``, ``dt`` and ``cat`` accessors of a Series (port of
``cudf_tpu/frame/accessors.py``).

Every method runs the column ops of ``ops/strings.py``,
``ops/datetime.py`` and ``ops/timezone.py`` on the Series' device.  The
``str`` methods of a dictionary column run over its keys and gather the
results by code.  Results follow pandas 3: predicates of the ``str``
dtype give False for a missing value; a Series of pandas' nullable
``string`` dtype gives ``string``, ``Int64`` and ``boolean`` results
(null stays null).  Unlike the reference, ``dt.is_leap_year``,
``is_month_start`` and ``is_month_end`` of NaT are False and
``cat.codes`` is the narrowest signed integer that holds the codes, as
in pandas; ``cat.as_ordered`` sets pandas' ``ordered`` flag (the
reference returns a copy), and ``str.extract`` names its columns by the
pattern's named groups, as pandas does.  ``str.split(expand=False)`` and
``str.findall`` give LIST<STRING> Series, on the device where the span
engine takes the pattern.  ``.list`` and ``.struct`` are the accessors of
LIST and STRUCT Series over ``ops/lists.py`` and ``ops/structs.py``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import datetime as dt_ops
from cudf_tpu_torch.ops import lists as list_ops
from cudf_tpu_torch.ops import strings as str_ops
from cudf_tpu_torch.ops import structs as struct_ops
from cudf_tpu_torch.ops import timezone as tz_ops
from cudf_tpu_torch.ops import unary
from cudf_tpu_torch.ops._utils import materialize_validity
from cudf_tpu_torch.utils import tracing

_REGEX_CHARS = frozenset(r".^$*+?{}[]\|()")
_NULLABLE = {dt.TypeId.STRING: dt.DType(dt.TypeId.STRING, nullable=True),
             dt.TypeId.INT64: dt.DType(dt.TypeId.INT64, nullable=True),
             dt.TypeId.BOOL8: dt.DType(dt.TypeId.BOOL8, nullable=True)}


def _is_regex(pat: str) -> bool:
    return any(c in _REGEX_CHARS for c in pat)


def _beyond(what: str):
    from cudf_tpu_torch.frame.series import BEYOND

    raise NotImplementedError(f"{what}: {BEYOND}")


def _beyond_method(what: str):
    def method(self, *args, **kwargs):
        _beyond(what)
    method.__name__ = what.rsplit(".", 1)[-1]
    return method


def _beyond_property(what: str):
    return property(lambda self: _beyond(what))


def binaryop_concat(l: Column, r: Column) -> Column:
    """Row-wise concatenation of two STRING columns (null where either
    is), as ``str.cat`` and ``+`` give it (``ops/strings.py`` ``concat``)."""
    return str_ops.concat([l, r])


class StringMethods:
    def __init__(self, s):
        if not (s.dtype.is_string or (s.dtype.is_dictionary and s._column.keys.dtype.is_string)):
            raise AttributeError("Can only use .str accessor with string values!")
        self._s = s
        self._nullable = s.dtype.is_string and s.dtype.nullable

    # -- plumbing ------------------------------------------------------
    def _run(self, op, *args, **kwargs):
        """``op`` of the column; of a dictionary's keys, gathered by code."""
        return str_ops.over_keys(self._s._column, lambda c: op(c, *args, **kwargs))

    def _wrap(self, col: Column):
        from cudf_tpu_torch.frame.series import Series

        if self._nullable and col.dtype.id in _NULLABLE:
            col = col._as(_NULLABLE[col.dtype.id])
        return Series._from(col, self._s._index, self._s.name)

    def _wrap_bool(self, col: Column):
        """pandas 3's ``str`` dtype: a predicate of a missing value is False."""
        if col.validity is not None and not self._nullable:
            col = Column(dt.BOOL8, col.length, col.data & col.validity)
        return self._wrap(col)

    def _frame(self, cols, names=None):
        from cudf_tpu_torch.core.table import Table
        from cudf_tpu_torch.frame.dataframe import DataFrame

        if self._nullable:
            cols = [c._as(_NULLABLE[dt.TypeId.STRING]) for c in cols]
        names = range(len(cols)) if names is None else names
        return DataFrame._from(Table(dict(zip(names, cols))), self._s._index)

    # -- attributes and case -------------------------------------------
    def len(self):
        return self._wrap(self._run(str_ops.length))

    def byte_count(self):
        return self._wrap(self._run(str_ops.byte_count))

    def lower(self):
        return self._wrap(self._run(str_ops.lower))

    def upper(self):
        return self._wrap(self._run(str_ops.upper))

    def capitalize(self):
        return self._wrap(self._run(str_ops.capitalize))

    def title(self):
        return self._wrap(self._run(str_ops.title))

    def swapcase(self):
        return self._wrap(self._run(str_ops.swapcase))

    def strip(self, to_strip=None):
        return self._wrap(self._run(str_ops.strip, to_strip, "both"))

    def lstrip(self, to_strip=None):
        return self._wrap(self._run(str_ops.strip, to_strip, "left"))

    def rstrip(self, to_strip=None):
        return self._wrap(self._run(str_ops.strip, to_strip, "right"))

    def slice(self, start=None, stop=None, step=None):
        return self._wrap(self._run(str_ops.slice_strings, start, stop, step))

    def get(self, i):
        return self._wrap(self._run(str_ops.get, i))

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.slice(key.start, key.stop, key.step)
        return self.get(key)

    # -- search ----------------------------------------------------------
    def contains(self, pat, case=True, flags=0, na=None, regex=True):
        if not case:
            flags |= re.IGNORECASE
        if regex and (_is_regex(pat) or flags):
            return self._with_na(self._run(str_ops.contains_re, pat, flags), na)
        if not case:
            return self._with_na(self._run(lambda c: str_ops.contains_literal(
                str_ops.lower(c), pat.lower())), na)
        return self._with_na(self._run(str_ops.contains_literal, pat), na)

    def match(self, pat, case=True, flags=0, na=None):
        flags |= 0 if case else re.IGNORECASE
        return self._with_na(self._run(str_ops.match_re, pat, flags), na)

    def fullmatch(self, pat, case=True, flags=0, na=None):
        flags |= 0 if case else re.IGNORECASE
        return self._with_na(self._run(str_ops.fullmatch_re, pat, flags), na)

    def _with_na(self, col: Column, na):
        """A predicate's missing values as ``na`` when it is given."""
        if na is not None and not (isinstance(na, float) and na != na) \
                and col.validity is not None:
            col = Column(dt.BOOL8, col.length, torch.where(col.validity, col.data, bool(na)))
        return self._wrap_bool(col)

    def _affix(self, pat, na, op):
        pats = pat if isinstance(pat, tuple) else (pat,)
        if not all(isinstance(p, str) for p in pats):
            raise TypeError(f"expected a string or tuple, not {type(pat).__name__}")
        out = None
        for p in pats:
            c = self._run(op, p)
            out = c if out is None else Column(dt.BOOL8, c.length, out.data | c.data,
                                               c.validity)
        return self._with_na(out, na)

    def startswith(self, pat, na=None):
        return self._affix(pat, na, str_ops.startswith)

    def endswith(self, pat, na=None):
        return self._affix(pat, na, str_ops.endswith)

    def _find(self, sub, start, end, from_end):
        if start == 0 and end is None:
            return self._wrap(self._run(str_ops.find_literal, sub, from_end))

        def op(col):
            # Python's find(sub, start, end): a search of s[start:end],
            # reported from the start of s
            pos = str_ops.find_literal(str_ops.slice_strings(col, start or None, end), sub,
                                       from_end)
            n = str_ops.length(col).data
            lo = torch.full_like(n, start)
            lo = torch.where(lo >= 0, torch.minimum(lo, n), torch.clamp(n + lo, min=0))
            return Column(dt.INT64, col.length, torch.where(pos.data >= 0, pos.data + lo, -1),
                          col.validity)
        return self._wrap(self._run(op))

    def find(self, sub, start=0, end=None):
        return self._find(sub, start, end, False)

    def rfind(self, sub, start=0, end=None):
        return self._find(sub, start, end, True)

    def index(self, sub, start=0, end=None):
        out = self.find(sub, start, end)
        missing = (out._column.data == -1) & materialize_validity(out._column)
        if tracing.to_bool(missing.any(), "label_lookup"):
            raise ValueError("substring not found")
        return out

    def count(self, pat, flags=0):
        if _is_regex(pat) or flags:
            return self._wrap(self._run(str_ops.count_re, pat, flags))
        return self._wrap(self._run(str_ops.count_literal, pat))

    # -- rewriting ---------------------------------------------------------
    def replace(self, pat, repl, n=-1, case=None, flags=0, regex=False):
        if case is False:
            flags |= re.IGNORECASE
        if regex and (_is_regex(pat) or flags):
            return self._wrap(self._run(str_ops.replace_re, pat, repl, n, flags))
        return self._wrap(self._run(str_ops.replace_literal, pat, repl, n))

    def extract(self, pat, flags=0, expand=True):
        cols = self._run(str_ops.extract_re, pat, flags)
        if len(cols) == 1 and not expand:
            return self._wrap(cols[0])
        by_group = {g: name for name, g in re.compile(pat, flags).groupindex.items()}
        return self._frame(cols, [by_group.get(i + 1, i) for i in range(len(cols))])

    def split(self, pat=None, n=-1, expand=False, regex=None):
        regex = bool(pat) and len(pat) > 1 and _is_regex(pat) if regex is None else regex
        if not expand:
            return self._wrap(self._run(str_ops.split_record, pat, n, regex))
        return self._frame(self._run(str_ops.split_expand, pat, n, regex))

    def findall(self, pat, flags=0):
        return self._wrap(self._run(str_ops.findall_re, pat, flags))

    def wrap(self, width, **kwargs):
        """Lines of at most ``width`` characters joined by newlines
        (``textwrap.wrap``, on the host as in the reference)."""
        import textwrap

        return self._wrap(str_ops.host_map(
            self._strings(), lambda s: "\n".join(textwrap.wrap(s, width, **kwargs)), dt.STRING))

    def pad(self, width, side="left", fillchar=" "):
        return self._wrap(self._run(str_ops.pad, width, side, fillchar))

    def ljust(self, width, fillchar=" "):
        return self.pad(width, "right", fillchar)

    def rjust(self, width, fillchar=" "):
        return self.pad(width, "left", fillchar)

    def center(self, width, fillchar=" "):
        return self.pad(width, "both", fillchar)

    def zfill(self, width):
        return self._wrap(self._run(str_ops.zfill, width))

    def repeat(self, repeats):
        if not isinstance(repeats, (int, np.integer)):
            _beyond("str.repeat of a sequence")
        return self._wrap(self._run(str_ops.repeat_strings, repeats))

    def removeprefix(self, prefix):
        def op(col):
            cut = str_ops.slice_strings(col, len(prefix))
            return copying.copy_if_else(str_ops.startswith(col, prefix).data, cut, col)
        return self._wrap(self._run(op)) if prefix else self._wrap(self._s._column)

    def removesuffix(self, suffix):
        def op(col):
            cut = str_ops.slice_strings(col, None, -len(suffix))
            return copying.copy_if_else(str_ops.endswith(col, suffix).data, cut, col)
        return self._wrap(self._run(op)) if suffix else self._wrap(self._s._column)

    def slice_replace(self, start=None, stop=None, repl=""):
        return self._wrap(str_ops.host_map(
            self._strings(), lambda s: s[:start] + repl + s[(len(s) if stop is None else stop):],
            dt.STRING))

    def translate(self, table):
        return self._wrap(str_ops.host_map(self._strings(), lambda s: s.translate(table),
                                           dt.STRING))

    def _strings(self) -> Column:
        return self._s._column.decode_dictionary()

    def cat(self, others=None, sep=None, na_rep=None):
        """Joined into one string (no ``others``), or row by row with
        another Series, list or array of strings."""
        from cudf_tpu_torch.frame.series import Series

        sep = sep or ""
        col = self._strings()
        if na_rep is not None:
            col = copying.copy_if_else(materialize_validity(col), col, na_rep)
        if others is None:
            return str_ops.join_strings(col, sep)
        if isinstance(others, Series):
            other = others._column.decode_dictionary()
        elif isinstance(others, (list, tuple, np.ndarray)):
            other = Column.from_strings([None if v is None else str(v) for v in others],
                                        device=col.device)
        else:
            raise TypeError("others must be Series, Index, DataFrame, np.ndarray or "
                            "list-like")
        if na_rep is not None:
            other = copying.copy_if_else(materialize_validity(other), other, na_rep)
        return self._wrap(str_ops.concat([col, sep, other] if sep else [col, other]))

    # -- character classes -------------------------------------------------
    def isdigit(self):
        return self._wrap_bool(self._run(str_ops.isdigit))

    def isdecimal(self):
        return self._wrap_bool(self._run(str_ops.isdecimal))

    def isnumeric(self):
        return self._wrap_bool(self._run(str_ops.isnumeric))

    def isalpha(self):
        return self._wrap_bool(self._run(str_ops.isalpha))

    def isalnum(self):
        return self._wrap_bool(self._run(str_ops.isalnum))

    def isspace(self):
        return self._wrap_bool(self._run(str_ops.isspace))

    def isupper(self):
        return self._wrap_bool(self._run(str_ops.isupper))

    def islower(self):
        return self._wrap_bool(self._run(str_ops.islower))


_TICKS = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}


class DatetimeProperties:
    def __init__(self, s):
        if not (s.dtype.is_timestamp or s.dtype.is_duration):
            raise AttributeError("Can only use .dt accessor with datetimelike values")
        if dt_ops.is_day_unit(s.dtype):                 # read as seconds, as pandas
            s = type(s)._from(dt_ops.days_as_seconds(s._column), s._index, s.name)
        self._s = s

    def _wrap(self, col: Column):
        from cudf_tpu_torch.frame.series import Series

        return Series._from(col, self._s._index, self._s.name)

    def _field(self, name: str):
        if not self._s.dtype.is_timestamp:
            raise AttributeError(f"'TimedeltaProperties' object has no attribute {name!r}")
        return self._wrap(dt_ops.extract(tz_ops.wall_clock_column(self._s._column), name))

    @property
    def tz(self):
        return self._s.dtype.tz

    def tz_localize(self, tz, ambiguous="raise", nonexistent="raise"):
        return self._wrap(tz_ops.tz_localize(self._s._column, tz, ambiguous, nonexistent))

    def tz_convert(self, tz):
        return self._wrap(tz_ops.tz_convert(self._s._column, tz))

    def floor(self, freq):
        return self._wrap(dt_ops.floor(self._s._column, freq))

    def ceil(self, freq):
        return self._wrap(dt_ops.ceil(self._s._column, freq))

    def round(self, freq):
        return self._wrap(dt_ops.round(self._s._column, freq))

    def strftime(self, date_format):
        return self._wrap(str_ops.strftime(self._s._column, date_format))

    def as_unit(self, unit):
        col = self._s._column
        kind = "M" if col.dtype.is_timestamp else "m"
        target = dt.DType(dt.unit_dtype(kind, unit).id, tz=col.dtype.tz)
        return self._wrap(unary.cast(col, target))

    # -- durations ---------------------------------------------------------
    def _duration(self):
        if not self._s.dtype.is_duration:
            raise AttributeError("'DatetimeProperties' object has no attribute for durations")
        col = self._s._column
        return col, _TICKS[col.dtype.time_unit]

    @property
    def days(self):
        col, tps = self._duration()
        return self._wrap(Column(dt.INT64, col.length,
                                 torch.div(col.data, tps * 86400, rounding_mode="floor"),
                                 col.validity))

    @property
    def seconds(self):
        col, tps = self._duration()
        secs = torch.div(col.data, tps, rounding_mode="floor") % 86400
        return self._wrap(Column(dt.INT64, col.length, secs, col.validity))

    def total_seconds(self):
        col, tps = self._duration()
        return self._wrap(Column(dt.FLOAT64, col.length, col.data.double() / tps,
                                 col.validity))


def _field_property(name):
    return property(lambda self: self._field(name))


# what pandas has and neither package does: ROADMAP.md's "beyond the reference"
for _name in ("rsplit", "partition", "rpartition", "casefold", "normalize", "get_dummies",
              "join", "istitle"):
    setattr(StringMethods, _name, _beyond_method(f"str.{_name}"))
for _name in ("is_quarter_start", "is_quarter_end", "is_year_start", "is_year_end", "date",
              "time"):
    setattr(DatetimeProperties, _name, _beyond_property(f"dt.{_name}"))
for _name in ("isocalendar", "normalize", "day_name", "month_name", "to_period"):
    setattr(DatetimeProperties, _name, _beyond_method(f"dt.{_name}"))


for _name in dt_ops.FIELDS:
    setattr(DatetimeProperties, _name, _field_property(_name))
for _alias, _name in (("dayofweek", "weekday"), ("day_of_week", "weekday"),
                      ("day_of_year", "dayofyear"), ("daysinmonth", "days_in_month")):
    setattr(DatetimeProperties, _alias, _field_property(_name))


class CategoricalAccessor:
    def __init__(self, s):
        if not s.dtype.is_dictionary:
            raise AttributeError("Can only use .cat accessor with a 'category' dtype")
        self._s = s

    @property
    def categories(self):
        from cudf_tpu_torch.frame.index import Index

        return Index(self._s._column.keys)

    @property
    def codes(self):
        """The codes, -1 where null, in the narrowest signed integer that
        holds the categories (pandas' ``coerce_indexer_dtype``)."""
        from cudf_tpu_torch.frame.series import Series

        col = self._s._column
        k = col.keys.length
        store = torch.int8 if k < 127 else torch.int16 if k < 32767 else torch.int32
        codes = col.data if col.validity is None else torch.where(col.validity, col.data, -1)
        return Series._from(Column.from_tensor(codes.to(store)), self._s._index, None)

    @property
    def ordered(self):
        return self._s.dtype.ordered

    def _with_ordered(self, ordered: bool):
        from cudf_tpu_torch.frame.series import Series

        col = self._s._column
        d = col.dtype
        return Series._from(col._as(dt.DType(d.id, value_type=d.value_type, ordered=ordered)),
                            self._s._index, self._s.name)

    def as_ordered(self):
        return self._with_ordered(True)

    def as_unordered(self):
        return self._with_ordered(False)

    def set_categories(self, new_categories):
        from cudf_tpu_torch.frame.series import Series
        from cudf_tpu_torch.ops.dictionary import set_keys

        col = self._s._column
        keys = Column.from_pylist(list(new_categories), col.keys.dtype, device=col.device)
        return Series._from(set_keys(col, keys), self._s._index, self._s.name)

    def add_categories(self, new_categories):
        return self.set_categories(self._s._column.keys.to_numpy().tolist()
                                   + list(new_categories))


class ListMethods:
    """The ``.list`` accessor of a LIST Series (``ops/lists.py``)."""

    def __init__(self, s):
        if not s.dtype.is_list:
            raise AttributeError("Can only use .list accessor with a list dtype")
        self._s = s

    def _wrap(self, col: Column):
        from cudf_tpu_torch.frame.series import Series

        return Series._from(col, self._s._index, self._s.name)

    def len(self):
        return self._wrap(list_ops.count_elements(self._s._column))

    def get(self, i: int):
        return self._wrap(list_ops.extract_list_element(self._s._column, i))

    def __getitem__(self, i: int):
        return self.get(i)

    def contains(self, value):
        return self._wrap(list_ops.contains(self._s._column, value))

    def index(self, value):
        return self._wrap(list_ops.index_of(self._s._column, value))

    def sort_values(self, ascending: bool = True):
        return self._wrap(list_ops.segmented_sort(self._s._column, ascending))

    def unique(self):
        return self._wrap(list_ops.unique_per_row(self._s._column))

    def concat(self, other):
        return self._wrap(list_ops.concatenate_rows([self._s._column, other._column]))

    @property
    def leaves(self):
        from cudf_tpu_torch.frame.index import default_index
        from cudf_tpu_torch.frame.series import Series

        child = self._s._column.children[0]
        return Series._from(child, default_index(child.length), self._s.name)


class StructMethods:
    """The ``.struct`` accessor of a STRUCT Series (``ops/structs.py``)."""

    def __init__(self, s):
        if not s.dtype.is_struct:
            raise AttributeError("Can only use .struct accessor with a struct dtype")
        self._s = s

    @property
    def dtypes(self):
        return dict(self._s.dtype.fields)

    def field(self, name_or_index):
        from cudf_tpu_torch.frame.series import Series

        name = name_or_index if isinstance(name_or_index, str) else \
            self._s.dtype.fields[name_or_index][0]
        return Series._from(struct_ops.field(self._s._column, name_or_index), self._s._index,
                            name)

    def explode(self):
        from cudf_tpu_torch.frame.dataframe import DataFrame

        return DataFrame._from(struct_ops.explode_to_table(self._s._column), self._s._index)
