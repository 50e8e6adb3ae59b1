"""What pandas has and neither package does, which the port raised as
AttributeError or TypeError: each now raises NotImplementedError naming
ROADMAP.md's "beyond the reference" line.  One case a name; every case
failed before (an AttributeError, a TypeError, or no error where the
option was ignored for rows outside a fold or a gap)."""

import datetime

import pandas as pd
import pytest
import torch

import cudf_tpu_torch as ct

CPU = torch.device("cpu")


def _text():
    return ct.Series(["a b", "c d e"], device=CPU)


def _stamps():
    return ct.Series(pd.Series(pd.to_datetime(["2020-03-31 10:00", "2021-01-01 00:00"])), device=CPU)


CASES = {
    **{f"str.{name}": (lambda name=name: getattr(_text().str, name)(*args))
       for name, args in (("rsplit", ()), ("partition", ()), ("rpartition", ()),
                          ("casefold", ()), ("normalize", ("NFC",)), ("get_dummies", ()),
                          ("join", ("-",)), ("istitle", ()))},
    "str.repeat of a sequence": lambda: _text().str.repeat([1, 2]),
    **{f"dt.{name}": (lambda name=name: getattr(_stamps().dt, name))
       for name in ("is_quarter_start", "is_quarter_end", "is_year_start", "is_year_end",
                    "date", "time")},
    **{f"dt.{name}()": (lambda name=name, args=args: getattr(_stamps().dt, name)(*args))
       for name, args in (("isocalendar", ()), ("normalize", ()), ("day_name", ()),
                          ("month_name", ()), ("to_period", ("M",)))},
    "to_datetime(utc=True)": lambda: ct.to_datetime(ct.Series(["2020-01-01"], device=CPU),
                                                    utc=True),
    'tz_localize(ambiguous="infer")': lambda: _stamps().dt.tz_localize("Europe/Berlin",
                                                                      ambiguous="infer"),
    "tz_localize(nonexistent=timedelta)": lambda: _stamps().dt.tz_localize(
        "Europe/Berlin", nonexistent=datetime.timedelta(hours=1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_missing_in_both_packages_names_beyond_the_reference(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md, beyond the reference"):
        CASES[name]()
