"""NA and NaT scalar sentinels (port of ``cudf_tpu/utils/missing.py``),
without pandas: ``NA`` is the port's own singleton, ``NaT`` numpy's."""

from __future__ import annotations

import numpy as np


class _NAType:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<NA>"

    def __bool__(self):
        raise TypeError("boolean value of NA is ambiguous")

    def __eq__(self, other):
        return NA

    def __ne__(self, other):
        return NA

    def __hash__(self):
        return 2**61 - 1


NA = _NAType()
NaT = np.datetime64("NaT")
