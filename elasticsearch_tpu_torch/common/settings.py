"""Time values of settings and request parameters (port of
`parse_time_value` in `elasticsearch_tpu/common/settings.py`): `30s`,
`500ms`, `1m`, `-1`, a bare number of seconds."""

from __future__ import annotations

import re
from typing import Any

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError

_TIME_RE = re.compile(r"^(-?\d+(?:\.\d+)?)(nanos|micros|ms|s|m|h|d)$")
_TIME_FACTORS = {"nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0,
                 "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_time_value(value: Any, setting_name: str = "") -> float:
    """A time value in seconds; only the -1 sentinel may be negative."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    if s in ("-1", "0"):
        return float(s)
    m = _TIME_RE.match(s)
    if not m or float(m.group(1)) < 0:
        raise IllegalArgumentError(
            f"failed to parse setting [{setting_name}] with value "
            f"[{value}] as a time value")
    return float(m.group(1)) * _TIME_FACTORS[m.group(2)]
