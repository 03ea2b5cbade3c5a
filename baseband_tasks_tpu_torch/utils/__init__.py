"""Host-side utility layer: units, two-double time, dtype helpers."""

from . import units
from .time import Time, TimeDelta, two_sum

__all__ = ["units", "Time", "TimeDelta", "two_sum"]
