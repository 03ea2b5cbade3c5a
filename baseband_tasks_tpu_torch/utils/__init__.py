"""Host-side utility layer: units, two-double time."""

from . import units
from .time import Time, TimeDelta, two_sum

__all__ = ["units", "Time", "TimeDelta", "two_sum"]
