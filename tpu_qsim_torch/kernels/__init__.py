"""Hand-written CUDA kernels of the port and their host planners.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went through
the kernels (``reset_launches`` zeroes the counts).
"""

from collections import Counter

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
