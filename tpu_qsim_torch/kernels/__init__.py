"""Hand-written CUDA kernels of the port and their host planners.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went through
the kernels (``reset_launches`` zeroes the counts). One launch of the segment
kernel runs a range of segments of either kind; ``SEGMENT_KINDS`` tallies,
per kind (``segment``, ``scatter_segment``), the launches that ran a segment
of that kind, and is not a count of launches. ``PASS_INSTANCES`` tallies the
dense pass's launches by the instance of ``csrc/dense_pass.cu`` they ran
(``small``, ``medium``, ``large``, ``stream``).
"""

from collections import Counter

LAUNCHES: Counter = Counter()
SEGMENT_KINDS: Counter = Counter()
PASS_INSTANCES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    SEGMENT_KINDS.clear()
    PASS_INSTANCES.clear()
