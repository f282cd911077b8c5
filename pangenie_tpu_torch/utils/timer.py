"""Wall-clock phase timing + RSS reporting.

Equivalent of the reference's Timer/getrusage bookkeeping
(src/timer.cpp, src/commands.cpp:559-586): every command collects
per-phase interval times and prints an end-of-run summary with peak
RSS.
"""

from __future__ import annotations

import resource
import sys
import time
from typing import List, Tuple


# phase -> seconds of the most recent completed command in this
# process; the bench reads it to attribute the e2e wall to phases in
# its JSON artifact line
last_phases: dict = {}


class Timer:
    """Monotonic total/interval timer (reference src/timer.cpp:5-20)."""

    def __init__(self):
        self._start = time.monotonic()
        self._interval = self._start

    def get_interval_time(self) -> float:
        now = time.monotonic()
        result = now - self._interval
        self._interval = now
        return result

    def get_total_time(self) -> float:
        return time.monotonic() - self._start


class PhaseSummary:
    """Collects (phase, seconds) pairs and prints the summary block."""

    def __init__(self, command: str):
        self.command = command
        self.timer = Timer()
        self.phases: List[Tuple[str, float]] = []

    def phase(self, name: str) -> None:
        self.phases.append((name, self.timer.get_interval_time()))

    def print_summary(self) -> None:
        global last_phases
        last_phases = dict(self.phases)
        print(f"\n###### Summary {self.command} ######", file=sys.stderr)
        for name, seconds in self.phases:
            print(f"time spent {name}:\t{seconds:.2f} sec", file=sys.stderr)
        print(
            f"total wallclock time {self.command}: "
            f"{self.timer.get_total_time():.2f} sec",
            file=sys.stderr,
        )
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"Max RSS:\t{rss_gb:.2f} GB", file=sys.stderr)
        print("#" * 36 + "\n", file=sys.stderr)
