"""The numbers that decide ``correct``, each beside its limit.

A cell's workload file gives each number's limit under ``check.limits``; a
number passes when it is at most its limit.  A number that is not finite
fails.  The last lines of standard error and the result line's last key
list every number compared with its limit.
"""

from __future__ import annotations

import math
import sys
import typing as tp


class Checks:

    def __init__(self, limits: tp.Mapping[str, float]):
        self.limits = dict(limits)
        self.values: tp.Dict[str, float] = {}
        self.notes: tp.List[str] = []

    def compare(self, name: str, value: float) -> bool:
        """Record ``value`` under ``name``; True when it keeps to the limit.
        A repeated name keeps the worst value."""
        if name not in self.limits:
            raise KeyError(f'no limit for {name!r}: the workload file lists {sorted(self.limits)}')
        value = float(value)
        old = self.values.get(name)
        if old is None or not math.isfinite(value) or value > old:
            self.values[name] = value
        return math.isfinite(value) and value <= self.limits[name]

    def fail(self, note: str) -> None:
        """A failure that is not a number: an answer that never came."""
        self.notes.append(note)

    @property
    def correct(self) -> bool:
        missing = set(self.limits) - set(self.values)
        return (not self.notes and not missing
                and all(math.isfinite(v) and v <= self.limits[k] for k, v in self.values.items()))

    def table(self) -> tp.Dict[str, tp.Dict[str, float]]:
        out = {k: {'value': v, 'limit': self.limits[k]} for k, v in self.values.items()}
        for k in sorted(set(self.limits) - set(self.values)):
            out[k] = {'value': float('nan'), 'limit': self.limits[k]}
        return out

    def print(self, stream: tp.TextIO = sys.stderr) -> None:
        for note in self.notes:
            print(f'check failed: {note}', file=stream)
        for name, row in self.table().items():
            verdict = 'ok' if math.isfinite(row['value']) and row['value'] <= row['limit'] \
                else 'FAIL'
            print(f'{name} {row["value"]!r} limit {row["limit"]!r} {verdict}', file=stream)
        stream.flush()
