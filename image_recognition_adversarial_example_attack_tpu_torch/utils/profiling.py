"""Phase timing (port of ``PhaseTimer``/``PhaseRecord`` of
``utils/profiling.py``): wall-clock seconds and examples/s per named phase,
collected as a dict for JSON reports.  The device trace is
``cli/common.py::maybe_profile`` (``--profile-dir``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class PhaseRecord:
    name: str
    seconds: float
    examples: int | None = None

    @property
    def examples_per_sec(self) -> float | None:
        if self.examples is None or self.seconds <= 0:
            return None
        return self.examples / self.seconds


@dataclass
class PhaseTimer:
    """Collects named phase timings.  CUDA work is asynchronous: the caller
    waits for the device (a ``.tolist()``, ``torch.cuda.synchronize()``)
    before the phase exits."""

    records: list[PhaseRecord] = field(default_factory=list)

    @contextmanager
    def phase(self, name: str, examples: int | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append(PhaseRecord(name=name, seconds=time.perf_counter() - t0,
                                            examples=examples))

    def as_dict(self) -> dict:
        return {
            r.name: {
                "seconds": round(r.seconds, 4),
                **({"examples": r.examples,
                    "examples_per_sec": round(r.examples_per_sec, 2)}
                   if r.examples is not None else {}),
            }
            for r in self.records
        }
