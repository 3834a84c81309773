"""Host-side step timing — the port's copy of
som_lvq_pak_tpu/utils/progress.py:StepTimer (wall-clock step and sample
rates; the trainers call `step` after each batch or group)."""

from __future__ import annotations

import time


class StepTimer:
    """Accumulates step wall-times; reports steps/s and samples/s."""

    def __init__(self):
        self.steps = 0
        self.samples = 0
        self.start = time.time()

    def step(self, n_samples: int = 1) -> None:
        self.steps += 1
        self.samples += n_samples

    @property
    def elapsed(self) -> float:
        return time.time() - self.start

    def rates(self):
        dt = max(self.elapsed, 1e-9)
        return self.steps / dt, self.samples / dt

    def report(self) -> str:
        sps, xps = self.rates()
        return "%d steps (%.0f samples) in %.2fs: %.1f steps/s, %.0f samples/s" % (
            self.steps, self.samples, self.elapsed, sps, xps,
        )
