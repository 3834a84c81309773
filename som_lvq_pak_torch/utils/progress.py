"""Host-side progress and step timing — the port's copies of
som_lvq_pak_tpu/utils/progress.py:Mprint (:17-55, the reference's 60-dot
progress meter, mprint, lvq_pak.c:418-456; the CLI's parity trainers draw
it on a terminal at verbosity >= 1), StepTimer (wall-clock step and
sample rates; the trainers call `step` after each batch or group) and
`trace` (:84-96: a profile capture around a training region, here
torch.profiler's in place of jax.profiler's)."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional


class Mprint:
    """Stateful progress meter: call with the REMAINING count each step,
    then with 0 to finish (the reference's calling convention)."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr
        self.totlen = 0
        self.startt = 0.0
        self.prevt = -1.0

    def __call__(self, rlen: int) -> None:
        currt = int(time.time())
        if not self.totlen:
            self.totlen = rlen
            self.startt = currt
            self.stream.write(" " * 15 + "-" * 60)
        if currt != self.prevt or not rlen:
            t1 = currt - self.startt
            if rlen != self.totlen:
                t2 = int((currt - self.startt) * float(self.totlen) / (self.totlen - rlen))
            else:
                t2 = 0
            if t2 > 9999:
                t1 //= 60
                t2 //= 60
                unit = "min."
            else:
                unit = "sec."
            self.stream.write("\r%4u/%4u %4s " % (int(t1), int(t2), unit))
            if self.totlen:
                dots = int(60 * float(self.totlen - rlen) / self.totlen)
                self.stream.write("." * dots)
            self.stream.flush()
            self.prevt = currt
        if not rlen:
            self.totlen = 0
            self.stream.write("\n")


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


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Optional torch.profiler capture around a training region, exported
    to `logdir` as a Chrome trace (`<host>_<pid>.<ns>.pt.trace.json`, which
    TensorBoard's profiler plugin and chrome://tracing read); a no-op when
    no logdir is given.  It records the host's activity, and the card's
    kernels and copies whenever PyTorch has a CUDA device."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
