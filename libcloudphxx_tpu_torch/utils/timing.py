"""StepTimer: the per-phase wall-clock profiler SURVEY section 5 asks for
(libcloudphxx_tpu/utils/timing.py).

Usage::

    timer = StepTimer()
    with timer("cond", sync=th):
        th, rv = prtcls.step_sync(opts, th, rv)
    with timer("async", sync=th):
        prtcls.step_async(opts)
    print(timer.report())

CUDA launches return before the work is done, so a phase's time counts
its device work only where ``sync`` names a tensor or a device of the
card: the timer then waits for it (torch.cuda.synchronize) on the phase's
exit.  Use it only when profiling.
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def synchronize(sync):
    """Wait for the device work queued on ``sync``'s device: a tensor, a
    device or its name, or a sequence of them; a CPU one needs no wait."""
    if isinstance(sync, (list, tuple)):
        for s in sync:
            synchronize(s)
        return
    dev = sync.device if isinstance(sync, torch.Tensor) \
        else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def __call__(self, phase: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def report(self) -> str:
        tot = sum(self.totals.values()) or 1.0
        lines = []
        for phase, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[phase]
            lines.append(
                f"{phase:>20}: {t:8.3f} s  ({t / n * 1e3:8.2f} ms x {n:4d})"
                f"  {100 * t / tot:5.1f}%"
            )
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
