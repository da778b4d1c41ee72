"""Reading a ``torch.profiler`` trace of the card: device intervals, busy
time, the device operations that took most time, kernel launches by name,
and the longest idle gaps named by the host operation under way."""
from __future__ import annotations

import time


class Profile:
    """What one profiled stretch of work left: ``window_s`` (host clock,
    from after the profiler started to after the device finished),
    ``busy_s`` (the union of the device's activity), ``kernels`` (name,
    seconds) of every device operation, ``breakdown``."""

    def __init__(self, window_s: float, device: list, host: list):
        self.window_s = window_s
        self.kernels = [(name, (end - start) * 1e-6)
                        for name, start, end in device]
        spans = sorted((s, e) for _, s, e in device)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-6
        by_name: dict = {}
        for name, sec in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + sec
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                        merged[i + 1][0]) for i in range(len(merged) - 1)),
                      reverse=True)[:10]
        self.breakdown = {
            "device_ops": [[short(n), s] for n, s in ops],
            "idle_gaps": [[_host_at(host, a, b), g * 1e-6]
                          for g, a, b in gaps]}

    def launches(self, fragments: tuple) -> list:
        """Seconds of every device operation whose name holds one of
        ``fragments``."""
        return [sec for name, sec in self.kernels
                if any(f in name for f in fragments)]


def short(name: str, n: int = 96) -> str:
    """A device operation's name cut to ``n`` characters."""
    return name if len(name) <= n else name[:n]


def _host_at(host: list, start: float, end: float) -> str:
    """The innermost host operation running over the gap's middle."""
    mid = 0.5 * (start + end)
    best = None
    for name, s, e in host:
        if s <= mid <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return short(best[0]) if best else "host code outside any recorded op"


def profiled(work) -> Profile:
    """Run ``work()`` under ``torch.profiler`` (host and device activity)
    and read the trace."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return _read(prof, window_s)


def _read(prof, window_s: float) -> Profile:
    """The trace's raw activity records (their times in µs): a device
    operation or a host one by its device type."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
        (device if e.device_type() == DeviceType.CUDA else host).append(rec)
    return Profile(window_s, device, host)


class Recorder:
    """``torch.profiler`` started and stopped by hand (a stretch of work
    inside a loop the caller does not own); ``profile`` is its reading."""

    def __init__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._t0 = None
        self.profile: Profile | None = None

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.profile = _read(self._prof, window_s)
