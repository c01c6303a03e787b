"""A traced slice of a run: ``torch.profiler`` over a short stretch of the
same work the window ran, reduced to what the per-layer metrics read.

From the device's events (kernels, copies, fills): the busy time as the
union of their intervals, device time by name, the longest idle gaps and
the host operation that covered each; from the host's events: the kernel
and graph launch calls (a CUDA graph's replay is one call for all its
kernels).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

HOST_LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                     'cuLaunchKernelEx', 'cudaGraphLaunch')
GAPS_LABELLED = 200


class Trace:
    """``with Trace(device) as tr: <work>``; then ``busy_s``, ``window_s``,
    ``device_s`` (seconds by device op name), ``launch_calls`` and
    ``breakdown``.  Without CUDA only the host is traced, and the device's
    readings (``busy_s``, ``breakdown``) stay None."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.device = device
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.device_s: Dict[str, float] = {}
        self.launch_calls = 0
        self.breakdown: Optional[dict] = None
        self.units = 0          # work units (steps, requests) the caller ran

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(exc[0] is None)
        return False

    def start(self):
        """Start tracing (from the thread that launches the traced work: the
        profiler records the device's activity of the thread it starts in)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def stop(self, digest: bool = True) -> None:
        """Stop tracing (in the thread that started it) and reduce the trace."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        if digest:
            self._digest(self._prof.profiler.kineto_results.events())
        del self._prof

    def _digest(self, events) -> None:
        """Reduce the profiler's raw events (host ops and runtime calls,
        device activity), times in ns."""
        from torch.autograd import DeviceType
        dev: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for e in events:
            s, t, name = e.start_ns(), e.end_ns(), e.name()
            if e.device_type() == DeviceType.CUDA:
                dev.append((s, t, name))
                self.device_s[name] = self.device_s.get(name, 0.0) + (t - s) / 1e9
            else:
                host.append((s, t, name))
                if name in HOST_LAUNCH_CALLS:
                    self.launch_calls += 1
        if not self.cuda:     # no device: no busy time, no idle share
            return
        dev.sort()
        merged: List[List[float]] = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) / 1e9
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:GAPS_LABELLED]
        host.sort()
        starts = [h[0] for h in host]
        by_label: Dict[str, float] = {}
        for length, s, t in gaps:
            label = _covering(host, starts, 0.5 * (s + t))
            by_label[label] = by_label.get(label, 0.0) + length / 1e9
        top_ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        top_gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
        self.breakdown = {'device_ops': [[n[:120], s] for n, s in top_ops],
                          'idle_gaps': [[n[:120], s] for n, s in top_gaps]}

    def kernel_s(self, *needles: str) -> float:
        """Device seconds of the ops whose name holds any of ``needles``."""
        return sum(s for n, s in self.device_s.items() if any(k in n for k in needles))


def _covering(host, starts, m: float, scan: int = 20000) -> str:
    """The innermost (latest-starting) host op running at time ``m``."""
    i = bisect.bisect_right(starts, m) - 1
    for j in range(i, max(-1, i - scan), -1):
        if host[j][1] >= m:
            return host[j][2]
    return 'host outside any traced op'
