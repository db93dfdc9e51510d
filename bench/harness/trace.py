"""The traced window of a `--trace 1` run: `torch.profiler` over whole
calls of the timed path, reduced to device busy time, kernel time by
name and the longest idle gaps named by what the host was doing.

The window is the host-side annotation ``bench.window`` that the driver
opens around the traced calls; device time outside it is not counted.
The profiler's events are read in memory; nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import sys
import time

import torch

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A kernel's name without its argument list, return type and the
    namespaces that every kernel carries, at most 96 characters."""
    for ns in ("(anonymous namespace)::", "at::native::", "at::detail::", "std::"):
        name = name.replace(ns, "")
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:96]


def category(e) -> str:
    """A profiler event's trace category ("kernel", "gpu_memcpy",
    "cpu_op", "user_annotation", ...), from `activity_type()` where the
    installed PyTorch has it, else from its device and kind."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    ua = e.is_user_annotation() if hasattr(e, "is_user_annotation") \
        else e.name().startswith("bench.")
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if ua:
            return "gpu_user_annotation"
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy")
                else "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if ua else "cpu_op"


class Tracer:
    """Profiles the calls made between `start` and `stop` (when on).

    With `host_ops` False only the device's activity is recorded, for
    windows whose host-side op events would be too many to read within
    a run's time (a whole deploy issues millions of small kernels); the
    window is then the host clock's, taken between two syncs, and gaps
    are named by the runtime calls the trace holds, if any.
    """

    def __init__(self, on: bool, host_ops: bool = True):
        self.on = on
        self.host_ops = host_ops
        self.prof = None
        self.summary = None
        self._window = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.on or self.prof is not None:
            return
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host_ops:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if self.host_ops:
            self._window = torch.profiler.record_function(WINDOW)
            self._window.__enter__()
        self._t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.summary is None

    def stop(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize()
        host_window = time.perf_counter() - self._t0
        if self._window is not None:
            self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        events = [(category(e), e.name(), e.start_ns() * 1e-3, e.duration_ns() * 1e-3)
                  for e in self.prof.profiler.kineto_results.events()]
        self.prof = None
        self.summary = reduce(events, None if self.host_ops else host_window)
        print(f"trace: {len(events)} events read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)

    def span(self, name: str):
        """A host-side annotation, recorded only while tracing host ops."""
        if self.active and self.host_ops:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def reduce(events: list, host_window: float | None = None) -> dict:
    """Busy and window seconds, device seconds by kernel name, and the
    longest idle gaps named by the innermost host event open at their
    start (prefixed by the innermost ``bench.`` annotation).

    `events` are (category, name, start us, duration us).  The window is
    the ``bench.window`` annotation, or, given `host_window` (seconds on
    the host clock, for a trace without host ops), that long from the
    first device op on.
    """
    if host_window is None:
        win = [e for e in events if e[0] == "user_annotation" and e[1] == WINDOW]
        if not win:
            return {}
        w0 = win[0][2]
        w1 = w0 + win[0][3]
    else:
        starts = [e[2] for e in events if e[0] in _DEVICE_CATS]
        if not starts:
            return {}
        w0 = min(starts)
        w1 = w0 + host_window * 1e6
    dev, by_name = [], {}
    host = []
    for cat, name, ts, dur in events:
        if cat in _DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b <= a:
                continue
            dev.append((a, b))
            n = short_name(name) if cat == "kernel" else cat
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        elif cat in _HOST_CATS and name != WINDOW:
            host.append((ts, ts + dur, name, cat))
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps, cur = [], w0
    for a, b in merged:
        if a > cur:
            gaps.append((a - cur, cur))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((w1 - cur, cur))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, at in gaps[:10]:
        open_ = [h for h in host[:bisect.bisect_right(starts, at)] if h[1] > at]
        spans = [h for h in open_ if h[2].startswith("bench.")]
        inner = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "idle host"
        outer = min(spans, key=lambda h: h[1] - h[0])[2] if spans else ""
        label = f"{outer}/{inner}" if outer and outer != inner else inner
        named.append([label[:96], length * 1e-6])
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy,
        kernel_s=by_name,
        device_ops=[[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=named,
    )
