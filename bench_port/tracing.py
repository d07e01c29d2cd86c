"""Reading a ``torch.profiler`` trace of the benchmark's window: the device
operations, the host events, their union and gaps.  Times are nanoseconds
on the profiler's clock, which it shares between host and device events.
"""

from __future__ import annotations

import numpy as np

WINDOW = "bench_port.window"
CALL = "bench_port.call"
_OURS = (WINDOW, CALL)


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")()
                                               * 1000)


def collect(prof) -> dict:
    """Device operations and host events of a finished profile, as
    (name, start ns, duration ns) triples; the window span's bounds."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        item = (name, _ns(ev, "start"), _ns(ev, "duration"))
        if ev.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (item[1], item[1] + item[2])
            host.append(item)
        elif name not in _OURS:
            device.append(item)
    return dict(device=device, host=host, window=window)


def union(intervals, lo: int, hi: int):
    """Merged (start, end) intervals clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(s + d, hi)) for _, s, d in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(trace: dict) -> int:
    lo, hi = trace["window"]
    return sum(e - s for s, e in union(trace["device"], lo, hi))


def gaps(trace: dict):
    """The window's idle intervals: where no device operation runs."""
    lo, hi = trace["window"]
    out, prev = [], lo
    for s, e in union(trace["device"], lo, hi):
        if s > prev:
            out.append((prev, s))
        prev = e
    if hi > prev:
        out.append((prev, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its trailing parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if i > 0 else name
    return name


def device_ops(trace: dict, top: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    acc: dict = {}
    for name, _, d in trace["device"]:
        key = short_name(name)
        acc[key] = acc.get(key, 0) + d
    return [[k, v / 1e9] for k, v in
            sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: dict, top: int = 10, attributed: int = 256):
    """[[what the host was doing, seconds]]: the ``attributed`` longest idle
    gaps, each named by the innermost host event at its middle, summed by
    name; the shorter gaps together as one entry."""
    gs = sorted(gaps(trace), key=lambda g: g[0] - g[1])
    host = [h for h in trace["host"] if h[0] not in _OURS]
    names = np.array([h[0] for h in host], dtype=object)
    start = np.array([h[1] for h in host], dtype=np.int64)
    end = start + np.array([h[2] for h in host], dtype=np.int64)
    acc: dict = {}
    for s, e in gs[:attributed]:
        mid = (s + e) // 2
        cover = np.flatnonzero((start <= mid) & (end >= mid))
        key = ("host between operations" if len(cover) == 0 else
               names[cover[np.argmin(end[cover] - start[cover])]])
        acc[key] = acc.get(key, 0) + (e - s)
    rest = sum(e - s for s, e in gs[attributed:])
    if rest:
        acc[f"{len(gs) - attributed} shorter gaps"] = rest
    out = sorted(acc.items(), key=lambda kv: -kv[1])
    return [[k, v / 1e9] for k, v in out[:top]]


def host_count(trace: dict, names) -> int:
    return sum(1 for h in trace["host"] if h[0] in names)


def device_time_ns(trace: dict, match) -> tuple:
    """(total ns, count) of device operations whose name ``match``es."""
    hits = [d for n, _, d in trace["device"] if match(n)]
    return sum(hits), len(hits)
