"""The program's own spans in a trace: its ``icp.`` ranges
(``utils/profiling.annotate``: host events on the profiler's clock, which
they share with the device events), and the window's idle time and host
synchronises split by the innermost span open at each instant.

The split is exact, not by a gap's midpoint: the spans nest on the
calling thread, so a sweep over their starts and ends gives the innermost
open span of every instant as sorted disjoint pieces, and a merge of
those with the window's sorted gaps (``tracing.gaps``) cuts each gap at
the pieces' edges.  Idle time and synchronises under no ``icp.`` span are
the harness's: its loop, its synchronise and the wake-up after it.
"""

from __future__ import annotations

from bisect import bisect_right

from bench_port import tracing
from bench_port.metrics.host_syncs_per_call import SYNCS

PREFIX = "icp."
OUTSIDE = None  # the key of the time no icp. span covers


def pieces(trace: dict):
    """[(start, end, name)]: sorted disjoint pieces of time, each under
    ``name``, the innermost ``icp.`` span open there; time under no span is
    in no piece."""
    spans = sorted(((s, s + d, n) for n, s, d in trace["host"]
                    if n.startswith(PREFIX)),
                   key=lambda x: (x[0], -x[1]))  # a parent before its child
    out, stack, t = [], [], 0

    def upto(end):
        nonlocal t
        if stack and end > t:
            out.append((t, end, stack[-1][1]))
        t = max(t, end)

    for s, e, name in spans:
        while stack and stack[-1][0] <= s:
            upto(stack[-1][0])
            stack.pop()
        upto(s)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    return out


def idle_ns(trace: dict, ps) -> dict:
    """{innermost span name, or OUTSIDE: idle ns of the window under it},
    from the trace's ``pieces`` ``ps``."""
    acc: dict = {}
    gs = tracing.gaps(trace)
    i = j = 0
    while i < len(gs) and j < len(ps):
        (gs_, ge), (ps_, pe, name) = gs[i], ps[j]
        lo, hi = max(gs_, ps_), min(ge, pe)
        if hi > lo:
            acc[name] = acc.get(name, 0) + hi - lo
        if ge <= pe:
            i += 1
        else:
            j += 1
    acc[OUTSIDE] = sum(e - s for s, e in gs) - sum(acc.values())
    return acc


def syncs(trace: dict, ps) -> dict:
    """{innermost span name, or OUTSIDE: the host synchronises (``SYNCS``,
    ``host_syncs_per_call``'s) that start under it}, from the trace's
    ``pieces`` ``ps``."""
    starts = [p[0] for p in ps]
    acc: dict = {}
    for n, s, _ in trace["host"]:
        if n in SYNCS:
            k = bisect_right(starts, s) - 1
            name = ps[k][2] if k >= 0 and s < ps[k][1] else OUTSIDE
            acc[name] = acc.get(name, 0) + 1
    return acc


def _pieces_with(trace: dict, name):
    """The trace's pieces, or None where it holds no ``icp.`` span, or
    none named ``name`` (OUTSIDE: any)."""
    ps = pieces(trace)
    if not ps or (name is not OUTSIDE and all(p[2] != name for p in ps)):
        return None
    return ps


def idle_share(run, name):
    """The window's idle time under ``name`` innermost (OUTSIDE: under no
    ``icp.`` span), over the window; None where the trace holds no device
    operation or no such span."""
    tr = run["trace"]
    if tr is None or not tr["device"]:
        return None
    ps = _pieces_with(tr, name)
    if ps is None:
        return None
    lo, hi = tr["window"]
    return idle_ns(tr, ps).get(name, 0) / (hi - lo)


def syncs_per_call(run, name):
    """The host synchronises that start under ``name`` innermost, per
    traced call; None where the trace holds no runtime events or no such
    span."""
    tr = run["trace"]
    if tr is None:
        return None
    ps = _pieces_with(tr, name)
    if ps is None:
        return None
    acc = syncs(tr, ps)
    if sum(acc.values()) < run["calls"]:  # no runtime events
        return None
    return acc.get(name, 0) / run["calls"]
