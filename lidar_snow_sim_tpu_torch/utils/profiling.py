"""The port's tracer: spans at the layer boundaries of the snowfall path, recorded only while a torch.profiler session runs; and
`device_trace`, a session that writes a Chrome trace.

`span(name, frame=None)` opens a span. With no profiler session running it
returns one shared no-op context after a single flag check
(`torch.autograd.profiler._is_profiler_enabled`, which every session sets,
CUDA-only ones included), so the untraced path pays that check alone.
While a session runs, each span is kept in memory as one row (name,
request id, parent row, frame index, start and end from `time.time_ns()`,
host syncs) and is also opened as `torch.profiler.record_function(name)`,
so a CPU+CUDA Chrome trace shows it on the kernels' timeline. The trace's
`ts + baseTimeNanoseconds / 1000` is `time.time_ns() / 1000`, so a span's
bounds and the trace's records share one clock (`idle_by_span` uses that).

- The outermost span of a call starts a new request id; every span under
  it carries that id. A span with no frame takes its parent's.
- Host syncs: while a root span records on an initialised card, the CUDA
  sync debug mode is "warn" and its warnings are caught and counted, never
  shown: each synchronizing call (`.item()`, `int()` or `.cpu()` of a card
  tensor, a 0-dim index, `nonzero`, a boolean mask, a blocking copy) is
  charged to the innermost span open on its thread. The mode and the
  warning filters are put back when the root span closes, so an untraced
  run never touches them.
- The buffer holds one profiler session: it is cleared as the next one
  starts (the tracer chains onto torch's session-start hook at import, and
  the import fails on a torch that lacks the hook).
- `recorded()` returns the closed spans; `self_ns(span)` a span's duration
  less the time its child spans cover.

Usage:
    with device_trace("/tmp/trace"):
        with span("augment"):
            step(batch)
    ms = {s.name: self_ns(s) / 1e6 for s in recorded()}
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

# the text of the warning CUDA's sync debug mode raises at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"


class Span(NamedTuple):
    """One recorded span. `id` and `parent` index the session's spans in
    the order they opened (parent None for a root); times in ns on
    `time.time_ns()`'s clock; `child_ns` the time its direct children
    cover."""

    id: int
    name: str
    request: int
    parent: int | None
    frame: int | None
    start_ns: int
    end_ns: int
    host_syncs: int
    child_ns: int


class _Tracer:
    """The process's span rows of the current session. A row: [id, name,
    request, parent id, frame, start, end, host syncs]."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = itertools.count()
        self._roots_open = 0
        self._sync_restore = None
        self.clear()

    def clear(self):
        self.rows = []

    def stack(self) -> list:
        """This thread's open rows, innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def charge_sync(self):
        st = self.stack()
        if st:
            st[-1][7] += 1

    def root_opened(self):
        with self._lock:
            self._roots_open += 1
            if self._roots_open == 1 and torch.cuda.is_initialized():
                self._sync_restore = _count_syncs(self.charge_sync)

    def root_closed(self):
        with self._lock:
            self._roots_open -= 1
            if self._roots_open == 0 and self._sync_restore is not None:
                self._sync_restore()
                self._sync_restore = None


_TRACER = _Tracer()


def _count_syncs(charge):
    """Sets the CUDA sync debug mode to "warn" and counts its warnings
    with `charge()` in place of showing them; returns the function that
    puts the mode and the warning filters back."""
    caught = warnings.catch_warnings()
    caught.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    show = warnings.showwarning

    def counted(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            charge()
        else:
            show(message, category, filename, lineno, file, line)

    warnings.showwarning = counted
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")

    def restore():
        torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)

    return restore


class _Span:
    __slots__ = ("name", "frame", "row", "root", "rf")

    def __init__(self, name: str, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        tr, rows = _TRACER, _TRACER.rows
        st = tr.stack()
        up = st[-1] if st else None
        if up is not None and (up[0] >= len(rows) or rows[up[0]] is not up):
            up = None   # opened before this session: the span is its root
        self.root = up is None
        if self.root:
            request, parent, frame = next(tr._requests), None, self.frame
            tr.root_opened()
        else:
            request, parent = up[2], up[0]
            frame = up[4] if self.frame is None else self.frame
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.row = [len(rows), self.name, request, parent, frame,
                    time.time_ns(), None, 0]
        rows.append(self.row)
        st.append(self.row)
        return self

    def __exit__(self, *exc):
        # stamped after record_function's enter and exit: each takes its
        # own timestamp early, so the span's bounds match its event's
        self.rf.__exit__(*exc)
        self.row[6] = time.time_ns()
        _TRACER.stack().pop()
        if self.root:
            _TRACER.root_closed()
        return False


_NOOP = contextlib.nullcontext()


def span(name: str, frame: int | None = None):
    """A span named `name` (of frame `frame` in a batch) around a `with`
    block: recorded while a torch.profiler session runs, else a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, frame)


def recorded() -> list:
    """The closed spans of the current or last session, in the order they
    opened."""
    rows = _TRACER.rows
    child = defaultdict(int)
    for r in rows:
        if r[3] is not None and r[6] is not None:
            child[r[3]] += r[6] - r[5]
    return [Span(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], child[r[0]])
            for r in rows if r[6] is not None]


def self_ns(s: Span) -> int:
    """The span's duration less the time its child spans cover."""
    return s.end_ns - s.start_ns - s.child_ns


def _chain_session_start():
    """Clear the buffer as each profiler session starts: every torch
    session calls `torch.autograd.profiler._run_on_profiler_start`. A torch
    without that hook raises here: the buffer would grow with each session
    and mix their spans."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if start is None:
        raise ImportError(
            "torch.autograd.profiler._run_on_profiler_start is missing: the "
            "tracer cannot tell one profiler session from the next")
    if getattr(start, "clears_tracer", False):
        return

    def run_on_profiler_start():
        _TRACER.clear()
        start()

    run_on_profiler_start.clears_tracer = True
    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


_chain_session_start()


def idle_by_span(busy_ns, spans) -> dict:
    """{span name: ns}: the time between the first and the last device
    record in which the card ran nothing, put down to the innermost span
    open at each moment ("(no span)" where none was). `busy_ns` is the
    device records' [(start, end)] on `time.time_ns()`'s clock, `spans`
    `recorded()`."""
    if not busy_ns:
        return {}
    gaps, reach = [], None
    for s, e in sorted(busy_ns):
        if reach is not None and s > reach:
            gaps.append((reach, s))
        reach = e if reach is None else max(reach, e)
    # the innermost span over time: segments (t0, t1, name)
    spans = [s for s in spans if s.end_ns > s.start_ns]
    events = sorted([(s.end_ns, 0, s.id) for s in spans]
                    + [(s.start_ns, 1, s.id) for s in spans])
    names = {s.id: s.name for s in spans}
    segs, open_, prev = [], [], None
    for t, opens, i in events:
        if prev is not None and t > prev:
            segs.append((prev, t, names[open_[-1]] if open_ else None))
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
        prev = t
    out = defaultdict(int)
    k = 0
    for g0, g1 in gaps:
        covered = 0
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            ov = min(g1, segs[j][1]) - max(g0, segs[j][0])
            if ov > 0 and segs[j][2] is not None:
                out[segs[j][2]] += ov
                covered += ov
            j += 1
        if g1 - g0 > covered:
            out["(no span)"] += g1 - g0 - covered
    return dict(out)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the block, written as a Chrome trace
    `log_dir/trace_<time>.json`: the CPU's activity and, where there is a
    card, the card's. A failure to start, stop or write the trace
    raises."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))
