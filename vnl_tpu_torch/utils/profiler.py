"""Profiling hooks (PyTorch counterpart of vnl_tpu/utils/profiler.py): a
trace of the host and the device (``trace``), and a recorder of spans and
counters (``recording``), of which ``PhaseTimer`` is a view.

A span is a named interval of the host's clock, ``time.time_ns()`` (the
clock torch.profiler stamps its events with), with its parent and the
training step it began in.  The trainer opens spans at its layers'
boundaries (training/train.py, acting.py, utils/graphs.py); (d) marks a
device span:

  train.step                      one training step; ids from 0 a train()
    train.rollout                 the unrolls and the sync after them
      rollout.control_step   (d)  one control step and its copy into the unroll
      rollout.concat         (d)  the unrolls joined into rows
    train.normalizer         (d)  the observation statistics' update
    train.sgd                     the SGD passes
      sgd.shuffle            (d)  a pass's permutation and gathers
      sgd.update             (d)  one update: copy in, replay, copy out
      sgd.flush              (d)  Adam's subnormal moments set to 0
    train.stats              (d)  the updates' stats stacked
  eval                            Evaluator.run_evaluation
  graph.capture                   a CUDA graph's capture and instantiation

and counts ``graph_nodes`` (each replay adds its graph's node count) and
``graph_nodes.<part>`` (its nodes of each tagged part: ``part``,
utils/graphs.py) by training step.  The device spans of a training step
hold every launch it makes, so where the device runs none of them it is
idle.

Spans are kept only while a ``recording(device)`` is open, and read once it
has closed.  A device span then also records a CUDA timing event on the
current stream as it opens and one as it closes (none while the stream
captures a graph), from a pool made when the recording opens.  The events
are resolved when it closes, onto the host clock by the anchor of the
span's training step: an event recorded just after the synchronisation at
the step's start, with the host time read once it has completed.  On the
CPU, which runs an operation as it is called, a device span's device
interval is its host interval.  While a torch.profiler is active, every
recorded span also opens a ``record_function`` range of its name, so a
``trace()`` file shows the trainer's phases.

With no recording open, ``span`` returns one shared no-op context and
``count`` does nothing; ``timed`` spans (train.step, train.rollout,
train.sgd, eval) read their host times, of which the trainer's logged
seconds are made, and are not kept."""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

# CUDA events a recording makes when it opens: about 47 training steps of
# the twin at 128 envs (698 device spans a step); more are made as needed
EVENT_POOL = 1 << 16


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace"):
    """Captures a torch.profiler trace of the CPU and, where there is one,
    the CUDA device; writes ``<log_dir>/<worker>.<time>.pt.trace.json``,
    which TensorBoard's profiler plugin and Chrome's trace viewer open."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


# the span of a recording that is off
NULL = contextlib.nullcontext()


class Span:
    """One span: ``name``, ``parent`` (the index of the enclosing span in
    its recording, or None), ``step`` (the training step it began in, -1
    before the first), host ``start_ns`` / ``end_ns`` and, for a device
    span of a recording, ``device_start_ns`` / ``device_end_ns`` on the
    host clock once the recording has closed.  ``attrs``: what the span
    carries besides (a graph capture: the graph's name, nodes and pool
    bytes)."""

    __slots__ = ("name", "parent", "step", "start_ns", "end_ns",
                 "device_start_ns", "device_end_ns", "attrs", "_rec",
                 "_device", "_events", "_annotation")

    def __init__(self, rec: Optional["Recording"], name: str,
                 device: bool = False, step: Optional[int] = None):
        self.name, self.step, self._rec, self._device = name, step, rec, device
        self.parent = self.attrs = self._events = self._annotation = None
        self.start_ns = self.end_ns = 0
        self.device_start_ns = self.device_end_ns = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_seconds(self) -> Optional[float]:
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e9

    def __enter__(self) -> "Span":
        if self._rec is None:
            self.start_ns = time.time_ns()
        else:
            self._rec._enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rec is None:
            self.end_ns = time.time_ns()
        else:
            self._rec._exit(self)
        return False


class Recording:
    """Spans and counters of one thread, kept in memory (the module's
    docstring).  ``recording`` opens one for the trainer; a Recording of
    no device (``PhaseTimer``'s) keeps host times alone.  After
    ``close``: ``spans`` in the order they opened, ``counters`` (name ->
    training step -> count), and on a CUDA device ``clock_error_ns``, the
    anchor's error, with ``clock_error_after_s``, the seconds from the
    last anchor to the probe that measured it."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self._cuda = self.device is not None and self.device.type == "cuda"
        self.spans: List[Span] = []
        self.counters: Dict[str, Dict[int, int]] = collections.defaultdict(
            lambda: collections.defaultdict(int))
        self.step = -1
        self.thread = threading.get_ident()
        self.clock_error_ns: Optional[int] = None
        self.clock_error_after_s: Optional[float] = None
        self._stack: List[int] = []
        self._pool: List[torch.cuda.Event] = []
        self._anchor: Optional[Tuple[torch.cuda.Event, int]] = None

    def open(self) -> None:
        """Makes the event pool and the anchor of the steps before the
        first (CUDA only)."""
        if self._cuda:
            self._pool = [torch.cuda.Event(enable_timing=True)
                          for _ in range(EVENT_POOL)]
            stream = torch.cuda.current_stream(self.device)
            for ev in self._pool:         # a CUDA event exists once recorded
                ev.record(stream)
            torch.cuda.synchronize(self.device)
            self._anchor = self._anchor_event()

    def close(self) -> None:
        """Resolves the device spans' events onto the host clock, and
        measures the anchor's error: an event recorded after a
        synchronisation, placed by the last anchor, against the host time
        read once it completed."""
        if not self._cuda:
            return
        torch.cuda.synchronize(self.device)
        probe, host_ns = self._anchor_event()
        torch.cuda.synchronize(self.device)
        self.clock_error_ns = self._on_host(self._anchor, probe) - host_ns
        self.clock_error_after_s = (host_ns - self._anchor[1]) / 1e9
        for s in self.spans:
            if s._events is not None:
                anchor, enter, exit_ = s._events
                s.device_start_ns = self._on_host(anchor, enter)
                s.device_end_ns = self._on_host(anchor, exit_)
                s._events = None
        self._pool, self._anchor = [], None

    @staticmethod
    def _on_host(anchor: Tuple[torch.cuda.Event, int],
                 ev: torch.cuda.Event) -> int:
        return anchor[1] + round(anchor[0].elapsed_time(ev) * 1e6)

    def _event(self) -> torch.cuda.Event:
        ev = self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _anchor_event(self) -> Tuple[torch.cuda.Event, int]:
        """An event on the idle stream and the host time once it has
        completed: the device reaches an event some microseconds after
        the call that records it returns."""
        ev = self._event()
        ev.synchronize()
        return ev, time.time_ns()

    def _enter(self, s: Span) -> None:
        if s.step is not None:                  # a training step begins
            self.step = s.step
            if self._cuda:
                self._anchor = self._anchor_event()
        else:
            s.step = self.step
        s.parent = self._stack[-1] if self._stack else None
        self._stack.append(len(self.spans))
        self.spans.append(s)
        if torch.autograd._profiler_enabled():
            s._annotation = torch.profiler.record_function(s.name)
            s._annotation.__enter__()
        s.start_ns = time.time_ns()
        if s._device and self._cuda and \
                not torch.cuda.is_current_stream_capturing():
            s._events = [self._anchor, self._event(), None]

    def _exit(self, s: Span) -> None:
        if s._events is not None:
            s._events[2] = self._event()
        s.end_ns = time.time_ns()
        if s._device and self.device is not None and not self._cuda:
            s.device_start_ns, s.device_end_ns = s.start_ns, s.end_ns
        if s._annotation is not None:
            s._annotation.__exit__(None, None, None)
            s._annotation = None
        self._stack.pop()

    def summary(self, steps: Iterable[int]) -> Optional[Dict]:
        """The training steps ``steps`` (their ids) as one window, from the
        first one's start to the last one's end: its seconds, the device's
        busy and idle seconds in it, and, per span name, by training step,
        the spans of those steps (``count``), their host seconds
        (``host_s``) and device seconds (``device_s``, device spans), and
        the idle seconds put down to the name (``idle_s``): each gap
        between busy intervals goes to the innermost span open on the host
        at its middle ("(no span)" where none was); a span of those steps
        that began after the window (an evaluation after the last) is left
        out.  Also the ten longest gaps with their owners
        (``longest_gaps``), the counters of those steps, the host seconds
        of the spans that ended before the window (``before_s``) and the
        anchor's error.  None where no ``train.step`` of ``steps`` was
        recorded."""
        steps = set(steps)
        whole = [s for s in self.spans
                 if s.name == "train.step" and s.step in steps]
        if not whole:
            return None
        k = len(whole)
        start = min(s.start_ns for s in whole)
        end = max(s.end_ns for s in whole)
        busy = busy_intervals(self.spans, start, end)
        gaps = idle_gaps(busy, start, end)
        owners = gap_owners(self.spans, gaps)
        idle_by: Dict[str, int] = collections.Counter()
        for (s, e), name in zip(gaps, owners):
            idle_by[name] += e - s
        longest = sorted(((e - s) / 1e9, name)
                         for (s, e), name in zip(gaps, owners))[-10:]
        by_span: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            if s.step not in steps or s.start_ns >= end:
                continue
            row = by_span.setdefault(s.name, {"count": 0.0, "host_s": 0.0})
            row["count"] += 1 / k
            row["host_s"] += s.seconds / k
            if s.device_start_ns is not None:
                row["device_s"] = row.get("device_s", 0.0) + \
                    s.device_seconds / k
        for name, ns in idle_by.items():
            by_span.setdefault(name, {"count": 0.0, "host_s": 0.0})
            by_span[name]["idle_s"] = ns / 1e9 / k
        before: Dict[str, float] = collections.Counter()
        for s in self.spans:
            if s.end_ns <= start:
                before[s.name] += s.seconds
        busy_ns = sum(e - s for s, e in busy)
        return {
            "steps": sorted(s.step for s in whole),
            "window_s": (end - start) / 1e9,
            "busy_s": busy_ns / 1e9,
            "idle_s": (end - start - busy_ns) / 1e9,
            "by_span": by_span,
            "longest_gaps": [[name, sec] for sec, name in reversed(longest)],
            "counters": {name: [by_step.get(n, 0) for n in sorted(steps)]
                         for name, by_step in self.counters.items()},
            "before_s": dict(before),
            "clock_error_us": None if self.clock_error_ns is None
            else self.clock_error_ns / 1e3,
            "clock_error_after_s": self.clock_error_after_s,
        }


def busy_intervals(spans: Iterable[Span], start: int,
                   end: int) -> List[Tuple[int, int]]:
    """The union of the spans' device intervals within [start, end], in
    order (overlapping intervals count once)."""
    cut = sorted((max(s.device_start_ns, start), min(s.device_end_ns, end))
                 for s in spans if s.device_start_ns is not None)
    merged: List[List[int]] = []
    for s, e in cut:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_gaps(busy: List[Tuple[int, int]], start: int,
              end: int) -> List[Tuple[int, int]]:
    """The stretches of [start, end] outside the ordered, disjoint
    intervals ``busy``."""
    gaps, at = [], start
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if end > at:
        gaps.append((at, end))
    return gaps


def gap_owners(spans: Iterable[Span],
               gaps: List[Tuple[int, int]]) -> List[str]:
    """For each of the ordered ``gaps``, the name of the innermost span
    open on the host at its middle ("(no span)" where none was).  The
    spans are one thread's, so they nest."""
    ordered = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    out: List[str] = []
    stack: List[Span] = []
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(ordered) and ordered[i].start_ns <= mid:
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1].end_ns < mid:     # nested: the top
            stack.pop()                            # ends first
        out.append(stack[-1].name if stack else "(no span)")
    return out


_active: Optional[Recording] = None


@contextlib.contextmanager
def recording(device=None):
    """Records the spans and counters of the calling thread while open
    (one recording at a time); yields the Recording, to be read after the
    block.  ``device``: where device spans record their events (a CUDA
    device), or the CPU."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is open already")
    rec = Recording("cpu" if device is None else device)
    rec.open()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec.close()


def _recorder() -> Optional[Recording]:
    rec = _active
    if rec is None or rec.thread != threading.get_ident():
        return None
    return rec


def span(name: str, device: bool = False):
    """A span of the open recording, or the shared no-op context."""
    rec = _recorder()
    return NULL if rec is None else Span(rec, name, device)


def timed(name: str, step: Optional[int] = None) -> Span:
    """A span that reads its host times (``seconds``) whether or not a
    recording is open; recorded where one is.  Given ``step``, it begins
    that training step: entered just after the synchronisation at the
    step's start, it records the step's anchor on an idle stream."""
    return Span(_recorder(), name, False, step)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` of the current training step."""
    rec = _recorder()
    if rec is not None:
        rec.counters[name][rec.step] += n


class PartCounts:
    """The count ``read()`` has grown by inside each tagged part (``part``):
    a capture's graph nodes (utils/graphs.py), or what a caller counts."""

    def __init__(self, read: Callable[[], int]):
        self.read = read
        self.stack: List[str] = []
        self.counts: Dict[str, int] = collections.Counter()
        self.outside = 0            # grown outside every part
        self._at = read()

    def mark(self) -> None:
        """Puts what the count grew by since the last mark down to the
        innermost part open."""
        n = self.read()
        if self.stack:
            self.counts[self.stack[-1]] += n - self._at
        else:
            self.outside += n - self._at
        self._at = n


# the PartCounts of each thread's ``parts_counted`` block: the tags of
# another thread (a render job's) neither count nor read the capture
_parts = threading.local()


@contextlib.contextmanager
def parts_counted(read: Callable[[], int]):
    """Counts ``read()`` by part (``part``) inside the block, on the
    calling thread; yields the PartCounts."""
    if getattr(_parts, "counts", None) is not None:
        raise RuntimeError("parts are counted already")
    _parts.counts = counts = PartCounts(read)
    try:
        yield counts
        counts.mark()
    finally:
        _parts.counts = None


class part:
    """``with part(name):`` tags the work inside as part ``name`` of the
    control step: a ``parts_counted`` block of the calling thread counts
    what it adds, and while a torch.profiler is active it is a
    ``record_function`` range ``part.<name>``, whose device time a trace
    of an eager step gives (a graph's replay has no ranges).  Nothing
    otherwise."""

    __slots__ = ("name", "_counts", "_annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._counts = getattr(_parts, "counts", None)
        if self._counts is not None:
            self._counts.mark()
            self._counts.stack.append(self.name)
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(
                "part." + self.name)
            self._annotation.__enter__()

    def __exit__(self, *exc) -> bool:
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        if self._counts is not None:
            self._counts.mark()
            self._counts.stack.pop()
        return False


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class PhaseTimer:
    """Per-phase wall-clock accounting (rollout vs SGD vs eval): a view of
    a host-only Recording of its own, one span a phase."""

    def __init__(self):
        self.recording = Recording()

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Times the block; with ``block_on`` (a tensor or a nest of them)
        it first waits for the CUDA devices those tensors live on, since
        PyTorch returns before the device finishes."""
        with Span(self.recording, name):
            yield
            if block_on is not None:
                for dev in {t.device for t in _tensors(block_on)}:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)

    @property
    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.recording.spans:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    @property
    def counts(self) -> Dict[str, int]:
        return dict(collections.Counter(s.name
                                        for s in self.recording.spans))

    def summary(self) -> Dict[str, float]:
        counts = self.counts
        return {f"profile/{k}_ms": 1e3 * v / max(counts[k], 1)
                for k, v in self.totals.items()}
