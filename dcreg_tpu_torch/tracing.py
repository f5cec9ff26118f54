"""Spans inside the port's loops, an in-memory recorder, and the exporters
that split a profile of the loops by the program's own modules.

* ``span(name, **args)`` marks a layer boundary on the host.  Under an
  active ``torch.profiler`` it is a ``record_function`` labelled
  ``name(k=v, ...)``, so its host events sit on the profiler's clock
  beside the device's; inside ``record()`` it appends ``[name, parent,
  t0_ns, t1_ns, args]`` to the recorder (``parent``: the index of the
  enclosing span, -1 at the top).  Otherwise it costs one flag check: no
  device op, no device allocation, no host read.
* ``calls(name, **derived)`` makes each call of a function such a span,
  with the call's sequence number and args derived from the call's
  arguments (``odometry.call`` on ``run_odometry_map``;
  ``odometry.fleet_call`` on ``run_odometry_fleet``, with ``sensors``).
* ``replay(graph, **args)`` replays a captured graph under a
  ``graphs.replay`` span; inside ``record()`` two CUDA events of the
  recorder's pool bracket it on the replay's stream.
* ``module_times(prof)`` splits the device operations of each replay in a
  profile by the module table its part recorded at capture
  (``graphs.mark``); ``idle_gaps(prof)`` puts the device's idle gaps down
  to the innermost program span that was open in them.

Nothing here turns itself on: no environment variable, option or
configuration field.  Tracing runs only inside ``record()`` or under a
profiler.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import time
import weakref

import torch
from torch.autograd import profiler as _profiler

# the recorder of the ``record()`` block in progress, if any
_RECORDER = None
_OFF = contextlib.nullcontext()
# the live captured configurations (``graphs.Graphs``) by their serial
# number, whose ``label``, ``nodes`` and ``modules`` ``module_times`` reads
GRAPHS = weakref.WeakValueDictionary()
# CUDA event pairs of a ``record()`` block: the replays it can time
POOL = 4096
REPLAY = "graphs.replay"
UNMARKED = "(unmarked)"


def label(name: str, args: dict) -> str:
    """A span's label under the profiler: ``name(k=v, ...)``."""
    if not args:
        return name
    return f"{name}({', '.join(f'{k}={v}' for k, v in args.items())})"


def parse(text: str) -> tuple:
    """(name, args) of a span's profiler label; args' values as text."""
    name, _, rest = text.partition("(")
    args = {}
    for item in rest.rstrip(")").split(", ") if rest else ():
        k, _, v = item.partition("=")
        args[k] = v
    return name, args


class _Span:
    __slots__ = ("name", "args", "fn", "rec", "index")

    def __init__(self, name, args):
        self.name, self.args, self.fn, self.rec = name, args, None, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.fn = _profiler.record_function(label(self.name, self.args))
            self.fn.__enter__()
        self.rec = _RECORDER
        if self.rec is not None:
            self.index = self.rec.open(self.name, self.args)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.close(self.index)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str, **args):
    """A span named ``name`` with ``args`` over a block (see the module's
    docstring)."""
    if _RECORDER is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def calls(name: str, **derived):
    """Make each call of the decorated function a span ``name`` whose
    ``call`` arg is the call's sequence number, from 0, and each arg of
    ``derived`` the value its function gives of the call's arguments."""
    def wrap(fn):
        seq = itertools.count()

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            extra = {k: f(*args, **kwargs) for k, f in derived.items()}
            with span(name, call=next(seq), **extra):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def replay(graph, **args) -> None:
    """``graph.replay()`` under a ``graphs.replay`` span with ``args``;
    inside ``record()`` bracketed on the current stream by two events of
    the recorder's pool."""
    if _RECORDER is None and not _profiler._is_profiler_enabled:
        graph.replay()
        return
    with _Span(REPLAY, args) as s:
        pair = s.rec.events(s.index) if s.rec is not None else None
        if pair is not None:
            pair[0].record()
        graph.replay()
        if pair is not None:
            pair[1].record()


class Recorder:
    """What one ``record()`` block recorded.

    ``spans``: [name, parent, t0_ns, t1_ns, args] in the order they
    opened; ``replays``: (span index, device seconds) of each replay the
    pool's events timed, in order; ``untimed``: replays past the pool;
    ``wall_s``: the block's wall, from a synchronised device at entry to
    the block's final synchronize."""

    def __init__(self):
        self.spans, self.replays, self.untimed = [], [], 0
        self.wall_s = 0.0
        self._stack, self._timed = [], []
        self._pool = []
        if torch.cuda.is_available():
            self._pool = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(POOL)]

    def open(self, name, args) -> int:
        parent = self._stack[-1] if self._stack else -1
        self.spans.append([name, parent, time.perf_counter_ns(), None,
                           args])
        self._stack.append(len(self.spans) - 1)
        return self._stack[-1]

    def close(self, index) -> None:
        self.spans[index][3] = time.perf_counter_ns()
        self._stack.pop()

    def events(self, index):
        """The next (start, end) pair of the pool for the replay span
        ``index``, or None once the pool is spent."""
        if len(self._timed) == len(self._pool):
            self.untimed += 1
            return None
        pair = self._pool[len(self._timed)]
        self._timed.append((index, *pair))
        return pair

    def _finish(self) -> None:
        self.replays = [(i, s.elapsed_time(e) * 1e-3)
                        for i, s, e in self._timed]
        self._pool = self._timed = None

    def seconds(self, name: str) -> float:
        """Host seconds in the spans named ``name``."""
        return sum(s[3] - s[2] for s in self.spans if s[0] == name) * 1e-9

    def self_seconds(self, name: str, inner=()) -> float:
        """Host seconds in the spans named ``name``, less those of the
        spans named in ``inner`` that open inside them."""
        total = self.seconds(name)
        for s in self.spans:
            if s[0] in inner and self._under(s, name):
                total -= (s[3] - s[2]) * 1e-9
        return total

    def _under(self, s, name) -> bool:
        p = s[1]
        while p >= 0:
            if self.spans[p][0] == name:
                return True
            p = self.spans[p][1]
        return False

    def replay_device_seconds(self) -> float:
        """Device seconds between each timed replay's two events."""
        return sum(sec for _, sec in self.replays)


@contextlib.contextmanager
def record():
    """Record spans, and the device interval of up to ``POOL`` graph
    replays by CUDA events, over a block; yields the ``Recorder``, whose
    replay times and wall are read after the block's final synchronize.
    A replay's interval runs from the moment its stream reaches the start
    event: where the device waited for the host, it includes the graph's
    launch, so the intervals' sum is an upper bound on the device's busy
    time in them."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("record() blocks do not nest")
    rec = Recorder()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None
        if cuda:
            torch.cuda.synchronize()
        rec.wall_s = time.perf_counter() - t0
        rec._finish()


# --------------------------------------------------------------------------
# exporters over a torch.profiler profile
# --------------------------------------------------------------------------

def events(prof):
    """(host, device) events of a ``torch.profiler`` (or autograd
    profiler) profile: (name, start_ns, end_ns, correlation id, is a user
    annotation) on the host; (name, start_ns, end_ns, correlation id) of
    every operation on the device (kernels, copies, sets)."""
    from torch.autograd import DeviceType
    res = getattr(prof, "profiler", prof).kineto_results
    host, dev = [], []
    for e in res.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row + (e.is_user_annotation(),))
    host.sort(key=lambda h: h[1])
    dev.sort(key=lambda d: d[1])
    return host, dev


def split_replays(host, dev, graphs) -> dict:
    """Device time of ``dev`` by replayed part and module.

    Each ``cudaGraphLaunch`` on the host inside a ``graphs.replay`` span
    takes the device operations of its correlation id, in start order;
    where the span's ``graphs`` arg names a configuration of ``graphs``
    (serial number: an object with ``label``, ``nodes`` {part: device ops
    at capture} and ``modules`` {part: [(module, first op, end op)]}) and
    the count equals the part's ``nodes``, the i-th is put down to the
    module whose range holds i (the innermost mark), else the replay is
    returned as unattributed.  Returns {"parts":
    {"<label>.<part>": {"replays", "seconds", "ops",
    "modules": {module: {"seconds", "ops"}}}}, "unattributed": {"replays",
    "seconds", "ops"}, "eager": {"seconds", "ops"} (device operations of
    no replay), "device": {"seconds", "ops"} (all of them)}."""
    spans = [h for h in host if h[4] and h[0].startswith(REPLAY + "(")]
    starts = [s[1] for s in spans]
    launches = {}
    for h in host:
        if not h[4] and h[0].startswith("cudaGraphLaunch"):
            s = _innermost_open(spans, starts, h[1])
            if s is not None:
                launches[h[3]] = parse(s[0])[1]
    by_launch = {}
    eager = [0.0, 0]
    for d in dev:
        if d[3] in launches:
            by_launch.setdefault(d[3], []).append(d)
        else:
            eager[0] += (d[2] - d[1]) * 1e-9
            eager[1] += 1
    parts, lost, labels = {}, [0, 0.0, 0], {}
    for corr, args in launches.items():
        ops = by_launch.get(corr, [])
        secs = sum(d[2] - d[1] for d in ops) * 1e-9
        g = graphs.get(_int(args.get("graphs")))
        part = args.get("part")
        if g is None or len(ops) != g.nodes.get(part):
            lost[0] += 1
            lost[1] += secs
            lost[2] += len(ops)
            continue
        key = f"{g.label}.{part}"
        p = parts.setdefault(key, {"replays": 0, "seconds": 0.0, "ops": 0,
                                   "modules": {}})
        p["replays"] += 1
        p["seconds"] += secs
        p["ops"] += len(ops)
        lab = labels.get((id(g), part))
        if lab is None:
            lab = labels[(id(g), part)] = _op_modules(
                g.nodes[part], g.modules.get(part, ()))
        for d, m in zip(ops, lab):
            mm = p["modules"].setdefault(m, {"seconds": 0.0, "ops": 0})
            mm["seconds"] += (d[2] - d[1]) * 1e-9
            mm["ops"] += 1
    total = sum(d[2] - d[1] for d in dev) * 1e-9
    return {"parts": parts,
            "unattributed": {"replays": lost[0], "seconds": lost[1],
                             "ops": lost[2]},
            "eager": {"seconds": eager[0], "ops": eager[1]},
            "device": {"seconds": total, "ops": len(dev)}}


def _int(text):
    try:
        return int(text)
    except (TypeError, ValueError):
        return None


def _op_modules(n: int, modules) -> list:
    """The module of each of a part's ``n`` device ops: the innermost mark
    (the last opened) whose range holds it, else ``UNMARKED``."""
    out = [UNMARKED] * n
    for name, first, end in modules:
        out[first:end] = [name] * (end - first)
    return out


def module_times(prof) -> dict:
    """``split_replays`` over a profile of the loops, by the module tables
    of the live configurations (``GRAPHS``): device seconds and operation
    counts per part and module, the replays it could not attribute, and
    the eager operations outside replays."""
    host, dev = events(prof)
    return split_replays(host, dev, GRAPHS)


def idle_gaps(prof) -> dict:
    """Seconds of the device's idle gaps in a profile by the innermost
    program span (a ``span``'s name, its args dropped) open at the middle
    of each gap; "(no program span)" where none was."""
    host, dev = events(prof)
    spans = [h for h in host if h[4]]
    starts = [s[1] for s in spans]
    out, end = {}, None
    for _, s, e, _ in dev:
        if end is not None and s > end:
            inner = _innermost_open(spans, starts, 0.5 * (s + end))
            name = parse(inner[0])[0] if inner else "(no program span)"
            out[name] = out.get(name, 0.0) + (s - end) * 1e-9
        end = e if end is None else max(end, e)
    return out


def _innermost_open(spans, starts, t):
    """The span of ``spans`` (sorted by start) open at ``t`` that opened
    last."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[j][2] >= t:
            return spans[j]
    return None
