"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` over the
compiled loops (``dcreg_tpu/utils/__init__.py``'s ``precise_jit``, and the
``lax.while_loop`` / ``lax.scan`` it wraps).

A compiled loop is split into named parts (prologue, step, epilogue) that
read and write a ``State`` of fixed tensors in place.  On the card each
part is captured once into a ``torch.cuda.CUDAGraph`` after an eager
warm-up on a side stream (which also loads the kernel libraries), and
every later call of the same statics replays the graphs: one
``cudaGraphLaunch`` per part in place of the part's hundreds of kernel
launches.  The host still reads one done flag per step, as the JAX
``while_loop``'s condition does.  ``GraphCache`` keys the captures on
their statics, including the address and layout of every tensor a graph
reads in place (a second index of the same shapes gets graphs of its
own), and keeps a few of them, least recently used first out.

On the CPU the same parts run eagerly (``run_eager``); nothing falls
back from a graph to eager execution: a capture error raises, naming the
part.

Kernel launches inside a capture are not launches: the wrappers report
them through ``note_launch``, which tallies them into the capture, and
each replay adds the tally to the wrappers' counters, so ``launches``
counts what the card ran (and ``launches_replayed`` the part of it that
came from replays).

Likewise a profiler range inside a part would run once, at capture, and
never at a replay.  So a part names its modules with ``mark``: at every
capture, traced or not, each mark records the range of the part's device
operations (kernel, copy and set nodes, in capture order) that its block
created, in ``Graphs.modules[part]`` beside ``Graphs.nodes[part]``; a
single-stream capture replays its nodes in that order, so
``tracing.module_times`` can split a profiled replay by the table.  A mark
adds no node and reads nothing from the device.  Outside a capture it is
a ``tracing.span``.  ``bind``, each replay and each read of the done flag
in ``drive`` are spans too (``graphs.bind``, ``graphs.replay``,
``graphs.done_read``), and ``STATS.host_reads`` counts the reads.

Every loop class (``BatchLoop``, ``MapLoop``, ``PairLoop``,
``EulerLoop``, ``VoxelLoop``, ``XICPLoop``, ``O3DLoop``,
``SuperLocLoop``, ``PoseGraphLoop``, ``ShardedLoop``) has ``key()`` and
``parts(state)``; ``bind`` gives the runner of its parts and their
state, and ``drive`` runs one pass of the loop (a loop with no ``step``
part, as ``SuperLocLoop``, runs with ``max_iterations`` 0);
``drive_lanes`` runs a loop of independent lanes (a fleet's ``MapLoop``).  A loop
whose parts hold collectives captures in ``capture_error_mode``
"thread_local" (``ShardedLoop``).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import itertools
import time

import torch

from . import tracing

# the captures in progress (``Capture``, innermost last)
_RECORDING: list = []
_SERIALS = itertools.count()


@dataclasses.dataclass
class Stats:
    host_reads: int = 0          # reads of the done flag in ``drive``


STATS = Stats()


def _bump(wrapper, kk, n: int, replayed: bool = False) -> None:
    wrapper.launches += n
    if replayed:
        wrapper.launches_replayed = getattr(wrapper, "launches_replayed",
                                            0) + n
    if kk is not None:
        by_kk = wrapper.launches_by_kk
        by_kk[kk] = by_kk.get(kk, 0) + n


def note_launch(wrapper, kk=None) -> None:
    """Count one launch of a kernel ``wrapper`` (its ``launches``, and
    ``launches_by_kk[kk]`` where ``kk`` is given).  Under a capture the
    launch goes into the graph's tally instead; each replay counts it."""
    if _RECORDING:
        _RECORDING[-1][(wrapper, kk)] += 1
    else:
        _bump(wrapper, kk, 1)


class _Driver:
    """The CUDA driver's capture queries, through ctypes."""

    OPS = (0, 1, 2)            # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    ACTIVE = 1                 # CU_STREAM_CAPTURE_STATUS_ACTIVE

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        p = ctypes.POINTER
        self.info = lib.cuStreamGetCaptureInfo_v2
        self.info.argtypes = [ctypes.c_void_p, p(ctypes.c_int),
                              p(ctypes.c_uint64), p(ctypes.c_void_p),
                              p(ctypes.c_void_p), p(ctypes.c_size_t)]
        self.nodes = lib.cuGraphGetNodes
        self.nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               p(ctypes.c_size_t)]
        self.kind = lib.cuGraphNodeGetType
        self.kind.argtypes = [ctypes.c_void_p, p(ctypes.c_int)]
        for fn in (self.info, self.nodes, self.kind):
            fn.restype = ctypes.c_int                     # CUresult

    @staticmethod
    def check(err, what) -> None:
        if err:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    def capture_nodes(self) -> list:
        """The nodes of the graph the current stream is capturing."""
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        self.check(self.info(torch.cuda.current_stream().cuda_stream,
                             ctypes.byref(status), None,
                             ctypes.byref(graph), None, None),
                   "cuStreamGetCaptureInfo_v2")
        if status.value != self.ACTIVE:
            raise RuntimeError("graphs.mark: the current stream is not "
                               "capturing")
        n = ctypes.c_size_t()
        self.check(self.nodes(graph, None, ctypes.byref(n)),
                   "cuGraphGetNodes")
        if not n.value:
            return []
        out = (ctypes.c_void_p * n.value)()
        self.check(self.nodes(graph, out, ctypes.byref(n)),
                   "cuGraphGetNodes")
        return list(out[:n.value])

    def is_op(self, node) -> bool:
        kind = ctypes.c_int()
        self.check(self.kind(ctypes.c_void_p(node), ctypes.byref(kind)),
                   "cuGraphNodeGetType")
        return kind.value in self.OPS


@functools.cache
def _driver() -> _Driver:
    return _Driver()


class Capture(collections.Counter):
    """One part's capture in progress: the kernel launches its wrappers
    made, by (wrapper, kk) (``note_launch``), and its marks, ``modules``
    [(name, first, end)] over the part's device operations in capture
    order, in the order the marks opened."""

    def __init__(self):
        super().__init__()
        self.modules, self._seen, self._ops = [], set(), 0

    def ops(self) -> int:
        """Device operations (kernel, copy and set nodes) captured so
        far; nodes are only ever added to a graph under capture."""
        for node in set(_driver().capture_nodes()) - self._seen:
            self._seen.add(node)
            self._ops += _driver().is_op(node)
        return self._ops


@contextlib.contextmanager
def _marked(cap: Capture, name: str):
    # no ``finally``: a capture that fails inside the block is over, and
    # its error is the one to raise
    entry = [name, cap.ops(), 0]
    cap.modules.append(entry)
    yield
    entry[2] = cap.ops()


def mark(name: str):
    """A module of a compiled part over a block: under a ``Graphs``
    capture, the range of device operations its block captured goes into
    the part's module table; elsewhere a ``tracing.span``."""
    if not _RECORDING:
        return tracing.span(name)
    return _marked(_RECORDING[-1], name)


class State:
    """The fixed tensors a compiled loop's parts share.  ``put`` creates
    a slot from a copy of its first value and afterwards copies into it,
    so the slot keeps its storage (a captured graph reads and writes it
    there) and never aliases a caller's tensor."""

    def put(self, name: str, value: torch.Tensor) -> None:
        slot = self.__dict__.get(name)
        if slot is None:
            self.__dict__[name] = value.clone()
            return
        if slot.shape != value.shape or slot.dtype != value.dtype:
            raise ValueError(f"state slot {name!r} is {slot.dtype} "
                             f"{tuple(slot.shape)}, got {value.dtype} "
                             f"{tuple(value.shape)}")
        slot.copy_(value)

    def put_row(self, name: str, row: torch.Tensor, value: torch.Tensor,
                rows: int) -> None:
        """Write ``value`` as row ``row`` (a device index) of the slot
        ``name``, created as ``rows`` zero rows of ``value``'s shape."""
        slot = self.__dict__.get(name)
        if slot is None:
            slot = self.__dict__[name] = value.new_zeros((rows,)
                                                         + value.shape)
        sel = torch.arange(rows, device=value.device) == row
        sel = sel.reshape((rows,) + (1,) * value.ndim)
        slot.copy_(torch.where(sel, value[None], slot))

    def put_tuple(self, prefix: str, value) -> None:
        for name, v in value._asdict().items():
            self.put(f"{prefix}.{name}", v)

    def get_tuple(self, prefix: str, cls):
        return cls(*(self.__dict__[f"{prefix}.{n}"] for n in cls._fields))


def use_graphs(device: torch.device, graph, plain_knn: bool = False) -> bool:
    """Whether a compiled loop runs as graphs: by default on the card
    (``jit`` is always on in the JAX package) unless the plain K1 twin is
    asked for, which syncs with the host; never on the CPU."""
    if graph is None:
        return device.type == "cuda" and not plain_knn
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
    if graph and plain_knn:
        raise ValueError("graph=True cannot capture the plain K1 twin "
                         "(plain_knn=True): it reads the host")
    return bool(graph)


def tensor_key(*objs) -> tuple:
    """(data_ptr, shape, stride, dtype, device) of every tensor in
    ``objs``, walking dataclasses and NamedTuples, and the scalar statics
    beside them (a grid's dims, a block index's sizes): what a graph that
    reads them in place depends on besides their contents."""
    out = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append((o.data_ptr(), tuple(o.shape), o.stride(),
                        str(o.dtype), str(o.device)))
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, tuple):
            for v in o:
                walk(v)
        elif isinstance(o, (bool, int, float, str)) or o is None:
            out.append(o)

    for o in objs:
        walk(o)
    return tuple(out)


def run_eager(parts: dict):
    """Run parts by name, eagerly: the CPU path and ``graph=False``."""
    return lambda name: parts[name]()


class Graphs:
    """The captured parts of one static configuration, sharing one memory
    pool and replayed in the order they were captured; ``state`` holds
    the tensors they read and write.  ``launches[name]`` is the kernel
    launches each replay of that part counts, ``nodes[name]`` its device
    operations and ``modules[name]`` its marks' ranges over them, which
    ``tracing.module_times`` reads through ``tracing.GRAPHS`` under
    ``serial``; ``seconds`` the warm-up and capture time;
    ``capture_error_mode`` goes to ``torch.cuda.graph``."""

    serial = None          # of an instance built without ``__init__``

    def __init__(self, label: str, state: State, parts: dict, device,
                 capture_error_mode: str = "global"):
        self.label, self.state = label, state
        self.graphs = {}
        self.launches = {}
        self.nodes, self.modules = {}, {}
        self.serial = next(_SERIALS)
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for fn in parts.values():
                fn()
        cur.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for name, fn in parts.items():
            g = torch.cuda.CUDAGraph()
            cap = Capture()
            _RECORDING.append(cap)
            try:
                with torch.cuda.graph(g, pool=pool,
                                      capture_error_mode=capture_error_mode):
                    fn()
                    self.nodes[name] = cap.ops()
            except Exception as exc:
                raise RuntimeError(f"CUDA graph capture of {label}, part "
                                   f"{name!r}, failed: {exc}") from exc
            finally:
                _RECORDING.pop()
            self.graphs[name] = g
            self.launches[name] = cap
            self.modules[name] = [tuple(m) for m in cap.modules]
        tracing.GRAPHS[self.serial] = self
        torch.cuda.synchronize(device)
        self.seconds = time.perf_counter() - t0

    def __call__(self, name: str) -> None:
        tracing.replay(self.graphs[name], part=name, graphs=self.serial)
        for (wrapper, kk), n in self.launches[name].items():
            _bump(wrapper, kk, n, replayed=True)


class GraphCache:
    """Captured graphs by static key, the ``max_entries`` most recently
    used kept.  ``captures`` and ``capture_seconds`` count what was
    captured (the counterpart of JAX's compile count and time)."""

    def __init__(self, max_entries: int = 6):
        self.max_entries = max_entries
        self._entries = collections.OrderedDict()
        self.captures = 0
        self.capture_seconds = 0.0

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def discard(self, key) -> None:
        """Drop the entry of ``key``, if any."""
        if isinstance(self._entries.pop(key, None), Graphs):
            # a replay of it may still be queued on the card
            torch.cuda.synchronize()

    def lookup(self, key, load, build):
        """The entry of ``key``, its inputs refilled by ``load(state)``.
        On a miss ``build(state)`` makes it from a fresh ``State`` that
        ``load`` filled first; ``load`` runs again after the build, since
        a capture's warm-up may change the state."""
        entry = self._entries.pop(key, None)
        if entry is None:
            while len(self._entries) >= self.max_entries:
                old = self._entries.popitem(last=False)[1]
                if isinstance(old, Graphs):
                    # a replay of it may still be queued on the card
                    torch.cuda.synchronize()
            state = State()
            load(state)
            entry = build(state)
            self.captures += 1
            self.capture_seconds += getattr(entry, "seconds", 0.0)
        self._entries[key] = entry
        load(entry.state)
        return entry


CACHE = GraphCache()


def bind(loop, load, graphed: bool, label: str, device):
    """(run, state) of ``loop``: ``run(name)`` runs a part eagerly over a
    fresh ``State`` that ``load`` filled, or, ``graphed``, replays the
    cached graphs of ``loop.key()`` (captured on a miss, named ``label``
    in a capture error, in the loop's ``capture_error_mode`` if it has
    one) over their state, refilled by ``load``."""
    with tracing.span("graphs.bind"):
        if not graphed:
            state = State()
            load(state)
            return run_eager(loop.parts(state)), state
        mode = getattr(loop, "capture_error_mode", "global")
        entry = CACHE.lookup(loop.key(), load,
                             lambda s: Graphs(label, s, loop.parts(s),
                                              device, mode))
        return entry, entry.state


def drive(run, S, max_iterations: int) -> None:
    """One pass of a compiled loop: the prologue, steps until the state's
    ``done`` flag is set (one host read per step, as the JAX
    ``while_loop``'s condition) or ``max_iterations`` steps ran, the
    epilogue.  ``run(name)`` runs or replays a part."""
    run("prologue")
    for it in range(max_iterations):
        if it:
            STATS.host_reads += 1
            with tracing.span("graphs.done_read"):
                done = bool(S.done)               # one host sync per trip
            if done:
                break
        run("step")
    run("epilogue")


def drive_lanes(run, S, max_iterations: int, lanes: int) -> tuple:
    """``drive`` for a loop of ``lanes`` independent lanes whose step
    writes ``left``, (lanes still running, lanes aborted or over their
    pair list): one host read of it after each step, until no lane runs
    or ``max_iterations`` steps ran; then the epilogue.  Returns (steps,
    lane steps: the sum over steps of the lanes running in each, so the
    lanes' iterations, lanes failed at the last read), all from the reads
    the loop makes anyway."""
    run("prologue")
    steps = lane_steps = failed = 0
    running = lanes
    for _ in range(max_iterations):
        run("step")
        steps += 1
        lane_steps += running
        STATS.host_reads += 1
        with tracing.span("graphs.done_read"):
            running, failed = S.left.tolist()     # one host sync per step
        if not running:
            break
    run("epilogue")
    return steps, lane_steps, failed


def detached(tree):
    """Fresh copies of a result's tensors: a graph's state is overwritten
    by its next call."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if type(tree) is tuple:
        return tuple(detached(v) for v in tree)
    return type(tree)(*(detached(v) for v in tree))
