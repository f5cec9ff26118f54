"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` over the
compiled loops (``dcreg_tpu/utils/__init__.py``'s ``precise_jit``, and the
``lax.while_loop`` / ``lax.scan`` it wraps).

A compiled loop is split into named parts (prologue, step, epilogue) that
read and write a ``State`` of fixed tensors in place.  On the card each
part is captured once into a ``torch.cuda.CUDAGraph`` after an eager
warm-up on a side stream (which also loads the kernel libraries), and
every later call of the same statics replays the graphs.  A loop with a
step part runs a pass (prologue, steps, epilogue) as one
``cudaGraphLaunch`` of a pass graph composed of the captured parts, with
the condition of the JAX ``while_loop`` evaluated on the card by the
hand-written ``loop_cond`` kernel (``ops/loop_cond``) between the steps:
no host read inside a pass.  A loop whose parts hold collectives
(``capture_error_mode`` "thread_local"), or whose pass graph would hold
more than ``PASS_OPS`` device operations, replays part by part, and its
host reads the flag between steps (``host_pass``).  ``GraphCache`` keys
the captures on their statics, including the address and layout of every
tensor a graph reads in place (a second index of the same shapes gets
graphs of its own), and keeps a few of them, least recently used first
out.

On the CPU the same parts run eagerly (``run_eager``); nothing falls
back from a graph to eager execution: a capture error raises, naming the
part.

Kernel launches inside a capture are not launches: each
``cuda_build.Kernel`` reports its launches through ``note_launch``, which
tallies them into the capture, and each replay adds the tally to the
kernels' counters, so ``launches`` counts what the card ran (and
``launches_replayed`` the part of it that came from replays).  A pass on
the card adds its prologue's and epilogue's tallies at once and its
steps' when a counter is read (``settle``: the card's own count of the
steps it ran, read then).

Likewise a profiler range inside a part would run once, at capture, and
never at a replay.  So a part names its modules with ``mark``: at every
capture, traced or not, each mark records the range of the part's device
operations (kernel, copy and set nodes, in capture order) that its block
created, in ``Graphs.modules[part]`` beside ``Graphs.nodes[part]``; a
single-stream capture replays its nodes in that order, so
``tracing.module_times`` can split a profiled replay by the table.  A mark
adds no node and reads nothing from the device.  Outside a capture it is
a ``tracing.span``.  ``bind``, each replay (a pass: ``part="pass"``) and
each host read of the loop's flag are spans too (``graphs.bind``,
``graphs.replay``, ``graphs.done_read``); ``STATS`` counts the reads and
the passes on the card.

Every loop class (``BatchLoop``, ``MapLoop``, ``PairLoop``,
``EulerLoop``, ``VoxelLoop``, ``XICPLoop``, ``O3DLoop``,
``SuperLocLoop``, ``PoseGraphLoop``, ``ShardedLoop``) has ``key()`` and
the methods ``prologue``, ``step`` (where it has one) and ``epilogue``
over a state, its parts (``parts``); ``bind`` gives the runner of its
parts and their state, and ``drive`` runs one pass of the loop (a loop
with no ``step`` part, as ``SuperLocLoop``, runs with ``max_iterations``
0, one replay per part); ``drive_lanes`` runs a loop of independent
lanes (a fleet's ``MapLoop``).  A loop whose parts hold collectives
captures in ``capture_error_mode`` "thread_local" (``ShardedLoop``).
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


class Stats:
    """``host_reads``: the host's reads of a loop's flag (``host_pass``:
    ``drive``'s done flag, ``drive_lanes``' ``left``); ``replays``: the
    graph launches of ``Graphs`` (a part, or a whole pass);
    ``device_passes``: the passes driven on the card in one launch;
    ``device_steps``: the steps those passes ran, counted when read
    (``settle``)."""

    def __init__(self):
        self.host_reads = 0
        self.replays = 0
        self.device_passes = 0
        self._device_steps = 0

    @property
    def device_steps(self) -> int:
        settle()
        return self._device_steps


STATS = Stats()
# the configurations whose passes ran steps not yet counted, by serial
_UNSETTLED: dict = {}
# the most device operations a pass graph holds (its prologue, cap steps
# each with the condition kernel, its epilogue; ``Graphs.loops``): the
# largest pass measured to run under the profiler (CUPTI of torch 2.11,
# driver 580, on an H100) with CUPTI attached before its instantiation,
# XICP-EQ's at cap 20; at cap 30 (390,892 ops) the same pass hit an
# illegal address there, and ran where the profiler came after its
# instantiation or not at all.  A larger loop, as XICP's (a step of about
# 12,900 ops) at cap 30, replays part by part.
PASS_OPS = 262_052


def _bump(kernel, kk, n: int, replayed: bool = False) -> None:
    kernel._launches += n
    if replayed:
        kernel._launches_replayed += n
    if kk is not None:
        by_kk = kernel._launches_by_kk
        by_kk[kk] = by_kk.get(kk, 0) + n


def settle() -> None:
    """Count the steps of the passes driven on the card since the last
    settle into the launch counters of the kernels their steps launch
    (the condition kernel's too) and ``STATS.device_steps``: one read of
    each configuration's step count from the card, after a synchronize.
    Reading a launch counter settles first; no call of the program does."""
    while _UNSETTLED:
        _UNSETTLED.popitem()[1].settle()


def note_launch(kernel, kk=None) -> None:
    """Count one launch of ``kernel`` (a ``cuda_build.Kernel``: its
    ``launches``, and ``launches_by_kk[kk]`` where ``kk`` is given).
    Under a capture the launch goes into the graph's tally instead; each
    replay counts it."""
    if _RECORDING:
        _RECORDING[-1][(kernel, kk)] += 1
    else:
        _bump(kernel, kk, 1)


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
    """One part's capture in progress: the kernel launches it made, by
    (kernel, kk) (``note_launch``), and its marks, ``modules``
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


def use_graphs(device: torch.device, graph) -> bool:
    """Whether a compiled loop runs as graphs: by default on the card
    (``jit`` is always on in the JAX package), never on the CPU."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
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


def parts(loop, S) -> dict:
    """The parts of ``loop`` over the state ``S`` by name: its
    ``prologue``, ``step`` (where it has one) and ``epilogue``."""
    return {name: functools.partial(getattr(loop, name), S)
            for name in ("prologue", "step", "epilogue")
            if hasattr(loop, name)}


def run_eager(parts: dict):
    """Run parts by name, eagerly: the CPU path and ``graph=False``."""
    return lambda name: parts[name]()


def loops_on_card(parts: dict, capture_error_mode: str) -> bool:
    """Whether a configuration of these parts runs its passes on the card
    in one launch: it has a prologue, a step and an epilogue, and no
    collectives (captured in "global" mode; NCCL inside a conditional
    node has never run here), else it replays part by part."""
    return capture_error_mode == "global" and \
        {"prologue", "step", "epilogue"} <= parts.keys()


class Graphs:
    """The captured parts of one static configuration, sharing one memory
    pool and replayed in the order they were captured; ``state`` holds
    the tensors they read and write.  ``launches[name]`` is the kernel
    launches each replay of that part counts, ``nodes[name]`` its device
    operations and ``modules[name]`` its marks' ranges over them, which
    ``tracing.module_times`` reads through ``tracing.GRAPHS`` under
    ``serial``; ``seconds`` the warm-up and capture time (and the pass
    graphs' instantiation); ``capture_error_mode`` goes to
    ``torch.cuda.graph``.

    ``looped`` (``loops_on_card``): the configuration runs a pass that
    fits ``PASS_OPS`` (``loops``) on the card in one launch
    (``run_pass``) of a pass graph per cap and rule
    (``passes``, built by ``ops/loop_cond`` from the captured parts, which
    are instantiated on their own only where replayed part by part);
    ``step_count``, a device counter, counts the steps its passes ran."""

    serial = None          # of an instance built without ``__init__``
    looped = False

    def __init__(self, label: str, state: State, parts: dict, device,
                 capture_error_mode: str = "global"):
        self.label, self.state = label, state
        self.device = torch.device(device)
        self.graphs = {}
        self.launches = {}
        self.nodes, self.modules = {}, {}
        self.serial = next(_SERIALS)
        self.looped = loops_on_card(parts, capture_error_mode)
        self.passes, self.step_count, self._counted = {}, None, 0
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
            g = torch.cuda.CUDAGraph(keep_graph=True)
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
            if not self.looped:
                g.instantiate()
            self.graphs[name] = g
            self.launches[name] = cap
            self.modules[name] = [tuple(m) for m in cap.modules]
        if self.looped:
            self.step_count = torch.zeros(1, dtype=torch.int64,
                                          device=device)
        tracing.GRAPHS[self.serial] = self
        torch.cuda.synchronize(device)
        self.seconds = time.perf_counter() - t0

    def loops(self, cap: int) -> bool:
        """Whether a pass of at most ``cap`` steps runs on the card in one
        launch: the configuration is looped and the pass graph holds at
        most ``PASS_OPS`` device operations."""
        n = self.nodes
        return self.looped and cap > 0 and n["prologue"] + n["epilogue"] \
            + cap * (n["step"] + 1) <= PASS_OPS

    def __call__(self, name: str) -> None:
        """Replay the part ``name`` (a looped configuration's parts are
        instantiated at their first replay)."""
        tracing.replay(self.graphs[name], part=name, graphs=self.serial)
        STATS.replays += 1
        self._count(name)

    def run_pass(self, pass_graph) -> None:
        """Launch one pass graph (``ops/loop_cond``) of this
        configuration: a ``graphs.replay`` span of part "pass"; the
        prologue's and epilogue's launches count now, the steps' at the
        next ``settle``."""
        tracing.replay(pass_graph, part=tracing.PASS, graphs=self.serial)
        self._count("prologue")
        self._count("epilogue")
        STATS.replays += 1
        STATS.device_passes += 1
        _UNSETTLED[self.serial] = self

    def settle(self) -> None:
        """Count the steps this configuration's passes ran since its last
        settle (``graphs.settle``)."""
        from .ops.loop_cond import LOOP_COND
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        total = int(self.step_count.item())
        k, self._counted = total - self._counted, total
        self._count("step", k)
        _bump(LOOP_COND, None, k, replayed=True)
        STATS._device_steps += k

    def _count(self, name: str, times: int = 1) -> None:
        for (wrapper, kk), n in self.launches[name].items():
            _bump(wrapper, kk, n * times, replayed=True)


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
        self._drop(self._entries.pop(key, None))

    @staticmethod
    def _drop(entry) -> None:
        if isinstance(entry, Graphs):
            # a replay of it may still be queued on the card; its passes'
            # steps are counted before it goes
            torch.cuda.synchronize()
            settle()

    def lookup(self, key, load, build):
        """The entry of ``key``, its inputs refilled by ``load(state)``.
        On a miss ``build(state)`` makes it from a fresh ``State`` that
        ``load`` filled first; ``load`` runs again after the build, since
        a capture's warm-up may change the state."""
        entry = self._entries.pop(key, None)
        if entry is None:
            while len(self._entries) >= self.max_entries:
                self._drop(self._entries.popitem(last=False)[1])
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
            return run_eager(parts(loop, state)), state
        mode = getattr(loop, "capture_error_mode", "global")
        entry = CACHE.lookup(loop.key(), load,
                             lambda s: Graphs(label, s, parts(loop, s),
                                              device, mode))
        return entry, entry.state


def drive(run, S, max_iterations: int):
    """One pass of a compiled loop: the prologue, steps until the state's
    ``done`` flag is set (the JAX ``while_loop``'s condition, tested
    after each step) or ``max_iterations`` steps ran, the epilogue.
    ``run(name)`` runs or replays a part; a ``Graphs`` whose pass fits
    (``Graphs.loops``) runs it on the card in one launch
    (``ops/loop_cond``), any other runner on the host (``host_pass``)."""
    return _drive(run, S, max_iterations, "done")


def drive_lanes(run, S, max_iterations: int):
    """``drive`` for a loop of independent lanes whose step writes
    ``left``, (lanes still running, lanes aborted or over their pair
    list): steps until no lane runs or ``max_iterations`` steps ran; then
    the epilogue."""
    return _drive(run, S, max_iterations, "left")


def _drive(run, S, cap: int, rule: str):
    # the one decision: a pass on the card, or the condition kernel's
    # plain twin (also where ``LOOP_COND.through_the_twin`` holds)
    from .ops import loop_cond
    if isinstance(run, Graphs) and run.loops(cap) \
            and not loop_cond.LOOP_COND.on_twin_route:
        return loop_cond.run_pass(run, cap, rule)
    return loop_cond.LOOP_COND.twin(run, S, cap, rule)


def host_pass(run, S, cap: int, rule: str) -> None:
    """One pass with the loop on the host, part by part: the condition
    kernel's plain twin.  Each read of the state's flag is one host sync,
    a ``graphs.done_read`` span counted in ``STATS.host_reads``: for rule
    "done" (``drive``) before every step but the first, stopping once it
    is set; for "left" (``drive_lanes``) after every step, stopping once
    no lane runs; at most ``cap`` steps."""
    run("prologue")
    for it in range(cap):
        if rule == "done" and it and _read(lambda: bool(S.done)):
            break
        run("step")
        if rule == "left" and not _read(lambda: S.left.tolist()[0]):
            break
    run("epilogue")


def _read(flag):
    STATS.host_reads += 1
    with tracing.span("graphs.done_read"):
        return flag()


def detached(tree):
    """Fresh copies of a result's tensors: a graph's state is overwritten
    by its next call."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if type(tree) is tuple:
        return tuple(detached(v) for v in tree)
    return type(tree)(*(detached(v) for v in tree))
