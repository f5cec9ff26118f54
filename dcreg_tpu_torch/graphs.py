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

Every loop class (``BatchLoop``, ``MapLoop``, ``PairLoop``,
``EulerLoop``, ``VoxelLoop``, ``XICPLoop``, ``O3DLoop``,
``SuperLocLoop``, ``PoseGraphLoop``, ``ShardedLoop``) has ``key()`` and
``parts(state)``; ``bind`` gives the runner of its parts and their
state, and ``drive`` runs one pass of the loop (a loop with no ``step``
part, as ``SuperLocLoop``, runs with ``max_iterations`` 0).  A loop
whose parts hold collectives captures in ``capture_error_mode``
"thread_local" (``ShardedLoop``).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch

# tallies of the captures in progress (innermost last)
_RECORDING: list = []


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
    launches each replay of that part counts, ``seconds`` the warm-up
    and capture time; ``capture_error_mode`` goes to
    ``torch.cuda.graph``."""

    def __init__(self, label: str, state: State, parts: dict, device,
                 capture_error_mode: str = "global"):
        self.state = state
        self.graphs = {}
        self.launches = {}
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
            tally = collections.Counter()
            _RECORDING.append(tally)
            try:
                with torch.cuda.graph(g, pool=pool,
                                      capture_error_mode=capture_error_mode):
                    fn()
            except Exception as exc:
                raise RuntimeError(f"CUDA graph capture of {label}, part "
                                   f"{name!r}, failed: {exc}") from exc
            finally:
                _RECORDING.pop()
            self.graphs[name] = g
            self.launches[name] = tally
        torch.cuda.synchronize(device)
        self.seconds = time.perf_counter() - t0

    def __call__(self, name: str) -> None:
        self.graphs[name].replay()
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
    if not graphed:
        state = State()
        load(state)
        return run_eager(loop.parts(state)), state
    mode = getattr(loop, "capture_error_mode", "global")
    entry = CACHE.lookup(loop.key(), load,
                         lambda s: Graphs(label, s, loop.parts(s), device,
                                          mode))
    return entry, entry.state


def drive(run, S, max_iterations: int) -> None:
    """One pass of a compiled loop: the prologue, steps until the state's
    ``done`` flag is set (one host read per step, as the JAX
    ``while_loop``'s condition) or ``max_iterations`` steps ran, the
    epilogue.  ``run(name)`` runs or replays a part."""
    run("prologue")
    for it in range(max_iterations):
        if it and bool(S.done):                   # one host sync per trip
            break
        run("step")
    run("epilogue")


def detached(tree):
    """Fresh copies of a result's tensors: a graph's state is overwritten
    by its next call."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if type(tree) is tuple:
        return tuple(detached(v) for v in tree)
    return type(tree)(*(detached(v) for v in tree))
