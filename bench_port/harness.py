"""The port's benchmark harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own that the harness finds by the name in
``BENCHMARK.json``:

  * a configuration is the JSON file its entry names; its ``scene`` names
    the generator ``scenes/<scene>.py``;
  * a traffic mix is ``traffic/<traffic>.json``; its ``driver`` names
    ``drivers/<driver>.py``;
  * a cell's comparison limits are ``limits/<workload>.json``;
  * a per-layer metric is the reader ``metrics/<name>.py``, whose
    ``read(ctx)`` returns the number or None where it finds nothing.

A run makes its inputs on the device from the seed, builds the port's
index and warms up (``setup_s``), measures for ``--seconds`` (``--trace
0``) or traces a short window under ``torch.profiler`` (``--trace 1``),
then holds a sample of the window's answers against the plain reference
(``check.py``) and prints the result line.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

import check
from seeds import generator

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "dcreg_tpu")
TOP = 10


class Parts:
    """Seconds of the named parts of set-up."""

    def __init__(self, device):
        self.seconds, self.device = {}, device

    @contextlib.contextmanager
    def timed(self, name):
        sync(self.device)
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t0


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Registry:
    """The benchmark's data: ``BENCHMARK.json`` under ``root`` and the
    files of each piece, looked up in ``search`` (the data directories,
    the harness's own last)."""

    def __init__(self, root, search=()):
        self.root = root
        self.search = list(search) + [HERE]
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def path(self, *parts):
        for d in self.search:
            p = os.path.join(d, *parts)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(os.path.join(*parts))

    def json(self, *parts):
        with open(self.path(*parts)) as f:
            return json.load(f)

    def module(self, *parts):
        p = self.path(*parts)
        name = "bench_" + "_".join(parts).replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name):
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        cfg_entry = {c["name"]: c for c in self.bench["configs"]}[w["config"]]
        with open(os.path.join(self.root, cfg_entry["file"])) as f:
            cfg = json.load(f)
        return w, cfg, self.json("traffic", w["traffic"] + ".json"), \
            self.json("limits", name + ".json")

    def metrics(self, cell, trace):
        """The metric entries the cell reports in this kind of run."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if "workloads" not in m or cell in m["workloads"]]


class Trace:
    """The device's operations and the host's calls in a traced window."""

    def __init__(self, prof, window_s):
        from torch.autograd import DeviceType
        self.window_s = window_s
        self.dev, self.host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    self.dev.append((e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CPU:
                self.host.append((e.name, tr.start, tr.end))
        self.dev.sort(key=lambda x: x[1])
        self.host.sort(key=lambda x: x[1])
        self.kernels = [d for d in self.dev
                        if not d[0].startswith(("Memcpy", "Memset"))]
        self.busy_s, self.gaps = self._union()

    def _union(self):
        """Seconds in which an operation ran on the device, and the idle
        gaps between them (start, end, in microseconds)."""
        busy, gaps, cur = 0.0, [], None
        for _, s, e in self.dev:
            if cur is None:
                cur = [s, e]
            elif s > cur[1]:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy * 1e-6, gaps

    def count_host(self, names):
        return sum(1 for h in self.host if h[0] in names)

    def device_seconds(self, contains):
        return sum(e - s for n, s, e in self.kernels if contains in n) * 1e-6

    def device_count(self, contains):
        return sum(1 for n, _, _ in self.kernels if contains in n)

    def breakdown(self):
        """The device operations that took most time, and the longest idle
        gaps by the innermost host call that was running in them."""
        ops = {}
        for n, s, e in self.dev:
            ops[n[:96]] = ops.get(n[:96], 0.0) + (e - s) * 1e-6
        starts = [h[1] for h in self.host]
        idle = {}
        for gs, ge in self.gaps:
            mid = 0.5 * (gs + ge)
            i = bisect.bisect_right(starts, mid) - 1
            name, best = "(no host call)", -math.inf
            for j in range(i, max(-1, i - 400), -1):
                n, s, e = self.host[j]
                if e >= mid and s > best:
                    name, best = n, s
            idle[name[:96]] = idle.get(name[:96], 0.0) + (ge - gs) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device, chips):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(workload, seed, seconds, trace, t_start, device="cuda", root=".",
        search=()):
    """One run of the cell ``workload``; returns (the result line's
    object, the lines for standard error: the set-up's parts, then each
    compared number beside its limit)."""
    from dcreg_tpu_torch import graphs
    from dcreg_tpu_torch.utils import precise
    reg = Registry(root, search)
    w, cfg, traffic, limits = reg.cell(workload)
    precise()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    parts = Parts(device)
    with parts.timed("inputs"):
        scene = reg.module("scenes", cfg["scene"] + ".py").make(
            cfg, seed, device)
    driver = reg.module("drivers", traffic["driver"] + ".py").Driver(
        cfg, traffic, scene, device, parts, seed)
    sync(device)
    setup_s = time.perf_counter() - t_start
    capture_s = graphs.CACHE.capture_seconds
    metrics, result_trace = {}, None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            wall = driver.traced()
            sync(device)
        result_trace = Trace(prof, wall)
    else:
        e2e, wall = driver.window(seconds)
        e2e["setup_s"] = setup_s
    dev_info = device_info(device, w["chips"])
    attempted, failed, _ = driver.outcome()
    counts = driver.counts()
    answers = driver.answers(generator(seed, "check", "cpu"))
    world = scene["world"]
    method = tuple(traffic["method"])
    driver.release()
    graphs.CACHE = graphs.GraphCache()           # the program's graphs
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        ctx = {"trace": result_trace, "counts": counts,
               "capture_seconds": capture_s, "scene": scene, "cfg": cfg,
               "traffic": traffic, "peaks": reg.json("peaks.json"),
               "device": device}
        for m in reg.metrics(workload, True):
            v = reg.module("metrics", m["name"] + ".py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = result_trace.busy_s
        dev_info["window_s"] = result_trace.window_s
    else:
        for m in reg.metrics(workload, False):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    t0 = time.perf_counter()
    numbers = check.run_reference(answers, world, method, cfg["icp"])
    ok, report = check.judge(numbers, limits)
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = result_trace.breakdown()
    result["checks"] = report
    spent = dict(parts.seconds, graph_capture=capture_s,
                 reference=time.perf_counter() - t0)
    lines = [f"set-up and check seconds: {json.dumps(spent)}; answers "
             f"checked: {len(answers)}",
             f"every number of the check: {json.dumps(numbers)}",
             f"window counts: {json.dumps(counts)}"]
    lines += [f"check {n}: {v['value']!r} limit {v['limit']!r}"
              for n, v in report.items()]
    return result, lines
