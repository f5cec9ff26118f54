"""CPU tests of the port's benchmark harness (``bench_port``).

    python -m pytest bench_port/tests -q

They run the harness on the CPU at a tiny size (the port's plain PyTorch
path), from a data directory that holds a tiny copy of each cell: its
configuration with fewer and smaller scans and a smaller map, its traffic
with fewer answers, and the real cell's limits.  Tests marked ``chip``
need a CUDA device and decide so in a fixture.
"""
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny cells: (name, config, traffic, real cell), with the cuts
TINY_CONFIGS = {
    "tmap": ("map53m.json", {"map_points": 400000, "min_extent_m": 14.0,
                             "frames": 6, "scan_points": 800}),
    "tcor": ("corridor.json", {"length_m": 30.0, "frames": 6,
                               "scan_points": 600}),
}
TINY_TRAFFIC = {"stream": {"check_answers": 3},
                "stream_metsvd": {"check_answers": 3},
                "mc128": {"batch": 8, "check_answers": 6, "trace_batches": 1}}
TINY_CELLS = [("tmap.stream", "tmap", "stream", "map53m.stream"),
              ("tcor.stream", "tcor", "stream", None),
              ("tmap.mc128", "tmap", "mc128", None)]
# the corridor and the Monte-Carlo batch are no cells of the benchmark yet
# (PERF.md, section 7): their tiny rehearsals only check that the harness
# drives them, under a limit that a broken path passes far beyond
REHEARSAL_LIMITS = {"plane_gap_m.q3": 1e-3, "rot_gap_rad.q3": 1e-3}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA device (skips without one)")


def write_tiny(root, cells=TINY_CELLS):
    """A data directory ``root`` with BENCHMARK.json, configs, traffic and
    limits of the tiny cells; returns ``root``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    configs = []
    for name, (src, cut) in TINY_CONFIGS.items():
        with open(os.path.join(BENCH, "configs", src)) as f:
            cfg = json.load(f)
        cfg.update(cut, name=name)
        with open(os.path.join(root, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        configs.append({"name": name, "source": "tiny", "reduced": [],
                        "file": f"configs/{name}.json", "why": "tiny"})
    for name, cut in TINY_TRAFFIC.items():
        with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
            tr = json.load(f)
        tr.update(cut)
        with open(os.path.join(root, "traffic", name + ".json"), "w") as f:
            json.dump(tr, f)
    workloads = []
    for name, cfg, traffic, real in cells:
        limits = REHEARSAL_LIMITS
        if real is not None:
            with open(os.path.join(BENCH, "limits", real + ".json")) as f:
                limits = json.load(f)
        with open(os.path.join(root, "limits", name + ".json"), "w") as f:
            json.dump(limits, f)
        workloads.append({"name": name, "config": cfg, "traffic": traffic,
                          "chips": 1, "why": "tiny"})
    real = {r: n for n, _, _, r in cells if r is not None}
    for key in ("end_to_end", "per_layer"):
        for m in bench[key]:
            if "workloads" in m:
                m["workloads"] = [real[w] for w in m["workloads"]
                                  if w in real]
    bench.update(configs=configs, workloads=workloads)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(root)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
