"""The harness reads its cells, traffic mixes and metrics from data files;
its result line has the contract's keys; the K1 work reckoning and the
kd-leaf order are right; nothing loads JAX or the JAX package."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from conftest import BENCH, ROOT

import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(root, workload, trace=0, seconds=0.5, seed=2147483659):
    torch.manual_seed(0)
    return harness.run(workload, seed, seconds, bool(trace),
                       time.perf_counter(), device="cpu", root=root,
                       search=[root])


def test_cell_added_from_data_files(tiny_root, tmp_path):
    """A new cell is a traffic file, a limits file and an entry: no code."""
    root = str(tmp_path)
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, d))
        for f in os.listdir(os.path.join(tiny_root, d)):
            with open(os.path.join(tiny_root, d, f)) as src, \
                    open(os.path.join(root, d, f), "w") as dst:
                dst.write(src.read())
    with open(os.path.join(root, "traffic", "stream.json")) as f:
        mix = json.load(f)
    mix.update(check_answers=2, about="a shorter check")
    with open(os.path.join(root, "traffic", "stream_two.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "limits", "tmap.stream.json")) as f:
        limits = f.read()
    with open(os.path.join(root, "limits", "tmap.stream_two.json"), "w") as f:
        f.write(limits)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tmap.stream_two", "config": "tmap",
                               "traffic": "stream_two", "chips": 1,
                               "why": "added from data files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tmap.stream" in m.get("workloads", []):
            m["workloads"].append("tmap.stream_two")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    result, lines = run_tiny(root, "tmap.stream_two")
    assert result["correct"], lines
    assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert set(result["checks"]) == set(json.loads(limits))


def test_result_line_keys(tiny_root):
    result, lines = run_tiny(tiny_root, "tmap.stream")
    assert list(result) == KEYS + ["checks"]
    assert list(result["device"]) == ["platform", "kind", "count",
                                      "memory_peak_bytes"]
    for m in result["metrics"].values():
        assert list(m) == ["value", "unit"]
    assert lines[-len(result["checks"]):] == [
        f"check {n}: {v['value']!r} limit {v['limit']!r}"
        for n, v in result["checks"].items()]
    json.dumps(result)


def test_traced_result_reads_metrics_by_name(tiny_root):
    result, _ = run_tiny(tiny_root, "tmap.stream", trace=1)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    # on the CPU only the program's counters read; the trace's readers
    # find no device operation and are left out
    assert set(result["metrics"]) == {"icp_iters.frame"}
    assert list(result["breakdown"]) == ["device_ops", "idle_gaps"]


def test_k1_reckoning_matches_brute_force():
    spec = harness.Registry(ROOT).module("metrics", "k1_roofline.batch.py")
    g = torch.Generator().manual_seed(3)
    pts = torch.rand(37, 3, generator=g)
    world = torch.rand(500, 3, generator=g) * 1.5 - 0.25
    r = 0.2
    pairs, touched = spec.pairs_within(pts, world, r)
    d = ((pts.numpy()[:, None] - world.numpy()[None]) ** 2).sum(-1)
    assert pairs == int((d <= r * r).sum())
    assert touched == int((d <= r * r).any(0).sum())
    peaks = {"f32_ops_per_s": 1e3, "hbm_bytes_per_s": 1e3}
    least, bound = spec.least_seconds(37, 4, pairs, touched, peaks)
    ops = 10 * pairs * 4
    nbytes = 12 * (37 + touched) + 5 * 8 * 37 * 4
    assert least == max(ops, nbytes) / 1e3
    assert bound == ("operations" if ops >= nbytes else "bytes")


def test_kd_leaf_order_compact_full_leaves():
    from kdorder import kd_leaf_order
    from dcreg_tpu_torch.ops.block_sparse import kd_block_order
    g = torch.Generator().manual_seed(5)
    for n in (1000, 4096, 33333):
        pts = torch.rand(n, 3, generator=g) * torch.tensor([40.0, 9.0, 2.0])
        perm = kd_leaf_order(pts, 128).numpy()
        assert sorted(perm.tolist()) == list(range(n))
        ref = kd_block_order(pts.numpy(), 128)
        leaves = lambda p: sorted(tuple(sorted(p[i:i + 128]))
                                  for i in range(0, n, 128))
        assert leaves(perm) == leaves(ref)
        sizes = [len(p) for p in np.array_split(perm, range(128, n, 128))]
        assert all(s == 128 for s in sizes[:-1])
        ext = lambda p: np.mean([np.ptp(pts.numpy()[p[i:i + 128]], 0).sum()
                                 for i in range(0, n - 127, 128)])
        assert ext(perm) < 0.5 * ext(np.arange(n))


def loaded_top_level(code):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{BENCH!r}, "
         f"{ROOT!r}]\n{code}\nprint(sorted({{m.split('.')[0] for m in "
         f"sys.modules}}))"], capture_output=True, text=True, check=True,
        cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_and_a_reference_without_the_port():
    every = ("import harness, check, control, kdorder, seeds, port, run\n"
             "reg = harness.Registry('.')\n"
             "import os\n"
             "for d in ('scenes', 'drivers', 'metrics'):\n"
             "    for f in sorted(os.listdir(os.path.join(harness.HERE, d))):\n"
             "        if f.endswith('.py'):\n"
             "            reg.module(d, f)\n"
             "import dcreg_tpu_torch.models.odometry, "
             "dcreg_tpu_torch.models.icp_batch")
    assert not loaded_top_level(every) & set(harness.FORBIDDEN)
    ref = loaded_top_level("import check\nfrom reference import icp")
    assert not ref & (set(harness.FORBIDDEN) | {"dcreg_tpu_torch"})
