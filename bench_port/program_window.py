"""The port's own spans and counters (``dcreg_tpu_torch.tracing``,
``graphs.mark``, ``graphs.STATS``) over windows of their own, for the
per-layer metrics that read them (``metrics/*_ms_per_iter.frame.py``,
``prologue_ms.frame``, ``epilogue_ms.frame``,
``host_reads_per_iter.frame``, ``graph_idle.frame``,
``graph_launch_us.frame``, ``host_path_us.frame``).

The harness keeps the traced run's profile without the correlation ids
that tie a device operation to its graph launch, and releases the cell's
driver before the readers run; and once a profiler has traced CUDA
graphs in a process, PyTorch leaves CUPTI attached to it
(``TEARDOWN_CUPTI=0``), which slows every later graph launch of that
process about fivefold.  So the first reader that asks (``data``) hands
the scene (its device tensors shared, not copied) to a fresh process,
which builds the cell's driver again (its index, capacities and a
warm-up pass that captures the graphs; no metric counts them) and runs,
from a pass start each:

  1. one pass of the frames inside ``tracing.record()``, before any
     profiler: the recorder's spans, its replays' CUDA events and
     ``graphs.STATS.host_reads``;
  2. ``trace_frames`` frames under ``torch.profiler``:
     ``tracing.module_times`` and ``tracing.idle_gaps`` of that window.

It keeps the result in ``ctx["program"]`` and prints the per-module table
and the idle gaps on standard error.  Where the program has no
``tracing`` module, or the cell's traffic is no stream of frames,
``ctx["program"]`` is None and the readers report nothing; on the CPU the
readers report nothing.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LOOP = "run_odometry_map"
STEP, PROLOGUE, EPILOGUE = (f"{LOOP}.{p}"
                            for p in ("step", "prologue", "epilogue"))
INNER = ("graphs.replay", "graphs.done_read")


def on_card(ctx) -> bool:
    return torch.device(ctx["device"]).type == "cuda"


def data(ctx):
    """The program's numbers of this run (``ctx["program"]``), measured at
    the first call; None on the CPU or where there is nothing to read."""
    if not on_card(ctx):
        return None
    if "program" not in ctx:
        ctx["program"] = _measure(ctx)
    return ctx["program"]


def step_module_ms(ctx, module):
    """Device ms of ``module``'s operations in the step replays of the
    profiled window per ICP iteration; None unless every replay of the
    window was attributed."""
    prof = _profile(ctx)
    step = prof and prof["modules"]["parts"].get(STEP)
    m = step and step["modules"].get(module)
    return 1e3 * m["seconds"] / prof["iterations"] if m else None


def part_ms(ctx, part):
    """Device ms of the replays of ``part`` in the profiled window per
    frame; None unless every replay of the window was attributed."""
    prof = _profile(ctx)
    p = prof and prof["modules"]["parts"].get(part)
    return 1e3 * p["seconds"] / prof["frames"] if p else None


def recorded(ctx):
    """The recorded pass's numbers, or None."""
    p = data(ctx)
    return p["recorded"] if p and p["recorded"]["frames"] else None


def _profile(ctx):
    p = data(ctx)
    if not p:
        return None
    prof = p["profile"]
    if prof["modules"]["unattributed"]["replays"] or not prof["iterations"]:
        return None
    return prof


def _iterations(records) -> int:
    return int(sum(int(r[3].iterations.sum()) for r in records))


def _measure(ctx):
    if importlib.util.find_spec("dcreg_tpu_torch.tracing") is None \
            or ctx["traffic"].get("driver") != "stream":
        return None
    import torch.multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        out = ex.submit(_windows, ctx["cfg"], ctx["traffic"], ctx["scene"],
                        ctx["device"]).result()
    for line in report(out):
        print(line, file=sys.stderr)
    return out


def _windows(cfg, traffic, scene, dev) -> dict:
    """The fresh process's windows (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    import harness
    from dcreg_tpu_torch import graphs, tracing
    from dcreg_tpu_torch.utils import precise
    precise()
    spec = importlib.util.spec_from_file_location(
        "program_window_stream", os.path.join(HERE, "drivers", "stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    driver = mod.Driver(cfg, traffic, scene, dev, harness.Parts(dev), None)
    reads = graphs.STATS.host_reads
    with tracing.record() as rec:
        records, wall, _ = driver.run_pass()
    recorded = {"frames": len(records), "iterations": _iterations(records),
                "host_reads": graphs.STATS.host_reads - reads,
                "frame_ms": wall / len(records) * 1e3,
                "wall_s": rec.wall_s,
                "replay_device_s": rec.replay_device_seconds(),
                "replay_less_launch_s": sum(
                    max(0.0, sec - (rec.spans[i][3] - rec.spans[i][2]) * 1e-9)
                    for i, sec in rec.replays),
                "replay_host_s": rec.seconds("graphs.replay"),
                "host_path_s": rec.self_seconds("odometry.call", INNER),
                "replays": len(rec.replays), "untimed": rec.untimed}
    n = traffic["trace_frames"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        records, _, _ = driver.frames_until(lambda k, _: k >= n)
        torch.cuda.synchronize()
    return {"profile": {"frames": len(records),
                        "iterations": _iterations(records),
                        "modules": tracing.module_times(prof),
                        "idle_gaps": tracing.idle_gaps(prof)},
            "recorded": recorded}


def report(out) -> list:
    """The lines printed on standard error: the profiled window's device
    time by part and module, what was left unattributed or ran eagerly,
    the idle gaps by innermost program span, the recorded pass."""
    prof = out["profile"]
    mt, it, fr = prof["modules"], prof["iterations"], prof["frames"]
    lines = [f"program modules ({fr} frames, {it} ICP iterations "
             f"profiled): device ms per iteration (step) or per frame"]
    for key, p in sorted(mt["parts"].items()):
        per = it if key == STEP else fr
        lines.append(f"  {key}: {p['replays']} replays, "
                     f"{p['ops'] / max(p['replays'], 1):.0f} ops each, "
                     f"{1e3 * p['seconds'] / per:.4f} ms")
        for name, m in sorted(p["modules"].items(),
                              key=lambda kv: -kv[1]["seconds"]):
            share = 100.0 * m["seconds"] / p["seconds"] if p["seconds"] \
                else 0.0
            lines.append(f"    {name}: {1e3 * m['seconds'] / per:.4f} ms, "
                         f"{m['ops'] / per:.1f} ops, {share:.2f}%")
    attributed = sum(p["seconds"] for p in mt["parts"].values())
    lines.append(
        f"  unattributed replays {mt['unattributed']['replays']} "
        f"({1e3 * mt['unattributed']['seconds']:.4f} ms); eager ops "
        f"{mt['eager']['ops']} ({1e3 * mt['eager']['seconds']:.4f} ms); "
        f"attributed + eager {1e3 * (attributed + mt['eager']['seconds']):.4f}"
        f" of {1e3 * mt['device']['seconds']:.4f} device ms")
    lines.append("idle gaps by innermost program span (s): "
                 + json.dumps(dict(sorted(prof["idle_gaps"].items(),
                                          key=lambda kv: -kv[1]))))
    rec = out["recorded"]
    if rec["frames"] and rec["wall_s"]:
        lines.append(
            "recorded pass idle share (%): "
            f"{100 * (1 - rec['replay_device_s'] / rec['wall_s']):.4f} "
            "(graph_idle.frame, a replay's launch wait counted busy) to "
            f"{100 * (1 - rec['replay_less_launch_s'] / rec['wall_s']):.4f}"
            " (each replay's host time taken off its interval)")
    lines.append(f"recorded pass: {json.dumps(rec)}")
    return lines
