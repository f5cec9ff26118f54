"""The readers of the program's spans and counters
(``program_window``): each metric's arithmetic over a synthetic
``ctx["program"]``, and nothing on the CPU or where the program gave
nothing to read."""
import importlib.util
import os

import pytest

import program_window

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")
STEP_READERS = {"search": "search", "planes": "tail.planes",
                "system": "tail.system", "degeneracy": "degeneracy",
                "solve": "solve", "update": "update"}
NAMES = [f"{r}_ms_per_iter.frame" for r in STEP_READERS] + [
    "prologue_ms.frame", "epilogue_ms.frame", "host_reads_per_iter.frame",
    "graph_idle.frame", "graph_launch_us.frame", "host_path_us.frame"]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + name.replace(".", "_"),
        os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program(unattributed=0, untimed=0):
    """8 frames and 20 iterations profiled; a recorded pass of 256
    frames, 700 iterations."""
    mods = {m: {"seconds": 1e-4 * (i + 1), "ops": 10 * (i + 1)}
            for i, m in enumerate(STEP_READERS.values())}
    mods["(unmarked)"] = {"seconds": 1e-6, "ops": 2}
    step_s = sum(m["seconds"] for m in mods.values())
    parts = {program_window.STEP: {"replays": 20, "seconds": step_s,
                                   "ops": 20 * 212, "modules": mods},
             program_window.PROLOGUE: {"replays": 8, "seconds": 4e-3,
                                       "ops": 8 * 300, "modules": {
                                           "(unmarked)": {"seconds": 4e-3,
                                                          "ops": 8 * 300}}},
             program_window.EPILOGUE: {"replays": 8, "seconds": 2e-3,
                                       "ops": 8 * 90, "modules": {
                                           "(unmarked)": {"seconds": 2e-3,
                                                          "ops": 8 * 90}}}}
    return {"profile": {"frames": 8, "iterations": 20, "modules": {
        "parts": parts,
        "unattributed": {"replays": unattributed, "seconds": 0.0, "ops": 0},
        "eager": {"seconds": 1e-4, "ops": 40},
        "device": {"seconds": step_s + 6e-3 + 1e-4, "ops": 7400}},
        "idle_gaps": {"graphs.replay": 0.01}},
        "recorded": {"frames": 256, "iterations": 700, "host_reads": 690,
                     "frame_ms": 7.9, "wall_s": 2.0, "replay_device_s": 1.5,
                     "replay_less_launch_s": 1.4,
                     "replay_host_s": 0.0256, "host_path_s": 0.0512,
                     "replays": 1468, "untimed": untimed}}


def test_each_reader_computes_its_metric():
    ctx = {"device": "cuda", "program": program()}
    for short, mark in STEP_READERS.items():
        mods = ctx["program"]["profile"]["modules"]["parts"][
            program_window.STEP]["modules"]
        assert reader(f"{short}_ms_per_iter.frame")(ctx) == pytest.approx(
            1e3 * mods[mark]["seconds"] / 20)
    assert reader("prologue_ms.frame")(ctx) == pytest.approx(0.5)
    assert reader("epilogue_ms.frame")(ctx) == pytest.approx(0.25)
    assert reader("host_reads_per_iter.frame")(ctx) == pytest.approx(
        690 / 700)
    assert reader("graph_idle.frame")(ctx) == pytest.approx(25.0)
    assert reader("graph_launch_us.frame")(ctx) == pytest.approx(100.0)
    assert reader("host_path_us.frame")(ctx) == pytest.approx(200.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_on_the_cpu_or_without_the_program(name):
    read = reader(name)
    assert read({"device": "cpu", "program": program()}) is None
    assert read({"device": "cuda", "program": None}) is None


def test_an_unattributed_replay_or_an_untimed_one_reports_nothing():
    ctx = {"device": "cuda", "program": program(unattributed=1)}
    for name in NAMES[:8]:
        assert reader(name)(ctx) is None, name
    assert reader("host_reads_per_iter.frame")(ctx) is not None
    ctx = {"device": "cuda", "program": program(untimed=3)}
    assert reader("graph_idle.frame")(ctx) is None
    assert reader("graph_launch_us.frame")(ctx) is not None


def test_the_report_names_every_module():
    lines = program_window.report(program())
    text = "\n".join(lines)
    for mark in STEP_READERS.values():
        assert f"    {mark}: " in text
    assert "unattributed replays 0" in text
    assert "graphs.replay" in lines[-3]
    # graph_idle.frame's lower bound and the upper one, launches off
    assert "25.0000 (graph_idle.frame" in lines[-2]
    assert "30.0000 (each replay's host time" in lines[-2]
