"""Port parity for the whole slice: the method matrix of
``configs/cylinder.yaml`` (all seven rows: the SO(3) family, XICP and
SuperLoc) through the port's ``TestRunner`` against
``dcreg_tpu.harness.TestRunner`` on the same small synthetic cylinder,
f64 on the CPU, on the CSR grid backend, plus the CLI, the config loader
and the PCD reader/writer.  ``tests/test_torch_harness_matrix.py`` holds
the parking-lot rows and the Euler family to the same checks, which live
here as ``check_*`` functions;
``tests/test_torch_harness_rows.py`` runs every row of every config.

Stated tolerances: per-method statistics within rtol 1e-6 (times
excepted); every artifact file with the same header line and the same
number of rows; every numeric cell that is not a time within rtol 1e-6
(atol 1e-9 for cells near zero).
"""
import csv
import math
import os

import numpy as np
import pytest
import torch

from chip_smoke import synthetic_cylinder
from dcreg_tpu.config import load_config as j_load_config
from dcreg_tpu.harness import TestRunner as JRunner
from dcreg_tpu.io.pcd import load_pcd as j_load_pcd
from dcreg_tpu.io.pcd import save_pcd as j_save_pcd
from dcreg_tpu_torch import cli
from dcreg_tpu_torch.config import load_config
from dcreg_tpu_torch.harness import TestRunner as TRunner
from dcreg_tpu_torch.io.pcd import jet_color, load_pcd, save_pcd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYLINDER = os.path.join(ROOT, "configs", "cylinder.yaml")
CYLINDER_ROWS = [m[0] for m in load_config(CYLINDER).test_methods]
# columns (by header name) and pcg.txt fields that hold times
TIME_COLUMNS = {"Time_ms", "IterTimeMs"}
PCG_TIME_FIELDS = {5, 6}          # time_pcg_ms, time_qr_direct_ms


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pts = synthetic_cylinder(11, 1800).astype(np.float64)
    j_out = str(tmp_path_factory.mktemp("jax_out"))
    t_out = str(tmp_path_factory.mktemp("torch_out"))
    jc = j_load_config(CYLINDER)._replace(output_folder=j_out)
    tc = load_config(CYLINDER)._replace(output_folder=t_out)
    return run_both(jc, tc, pts, j_out, t_out)


def run_both(jc, tc, pts, j_out, t_out):
    """The JAX and the port's TestRunner over ``pts`` (source == target)
    with configs ``jc`` and ``tc``, artifacts into ``j_out`` / ``t_out``."""
    jr = JRunner(jc)
    jr.load_point_clouds(pts, pts)
    jr.run_all()
    tr = TRunner(tc, device="cpu")
    tr.load_point_clouds(pts, pts)
    tr.run_all()
    return jr, tr, j_out, t_out


def _is_number(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def _close(a, b):
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-9)


def check_statistics(jr, tr, rows):
    """Per-method statistics of ``rows`` (times excepted) and SuperLoc's
    record fields within rtol 1e-6."""
    assert set(tr.stats) == set(jr.stats) == set(rows)
    for m in rows:
        for key, ref in jr.stats[m].items():
            if key.startswith("time"):
                continue
            assert _close(tr.stats[m][key], ref), (m, key)
    for rj, rt in zip(jr.records, tr.records):
        assert rt.method == rj.method
        sj, st = getattr(rj, "superloc", None), getattr(rt, "superloc", None)
        assert (sj is None) == (st is None), rj.method
        for key, ref in (sj or {}).items():
            np.testing.assert_allclose(st[key], ref, rtol=1e-6,
                                       err_msg=key)


def test_statistics_match(runs):
    jr, tr, _, _ = runs
    check_statistics(jr, tr, CYLINDER_ROWS)
    # the scenario exercises the method matrix: DCReg converges and flags
    # a degenerate direction at iteration 0
    ours = next(r for r in tr.records if r.method == "Ours")
    assert ours.converged and bool(ours.result.log.degenerate_mask[0].any())


@pytest.mark.parametrize("method", CYLINDER_ROWS)
def test_engine_results_match(runs, method):
    """Each row's engine on the CSR grid backend, as each method run of
    the two harnesses called it (each side built its own grid)."""
    check_engine_results(*runs[:2], method)


def check_engine_results(jr, tr, method):
    """converged, aborted and iterations identical; R and t within 1e-8;
    on executed rows the spectra within rtol 1e-6 and degenerate_mask
    identical."""
    rj = next(r for r in jr.records if r.method == method).result
    rt = next(r for r in tr.records if r.method == method).result
    for f in ("converged", "aborted", "iterations"):
        assert np.array_equal(np.asarray(getattr(rt, f)),
                              np.asarray(getattr(rj, f))), f
    np.testing.assert_allclose(rt.R, np.asarray(rj.R), atol=1e-8)
    np.testing.assert_allclose(rt.t, np.asarray(rj.t), atol=1e-8)
    ex = np.asarray(rj.log.executed)
    assert np.array_equal(rt.log.executed, ex)
    assert np.array_equal(rt.log.degenerate_mask[ex],
                          np.asarray(rj.log.degenerate_mask)[ex])
    for f in ("eigenvalues_full", "singular_values", "lambda_schur_rot",
              "lambda_schur_trans", "cond_schur_rot", "cond_schur_trans"):
        np.testing.assert_allclose(getattr(rt.log, f)[ex],
                                   np.asarray(getattr(rj.log, f))[ex],
                                   rtol=1e-6, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(rt.covariance, np.asarray(rj.covariance),
                               rtol=1e-6, atol=1e-12)


def _artifacts(out):
    return sorted(f for f in os.listdir(out) if not f.endswith(".pcd"))


def test_artifacts_same_headers_and_rows(runs):
    names = check_artifacts(*runs[2:])
    assert "pcg.txt" in names


def check_artifacts(j_out, t_out):
    """The same artifact files, each with the JAX one's header line and
    number of lines; returns their names."""
    names = _artifacts(j_out)
    assert names == _artifacts(t_out)
    assert "all_results.csv" in names
    for name in names:
        with open(os.path.join(j_out, name)) as f:
            ref = f.read().splitlines()
        with open(os.path.join(t_out, name)) as f:
            ours = f.read().splitlines()
        assert len(ours) == len(ref), name
        if name != "pcg.txt":              # pcg.txt has no header line
            assert ours[0] == ref[0], name
    return names


@pytest.mark.parametrize("name", [
    "all_results.csv", "iteration_history.csv",
    "iteration_details_with_dx.csv", "transform_details.csv",
    "condition_numbers_detailed.csv", "iteration_timing_provenance.csv"])
def test_csv_cells_match(runs, name):
    check_csv_cells(*runs[2:], name)


def check_csv_cells(j_out, t_out, name):
    with open(os.path.join(j_out, name)) as f:
        ref = list(csv.DictReader(f))
    with open(os.path.join(t_out, name)) as f:
        ours = list(csv.DictReader(f))
    assert len(ours) == len(ref) > 0
    for r_ref, r_ours in zip(ref, ours):
        for key, v in r_ref.items():
            if key in TIME_COLUMNS:
                continue
            if _is_number(v):
                assert _close(r_ours[key], v), (name, key, v, r_ours[key])
            else:
                assert r_ours[key] == v, (name, key)


def test_pcg_and_text_artifacts_match(runs):
    check_text_artifacts(*runs[2:])


def check_text_artifacts(j_out, t_out):
    """pcg.txt (where a PCG row ran) and the two degeneracy analyses."""
    if not os.path.isfile(os.path.join(j_out, "pcg.txt")):
        assert not os.path.isfile(os.path.join(t_out, "pcg.txt"))
        return check_degeneracy_text(j_out, t_out)
    with open(os.path.join(j_out, "pcg.txt")) as f:
        ref = [line.split() for line in f]
    with open(os.path.join(t_out, "pcg.txt")) as f:
        ours = [line.split() for line in f]
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert len(a) == len(b) == 17
        for i, (x, y) in enumerate(zip(a, b)):
            if i not in PCG_TIME_FIELDS:
                assert _close(x, y), (i, x, y)
    check_degeneracy_text(j_out, t_out)


def check_degeneracy_text(j_out, t_out):
    for name in ("degeneracy_analysis_first_iter.txt",
                 "degeneracy_analysis_last_iter.txt"):
        with open(os.path.join(j_out, name)) as f:
            ref = f.read().split()
        with open(os.path.join(t_out, name)) as f:
            ours = f.read().split()
        assert len(ours) == len(ref)
        for x, y in zip(ours, ref):
            if _is_number(x) and _is_number(y):
                assert _close(x, y), (name, x, y)
            else:
                assert x == y, (name, x, y)


def test_cli_runs_on_cpu(tmp_path, capsys):
    pts = synthetic_cylinder(12, 1200)
    src = tmp_path / "cloud.pcd"
    save_pcd(str(src), pts)
    out = tmp_path / "out"
    rc = cli.main(["--config", CYLINDER, "--device", "cpu", "--source",
                   str(src), "--output", str(out), "--methods", "Ours"])
    assert rc == 0
    with open(out / "all_results.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["Method"] for r in rows] == ["Ours"]
    assert "Ours: conv=" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not in the config"):
        cli.main(["--config", CYLINDER, "--device", "cpu", "--source",
                  str(src), "--methods", "Nope"])
    with pytest.raises(SystemExit):                      # f64 needs the CPU
        cli.main(["--config", CYLINDER, "--device", "cpu", "--f64",
                  "--f32", "--source", str(src)])


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(ROOT, "configs"))
    if f.endswith(".yaml")))
def test_config_loader_matches(name):
    path = os.path.join(ROOT, "configs", name)
    jc, tc = j_load_config(path), load_config(path)
    for f in tc._fields:
        if f in ("initial_noise", "gt_pose", "xicp"):
            assert tuple(getattr(tc, f)) == tuple(getattr(jc, f)), f
        else:
            assert getattr(tc, f) == getattr(jc, f), f
    np.testing.assert_allclose(tc.initial_matrix(), jc.initial_matrix(),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tc.gt_matrix(), jc.gt_matrix(), rtol=1e-12,
                               atol=1e-15)
    assert [(n, d.value, h.value) for n, d, h in tc.methods()] == \
        [(n, d.value, h.value) for n, d, h in jc.methods()]
    assert tc.icp_params()._asdict().keys() == jc.icp_params()._asdict(
    ).keys()


@pytest.mark.parametrize("fields", ["xyz", "intensity", "rgb"])
def test_pcd_round_trip_against_jax(tmp_path, fields):
    rng = np.random.default_rng(14)
    xyz = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    kw = {}
    if fields == "intensity":
        kw["intensity"] = rng.uniform(0, 1, 50).astype(np.float32)
    elif fields == "rgb":
        kw["rgb"] = jet_color(rng.uniform(0, 0.3, 50), 0.2)
    ours, ref = tmp_path / "ours.pcd", tmp_path / "ref.pcd"
    save_pcd(str(ours), xyz, **kw)
    j_save_pcd(str(ref), xyz, **kw)
    assert ours.read_bytes() == ref.read_bytes()
    a = load_pcd(str(ours), prefer_native=False)
    b = j_load_pcd(str(ref), prefer_native=False)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    save_pcd(str(ours), xyz, binary=False)
    assert np.array_equal(load_pcd(str(ours))["xyz"], xyz)
    assert torch.is_tensor(torch.as_tensor(a["xyz"]))


def _record(converged, moves):
    """A stand-in method record whose iteration k moved the pose to
    x = moves[k]."""
    from types import SimpleNamespace
    T = np.repeat(np.eye(4)[None], len(moves), axis=0)
    T[:, 0, 3] = moves
    log = SimpleNamespace(transform=T)
    return SimpleNamespace(converged=converged, n_iters=len(moves),
                           last_iter=lambda: len(moves) - 1,
                           result=SimpleNamespace(log=log))


@pytest.mark.parametrize("case", ["converged", "iteration_limit",
                                  "converged_apart", "early_apart"])
def test_backend_agreement_rule(case):
    """chip_smoke's backend gate: a method that converged on both
    backends is held at its final poses, one that ran to the iteration
    limit at iteration AGREE_ITERS only."""
    from chip_smoke import AGREE_ITERS, backend_agreement
    n = 30
    # apart only late in the run
    drift = np.where(np.arange(n) >= 2 * AGREE_ITERS, 5e-4, 0.0)
    same = np.linspace(0.0, 1.0, n)
    if case == "converged":       # one more step that lands on the pose
        a, b = _record(True, same[:6]), _record(True, same[[0, 1, 2, 3, 4,
                                                             5, 5]])
        want = (True, "final")
    elif case == "iteration_limit":
        a, b = _record(False, same), _record(False, same + drift)
        want = (True, f"iteration {AGREE_ITERS}")
    elif case == "converged_apart":
        a, b = _record(True, same[:6]), _record(True, same[:6] + 2e-4)
        want = (False, "final")
    else:
        a, b = _record(False, same), _record(False, same + 2e-4)
        want = (False, f"iteration {AGREE_ITERS}")
    out = backend_agreement(a, b)
    assert (out["ok"], out["compared_at"]) == want
