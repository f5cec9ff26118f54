"""Port parity of the rows only ``configs/parkinglot.yaml`` has (O3D and
the four XICP variants), with its parameters and the cylinder's poses
(its frames are not in the repository), through the two
``TestRunner``s, f64 on the CPU, CSR grid backend, on the same small
synthetic cylinder (``chip_smoke.pair_scenarios()["parkinglot"]``, as
phase 6 of ``chip_smoke.py`` runs it on the card);
``tests/test_torch_harness_euler.py`` holds the Euler family.

Stated tolerances: as ``tests/test_torch_harness.py``, whose ``check_*``
functions these tests call.
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from chip_smoke import PARKING_ROWS, pair_scenarios, synthetic_cylinder
from dcreg_tpu.config import load_config as j_load_config
from dcreg_tpu_torch.config import load_config
from test_torch_harness import (check_artifacts, check_csv_cells,
                                check_engine_results, check_statistics,
                                check_text_artifacts, run_both)

SCENARIO = "parkinglot"
ROWS = PARKING_ROWS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pts = synthetic_cylinder(11, 1800).astype(np.float64)
    j_out = str(tmp_path_factory.mktemp("jax_out"))
    t_out = str(tmp_path_factory.mktemp("torch_out"))
    jc = pair_scenarios(j_load_config)[SCENARIO]._replace(
        output_folder=j_out)
    tc = pair_scenarios(load_config)[SCENARIO]._replace(
        output_folder=t_out)
    return run_both(jc, tc, pts, j_out, t_out)


def test_statistics_match(runs):
    jr, tr, _, _ = runs
    check_statistics(jr, tr, ROWS)
    assert all(r.n_iters >= 2 for r in tr.records)


@pytest.mark.parametrize("method", ROWS)
def test_engine_results_match(runs, method):
    check_engine_results(*runs[:2], method)


def test_artifacts_same_headers_and_rows(runs):
    names = check_artifacts(*runs[2:])
    assert "pcg.txt" not in names         # no row solves by PCG


@pytest.mark.parametrize("csv_name", [
    "all_results.csv", "iteration_history.csv",
    "iteration_details_with_dx.csv", "transform_details.csv",
    "condition_numbers_detailed.csv", "iteration_timing_provenance.csv"])
def test_csv_cells_match(runs, csv_name):
    check_csv_cells(*runs[2:], csv_name)


def test_pcg_and_text_artifacts_match(runs):
    check_text_artifacts(*runs[2:])

