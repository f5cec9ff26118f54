"""Run the method matrices of ``chip_smoke.py`` phase 6 on the CPU.

    python3 cylinder_rehearsal.py [--seed 7] [--engine jax|torch|both]
                                  [--matrices cylinder,parkinglot,euler]

Phase 6's matrices (``chip_smoke.pair_scenarios``: every row of
configs/cylinder.yaml; the parking-lot-only rows with
configs/parkinglot.yaml's parameters; the SO(3) rows through the Euler
engine) go through the JAX reference harness
(``dcreg_tpu.harness.TestRunner``) and/or the port's
(``dcreg_tpu_torch.harness.TestRunner``), both in float32 on the CPU, on
``chip_smoke.synthetic_cylinder(seed)``, phase 6's world (source ==
target), once with the CSR grid search and once with the brute-force
k-NN.  It prints one JSON object per engine, matrix and backend (per
method: iterations, converged, translation and rotation error, the
iteration-0 degeneracy mask), then per engine and matrix the backend
agreement of ``chip_smoke``'s gate (``backend_agreement``) and whether
Ours meets its gate.  It shows whether a world meets phase 6's gates on
the reference itself, and predicts the port's numbers on the card.  It
writes the artifacts into a temporary folder and removes it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np

import chip_smoke


def jax_engine():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from dcreg_tpu.config import load_config
    from dcreg_tpu.harness import TestRunner
    return load_config, lambda c: TestRunner(c, dtype=jnp.float32)


def torch_engine():
    import torch
    from dcreg_tpu_torch.config import load_config
    from dcreg_tpu_torch.harness import TestRunner
    return load_config, lambda c: TestRunner(c, dtype=torch.float32,
                                             device="cpu")


def _drive(make_runner, cfg, world):
    out = tempfile.mkdtemp(prefix="dcreg_rehearsal_")
    try:
        runner = make_runner(cfg._replace(output_folder=out))
        runner.load_point_clouds(world, world)
        runner.run_all()
        return {r.method: r for r in runner.records}, runner.stats
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--engine", default="both",
                    choices=["jax", "torch", "both"])
    ap.add_argument("--matrices", default="cylinder,parkinglot,euler")
    args = ap.parse_args(argv)
    world = chip_smoke.synthetic_cylinder(args.seed)
    engines = {"jax": jax_engine, "torch": torch_engine}
    if args.engine != "both":
        engines = {args.engine: engines[args.engine]}
    ok = True
    for name, engine in engines.items():
        load_config, make_runner = engine()
        scenarios = chip_smoke.pair_scenarios(load_config)
        for matrix in args.matrices.split(","):
            cfg = scenarios[matrix]
            rows = [m for m, _, _ in cfg.methods()]
            runs = {}
            for backend, use_grid in (("grid", True), ("brute", False)):
                recs, stats = _drive(make_runner,
                                     cfg._replace(use_grid_index=use_grid),
                                     world)
                runs[backend] = recs
                print(json.dumps({
                    "engine": name, "matrix": matrix, "backend": backend,
                    "points": len(world),
                    "methods": {m: {
                        "iterations": recs[m].n_iters,
                        "converged": recs[m].converged,
                        "te_m": stats[m]["trans_error_mean"],
                        "re_deg": stats[m]["rot_error_mean"],
                        "mask_iter0": [int(v) for v in np.asarray(
                            recs[m].result.log.degenerate_mask[0])]}
                        for m in rows}}), flush=True)
                if "Ours" in recs and cfg.use_so3_parameterization:
                    ours, s = recs["Ours"], stats["Ours"]
                    ok &= bool(ours.converged
                               and s["trans_error_mean"] < 0.05
                               and s["rot_error_mean"] < 0.5
                               and np.asarray(
                                   ours.result.log.degenerate_mask[0]).any())
            agree = {m: chip_smoke.backend_agreement(runs["grid"][m],
                                                     runs["brute"][m])
                     for m in rows}
            ok &= all(d["ok"] for d in agree.values())
            print(json.dumps({"engine": name, "matrix": matrix,
                              "backends_agree": agree}), flush=True)
    print(json.dumps({"gates_met": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
