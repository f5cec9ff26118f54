"""Run the cylinder method matrix of ``chip_smoke.py`` phase 6 on the CPU.

    python3 cylinder_rehearsal.py [--seed 7] [--engine jax|torch|both]

The five SO(3) rows of configs/cylinder.yaml go through the JAX
reference harness (``dcreg_tpu.harness.TestRunner``) and/or the port's
(``dcreg_tpu_torch.harness.TestRunner``), both in float32 on the CPU, on
``chip_smoke.synthetic_cylinder(seed)``, phase 6's world (source == target),
once with the CSR grid search and once with the brute-force k-NN.  It
prints one JSON object per engine and backend (per method: iterations,
converged, translation and rotation error, the iteration-0 degeneracy
mask), then per engine the backend agreement of ``chip_smoke``'s gate
(``backend_agreement``) and whether Ours meets its gate.  It shows whether
a world meets phase 6's gates on the reference itself, and predicts the
port's numbers on the card.  It writes the artifacts into a temporary
folder and removes it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np

import chip_smoke

ROWS = chip_smoke.SO3_ROWS


def run_jax(world, use_grid):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from dcreg_tpu.config import load_config
    from dcreg_tpu.harness import TestRunner
    cfg = load_config(chip_smoke.CYLINDER_YAML)
    cfg = cfg._replace(use_grid_index=use_grid, test_methods=tuple(
        m for m in cfg.test_methods if m[0] in ROWS))
    return _drive(TestRunner, cfg, jnp.float32, world)


def run_torch(world, use_grid):
    import torch
    from dcreg_tpu_torch.config import load_config, select_methods
    from dcreg_tpu_torch.harness import TestRunner
    cfg = select_methods(load_config(chip_smoke.CYLINDER_YAML), ROWS)
    cfg = cfg._replace(use_grid_index=use_grid)
    return _drive(lambda c, dtype: TestRunner(c, dtype=dtype, device="cpu"),
                  cfg, torch.float32, world)


def _drive(make_runner, cfg, dtype, world):
    out = tempfile.mkdtemp(prefix="dcreg_rehearsal_")
    try:
        runner = make_runner(cfg._replace(output_folder=out), dtype=dtype)
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
    args = ap.parse_args(argv)
    world = chip_smoke.synthetic_cylinder(args.seed)
    engines = {"jax": run_jax, "torch": run_torch}
    if args.engine != "both":
        engines = {args.engine: engines[args.engine]}
    ok = True
    for name, fn in engines.items():
        runs = {}
        for backend, use_grid in (("grid", True), ("brute", False)):
            recs, stats = fn(world, use_grid)
            runs[backend] = recs
            print(json.dumps({"engine": name, "backend": backend,
                              "points": len(world),
                              "methods": {m: {
                                  "iterations": recs[m].n_iters,
                                  "converged": recs[m].converged,
                                  "te_m": stats[m]["trans_error_mean"],
                                  "re_deg": stats[m]["rot_error_mean"],
                                  "mask_iter0": [int(v) for v in np.asarray(
                                      recs[m].result.log.degenerate_mask[0])]}
                                  for m in ROWS}}), flush=True)
            ours = recs["Ours"]
            s = stats["Ours"]
            ok &= bool(ours.converged and s["trans_error_mean"] < 0.05
                       and s["rot_error_mean"] < 0.5
                       and np.asarray(ours.result.log.degenerate_mask[0])
                       .any())
        agree = {m: chip_smoke.backend_agreement(runs["grid"][m],
                                                 runs["brute"][m])
                 for m in ROWS}
        ok &= all(d["ok"] for d in agree.values())
        print(json.dumps({"engine": name, "backends_agree": agree}),
              flush=True)
    print(json.dumps({"gates_met": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
