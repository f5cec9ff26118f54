"""Readings of the correctness check: the program's (the lower reading)
and its control's (the upper reading), on the chip at a cell's own size.

    python3 bench_port/control.py --workload corridor.stream \
        --seeds 11 12 13 --seconds 3

For each seed the cell is set up as a run sets it up and its traffic runs
for ``--seconds``; then, on the answers a run would sample:

  * ``program``: the port's answers against the float64 reference;
  * ``control``: the reference in TF32 (float32, the operands of every
    matrix product rounded to TF32, the precision below the
    configuration's float32 with TF32 off), put in the program's place:
    its own registrations from the same inputs, judged the same way;
  * ``float32``: the reference in float32, for comparison.

Prints one JSON line per seed with the three readings and the cell's
limits.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.getcwd())


def as_answer(a: dict, out: dict) -> dict:
    """The reference's registration ``out`` as an answer in the place of
    the program's answer ``a``."""
    import numpy as np
    k = out["steps"]
    T = np.eye(4)
    T[:3, :3] = out["R"][k].double().cpu().numpy()
    T[:3, 3] = out["t"][k].double().cpu().numpy()
    b = dict(a, pose=T, iterations=k, rmse=out["rmse"][k])
    ana = out["ana"][k]
    if a["kind"] == "frame":
        b.update(cond_schur_rot=ana["cond_rot"],
                 cond_schur_trans=ana["cond_trans"],
                 cond_full=ana["cond_full"], is_degenerate=ana["degenerate"],
                 degenerate_mask=ana["mask"])
    else:
        b["H_last"] = out["H"][k].double().cpu().numpy()
    return b


def readings(workload, seed, seconds, device="cuda", root=".", search=()):
    import torch
    import check
    import harness
    from reference import icp as ref
    from seeds import generator
    from dcreg_tpu_torch.utils import precise
    reg = harness.Registry(root, search)
    _, cfg, traffic, limits = reg.cell(workload)
    precise()
    parts = harness.Parts(device)
    scene = reg.module("scenes", cfg["scene"] + ".py").make(cfg, seed, device)
    driver = reg.module("drivers", traffic["driver"] + ".py").Driver(
        cfg, traffic, scene, device, parts, seed)
    driver.window(seconds)
    answers = driver.answers(generator(seed, "check", "cpu"))
    driver.release()
    method, icp = tuple(traffic["method"]), cfg["icp"]
    world = scene["world"]
    out = {"workload": workload, "seed": seed, "answers": len(answers),
           "program": check.run_reference(answers, world, method, icp)}
    for name, precision in (("control", "tf32"), ("float32", "float32")):
        with torch.no_grad():
            mine = [as_answer(a, ref.register(a["scan"], world,
                                              a["seed_pose"], method, icp,
                                              precision))
                    for a in answers]
        out[name] = check.run_reference(mine, world, method, icp)
    out["limits"] = limits
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
