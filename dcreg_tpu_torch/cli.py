"""Command line entry point: run a config's method matrix (counterpart of
``dcreg_tpu/cli.py``).

Usage:  python -m dcreg_tpu_torch.cli --config configs/cylinder.yaml \
            [--output DIR] [--device cuda|cpu] [--f32|--f64] \
            [--source PCD] [--target PCD] [--methods NAME,...]

The device is ``cuda`` unless ``--device cpu`` is given; with no card that
raises.  The dtype is f32 on the card (as the TPU ran) and f64 on the
CPU unless ``--f32``/``--f64`` says otherwise; f64 runs on the CPU only.
``--methods`` keeps only the named rows of the config's matrix.
"""
from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="dcreg_tpu_torch method matrix")
    ap.add_argument("--config", required=True, help="YAML config path "
                    "(reference icp.yaml format)")
    ap.add_argument("--output", default=None, help="override output folder")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    prec = ap.add_mutually_exclusive_group()
    prec.add_argument("--f32", action="store_true", help="force float32")
    prec.add_argument("--f64", action="store_true",
                      help="force float64 (CPU only)")
    ap.add_argument("--source", default=None, help="override source PCD path")
    ap.add_argument("--target", default=None, help="override target PCD path")
    ap.add_argument("--methods", default=None,
                    help="comma-separated method names to run (default: "
                         "the config's whole matrix)")
    args = ap.parse_args(argv)

    from .config import load_config, select_methods
    from .harness import TestRunner
    from .io.pcd import load_pcd
    from .utils import precise, resolve_device

    device = resolve_device(args.device)
    use_f64 = args.f64 or (device.type == "cpu" and not args.f32)
    if use_f64 and device.type != "cpu":
        ap.error("--f64 runs on the CPU only (--device cpu)")
    precise()
    config = load_config(args.config)
    if args.output:
        config = config._replace(output_folder=args.output)
    if args.methods:
        config = select_methods(config, args.methods.split(","))

    runner = TestRunner(config, dtype=torch.float64 if use_f64
                        else torch.float32, device=device)
    if args.source:
        src = load_pcd(args.source)["xyz"]
        tgt = src if args.target in (None, args.source) else \
            load_pcd(args.target)["xyz"]
        runner.load_point_clouds(src, tgt)
    else:
        runner.load_point_clouds()
    runner.run_all()

    for name, s in sorted(runner.stats.items()):
        print(f"{name:>10s}: conv={s['success_rate']*100:5.1f}% "
              f"TE={s['trans_error_mean']:.4f}m "
              f"RE={s['rot_error_mean']:.4f}deg "
              f"iters={s['iters_mean']:.1f} time={s['time_mean']:.2f}ms")
    if config.output_folder:
        print(f"artifacts -> {config.output_folder}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
