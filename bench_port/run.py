"""Benchmark of the PyTorch and CUDA port (``dcreg_tpu_torch``) on NVIDIA
GPUs: one run of one cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload map53m.stream --seed 7 \
        --seconds 20 --trace 0

Run from the root of a checkout.  The last line of standard output is the
result (JSON); the last lines of standard error are the numbers the
correctness check compared, each beside its limit.  Without a CUDA device
(or with fewer than the cell asks for) it exits 2 and prints no result;
if JAX or the JAX package was loaded, it exits 3.
"""
import time

T_START = time.perf_counter()

import argparse                                            # noqa: E402
import json                                                # noqa: E402
import os                                                  # noqa: E402
import sys                                                 # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(HERE, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, HERE)
sys.path.insert(1, os.getcwd())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    with open("BENCHMARK.json") as f:
        chips = {w["name"]: w["chips"]
                 for w in json.load(f)["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    import harness
    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"bench_port: loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
