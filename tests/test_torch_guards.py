"""Guards of the port: no JAX anywhere in it, no silent CPU fallback, and
the boundary of its hand-written kernels (``cuda_build.Kernel``): a
tensor that is not on the CPU raises rather than falls back when the
kernel cannot be built, and reaches the plain twin only on the twin
route."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu_torch import cuda_build
from dcreg_tpu_torch.models import icp_batch as tib
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.models.icp import ICPParams
from dcreg_tpu_torch.ops import block_knn as tk
from dcreg_tpu_torch.ops import block_sparse as tbs
from dcreg_tpu_torch.ops import degeneracy as tdeg

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dcreg_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dcreg_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_imports_ast(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}: imports {bad}"


def test_no_jax_in_sys_modules():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT_FILES]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'dcreg_tpu')]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbs.build_block_index(pts, tb=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbs.build_map_index(pts, tb=128, sb=4)
    mi = tbs.build_map_index(pts, tb=128, sb=4, device="cpu")
    R0 = np.eye(3, dtype=np.float32)[None]
    t0 = np.zeros((1, 3), np.float32)
    det = tdeg.DetectionMethod.SCHUR_CONDITION_NUMBER
    hand = tdeg.HandlingMethod.PRECONDITIONED_CG
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tib.icp_batch_so3(pts, pts, R0, t0, det, hand, ICPParams(), mi.block,
                          64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        todo.run_odometry_map(pts[None], mi, pts, num_supers=2,
                              max_per_query=4, num_pairs=64)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        tbs.build_block_index(pts, tb=128, device="cuda")
    # explicit CPU runs
    out = tib.icp_batch_so3(pts, pts, R0, t0, det, hand,
                            ICPParams(max_iterations=2), mi.block, 64,
                            device="cpu")
    assert out.R.device.type == "cpu"


def test_tf32_guard(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    pts = np.zeros((10, 3), np.float32)
    bi = tbs.build_block_index(pts, tb=128, device="cpu")
    with pytest.raises(RuntimeError, match="TF32"):
        tib.icp_batch_so3(pts, pts, np.eye(3)[None], np.zeros((1, 3)),
                          tdeg.DetectionMethod.SCHUR_CONDITION_NUMBER,
                          tdeg.HandlingMethod.PRECONDITIONED_CG,
                          ICPParams(), bi, 64, device="cpu")


def _device_inputs(device):
    nq, B, P = 2, 3, 4
    e = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    return (e(nq, 3, 128), e(5, 3, 128), e(B, 12),
            torch.tensor([0, 0, 1, 2], dtype=torch.int32, device=device),
            e(P, dt=torch.int32), e(P, dt=torch.int32))


KERNELS = ("K1", "K2", "K3", "pcg6", "plane_fit")
NO_NVCC = (RuntimeError, "nvcc not found")


def _boundary(label, device):
    """(``label``'s Kernel, calls of its boundary on ``device``: the
    boundary itself first, then the searches over it, each with the
    error it raises on a "meta" tensor with no nvcc, whether it gets as
    far as the build).  "meta" tensors stand in for CUDA tensors on a
    machine without a card."""
    from dcreg_tpu_torch.ops import knn as tknn
    from dcreg_tpu_torch.ops import knn_kernels as tkk
    from dcreg_tpu_torch.ops import soa_tail, solvers
    if label == "K1":
        args = _device_inputs(device)
        bad = list(args)
        bad[2] = bad[2].to(torch.float64)
        return tk.K1, [
            (lambda: tk.block_knn_keys(*args, None, 11, 1.0, 1.1), NO_NVCC),
            # argument checks run before any build
            (lambda: tk.block_knn_keys(*bad, None, 11, 1.0, 1.1),
             (TypeError, "float32"))]
    q = torch.zeros((20, 3), device=device)
    t = torch.rand((300, 3)).to(device)
    pen = torch.zeros(300, device=device)
    if label == "K2":
        return tkk.K2, [
            (lambda: tkk.knn_candidates(q, t, pen, 10), NO_NVCC),
            (lambda: tkk.knn(q, t, k=5), NO_NVCC),
            (lambda: tknn.nn1(q, t), NO_NVCC),
            # f64 on a device other than the CPU raises before any search
            (lambda: tknn.knn(q.double(), t.double(), k=5),
             (ValueError, "CPU only"))]
    if label == "K3":
        return tkk.K3, [(lambda: tkk.group_min(q, t, pen), NO_NVCC),
                        (lambda: tkk.knn_grouped(q, t, k=5), NO_NVCC)]
    if label == "pcg6":
        H = torch.eye(6).expand(2, 6, 6) * torch.arange(1.0, 7.0)
        a = tdeg.analyze(H, tdeg.DetectionMethod.SCHUR_CONDITION_NUMBER,
                         tdeg.DegeneracyThresholds(), fast=True)
        H, g = H.to(device), torch.ones((2, 6), device=device)
        a = tdeg.DegeneracyAnalysis(*[f.to(device) for f in a])
        return solvers.PCG6, [
            (lambda: solvers.solve_pcg_fast(H, g, a,
                                            tdeg.DegeneracyThresholds()),
             (ValueError, "CUDA device"))]
    idx = torch.randint(0, 300, (2, 5, 20), dtype=torch.int32).to(device)
    params = soa_tail.CorrespondenceParams()
    return soa_tail.PLANE_FIT, [
        (lambda: soa_tail._plane_fit(t, idx, params),
         (ValueError, "CUDA device"))]


def _counts(kernel):
    return (kernel.launches, kernel.launches_replayed,
            dict(kernel.launches_by_kk), kernel.last_grid)


def _no_nvcc(monkeypatch, tmp_path, kernel):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(kernel, "_fn", None)


@pytest.mark.parametrize("label", KERNELS)
def test_card_tensors_raise_instead_of_falling_back(label, monkeypatch,
                                                    tmp_path):
    """A tensor that is not on the CPU never reaches the plain twin: with
    no kernel library to be had, the boundary raises, and counts no
    launch; a watcher sees the operands first.  The same call on CPU
    tensors takes the twin and counts nothing."""
    kernel, calls = _boundary(label, "meta")
    _no_nvcc(monkeypatch, tmp_path, kernel)
    before, seen = _counts(kernel), []
    with kernel.watching(lambda *ops: seen.append(ops)):
        for call, (err, match) in calls:
            with pytest.raises(err, match=match):
                call()
    assert seen and all(ops[0].device.type == "meta" for ops in seen)
    if calls[0][1] is NO_NVCC:
        monkeypatch.setattr(kernel, "source", tmp_path / "missing.cu")
        with pytest.raises(FileNotFoundError):
            calls[0][0]()
    assert kernel._fn is None and not (tmp_path / "build").exists()
    assert _counts(kernel) == before
    _, cpu_calls = _boundary(label, "cpu")
    cpu_calls[0][0]()
    assert _counts(kernel) == before


@pytest.mark.parametrize("label", KERNELS)
def test_the_twin_route_takes_card_tensors_to_the_twin(label, monkeypatch,
                                                       tmp_path):
    """On the twin route (``Kernel.through_the_twin``) a tensor that is
    not on the CPU reaches the plain twin, builds nothing and counts no
    launch; after it the boundary launches (or raises) again."""
    kernel, calls = _boundary(label, "meta")
    _no_nvcc(monkeypatch, tmp_path, kernel)
    before, seen = _counts(kernel), []

    def twin(*ops):
        seen.append(ops)
        return "twin"

    monkeypatch.setattr(kernel, "twin", twin)
    with kernel.through_the_twin():
        assert calls[0][0]() == "twin"
    assert len(seen) == 1 and seen[0][0].device.type == "meta"
    assert kernel._fn is None and not (tmp_path / "build").exists()
    assert _counts(kernel) == before
    err, match = calls[0][1]
    with pytest.raises(err, match=match):
        calls[0][0]()


def test_every_cuda_source_has_a_kernel():
    """``cuda_build.kernels()`` finds each kernel declared in the ops
    modules, and every CUDA source has one."""
    ks = cuda_build.kernels()
    assert sorted(k.label for k in ks) == sorted(KERNELS)
    assert {k.source.name for k in ks} == {
        p.name for p in cuda_build.CSRC.glob("*.cu")}


def test_pair_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """The pair-mode entry points, the harness and the CLI need a card
    unless told device='cpu'."""
    from dcreg_tpu_torch import cli
    from dcreg_tpu_torch.config import load_config
    from dcreg_tpu_torch.harness import TestRunner
    from dcreg_tpu_torch.io.pcd import save_pcd
    from dcreg_tpu_torch.models.icp import icp_point_to_plane_so3
    from dcreg_tpu_torch.ops import voxel_grid as tvg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(1).uniform(-1, 1, (300, 3))
    det = tdeg.DetectionMethod.SCHUR_CONDITION_NUMBER
    hand = tdeg.HandlingMethod.PRECONDITIONED_CG
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvg.build_grid_index(pts, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        icp_point_to_plane_so3(pts, pts, np.eye(3), np.zeros(3), det, hand)
    cfg = load_config(str(ROOT / "configs" / "cylinder.yaml"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TestRunner(cfg)
    src = tmp_path / "c.pcd"
    save_pcd(str(src), pts)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        cli.main(["--config", str(ROOT / "configs" / "cylinder.yaml"),
                  "--source", str(src)])
    # explicit CPU runs
    g = tvg.build_grid_index(pts, 1.0, device="cpu")
    assert g.points.device.type == "cpu"
    out = icp_point_to_plane_so3(pts, pts, np.eye(3), np.zeros(3), det,
                                 hand, ICPParams(max_iterations=2),
                                 device="cpu")
    assert out.R.device.type == "cpu"
    assert TestRunner(cfg, device="cpu").device.type == "cpu"


def test_test_runner_dtype_follows_device(monkeypatch):
    """With no dtype given, the harness runs f64 on the CPU and f32 on
    the card, whose k-NN runs no f64; an explicit dtype stands."""
    from dcreg_tpu_torch.config import load_config
    from dcreg_tpu_torch.harness import TestRunner
    cfg = load_config(str(ROOT / "configs" / "cylinder.yaml"))
    assert TestRunner(cfg, device="cpu").dtype == torch.float64
    assert TestRunner(cfg, dtype=torch.float32,
                      device="cpu").dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    runner = TestRunner(cfg)
    assert (runner.device.type, runner.dtype) == ("cuda", torch.float32)


def test_voxel_odometry_entry_points_raise_without_gpu(monkeypatch):
    """The voxel index, the voxel odometry loop and the pose graph need a
    card unless told device='cpu'."""
    from dcreg_tpu_torch.models import pose_graph as tpg
    from dcreg_tpu_torch.ops import voxel_grid as tvg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(2).uniform(-3, 3, (400, 3))
    poses = np.broadcast_to(np.eye(4), (3, 4, 4)).copy()
    poses[:, 0, 3] = [0.0, 1.0, 2.0]
    Z = np.linalg.inv(poses[:-1]) @ poses[1:]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvg.build_voxel_grid(pts, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        todo.run_odometry(pts[None], pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpg.make_edges([0, 1], [1, 2], Z)
    edges = tpg.make_edges([0, 1], [1, 2], Z, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpg.optimize_pose_graph(poses, edges)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        tpg.optimize_pose_graph(poses, edges, device="cuda")
    # explicit CPU runs
    assert tvg.build_voxel_grid(pts, 1.0, device="cpu").points.device.type \
        == "cpu"
    out = todo.run_odometry(pts[None], pts,
                            params=todo.OdometryParams(icp_iterations=1),
                            device="cpu")
    assert out.poses.device.type == "cpu"
    res = tpg.optimize_pose_graph(poses, edges, max_gn_iters=1, device="cpu")
    assert res.poses.device.type == "cpu"
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        todo.run_odometry(pts[None], pts, device="cpu")
    with pytest.raises(RuntimeError, match="TF32"):
        tpg.optimize_pose_graph(poses, edges, device="cpu")
