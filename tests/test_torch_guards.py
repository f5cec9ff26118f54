"""Guards of the port: no JAX anywhere in it, no silent CPU fallback, and
a K1 wrapper that raises rather than falls back when the kernel cannot be
built."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

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


def test_k1_wrapper_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A tensor that is not on the CPU never reaches the plain version:
    with no kernel library to be had, the wrapper raises.  ("meta"
    tensors stand in for CUDA tensors on a machine without a card.)"""
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tk.cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(tk.cuda_build.os.path, "exists", lambda p: False)
    tk._library.cache_clear()
    before = tk.block_knn_keys.launches
    args = _device_inputs("meta")
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tk.block_knn_keys(*args, None, 11, 1.0, 1.1)
        monkeypatch.setattr(tk, "CSRC", tmp_path / "missing.cu")
        with pytest.raises(FileNotFoundError):
            tk.block_knn_keys(*args, None, 11, 1.0, 1.1)
        # argument checks run before any build
        bad = list(args)
        bad[2] = bad[2].to(torch.float64)
        with pytest.raises(TypeError):
            tk.block_knn_keys(*bad, None, 11, 1.0, 1.1)
    finally:
        tk._library.cache_clear()
    assert tk.block_knn_keys.launches == before
    # the same call on CPU tensors takes the plain version and counts no
    # kernel launch
    keys = tk.block_knn_keys(*_device_inputs("cpu"), None, 11, 1.0, 1.1)
    assert keys.shape == (2, 3, 8, 128)
    assert tk.block_knn_keys.launches == before


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


def test_k2_k3_wrappers_raise_instead_of_falling_back(monkeypatch,
                                                      tmp_path):
    """A non-CPU tensor never reaches the K2 or K3 plain twin: with no
    kernel library to be had, knn and knn_grouped raise and no launch is
    counted ("meta" tensors stand in for CUDA tensors)."""
    from dcreg_tpu_torch.ops import knn as tknn
    from dcreg_tpu_torch.ops import knn_kernels as tkk
    monkeypatch.setattr(tkk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tkk.cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(tkk.cuda_build.os.path, "exists", lambda p: False)
    tkk._library.cache_clear()
    k2, k3 = tkk.knn_candidates.launches, tkk.group_min.launches
    q = torch.zeros((20, 3), device="meta")
    t = torch.zeros((300, 3), device="meta")
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tkk.knn(q, t, k=5)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tkk.knn_grouped(q, t, k=5)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tknn.nn1(q, t)
        # f64 on a device other than the CPU raises before any search
        with pytest.raises(ValueError, match="CPU only"):
            tknn.knn(q.double(), t.double(), k=5)
    finally:
        tkk._library.cache_clear()
    assert (tkk.knn_candidates.launches, tkk.group_min.launches) == (k2, k3)
    # the same calls on CPU tensors take the plain twins, count nothing
    d, i = tkk.knn(torch.zeros((20, 3)), torch.rand((300, 3)), k=5)
    assert d.shape == (20, 5)
    tkk.knn_grouped(torch.zeros((20, 3)), torch.rand((300, 3)), k=5)
    assert (tkk.knn_candidates.launches, tkk.group_min.launches) == (k2, k3)


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
