"""K1's split and merge on the CPU: each query block's run of pairs is
cut into ``nsplit`` pieces by the kernel's integer arithmetic
(``_split_bounds``), each piece keeps its own top-5 lists, and the lists
are merged (``merge_partial_keys``).  The plain twin run piece by piece
and merged must give the unsplit plain twin's keys bit for bit, and the
decoded neighbours must match JAX's ``batched_block_knn`` in interpret
mode within ``tests/test_torch_block_knn.py``'s tolerance.
"""
import functools

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu_torch.ops import block_knn as tk
from tests import test_torch_block_knn as base

NSPLITS = [1, 2, 3, 7, 16]
# run lengths of the five query blocks: empty, single, longer than every
# nsplit, shorter than most
RUNS = [0, 1, 9, 20, 3]
PAD = 4


def _split_parts(src_blocks, tgt, poses, qid, tid, pid, lane_mask,
                 index_bits, scale, clamp, nsplit):
    """(nq, nsplit, B, KP, QB): the plain twin on each split's pairs."""
    nq = src_blocks.shape[0]
    lo, hi = tk._split_bounds(tk._run_start(qid, nq), nsplit)
    words = None if lane_mask is None else lane_mask.reshape(qid.shape[0],
                                                             -1)
    parts = []
    for s in range(nsplit):
        idx = torch.cat([torch.arange(int(lo[q, s]), int(hi[q, s]))
                         for q in range(nq)]).long()
        parts.append(tk.block_knn_keys_plain(
            src_blocks, tgt, poses, qid[idx].contiguous(),
            tid[idx].contiguous(), pid[idx].contiguous(),
            None if words is None else words[idx].contiguous(), index_bits,
            scale, clamp))
    return torch.stack(parts, dim=1)


def _split_merge_keys(*args, plain=False, nsplit=1, nq_lane=0):
    """K1's structure in plain torch: split, top-5 per split, merge (the
    lanes' own mode, ``nq_lane``, is not split here)."""
    assert nq_lane == 0
    _split_merge_keys.calls += 1
    return tk.merge_partial_keys(_split_parts(*args, nsplit))


_split_merge_keys.calls = 0


def _pack_words(bits):
    """(P, B) bool -> (P, ceil(B/32)) int32 words, bit 31 in the sign."""
    P, B = bits.shape
    W = -(-B // 32)
    padded = np.zeros((P, W * 32), bool)
    padded[:, :B] = bits
    w = (padded.reshape(P, W, 32).astype(np.int64)
         << np.arange(32, dtype=np.int64)).sum(-1)
    return w.astype(np.uint32).view(np.int32)


def _case(B, slotted, mask, seed=3):
    """Random keys inputs: five query blocks with runs RUNS, PAD padding
    pairs (qid == nq), distinct target blocks within each run."""
    rng = np.random.default_rng(seed)
    nq, nbt = len(RUNS), 24
    src = rng.uniform(-1.0, 1.0, (nq, 3, 128)).astype(np.float32)
    tgt = rng.uniform(-1.2, 1.2, (nbt + 1, 3, 128)).astype(np.float32)
    ang = rng.uniform(-0.1, 0.1, (B, 3))
    poses = np.concatenate([
        np.stack([base._euler(*a) for a in ang]).reshape(B, 9),
        rng.uniform(-0.1, 0.1, (B, 3))], axis=1).astype(np.float32)
    qid, tid, slot = [], [], []
    for q, n in enumerate(RUNS):
        qid += [q] * n
        tid += list(rng.choice(nbt, n, replace=False))
        slot += list(range(n))
    qid += [nq] * PAD
    tid += [nbt] * PAD
    slot += [0] * PAD
    P = len(qid)
    if slotted:
        pid, ib = slot, tk._index_bits(max(RUNS) * 128)
    else:
        pid, ib = tid, tk._index_bits((nbt + 1) * 128)
    lane_mask = None
    if mask:
        bits = rng.random((P, B)) < 0.6
        bits[2] = False                   # a pair with no live lane
        bits[len(qid) - PAD:] = False
        lane_mask = torch.as_tensor(_pack_words(bits))
    _, _, clamp, scale = tk.key_params(0.6, ib)
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32)
    return (torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(
        poses), i32(qid), i32(tid), i32(pid), lane_mask, ib, scale, clamp)


@pytest.mark.parametrize("nsplit", NSPLITS)
def test_split_bounds_partition_every_run(nsplit):
    args = _case(1, False, False)
    qid = args[3]
    nq = len(RUNS)
    run_start = tk._run_start(qid, nq)
    assert run_start.tolist() == list(np.cumsum([0] + RUNS))
    lo, hi = tk._split_bounds(run_start, nsplit)
    assert lo.shape == hi.shape == (nq, nsplit)
    owner = np.full(qid.shape[0], -1)
    for q in range(nq):
        # consecutive, non-overflowing pieces that tile the run exactly
        assert int(lo[q, 0]) == int(run_start[q])
        assert int(hi[q, -1]) == int(run_start[q + 1])
        assert torch.equal(lo[q, 1:], hi[q, :-1])
        assert bool((hi[q] >= lo[q]).all())
        for s in range(nsplit):
            for p in range(int(lo[q, s]), int(hi[q, s])):
                assert owner[p] == -1
                owner[p] = q
    real = (qid < nq).numpy()
    assert np.array_equal(owner[real], qid.numpy()[real])
    assert (owner[~real] == -1).all()       # padding pairs in no split
    sizes = (hi - lo).numpy()
    assert sizes.sum() == sum(RUNS)
    if nsplit > 1:
        assert (sizes[1] == 0).any()        # a run of 1 leaves empty splits
        assert sizes[0].sum() == 0


@pytest.mark.parametrize("nq,B,nsplit,ctas", [
    (40, 1, 16, 640),           # (a) map frame, B = 1: 5,000 points
    (40, 128, 1, 5120),         # (b) map batch, B = 128
    (128, 128, 1, 16384),       # (c) BlockIndex batch, 16,384 points
    (40, 33, 4, 5280),          # (e) B = 33
    (1, 1, 16, 16),             # capped at MAX_SPLIT
])
def test_choose_nsplit_at_the_smoke_shapes(nq, B, nsplit, ctas):
    got = tk._choose_nsplit(nq, B, 132)     # an H100 SXM's SMs
    assert got == nsplit
    assert nq * got * B == ctas
    # fewer SMs (an H100 PCIe's 114) never ask for more pieces
    assert 1 <= tk._choose_nsplit(nq, B, 114) <= got


@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("slotted", [False, True])
@pytest.mark.parametrize("nsplit", NSPLITS)
def test_split_then_merge_equals_plain(nsplit, slotted, mask, B):
    args = _case(B, slotted, mask)
    want = tk.block_knn_keys_plain(*args)
    got = _split_merge_keys(*args, nsplit=nsplit)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    # keys are live (not all INIT_KEY), and empty runs stay INIT_KEY
    assert bool((want[:, :, :tk.K] != tk.INIT_KEY).any())
    assert bool((want[0] == tk.INIT_KEY).all())
    # the merge does not depend on the order of the pieces
    parts = _split_parts(*args, nsplit)
    assert torch.equal(tk.merge_partial_keys(parts.flip(1)), want)


@pytest.mark.parametrize("nsplit", [3, 16])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("ids", ["global", "slotted"])
def test_split_merge_vs_jax_interpret(monkeypatch, ids, mask, nsplit):
    """The whole batched_block_knn with K1's split-and-merge structure in
    place of the plain twin, against JAX (interpret=True)."""
    monkeypatch.setattr(tk, "block_knn_keys",
                        functools.partial(_split_merge_keys, nsplit=nsplit))
    before = _split_merge_keys.calls
    if ids == "global":
        base.test_plain_k1_vs_jax_interpret_global_ids(mask)
    else:
        base.test_plain_k1_vs_jax_interpret_slotted(mask)
    assert _split_merge_keys.calls > before
