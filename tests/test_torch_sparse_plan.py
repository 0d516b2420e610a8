"""PyTorch port, block-sparse dk/dv: the tensor-core kernel's plan
(``ops/sparse_attention.py sparse_dkv_plan``) and route, held on the CPU
with numpy alone.  The plan is a plain function of the layout; the kernel
(``csrc/sparse_attention.cu sparse_dkv_wgmma_kernel``) walks exactly what it
lists, so these checks are what keeps a live (row block, column block)
pair from being dropped or counted twice on the card.
"""

import importlib

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and a thread per core in each would oversubscribe the CPU
torch.set_num_threads(1)

sp = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")

LAYOUTS = {
    "fixed": sp.FixedSparsityConfig,
    "bigbird": sp.BigBirdSparsityConfig,
    "longformer": sp.BSLongformerSparsityConfig,
    "dense": sp.DenseSparsityConfig,
}


def _causal(layout, causal):
    lay = np.asarray(layout, bool).copy()
    if causal:
        lay &= np.tril(np.ones(lay.shape, bool))
    return lay


def _check_cover(plan, lay, block):
    """Every live (row block, column) pair is walked exactly once a
    min(block, 64)-query segment of its row block, no dead pair and no pad
    column carries a live bit, and each group's stages are its own."""
    nb = lay.shape[0]
    halves = max(1, block // 64)
    cols, gst, seg, live = plan["cols"], plan["gst"], plan["seg"], plan["live"]
    G, R = plan["G"], plan["R"]
    assert cols.shape[1] == G == 128 // block
    assert R == 64 // min(block, 64) and seg.shape == live.shape
    real = np.sort(cols[cols >= 0])
    assert np.array_equal(real, np.arange(nb))       # every column, once
    assert (gst[:, 1] >= 0).all()
    assert np.array_equal(np.cumsum(np.r_[0, gst[:-1, 1]]), gst[:, 0])
    assert gst[-1, 0] + gst[-1, 1] == len(seg)
    group = np.repeat(np.arange(len(gst)), gst[:, 1])  # each stage's group
    count = np.zeros((halves, nb, nb), np.int64)
    for c in range(G):
        bit = (live >> c) & 1                       # [stages, R]
        col = cols[group, c]                        # [stages]
        if c >= 1:
            assert (bit[col < 0] == 0).all()        # a pad column is dead
        s, r = np.nonzero(bit)
        start = seg[s, r]
        assert (col[s] >= 0).all()
        np.add.at(count, ((start % block) // 64, start // block, col[s]), 1)
    assert (live >> G == 0).all()
    assert np.array_equal(count, np.broadcast_to(lay, count.shape).astype(
        np.int64))
    assert (seg % min(block, 64) == 0).all() and (seg >= 0).all()
    assert (seg < nb * block).all()


def _check_tasks(plan, group, bh, sms):
    """The tasks cover each unit's walk in order (a split walk's chunks
    contiguous, their part slots consecutive and listed by its merge), each
    block's run is heaviest first, and no block carries more than a fair
    share plus the largest task."""
    gst, tasks, blk = plan["gst"], plan["tasks"], plan["blk"]
    items = group * gst[:, 1]
    assert plan["grid"] == len(blk) - 1 == min(sms, len(tasks))
    assert blk[0] == 0 and blk[-1] == len(tasks) and (np.diff(blk) >= 1).all()
    by_unit = {}
    for g, u, i0, i1, part in tasks.tolist():
        by_unit.setdefault((g, u), []).append((i0, i1, part))
    assert sorted(by_unit) == [(g, u) for g in range(len(gst))
                               for u in range(bh)]
    merges = {(g, u): (p0, n) for g, u, p0, n in plan["merges"].tolist()}
    parts = []
    for (g, u), chunks in by_unit.items():
        chunks.sort()
        assert chunks[0][0] == 0 and chunks[-1][1] == items[g]
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        if len(chunks) == 1:
            assert chunks[0][2] == -1 and (g, u) not in merges
            assert items[g] <= plan["fair"]
        else:
            assert all(a < b for a, b, _ in chunks)
            p0, n = merges[(g, u)]
            assert n == len(chunks)
            assert [p for _, _, p in chunks] == list(range(p0, p0 + n))
            parts += list(range(p0, p0 + n))
    assert sorted(parts) == list(range(plan["parts"]))
    cost = tasks[:, 3] - tasks[:, 2] + 1
    loads = [int(cost[a:b].sum()) for a, b in zip(blk, blk[1:])]
    assert loads == plan["loads"]
    for a, b in zip(blk, blk[1:]):
        assert (np.diff(cost[a:b]) <= 0).all()
    assert max(loads) <= sum(loads) / len(loads) + cost.max()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sparse_dkv_plan_covers_layout(name, block, causal):
    """At T 8192 for block 16 (the main path's Fixed call) and 2048 for the
    others, GQA 4 over 8 kv heads on 132 blocks: the groups cover the
    layout's live pairs exactly once and the tasks each walk in order."""
    T = 8192 if block == 16 else 2048
    lay = LAYOUTS[name](block=block).make_layout(T)
    plan = sp.sparse_dkv_plan(lay, causal, block, 4, 8)
    _check_cover(plan, _causal(lay, causal), block)
    _check_tasks(plan, 4, 8, sp.H100_SMS)
    assert plan["smem"] <= sp.SMEM_LIMIT


@pytest.mark.parametrize("case", [(16, 384, 2, 4, 132), (32, 384, 4, 4, 132),
                                  (64, 256, 1, 2, 132), (128, 1024, 2, 1, 7)])
def test_sparse_dkv_plan_small_calls_split(case):
    """Small calls (on a full card, and on 7 blocks): walks that exceed
    the fair share split, and a layout with dead columns (no row reads
    them) still lists them, in a group of their own, to be written as
    zeros."""
    block, T, group, bh, sms = case
    nb = T // block
    lay = np.tril(np.ones((nb, nb), bool))
    lay[:, 1::2] = False                            # the odd columns dead
    plan = sp.sparse_dkv_plan(lay, True, block, group, bh, 64, sms)
    _check_cover(plan, lay, block)
    _check_tasks(plan, group, bh, sms)
    assert plan["parts"] > 0
    dead = {int(j) for j in np.flatnonzero(~lay.any(0))}
    last = set(plan["cols"][-1][plan["cols"][-1] >= 0].tolist())
    assert last <= dead and plan["gst"][-1][1] == 0


def test_sparse_dkv_plan_main_call():
    """The phase 17 Fixed call (T 8192, block 16, causal, 32 q over 8 kv
    heads): 64 groups of 8 columns a kv head, the global columns' nested
    row lists in groups of their own (at least 75% of the walked sub-tiles
    live), the heaviest walks split, no block above 1.05 fair shares."""
    lay = sp.FixedSparsityConfig().make_layout(8192)
    plan = sp.sparse_dkv_plan(lay, True, 16, 4, 8)
    assert plan["cols"].shape == (64, 8) and plan["R"] == 4
    assert plan["grid"] == 132 and plan["parts"] > 0
    walked = plan["gst"][:, 1].sum() * 4 * 8
    live = sum(bin(int(x)).count("1") for x in plan["live"].ravel())
    assert live == _causal(lay, True).sum()
    assert live / walked >= 0.75
    assert max(plan["loads"]) <= 1.05 * plan["fair"]
    assert (plan["slots"], plan["stages"]) == (1, 4)


@pytest.mark.parametrize("block", [8, 16, 24, 32, 48, 64, 80, 96, 112, 128,
                                   144, 256])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_sparse_dkv_route(dtype, hd, block):
    """16-bit at head_dim 64 / 128: the blocks that divide 128 take the
    wgmma kernel, the other multiples of 16 up to 128 keep the mma.sync
    kernel; everything else runs on the CUDA cores."""
    got = sp.sparse_dkv_route(dtype, hd, block)
    if dtype == torch.float32 or hd not in (64, 128) or block % 16 \
            or block > 128:
        assert got == "simt"
    elif block in (16, 32, 64, 128):
        assert got == "wgmma"
    else:
        assert block in (48, 80, 96, 112) and got == "mma"


@pytest.mark.parametrize("hd", [64, 128])
def test_sparse_dkv_tiles_fit(hd):
    """Slots of K and V [128, hd], stages of Q and dO [64, hd] with four
    rows of 64 words, 1024-byte stages, two slots only where a ring of 3
    fits beside them, all in the card's opt-in shared memory."""
    t = sp.sparse_dkv_tiles(hd)
    assert t["slot_bytes"] == 2 * 128 * hd * 2
    assert t["stage_bytes"] % 1024 == 0
    assert t["stage_bytes"] >= 2 * 64 * hd * 2 + 4 * 64 * 4
    assert 2 <= t["stages"] <= 8 and t["slots"] in (1, 2)
    assert t["smem"] <= sp.SMEM_LIMIT
    fixed = t["smem"] - t["slots"] * t["slot_bytes"] \
        - t["stages"] * t["stage_bytes"]
    three = (sp.SMEM_LIMIT - fixed - 2 * t["slot_bytes"]) \
        // t["stage_bytes"] >= 3
    assert t["slots"] == (2 if three else 1)
