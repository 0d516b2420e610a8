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


# ------------------------------------------- the forward / dq's q plan
# (``sparse_q_plan``, walked by ``sparse_fwd_wgmma_kernel`` and
# ``sparse_dq_wgmma_kernel``).  The file runs in ~6 s in one process.

def _check_q_cover(plan, lay, block, group, causal, dq=False):
    """Every live (q head, segment, key block) triple is walked exactly
    once, no dead sub-tile and no padded stage block carries a bit, a
    position-test bit sits exactly where a key of the block lies after one
    of the segment's queries, and a pad segment reads nothing."""
    nb = lay.shape[0]
    seg, R, C, kb = plan["seg"], plan["R"], plan["C"], plan["kb"]
    assert seg * R == 128 and kb == min(block, 64)
    assert C * kb == (64 if dq else 128)
    rows, ust, kst, live = plan["rows"], plan["ust"], plan["kst"], plan["live"]
    assert np.array_equal(np.cumsum(np.r_[0, ust[:-1, 1]]), ust[:, 0])
    assert ust[-1, 0] + ust[-1, 1] == len(kst) == len(live)
    pat = np.repeat(np.arange(len(ust)), ust[:, 1])  # each stage's pattern
    head = rows[pat][:, :, 0]                       # [stages, R]
    q0 = rows[pat][:, :, 1]
    bit = (live[:, :, None] >> np.arange(C)) & 1     # [stages, R, C]
    test = (live[:, :, None] >> (8 + np.arange(C))) & 1
    # bits 0..C-1 live, 8..8+C-1 the position test, nothing else
    assert (live & ~((1 << C) - 1) & ~(((1 << C) - 1) << 8) == 0).all()
    assert (test <= bit).all()
    assert (bit[head < 0] == 0).all()
    s, r, c = np.nonzero(bit)
    k0 = kst[s, c]
    after = k0 + kb - 1 > q0[s, r]
    assert np.array_equal(test[s, r, c] == 1, causal & after)
    count = np.zeros((group, nb * block // seg, nb * block // kb), np.int64)
    np.add.at(count, (head[s, r], q0[s, r] // seg, k0 // kb), 1)
    sub = np.repeat(np.repeat(lay, block // seg, 0), block // kb, 1)
    if causal:   # a key block with no key at or before a segment's queries
        qs = np.arange(sub.shape[0])[:, None] * seg
        sub = sub & (np.arange(sub.shape[1])[None, :] * kb <= qs + seg - 1)
    assert np.array_equal(count, np.broadcast_to(sub, count.shape))
    # the real segments: each (head, segment) once
    real = rows[rows[:, :, 0] >= 0]
    assert len(real) == group * nb * block // seg
    assert len({(j, q) for j, q in real.tolist()}) == len(real)


def _check_q_tasks(plan, bh, sms):
    """The tasks cover each unit's walk in order with even chunks (a split
    walk's part slots consecutive and listed by its merge), each block's
    run is heaviest first, and no block carries more than a fair share plus
    the largest task."""
    items, tasks, blk = plan["ust"][:, 1], plan["tasks"], plan["blk"]
    assert plan["grid"] == len(blk) - 1 == min(sms, len(tasks))
    assert blk[0] == 0 and blk[-1] == len(tasks) and (np.diff(blk) >= 1).all()
    by_unit = {}
    for g, u, i0, i1, part in tasks.tolist():
        by_unit.setdefault((g, u), []).append((i0, i1, part))
    assert sorted(by_unit) == [(g, u) for g in range(len(items))
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
            lens = [b - a for a, b, _ in chunks]
            assert min(lens) >= 1 and max(lens) - min(lens) <= 1
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


@pytest.mark.parametrize("dq", [False, True])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sparse_q_plan_covers_layout(name, block, causal, group, dq):
    """At T 2048 (block 16: 4096), over 2 kv heads x 2 batches on 132
    blocks, the forward's plan (128-key stages) and dq's (64): the units
    cover every live pair exactly once a q head, and the tasks walk each
    unit in order."""
    T = 4096 if block == 16 else 2048
    lay = LAYOUTS[name](block=block).make_layout(T)
    plan = sp.sparse_q_plan(lay, causal, block, group, 4, dq=dq)
    _check_q_cover(plan, _causal(lay, causal), block, group, causal, dq)
    _check_q_tasks(plan, 4, sp.H100_SMS)
    assert plan["smem"] <= sp.SMEM_LIMIT


@pytest.mark.parametrize("case", [(16, 4, [(j, 0) for j in range(4)]
                                   + [(j, 16) for j in range(4)]),
                                  (64, 4, [(j, 0) for j in range(4)]),
                                  (16, 1, [(0, 16 * i) for i in range(8)]),
                                  (128, 1, [(0, 0), (0, 64)]),
                                  (32, 16, [(j, 0) for j in range(16)])])
def test_sparse_q_plan_stacks_heads(case):
    """A unit's segments: the GQA group's q heads stacked first (block 16,
    group 4: 4 heads x 2 row blocks of 16; block 64: 4 heads x 32 queries,
    a row block two units), then adjacent row blocks (group 1: 128 / block
    row blocks of one head; a 128-row block is two segments of 64); group
    16: 16 heads x 8 queries."""
    block, group, want = case
    lay = sp.DenseSparsityConfig(block=block).make_layout(1024)
    plan = sp.sparse_q_plan(lay, False, block, group, 1)
    assert plan["seg"] == 128 // len(want)
    assert plan["rows"][0].tolist() == [list(x) for x in want]
    if block == 64:   # the row block's second half is the next unit
        assert plan["rows"][1].tolist() == [[j, 32] for j in range(4)]


def test_sparse_q_plan_pads_the_last_unit():
    """T 1040 at block 16, group 1: 65 segments, so the last unit holds one
    real segment and 7 pad segments (head -1) that carry no bit."""
    lay = sp.BSLongformerSparsityConfig().make_layout(1040)
    plan = sp.sparse_q_plan(lay, True, 16, 1, 2)
    last = plan["rows"][-1]
    assert len(plan["rows"]) == 9 and last[0].tolist() == [0, 1024]
    assert (last[1:, 0] == -1).all()
    _check_q_cover(plan, _causal(lay, True), 16, 1, True)


@pytest.mark.parametrize("call", ["fixed", "bigbird64"])
def test_sparse_q_plan_main_calls(call):
    """The phase 17 calls (T 8192, 32 q over 8 kv heads, 132 blocks), dq's
    plan: 2048 units each; Fixed (block 16, causal) 34,816 stages of 64
    keys, the heaviest walk 33 against a fair share of ~279, nothing split,
    >= 99% of the walked (row block, column) pairs live; BigBird block 64
    (non-causal) 11,856 stages, every walked pair live, and only the 16
    units of global row block 0 (128 stages against ~105) split."""
    cfg, causal, stages = {
        "fixed": (sp.FixedSparsityConfig(), True, 34816),
        "bigbird64": (sp.BigBirdSparsityConfig(block=64), False, 11856)}[call]
    lay = cfg.make_layout(8192)
    plan = sp.sparse_q_plan(lay, causal, cfg.block, 4, 8, dq=True)
    n = plan["ust"][:, 1]
    assert len(n) * 8 == 2048 and n.sum() * 8 == stages
    assert plan["grid"] == 132
    live = _causal(lay, causal)
    walked = hit = 0
    for p in range(len(n)):
        rbs = sorted(set(plan["rows"][p][:, 1] // cfg.block))
        cols = sorted(set(plan["kst"][plan["ust"][p, 0]:plan["ust"][p, 0]
                                      + n[p]].ravel() // cfg.block))
        walked += len(rbs) * len(cols)
        hit += int(live[np.ix_(rbs, cols)].sum())
    if call == "fixed":
        assert n.max() == 33 and plan["parts"] == 0
        assert 279 < plan["fair"] < 280 and hit / walked >= 0.99
        assert max(plan["loads"]) <= 1.01 * plan["fair"]
    else:
        assert n.max() == 128 and 105 < plan["fair"] < 106
        assert hit == walked
        split = {int(g) for g in plan["merges"][:, 0]}
        assert len(plan["merges"]) == 16 and all(
            plan["rows"][g][:, 1].max() < 64 for g in split)
    assert (plan["slots"], plan["stages"]) == (2, 3)


@pytest.mark.parametrize("call", ["fixed", "bigbird64", "longformer"])
def test_sparse_q_plan_forward_calls(call):
    """The forward's plans at the phase 17 calls: stages of 128 keys
    (Fixed 17,920, the heaviest walk 17; BigBird block 64 6,800, its
    global row block's 64 stages under a fair share of ~67: nothing
    splits), and BSLongformer's defaults (non-causal), whose global row
    block 0 walks all 512 column blocks: its 8 units split into 32
    chunks; one slot of Q, a ring of 3."""
    cfg, causal, stages, parts = {
        "fixed": (sp.FixedSparsityConfig(), True, 17920, 0),
        "bigbird64": (sp.BigBirdSparsityConfig(block=64), False, 6800, 0),
        "longformer": (sp.BSLongformerSparsityConfig(), False, 2552, 32)}[
        call]
    lay = cfg.make_layout(8192)
    plan = sp.sparse_q_plan(lay, causal, cfg.block, 4, 8)
    assert plan["ust"][:, 1].sum() * 8 == stages and plan["C"] * plan[
        "kb"] == 128
    assert plan["parts"] == parts
    assert set(plan["merges"][:, 0].tolist()) <= {0}   # row blocks 0 and 1
    assert (plan["slots"], plan["stages"]) == (1, 3)


@pytest.mark.parametrize("dq", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
def test_sparse_q_tiles_fit(hd, dq):
    """Slots of Q (dq: Q, dO and 128 delta values) [128, hd], stages of K
    and V [128 keys (dq: 64), hd] with 32 words, two slots only where a
    ring of 3 fits beside them, all in the card's opt-in shared memory."""
    t = sp.sparse_q_tiles(hd, dq)
    tile = 128 * hd * 2
    assert t["slot_bytes"] == (2 * tile + 512 if dq else tile)
    assert t["stage_bytes"] == 2 * (64 if dq else 128) * hd * 2 + 128
    assert 3 <= t["stages"] <= 8 and t["smem"] <= sp.SMEM_LIMIT
    fixed = t["smem"] - t["slots"] * t["slot_bytes"] \
        - t["stages"] * t["stage_bytes"]
    three = (sp.SMEM_LIMIT - fixed - 2 * t["slot_bytes"]) \
        // t["stage_bytes"] >= 3
    assert t["slots"] == (2 if three else 1)


@pytest.mark.parametrize("block", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sparse_q_route(dtype, block):
    """The forward and dq take ``sparse_dkv_route``'s rule: 16-bit at
    head_dim 64 / 128 with a block that divides 128 run the wgmma kernels
    on ``sparse_q_plan`` (whose segments then divide the block); block 48
    keeps the mma.sync kernels, fp32 the CUDA-core family."""
    route = sp.sparse_dkv_route(dtype, 128, block)
    if dtype == torch.float32:
        assert route == "simt"
    elif block == 48:
        assert route == "mma"
    else:
        assert route == "wgmma"
        for group in (1, 2, 4, 8, 16, 32):
            seg = sp.sparse_q_seg(block, group)
            assert block % seg == 0 and 8 <= seg <= 64 and 128 % seg == 0
