"""Paged LoRA adapter pool — counterpart of deepspeed_tpu/serving/adapters.py.

Multi-tenant adapter weights are block-granular residents of the SAME
refcounted allocator that pages the KV cache (the S-LoRA unified pool): an
adapter occupies ``blocks_per_adapter`` blocks of the engine's
``BlockedAllocator`` (inference/v2/ragged.py) for supply accounting, while
its bytes live in packed device tables that the batched-gather op
(ops/lora_matmul.py) indexes by slot.  The lifecycle is the JAX pool's,
rule for rule:

- **load** allocates the adapter's blocks at refcount 1 (the pool holds
  them) and writes its pages into a free table slot;
- **pin** (one per in-flight request using the adapter) goes through
  ``allocator.acquire`` on the same blocks, so the allocator's refcount is
  the single source of truth for "in use";
- **evictable** exactly when every block is back to refcount 1; eviction
  takes the least recently used adapters first, then the caller's
  ``spill`` (the state manager hands radix eviction through it);
- **supply**: ``DSStateManager.available_blocks`` folds the evictable
  adapter blocks in beside the radix's.

Slot 0 is the base-model identity: its pages stay zero and its scale is 0,
so adapter-less rows ride the same op call with an exact zero delta.

Layout (the port's choice): each table is LAYER-major, ``[L, slots, H, r]``
for A and ``[L, slots, r, O]`` for B (JAX keeps ``[slots, L, ...]`` and
slices ``[:, li]``).  ``tables()[k][li]`` is then a contiguous ``[slots,
...]`` view that every forward hands the kernel as it is; the JAX layout's
slice would be strided and cost a copy per call.  The tables are torch
tensors on the pool's ``device`` in the engine dtype; the scales are fp32.

A load writes its slot IN PLACE (``table[:, slot].copy_(page)``, where JAX
rebuilds each table with ``.at[].set``).  On a CUDA device the host pages
are cast to the engine dtype on the host, staged in pinned memory and
copied with ``non_blocking=True`` on the current stream, so a load needs no
host sync and the stream orders it after every forward already enqueued (a
slot is only reloaded once no in-flight request pins its previous tenant).
PyTorch's pinned-memory cache keeps each staging buffer until its copy has
run.

Thread-safety mirrors the JAX pool: mutations (load / evict / pin) run on
the engine's thread; ``is_resident`` / ``resident_count`` are plain dict
reads, which a concurrent load or evict can only make stale.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device

PROJS = ("a_q", "b_q", "a_v", "b_v")


def random_adapter_weights(num_layers: int, hidden: int, rank: int,
                           q_dim: int, v_dim: int, seed: int = 0,
                           init_scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Deterministic per-seed LoRA weights (bench/test tenants), the JAX
    function's numpy stream draw for draw.  Both A and B are non-zero so
    distinct adapters produce distinct outputs — the classic B=0 init
    would make every tenant the base model."""
    rng = np.random.default_rng(seed)
    return {
        "a_q": rng.normal(0, init_scale,
                          (num_layers, hidden, rank)).astype(np.float32),
        "b_q": rng.normal(0, init_scale,
                          (num_layers, rank, q_dim)).astype(np.float32),
        "a_v": rng.normal(0, init_scale,
                          (num_layers, hidden, rank)).astype(np.float32),
        "b_v": rng.normal(0, init_scale,
                          (num_layers, rank, v_dim)).astype(np.float32),
    }


class _Resident:
    __slots__ = ("slot", "blocks", "stamp")

    def __init__(self, slot: int, blocks: List[int], stamp: int):
        self.slot = slot
        self.blocks = blocks
        self.stamp = stamp


class AdapterPool:
    """Block-granular LoRA adapter residency over a shared
    ``BlockedAllocator``.

    allocator: the engine's KV pool allocator (shared supply).
    slots: device-table capacity INCLUDING the reserved identity slot 0.
    block_bytes: bytes one allocator block represents (the engine derives
        it from the paged KV layout) — sizes ``blocks_per_adapter``.
    scale: LoRA scaling s = alpha / rank applied to every adapter delta.
    dtype: the tables' dtype (the engine's).
    device: where the tables live; None means cuda:0 and raises without
        CUDA (``accelerator.resolve_device``), as every entry of the port.
    """

    def __init__(self, allocator, *, slots: int, rank: int, hidden: int,
                 num_layers: int, q_dim: int, v_dim: int, block_bytes: int,
                 scale: float, dtype=torch.float32, device=None,
                 telemetry=None):
        self.allocator = allocator
        self.slots = int(slots)
        self.rank = int(rank)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.q_dim = int(q_dim)
        self.v_dim = int(v_dim)
        self.scale = float(scale)
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self._dtype = dtype
        itemsize = torch.empty((), dtype=self._dtype).element_size()
        per_adapter_bytes = itemsize * num_layers * (
            hidden * rank + rank * q_dim + hidden * rank + rank * v_dim)
        self.blocks_per_adapter = max(
            1, -(-per_adapter_bytes // max(1, int(block_bytes))))
        self._host: Dict[int, Dict[str, np.ndarray]] = {}
        self._resident: Dict[int, _Resident] = {}
        self._free_slots: List[int] = list(range(1, self.slots))
        self._clock = 0
        self._ever_loaded: set = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # load/evict serialization: two concurrent loads racing one free
        # slot would double-book it
        self._lock = threading.Lock()
        L = num_layers
        shapes = {"a_q": (L, self.slots, hidden, rank),
                  "b_q": (L, self.slots, rank, q_dim),
                  "a_v": (L, self.slots, hidden, rank),
                  "b_v": (L, self.slots, rank, v_dim)}
        self._tables = {k: torch.zeros(shapes[k], dtype=self._dtype,
                                       device=self.device) for k in PROJS}
        # slot 0 keeps scale 0 — the identity lane's delta is exactly zero
        # even if a stale page were ever read through it
        self._scales = torch.zeros((self.slots,), dtype=torch.float32,
                                   device=self.device)

    # ------------------------------------------------------------ registry
    def register(self, adapter_id: int,
                 weights: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Make ``adapter_id`` loadable.  Host-side only: no pool blocks,
        no device traffic until a request actually selects the adapter.
        ``weights=None`` generates deterministic per-id test weights."""
        aid = int(adapter_id)
        if aid <= 0:
            raise ValueError("adapter id 0 is the reserved base-model "
                             "identity; tenant ids start at 1")
        if weights is None:
            weights = random_adapter_weights(
                self.num_layers, self.hidden, self.rank, self.q_dim,
                self.v_dim, seed=aid)
        for k in PROJS:
            if k not in weights:
                raise ValueError(f"adapter {aid}: missing projection {k!r}")
        self._host[aid] = {k: np.asarray(weights[k]) for k in PROJS}

    def registered(self, adapter_id: int) -> bool:
        return int(adapter_id) == 0 or int(adapter_id) in self._host

    def unfittable_reason(self, adapter_id: int) -> Optional[str]:
        """Why this adapter id can NEVER be served by this pool (a client
        input error → the caller fails the REQUEST, not the replica), or
        None when it is servable."""
        aid = int(adapter_id)
        if aid == 0:
            return None
        if aid not in self._host:
            return f"unknown adapter id {aid} (never registered)"
        if self.blocks_per_adapter > self.allocator.num_blocks:
            return (f"adapter {aid} needs {self.blocks_per_adapter} pool "
                    f"blocks but the pool only has "
                    f"{self.allocator.num_blocks}")
        if self.slots < 2:
            return "adapter pool has no tenant slots (slots < 2)"
        return None

    # ----------------------------------------------------------- residency
    def is_resident(self, adapter_id: int) -> bool:
        """Cross-thread-safe residency peek — a dict read, no stamps
        freshened, no side effects."""
        return int(adapter_id) == 0 or int(adapter_id) in self._resident

    def resident_count(self, adapter_ids) -> int:
        return sum(1 for a in set(int(i) for i in adapter_ids)
                   if a != 0 and a in self._resident)

    def slot_of(self, adapter_id: int) -> int:
        aid = int(adapter_id)
        return 0 if aid == 0 else self._resident[aid].slot

    def _evictable_ids(self) -> List[int]:
        """Adapters only the pool holds (every block at refcount 1) — the
        radix-leaf predicate applied to whole adapters."""
        return [aid for aid, res in self._resident.items()
                if all(self.allocator.refcount(b) == 1 for b in res.blocks)]

    def evictable_blocks(self) -> int:
        """Supply reclaimable by evicting cold adapters right now."""
        return len(self._evictable_ids()) * self.blocks_per_adapter

    def _evict(self, aid: int) -> int:
        """Drop resident ``aid`` (its slot returns to the free list; its
        pages stay in the table until the slot is reloaded).  Returns the
        blocks freed."""
        res = self._resident.pop(aid)
        freed = len(self.allocator.release(res.blocks))
        self._free_slots.append(res.slot)
        self.evictions += 1
        if self.telemetry is not None:
            self.telemetry.adapter_eviction()
        return freed

    def evict_cold(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by evicting LRU-cold
        adapters (never a pinned one).  Returns blocks actually freed."""
        freed = 0
        with self._lock:
            while freed < n_blocks:
                cold = self._evictable_ids()
                if not cold:
                    break
                freed += self._evict(
                    min(cold, key=lambda a: self._resident[a].stamp))
        return freed

    # --------------------------------------------------------------- load
    def _upload(self, slot: int, host: Dict[str, np.ndarray]) -> None:
        """Write one adapter's pages into table slot ``slot`` in place."""
        pinned = self.device.type == "cuda"
        for k in PROJS:
            page = torch.from_numpy(np.ascontiguousarray(host[k])).to(
                self._dtype)
            if pinned:
                staging = torch.empty(page.shape, dtype=self._dtype,
                                      pin_memory=True)
                staging.copy_(page)
                page = staging
            self._tables[k][:, slot].copy_(page, non_blocking=pinned)
        # fill_ passes the scale as a kernel argument; assigning a Python
        # float to a CUDA element would copy it from the host and sync
        self._scales[slot:slot + 1].fill_(self.scale)

    def _load_locked(self, aid: int, spill) -> None:
        if not self._free_slots:
            # all table slots taken: evict ONE cold adapter for its slot
            cold = self._evictable_ids()
            if not cold:
                raise RuntimeError(
                    f"adapter slots exhausted: {self.slots - 1} tenant "
                    f"slots all pinned by in-flight requests")
            self._evict(min(cold, key=lambda a: self._resident[a].stamp))
        short = self.blocks_per_adapter - self.allocator.free_blocks
        if short > 0:
            # cold adapters first (same-tenancy pressure), then the
            # caller's spill (the state manager hands us radix eviction)
            for aid2 in sorted(self._evictable_ids(),
                               key=lambda a: self._resident[a].stamp):
                if short <= 0:
                    break
                short -= self._evict(aid2)
        if short > 0 and spill is not None:
            short -= spill(short)
        # allocate raises "KV cache exhausted" if still short
        blocks = self.allocator.allocate(self.blocks_per_adapter)
        slot = self._free_slots.pop()
        self._upload(slot, self._host[aid])
        self._clock += 1
        self._resident[aid] = _Resident(slot, blocks, self._clock)

    def ensure(self, adapter_ids, spill=None) -> None:
        """Make every id in ``adapter_ids`` resident, loading misses from
        host.  ``spill(n) -> freed`` reclaims extra blocks beyond cold
        adapters.  Raises ``RuntimeError`` when the pool cannot fit the
        load right now (every slot pinned, or the allocator short)."""
        for aid in sorted(set(int(i) for i in adapter_ids)):
            if aid == 0:
                continue
            if aid not in self._host:
                raise KeyError(f"adapter id {aid} was never registered")
            res = self._resident.get(aid)
            if res is not None:
                self._clock += 1
                res.stamp = self._clock
                self.hits += 1
                if self.telemetry is not None:
                    self.telemetry.adapter_load("hit", self._hit_rate())
                continue
            outcome = "reload" if aid in self._ever_loaded else "miss"
            try:
                with self._lock:
                    self._load_locked(aid, spill)
            except Exception:
                self.misses += 1
                if self.telemetry is not None:
                    self.telemetry.adapter_load("failed", self._hit_rate())
                raise
            self.misses += 1
            self._ever_loaded.add(aid)
            if self.telemetry is not None:
                self.telemetry.adapter_load(outcome, self._hit_rate())

    # ---------------------------------------------------------------- pins
    def acquire(self, adapter_id: int) -> None:
        """One in-flight request starts using the adapter: add a holder to
        its blocks (refcount > 1 ⇒ not evictable)."""
        aid = int(adapter_id)
        if aid:
            self.allocator.acquire(self._resident[aid].blocks)

    def release(self, adapter_id: int) -> None:
        """The request finished: drop its hold.  The pool's own refcount
        keeps the pages resident until eviction pressure reclaims them."""
        aid = int(adapter_id)
        if aid:
            self.allocator.release(self._resident[aid].blocks)

    # -------------------------------------------------------------- tables
    def tables(self) -> Dict[str, torch.Tensor]:
        """The packed device tables every forward reads: per-projection
        LAYER-major pages (``[L, slots, ...]``; layer ``li``'s view is
        ``tables()[k][li]``) plus the per-slot fp32 ``scale``."""
        out = dict(self._tables)
        out["scale"] = self._scales
        return out

    # --------------------------------------------------------------- stats
    def _hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        pinned = sum(
            self.blocks_per_adapter for res in self._resident.values()
            if any(self.allocator.refcount(b) > 1 for b in res.blocks))
        resident = len(self._resident) * self.blocks_per_adapter
        return {"resident_adapters": len(self._resident),
                "resident_blocks": resident,
                "pinned_blocks": pinned,
                "evictable_blocks": self.evictable_blocks(),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self._hit_rate()}

    def check_invariants(self) -> None:
        """Test hook: every resident adapter's blocks are live, slot
        bookkeeping is exact, and no slot is double-owned."""
        seen = set()
        for aid, res in self._resident.items():
            assert 0 < res.slot < self.slots, (aid, res.slot)
            assert res.slot not in seen, f"slot {res.slot} double-owned"
            seen.add(res.slot)
            for b in res.blocks:
                assert self.allocator.refcount(b) >= 1, (aid, b)
        assert not seen & set(self._free_slots), "free slot still owned"
        assert len(seen) + len(self._free_slots) == self.slots - 1, (
            len(seen), len(self._free_slots), self.slots)
