"""Host-side ragged-batching state — paged KV allocator, sequence descriptors,
radix shared-prefix cache, ragged batch construction.

A copy of deepspeed_tpu/inference/v2/ragged.py (numpy-only, so the port keeps
its own copy instead of importing the JAX package), with its LoRA adapter
pool hooks (``DSStateManager.adapters``, serving/adapters.py).  In the
PyTorch port the arrays built here are copied to the card once per step;
the KV pool is updated in place on one CUDA stream, so the
write-before-read ordering the notes below rely on holds there too.

TPU-native analog of the reference's ragged device state
(inference/v2/ragged/): ``BlockedAllocator`` (blocked_allocator.py),
``DSSequenceDescriptor`` (sequence_descriptor.py:280), ``DSStateManager``
(ragged_manager.py:206), ``KVCacheManager`` (kv_cache.py:208) and
``RaggedBatchWrapper`` (ragged_wrapper.py:292).  The reference keeps this
metadata in pinned host buffers copied to the GPU each step
(csrc fast_host_buffer.cu); on TPU the same arrays are plain numpy staged
through the jitted step's donated inputs.

Every shape the device sees is STATIC (token budget, max sequences, max blocks
per sequence) — raggedness lives entirely in index/mask arrays, which is what
keeps one compiled XLA program serving every batch composition.

The radix shared-prefix cache (``RadixKVCache``) adds the [serving_scale]
layer: at fleet scale most requests share a system prompt, so the pool's
FULL blocks (block_size tokens of known content) are indexed by token
content in a block-granular trie.  An incoming prompt's longest cached
prefix aliases those blocks instead of re-running prefill — the blocks are
content-complete and never written again (every KV write lands at
position ≥ seen_tokens, which starts AT the block-aligned match boundary,
i.e. in freshly allocated exclusive blocks), so aliasing is write-safe by
construction: the "copy" of copy-on-write is the re-prefill of the first
partial block.  Sharing is safe in memory because the allocator refcounts
every block (a block returns to the free list only when its last holder —
sequence or radix — releases it), and safe in time because the paged KV
arrays are donated through every step program in dispatch order (XLA runs
them on one stream, so a later reader never races an earlier writer).
Eviction is LRU over leaf nodes only the radix still holds
(refcount == 1), triggered on demand at the same starvation sites that
book ``kv_alloc_failures_total``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


class BlockedAllocator:
    """Refcounted free-list allocator over a fixed pool of KV blocks
    (reference inference/v2/ragged/blocked_allocator.py, plus the
    share/acquire/release refcounts the radix prefix cache needs).

    ``allocate`` hands out blocks at refcount 1 (exclusive);
    ``acquire`` adds a holder to live blocks (radix adoption, prefix
    sharing); ``release`` drops one holder and returns a block to the
    free deque only when its LAST holder lets go.  ``free`` stays as an
    alias of ``release`` for the pre-radix exclusive-ownership callers.

    Refcount transitions take a lock: the engine mutates the pool from
    its replica worker thread while the fleet dispatcher pins/unpins
    KV-handoff blocks (serving/fleet.py) on the same allocator, and an
    interleaved ``_ref[b] -= 1`` is not atomic in CPython — a torn
    decrement would corrupt the refcount and either leak the block or
    free it under a live holder.  Single-threaded engines pay one
    uncontended lock per TRANSITION (not per token), which is noise
    next to the dict walks around it.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._free: Deque[int] = deque(range(num_blocks))
        self._ref: List[int] = [0] * num_blocks
        self._lock = threading.Lock()
        # bumped on every refcount transition: the radix caches its
        # evictable-count DFS against it (the scheduler reads
        # available_blocks many times per round, usually with no
        # allocator activity in between)
        self.version = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def allocate(self, n: int) -> List[int]:
        with self._lock:
            if n > len(self._free):
                raise RuntimeError(
                    f"KV cache exhausted: requested {n} blocks, "
                    f"{len(self._free)} free of {self.num_blocks}")
            out = [self._free.popleft() for _ in range(n)]
            self.version += 1
            for b in out:
                assert self._ref[b] == 0, (b, self._ref[b])
                self._ref[b] = 1
            return out

    def acquire(self, blocks: List[int]) -> None:
        """Add one holder to each (already-live) block."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise RuntimeError(
                        f"acquire of dead block {b} "
                        f"(refcount {self._ref[b]})")
            self.version += 1
            for b in blocks:
                self._ref[b] += 1

    def release(self, blocks: List[int]) -> List[int]:
        """Drop one holder per block; blocks reaching refcount 0 return to
        the free list.  Returns the freed subset (accounting tests)."""
        freed: List[int] = []
        with self._lock:
            self.version += 1
            for b in blocks:
                self._ref[b] -= 1
                if self._ref[b] < 0:
                    raise RuntimeError(
                        f"refcount underflow on block {b} (double release)")
                if self._ref[b] == 0:
                    self._free.append(b)
                    freed.append(b)
        return freed

    # exclusive-ownership callers (pre-radix API) release through this name
    free = release


class RadixNode:
    """One full KV block in the prefix trie.  The edge label is the block's
    token content (a ``block_size`` tuple); ``block`` is its pool index.
    The node does NOT own a refcount field: the allocator's per-block
    refcount is the single source of truth — a node is evictable exactly
    when refcount == 1 (only the radix holds it)."""

    __slots__ = ("key", "block", "children", "parent", "stamp")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["RadixNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.stamp = 0


class RadixKVCache:
    """Block-granular radix index over the paged pool.

    Nodes are FULL blocks only: a partial (still-written) tail block never
    enters the trie, which is what makes aliased reads write-safe (see the
    module docstring).  Matching, insertion, and eviction are pure host
    dict walks — O(prompt_len / block_size) lookups, no device sync — so
    they are safe on the serving scheduler's dispatch thread.
    """

    def __init__(self, allocator: BlockedAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.root = RadixNode((), -1, None)
        self._clock = 0                    # LRU stamp source
        self.node_count = 0
        # (allocator.version when computed, evictable block-id set) — see
        # evictable_blocks; the count AND the membership view (exact
        # pinned-supply accounting in peek_pinned) come from one DFS
        self._evictable_cache: Tuple[int, frozenset] = (-1, frozenset())
        self._stats_cache: Tuple[int, Dict[str, int]] = (-1, {})

    # ------------------------------------------------------------ lookup
    def _walk(self, tokens: np.ndarray) -> List[RadixNode]:
        bs = self.block_size
        path: List[RadixNode] = []
        node = self.root
        for i in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def touch(self, path: List[RadixNode]) -> None:
        """Freshen a matched path's LRU stamps (root-to-leaf order)."""
        self._clock += 1
        for node in path:
            node.stamp = self._clock

    def match(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of ``tokens``: returns
        (block ids, matched token count) and freshens the path's LRU
        stamps.  Callers must ``acquire`` the blocks before anything else
        can trigger eviction."""
        path = self._walk(tokens)
        self.touch(path)
        return [n.block for n in path], len(path) * self.block_size

    def peek(self, tokens: np.ndarray) -> int:
        """Matched-prefix LENGTH only — no stamp freshening, no side
        effects.  Safe to call cross-thread (fleet router residency probe:
        a plain dict walk under the GIL; a concurrent insert/evict can
        only make the answer stale, never corrupt it)."""
        return len(self._walk(tokens)) * self.block_size

    def peek_blocks(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """:meth:`match` without the side effects: (block ids, matched
        token count), no LRU freshening, no references taken.  The fleet's
        KV-handoff path probes this cross-thread (same safety argument as
        :meth:`peek`) and then pins the blocks with ``allocator.acquire``
        — which validates liveness atomically, so a block a concurrent
        evict freed between the walk and the pin raises there instead of
        being silently resurrected."""
        path = self._walk(np.asarray(tokens, np.int32).reshape(-1))
        return [n.block for n in path], len(path) * self.block_size

    # ------------------------------------------------------------ insert
    def insert(self, tokens: np.ndarray, blocks: List[int]) -> int:
        """Index every full block of ``tokens`` (content) / ``blocks``
        (pool ids).  New nodes ``acquire`` their block (the radix becomes
        a holder); blocks whose content is already indexed under a
        DIFFERENT pool id are left alone (the sequence keeps its private
        copy; it frees normally at flush).  Returns new-node count."""
        bs = self.block_size
        node = self.root
        added = 0
        self._clock += 1
        for i in range(min(len(tokens), len(blocks) * bs) // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, blocks[i], node)
                self.allocator.acquire([blocks[i]])
                node.children[key] = child
                self.node_count += 1
                added += 1
            child.stamp = self._clock
            node = child
        return added

    # ---------------------------------------------------------- eviction
    def _nodes(self) -> List[RadixNode]:
        """All trie nodes in pre-order (parents before children) — the
        one DFS every walker below shares."""
        order: List[RadixNode] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        return order

    def _evictable_leaves(self) -> List[RadixNode]:
        return [n for n in self._nodes()
                if not n.children and self.allocator.refcount(n.block) == 1]

    def evictable_set(self) -> frozenset:
        """Block ids reclaimable by repeated leaf eviction: a node counts
        iff only the radix holds it (refcount == 1) AND its whole subtree
        is likewise reclaimable (a live descendant pins the path above
        it).  Computed bottom-up over the shared DFS order, cached
        against the allocator's refcount version — the scheduler reads
        ``available_blocks`` several times per round (decode checks,
        admission, burst sizing) and the DFS must not run O(running ×
        trie) times per round on the dispatch thread.  Every tree
        mutation (insert acquires, evict releases) bumps the version
        too, so the cache can never go stale."""
        version = self.allocator.version
        if self._evictable_cache[0] == version:
            return self._evictable_cache[1]
        reclaim: Dict[int, bool] = {}
        blocks = set()
        for n in reversed(self._nodes()):
            ok = self.allocator.refcount(n.block) == 1 and all(
                reclaim[id(c)] for c in n.children.values())
            reclaim[id(n)] = ok
            if ok:
                blocks.add(n.block)
        out = frozenset(blocks)
        self._evictable_cache = (version, out)
        return out

    def evictable_blocks(self) -> int:
        return len(self.evictable_set())

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks, LRU leaves first (evicting a leaf may
        expose its parent as the next leaf).  Returns blocks actually
        freed back to the pool."""
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.stamp)
            for leaf in leaves:
                if freed >= n:
                    break
                del leaf.parent.children[leaf.key]
                self.node_count -= 1
                freed += len(self.allocator.release([leaf.block]))
        return freed

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        """Residency gauges, cached against the allocator refcount version
        like :meth:`evictable_blocks` — ``kv_sample`` reads this once per
        scheduler round, and an uncached O(trie) DFS there would grow
        per-round host work with cache size."""
        version = self.allocator.version
        if self._stats_cache[0] == version:
            return self._stats_cache[1]
        nodes = self._nodes()
        out = {"nodes": len(nodes),
               "shared": sum(1 for n in nodes
                             if self.allocator.refcount(n.block) > 1),
               "evictable": self.evictable_blocks()}
        self._stats_cache = (version, out)
        return out

    def check_invariants(self) -> None:
        """Test hook: every indexed block is live (refcount ≥ 1), node
        bookkeeping matches the tree, and no key is empty."""
        nodes = self._nodes()
        for nd in nodes:
            assert len(nd.key) == self.block_size, nd.key
            assert self.allocator.refcount(nd.block) >= 1, \
                (nd.block, self.allocator.refcount(nd.block))
            for key, c in nd.children.items():
                assert c.parent is nd and c.key == key
        assert len(nodes) == self.node_count, (len(nodes), self.node_count)


@dataclasses.dataclass
class SequenceDescriptor:
    """Tracks one in-flight sequence (reference
    inference/v2/ragged/sequence_descriptor.py DSSequenceDescriptor)."""

    uid: int
    slot: int                                  # dense slot in the batch arrays
    blocks: List[int] = dataclasses.field(default_factory=list)
    seen_tokens: int = 0                       # tokens already in the KV cache
    pending: np.ndarray = dataclasses.field(   # prompt tokens not yet scheduled
        default_factory=lambda: np.zeros(0, np.int32))
    # token content the HOST knows from position 0 (prompt + preemption-folded
    # generated tokens; device-sampled values are unknown until materialize,
    # so the known prefix never extends past them) — the radix insert key
    host_tokens: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    # blocks already indexed by the radix for this sequence (insert cursor —
    # avoids re-walking the whole prefix on every decode block completion;
    # also covers the admission match: matched blocks are already indexed)
    cached_blocks: int = 0
    # LoRA adapter this request pins resident (0 = base model, no pin) —
    # bind_adapter() acquires the pool pages' refcounts, flush releases them
    adapter: int = 0

    @property
    def in_flight(self) -> bool:
        return self.pending.size > 0

    def kv_blocks_needed(self, new_tokens: int, block_size: int) -> int:
        total = self.seen_tokens + new_tokens
        need = -(-total // block_size)
        return max(0, need - len(self.blocks))


@dataclasses.dataclass(frozen=True)
class RaggedBatch:
    """One scheduled forward step: flat token arrays + per-slot tables
    (reference ragged_wrapper.py RaggedBatchWrapper)."""

    tokens: np.ndarray          # [N] int32, pad 0
    token_slot: np.ndarray      # [N] int32, slot of each token, pad -1
    token_pos: np.ndarray       # [N] int32 logical position, pad 0
    token_dense_idx: np.ndarray  # [N] int32 index within the slot's q rows
    block_table: np.ndarray     # [S, MB] int32, pad 0
    kv_len: np.ndarray          # [S] int32 kv length AFTER this step
    q_len: np.ndarray           # [S] int32 new tokens this step
    logits_slots: List[int]     # slots whose last-token logits are meaningful
    slot_uid: Dict[int, int]    # slot -> uid for this step
    total_tokens: int


class DSStateManager:
    """Sequence tracking + KV block accounting (reference
    inference/v2/ragged/ragged_manager.py DSStateManager + kv_cache.py
    KVCacheManager), with the optional radix prefix-cache layer."""

    def __init__(self, max_tracked_sequences: int, num_blocks: int,
                 block_size: int, max_seq_len: int,
                 prefix_cache: bool = False):
        self.max_tracked_sequences = int(max_tracked_sequences)
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self.max_blocks_per_seq = -(-self.max_seq_len // self.block_size)
        self.allocator = BlockedAllocator(num_blocks)
        self.radix: Optional[RadixKVCache] = (
            RadixKVCache(self.allocator, self.block_size)
            if prefix_cache else None)
        # multi-tenant LoRA adapter pool (serving/adapters.py AdapterPool):
        # a SECOND block-granular resident of the same allocator, attached
        # by the engine when its adapters config enables it.  Supply
        # accounting (available_blocks) and eviction (ensure_blocks) fold
        # it in below so every starvation check stays honest.
        self.adapters = None
        self._seqs: Dict[int, SequenceDescriptor] = {}
        # deque: create/flush are per-request hot-path ops (list.pop(0)/
        # insert(0) would be O(S) each)
        self._free_slots: Deque[int] = deque(range(self.max_tracked_sequences))

    # ---- reference DSStateManager.get_or_create_sequence ----
    def get(self, uid: int) -> Optional[SequenceDescriptor]:
        return self._seqs.get(uid)

    def create(self, uid: int) -> SequenceDescriptor:
        if uid in self._seqs:
            raise ValueError(f"sequence uid {uid} already tracked")
        if not self._free_slots:
            raise RuntimeError(
                f"sequence capacity exhausted "
                f"({self.max_tracked_sequences} tracked)")
        seq = SequenceDescriptor(uid=uid, slot=self._free_slots.popleft())
        self._seqs[uid] = seq
        return seq

    def flush(self, uid: int) -> None:
        """Release a sequence's blocks + slot (reference engine_v2.flush :242).
        Shared blocks only drop this sequence's hold — the radix (and any
        other sharer) keeps them alive; exclusive blocks return to the
        free list as before."""
        seq = self._seqs.pop(uid)
        if seq.adapter and self.adapters is not None:
            # drop this request's pin on its adapter pages — EVERY engine
            # flush path (retirement, preemption, admission rollback)
            # funnels through here, so pins release exactly once per bind
            self.adapters.release(seq.adapter)
        self.allocator.release(seq.blocks)
        self._free_slots.appendleft(seq.slot)

    def ensure_blocks(self, seq: SequenceDescriptor, new_tokens: int) -> None:
        need = seq.kv_blocks_needed(new_tokens, self.block_size)
        if need:
            short = need - self.allocator.free_blocks
            if short > 0 and self.adapters is not None:
                # cold adapters go before KV prefixes: an evictable adapter
                # serves no in-flight request, while the LRU-freshest radix
                # leaves are the shared prompts being re-matched
                short -= self.adapters.evict_cold(short)
            if short > 0 and self.radix is not None:
                self.radix.evict(short)
            seq.blocks.extend(self.allocator.allocate(need))

    def ensure_adapters(self, adapter_ids) -> None:
        """Make every adapter in ``adapter_ids`` resident, spilling the
        radix cache (beyond the pool's own cold adapters) when the load
        needs blocks the free list cannot cover."""
        if self.adapters is not None:
            spill = (self.radix.evict if self.radix is not None else None)
            self.adapters.ensure(adapter_ids, spill=spill)

    def bind_adapter(self, seq: SequenceDescriptor, adapter_id: int) -> None:
        """Pin ``adapter_id``'s resident pages for this request's lifetime
        (refcount acquire on the shared allocator — a pinned adapter is
        never LRU-evicted under it).  flush() releases the pin."""
        if self.adapters is not None and adapter_id:
            self.adapters.acquire(adapter_id)
            seq.adapter = int(adapter_id)

    @property
    def available_blocks(self) -> int:
        """Blocks a scheduler can count on: free now + reclaimable from
        the radix cache and cold adapter pages by LRU eviction.  The
        supply side every starvation check (put / can_schedule / decode /
        prompt_chunk / admission) compares against — a cached-but-
        unreferenced block must never make the scheduler preempt or
        shed."""
        free = self.allocator.free_blocks
        if self.radix is not None:
            free += self.radix.evictable_blocks()
        if self.adapters is not None:
            free += self.adapters.evictable_blocks()
        return free

    # ------------------------------------------------- radix prefix cache
    def _capped_path(self, tokens) -> List[RadixNode]:
        """THE matchable path for a prompt: the trie walk capped at
        ``len(tokens) - 1`` rounded down to a block multiple (at least one
        token always runs through the forward — its logits seed
        decoding).  The single definition every peek AND the actual
        acquisition share, so a feasibility precheck can never desync
        from what ``match_prefix`` acquires."""
        if self.radix is None or tokens is None or len(tokens) < 2:
            return []
        cap = (len(tokens) - 1) // self.block_size * self.block_size
        return self.radix._walk(tokens[:cap])

    def peek_prefix_pinned(self, tokens: np.ndarray) -> Tuple[int, int]:
        """(match length, supply the match would pin): admission checks
        compare ``fresh_blocks_needed + pinned`` against
        ``available_blocks`` — matched evictable nodes stop being supply
        the moment the sequence acquires them, so counting them as both
        supply AND skipped-need would overpromise the pool.  (Membership
        in the evictable set, not refcount == 1: a refcount-1 node pinned
        by a live descendant was never supply and must not inflate the
        need.)"""
        path = self._capped_path(tokens)
        if not path:
            return 0, 0
        evictable = self.radix.evictable_set()
        return (len(path) * self.block_size,
                sum(1 for n in path if n.block in evictable))

    def peek_prefix_batch(self, tokens_list
                          ) -> Tuple[List[int], int, List[List[RadixNode]]]:
        """Batch form of :meth:`peek_prefix_pinned`: per-prompt capped
        match lengths plus the UNIQUE evictable blocks the whole batch
        would pin — prompts sharing a cached prefix (the target workload)
        pin each node once, not once per prompt, so a feasible shared-
        prefix ``put()`` batch is never spuriously rejected.  Also
        returns the walked paths so the caller can hand them back to
        :meth:`match_prefix` instead of re-walking (valid as long as no
        insert/evict runs in between — true for the single-threaded
        validate→admit sequence in ``put()``)."""
        matches: List[int] = []
        paths: List[List[RadixNode]] = []
        pinned: set = set()
        evictable = (self.radix.evictable_set()
                     if self.radix is not None else frozenset())
        for toks in tokens_list:
            path = self._capped_path(toks)
            paths.append(path)
            matches.append(len(path) * self.block_size)
            for node in path:
                if node.block in evictable:
                    pinned.add(node.block)
        return matches, len(pinned), paths

    def match_prefix(self, seq: SequenceDescriptor, tokens: np.ndarray,
                     path: Optional[List[RadixNode]] = None) -> int:
        """Alias the longest cached block-aligned prefix of ``tokens`` into
        ``seq``: the matched blocks are acquired (this sequence becomes a
        holder), ``seen_tokens`` starts at the match boundary, and the
        match is capped by :meth:`_capped_path` so at least one token
        always runs through the forward.  ``path`` reuses a walk a
        just-taken :meth:`peek_prefix_batch` already did (no trie
        mutation may run in between).  Returns the matched token count."""
        if self.radix is None or seq.seen_tokens:
            return 0
        if path is None:
            path = self._capped_path(tokens)
        if not path:
            return 0
        self.radix.touch(path)
        blocks = [n.block for n in path]
        self.allocator.acquire(blocks)
        seq.blocks = blocks + seq.blocks
        seq.seen_tokens = len(blocks) * self.block_size
        seq.cached_blocks = len(blocks)
        return seq.seen_tokens

    def cache_insert(self, seq: SequenceDescriptor) -> int:
        """Index ``seq``'s host-known full blocks into the radix.  Called
        AFTER the forward filling them has been dispatched — later
        programs that read the aliased pages are ordered behind the writer
        by the donated-cache dispatch chain, so the host never needs the
        values, only the content KEY (which it fed in).  Idempotent via
        the per-sequence ``cached_blocks`` cursor."""
        if self.radix is None:
            return 0
        bs = self.block_size
        known = min(len(seq.host_tokens), seq.seen_tokens)
        n_full = known // bs
        if n_full <= seq.cached_blocks:
            return 0
        added = self.radix.insert(seq.host_tokens[:n_full * bs],
                                  seq.blocks[:n_full])
        seq.cached_blocks = n_full
        return added

    @property
    def tracked(self) -> Dict[int, SequenceDescriptor]:
        return self._seqs

    @property
    def free_sequence_slots(self) -> int:
        return len(self._free_slots)


def build_ragged_batch(schedule, state: DSStateManager, token_budget: int,
                       max_q_per_seq: int) -> RaggedBatch:
    """Pack (seq, tokens) pairs into the static device arrays.

    schedule: list of (SequenceDescriptor, np.ndarray tokens) — tokens are
    appended to the sequence's KV at positions [seen, seen+len).
    """
    S = state.max_tracked_sequences
    MB = state.max_blocks_per_seq
    N = token_budget
    tokens = np.zeros(N, np.int32)
    token_slot = np.full(N, -1, np.int32)
    token_pos = np.zeros(N, np.int32)
    token_dense = np.zeros(N, np.int32)
    block_table = np.zeros((S, MB), np.int32)
    kv_len = np.zeros(S, np.int32)
    q_len = np.zeros(S, np.int32)
    logits_slots: List[int] = []
    slot_uid: Dict[int, int] = {}

    cursor = 0
    for seq, toks in schedule:
        n = len(toks)
        assert n <= max_q_per_seq, (n, max_q_per_seq)
        assert cursor + n <= N, "token budget exceeded by schedule"
        sl = seq.slot
        tokens[cursor:cursor + n] = toks
        token_slot[cursor:cursor + n] = sl
        token_pos[cursor:cursor + n] = np.arange(seq.seen_tokens,
                                                 seq.seen_tokens + n)
        token_dense[cursor:cursor + n] = np.arange(n)
        bt = np.asarray(seq.blocks, np.int32)
        block_table[sl, :len(bt)] = bt
        kv_len[sl] = seq.seen_tokens + n
        q_len[sl] = n
        logits_slots.append(sl)
        slot_uid[sl] = seq.uid
        cursor += n
    return RaggedBatch(tokens=tokens, token_slot=token_slot,
                       token_pos=token_pos, token_dense_idx=token_dense,
                       block_table=block_table, kv_len=kv_len, q_len=q_len,
                       logits_slots=logits_slots, slot_uid=slot_uid,
                       total_tokens=cursor)
