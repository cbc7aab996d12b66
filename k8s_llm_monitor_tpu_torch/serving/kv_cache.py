"""Host-side paged KV-cache block management: refcounted allocator + prefix
cache (a copy of the JAX package's ``serving/kv_cache.py``; its code is
held to that module by ``tests/test_torch_copies.py``).

The device-side page tensors live in models/llama.py (KVPages); these
classes own the free list, per-block reference counts, and the
prompt-prefix reuse map.  Block id 0 is the null block -- masked lanes in
prefill/decode scatter there -- so it is never handed out.

Prefix sharing needs no copy-on-write:

  * Only *full* blocks covered entirely by a prompt are ever shared
    (``shareable_blocks``: at least one prompt token always stays
    unshared).  A block's K/V is a pure function of the token prefix
    (absolute-position RoPE), so equal prefixes mean equal pages.
  * A sequence's writes start at its first unshared position, which lands
    in a block it owns alone, so shared blocks are read-only for their
    whole lifetime and reference counting is enough.
  * The cache is an LRU over chain digests ``h_k = sha256(h_{k-1} ||
    block_k_token_bytes)`` seeded by the tenant's namespace digest
    (``resilience.tenancy.tenant_seed``): collision-proof keys, O(L)
    registration, and no prefix hit across tenants.  Lookup walks the
    chain from the longest prefix down; eviction drops the cache's
    reference, and blocks still held by live slots survive.  With
    ``max_tenant_share`` below 1, a tenant over its share of the cached
    blocks loses its own LRU entries first.

Every diagnosis query shares the system preamble and the evidence prefix
(monitor/analysis.py builds them), so a burst of questions about one
cluster prefills that prefix once.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector
from k8s_llm_monitor_tpu_torch.resilience.tenancy import DEFAULT_TENANT, tenant_seed


def shareable_blocks(n_tokens: int, block_size: int) -> int:
    """Full blocks of a prompt that may be published for prefix reuse,
    leaving >= 1 unshared token (the final prompt token must run through
    prefill to produce the first-token logits).  The single source of
    truth for the shareable-span rule — PrefixCache.lookup/register and
    the engine's admission deferral gate must agree on it exactly."""
    return min(n_tokens // block_size, (n_tokens - 1) // block_size)


def page_slice_bytes(num_kv_heads: int, head_dim: int, block_size: int,
                     dtype_bytes: int, tp: int = 1,
                     scale_bytes: int = 0) -> int:
    """Bytes ONE chip holds for ONE logical KV page (K + V) under
    head-dimension sharding.

    With ``tp`` dividing ``num_kv_heads`` each chip stores a
    ``kv_heads/tp`` slice of every page; otherwise the pool is replicated
    (parallel/sharding.py ``SpecLayout.kv_pages``) and every chip pays the
    full page.  Fit preflight multiplies this by ``num_blocks`` — the
    page-id namespace itself never shrinks with the mesh (global-ids
    invariant above).

    ``scale_bytes`` accounts for quantized pools: a per-token-per-head
    dequant scale array rides each of K and V (models/llama.py KVPages
    ``k_scale``/``v_scale``, f32 so scale_bytes=4), sharded on the same
    head boundaries as the pages themselves (``SpecLayout.kv_scales``)."""
    sharded = 1 < tp <= num_kv_heads and num_kv_heads % tp == 0
    heads = num_kv_heads // tp if sharded else num_kv_heads
    return (2 * block_size * heads * head_dim * dtype_bytes
            + 2 * block_size * heads * scale_bytes)


class OutOfBlocks(Exception):
    pass


class BlockAllocator:
    """Free-list allocator with per-block reference counts.

    ``alloc``/``extend`` hand out blocks at refcount 1; ``incref`` adds
    sharers; ``free`` decrements and returns a block to the free list only
    when its count reaches zero.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))  # pop -> 1,2,...
        self._refs: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def can_alloc(self, num_tokens: int) -> bool:
        return self.blocks_for(num_tokens) <= len(self._free)

    def alloc(self, num_tokens: int) -> list[int]:
        n = self.blocks_for(num_tokens)
        if get_injector().should_fire("alloc_exhaustion"):
            raise OutOfBlocks(
                f"injected exhaustion: need {n} blocks (fault point)")
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def extend(self, blocks: list[int], new_len: int) -> None:
        """Grow ``blocks`` in place to cover ``new_len`` tokens."""
        need = self.blocks_for(new_len) - len(blocks)
        if need <= 0:
            return
        if get_injector().should_fire("alloc_exhaustion"):
            raise OutOfBlocks(
                f"injected exhaustion: need {need} more blocks (fault point)")
        if need > len(self._free):
            raise OutOfBlocks(f"need {need} more blocks, {len(self._free)} free")
        for _ in range(need):
            b = self._free.pop()
            self._refs[b] = 1
            blocks.append(b)

    def incref(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == 0:
                raise ValueError("cannot share the null block")
            self._refs[b] += 1

    def ref_count(self, block: int) -> int:
        return self._refs.get(block, 0)

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == 0:
                raise ValueError("attempt to free the null block")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
        blocks.clear()


@dataclasses.dataclass
class _PrefixEntry:
    blocks: tuple[int, ...]     # cache-owned refs (one per block)
    tenant: str = DEFAULT_TENANT  # namespace owner (fairness accounting)


class PrefixCache:
    """LRU map from token-prefix chain digests to shared KV blocks.

    All entries' blocks carry one cache-owned reference; ``lookup`` increfs
    the reused span for the caller, ``evict_lru`` releases the cache's own
    reference (live slots keep their pages).

    ``hits``/``misses`` are maintained by the engine at admission time (a
    lookup retried for a deferred request must not double-count).
    """

    def __init__(self, allocator: BlockAllocator, max_entries: int = 512,
                 max_tenant_share: float = 1.0):
        self.allocator = allocator
        self.max_entries = max_entries
        # Fairness cap: once >1 tenant is resident, a tenant holding more
        # than this fraction of the cached blocks becomes the preferred
        # eviction victim (1.0 = no cap).
        self.max_tenant_share = float(max_tenant_share)
        # Insertion-ordered: first key is always the LRU entry (touch =
        # pop + reinsert), so eviction never scans.
        self._entries: dict[bytes, _PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _chain_digests(self, prompt_ids: list[int], n_blocks: int,
                       tenant: str) -> list[bytes]:
        """SHA-256 chain over block token bytes, seeded by the tenant's
        namespace digest: collision-proof AND tenant-disjoint keys, O(L)."""
        bs = self.allocator.block_size
        digests = []
        h = tenant_seed(tenant)
        for k in range(n_blocks):
            block = np.asarray(prompt_ids[k * bs:(k + 1) * bs], np.int64)
            h = hashlib.sha256(h + block.tobytes()).digest()
            digests.append(h)
        return digests

    def _shareable_blocks(self, prompt_ids: list[int]) -> int:
        return shareable_blocks(len(prompt_ids), self.allocator.block_size)

    def digest_chain(self, prompt_ids: list[int], n_blocks: int, *,
                     tenant: str) -> list[bytes]:
        """Public digest access: the host spill tier (serving/kv_tier.py)
        and the fleet migration path key their entries by the SAME chain
        digests lookup walks, so a demoted or migrated prefix is found by
        the identical probe that would have hit it on-device.  ``tenant``
        is keyword-required on purpose: every key derivation must name its
        namespace (graftcheck's ``tenant-namespace`` rule enforces it)."""
        return self._chain_digests(prompt_ids, n_blocks, tenant)

    def _touch(self, key: bytes, entry: _PrefixEntry) -> None:
        del self._entries[key]
        self._entries[key] = entry

    def lookup(self, prompt_ids: list[int], *,
               tenant: str) -> tuple[list[int], int]:
        """Longest cached prefix of ``prompt_ids`` in ``tenant``'s
        namespace (digests of other tenants can never match: the chains
        are seeded differently).

        Returns (shared block ids increfed for the caller, tokens covered).
        The caller owns one reference per returned block and must release
        it through ``BlockAllocator.free`` eventually.
        """
        n = self._shareable_blocks(prompt_ids)
        if n <= 0 or not self._entries:
            return [], 0
        digests = self._chain_digests(prompt_ids, n, tenant)
        for k in range(n, 0, -1):
            entry = self._entries.get(digests[k - 1])
            if entry is not None and len(entry.blocks) >= k:
                self._touch(digests[k - 1], entry)
                shared = list(entry.blocks[:k])
                self.allocator.incref(shared)
                return shared, k * self.allocator.block_size
        return [], 0

    def register(self, prompt_ids: list[int], blocks: list[int], *,
                 tenant: str) -> None:
        """Publish a prompt's full blocks for reuse (after its prefill has
        been dispatched — page contents are ordered by device data flow).

        One entry is stored per prefix length (a flattened trie), so a later
        prompt diverging mid-way still reuses the longest common span.  Each
        entry owns references on its own span; block i is held by every
        entry covering it and returns to the pool when all are evicted."""
        n = self._shareable_blocks(prompt_ids)
        if n <= 0:
            return
        digests = self._chain_digests(prompt_ids, n, tenant)
        for k in range(n, 0, -1):
            key = digests[k - 1]
            entry = self._entries.get(key)
            if entry is not None:
                self._touch(key, entry)
                continue
            while len(self._entries) >= self.max_entries:
                if not self.evict_lru():
                    return
            shared = blocks[:k]
            self.allocator.incref(shared)
            self._entries[key] = _PrefixEntry(tuple(shared), tenant)
        # Fairness cap: if this registration pushed the tenant over its
        # share (and someone else is resident), the tenant pays with its
        # OWN oldest entries — never another tenant's.
        while self._overshare_tenant() == tenant:
            if not self._evict_key(self._tenant_lru_key(tenant)):
                break

    def evictable_blocks(self) -> int:
        """Blocks an eviction sweep could return to the free list right
        now: those whose every reference is cache-owned (live slots pin
        theirs, and a pinned block survives eviction — ``free`` only
        decrefs).  One entry per prefix length means a block is covered by
        several entries; it is evictable iff its allocator refcount equals
        that coverage.  Tier-aware admission
        (engine.admission_headroom_tokens) counts these as capacity the
        spill path can deliver without losing cache content."""
        coverage: dict[int, int] = {}
        for entry in self._entries.values():
            for b in entry.blocks:
                coverage[b] = coverage.get(b, 0) + 1
        return sum(1 for b, n in coverage.items()
                   if self.allocator.ref_count(b) == n)

    def blocks_by_tenant(self) -> dict[str, int]:
        """Distinct resident blocks per tenant (tenant namespaces are
        disjoint, so the counts never double-book a block) — the fairness
        accounting behind the max-share cap and ``tenant_kv_blocks``."""
        per: dict[str, set[int]] = {}
        for entry in self._entries.values():
            per.setdefault(entry.tenant, set()).update(entry.blocks)
        return {t: len(s) for t, s in per.items()}

    def _overshare_tenant(self) -> str | None:
        """The tenant currently over its max-share cap (worst offender),
        or None.  Only meaningful with >= 2 resident tenants: a sole
        tenant using the whole cache victimizes nobody."""
        if self.max_tenant_share >= 1.0:
            return None
        per = self.blocks_by_tenant()
        if len(per) < 2:
            return None
        total = sum(per.values())
        if total <= 0:
            return None
        worst = max(per, key=lambda t: per[t])
        if per[worst] > self.max_tenant_share * total:
            return worst
        return None

    def _tenant_lru_key(self, tenant: str) -> bytes | None:
        """The oldest entry belonging to ``tenant`` (insertion order)."""
        for key, entry in self._entries.items():
            if entry.tenant == tenant:
                return key
        return None

    def _victim_key(self) -> bytes | None:
        """The entry the next eviction should take: an over-share tenant's
        own LRU when the fairness cap is tripped, the global LRU otherwise.
        ``peek_lru`` and ``evict_lru`` both route through this so the
        engine's spill-then-evict sequence stays coherent."""
        if not self._entries:
            return None
        offender = self._overshare_tenant()
        if offender is not None:
            key = self._tenant_lru_key(offender)
            if key is not None:
                return key
        return next(iter(self._entries))

    def _evict_key(self, key: bytes | None) -> bool:
        if key is None:
            return False
        entry = self._entries.pop(key)
        self.allocator.free(list(entry.blocks))
        self.evictions += 1
        return True

    def peek_lru(self) -> tuple[bytes, list[int]] | None:
        """The next eviction victim's (chain digest, block ids) without
        evicting or touching refcounts — the engine's host-spill wrapper
        reads the victim's pages off-device *before* calling ``evict_lru``
        so a pressured eviction demotes to the host tier instead of
        dropping."""
        key = self._victim_key()
        if key is None:
            return None
        return key, list(self._entries[key].blocks)

    def peek_lru_tenant(self) -> str | None:
        """Namespace owner of the next eviction victim (the spill wrapper
        tags the host-tier entry with it)."""
        key = self._victim_key()
        return self._entries[key].tenant if key is not None else None

    def evict_lru(self) -> bool:
        """Drop the next victim entry (the over-share tenant's LRU when the
        fairness cap is tripped, else the global LRU), releasing the
        cache's block references.  Returns False when the cache is empty."""
        return self._evict_key(self._victim_key())

    def clear(self) -> None:
        while self.evict_lru():
            pass
