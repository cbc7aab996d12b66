"""Host-side paged KV-cache block management (copy of the JAX package's
allocator half of ``serving/kv_cache.py``; the prefix cache is not ported
yet).

Block id 0 is the null block -- masked lanes in prefill/decode scatter
there -- so it is never handed out.  Block ids are global: one allocator
serves the whole page pool.
"""

from __future__ import annotations


def shareable_blocks(n_tokens: int, block_size: int) -> int:
    """Full blocks of a prompt that may be published for prefix reuse,
    leaving >= 1 unshared token (the final prompt token must run through
    prefill to produce the first-token logits)."""
    return min(n_tokens // block_size, (n_tokens - 1) // block_size)


def page_slice_bytes(num_kv_heads: int, head_dim: int, block_size: int,
                     dtype_bytes: int, tp: int = 1,
                     scale_bytes: int = 0) -> int:
    """Bytes one device holds for one logical KV page (K + V) when the pool
    is sharded on kv-head boundaries over ``tp`` devices (replicated when
    ``tp`` does not divide the kv heads); ``scale_bytes`` adds per-token,
    per-head dequant scales of a quantized pool."""
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
