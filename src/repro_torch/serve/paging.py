"""Paged KV pool bookkeeping: block allocator, copy-on-write, prefix
sharing, and the paged prefill/decode step factories.

The port of ``repro/serve/paging.py``. The device arena is one
``(n_blocks + 1, block_size, n_kv, D)`` tensor per layer
(``transformer.init_paged_pool``); everything in this module except the
step factories is pure host-side state, mirroring the split between
``scheduler`` (host) and ``batching`` (device).

- :class:`BlockAllocator` — free-list + per-block refcounts over the
  arena. A block with refcount > 1 is shared (prefix sharing);
  ``ensure_writable`` implements copy-on-write: before a writer touches
  a shared block it gets a private copy (``transformer.copy_pool_block``
  on the device) and the share count drops by one.
- :class:`PrefixCache` — requests carrying the same
  ``Request.prefix_id`` map their shared prompt prefix onto the same
  refcounted blocks. Only *complete* blocks strictly before the last
  prompt token are shared, so every writer owns its tail block and at
  least one prompt token is always prefilled (the first sampled token's
  logits come from the writer's own compute).
- ``make_paged_prefill_step`` / ``make_paged_decode_step`` — the steps
  threading per-request block tables through ``transformer.forward``
  the same way the vector ``cache_index`` is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.specs import ModelConfig


class OutOfBlocks(RuntimeError):
    """The arena has fewer free blocks than an allocation needs — the
    scheduler holds the request in the queue (admission backpressure)."""


class BlockAllocator:
    """Host-side free-list allocator with per-block refcounts.

    Blocks ``0 .. n_blocks-1`` are allocatable; the arena's extra
    scratch block (index ``n_blocks``) is never handed out — padded
    prefill positions and inactive decode slots write there.
    """

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.scratch = n_blocks          # reserved scratch block id
        self._free = list(range(n_blocks - 1, -1, -1))
        self._refs: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> list:
        """Claim ``n`` fresh blocks (refcount 1 each)."""
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def retain(self, blocks) -> None:
        """Add one reference to each block (prefix sharing)."""
        for b in blocks:
            if self._refs.get(b, 0) <= 0:
                raise ValueError(f"retain of unallocated block {b}")
            self._refs[b] += 1

    def release(self, blocks) -> None:
        """Drop one reference; a block at zero returns to the free
        list."""
        for b in blocks:
            r = self._refs.get(b, 0)
            if r <= 0:
                raise ValueError(f"release of unallocated block {b}")
            if r == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = r - 1

    def ensure_writable(self, table, j: int, pool,
                        reserve: Optional[int] = None):
        """Copy-on-write: make ``table[j]`` safe for its owner to write.

        If the block is shared (refcount > 1), place a private copy into
        ``reserve`` — a block the owner already claimed at admission
        time — duplicate the contents on the device, and drop the shared
        reference. Without a reserve the copy block is allocated here,
        which can raise :class:`OutOfBlocks` against a full arena:
        admission must pre-claim the reserve for any request entering on
        shared blocks so COW can never fail mid-tick. Returns the pool
        (updated in place). ``table`` is a mutable host-side sequence of
        physical block ids.
        """
        b = int(table[j])
        if self._refs.get(b, 0) <= 1:
            return pool                 # exclusive (or scratch): no-op
        if reserve is not None:
            fresh = reserve             # refcount 1 since admission
        else:
            (fresh,) = self.alloc(1)
        pool = T.copy_pool_block(pool, b, fresh)
        self.release([b])
        table[j] = fresh
        return pool


class PrefixCache:
    """``prefix_id`` -> shared prompt-prefix blocks (request-level cache
    identity, after deepsparse's ``session_ids``).

    The first request with a given ``prefix_id`` prefills normally and
    ``register``\\ s its full prompt blocks once its prefill completes
    (the blocks' contents are only valid then); later requests whose
    prompt starts with the registered tokens ``match`` those blocks into
    their own block table at +1 refcount and skip prefilling them.
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self._entries: dict[str, tuple] = {}   # id -> (tokens, blocks)

    def __len__(self) -> int:
        return len(self._entries)

    def shareable_tokens(self, prompt) -> int:
        """Tokens coverable by shared full blocks: complete blocks
        strictly before the last prompt token, so the writer always
        prefills >= 1 token into blocks it owns."""
        bs = self.allocator.block_size
        return ((len(prompt) - 1) // bs) * bs

    def match(self, prefix_id: Optional[str], prompt) -> list:
        """Blocks of ``prefix_id`` reusable for ``prompt`` (may be
        ``[]``): the longest block-aligned run of tokens the registered
        entry and this prompt agree on, so requests that diverge
        mid-prompt (same system prefix, different tails) still share the
        common blocks. Caller must map them into a table via
        ``allocator.retain``."""
        if prefix_id is None or prefix_id not in self._entries:
            return []
        tokens, blocks = self._entries[prefix_id]
        limit = min(len(tokens), self.shareable_tokens(prompt))
        same = 0
        for a, b in zip(tokens[:limit], prompt[:limit]):
            if a != b:
                break
            same += 1
        n = (same // self.allocator.block_size) * self.allocator.block_size
        return blocks[:n // self.allocator.block_size]

    def register(self, prefix_id: Optional[str], prompt, table) -> None:
        """After a prefill completes: publish the request's full prompt
        blocks under ``prefix_id``. The cache holds its own reference so
        the blocks outlive the registering request. First writer wins;
        later registrations are no-ops."""
        if prefix_id is None or prefix_id in self._entries:
            return
        n = self.shareable_tokens(prompt)
        if n == 0:
            return
        blocks = [int(b) for b in table[:n // self.allocator.block_size]]
        self.allocator.retain(blocks)
        self._entries[prefix_id] = (tuple(prompt[:n]), blocks)

    def drop_all(self) -> None:
        """Release every cached prefix (end of a serving run)."""
        for _, blocks in self._entries.values():
            self.allocator.release(blocks)
        self._entries.clear()


# ------------------------------------------------------------------ steps

def make_paged_prefill_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                            mlp_apply=None):
    """One (chunk of a) B=1 prompt into the paged pool. ``tokens`` is
    right-padded to a bucket; ``n_valid`` masks the padding into the
    scratch block; ``start`` is the chunk's first logical position (> 0
    for later chunks and for requests entering on a shared prefix)."""
    def paged_prefill_step(params, pool, tokens, block_table, start,
                           n_valid):
        logits, pool, _ = T.forward(
            params, cfg, tokens, cache=pool, cache_index=start,
            block_tables=block_table, n_valid=n_valid,
            compute_dtype=compute_dtype, mlp_apply=mlp_apply)
        return logits, pool
    return paged_prefill_step


def make_paged_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                           mlp_apply=None, paged_kernel: bool = False):
    """One token for every slot against the paged pool: the per-slot
    ``lengths`` vector and ``block_tables`` play the role the vector
    ``cache_index`` plays for the contiguous pool. ``paged_kernel``
    routes attention through the paged-attention op (block tables walked
    in the kernel, K/V read in place) instead of materialising each
    slot's logical view."""
    def paged_decode_step(params, pool, tokens, lengths, block_tables):
        logits, pool, _ = T.forward(
            params, cfg, tokens, cache=pool, cache_index=lengths,
            block_tables=block_tables, compute_dtype=compute_dtype,
            mlp_apply=mlp_apply, paged_kernel=paged_kernel)
        return logits[:, -1, :], pool
    return paged_decode_step
