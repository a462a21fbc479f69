"""Hashed shared-prefix KV block store for cache-aware admission.

Ternary packing attacks the weight-bandwidth wall, which leaves *prefill
compute* as the dominant admission cost — and production traffic is
dominated by shared system prompts and multi-turn re-submission, where most
of that prefill recomputes KV another request just produced.  This module
holds those KV blocks so admission can splice instead of recompute.

The reuse unit is one **admission chunk** (``prefill_chunk`` tokens): the
engine already pads every prompt to chunk multiples and prefills it one
fixed-shape chunk at a time, so a chunk's KV is exactly the slab a later
request with the same token prefix would recompute.  Blocks are keyed by a
**chained content hash**: block ``i``'s key digests block ``i-1``'s key plus
block ``i``'s token ids, so a key identifies the *entire* prefix up to and
including the block — two prompts share block ``i`` iff their first
``(i+1)·C`` tokens are identical.  The chain is what makes lookup a pure
prefix match: hits are always a contiguous prefix of the prompt's blocks,
never an interior fragment that the attention causality would invalidate.

The store is host-side bookkeeping over device-resident slabs
(``{"k": [L, C, Hkv, hd], "v": [L, C, Hkv, hd]}`` tensors that own their
storage), with LRU eviction under a byte budget.  It never touches model
state itself: the engine extracts slabs from its single-row admission
cache after each miss chunk (:func:`repro_torch.models.decode.extract_kv_blocks`)
and splices hits back (:func:`repro_torch.models.decode.splice_kv_blocks`),
both honouring the canonical ring invariant (position ``p`` → slot
``p % CL``).  Windowed configs cap reusable depth at the ring length
``CL``: blocks past the first ``CL`` positions would be overwritten before
the prompt's tail attends them, so they are neither published nor
consulted.  Hashes, LRU order and statistics are those of the JAX
package's store, so both publish the same key set on the same requests.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

__all__ = ["PrefixBlockStore", "PrefixStoreStats", "chain_block_hashes"]


def chain_block_hashes(tokens: Sequence[int], block_tokens: int,
                       n_blocks: int | None = None,
                       namespace: bytes = b"") -> list[bytes]:
    """Chained content hashes for the full ``block_tokens``-sized blocks of a
    token-id sequence (the trailing partial block, if any, is never hashed —
    it is not a reuse unit).

    ``hash[i] = H(hash[i-1] || tokens[i*C:(i+1)*C])``, so ``hash[i]`` is a
    content address for the whole ``(i+1)*C``-token prefix.  The digest
    depends only on the token ids (plus ``namespace``, which callers use to
    separate incompatible KV producers — model config / chunk size): it is
    invariant to batch composition, admission order, scheduler state, and
    everything else about the serving context.  ``n_blocks`` truncates the
    chain (e.g. the windowed reuse-depth cap).
    """
    toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    total = len(toks) // block_tokens
    if n_blocks is not None:
        total = min(total, n_blocks)
    prev = hashlib.blake2b(namespace + np.int32(block_tokens).tobytes(),
                           digest_size=16).digest()
    out: list[bytes] = []
    for i in range(total):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(toks[i * block_tokens:(i + 1) * block_tokens].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


@dataclass
class PrefixStoreStats:
    #: block-granular lookup tally over admissions (peeks excluded)
    hit_blocks: int = 0
    miss_blocks: int = 0
    published_blocks: int = 0
    evicted_blocks: int = 0
    #: token-granular: prompt tokens whose prefill was skipped via splice
    reused_tokens: int = 0

    @property
    def lookups(self) -> int:
        return self.hit_blocks + self.miss_blocks

    @property
    def hit_rate(self) -> float:
        """Block hit rate over all admission lookups (0.0 when none ran)."""
        n = self.lookups
        return self.hit_blocks / n if n else 0.0


class PrefixBlockStore:
    """Content-addressed KV block cache: chained prefix hashes → KV slabs,
    LRU-evicted under ``max_bytes``.

    Slabs are dicts of tensors (the store only sums their bytes for the
    budget), so device placement is the caller's concern — the engine
    stores its slabs exactly as its extract produced them, on the card.
    """

    def __init__(self, block_tokens: int, max_bytes: int = 64 << 20,
                 namespace: bytes = b""):
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.block_tokens = int(block_tokens)
        self.max_bytes = int(max_bytes)
        self.namespace = bytes(namespace)
        #: insertion/recency-ordered: oldest-used first (LRU eviction order)
        self._blocks: OrderedDict[bytes, tuple[Any, int]] = OrderedDict()
        self.nbytes = 0
        self.stats = PrefixStoreStats()

    # -- hashing ------------------------------------------------------------

    def block_hashes(self, tokens: Sequence[int],
                     n_blocks: int | None = None) -> list[bytes]:
        return chain_block_hashes(tokens, self.block_tokens,
                                  n_blocks=n_blocks,
                                  namespace=self.namespace)

    # -- lookup -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, h: bytes) -> bool:
        return h in self._blocks

    def match(self, hashes: Sequence[bytes], *, peek: bool = False) -> int:
        """Longest prefix of ``hashes`` present in the store.

        A chained hash makes any interior hit meaningless (its prefix would
        have to be present too), so matching stops at the first absence.
        Counts hit/miss stats and bumps LRU recency on the hit blocks unless
        ``peek`` (the scheduler's affinity probe — a queue reorder decision
        must not distort eviction order or the measured admission hit rate).
        """
        n = 0
        for h in hashes:
            if h not in self._blocks:
                break
            n += 1
        if not peek:
            self.stats.hit_blocks += n
            self.stats.miss_blocks += len(hashes) - n
            for h in hashes[:n]:
                self._blocks.move_to_end(h)
        return n

    def get(self, h: bytes) -> Any | None:
        """The slab for ``h`` (bumping recency), or None."""
        entry = self._blocks.get(h)
        if entry is None:
            return None
        self._blocks.move_to_end(h)
        return entry[0]

    # -- publication --------------------------------------------------------

    @staticmethod
    def _slab_bytes(slab: Any) -> int:
        return sum(t.numel() * t.element_size() for t in slab.values())

    def put(self, h: bytes, slab: Any) -> bool:
        """Publish a block; evicts LRU entries to honour the byte budget.
        Returns False (and stores nothing) if the block is already present
        or is larger than the whole budget."""
        if h in self._blocks:
            self._blocks.move_to_end(h)
            return False
        size = self._slab_bytes(slab)
        if size > self.max_bytes:
            return False
        while self.nbytes + size > self.max_bytes and self._blocks:
            _, (_, old_size) = self._blocks.popitem(last=False)
            self.nbytes -= old_size
            self.stats.evicted_blocks += 1
        self._blocks[h] = (slab, size)
        self.nbytes += size
        self.stats.published_blocks += 1
        return True

    def clear(self) -> None:
        self._blocks.clear()
        self.nbytes = 0
