"""Prefix cache: cross-request KV block sharing by content hash.

Counterpart of ``paddle_tpu/serving/prefix_cache.py``. A prompt is a
sequence of `block_size`-token chunks, each chunk's KV lives in one pool
block, and the fused step is deterministic, so two requests whose
prompts share a leading run of chunks can share the blocks.

The index is a hash chain: chunk i's key is
``H(key(i-1), tokens[i*bs:(i+1)*bs])`` (blake2b over the same bytes as
the JAX package, so both packages give the same keys for a prompt). A
chunk is matched only under the exact prefix that produced its KV. Each
entry keeps its chunk's tokens, and a lookup checks them before it
trusts the hash, so a hash collision degrades to a miss.

Lifecycle (refcounts live in PagedKVCache):

- register: when a prefill completes a full prompt chunk, the scheduler
  offers (chain key, tokens, block); the index takes its own ref. The
  request keeps its ref too, and retirement unrefs instead of freeing.
- match / claim: admission probes the chain (`match`, pure: no refs, no
  recency, no counters, since a backpressured admission retries every
  iteration) and, when it proceeds, `claim`s the matched blocks.
- eviction: an indexed block whose only ref is the index's is idle.
  Under pool pressure the scheduler evicts the least recently touched
  idle leaf first (an entry with a live indexed child is never evicted).
- copy-on-write: a request that must write into a shared block copies it
  first (`PagedKVCache.cow_copy`); the index keeps the original.

Host bookkeeping only, under the scheduler's lock. The host tier (spill
and swap-in of idle entries) and the metric gauges wait for later
slices.
"""

import hashlib

import numpy as np

__all__ = ["PrefixCacheIndex", "chain_hash", "prompt_chain_keys"]


def chain_hash(parent_key, tokens):
    """The chunk chain hash: blake2b (16-byte digest) over the parent
    key's bytes and the chunk's int32 token bytes, as a hex string."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"" if parent_key is None else parent_key.encode())
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.hexdigest()


def prompt_chain_keys(prompt, block_size, n_chunks=None):
    """Chain keys of `prompt`'s full `block_size` chunks (all of them by
    default): the index-free form of PrefixCacheIndex.chain_keys."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if n_chunks is None:
        n_chunks = len(prompt) // int(block_size)
    keys, prev = [], None
    for i in range(n_chunks):
        prev = chain_hash(prev,
                          prompt[i * block_size:(i + 1) * block_size])
        keys.append(prev)
    return keys


class _Entry:
    __slots__ = ("key", "block", "tokens", "parent", "children",
                 "last_touch")

    def __init__(self, key, block, tokens, parent, touch):
        self.key = key
        self.block = block              # pool block id (index holds a ref)
        self.tokens = tokens            # np.int32 (block_size,), verified
        self.parent = parent            # parent chain key or None
        self.children = 0               # live indexed children
        self.last_touch = touch


class PrefixCacheIndex:
    """Hash-chain prefix index over one PagedKVCache. Not thread-safe on
    its own: every call happens under the owning scheduler's lock."""

    def __init__(self, cache):
        self._cache = cache
        self._entries = {}              # chain key -> _Entry
        self._by_block = {}             # block id -> chain key
        self._touch = 0
        self.counts = {"hits": 0, "misses": 0, "evictions": 0,
                       "cow_copies": 0}

    # -- hashing -----------------------------------------------------------
    def chunk_key(self, parent_key, tokens):
        """Chain key of one chunk under its prefix (chain_hash)."""
        return chain_hash(parent_key, tokens)

    def chain_keys(self, prompt, n_chunks, have=None):
        """Chain keys of the first `n_chunks` full chunks of `prompt`,
        extending an already computed prefix `have`."""
        bs = self._cache.block_size
        keys = list(have) if have else []
        prev = keys[-1] if keys else None
        for i in range(len(keys), n_chunks):
            prev = self.chunk_key(prev, prompt[i * bs:(i + 1) * bs])
            keys.append(prev)
        return keys

    # -- lookup (admission) ------------------------------------------------
    def match(self, prompt, keys):
        """Pure probe: walk the chain over `prompt`'s full chunks with
        the precomputed `keys`, stopping at the first absent key or
        token mismatch (the collision check). Returns the matched block
        list; no refs, recency or counters move."""
        bs = self._cache.block_size
        blocks = []
        for i in range(len(prompt) // bs):
            e = self._entries.get(keys[i])
            if e is None or not np.array_equal(
                    e.tokens, prompt[i * bs:(i + 1) * bs]):
                break
            blocks.append(e.block)
        return blocks

    def claim(self, keys, blocks, probed):
        """Commit an admission's match: one ref per matched block for the
        admitting request, recency touches, and the counters (hits =
        matched chunks; one miss when the walk stopped before all
        `probed` full chunks). Runs under the same lock hold as the
        match. Returns the block list."""
        blocks = list(blocks)
        for key in keys[:len(blocks)]:
            e = self._entries[key]
            self._cache.ref(e.block)
            self._touch += 1
            e.last_touch = self._touch
        self.counts["hits"] += len(blocks)
        if len(blocks) < probed:
            self.counts["misses"] += 1
        return blocks

    def release(self, blocks):
        """Drop one request's refs on `blocks`: indexed blocks keep the
        index's ref (idle once it is the last), others free."""
        for b in blocks:
            self._cache.unref(b)

    # -- registration (prefill completion) ---------------------------------
    def register(self, key, parent_key, tokens, block):
        """Adopt `block` as the cached KV of chunk `tokens` under `key`.
        False (no-op) when the key is already indexed or its parent is
        gone (the chain walk could never reach it); on success the index
        takes its own ref."""
        if key in self._entries:
            return False
        if parent_key is not None and parent_key not in self._entries:
            return False
        self._cache.ref(block)
        self._touch += 1
        e = _Entry(key, int(block), np.array(tokens, np.int32, copy=True),
                   parent_key, self._touch)
        self._entries[key] = e
        self._by_block[int(block)] = key
        if parent_key is not None:
            self._entries[parent_key].children += 1
        return True

    def drop_block(self, block):
        """A shared block left a request's table by copy-on-write: the
        request's ref moves to the copy, the entry stays."""
        self._cache.unref(block)
        self.counts["cow_copies"] += 1

    def owns_block(self, block):
        """True when `block` is indexed (a fork-group lane's block may be
        shared only between sibling lanes)."""
        return int(block) in self._by_block

    # -- eviction (LRU, leaf-first) ----------------------------------------
    def _idle(self, e):
        return self._cache.refcount(e.block) == 1

    def evictable_total(self):
        """Blocks reclaimable by eviction now. A request refs its whole
        matched prefix, so an idle parent implies idle children, and the
        idle count is the transitively evictable count."""
        return sum(1 for e in self._entries.values() if self._idle(e))

    def evict_lru(self, protect=frozenset()):
        """Evict the least recently touched idle leaf; its block returns
        to the free list. Returns the block id, or None when nothing is
        evictable. `protect` names chain keys an admission in progress
        has matched but not yet claimed."""
        victim = None
        for e in self._entries.values():
            if e.key in protect:
                continue
            if e.children == 0 and self._idle(e):
                if victim is None or e.last_touch < victim.last_touch:
                    victim = e
        if victim is None:
            return None
        del self._entries[victim.key]
        del self._by_block[victim.block]
        if victim.parent is not None:
            parent = self._entries.get(victim.parent)
            if parent is not None:
                parent.children -= 1
        self._cache.unref(victim.block)
        self.counts["evictions"] += 1
        return victim.block

    def evict_for(self, need, protect=frozenset()):
        """Evict until `need` blocks are free or nothing evictable is
        left. Returns the number evicted."""
        n = 0
        while self._cache.num_free < need:
            if self.evict_lru(protect) is None:
                break
            n += 1
        return n

    def peek(self, key):
        """(block, tokens, parent_key) of an indexed key, or None; no
        refs, no recency."""
        e = self._entries.get(key)
        if e is None:
            return None
        return e.block, e.tokens, e.parent

    # -- introspection -----------------------------------------------------
    def shared_block_count(self):
        """Indexed blocks that a live request holds beside the index."""
        return sum(1 for e in self._entries.values()
                   if self._cache.refcount(e.block) >= 2)

    def __len__(self):
        return len(self._entries)

    def stats(self):
        return {
            "entries": len(self._entries),
            "evictable": self.evictable_total(),
            "shared_blocks": self.shared_block_count(),
            **dict(self.counts),
        }
