"""Cross-request prefix caching: a hash-chain index over pool blocks,
with a host tier for idle chains.

Counterpart of ``paddle_tpu/serving/prefix_cache.py``. A prompt is a
sequence of `block_size`-token chunks, each chunk's KV lives in one pool
block, and the fused step is deterministic, so two requests whose
prompts share a leading run of chunks can share the blocks.

The index is a hash chain: chunk i's key is
``H(key(i-1), tokens[i*bs:(i+1)*bs])`` (blake2b over the same bytes as
the JAX package, so both packages give the same keys for a prompt). A
chunk is matched only under the exact prefix that produced its KV. Each
entry keeps its chunk's tokens, and a lookup checks them before it
trusts the hash, so a hash collision degrades to a miss
(``ChaosInjector.hash_collision_at`` forces this path).

Lifecycle of a cached block:

- register: when a prefill completes a full prompt chunk, the scheduler
  offers (chain key, tokens, block); the index takes its own ref. The
  request keeps its ref too, and retirement unrefs instead of freeing.
- match / claim: admission probes the chain (`match`, pure: no refs, no
  recency, no counters, since a backpressured admission retries every
  iteration) and, when it proceeds, `claim`s the matched blocks.
- eviction: an indexed block whose only ref is the index's is idle.
  Under pool pressure the scheduler evicts the least recently touched
  idle leaf first (an entry with a live indexed child is never evicted).
  With a host tier (``PagedKVCache.enable_host_tier``) eviction spills
  the block's KV to the host instead of destroying it: the entry stays
  under tier "host", `match` still verifies it (as None in place of a
  block id), and `claim` swaps it back into a fresh device block, a
  re-prefill avoided. When the host pool is full its own LRU leaf is
  dropped for good (`_drop_host_lru`), never one an admission in
  progress has matched.
- copy-on-write: a request that must write into a shared block copies it
  first (`PagedKVCache.cow_copy`); the index keeps the original.

Host bookkeeping only, under the scheduler's lock. Metrics:
``serving.prefix.{hits,misses,shared_blocks,evictions,cow_copies}``.
"""

import hashlib
import itertools

import numpy as np

__all__ = ["PrefixCacheIndex", "chain_hash", "prompt_chain_keys"]

_INDEX_SEQ = itertools.count()

# sentinel chain key returned by a chaos-forced hash collision: a real
# blake2b collision is not constructible in a test, so the injector
# makes two DIFFERENT chunks hash to this value and the token-verify
# fallback does the rest
COLLISION_SENTINEL = "collision!"


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
                 "last_touch", "tier", "host_block", "host_children")

    def __init__(self, key, block, tokens, parent, touch):
        self.key = key
        self.block = block              # pool block id (index holds a ref)
        self.tokens = tokens            # np.int32 (block_size,) — verified
        self.parent = parent            # parent chain key or None
        self.children = 0               # live indexed children
        self.last_touch = touch
        # tiering (host spill pool): "device" entries hold a live pool
        # block; "host" entries hold a HostKVTier block instead (block
        # is None, the device ref was dropped at spill). host_children
        # counts the children currently spilled — an entry whose only
        # children are host-tier is still spill-eligible (the chain
        # stays walkable either way), which is what lets a whole chain
        # drain to host leaf-first instead of wedging after one leaf.
        self.tier = "device"
        self.host_block = None
        self.host_children = 0


class PrefixCacheIndex:
    """Hash-chain prefix index over one PagedKVCache. NOT thread-safe
    on its own: every call happens under the owning scheduler's lock."""

    def __init__(self, cache, chaos=None, label=None):
        self._cache = cache
        self._chaos = chaos
        self._entries = {}              # chain key -> _Entry
        self._by_block = {}             # block id -> chain key
        self._touch = 0
        # gauge series carry a per-index server label (the engine
        # passes its ledger id): two live prefix servers must not
        # clobber each other's shared_blocks reading, and drop_gauges()
        # retires the series when the server closes (the serving.mesh
        # / SLO gauge convention)
        self.labels = {"server": label if label is not None
                       else f"prefix{next(_INDEX_SEQ)}"}
        from ..observability import _help
        from ..observability.metrics import global_registry
        reg = global_registry()
        self._m_hits = reg.counter("serving.prefix.hits",
                                   _help("serving.prefix.hits"))
        self._m_misses = reg.counter("serving.prefix.misses",
                                     _help("serving.prefix.misses"))
        self._m_evictions = reg.counter("serving.prefix.evictions",
                                        _help("serving.prefix.evictions"))
        self._m_cow = reg.counter("serving.prefix.cow_copies",
                                  _help("serving.prefix.cow_copies"))
        self._g_shared = reg.gauge("serving.prefix.shared_blocks",
                                   _help("serving.prefix.shared_blocks"))
        self.counts = {"hits": 0, "misses": 0, "evictions": 0,
                       "cow_copies": 0, "collisions": 0, "spills": 0,
                       "swap_ins": 0, "reprefills_avoided": 0,
                       "host_drops": 0}

    # -- hashing -----------------------------------------------------------
    def chunk_key(self, parent_key, tokens):
        """Chain key for one chunk under its prefix. Deterministic
        content hash (blake2b over the parent key bytes + the chunk's
        int32 token bytes); the chaos injector can force the Nth
        computation to return the collision sentinel."""
        if self._chaos is not None and self._chaos.prefix_hash_collides():
            self.counts["collisions"] += 1
            return COLLISION_SENTINEL
        return chain_hash(parent_key, tokens)

    def chain_keys(self, prompt, n_chunks, have=None):
        """Chain keys for the first `n_chunks` full chunks of `prompt`,
        extending an already-computed prefix `have` (each chunk is
        hashed at most once per request — the chaos collision injector
        counts on that)."""
        bs = self._cache.block_size
        keys = list(have) if have else []
        prev = keys[-1] if keys else None
        for i in range(len(keys), n_chunks):
            prev = self.chunk_key(prev, prompt[i * bs:(i + 1) * bs])
            keys.append(prev)
        return keys

    # -- lookup (admission) ------------------------------------------------
    def match(self, prompt, keys):
        """PURE probe: walk the chain over `prompt`'s full chunks
        (using the precomputed `keys` — each request hashes its chunks
        exactly once, however many admission attempts it takes), stop
        at the first miss or token-verify failure (the collision
        fallback). No refs, no recency touches, no metric movement —
        the scheduler probes on EVERY backpressured admission retry,
        and a retry must not masquerade as cache traffic or keep
        entries artificially hot in the LRU. Returns the matched block
        list — a SPILLED (host-tier) entry matches as None in place of
        a block id (still token-verified), so len(match) is the true
        prefix depth while the
        Nones tell admission how many swap-ins `claim()` will need;
        `claim()` commits the match when admission proceeds."""
        bs = self._cache.block_size
        blocks = []
        for i in range(len(prompt) // bs):
            e = self._entries.get(keys[i])
            if e is None or not np.array_equal(
                    e.tokens, prompt[i * bs:(i + 1) * bs]):
                # absent, or present under a colliding key with other
                # tokens: both are a miss (the verify step is what
                # makes a collision harmless)
                break
            blocks.append(e.block if e.tier == "device" else None)
        return blocks

    def _materialize(self, e):
        """Swap a host-tier entry's KV back into a fresh device block
        (the adopt idiom pointed at the host pool) — the re-prefill the
        host tier exists to avoid. The caller (scheduler admission,
        materialize_key) must have budgeted a free device block; raising
        here means its evict_for math was wrong, not a recoverable
        miss."""
        nb = self._cache.allocate(1)
        if nb is None:
            raise MemoryError(
                "materializing a spilled chain entry with no free "
                "device block — admission must evict_for the swap-in "
                "count before claiming")
        db = nb[0]
        self._cache.swap_in_block(e.host_block, db)
        self._cache.host.free([e.host_block])
        e.tier = "device"
        e.host_block = None
        e.block = db
        self._by_block[db] = e.key
        if e.parent is not None:
            p = self._entries.get(e.parent)
            if p is not None:
                p.host_children -= 1
        self.counts["swap_ins"] += 1
        self.counts["reprefills_avoided"] += 1
        return db

    def claim(self, keys, blocks, probed):
        """Commit a successful admission's match: one ref per matched
        block for the admitting request, recency touches, and the
        hit/miss counters (hits = matched chunks; ONE miss if the walk
        stopped before probing all `probed` full chunks). Must run
        under the same scheduler-lock hold as the match — entries
        cannot be evicted in between. Spilled entries in the match
        (None placeholders) are materialized by swap-in here; returns
        the fully-device block list the request's table should use."""
        blocks = list(blocks)
        for i, key in enumerate(keys[:len(blocks)]):
            e = self._entries[key]
            if e.tier != "device":
                blocks[i] = self._materialize(e)
            self._cache.ref(e.block)
            self._touch += 1
            e.last_touch = self._touch
        self.counts["hits"] += len(blocks)
        if len(blocks):
            self._m_hits.inc(len(blocks))
        if len(blocks) < probed:
            self.counts["misses"] += 1
            self._m_misses.inc()
        self._publish_shared()
        return blocks

    def release(self, blocks):
        """Drop one request's refs on `blocks` (matched at admission or
        rolled back on a failed admission). Indexed blocks keep the
        index's ref and become evictable when it is the last one;
        unindexed blocks free normally."""
        for b in blocks:
            self._cache.unref(b)
        self._publish_shared()

    # -- registration (prefill completion) ---------------------------------
    def register(self, key, parent_key, tokens, block):
        """Adopt `block` as the cached KV for chunk `tokens` under
        chain key `key`. No-op (False) when the key is already indexed
        (an identical concurrent prompt registered first — the caller's
        block stays private) or when the parent entry is gone (evicted:
        the chain walk could never reach this entry). On success the
        index takes its own ref so the block outlives its author."""
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
        self._publish_shared()
        return True

    def drop_block(self, block):
        """A shared block left a request's table via copy-on-write: the
        request's ref moves to the fresh copy; the index entry stays
        (other requests / future lookups still want the original)."""
        self._cache.unref(block)
        self.counts["cow_copies"] += 1
        self._m_cow.inc()
        self._publish_shared()

    def owns_block(self, block):
        """True when `block` is indexed under a chain key. The COW
        guard routes an abandoned shared block through drop_block only
        when the index actually holds it — a fork-group lane's block
        can be shared purely between sibling lanes, and its release is
        then a plain pool unref."""
        return int(block) in self._by_block

    # -- eviction (LRU, leaf-first, spill-before-destroy) ------------------
    def _idle(self, e):
        # the index's own ref is the only one left (host-tier entries
        # hold no device ref and are never device-eviction victims)
        return (e.tier == "device"
                and self._cache.refcount(e.block) == 1)

    def evictable_total(self):
        """DEVICE blocks reclaimable by eviction right now. Idle
        parents imply idle children (a request refs its whole matched
        prefix), so the idle count IS the transitively-evictable
        count. Host-tier entries hold no device block — not counted."""
        return sum(1 for e in self._entries.values() if self._idle(e))

    def evict_lru(self, protect=frozenset()):
        """Evict the least-recently-touched idle LEAF entry; its
        device block returns to the free list. Returns the block id,
        or None when nothing is evictable. `protect` names chain keys
        that must survive — an admission in progress has MATCHED (but
        not yet claimed) those entries, and evicting them out from
        under it would invalidate the match; the rule covers the HOST
        tier too (a protected entry is neither destroyed nor dropped
        from host — spilling it is fine, the match stays valid as a
        swap-in).

        With a host tier attached, eviction SPILLS instead of
        destroying: the KV moves device->host, the entry survives
        under tier="host", and a later hit swaps it back in instead of
        re-prefilling. Leaf-first relaxes to device-leaf-first (an
        entry whose remaining children are all host-tier may spill —
        the chain stays walkable). Destruction only happens with no
        host tier, or when the host pool is full even after dropping
        its own LRU."""
        victim = None
        for e in self._entries.values():
            if e.key in protect or e.tier != "device":
                continue
            if e.children - e.host_children == 0 and self._idle(e):
                if victim is None or e.last_touch < victim.last_touch:
                    victim = e
        if victim is None:
            return None
        if getattr(self._cache, "host", None) is not None:
            hb = self._cache.spill_block(victim.block)
            if hb is None and self._drop_host_lru(protect) is not None:
                hb = self._cache.spill_block(victim.block)
            if hb is not None:
                blk = victim.block
                victim.tier = "host"
                victim.host_block = hb
                victim.block = None
                del self._by_block[blk]
                if victim.parent is not None:
                    parent = self._entries.get(victim.parent)
                    if parent is not None:
                        parent.host_children += 1
                self._cache.unref(blk)
                self.counts["evictions"] += 1
                self.counts["spills"] += 1
                self._m_evictions.inc()
                self._publish_shared()
                return blk
        if victim.children:
            # can't destroy: host-tier children would be stranded
            # unreachable (the chain walk dies at the missing parent).
            # Only hit when the host pool is exhausted AND undroppable.
            return None
        del self._entries[victim.key]
        del self._by_block[victim.block]
        if victim.parent is not None:
            parent = self._entries.get(victim.parent)
            if parent is not None:
                parent.children -= 1
        self._cache.unref(victim.block)
        self.counts["evictions"] += 1
        self._m_evictions.inc()
        self._publish_shared()
        return victim.block

    def _drop_host_lru(self, protect=frozenset()):
        """Destroy the least-recently-touched host-tier LEAF entry to
        free one host block (the host pool's own pressure valve —
        host-tier entries age out for good once even the spill pool is
        full). Respects `protect` exactly like device eviction: a
        spilled entry an admission's match() still names must survive
        until the claim lands. Returns the freed host block id or
        None."""
        victim = None
        for e in self._entries.values():
            if e.key in protect or e.tier != "host":
                continue
            if e.children == 0:
                if victim is None or e.last_touch < victim.last_touch:
                    victim = e
        if victim is None:
            return None
        del self._entries[victim.key]
        if victim.parent is not None:
            parent = self._entries.get(victim.parent)
            if parent is not None:
                parent.children -= 1
                parent.host_children -= 1
        self._cache.host.free([victim.host_block])
        self.counts["host_drops"] += 1
        return victim.host_block

    def evict_for(self, need, protect=frozenset()):
        """Evict until `need` blocks are free (or nothing evictable is
        left). Returns the number of blocks evicted."""
        n = 0
        while self._cache.num_free < need:
            if self.evict_lru(protect) is None:
                break
            n += 1
        return n

    def peek(self, key):
        """-> (block, tokens, parent_key) for an indexed chain key, or
        None. A read-only probe (no refs, no recency): it finds which
        pool block holds a chunk's KV. Call under the owning
        scheduler's lock like every other method. A host-tier entry
        peeks as None — its KV is not in the device pool, so a handoff
        walk cannot adopt from it directly; callers that can afford a
        swap-in use `materialize_key()` first."""
        e = self._entries.get(key)
        if e is None or e.tier != "device":
            return None
        return e.block, e.tokens, e.parent

    def materialize_key(self, key):
        """Swap a spilled chain entry back into the device pool (a
        re-warm lifts host-tier chains through here before adopting
        their blocks). Returns the device block id, or None when the key is absent,
        already device-tier (use peek), or no device block is free."""
        e = self._entries.get(key)
        if e is None or e.tier != "host":
            return None
        if self._cache.num_free < 1:
            return None
        return self._materialize(e)

    def host_entry_count(self):
        """Live host-tier (spilled) entries — each holds exactly one
        host block that a claim would hand back."""
        return sum(1 for e in self._entries.values()
                   if e.tier == "host")

    # -- introspection -----------------------------------------------------
    def shared_block_count(self):
        """Indexed blocks referenced by at least one live request on
        top of the index's own ref — the serving.prefix.shared_blocks
        gauge."""
        return sum(1 for e in self._entries.values()
                   if e.tier == "device"
                   and self._cache.refcount(e.block) >= 2)

    def _publish_shared(self):
        self._g_shared.labels(**self.labels).set(
            self.shared_block_count())

    def drop_gauges(self):
        """Remove this index's gauge series from the process-wide
        registry — a closed server must not keep reporting a shared-
        block footprint (idempotent; both engine close paths call it)."""
        self._g_shared.remove(**self.labels)

    def __len__(self):
        return len(self._entries)

    def stats(self):
        return {
            "entries": len(self._entries),
            "evictable": self.evictable_total(),
            "shared_blocks": self.shared_block_count(),
            "host_entries": self.host_entry_count(),
            **dict(self.counts),
        }
