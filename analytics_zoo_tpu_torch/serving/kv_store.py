"""Tiered KV memory: a bounded host-RAM store for evicted prefix
chains (:class:`HostKVStore`) and a fleet-wide index of which replica
holds which chain hash (:class:`PrefixDirectory`).

A copy of ``analytics_zoo_tpu/serving/kv_store.py`` (stdlib only).  The
server builds a ``PrefixDirectory`` when its config asks for one, and
``serving.continuous.ContinuousEngine(kv_host_store_bytes=...)`` spills
to and readmits from a ``HostKVStore``; under a tensor-parallel mesh
each rank's store holds that rank's kv-head shard of a block and counts
the whole block's bytes, so every rank evicts where one rank would.
"""

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HostKVStore",
    "PrefixDirectory",
    "TIER_HBM",
    "TIER_HOST",
]

# Directory tier labels.  TIER_HBM entries are device-resident
# (published in a pool's hash index); TIER_HOST entries live in a
# replica's HostKVStore.
TIER_HBM = "hbm"
TIER_HOST = "host"


class HostKVStore:
    """Bounded host-RAM second tier for evicted KV blocks.

    Entries are keyed by *chain hash* — one full block of KV per hash.
    Because chain hashes are position-aligned and encode the full
    token history up to their block (paged_cache.chain_hashes), a run
    of per-hash entries composes back into a chain at probe time: the
    store never needs to remember which chain a block came from.

    The payload is opaque to the store (the engine passes host
    numpy trees; int8 ``QuantKV`` blocks spill quantized with their
    scales alongside) and the caller supplies its byte size, keeping
    this module numpy-free.  Capacity is enforced in bytes with LRU
    eviction *within the store*; ``put`` of an oversized entry is
    rejected rather than flushing the whole tier.

    Re-admission never removes an entry: ``adopt_chain`` back into a
    pool can still fail after a successful probe (dry pool), and the
    rollback contract requires the store copy to survive.  Entries
    leave only under capacity pressure (or ``pop``/``clear``).
    """

    def __init__(self, capacity_bytes: int,
                 evict_cb: Optional[Callable[[int], None]] = None):
        if capacity_bytes <= 0:
            raise ValueError(
                "HostKVStore capacity_bytes must be > 0 "
                "(got %r); use no store at all to disable the tier"
                % (capacity_bytes,))
        self.capacity_bytes = int(capacity_bytes)
        # hash -> (payload, nbytes); insertion order = LRU order with
        # move_to_end on every touch.
        self._entries: "OrderedDict[int, Tuple[Any, int]]" = OrderedDict()
        self._lock = threading.Lock()
        # fires for every entry dropped under capacity pressure (or
        # pop) so the owner can retract the host-tier directory claim
        self.evict_cb = evict_cb
        # counters (scraped via the engine's gauges)
        self.spilled_chains = 0
        self.spilled_bytes = 0
        self.store_evictions = 0
        self.probes = 0
        self.probe_hits = 0
        self.occupancy_bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, hash_: int) -> bool:
        with self._lock:
            return hash_ in self._entries

    def put(self, hash_: int, payload: Any, nbytes: int) -> bool:
        """Offer one block to the store.  Returns True when accepted.

        An already-present hash refreshes recency and is counted as
        accepted (the device copy and the store copy are snapshots of
        the same immutable published block).  Entries larger than the
        whole store are rejected without disturbing residents.
        """
        nbytes = int(nbytes)
        evicted: List[int] = []
        with self._lock:
            if hash_ in self._entries:
                self._entries.move_to_end(hash_)
                return True
            if nbytes > self.capacity_bytes:
                return False
            while (self.occupancy_bytes + nbytes > self.capacity_bytes
                   and self._entries):
                old_h, (_, old_n) = self._entries.popitem(last=False)
                self.occupancy_bytes -= old_n
                self.store_evictions += 1
                evicted.append(old_h)
            self._entries[hash_] = (payload, nbytes)
            self.occupancy_bytes += nbytes
            self.spilled_chains += 1
            self.spilled_bytes += nbytes
        if self.evict_cb is not None:
            for h in evicted:
                self.evict_cb(h)
        return True

    def probe(self, hashes: Sequence[int]) -> List[Tuple[int, Any]]:
        """Longest leading run of ``hashes`` present in the store.

        Returns ``[(hash, payload), ...]`` for the run (possibly
        empty) and bumps each hit's recency.  Only a *leading* run is
        useful to admission: a chain must extend an unbroken prefix.
        """
        out: List[Tuple[int, Any]] = []
        with self._lock:
            self.probes += 1
            for h in hashes:
                ent = self._entries.get(h)
                if ent is None:
                    break
                self._entries.move_to_end(h)
                out.append((h, ent[0]))
            if out:
                self.probe_hits += 1
        return out

    def pop(self, hash_: int) -> Optional[Any]:
        """Remove and return one entry (None when absent)."""
        with self._lock:
            ent = self._entries.pop(hash_, None)
            if ent is None:
                return None
            self.occupancy_bytes -= ent[1]
        if self.evict_cb is not None:
            self.evict_cb(hash_)
        return ent[0]

    def clear(self) -> None:
        with self._lock:
            hashes = list(self._entries)
            self._entries.clear()
            self.occupancy_bytes = 0
        if self.evict_cb is not None:
            for h in hashes:
                self.evict_cb(h)

    def metrics(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity_bytes": self.capacity_bytes,
                "occupancy_bytes": self.occupancy_bytes,
                "entries": len(self._entries),
                "spilled_chains": self.spilled_chains,
                "spilled_bytes": self.spilled_bytes,
                "store_evictions": self.store_evictions,
                "probes": self.probes,
                "probe_hits": self.probe_hits,
            }


class PrefixDirectory:
    """Fleet-wide prefix index: chain hash -> {replica_id: tier}.

    Every replica publishes its device-index contents (TIER_HBM) and
    its host-store contents (TIER_HOST) here as they change — pool
    publish/evict hooks and store put/evict callbacks are the only
    writers.  The router reads it per request through
    :meth:`match_depths` to fill ``ReplicaSignals.prefix_blocks``, the
    prefix-locality rank term in ``route_request``.

    The directory is advisory: a stale entry costs one wasted probe on
    the chosen replica, never correctness (admission re-checks the
    pool index and the store under their own locks).
    """

    def __init__(self) -> None:
        self._by_hash: Dict[int, Dict[int, str]] = {}
        self._lock = threading.Lock()
        self.publishes = 0
        self.unpublishes = 0

    def publish(self, replica: int, hash_: int, tier: str) -> None:
        if tier not in (TIER_HBM, TIER_HOST):
            raise ValueError("unknown tier %r" % (tier,))
        with self._lock:
            self._by_hash.setdefault(hash_, {})[int(replica)] = tier
            self.publishes += 1

    def unpublish(self, replica: int, hash_: int,
                  tier: Optional[str] = None) -> None:
        """Retract a claim.  ``tier=None`` drops the replica's claim
        regardless of tier; a tier-qualified unpublish is a no-op when
        the replica's current claim is for the *other* tier (an HBM
        eviction must not retract a host-store claim published a
        moment earlier)."""
        with self._lock:
            claims = self._by_hash.get(hash_)
            if claims is None:
                return
            cur = claims.get(int(replica))
            if cur is None or (tier is not None and cur != tier):
                return
            del claims[int(replica)]
            if not claims:
                del self._by_hash[hash_]
            self.unpublishes += 1

    def lookup(self, hash_: int) -> Dict[int, str]:
        with self._lock:
            return dict(self._by_hash.get(hash_, ()))

    def match_depths(self, hashes: Sequence[int]) -> Dict[int, int]:
        """Longest leading run held per replica, any tier.

        Returns ``{replica_id: depth_in_blocks}`` for every replica
        holding at least the first hash.  Depth is the router's
        estimated reuse: blocks the replica can serve from HBM or
        host store instead of re-prefilling.
        """
        depths: Dict[int, int] = {}
        with self._lock:
            live: Optional[set] = None
            for i, h in enumerate(hashes):
                claims = self._by_hash.get(h)
                holders = set(claims) if claims else set()
                live = holders if live is None else (live & holders)
                if not live:
                    break
                for r in live:
                    depths[r] = i + 1
        return depths

    def metrics(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hashes": len(self._by_hash),
                "publishes": self.publishes,
                "unpublishes": self.unpublishes,
            }
