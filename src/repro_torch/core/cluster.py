"""Cluster model: pods -> hosts -> chips, gang allocation, failures,
stragglers, node health + reliability.

Models a multi-pod TPU fleet (default 2 pods x 64 hosts x 4 chips = 512
chips). Gang allocation is all-or-nothing; placement prefers a single pod
(collectives stay on intra-pod ICI) and otherwise splits across as few pods
as possible. The same object backs the discrete-event simulator and the real
local executor.

Capacity queries (``free_chips`` / ``total_chips`` / ``used_chips``) are
O(1): the cluster maintains incremental per-pod free counters, a used-chips
total and a node->jobs index, updated at every mutation point (allocate /
release / fail / recover / drain), so the event-driven simulator's
scheduling instants don't rescan all nodes.  Placement is O(chips) per gang
allocation: each pod keeps *bucketed free lists* — one lazy min-heap of node
ids per free-chip count (1..chips_per_host) — so ``_take`` pops the
fullest-first / lowest-id-first node in O(log hosts) instead of sorting the
whole pod, while picking the exact same nodes the sort-based scan would
(the placement parity tests pin this).  ``abnormal_nodes`` tracks hosts
whose speed != 1.0 so the straggler sweep can skip entirely on the (common)
healthy steady state.

Reliability layer: every node carries an install age (``age_days``) and a
lifetime failure count, combined into a *hazard key* — an integer-quantized
expected failure rate per day that grows with age (wear-out, à la the Meta
reliability study's age-dependent MTBF curves) and with observed failures.
Per-pod hazard sums are maintained incrementally, giving O(1)
``pod_reliability`` / ``survival_probability`` queries, and a second set of
bucketed free lists ordered ``(-free, hazard, id)`` (built lazily on the
first reliability-aware allocation, then maintained at the same mutation
points) lets ``try_allocate(..., reliable=True)`` place gangs on the most
reliable pods/nodes in the same O(chips + log hosts) — byte-identical to a
brute-force scoring scan, and identical to the default placement whenever
the fleet has no reliability signal (all ages 0, no failures).  Node health
is a derived four-state machine (healthy / degraded / draining / repairing)
with O(1) incremental per-state counts.

Multi-resource allocator (isolation tiers): node capacity is a vector of
typed slots.  A :class:`TierConfig` carves each host's chips into three
static pools — ``exclusive`` whole chips (the gang path above, unchanged),
``mig`` chips split into 1/``MIG_SLICES`` fractional partitions, and
``shared`` chips time-sliced into ``SHARED_SLOTS`` oversubscribed slots.
Sub-chip bookkeeping is integer *quanta* (slices / slots), never floats, so
all counters stay exact.  Fractional demands are at most one chip and land
on a single chip via global best-fit: the chip with the smallest
sufficient free-quanta count, ties broken by lowest node id then chip
index (``reliable=True`` prefers low hazard before id).  Placement is
O(log chips) via per-tier bucketed free lists keyed by free-quanta count,
with the same lazy generation-stamped heap entries as the exclusive path.
The default ``TierConfig()`` reserves zero mig/shared chips, making a
tiered cluster bit-for-bit identical to the historical whole-chip one —
the load-bearing property that lets every committed trace artifact replay
byte-identically through this allocator.

Invariants (property-tested, plus ``check_counters`` in the sim tests):
  - sum of per-node allocations never exceeds node capacity,
  - unhealthy/draining nodes never receive allocations,
  - release() returns exactly what was allocated,
  - incremental counters always equal the brute-force node scan,
  - every live bucket entry sits in the bucket of its node's current free
    count, and every allocatable node has exactly one live entry,
  - health-state counts and per-pod hazard sums equal the node scan,
  - per-tier free/used/fragmentation counters and per-chip bucket entries
    equal the brute-force chip scan, and per-chip used quanta equal the
    sum of the fractional allocations living on that chip.

The port's copy of ``repro/core/cluster.py``, verbatim apart from its
imports and the ``# repolint: disable=hook-discipline`` marks on the lines
that write the bookkeeping fields this module owns (repolint names the
reference's path as their owner); ``tests/test_torch_core.py`` holds it
to the reference's decisions.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from enum import Enum
from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.schema import MIG_SLICES, SHARED_SLOTS

FRACTIONAL_TIERS = ("mig", "shared")


@dataclass(frozen=True)
class TierConfig:
    """Static per-host split of chips into isolation-tier pools.

    The default (zero mig/shared chips) is the historical whole-chip
    cluster; sub-chip granularities come from the schema layer so demand
    quantization and capacity quantization can never disagree.
    """
    mig_chips_per_host: int = 0
    shared_chips_per_host: int = 0
    mig_slices: int = MIG_SLICES        # quanta per mig chip
    shared_slots: int = SHARED_SLOTS    # quanta per shared chip (oversub)

    def quanta_per_chip(self, tier: str) -> int:
        if tier == "mig":
            return self.mig_slices
        if tier == "shared":
            return self.shared_slots
        raise ValueError(f"not a fractional tier: {tier!r}")

    def chips_per_host(self, tier: str) -> int:
        if tier == "mig":
            return self.mig_chips_per_host
        if tier == "shared":
            return self.shared_chips_per_host
        raise ValueError(f"not a fractional tier: {tier!r}")


class NodeHealth(str, Enum):
    """Derived health state of a host (precedence: repairing > draining >
    degraded > healthy)."""
    HEALTHY = "healthy"
    DEGRADED = "degraded"      # up, but running slow (speed != 1.0)
    DRAINING = "draining"      # up, being vacated; no new allocations
    REPAIRING = "repairing"    # down, waiting for repair completion


@dataclass
class Node:
    id: str
    pod: int
    chips: int = 4
    used: int = 0
    healthy: bool = True
    draining: bool = False
    speed: float = 1.0            # <1.0 = straggler
    age_days: float = 0.0         # install age at sim start
    fail_count: int = 0           # lifetime failures observed
    mig_chips: int = 0            # chips carved into MIG partitions
    shared_chips: int = 0         # chips carved into time-sliced slots
    # free quanta per fractional chip (index = chip on this host); these
    # lists always hold the *true* free counts, even while the node is down
    # — availability gating lives in the cluster's counters/buckets
    mig_free: List[int] = field(default_factory=list)
    shared_free: List[int] = field(default_factory=list)

    @property
    def exclusive_chips(self) -> int:
        return self.chips - self.mig_chips - self.shared_chips

    @property
    def avail(self) -> bool:
        return self.healthy and not self.draining

    @property
    def free(self) -> int:
        return 0 if not self.avail else self.exclusive_chips - self.used

    def tier_free_list(self, tier: str) -> List[int]:
        return self.mig_free if tier == "mig" else self.shared_free

    @property
    def health(self) -> NodeHealth:
        if not self.healthy:
            return NodeHealth.REPAIRING
        if self.draining:
            return NodeHealth.DRAINING
        if self.speed != 1.0:
            return NodeHealth.DEGRADED
        return NodeHealth.HEALTHY


# [(node_id, n_chips), ...]; n_chips is an int for exclusive gangs and an
# exact Fraction (< 1 chip) for fractional single-chip placements
Allocation = List[Tuple[str, int]]

# fractional allocation record: (tier, node_id, chip_idx, quanta)
FracAlloc = Tuple[str, str, int, int]


class Cluster:
    # reliability "belief" model: expected failures/day for a node, from its
    # install age (wear-out term, Weibull-shaped) and observed failure count.
    # A fresh node (age 0, no failures) has hazard 0, so reliability-aware
    # placement degenerates to the default order on an unsignalled fleet.
    AGE_HAZARD_PER_DAY = 1.0e-3   # hazard at age == AGE_REF_DAYS
    AGE_REF_DAYS = 365.0
    AGE_SHAPE = 1.5               # >1: wear-out (hazard grows with age)
    FAIL_HAZARD_PER_DAY = 2.0e-3  # extra hazard per observed failure
    REL_WINDOW_S = 7 * 86400.0    # horizon the reliability score integrates
    _HKEY_SCALE = 1e9             # hazard/day -> integer key quantization

    def __init__(self, n_pods: int = 2, hosts_per_pod: int = 64,
                 chips_per_host: int = 4,
                 tiers: Optional[TierConfig] = None):
        self.n_pods = n_pods
        self.hosts_per_pod = hosts_per_pod
        self.chips_per_host = chips_per_host
        self.tiers = tiers or TierConfig()
        frac_per_host = (self.tiers.mig_chips_per_host
                         + self.tiers.shared_chips_per_host)
        if frac_per_host > chips_per_host:
            raise ValueError("tier pools exceed chips_per_host")
        exc_per_host = chips_per_host - frac_per_host
        self.nodes: Dict[str, Node] = {}
        for p in range(n_pods):
            for h in range(hosts_per_pod):
                nid = f"pod{p}/host{h:03d}"
                self.nodes[nid] = Node(
                    nid, p, chips_per_host,
                    mig_chips=self.tiers.mig_chips_per_host,
                    shared_chips=self.tiers.shared_chips_per_host,
                    mig_free=[self.tiers.mig_slices] *
                    self.tiers.mig_chips_per_host,
                    shared_free=[self.tiers.shared_slots] *
                    self.tiers.shared_chips_per_host)
        self.allocations: Dict[str, Allocation] = {}
        # incremental capacity counters + reverse indices (see module doc);
        # free/used counters cover the exclusive pool only — fractional
        # tiers have their own quanta counters below
        self._free_total = n_pods * hosts_per_pod * exc_per_host  # repolint: disable=hook-discipline
        self._pod_free = [hosts_per_pod * exc_per_host] * n_pods  # repolint: disable=hook-discipline
        self._healthy_chips = n_pods * hosts_per_pod * chips_per_host  # repolint: disable=hook-discipline
        self._healthy_exc = self._free_total  # repolint: disable=hook-discipline
        self._used_total = 0  # repolint: disable=hook-discipline
        self._node_jobs: Dict[str, Set[str]] = {nid: set() for nid in self.nodes}  # repolint: disable=hook-discipline
        self.abnormal_nodes: Set[str] = set()     # speed != 1.0  # repolint: disable=hook-discipline
        # bucketed free lists: _buckets[pod][f] is a lazy min-heap of
        # (node_id, gen) for nodes with free == f; an entry is live iff its
        # gen matches _node_gen[node_id] (bumped on every free-count change)
        self._node_gen: Dict[str, int] = {nid: 0 for nid in self.nodes}  # repolint: disable=hook-discipline
        self._buckets: List[List[list]] = [  # repolint: disable=hook-discipline
            [[] for _ in range(chips_per_host + 1)] for _ in range(n_pods)]
        if exc_per_host > 0:
            for nid, node in self.nodes.items():
                heapq.heappush(self._buckets[node.pod][exc_per_host], (nid, 0))
        # fractional tiers: per-(tier, node, chip) generation stamps and one
        # *global* bucketed free list per tier — _fbuckets[tier][f] is a lazy
        # min-heap of (node_id, chip_idx, gen) over chips with free == f
        # quanta; best-fit pops the smallest sufficient bucket.  Counters:
        # _tier_free is allocatable quanta (0 while a node is down/draining),
        # _tier_used is health-independent occupancy, _frag counts partially
        # used fractional chips.
        self._frac_alloc: Dict[str, FracAlloc] = {}  # repolint: disable=hook-discipline
        self._fgen: Dict[Tuple[str, str, int], int] = {}  # repolint: disable=hook-discipline
        self._fbuckets: Dict[str, List[list]] = {}  # repolint: disable=hook-discipline
        self._rfbuckets: Optional[Dict[str, List[list]]] = None  # repolint: disable=hook-discipline
        self._tier_free: Dict[str, List[int]] = {}  # repolint: disable=hook-discipline
        self._tier_cap: Dict[str, int] = {}  # repolint: disable=hook-discipline
        self._tier_used: Dict[str, int] = {}  # repolint: disable=hook-discipline
        self._frag = 0  # repolint: disable=hook-discipline
        for tier in FRACTIONAL_TIERS:
            per_chip = self.tiers.quanta_per_chip(tier)
            n_chips = self.tiers.chips_per_host(tier)
            self._fbuckets[tier] = [[] for _ in range(per_chip + 1)]  # repolint: disable=hook-discipline
            self._tier_free[tier] = [hosts_per_pod * n_chips * per_chip] * n_pods  # repolint: disable=hook-discipline
            self._tier_cap[tier] = n_pods * hosts_per_pod * n_chips * per_chip  # repolint: disable=hook-discipline
            self._tier_used[tier] = 0  # repolint: disable=hook-discipline
            if n_chips:
                for nid in self.nodes:
                    for idx in range(n_chips):
                        heapq.heappush(self._fbuckets[tier][per_chip],
                                       (nid, idx, 0))
        # health-state counts (O(1) per transition, parity-checked)
        self._health_counts: Dict[NodeHealth, int] = {  # repolint: disable=hook-discipline
            h: 0 for h in NodeHealth}
        self._health_counts[NodeHealth.HEALTHY] = n_pods * hosts_per_pod  # repolint: disable=hook-discipline
        # integer-quantized per-node hazard keys + per-pod sums (exact
        # incremental arithmetic: no float drift vs the parity scan)
        self._node_hkey: Dict[str, int] = {nid: 0 for nid in self.nodes}  # repolint: disable=hook-discipline
        self._pod_hkey: List[int] = [0] * n_pods  # repolint: disable=hook-discipline
        # reliability-ordered free lists: entries (hkey, node_id, gen) per
        # (pod, free) bucket; None until the first reliable allocation
        self._rbuckets: Optional[List[List[list]]] = None  # repolint: disable=hook-discipline

    def _mutate(self, node: Node, fn) -> None:
        """Apply ``fn(node)`` keeping counters and bucket lists in sync."""
        free0 = node.free
        used0 = node.used
        healthy0 = node.healthy
        cap0 = node.chips if node.healthy else 0
        h0 = node.health
        avail0 = node.avail
        fn(node)
        d_free = node.free - free0
        if d_free:
            self._free_total += d_free  # repolint: disable=hook-discipline
            self._pod_free[node.pod] += d_free  # repolint: disable=hook-discipline
            gen = self._node_gen[node.id] = self._node_gen[node.id] + 1  # repolint: disable=hook-discipline
            if node.free > 0:
                heapq.heappush(self._buckets[node.pod][node.free],
                               (node.id, gen))
                if self._rbuckets is not None:
                    heapq.heappush(
                        self._rbuckets[node.pod][node.free],
                        (self._node_hkey[node.id], node.id, gen))
        self._used_total += node.used - used0  # repolint: disable=hook-discipline
        self._healthy_chips += (node.chips if node.healthy else 0) - cap0  # repolint: disable=hook-discipline
        if node.healthy != healthy0:
            # repolint: disable=hook-discipline
            self._healthy_exc += node.exclusive_chips if node.healthy \
                else -node.exclusive_chips
        h1 = node.health
        if h1 is not h0:
            self._health_counts[h0] -= 1  # repolint: disable=hook-discipline
            self._health_counts[h1] += 1  # repolint: disable=hook-discipline
        if avail0 != node.avail:
            self._frac_avail_flip(node, node.avail)

    def _frac_avail_flip(self, node: Node, now_avail: bool) -> None:
        """A node entered/left the allocatable state: move its fractional
        chips' (true) free quanta in or out of the allocatable counters and
        kill/recreate their bucket entries.  No-op on untiered clusters."""
        for tier in FRACTIONAL_TIERS:
            lst = node.tier_free_list(tier)
            if not lst:
                continue
            total = sum(lst)
            self._tier_free[tier][node.pod] += total if now_avail else -total
            for idx, f in enumerate(lst):
                key = (tier, node.id, idx)
                gen = self._fgen[key] = self._fgen.get(key, 0) + 1  # repolint: disable=hook-discipline
                if now_avail and f > 0:
                    heapq.heappush(self._fbuckets[tier][f],
                                   (node.id, idx, gen))
                    if self._rfbuckets is not None:
                        heapq.heappush(
                            self._rfbuckets[tier][f],
                            (self._node_hkey[node.id], node.id, idx, gen))

    def _frac_set(self, node: Node, tier: str, idx: int,
                  new_free: int) -> None:
        """Set a fractional chip's free quanta, keeping the tier counters,
        fragmentation count and bucket lists in sync (single bookkeeping
        path for fractional allocate + release)."""
        lst = node.tier_free_list(tier)
        old = lst[idx]
        if new_free == old:
            return
        cap = self.tiers.quanta_per_chip(tier)
        self._tier_used[tier] += old - new_free  # repolint: disable=hook-discipline
        self._frag += (0 < new_free < cap) - (0 < old < cap)  # repolint: disable=hook-discipline
        lst[idx] = new_free
        if node.avail:
            self._tier_free[tier][node.pod] += new_free - old
            key = (tier, node.id, idx)
            gen = self._fgen[key] = self._fgen.get(key, 0) + 1  # repolint: disable=hook-discipline
            if new_free > 0:
                heapq.heappush(self._fbuckets[tier][new_free],
                               (node.id, idx, gen))
                if self._rfbuckets is not None:
                    heapq.heappush(
                        self._rfbuckets[tier][new_free],
                        (self._node_hkey[node.id], node.id, idx, gen))

    # -- capacity ------------------------------------------------------------

    @property
    def total_chips(self) -> int:
        return self._healthy_chips

    def free_chips(self, pod: Optional[int] = None) -> int:
        return self._free_total if pod is None else self._pod_free[pod]

    def used_chips(self) -> int:
        return self._used_total

    def utilization(self) -> float:
        t = self.total_chips
        return self.used_chips() / t if t else 0.0

    @property
    def pod_capacity_chips(self) -> int:
        return self.hosts_per_pod * self.chips_per_host

    # -- fractional-tier capacity -------------------------------------------

    def exclusive_capacity(self) -> int:
        """Exclusive-pool chips on healthy nodes (== total_chips untiered)."""
        return self._healthy_exc

    def free_slots(self, tier: str, pod: Optional[int] = None) -> int:
        """Allocatable free quanta in a fractional tier (O(1))."""
        return sum(self._tier_free[tier]) if pod is None \
            else self._tier_free[tier][pod]

    def tier_capacity(self, tier: str) -> int:
        """Physical quanta capacity of a fractional tier (fleet-wide)."""
        return self._tier_cap[tier]

    def tier_occupancy(self, tier: str) -> float:
        """Used / physical quanta for a tier in [0, 1] (health-independent,
        so a down node's residents still count as occupying)."""
        cap = self._tier_cap[tier]
        return self._tier_used[tier] / cap if cap else 0.0

    def shared_occupancy(self) -> float:
        return self.tier_occupancy("shared")

    def frag_chips(self) -> int:
        """Fractional chips that are partially used (0 < used < capacity) —
        the stranded-capacity signal the bench reports."""
        return self._frag

    # -- reliability ---------------------------------------------------------

    def _hazard_per_day(self, node: Node) -> float:
        """Expected failures/day the scheduler believes this node has."""
        h = self.FAIL_HAZARD_PER_DAY * node.fail_count
        if node.age_days > 0:
            h += self.AGE_HAZARD_PER_DAY * \
                (node.age_days / self.AGE_REF_DAYS) ** self.AGE_SHAPE
        return h

    def node_hazard_key(self, node_id: str) -> int:
        """Integer-quantized hazard (placement sort key; lower = better)."""
        return self._node_hkey[node_id]

    def hazard_per_day(self, node_id: str) -> float:
        """Believed expected failures/day (float view of the hazard key —
        what predictive draining compares against its knee)."""
        return self._node_hkey[node_id] / self._HKEY_SCALE

    def pod_hazard_key(self, pod: int) -> int:
        return self._pod_hkey[pod]

    def _refresh_hazard(self, node: Node) -> None:
        """Re-derive the node's hazard key after an age/fail-count change,
        keeping the pod sum exact and re-bucketing the node so any
        reliability-ordered entry carrying the stale key dies."""
        new = round(self._hazard_per_day(node) * self._HKEY_SCALE)
        old = self._node_hkey[node.id]
        if new == old:
            return
        self._node_hkey[node.id] = new  # repolint: disable=hook-discipline
        self._pod_hkey[node.pod] += new - old  # repolint: disable=hook-discipline
        if node.free > 0:
            gen = self._node_gen[node.id] = self._node_gen[node.id] + 1  # repolint: disable=hook-discipline
            heapq.heappush(self._buckets[node.pod][node.free],
                           (node.id, gen))
            if self._rbuckets is not None:
                heapq.heappush(self._rbuckets[node.pod][node.free],
                               (new, node.id, gen))
        if self._rfbuckets is not None and node.avail:
            # reliability-ordered fractional entries carry the stale hazard
            # key: re-stamp this node's free chips in both orders
            for tier in FRACTIONAL_TIERS:
                for idx, f in enumerate(node.tier_free_list(tier)):
                    if f <= 0:
                        continue
                    key = (tier, node.id, idx)
                    g = self._fgen[key] = self._fgen.get(key, 0) + 1  # repolint: disable=hook-discipline
                    heapq.heappush(self._fbuckets[tier][f],
                                   (node.id, idx, g))
                    heapq.heappush(self._rfbuckets[tier][f],
                                   (new, node.id, idx, g))

    def set_node_age(self, node_id: str, age_days: float) -> None:
        node = self.nodes[node_id]
        node.age_days = age_days
        self._refresh_hazard(node)

    def node_reliability(self, node_id: str) -> float:
        """P(node survives REL_WINDOW_S) under its believed hazard, in
        (0, 1]; 1.0 for a fresh node."""
        hz = self._node_hkey[node_id] / self._HKEY_SCALE
        return math.exp(-hz * self.REL_WINDOW_S / 86400.0)

    def pod_reliability(self, pod: int) -> float:
        """Mean-host survival over REL_WINDOW_S for a pod (incremental)."""
        avg = self._pod_hkey[pod] / self._HKEY_SCALE / self.hosts_per_pod
        return math.exp(-avg * self.REL_WINDOW_S / 86400.0)

    def survival_probability(self, duration_s: float, chips: int = 1) -> float:
        """P(no participating host fails over ``duration_s``) for a gang of
        ``chips`` placed on the most reliable pod (mean-host hazard)."""
        if duration_s <= 0:
            return 1.0
        hosts = max(1, -(-chips // self.chips_per_host))
        avg = min(self._pod_hkey) / self._HKEY_SCALE / self.hosts_per_pod
        return math.exp(-avg * hosts * duration_s / 86400.0)

    def _ensure_rbuckets(self) -> None:
        if self._rbuckets is not None:
            return
        self._rbuckets = [  # repolint: disable=hook-discipline
            [[] for _ in range(self.chips_per_host + 1)]
            for _ in range(self.n_pods)]
        for nid, node in self.nodes.items():
            if node.free > 0:
                heapq.heappush(
                    self._rbuckets[node.pod][node.free],
                    (self._node_hkey[nid], nid, self._node_gen[nid]))

    def _ensure_rfbuckets(self) -> None:
        if self._rfbuckets is not None:
            return
        self._rfbuckets = {  # repolint: disable=hook-discipline
            tier: [[] for _ in range(self.tiers.quanta_per_chip(tier) + 1)]
            for tier in FRACTIONAL_TIERS}
        for nid, node in self.nodes.items():
            if not node.avail:
                continue
            for tier in FRACTIONAL_TIERS:
                for idx, f in enumerate(node.tier_free_list(tier)):
                    if f > 0:
                        heapq.heappush(
                            self._rfbuckets[tier][f],
                            (self._node_hkey[nid], nid, idx,
                             self._fgen.get((tier, nid, idx), 0)))

    def check_counters(self) -> None:
        """Assert the incremental counters match a brute-force node scan."""
        assert self._free_total == sum(n.free for n in self.nodes.values())
        for p in range(self.n_pods):
            assert self._pod_free[p] == sum(
                n.free for n in self.nodes.values() if n.pod == p)
        assert self._healthy_chips == sum(
            n.chips for n in self.nodes.values() if n.healthy)
        assert self._used_total == sum(n.used for n in self.nodes.values())
        assert self.abnormal_nodes == {
            nid for nid, n in self.nodes.items() if n.speed != 1.0}
        # health-state counts: incremental per-state totals == node scan
        scan_health = {h: 0 for h in NodeHealth}
        for n in self.nodes.values():
            scan_health[n.health] += 1
        assert self._health_counts == scan_health, \
            (self._health_counts, scan_health)
        # hazard keys: per-node derivation and per-pod sums are exact
        for nid, n in self.nodes.items():
            assert self._node_hkey[nid] == round(
                self._hazard_per_day(n) * self._HKEY_SCALE), nid
        for p in range(self.n_pods):
            assert self._pod_hkey[p] == sum(
                self._node_hkey[nid] for nid, n in self.nodes.items()
                if n.pod == p), p
        # bucket lists: live entries of every (pod, free-count) bucket equal
        # the brute-force scan (a live entry was pushed at its node's latest
        # free change, so gen match implies the bucket is the right one)
        for p in range(self.n_pods):
            for f in range(1, self.chips_per_host + 1):
                live = {nid for nid, gen in self._buckets[p][f]
                        if gen == self._node_gen[nid]}
                scan = {nid for nid, n in self.nodes.items()
                        if n.pod == p and n.free == f}
                assert live == scan, (p, f, live, scan)
                if self._rbuckets is not None:
                    rlive = {(hk, nid) for hk, nid, gen in self._rbuckets[p][f]
                             if gen == self._node_gen[nid]}
                    rscan = {(self._node_hkey[nid], nid) for nid in scan}
                    assert rlive == rscan, (p, f, rlive, rscan)
        # fractional tiers: counters, fragmentation, per-chip used quanta and
        # bucket entries all equal the brute-force chip scan
        assert self._healthy_exc == sum(
            n.exclusive_chips for n in self.nodes.values() if n.healthy)
        frac_used: Dict[Tuple[str, str, int], int] = {}
        for jid, (tier, nid, idx, q) in self._frac_alloc.items():
            frac_used[(tier, nid, idx)] = frac_used.get((tier, nid, idx), 0) + q
            assert jid in self._node_jobs[nid], jid
        scan_frag = 0
        for tier in FRACTIONAL_TIERS:
            cap = self.tiers.quanta_per_chip(tier)
            for p in range(self.n_pods):
                assert self._tier_free[tier][p] == sum(
                    sum(n.tier_free_list(tier))
                    for n in self.nodes.values()
                    if n.pod == p and n.avail), (tier, p)
            assert self._tier_used[tier] == sum(
                cap - f for n in self.nodes.values()
                for f in n.tier_free_list(tier)), tier
            for nid, n in self.nodes.items():
                for idx, f in enumerate(n.tier_free_list(tier)):
                    assert 0 <= f <= cap, (tier, nid, idx, f)
                    assert cap - f == frac_used.get((tier, nid, idx), 0), \
                        (tier, nid, idx)
                    scan_frag += 0 < f < cap
            for f in range(1, cap + 1):
                flive = {(nid, idx) for nid, idx, gen in self._fbuckets[tier][f]
                         if gen == self._fgen.get((tier, nid, idx), 0)}
                fscan = {(nid, idx) for nid, n in self.nodes.items()
                         if n.avail
                         for idx, ff in enumerate(n.tier_free_list(tier))
                         if ff == f}
                assert flive == fscan, (tier, f, flive, fscan)
                if self._rfbuckets is not None:
                    rflive = {(hk, nid, idx)
                              for hk, nid, idx, gen in self._rfbuckets[tier][f]
                              if gen == self._fgen.get((tier, nid, idx), 0)}
                    rfscan = {(self._node_hkey[nid], nid, idx)
                              for nid, idx in fscan}
                    assert rflive == rfscan, (tier, f, rflive, rfscan)
        assert self._frag == scan_frag, (self._frag, scan_frag)

    # -- allocation ----------------------------------------------------------

    def try_allocate(self, job_id: str, chips: int,
                     prefer_single_pod: bool = True,
                     reliable: bool = False) -> Optional[Allocation]:
        """Gang (all-or-nothing) allocation. Returns None if it doesn't fit.

        ``reliable=True`` selects the failure-aware placement order: pods by
        ascending hazard (then fullest-first), nodes by ``(-free, hazard,
        id)`` — identical to the default order when the fleet carries no
        reliability signal.
        """
        if job_id in self.allocations or job_id in self._frac_alloc:
            raise ValueError(f"{job_id} already allocated")
        if chips > self.free_chips():
            return None
        if reliable:
            self._ensure_rbuckets()
            pods = sorted(range(self.n_pods),
                          key=lambda p: (self._pod_hkey[p],
                                         -self.free_chips(p), p))
        else:
            pods = sorted(range(self.n_pods),
                          key=lambda p: -self.free_chips(p))
        # single-pod placement if any pod fits
        if prefer_single_pod:
            for p in pods:
                if self.free_chips(p) >= chips:
                    alloc = self._take(chips, [p], reliable)
                    self._register(job_id, alloc)
                    return alloc
        alloc = self._take(chips, pods, reliable)
        if alloc is None:
            return None
        self._register(job_id, alloc)
        return alloc

    def _register(self, job_id: str, alloc: Allocation) -> None:
        self.allocations[job_id] = alloc
        for nid, _ in alloc:
            self._node_jobs[nid].add(job_id)

    def _take(self, chips: int, pods: List[int],
              reliable: bool = False) -> Optional[Allocation]:
        """Gang-pick ``chips`` from ``pods``: fullest nodes first, lowest id
        breaking ties — the same order a (-free, id) sort of every node would
        yield, at O(chips + log hosts) via the bucketed free lists.  With
        ``reliable`` the reliability-ordered buckets break free-count ties by
        ascending hazard key before id ((-free, hkey, id) scan order)."""
        buckets = self._rbuckets if reliable else self._buckets
        picked: Allocation = []
        popped: List[Tuple[int, int, tuple]] = []
        need = chips
        for p in pods:
            if need == 0:
                break
            for f in range(self.chips_per_host, 0, -1):
                if need == 0:
                    break
                heap = buckets[p][f]
                while need > 0 and heap:
                    entry = heapq.heappop(heap)
                    nid, gen = (entry[1], entry[2]) if reliable else entry
                    if gen != self._node_gen[nid]:
                        continue          # stale: drop it for good
                    popped.append((p, f, entry))
                    take = min(f, need)
                    picked.append((nid, take))
                    need -= take
        if need > 0:
            # gang doesn't fit: restore the live entries we popped
            for p, f, entry in popped:
                heapq.heappush(buckets[p][f], entry)
            return None
        for nid, k in picked:
            # re-buckets the node (gen bump), so the popped entry is stale
            self._mutate(self.nodes[nid], lambda n, k=k: setattr(  # repolint: disable=hook-discipline
                n, "used", n.used + k))
        return picked

    def try_allocate_fractional(self, job_id: str, tier: str, quanta: int,
                                reliable: bool = False
                                ) -> Optional[Allocation]:
        """Place a sub-chip demand of ``quanta`` tier-slots on one chip.

        Global best-fit: the chip with the smallest free-quanta count that
        still fits, ties broken by lowest node id then chip index —
        identical to a brute-force ``(free, id, idx)`` scan of every tier
        chip.  ``reliable=True`` breaks free-count ties by ascending hazard
        key first (``(free, hazard, id, idx)`` scan order).  Returns the
        allocation as ``[(node_id, Fraction(quanta, quanta_per_chip))]`` or
        None if no chip fits.
        """
        if job_id in self.allocations or job_id in self._frac_alloc:
            raise ValueError(f"{job_id} already allocated")
        if tier not in FRACTIONAL_TIERS:
            raise ValueError(f"not a fractional tier: {tier!r}")
        per_chip = self.tiers.quanta_per_chip(tier)
        if not 1 <= quanta <= per_chip:
            raise ValueError(f"quanta {quanta} out of range for {tier}")
        if reliable:
            self._ensure_rfbuckets()
            buckets = self._rfbuckets[tier]
        else:
            buckets = self._fbuckets[tier]
        for f in range(quanta, per_chip + 1):
            heap = buckets[f]
            while heap:
                entry = heapq.heappop(heap)
                nid, idx, gen = entry[1:] if reliable else entry
                if gen != self._fgen.get((tier, nid, idx), 0):
                    continue              # stale: drop it for good
                # live entries only exist for allocatable nodes, so no
                # health check is needed; _frac_set re-buckets the chip
                # (gen bump), which also kills this entry's twin in the
                # other-ordered bucket list
                node = self.nodes[nid]
                self._frac_set(node, tier, idx, f - quanta)
                self._frac_alloc[job_id] = (tier, nid, idx, quanta)  # repolint: disable=hook-discipline
                self._node_jobs[nid].add(job_id)
                chips = Fraction(quanta, per_chip)
                return [(nid, int(chips) if chips.denominator == 1
                         else chips)]
        return None

    def frac_allocation(self, job_id: str) -> Optional[FracAlloc]:
        """The (tier, node, chip_idx, quanta) record of a fractional job."""
        return self._frac_alloc.get(job_id)

    def release(self, job_id: str) -> None:
        fr = self._frac_alloc.pop(job_id, None)  # repolint: disable=hook-discipline
        if fr is not None:
            tier, nid, idx, q = fr
            node = self.nodes[nid]
            self._frac_set(node, tier, idx,
                           node.tier_free_list(tier)[idx] + q)
            self._node_jobs[nid].discard(job_id)
            return
        for nid, k in self.allocations.pop(job_id, []):
            self._mutate(self.nodes[nid], lambda n, k=k: setattr(  # repolint: disable=hook-discipline
                n, "used", max(0, n.used - k)))
            self._node_jobs[nid].discard(job_id)

    # -- topology ------------------------------------------------------------

    def job_pods(self, job_id: str) -> List[int]:
        return sorted({self.nodes[nid].pod for nid in self.job_nodes(job_id)})

    def crosses_pods(self, job_id: str) -> bool:
        return len(self.job_pods(job_id)) > 1

    def job_speed(self, job_id: str) -> float:
        """Synchronous training runs at the slowest participant's speed."""
        nodes = self.job_nodes(job_id)
        if not nodes:
            return 0.0
        return min(self.nodes[nid].speed for nid in nodes)

    def job_nodes(self, job_id: str) -> List[str]:
        fr = self._frac_alloc.get(job_id)
        if fr is not None:
            return [fr[1]]
        return [nid for nid, _ in self.allocations.get(job_id, [])]

    def jobs_on_node(self, node_id: str) -> List[str]:
        """Job ids with at least one chip allocated on ``node_id``."""
        return sorted(self._node_jobs[node_id])

    # -- failures / stragglers ------------------------------------------------

    def fail_node(self, node_id: str) -> List[str]:
        """Marks a node dead (health -> repairing) and records the failure
        in its reliability history. Returns job ids that were running on it."""
        node = self.nodes[node_id]

        def fn(n):
            n.healthy = False  # repolint: disable=hook-discipline
            n.fail_count += 1  # repolint: disable=hook-discipline
        self._mutate(node, fn)
        self._refresh_hazard(node)
        return self.jobs_on_node(node_id)

    def recover_node(self, node_id: str) -> None:
        # recompute `used` from live allocations rather than zeroing it:
        # with overlapping failure windows (scale traces) a stale second
        # recovery can land after the node was recovered and re-allocated,
        # and wiping `used` would double-book those chips
        live = sum(k for jid in self._node_jobs[node_id]
                   for nid, k in self.allocations.get(jid, [])
                   if nid == node_id)

        def fn(n):
            n.healthy = True  # repolint: disable=hook-discipline
            n.used = live  # repolint: disable=hook-discipline
            n.speed = 1.0  # repolint: disable=hook-discipline
            n.draining = False  # repolint: disable=hook-discipline
        self._mutate(self.nodes[node_id], fn)
        self.abnormal_nodes.discard(node_id)  # repolint: disable=hook-discipline

    def begin_maintenance(self, node_id: str) -> List[str]:
        """Takes a node down for *planned* maintenance (health -> repairing)
        without recording a failure: unlike ``fail_node``, a proactive drain
        is not a reliability event — the hazard belief triggered it, so
        bumping ``fail_count`` would double-count the wear the belief already
        prices in. Returns job ids still allocated on the node (a caller
        that vacated the gangs first gets [])."""
        self._mutate(self.nodes[node_id],
                     lambda n: setattr(n, "healthy", False))  # repolint: disable=hook-discipline
        return self.jobs_on_node(node_id)

    def renew_node(self, node_id: str) -> None:
        """Planned-maintenance completion: the worn part was replaced, so
        the node comes back *as new* — age and failure history reset, hazard
        key re-derived to zero (vs ``recover_node``, which returns a node to
        service with its reliability history intact)."""
        live = sum(k for jid in self._node_jobs[node_id]
                   for nid, k in self.allocations.get(jid, [])
                   if nid == node_id)
        node = self.nodes[node_id]

        def fn(n):
            n.healthy = True  # repolint: disable=hook-discipline
            n.used = live  # repolint: disable=hook-discipline
            n.speed = 1.0  # repolint: disable=hook-discipline
            n.draining = False  # repolint: disable=hook-discipline
            n.age_days = 0.0
            n.fail_count = 0  # repolint: disable=hook-discipline
        self._mutate(node, fn)
        self.abnormal_nodes.discard(node_id)  # repolint: disable=hook-discipline
        self._refresh_hazard(node)

    def set_speed(self, node_id: str, speed: float) -> None:
        # speed never changes free/used, so _mutate only does the (cheap)
        # health-count transition — one bookkeeping path for every mutation
        self._mutate(self.nodes[node_id],
                     lambda n: setattr(n, "speed", speed))  # repolint: disable=hook-discipline
        if speed == 1.0:
            self.abnormal_nodes.discard(node_id)  # repolint: disable=hook-discipline
        else:
            self.abnormal_nodes.add(node_id)  # repolint: disable=hook-discipline

    def drain(self, node_id: str, on: bool = True) -> None:
        self._mutate(self.nodes[node_id], lambda n: setattr(n, "draining", on))  # repolint: disable=hook-discipline

    def straggler_nodes(self, job_id: str, threshold: float = 0.75
                        ) -> List[str]:
        nodes = self.job_nodes(job_id)
        if not nodes:
            return []
        speeds = sorted(self.nodes[n].speed for n in nodes)
        mid = len(speeds) // 2
        # true median: interpolate the two middle elements on even lengths
        # (the old upper-element pick inflated the median whenever exactly
        # half a gang was slow, over-flagging stragglers)
        median = speeds[mid] if len(speeds) % 2 \
            else 0.5 * (speeds[mid - 1] + speeds[mid])
        return [n for n in nodes
                if self.nodes[n].speed < threshold * median]
