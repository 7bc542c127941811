"""Multi-tier edge aggregation trees over :class:`repro.edge.Fleet` profiles.

A :class:`Topology` is a rooted tree: tier 0 holds the fleet's devices (one
leaf per :class:`~repro.edge.profiles.DeviceProfile`), interior tiers hold
aggregation points (gateways, regional servers), and the root is the cloud.
Every non-root node owns the :class:`Link` to its parent — per-link bandwidth
and latency are what make multi-hop timing and byte accounting (``comm.py``)
meaningful.  Leaf→gateway traffic keeps using the *device profile's* own
up/down bandwidth (that link already exists in ``repro.edge``); ``Link``
models the backhaul tiers above it.

Canonical topologies (cf. Gao et al., FL-as-a-Service for hierarchical edge
networks; Wang et al., resource-constrained edge control):

  * :func:`star_topology`          — every device reports straight to the
    cloud: depth 1, the flat baseline every hierarchy is compared against.
  * :func:`two_tier_topology`      — device → gateway → cloud with a fixed
    gateway count; the canonical "bimodal" instance pairs it with
    :func:`~repro.edge.profiles.bimodal_fleet` (phones behind gateways).
  * :func:`geo_partitioned_topology` — device → gateway → regional → cloud;
    devices are assigned *contiguously*, so with a Dirichlet-partitioned
    dataset each region sees a correlated (non-IID) label slice — the
    geo-skew regime hierarchical aggregation has to survive.

This module is a copy of ``repro.hier.topology`` (numpy and the port's own
modules only), kept so the port never imports the JAX package; its
output is bit-identical (``tests/test_torch_edge.py``,
``tests/test_torch_hier.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..edge.profiles import Fleet, bimodal_fleet, uniform_fleet

# Backhaul reference magnitudes: a metro gateway uplink sustains ~100 Mbit/s,
# a regional→cloud trunk ~1 Gbit/s; WAN hops add milliseconds of latency.
GATEWAY_BW = 1.25e7
TRUNK_BW = 1.25e8


@dataclass(frozen=True)
class Link:
    """A backhaul link (child → parent): bytes/s each way plus fixed latency."""
    up_bw: float                 # bytes/s toward the parent
    down_bw: float               # bytes/s toward the child
    latency: float = 0.0         # seconds, charged per transfer

    def __post_init__(self):
        if self.up_bw <= 0 or self.down_bw <= 0:
            raise ValueError(f"link bandwidth must be positive, got "
                             f"up={self.up_bw} down={self.down_bw}")

    def uplink_time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.up_bw

    def downlink_time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.down_bw


@dataclass(frozen=True)
class TopoNode:
    """One tree node.  Devices occupy node ids ``[0, fleet.num_devices)`` and
    tier 0; interior/root nodes get ids above the fleet."""
    node_id: int
    tier: int
    parent: Optional[int]                # None only for the cloud root
    children: Tuple[int, ...]            # empty only for device leaves
    uplink: Optional[Link] = None        # link to parent (None for root and
                                         # for devices, whose profile is the link)


@dataclass(frozen=True)
class Topology:
    name: str
    fleet: Fleet
    nodes: Dict[int, TopoNode]
    cloud_id: int

    def __post_init__(self):
        n = self.fleet.num_devices
        cloud = self.nodes[self.cloud_id]
        if cloud.parent is not None:
            raise ValueError("cloud node must be the root (parent=None)")
        for i in range(n):
            node = self.nodes.get(i)
            if node is None or node.tier != 0 or node.children:
                raise ValueError(f"device {i} must be a tier-0 leaf")
            # every device must reach the cloud through consistent tiers
            seen, cur = 0, node
            while cur.parent is not None:
                parent = self.nodes.get(cur.parent)
                if parent is None:
                    raise ValueError(f"node {cur.node_id} has dangling parent "
                                     f"{cur.parent}")
                if parent.tier != cur.tier + 1:
                    raise ValueError(
                        f"tier skip on edge {cur.node_id}->{parent.node_id}: "
                        f"{cur.tier}->{parent.tier}")
                if cur.node_id not in parent.children:
                    raise ValueError(f"{parent.node_id} does not list child "
                                     f"{cur.node_id}")
                cur, seen = parent, seen + 1
                if seen > len(self.nodes):
                    raise ValueError("cycle in topology")
            if cur.node_id != self.cloud_id:
                raise ValueError(f"device {i} does not reach the cloud")
        for node in self.nodes.values():
            if node.node_id != self.cloud_id and node.tier > 0 \
                    and node.uplink is None:
                raise ValueError(f"interior node {node.node_id} needs an uplink")

    # -- structure helpers --------------------------------------------------
    @property
    def depth(self) -> int:
        """Number of aggregation hops from a device to the cloud."""
        return self.nodes[self.cloud_id].tier

    @property
    def num_devices(self) -> int:
        return self.fleet.num_devices

    def tier_nodes(self, tier: int) -> List[TopoNode]:
        return sorted((n for n in self.nodes.values() if n.tier == tier),
                      key=lambda n: n.node_id)

    @property
    def gateways(self) -> List[TopoNode]:
        """The tier-1 aggregation points (parents of the device leaves).
        For a star topology this is just ``[cloud]``."""
        return self.tier_nodes(1)

    def devices_under(self, node_id: int) -> List[int]:
        """All device ids in the subtree of ``node_id`` (sorted)."""
        node = self.nodes[node_id]
        if node.tier == 0:
            return [node.node_id]
        out: List[int] = []
        for ch in node.children:
            out.extend(self.devices_under(ch))
        return sorted(out)

    def describe(self) -> str:
        tiers = [len(self.tier_nodes(t)) for t in range(self.depth + 1)]
        return (f"{self.name}: depth={self.depth} "
                f"tier_sizes={'x'.join(str(t) for t in tiers)} "
                f"({self.fleet.describe()})")


@dataclass(frozen=True, eq=False)
class StackedTopology:
    """Array-native topology for fleet-scale runs: only interior nodes and
    the cloud exist as :class:`TopoNode` objects; device membership lives in
    a numpy id array on each gateway's ``children`` field.  A million-device
    tree is O(gateways) objects and O(1) validation per gateway instead of
    one frozen dataclass + an O(depth) path walk per device (the
    :class:`Topology` ``__post_init__``), which at 10⁶ devices costs seconds
    and ~0.5 GB before the first round starts.

    Duck-compatible with :class:`Topology` everywhere the hierarchical
    runtime looks: ``fleet``/``nodes``/``cloud_id``/``depth``/
    ``num_devices``/``tier_nodes``/``gateways``/``describe``; gateway
    ``children`` supports ``len`` and numpy indexing.  Nodes holding array
    children are not hashable — never used as dict keys."""
    name: str
    fleet: Fleet
    nodes: Dict[int, TopoNode]           # interior + cloud ONLY
    cloud_id: int

    def __post_init__(self):
        n = self.fleet.num_devices
        cloud = self.nodes[self.cloud_id]
        if cloud.parent is not None:
            raise ValueError("cloud node must be the root (parent=None)")
        covered = 0
        for node in self.nodes.values():
            if node.tier == 0:
                raise ValueError("stacked topology holds no device nodes")
            parent = self.nodes.get(node.parent) if node.parent is not None \
                else None
            if node.node_id != self.cloud_id:
                if parent is None:
                    raise ValueError(f"node {node.node_id} has dangling "
                                     f"parent {node.parent}")
                if parent.tier != node.tier + 1:
                    raise ValueError(f"tier skip on edge {node.node_id}->"
                                     f"{parent.node_id}")
                if node.uplink is None:
                    raise ValueError(f"interior node {node.node_id} needs "
                                     "an uplink")
            if node.tier == 1:
                devs = np.asarray(node.children)
                if devs.size and (devs.min() < 0 or devs.max() >= n):
                    raise ValueError(f"gateway {node.node_id} references "
                                     "devices outside the fleet")
                covered += devs.size
        if covered != n:
            raise ValueError(f"gateways cover {covered} of {n} devices")

    @property
    def depth(self) -> int:
        return self.nodes[self.cloud_id].tier

    @property
    def num_devices(self) -> int:
        return self.fleet.num_devices

    def tier_nodes(self, tier: int) -> List[TopoNode]:
        return sorted((n for n in self.nodes.values() if n.tier == tier),
                      key=lambda n: n.node_id)

    @property
    def gateways(self) -> List[TopoNode]:
        return self.tier_nodes(1)

    def devices_under(self, node_id: int) -> List[int]:
        node = self.nodes[node_id]
        if node.tier == 1:
            return sorted(int(d) for d in np.asarray(node.children))
        out: List[int] = []
        for ch in node.children:
            out.extend(self.devices_under(int(ch)))
        return sorted(out)

    def describe(self) -> str:
        tiers = [len(self.tier_nodes(t)) for t in range(1, self.depth + 1)]
        return (f"{self.name}: depth={self.depth} "
                f"tier_sizes={self.num_devices}x"
                f"{'x'.join(str(t) for t in tiers)} "
                f"({self.fleet.describe()})")


def stacked_two_tier(fleet: Fleet, num_gateways: int,
                     gw_up_bw: float = GATEWAY_BW,
                     gw_down_bw: float = GATEWAY_BW,
                     gw_latency: float = 0.01,
                     assignment: str = "contiguous",
                     seed: int = 0) -> StackedTopology:
    """:func:`two_tier_topology` in stacked form — same device→gateway
    partition, links, node ids and tiers, minus the per-device leaf nodes."""
    n = fleet.num_devices
    if not (1 <= num_gateways <= n):
        raise ValueError(f"num_gateways must be in [1, {n}], got {num_gateways}")
    groups = _partition(n, num_gateways, assignment, seed)
    link = Link(gw_up_bw, gw_down_bw, gw_latency)
    cloud_id = n + num_gateways
    nodes: Dict[int, TopoNode] = {}
    for g, devs in enumerate(groups):
        gid = n + g
        nodes[gid] = TopoNode(gid, 1, cloud_id,
                              np.ascontiguousarray(devs, np.int32),
                              uplink=link)
    nodes[cloud_id] = TopoNode(cloud_id, 2, None,
                               tuple(range(n, n + num_gateways)))
    return StackedTopology(f"two_tier(g{num_gateways})", fleet, nodes,
                           cloud_id)


def _partition(num_devices: int, num_groups: int,
               assignment: str, seed: int) -> List[np.ndarray]:
    """Split device ids into ``num_groups`` groups."""
    ids = np.arange(num_devices)
    if assignment == "contiguous":
        return [g for g in np.array_split(ids, num_groups)]
    if assignment == "roundrobin":
        return [ids[g::num_groups] for g in range(num_groups)]
    if assignment == "random":
        rng = np.random.RandomState(seed)
        return [np.sort(g) for g in
                np.array_split(rng.permutation(ids), num_groups)]
    raise KeyError(f"unknown assignment '{assignment}' "
                   "(contiguous|roundrobin|random)")


def star_topology(fleet: Fleet) -> Topology:
    """Every device uploads straight to the cloud — the flat baseline."""
    n = fleet.num_devices
    cloud = TopoNode(n, tier=1, parent=None, children=tuple(range(n)))
    nodes = {i: TopoNode(i, 0, n, ()) for i in range(n)}
    nodes[n] = cloud
    return Topology("star", fleet, nodes, cloud_id=n)


def two_tier_topology(fleet: Fleet, num_gateways: int,
                      gw_up_bw: float = GATEWAY_BW,
                      gw_down_bw: float = GATEWAY_BW,
                      gw_latency: float = 0.01,
                      assignment: str = "contiguous",
                      seed: int = 0) -> Topology:
    """device → gateway → cloud with ``num_gateways`` gateways."""
    n = fleet.num_devices
    if not (1 <= num_gateways <= n):
        raise ValueError(f"num_gateways must be in [1, {n}], got {num_gateways}")
    groups = _partition(n, num_gateways, assignment, seed)
    link = Link(gw_up_bw, gw_down_bw, gw_latency)
    cloud_id = n + num_gateways
    nodes: Dict[int, TopoNode] = {}
    gw_ids = []
    for g, devs in enumerate(groups):
        gid = n + g
        gw_ids.append(gid)
        nodes[gid] = TopoNode(gid, 1, cloud_id, tuple(int(d) for d in devs),
                              uplink=link)
        for d in devs:
            nodes[int(d)] = TopoNode(int(d), 0, gid, ())
    nodes[cloud_id] = TopoNode(cloud_id, 2, None, tuple(gw_ids))
    return Topology(f"two_tier(g{num_gateways})", fleet, nodes, cloud_id)


def geo_partitioned_topology(fleet: Fleet, num_regions: int,
                             gateways_per_region: int,
                             gw_up_bw: float = GATEWAY_BW,
                             trunk_bw: float = TRUNK_BW,
                             gw_latency: float = 0.01,
                             trunk_latency: float = 0.05) -> Topology:
    """device → gateway → regional → cloud, devices assigned contiguously so
    regions correlate with a Dirichlet-partitioned dataset's label skew."""
    n = fleet.num_devices
    num_gateways = num_regions * gateways_per_region
    if num_gateways > n:
        raise ValueError(f"{num_gateways} gateways exceed {n} devices")
    groups = _partition(n, num_gateways, "contiguous", 0)
    gw_link = Link(gw_up_bw, gw_up_bw, gw_latency)
    trunk = Link(trunk_bw, trunk_bw, trunk_latency)
    cloud_id = n + num_gateways + num_regions
    nodes: Dict[int, TopoNode] = {}
    region_ids = []
    for r in range(num_regions):
        rid = n + num_gateways + r
        region_ids.append(rid)
        gw_ids = []
        for j in range(gateways_per_region):
            g = r * gateways_per_region + j
            gid = n + g
            gw_ids.append(gid)
            devs = groups[g]
            nodes[gid] = TopoNode(gid, 1, rid, tuple(int(d) for d in devs),
                                  uplink=gw_link)
            for d in devs:
                nodes[int(d)] = TopoNode(int(d), 0, gid, ())
        nodes[rid] = TopoNode(rid, 2, cloud_id, tuple(gw_ids), uplink=trunk)
    nodes[cloud_id] = TopoNode(cloud_id, 3, None, tuple(region_ids))
    return Topology(f"geo(r{num_regions}xg{gateways_per_region})", fleet,
                    nodes, cloud_id)


def get_topology(name: str, num_devices: int, seed: int = 0, **kw) -> Topology:
    """Canonical (fleet, tree) pairs by name.

      * ``star``            — uniform fleet, flat.
      * ``two_tier_bimodal``— bimodal phone+gateway fleet behind
        ``num_gateways`` (default 4) gateways, contiguous assignment.
      * ``geo``             — uniform fleet, 2 regions × 2 gateways (3 tiers),
        contiguous (non-IID-correlated) assignment.
    """
    if name == "star":
        return star_topology(uniform_fleet(num_devices))
    if name == "two_tier_bimodal":
        gws = kw.pop("num_gateways", 4)
        fleet = bimodal_fleet(num_devices, seed=seed,
                              **{k: kw.pop(k) for k in
                                 ("slowdown", "slow_frac", "dropout_slow")
                                 if k in kw})
        return two_tier_topology(fleet, gws, seed=seed, **kw)
    if name == "geo":
        regions = kw.pop("num_regions", 2)
        gpr = kw.pop("gateways_per_region", 2)
        return geo_partitioned_topology(uniform_fleet(num_devices), regions,
                                        gpr, **kw)
    raise KeyError(f"unknown topology '{name}' (star|two_tier_bimodal|geo)")
