"""ICI topology model + contention-aware gang placement scoring.

The reference's TPU pod slices are physical torus meshes: every node
(host) sits at a coordinate on a 2D/3D torus and talks to its neighbors
over per-link ICI. A ring allreduce over a gang of nodes occupies the
torus links along its ring path, so two gangs whose rings share links
serialize each other's collectives (arxiv 2207.07817). This module is
the ONE scoring abstraction threaded through every placement surface:

* ``common.place_bundles`` (the C++-bound scheduler wrapper) accepts an
  optional ``Topology`` + committed-ring registry and dispatches here
  when the cluster advertises coordinates — topology-less clusters take
  today's resource-fit path (native engine or Python oracle) untouched.
* The GCS placement-group path (gcs.py ``_try_place_pg``) builds the
  topology from its node table, scores candidates against the rings of
  already-committed gangs, and stamps the chosen score on the pg table.
* schedsim.py drives these same functions under a virtual clock to get
  reproducible contention/latency numbers at simulated 10k-node scale.

Coordinates ride ordinary node labels (synthesized from config for now,
the way the reference synthesizes slice topology env vars), in the
TPU-style "x"-separated form — "," is a reserved separator of the native
scheduler's line wire format, and a label it can't carry would silently
demote the whole cluster off the native pick_node path:

    torus-coord     = "0x1[x2]"   this node's coordinate
    torus-dims      = "4x4[x8]"   the torus extent (same on every node)
    torus-link-caps = "2x1[x1]"   optional per-dimension link capacity
                                  (relative units; a shared link on a
                                  half-capacity dimension contends 2x)

(comma-separated values are accepted on parse for hand-written configs).

Everything here is deterministic pure Python over ``NodeInfo`` views —
no wall clock, no RNG — so a schedsim replay of a placement decision is
bit-identical to the live GCS decision on the same view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch._private.common import (
    NodeInfo,
    place_bundles_py,
    res_add,
    res_fits,
    res_sub,
)

Coord = Tuple[int, ...]
Link = Tuple[Coord, Coord]  # normalized: min endpoint first

COORD_LABEL = "torus-coord"
DIMS_LABEL = "torus-dims"
LINK_CAPS_LABEL = "torus-link-caps"


def parse_coord(s: str) -> Optional[Coord]:
    try:
        c = tuple(int(v) for v in str(s).replace(",", "x").split("x"))
    except (ValueError, AttributeError):
        return None
    return c if 1 <= len(c) <= 3 else None


def format_coord(c: Coord) -> str:
    return "x".join(str(v) for v in c)


@dataclass(frozen=True)
class PlacementScore:
    """Score of one candidate gang placement; lower tuples are better.

    ``contention``  shared torus links between this gang's induced
                    allreduce ring and every committed gang's ring,
                    each link weighted by the inverse of its
                    dimension's capacity (unit capacity -> a plain
                    shared-link count).
    ``compactness`` torus bounding-box volume / member count (1.0 = a
                    perfectly contiguous slice; grows as the gang
                    scatters and its ring has to snake across the pod).
    """

    contention: float
    compactness: float

    def key(self) -> tuple:
        return (self.contention, self.compactness)


class Topology:
    """Coordinate view of a cluster: node_id -> torus coord (+ extents,
    optional per-dimension link capacities)."""

    def __init__(self, coords: Dict[str, Coord], dims: Coord,
                 link_caps: Optional[Tuple[float, ...]] = None):
        self.coords = coords
        self.dims = dims
        self.link_caps = link_caps  # None = unit capacity everywhere

    @classmethod
    def from_nodes(cls, nodes: Sequence[NodeInfo]) -> Optional["Topology"]:
        """Build from advertised labels; None when fewer than two nodes
        carry coords (the scoring surface then degrades to resource-fit,
        which keeps topology-less clusters byte-identical to today)."""
        coords: Dict[str, Coord] = {}
        dims: Optional[Coord] = None
        caps: Optional[Coord] = None
        for n in nodes:
            labels = n.labels or {}
            c = parse_coord(labels.get(COORD_LABEL, ""))
            if c is None:
                continue
            coords[n.node_id] = c
            d = parse_coord(labels.get(DIMS_LABEL, ""))
            if d is not None and len(d) == len(c):
                dims = d if dims is None else tuple(
                    max(a, b) for a, b in zip(dims, d))
            if caps is None:
                caps = parse_coord(labels.get(LINK_CAPS_LABEL, ""))
        if len(coords) < 2:
            return None
        ndim = max(len(c) for c in coords.values())
        # pad short coords so mixed 2D/3D labels still compare
        coords = {k: c + (0,) * (ndim - len(c)) for k, c in coords.items()}
        if dims is None or len(dims) != ndim:
            dims = tuple(max(c[i] for c in coords.values()) + 1
                         for i in range(ndim))
        else:
            dims = tuple(max(dims[i], max(c[i] for c in coords.values()) + 1)
                         for i in range(ndim))
        link_caps = None
        if caps is not None and len(caps) == ndim \
                and all(v > 0 for v in caps):
            link_caps = tuple(float(v) for v in caps)
        return cls(coords, dims, link_caps)

    def link_weight(self, link: Link) -> float:
        """Contention weight of one link: 1 / its dimension's capacity
        (half-capacity wires hurt twice as much to share)."""
        if self.link_caps is None:
            return 1.0
        a, b = link
        for d in range(len(self.dims)):
            if a[d] != b[d]:
                return 1.0 / self.link_caps[d]
        return 1.0

    # -- ring / link geometry ------------------------------------------

    def _step(self, a: int, b: int, extent: int) -> int:
        """One unit step from a toward b along a ring of ``extent``,
        taking the shorter wrap direction (ties go positive)."""
        if a == b:
            return a
        fwd = (b - a) % extent
        back = (a - b) % extent
        return (a + 1) % extent if fwd <= back else (a - 1) % extent

    def _route(self, src: Coord, dst: Coord) -> List[Link]:
        """Dimension-ordered shortest torus route src -> dst as a list of
        normalized unit links (both rings crossing a physical link in
        either direction contend: links are undirected)."""
        links: List[Link] = []
        cur = list(src)
        for d in range(len(self.dims)):
            while cur[d] != dst[d]:
                nxt = list(cur)
                nxt[d] = self._step(cur[d], dst[d], self.dims[d])
                a, b = tuple(cur), tuple(nxt)
                links.append((a, b) if a <= b else (b, a))
                cur = nxt
        return links

    def ring_links(self, node_ids: Sequence[str]) -> FrozenSet[Link]:
        """The torus links occupied by a ring allreduce over the gang:
        members visited in snake order (contiguous slices produce mostly
        neighbor hops), each hop routed dimension-ordered. Deterministic
        for a given member set. Nodes without coords contribute nothing
        (their traffic rides DCN, not ICI)."""
        members = sorted({self.coords[nid] for nid in node_ids
                          if nid in self.coords},
                         key=self._snake_key)
        if len(members) < 2:
            return frozenset()
        links: Set[Link] = set()
        for i, src in enumerate(members):
            links.update(self._route(src, members[(i + 1) % len(members)]))
        return frozenset(links)

    def _snake_key(self, c: Coord) -> tuple:
        """Boustrophedon order: odd rows traverse backward, so
        consecutive members in a contiguous block are torus neighbors
        (plain lexicographic order would teleport row ends)."""
        key: List[int] = []
        flip = 0
        # outermost dims first (z, then y, then x), flipping the next
        # dim's direction whenever the accumulated prefix is odd
        for d in range(len(c) - 1, -1, -1):
            v = c[d] if flip % 2 == 0 else self.dims[d] - 1 - c[d]
            key.append(v)
            flip += c[d]
        return tuple(key)

    def compactness(self, node_ids: Sequence[str]) -> float:
        """Torus bounding-box volume / member count (>= 1.0; 1.0 is a
        perfectly dense axis-aligned slice). Circular extents: a block
        wrapping the torus edge is as compact as an interior one."""
        coords = [self.coords[nid] for nid in node_ids
                  if nid in self.coords]
        if not coords:
            return 1.0
        volume = 1
        for d in range(len(self.dims)):
            vals = sorted({c[d] for c in coords})
            extent = self.dims[d]
            if len(vals) <= 1:
                span = 1
            elif len(vals) == extent:
                span = extent
            else:
                # minimal circular cover = extent - largest gap + 1
                gaps = [(vals[(i + 1) % len(vals)] - v) % extent
                        for i, v in enumerate(vals)]
                span = max(extent - max(gaps) + 1, 1)
            volume *= span
        return volume / max(len(set(coords)), 1)

    # -- scoring --------------------------------------------------------

    def score(self, node_ids: Sequence[str],
              committed: Dict[str, FrozenSet[Link]]) -> PlacementScore:
        links = self.ring_links(node_ids)
        if self.link_caps is None:  # common case: plain shared-link count
            contention = float(sum(
                len(links & other) for other in committed.values()))
        else:
            contention = sum(
                self.link_weight(lk)
                for other in committed.values() for lk in links & other)
        return PlacementScore(contention, self.compactness(node_ids))

    def overlap_ratio(self,
                      committed: Dict[str, FrozenSet[Link]]) -> float:
        return overlap_ratio(committed)


def overlap_ratio(committed: Dict[str, FrozenSet[Link]]) -> float:
    """Aggregate ring-overlap across committed gangs: pairwise shared
    links / total ring links (0.0 = every gang owns its links). The ONE
    definition behind both the live ``sched_ring_overlap_ratio`` gauge
    and schedsim's reported ratio — geometry-free, so it needs no
    Topology instance."""
    rings = [r for r in committed.values() if r]
    total = sum(len(r) for r in rings)
    if total == 0 or len(rings) < 2:
        return 0.0
    shared = 0
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            shared += len(rings[i] & rings[j])
    return min(1.0, 2.0 * shared / total)


def synthesize(n: int, dims: Optional[Coord] = None) -> List[Coord]:
    """Grid coordinates for n nodes (schedsim clusters, tests, and the
    config-synthesized pods the reference builds from slice env vars).
    Chooses near-square/cubic dims when not given; row-major fill."""
    if dims is None:
        side = max(2, round(n ** 0.5))
        dims = (side, (n + side - 1) // side)
    out: List[Coord] = []
    for i in range(n):
        c: List[int] = []
        rest = i
        for d in dims:
            c.append(rest % d)
            rest //= d
        out.append(tuple(c))
    return out


# ---------------------------------------------------------------------------
# Topology-aware bundle placement (the contention policy)
# ---------------------------------------------------------------------------


def place_bundles_topo(
    nodes: List[NodeInfo],
    bundles: List[Dict[str, float]],
    strategy: str,
    topo: Topology,
    committed: Dict[str, FrozenSet[Link]],
    max_candidates: int = 32,
) -> Optional[Tuple[List[str], PlacementScore]]:
    """Contention-aware gang placement: generate candidate torus-aligned
    contiguous slices (windows over the feasible nodes in snake order),
    place the gang inside each window with the SAME strategy semantics as
    the resource-fit oracle (``place_bundles_py`` restricted to the
    window — feasibility and PACK/SPREAD/STRICT_* behavior are inherited,
    never re-implemented), score each feasible candidate by (ring overlap
    with committed gangs, slice compactness), and return the best. The
    unrestricted oracle placement is always a candidate, so this never
    returns None when resource-fit placement exists."""
    base = place_bundles_py(nodes, bundles, strategy)
    if base is None:
        return None
    best = (topo.score(base, committed), 1, base)  # (score, tiebreak, pl)

    # candidate pool: alive, coordinated, and able to host at least one
    # bundle RIGHT NOW — windows over snake order then consist of
    # placeable nodes, so they track the free regions of a fragmented
    # torus instead of sliding over committed gangs
    with_coords = sorted(
        (n for n in nodes
         if n.alive and n.node_id in topo.coords
         and any(res_fits(b, n.resources_available) for b in bundles)),
        key=lambda n: (topo._snake_key(topo.coords[n.node_id]), n.node_id),
    )
    # windows must be able to host the gang: STRICT_SPREAD needs one node
    # per bundle; the others can double up but a window of gang size is
    # the natural contiguous slice to try first, then 2x for slack
    need = len(bundles)
    for width in {min(need, len(with_coords)),
                  min(2 * need, len(with_coords))}:
        if width < 1 or (strategy == "STRICT_SPREAD"
                         and width < len(bundles)):
            continue
        n_windows = len(with_coords) - width + 1
        stride = max(1, n_windows // max_candidates)
        for start in range(0, n_windows, stride):
            window = with_coords[start:start + width]
            placement = place_bundles_py(window, bundles, strategy)
            if placement is None:
                continue
            cand = (topo.score(placement, committed), 0, placement)
            # tiebreak 0 < 1: at equal score prefer the aligned slice
            # over the oracle's arbitrary pick; ties between windows
            # resolve by score then first-window order (deterministic)
            if (cand[0].key(), cand[1]) < (best[0].key(), best[1]):
                best = cand
            if best[0].contention == 0 and best[0].compactness <= 1.0:
                break  # perfect slice; no better candidate exists
        if best[0].contention == 0 and best[0].compactness <= 1.0:
            break
    return best[2], best[0]


# ---------------------------------------------------------------------------
# Fragmentation-aware repack (shared planner: GCS executes over RPC,
# schedsim applies to its simulated view)
# ---------------------------------------------------------------------------


@dataclass
class RepackMove:
    pg_id: str
    bundle_index: int
    from_node: str
    to_node: str
    resources: Dict[str, float]


def plan_repack(
    nodes: List[NodeInfo],
    bundles: List[Dict[str, float]],
    strategy: str,
    idle_bundles: List[Tuple[str, int, str, Dict[str, float]]],
    max_moves: int = 8,
) -> Optional[Tuple[List[str], List[RepackMove]]]:
    """When a strict-spread gang can't place, try migrating PENDING (not
    running) bundles of other gangs — ``idle_bundles`` rows are
    ``(pg_id, bundle_index, node_id, original_resources)`` whose
    reservations show zero consumption — to defragment enough distinct
    nodes. Greedy and bounded: each round frees the first (deterministic
    order) idle bundle whose host could then fit some gang bundle, parks
    it on the first other node with room, and re-tries placement on the
    scratch view. Returns (placement, moves) or None if ``max_moves``
    rounds can't defragment a feasible placement."""
    scratch = {
        n.node_id: NodeInfo(
            node_id=n.node_id, host=n.host, port=n.port,
            store_dir=n.store_dir,
            resources_total=dict(n.resources_total),
            resources_available=dict(n.resources_available),
            labels=n.labels, alive=n.alive,
        )
        for n in nodes if n.alive
    }
    pending = sorted(idle_bundles)
    moves: List[RepackMove] = []
    for _ in range(max_moves):
        view = list(scratch.values())
        placement = place_bundles_py(view, bundles, strategy)
        if placement is not None:
            return placement, moves
        moved = False
        for row in pending:
            pg_id, idx, host_id, orig = row
            host = scratch.get(host_id)
            if host is None:
                continue
            # freeing this bundle must make its host useful to the gang
            freed = dict(host.resources_available)
            res_add(freed, orig)
            if not any(res_fits(b, freed) for b in bundles):
                continue
            # prefer parking spots that stay (or already were) useless to
            # the gang — moving the bundle onto one of the few nodes the
            # gang itself needs just shifts the hole around. One linear
            # pass, key computed once per feasible node (a sort with a
            # res_fits-heavy key is O(n log n) paid every repack round).
            target = None
            best_key = None
            for t in scratch.values():
                if t.node_id == host_id \
                        or not res_fits(orig, t.resources_available):
                    continue
                fits_before = any(res_fits(b, t.resources_available)
                                  for b in bundles)
                after = dict(t.resources_available)
                res_sub(after, orig)
                fits_after = any(res_fits(b, after) for b in bundles)
                key = (fits_before and not fits_after, t.node_id)
                if best_key is None or key < best_key:
                    best_key, target = key, t
            if target is None:
                continue
            res_add(host.resources_available, orig)
            res_sub(target.resources_available, orig)
            moves.append(RepackMove(pg_id, idx, host_id, target.node_id,
                                    dict(orig)))
            pending.remove(row)
            moved = True
            break
        if not moved:
            return None
    view = list(scratch.values())
    placement = place_bundles_py(view, bundles, strategy)
    return (placement, moves) if placement is not None else None
