"""The port's counterpart of ``tests/test_native_sched.py`` (7 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

Beside them, the port's native ``pick_node`` and ``place_bundles`` are
held to the reference's Python oracle on the same seeded clusters, in the
port's resource names (``GPU``, ``gpu-group``).

The reference's description:

Differential tests: native (C++) scheduling policies vs the Python oracle.

The native engine (ray_tpu_torch/_private/csrc/scheduler.cpp via
ray_tpu_torch/_private/native_sched.py)
must pick the same node as the pure-Python policies in
ray_tpu_torch/_private/common.py for every strategy on randomized clusters —
mirroring how the reference unit-tests its policy classes
(ray: src/ray/raylet/scheduling/policy/scheduling_policy_test.cc).
"""

import random

import pytest

from ray_tpu_torch._private import native_sched
from ray_tpu_torch._private.common import (
    NodeInfo,
    SchedulingStrategy,
    pick_node_py,
    place_bundles_py,
)

pytestmark = pytest.mark.skipif(
    not native_sched.available(), reason="native scheduler not built"
)


def _rand_cluster(rng, n_nodes):
    nodes = []
    for i in range(n_nodes):
        total = {"CPU": rng.choice([1, 2, 4, 8, 16])}
        if rng.random() < 0.5:
            total["TPU"] = rng.choice([1, 4, 8])
        if rng.random() < 0.3:
            total["memory"] = rng.choice([2.5, 8.0, 16.0])
        avail = {
            k: round(v * rng.choice([0.0, 0.25, 0.5, 0.75, 1.0]), 4)
            for k, v in total.items()
        }
        labels = {}
        if rng.random() < 0.6:
            labels["zone"] = rng.choice(["a", "b", "c"])
        if rng.random() < 0.4:
            labels["tpu-slice"] = rng.choice(["s0", "s1"])
        nodes.append(
            NodeInfo(
                node_id=f"node{i:03d}", host="127.0.0.1", port=0,
                store_dir="", resources_total=total,
                resources_available=avail, labels=labels,
                alive=rng.random() > 0.1,
            )
        )
    return nodes


def _rand_demand(rng):
    d = {"CPU": rng.choice([0.5, 1, 2, 4])}
    if rng.random() < 0.3:
        d["TPU"] = rng.choice([1, 4])
    return d


def _strategies(rng, nodes):
    yield SchedulingStrategy()
    yield SchedulingStrategy(kind="SPREAD")
    nid = rng.choice(nodes).node_id if nodes else "nodeX"
    yield SchedulingStrategy(kind="NODE_AFFINITY", node_id=nid, soft=False)
    yield SchedulingStrategy(kind="NODE_AFFINITY", node_id=nid, soft=True)
    yield SchedulingStrategy(kind="NODE_AFFINITY", node_id="missing", soft=True)
    yield SchedulingStrategy(kind="NODE_LABEL", labels_hard={"zone": "a"})
    yield SchedulingStrategy(
        kind="NODE_LABEL", labels_hard={"zone": ["a", "b"]},
        labels_soft={"tpu-slice": "s0"},
    )
    yield SchedulingStrategy(kind="NODE_LABEL", labels_hard={"zone": "!c"})
    yield SchedulingStrategy(kind="NODE_LABEL", labels_hard={"tpu-slice": None})


def test_pick_node_matches_python_oracle():
    rng = random.Random(7)
    checked = picked = 0
    for trial in range(200):
        nodes = _rand_cluster(rng, rng.randint(1, 12))
        demand = _rand_demand(rng)
        local = rng.choice(nodes).node_id if rng.random() < 0.7 else None
        for strat in _strategies(rng, nodes):
            rr_py, rr_nat = [trial % 5], [trial % 5]
            want = pick_node_py(nodes, demand, strat, local, rr_py)
            got = native_sched.pick_node(nodes, demand, strat, local, rr_nat, 0.5)
            assert got == want, (
                f"trial {trial} strat={strat}: native={got} py={want}\n"
                f"demand={demand} local={local}\n"
                + "\n".join(
                    f"  {n.node_id} alive={n.alive} t={n.resources_total} "
                    f"a={n.resources_available} l={n.labels}" for n in nodes
                )
            )
            assert rr_nat == rr_py
            checked += 1
            picked += got is not None
    assert checked > 1000 and picked > 100  # the sweep actually exercised both


def test_place_bundles_matches_python_oracle():
    rng = random.Random(11)
    checked = placed = 0
    for trial in range(200):
        nodes = _rand_cluster(rng, rng.randint(1, 8))
        bundles = [
            {"CPU": rng.choice([0.5, 1, 2])} for _ in range(rng.randint(1, 5))
        ]
        for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
            want = place_bundles_py(nodes, bundles, strategy)
            got = native_sched.place_bundles(nodes, bundles, strategy)
            assert got == want, (
                f"trial {trial} {strategy}: native={got} py={want}"
            )
            checked += 1
            placed += got is not None
    assert checked == 800 and placed > 200


def test_wire_format_edge_cases_fall_back_consistently():
    """Values the wire format cannot carry (separator chars, empty-string
    conditions, non-string conditions) must not diverge from the oracle:
    common.pick_node guards with encodable() and falls back to Python."""
    from ray_tpu_torch._private.common import pick_node, place_bundles

    def node(nid, labels):
        return NodeInfo(node_id=nid, host="h", port=0, store_dir="",
                        resources_total={"CPU": 4},
                        resources_available={"CPU": 4}, labels=labels)

    # label value with a separator char -> encodable() is False
    nodes = [node("n1", {"pool": "a,b"}), node("n2", {"pool": "c"})]
    strat = SchedulingStrategy(kind="NODE_LABEL", labels_hard={"pool": "a,b"})
    assert not native_sched.encodable(nodes, {"CPU": 1}, strat)
    assert pick_node(nodes, {"CPU": 1}, strat, None, [0]) == "n1"

    # int conditions match string labels identically on both paths
    nodes = [node("n1", {"slice": "1"}), node("n2", {"slice": "9"})]
    strat = SchedulingStrategy(kind="NODE_LABEL", labels_hard={"slice": [1, 2]})
    want = pick_node_py(nodes, {"CPU": 1}, strat, None, [0])
    assert want == "n1"
    assert native_sched.pick_node(nodes, {"CPU": 1}, strat, None, [0], 0.5) == want

    # empty-string equality cannot ride the wire -> oracle handles it
    nodes = [node("n1", {"zone": ""})]
    strat = SchedulingStrategy(kind="NODE_LABEL", labels_hard={"zone": ""})
    assert not native_sched.encodable(nodes, {"CPU": 1}, strat)
    assert pick_node(nodes, {"CPU": 1}, strat, None, [0]) == "n1"

    # empty bundle list: [] on both paths, not ['']
    assert native_sched.place_bundles(nodes, [], "PACK") == []
    assert place_bundles(nodes, [], "PACK") == place_bundles_py(nodes, [], "PACK")


def test_place_bundles_parity_property_on_grid_resources():
    """Property-style parity: on randomized grid-resource clusters (all
    values on the engine's 1e-4 fixed-point grid), native and Python
    place_bundles agree node-for-node across every strategy AND the
    agreed placement is actually feasible and honors the strategy
    (distinct nodes for STRICT_SPREAD, one node for STRICT_PACK, fits
    under sequential reservation) — equality alone would also pass on
    two identically-wrong engines."""
    from ray_tpu_torch._private.common import res_fits, res_sub

    rng = random.Random(23)
    checked = placed = 0
    for trial in range(150):
        nodes = _rand_cluster(rng, rng.randint(1, 10))
        bundles = [
            {"CPU": rng.choice([0.5, 1, 2]),
             **({"TPU": rng.choice([1.0, 4.0])}
                if rng.random() < 0.3 else {})}
            for _ in range(rng.randint(1, 5))
        ]
        for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
            want = place_bundles_py(nodes, bundles, strategy)
            got = native_sched.place_bundles(nodes, bundles, strategy)
            assert got == want, (
                f"trial {trial} {strategy}: native={got} py={want}"
            )
            checked += 1
            if got is None:
                continue
            placed += 1
            by_id = {n.node_id: n for n in nodes}
            avail = {n.node_id: dict(n.resources_available)
                     for n in nodes if n.alive}
            for nid, b in zip(got, bundles):
                assert by_id[nid].alive, (trial, strategy, got)
                assert res_fits(b, avail[nid]), (trial, strategy, got)
                res_sub(avail[nid], b)
            if strategy == "STRICT_SPREAD":
                assert len(set(got)) == len(got)
            if strategy == "STRICT_PACK":
                assert len(set(got)) == 1
    assert checked == 600 and placed > 150


def test_torus_coord_labels_stay_on_the_native_path():
    """Topology labels in the canonical "x"-separated form must remain
    wire-encodable — a cluster advertising coords must NOT silently fall
    off the native pick_node fast path."""
    from ray_tpu_torch._private import topology
    from ray_tpu_torch._private.common import SchedulingStrategy, pick_node_py

    nodes = [
        NodeInfo(node_id=f"n{i}", host="h", port=0, store_dir="",
                 resources_total={"CPU": 4}, resources_available={"CPU": 4},
                 labels={topology.COORD_LABEL: topology.format_coord((i, 0)),
                         topology.DIMS_LABEL: topology.format_coord((4, 1))})
        for i in range(4)
    ]
    assert native_sched.encodable(nodes, {"CPU": 1}, SchedulingStrategy())
    strat = SchedulingStrategy()
    want = pick_node_py(nodes, {"CPU": 1}, strat, None, [0])
    assert native_sched.pick_node(
        nodes, {"CPU": 1}, strat, None, [0], 0.5) == want


def test_build_scheduling_converts_node_label_strategy():
    from ray_tpu_torch.api import _build_scheduling
    from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy

    s = _build_scheduling({
        "scheduling_strategy": NodeLabelSchedulingStrategy(
            hard={"zone": "a"}, soft={"tpu-slice": "s0"}
        )
    })
    assert s.kind == "NODE_LABEL"
    assert s.labels_hard == {"zone": "a"}
    assert s.labels_soft == {"tpu-slice": "s0"}


def test_node_label_strategy_end_to_end():
    """NODE_LABEL picks only matching nodes; infeasible without a match."""
    nodes = [
        NodeInfo(node_id="n1", host="h", port=0, store_dir="",
                 resources_total={"CPU": 4}, resources_available={"CPU": 4},
                 labels={"zone": "a"}),
        NodeInfo(node_id="n2", host="h", port=0, store_dir="",
                 resources_total={"CPU": 4}, resources_available={"CPU": 4},
                 labels={"zone": "b"}),
    ]
    strat = SchedulingStrategy(kind="NODE_LABEL", labels_hard={"zone": "b"})
    assert native_sched.pick_node(nodes, {"CPU": 1}, strat, None, [0], 0.5) == "n2"
    strat = SchedulingStrategy(kind="NODE_LABEL", labels_hard={"zone": "z"})
    assert native_sched.pick_node(nodes, {"CPU": 1}, strat, None, [0], 0.5) is None


# ---------------------------------------------- held against the reference --


def _ref_nodes(nodes):
    from ray_tpu._private.common import NodeInfo as RefNodeInfo

    return [RefNodeInfo(node_id=n.node_id, host=n.host, port=n.port,
                        store_dir=n.store_dir,
                        resources_total=dict(n.resources_total),
                        resources_available=dict(n.resources_available),
                        labels=dict(n.labels), alive=n.alive)
            for n in nodes]


def _ref_strategy(s):
    from ray_tpu._private.common import SchedulingStrategy as RefStrategy

    return RefStrategy(kind=s.kind, node_id=s.node_id, soft=s.soft,
                       labels_hard=s.labels_hard, labels_soft=s.labels_soft)


def test_native_pick_node_equals_the_reference_oracle():
    """The port's C++ ``pick_node`` against the reference's Python oracle
    on the same seeded clusters, demands and strategies (the port's
    resource names: ``GPU`` and the ``gpu-group`` label)."""
    from ray_tpu._private.common import pick_node_py as ref_pick_node_py

    rng = random.Random(31)
    checked = picked = 0
    for trial in range(150):
        nodes = _rand_cluster(rng, rng.randint(1, 12))
        for n in nodes:
            for d in (n.resources_total, n.resources_available):
                if "TPU" in d:
                    d["GPU"] = d.pop("TPU")
            if "tpu-slice" in n.labels:
                n.labels["gpu-group"] = n.labels.pop("tpu-slice")
        demand = _rand_demand(rng)
        if "TPU" in demand:
            demand["GPU"] = demand.pop("TPU")
        local = rng.choice(nodes).node_id if rng.random() < 0.7 else None
        for strat in _strategies(rng, nodes):
            rr_ref, rr_nat = [trial % 5], [trial % 5]
            want = ref_pick_node_py(_ref_nodes(nodes), demand,
                                    _ref_strategy(strat), local, rr_ref)
            got = native_sched.pick_node(nodes, demand, strat, local,
                                         rr_nat, 0.5)
            assert got == want, (trial, strat, got, want)
            assert rr_nat == rr_ref
            checked += 1
            picked += got is not None
    assert checked > 1000 and picked > 100


def test_native_place_bundles_equals_the_reference_oracle():
    from ray_tpu._private.common import place_bundles_py as ref_place_py

    rng = random.Random(37)
    checked = placed = 0
    for trial in range(150):
        nodes = _rand_cluster(rng, rng.randint(1, 8))
        bundles = [{"CPU": rng.choice([0.5, 1, 2])}
                   for _ in range(rng.randint(1, 5))]
        for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
            want = ref_place_py(_ref_nodes(nodes), bundles, strategy)
            got = native_sched.place_bundles(nodes, bundles, strategy)
            assert got == want, (trial, strategy, got, want)
            checked += 1
            placed += got is not None
    assert checked == 600 and placed > 150
