"""The port's scheduler simulator (``ray_tpu_torch._private.schedsim``)
against the reference's: the cases of ``tests/test_schedsim.py``, each run
through the port and held to the reference's simulator on the same spec
and seed: the same decisions, the same report and the same trace text.
"""

import time

import pytest

from ray_tpu._private import schedsim as ref
from ray_tpu_torch._private import schedsim

pytestmark = pytest.mark.schedsim


def spec(mod=schedsim, **kw):
    kw.setdefault("nodes", 200)
    kw.setdefault("seed", 11)
    return mod.SimSpec(**kw)


def _held_to_reference(**kw):
    """The port's (report, trace) of ``kw``, asserted equal to the
    reference's."""
    got = schedsim.run_with_trace(spec(**kw))
    want = ref.run_with_trace(spec(ref, **kw))
    assert got[1] == want[1]
    assert got[0] == want[0]
    return got


def test_same_seed_same_trace_bytes():
    r1, t1 = _held_to_reference(policy="contention")
    r2, t2 = schedsim.run_with_trace(spec(policy="contention"))
    assert t1 == t2
    assert r1["trace_sha256"] == r2["trace_sha256"]
    assert r1 == r2


def test_same_seed_same_trace_with_chaos():
    chaos = "sim000[0-7]:drop:1:42;sim001.:delay:1:43:500"
    r1, t1 = _held_to_reference(seed=3, chaos=chaos)
    r2, t2 = schedsim.run_with_trace(spec(seed=3, chaos=chaos))
    assert t1 == t2 and r1["trace_sha256"] == r2["trace_sha256"]


def test_different_seed_different_trace():
    _, t1 = _held_to_reference(seed=1)
    _, t2 = _held_to_reference(seed=2)
    assert t1 != t2


def test_smoke_500_nodes_contention_no_worse_than_baseline():
    t0 = time.monotonic()
    cont = schedsim.run(spec(nodes=500, seed=7, policy="contention"))
    base = schedsim.run(spec(nodes=500, seed=7, policy="baseline"))
    wall = time.monotonic() - t0
    assert wall < 10.0, f"500-node smoke took {wall:.1f}s"
    assert cont["placed"] > 0 and base["placed"] > 0
    assert cont["total_contention"] <= base["total_contention"]
    assert cont["gangs"] == base["gangs"]
    for r in (cont, base):
        lat = r["placement_latency_s"]
        assert 0.0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
        assert 0.0 < r["utilization"] < 1.0
    assert cont == ref.run(spec(ref, nodes=500, seed=7, policy="contention"))
    assert base == ref.run(spec(ref, nodes=500, seed=7, policy="baseline"))


def test_chaos_kill_requeues_and_books_balance():
    chaos = "sim0000[0-9]:drop:1:5"  # kill 10 of 100 nodes
    sim = schedsim.SchedSim(spec(nodes=100, seed=9, chaos=chaos))
    report = sim.run()
    trace = sim.trace.text()
    assert " kill " in trace
    dead = [nid for nid, n in sim.nodes.items() if not n.alive]
    assert len(dead) == 10
    assert sim._used_cpu == pytest.approx(0.0)
    assert not sim.placed
    assert report["placed"] >= report["gangs"]  # requeues re-place
    want = ref.SchedSim(spec(ref, nodes=100, seed=9, chaos=chaos))
    assert want.run() == report
    assert want.trace.text() == trace


def test_chaos_heartbeat_delay_restores_node():
    chaos = "sim00000:delay:1:5:200"
    sim = schedsim.SchedSim(spec(nodes=50, seed=2, chaos=chaos))
    sim.run()
    trace = sim.trace.text()
    assert "hb_delay ms=200 node=sim00000" in trace
    assert "hb_restore node=sim00000" in trace
    assert sim.nodes["sim00000"].alive
    want = ref.SchedSim(spec(ref, nodes=50, seed=2, chaos=chaos))
    want.run()
    assert want.trace.text() == trace


def test_bad_policy_rejected():
    with pytest.raises(ValueError):
        schedsim.SchedSim(spec(policy="nope"))
    with pytest.raises(ValueError):
        ref.SchedSim(spec(ref, policy="nope"))


def test_report_shape():
    r, _ = _held_to_reference(nodes=100, seed=1)
    for key in ("policy", "nodes", "gangs", "placed", "failed", "repacks",
                "placement_latency_s", "utilization", "mean_contention",
                "total_contention", "final_ring_overlap_ratio", "events",
                "trace_sha256"):
        assert key in r, key


def _fragmented(mod):
    """The reference's hand-fragmented cluster of 4 nodes and the gang
    that needs a repack, in ``mod``'s simulator."""
    s = spec(mod, nodes=4, seed=1, gang_size=3, gangs=1,
             big_node_every=0, policy="contention")
    sim = mod.SchedSim(s)
    nodes = sorted(sim.nodes)
    sim.nodes[nodes[3]].resources_total = {"CPU": 8.0}
    sim.nodes[nodes[3]].resources_available = {"CPU": 8.0}
    sim.nodes[nodes[1]].resources_available = {"CPU": 0.0}  # running
    blocker = mod._Gang(
        gang_id="blocker", bundles=[{"CPU": 4.0}], strategy="PACK",
        arrival_t=0.0, hold_s=100.0,
        placement=[nodes[0]], placed_t=0.0, running=False)
    sim.nodes[nodes[0]].resources_available = {"CPU": 0.0}
    sim.placed["blocker"] = blocker
    gang = mod._Gang(
        gang_id="g0", bundles=[{"CPU": 4.0}] * 3,
        strategy="STRICT_SPREAD", arrival_t=0.0, hold_s=1.0)
    sim._try_place(gang)
    return sim, nodes, blocker, gang


def test_repack_fires_under_fragmentation():
    sim, nodes, blocker, gang = _fragmented(schedsim)
    assert gang.placement is not None
    assert sim.repacks == 1
    assert blocker.placement == [nodes[3]]  # parked on the big node
    assert "repack" in sim.trace.text()
    want, _, want_blocker, want_gang = _fragmented(ref)
    assert gang.placement == want_gang.placement
    assert blocker.placement == want_blocker.placement
    assert sim.trace.text() == want.trace.text()
