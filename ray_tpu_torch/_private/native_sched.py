"""ctypes binding for the native (C++) scheduling-policy engine.

The reference's node-selection policies are C++ (ray:
src/ray/raylet/scheduling/policy/*, cluster_resource_scheduler.h); here
they live in _private/csrc/scheduler.cpp behind a C ABI (built into the
port's own library by native_store.py). `pick_node` and
`place_bundles` in ray_tpu_torch/_private/common.py dispatch to this module when
the shared library is available (set ``RAY_TPU_TORCH_NATIVE_SCHED=0`` to force
the pure-Python policies); both implementations must agree
node-for-node on the same cluster view.

Wire format: the cluster view is serialized per call (clusters are
hundreds of nodes, not millions; serialization is nanoseconds against an
RPC-scale scheduling decision) as one node per line:
``node_id|alive|total|avail|labels`` with comma-joined ``k=v`` lists.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

from ray_tpu_torch._private import native_store

_OUT_CAP = 1 << 20

_configured = False


def _lib():
    global _configured
    lib = native_store.load_library()
    if lib is None:
        return None
    if not hasattr(lib, "rtpu_sched_pick"):
        return None  # a library built without the scheduler
    if not _configured:
        lib.rtpu_sched_pick.restype = ctypes.c_int
        lib.rtpu_sched_pick.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_char_p, ctypes.c_ulong,
        ]
        lib.rtpu_sched_place_bundles.restype = ctypes.c_int
        lib.rtpu_sched_place_bundles.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_ulong,
        ]
        _configured = True
    return lib


def available() -> bool:
    import os

    if os.environ.get("RAY_TPU_TORCH_NATIVE_SCHED", "1") == "0":
        return False
    return _lib() is not None


_RESERVED = set(",|:;=\n")


def _clean(s) -> bool:
    return not (set(str(s)) & _RESERVED)


def _on_grid(res: Dict[str, float]) -> bool:
    """The C++ engine quantizes to 1e-4 fixed point (llround); a value off
    that grid could make native and the Python-oracle policies pick
    different nodes. Screen such inputs out so they take the oracle path."""
    for v in res.values():
        scaled = float(v) * 1e4
        if abs(scaled - round(scaled)) > 1e-6:
            return False
    return True


def encodable(nodes, demand, strategy=None,
              bundles=None) -> bool:
    """The line-oriented wire format has no escaping: any node id, resource
    name, label, or selector value containing a separator char (or an
    empty-string selector value, which the format cannot represent) must be
    scheduled by the Python oracle instead; likewise values off the engine's
    1e-4 fixed-point grid (see _on_grid)."""
    for n in nodes:
        if not _clean(n.node_id):
            return False
        for res in (n.resources_total, n.resources_available):
            if not all(_clean(k) for k in res):
                return False
            if not _on_grid(res):
                return False
        for k, v in (n.labels or {}).items():
            if not (_clean(k) and _clean(v)):
                return False
    if not all(_clean(k) for k in demand or {}):
        return False
    if demand and not _on_grid(demand):
        return False
    for b in bundles or []:
        if not all(_clean(k) for k in b):
            return False
        if not _on_grid(b):
            return False
    if strategy is not None:
        for sel in (getattr(strategy, "labels_hard", None),
                    getattr(strategy, "labels_soft", None)):
            for k, cond in (sel or {}).items():
                if not _clean(k):
                    return False
                vals = cond if isinstance(cond, (list, tuple, set)) else (
                    [] if cond is None else [cond]
                )
                for v in vals:
                    if str(v) == "" or not _clean(v) or (
                        isinstance(v, str) and v == "!"
                    ):
                        return False
    return True


def _res_str(res: Dict[str, float]) -> str:
    return ",".join(f"{k}={v:.10g}" for k, v in res.items())


def _nodes_blob(nodes) -> bytes:
    lines = []
    for n in nodes:
        labels = ",".join(f"{k}={v}" for k, v in (n.labels or {}).items())
        lines.append(
            f"{n.node_id}|{1 if n.alive else 0}|"
            f"{_res_str(n.resources_total)}|"
            f"{_res_str(n.resources_available)}|{labels}"
        )
    return "\n".join(lines).encode()


def _selector_str(sel: Optional[dict]) -> bytes:
    """Encode a label selector {key: cond} where cond is a str (equals),
    a list (in), None (exists), or "!value" (not equals)."""
    if not sel:
        return b""
    parts = []
    for k, cond in sel.items():
        if cond is None:
            parts.append(f"{k}:ex:")
        elif isinstance(cond, (list, tuple, set)):
            vals = list(dict.fromkeys(str(v) for v in cond))
            parts.append(f"{k}:in:{';'.join(vals)}")
        elif isinstance(cond, str) and cond.startswith("!"):
            parts.append(f"{k}:nin:{cond[1:]}")
        else:
            parts.append(f"{k}:in:{cond}")
    return ",".join(parts).encode()


def pick_node(nodes, demand: Dict[str, float], strategy, local_node_id,
              rr_state: List[int], spread_threshold: float) -> Optional[str]:
    lib = _lib()
    out = ctypes.create_string_buffer(_OUT_CAP)
    rr = ctypes.c_longlong(rr_state[0])
    rc = lib.rtpu_sched_pick(
        _nodes_blob(nodes), _res_str(demand).encode(),
        strategy.kind.encode(),
        (strategy.node_id or "").encode(), 1 if strategy.soft else 0,
        _selector_str(getattr(strategy, "labels_hard", None)),
        _selector_str(getattr(strategy, "labels_soft", None)),
        (local_node_id or "").encode(), spread_threshold,
        ctypes.byref(rr), out, _OUT_CAP,
    )
    rr_state[0] = rr.value
    if rc != 1:
        return None
    return out.value.decode()


def place_bundles(nodes, bundles: List[Dict[str, float]],
                  strategy: str) -> Optional[List[str]]:
    if not bundles:
        return []  # the empty wire blob would decode as [''], not []
    lib = _lib()
    out = ctypes.create_string_buffer(_OUT_CAP)
    blob = "\n".join(_res_str(b) for b in bundles).encode()
    rc = lib.rtpu_sched_place_bundles(
        _nodes_blob(nodes), blob, strategy.encode(), out, _OUT_CAP,
    )
    if rc != 1:
        return None
    return out.value.decode().split("\n")
