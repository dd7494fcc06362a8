"""Deterministic, seeded network fault injection for the RPC substrate.

Analog of the reference's chaos knobs (ray: RAY_testing_rpc_failure injects
per-method request/response failures, testing_asio_delay_us injects delays —
src/ray/common/ray_config_def.h). rpcio consults this module at three
well-defined points — frame enqueue (``Connection`` send path), the flush
loop, and ``connect()`` — and each armed rule decides from its OWN seeded
PRNG, so a chaos failure is replayable by re-running with the logged spec.

Spec syntax (``RAY_TPU_TORCH_RPC_FAULTS``), rules separated by ``;`` or newlines::

    pattern:kind:prob:seed[:param]

``kind`` is one of:

  drop       sever the connection mid-frame (partial bytes hit the wire,
             then a hard close — the peer sees a truncated frame)
  delay      stall the connection's write stream ``param`` ms (default 50)
             before this frame (in-order: TCP never reorders, neither do we)
  dup        enqueue the frame twice (exercises receiver-side dedup)
  corrupt    flip one byte in the frame head (length-covered, CRC-covered
             region — the receiver must detect it and reset)
  partition  black-hole traffic to a peer: new dials fail, frames on
             existing connections are silently discarded (keepalive then
             declares the peer dead). ``prob`` is ignored — a matching
             partition rule is always on (a real partition is not a coin
             flip per packet).
  kill       SIGKILL the process sending a matching frame — rank death
             as a seeded-replayable chaos event (nothing flushes, no
             handlers run: exactly what a spot reclaim or OOM kill looks
             like to the rest of the gang). Match a method only the
             target process sends (or replies to) to scope the blast.

``pattern`` is a regex matched against the RPC *method name* for frame
kinds, and against ``"<self_id>><peer>"`` for ``partition`` (so a rule
can partition one process from one peer without touching the rest:
``nodeA.*>.*:6801:partition:1:0``). ``<peer>`` is the dialed
``host:port`` for client connections, and — once the peer has registered
an identity on the connection (``meta["node_id"]``, stamped on both
sides of raylet peer links) — ``"<node_id>|<addr>"``, so rules can name
a peer by node id and black-hole BOTH directions of a duplex socket
(a server-accepted conn's socket addr is just an ephemeral port no rule
could name). Processes label themselves via ``set_self_id`` (raylets use
their node id, the GCS ``gcs:<port>``, workers/drivers
``worker:<client_id>``); the default is ``pid:<pid>``.

Dynamic control: ``RAY_TPU_TORCH_RPC_FAULTS_FILE`` names a file holding the same
spec syntax, re-read when its mtime/size changes (checked at most every
0.2 s) — the lever tests use to create and then HEAL a partition across
live subprocesses. Both sources combine; the env spec parses once.

Near-zero cost when idle: the env is probed once; after that
``active_plan()`` is two module-attribute reads returning None until a
spec is configured (arm at process start via env, or at runtime via
``install()``).
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading
import time
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

KINDS = ("drop", "delay", "dup", "corrupt", "partition", "kill")

_FILE_POLL_S = 0.2


class FaultRule:
    __slots__ = ("pattern", "kind", "prob", "seed", "param", "rx", "rng")

    def __init__(self, pattern: str, kind: str, prob: float, seed: int,
                 param: Optional[float] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.pattern = pattern
        self.kind = kind
        self.prob = prob
        self.seed = seed
        self.param = param
        self.rx = re.compile(pattern)
        self.rng = random.Random(seed)

    def fires(self, text: str) -> bool:
        if self.rx.search(text) is None:
            return False
        if self.kind == "partition":
            return True  # stateful, not probabilistic
        # the PRNG advances only on matches, so the decision sequence for a
        # given (spec, method stream) is reproducible from the seed
        return self.rng.random() < self.prob

    def __repr__(self):
        return (f"FaultRule({self.pattern!r}:{self.kind}:{self.prob}"
                f":{self.seed}" + (f":{self.param}" if self.param else "") + ")")


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a fault spec; malformed rules are logged and skipped (a typo
    in a chaos env var must not crash a raylet at boot)."""
    rules: List[FaultRule] = []
    for raw in re.split(r"[;\n]+", spec or ""):
        raw = raw.strip()
        if not raw or raw.startswith("#"):
            continue
        # rsplit: the pattern itself may contain ':' (host:port regexes)
        parts = raw.rsplit(":", 4)
        for take in (5, 4):  # with and without the optional param field
            if len(parts) < take:
                continue
            head = raw.rsplit(":", take - 1)
            if len(head) != take or head[1] not in KINDS:
                continue
            try:
                param = float(head[4]) if take == 5 else None
                rules.append(FaultRule(head[0], head[1], float(head[2]),
                                       int(head[3]), param))
            except (ValueError, re.error) as e:
                logger.warning("faultsim: skipping malformed rule %r: %s",
                               raw, e)
            break
        else:
            logger.warning("faultsim: skipping malformed rule %r", raw)
    return rules


class FaultPlan:
    """The armed rule set for this process."""

    def __init__(self, rules: List[FaultRule], source: str = ""):
        self.method_rules = [r for r in rules if r.kind != "partition"]
        self.partition_rules = [r for r in rules if r.kind == "partition"]
        self.source = source

    def on_send(self, method: str,
                peer: Optional[str]) -> Optional[Tuple[str, FaultRule]]:
        """Decide the fate of one outbound frame. Returns (kind, rule) for
        the first rule that fires, or None. Internal keepalive frames are
        exempt from method faults (they ARE the failure detector) but not
        from partition (a black hole swallows pings too)."""
        if peer is not None and self.partitioned(peer):
            return ("partition", self.partition_rules[0])
        if method.startswith("__"):
            return None
        for rule in self.method_rules:
            if rule.fires(method):
                return (rule.kind, rule)
        return None

    def partitioned(self, peer: str) -> bool:
        key = f"{_SELF_ID}>{peer}"
        return any(r.fires(key) for r in self.partition_rules)

    def on_connect(self, addr: str) -> bool:
        """True when new dials to ``addr`` must be refused (partition)."""
        return bool(self.partition_rules) and self.partitioned(addr)


# --- module state -------------------------------------------------------
_SELF_ID = f"pid:{os.getpid()}"
_PLAN: Optional[FaultPlan] = None
# set once a probe finds neither env var configured: the per-frame hot
# path then short-circuits to one module-attribute read (env vars are
# snapshotted at first use — arm at process start or via install())
_DISARMED = False
_LOCK = threading.Lock()
_file_state = {"path": None, "sig": None, "next_check": 0.0, "rules": []}
_env_state = {"spec": None, "rules": []}
_installed: Optional[FaultPlan] = None


def set_self_id(self_id: str):
    """Label this process for partition-rule matching (raylet: node id,
    GCS: gcs:<port>, worker/driver: worker:<client_id>)."""
    global _SELF_ID
    _SELF_ID = self_id


def self_id() -> str:
    return _SELF_ID


def install(spec: str) -> FaultPlan:
    """Arm a plan programmatically (tests). Overrides env/file sources
    until ``clear()``."""
    global _installed, _PLAN
    _installed = FaultPlan(parse_spec(spec), source="install")
    _rebuild()
    logger.warning("faultsim armed (install): %s", spec)
    return _installed


def clear():
    global _installed, _PLAN, _DISARMED
    _installed = None
    _env_state["spec"] = None
    _env_state["rules"] = []
    _file_state["path"] = None
    _file_state["sig"] = None
    _file_state["rules"] = []
    _PLAN = None
    _DISARMED = False  # re-probe the env on next use (tests re-arm)


def _rebuild():
    global _PLAN
    rules = list(_env_state["rules"]) + list(_file_state["rules"])
    if _installed is not None:
        _PLAN = _installed
    elif rules:
        _PLAN = FaultPlan(rules, source="env/file")
    else:
        _PLAN = None


def _load_env():
    spec = os.environ.get("RAY_TPU_TORCH_RPC_FAULTS") or ""
    if spec != _env_state["spec"]:
        _env_state["spec"] = spec
        _env_state["rules"] = parse_spec(spec)
        if _env_state["rules"]:
            logger.warning(
                "faultsim armed from RAY_TPU_TORCH_RPC_FAULTS=%r (replay a chaos "
                "failure by re-running with this exact spec)", spec)
        _rebuild()


def _load_file(path: str, now: float):
    _file_state["next_check"] = now + _FILE_POLL_S
    try:
        st = os.stat(path)
        sig = (st.st_mtime_ns, st.st_size)
    except OSError:
        sig = None
    if sig == _file_state["sig"] and _file_state["path"] == path:
        return
    _file_state["path"] = path
    _file_state["sig"] = sig
    if sig is None:
        _file_state["rules"] = []
    else:
        try:
            with open(path) as f:
                spec = f.read()
        except OSError:
            spec = ""
        _file_state["rules"] = parse_spec(spec)
        logger.warning("faultsim reloaded %s: %d rule(s) [self_id=%s]",
                       path, len(_file_state["rules"]), _SELF_ID)
    _rebuild()


_injection_counters: dict = {}


def record_injection(kind: str, method: str):
    """Account one injected fault: a metric
    (``rpc_faults_injected_total{kind=...}``) plus — when tracing is on —
    a point span in the task-event log, so a chaos-lane failure
    correlates with the exact faults injected around it in the SAME
    cluster snapshot (metrics + timeline). Called by rpcio at the
    injection sites; must never raise into the send path."""
    try:
        c = _injection_counters.get(kind)
        if c is None:
            from ray_tpu_torch._private import metrics_core

            c = _injection_counters[kind] = metrics_core.registry().counter(
                "rpc_faults_injected_total",
                "Faults injected by faultsim, by kind",
            ).labels(kind=kind)
        c.inc()
    except Exception:
        pass
    try:
        from ray_tpu_torch.util import tracing

        if tracing.is_enabled():
            now = time.time()
            tracing.record_remote_span(
                f"faultsim::{kind}", now, now,
                {"trace_id": f"faultsim-{os.getpid()}", "span_id": "fault"},
                attributes={"kind": kind, "method": method,
                            "self_id": _SELF_ID},
            )
    except Exception:
        pass


def active_plan() -> Optional[FaultPlan]:
    """The armed plan, or None (the common case, two attribute reads)."""
    global _DISARMED
    if _installed is not None:
        return _installed
    if _DISARMED:
        return None
    path = os.environ.get("RAY_TPU_TORCH_RPC_FAULTS_FILE")
    spec = os.environ.get("RAY_TPU_TORCH_RPC_FAULTS")
    if not path and not spec:
        if _PLAN is not None:
            clear()
        _DISARMED = True
        return None
    with _LOCK:
        _load_env()
        if path:
            now = time.monotonic()
            if now >= _file_state["next_check"]:
                _load_file(path, now)
        elif _file_state["rules"]:
            _file_state["rules"] = []
            _rebuild()
        return _PLAN
