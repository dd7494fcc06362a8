"""Typed runtime flag table, env-overridable.

Analog of the reference's RAY_CONFIG table (ray: src/ray/common/ray_config_def.h,
205 flags overridable via RAY_* env vars). Each flag is declared once with a
type and default; ``RAY_TPU_TORCH_<NAME>`` environment variables override, and an
explicit ``system_config`` dict (passed to ``init``) overrides both.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_FLAG_DEFS: Dict[str, tuple] = {}


def _flag(name: str, typ, default):
    _FLAG_DEFS[name] = (typ, default)
    return default


class _Config:
    """Singleton flag table. Access flags as attributes."""

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self.reset()

    def reset(self, system_config: Dict[str, Any] | None = None):
        self._values = {}
        for name, (typ, default) in _FLAG_DEFS.items():
            value = default
            env = os.environ.get(f"RAY_TPU_TORCH_{name}")
            if env is not None:
                value = self._parse(typ, env)
            self._values[name] = value
        if system_config:
            self.update(system_config)

    def update(self, overrides: Dict[str, Any]):
        for k, v in overrides.items():
            if k not in _FLAG_DEFS:
                raise ValueError(f"Unknown system config flag: {k}")
            typ, _ = _FLAG_DEFS[k]
            self._values[k] = self._parse(typ, v) if isinstance(v, str) else typ(v)

    @staticmethod
    def _parse(typ, raw: str):
        if typ is bool:
            return raw.lower() in ("1", "true", "yes")
        if typ in (dict, list):
            return json.loads(raw)
        return typ(raw)

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)


# --- flag declarations -------------------------------------------------------
# Scheduling
_flag("max_pending_lease_requests_per_scheduling_category", int, 10)
_flag("scheduler_spread_threshold", float, 0.5)
_flag("scheduler_top_k_fraction", float, 0.2)
_flag("max_spillback_depth", int, 10)
_flag("worker_lease_timeout_ms", int, 30_000)
# Topology-aware gang scheduling (topology.py): nodes advertise torus
# coordinates via labels (torus-coord="0x1[x2]", torus-dims="4x4[x8]" —
# TPU-style "x" separators keep the labels wire-safe for the native
# scheduler), synthesized here from per-node env/config the way the
# reference synthesizes TPU slice topology. Placement-group scheduling
# then scores candidate placements by ring-allreduce link overlap
# against committed gangs and prefers torus-aligned contiguous slices;
# clusters with no coords advertised take the resource-fit path
# untouched.
_flag("sched_topology_enabled", bool, True)
_flag("torus_coord", str, "")  # this node's "0x1[x2]" (per-node env)
_flag("torus_dims", str, "")  # the torus extent "4x4[x8]"
_flag("sched_max_candidates", int, 32)  # slice windows scored per gang
_flag("sched_repack_max_moves", int, 8)  # bundle migrations per repack
# Workers
_flag("num_workers_soft_limit", int, 16)
_flag("worker_register_timeout_s", float, 60.0)
_flag("idle_worker_killing_time_threshold_ms", int, 300_000)
_flag("prestart_worker_first_driver", bool, False)
_flag("worker_niceness", int, 0)
# Objects
_flag("max_direct_call_object_size", int, 100 * 1024)  # inline threshold (ray: 100KB)
_flag("object_store_memory", int, 2 * 1024**3)
_flag("object_store_eviction_fraction", float, 0.8)
# Slab-arena object plane (slab_arena.py): leased write slabs + shared
# index instead of one file per object. RAY_TPU_TORCH_slab_arena=0 restores the
# legacy per-object-file data path (and with it the native C++ writer).
_flag("slab_arena", bool, True)
_flag("slab_size_bytes", int, 16 * 1024 * 1024)  # default lease ceiling
_flag("slab_min_lease_bytes", int, 1024 * 1024)  # first lease of a worker
_flag("slab_index_slots", int, 1 << 16)  # shared index capacity (~4MB)
_flag("object_transfer_chunk_bytes", int, 8 * 1024 * 1024)
# concurrent chunk requests per pull (raylet._fetch_from): one request at
# a time is latency-bound (the reason push outran pull); the window's
# chunks land out of order at their offsets in the reserved slab entry
_flag("fetch_pipeline_depth", int, 4)
# the FIRST fetch request (which discovers total size + metadata) asks
# for at most this much: a full-size head chunk is a serial prefix the
# pipeline can't overlap, while a small head reveals the size after a
# fraction of a chunk and the concurrent window covers the rest
_flag("fetch_head_chunk_bytes", int, 1 << 20)
_flag("object_pull_timeout_s", float, 60.0)
_flag("fetch_warn_timeout_s", float, 10.0)
# Hole-punch reclamation (object_store.punch_holes): a periodic raylet
# pass fallocate(PUNCH_HOLE|KEEP_SIZE)s the page-aligned interior of
# dead entry ranges in sealed segments above the fragmentation
# threshold, returning tmpfs pages without waiting for whole-segment
# emptiness. KEEP_SIZE preserves the mapping, so live zero-copy readers
# keep their views; flock-pinned and pooled segments are skipped.
_flag("slab_punch_enabled", bool, True)
_flag("slab_punch_interval_s", float, 30.0)
_flag("slab_punch_min_fragmentation", float, 0.25)
_flag("slab_punch_min_bytes", int, 1 << 20)
# Pull admission + spilling (ray: pull_manager.h:56, local_object_manager.h:40)
_flag("max_concurrent_pulls", int, 8)
_flag("pull_manager_memory_fraction", float, 0.5)
_flag("object_spill_dir", str, "")  # path or storage URI (file://, s3://, ...)
# staging root for mid-spill .obj copies; "" = the spill destination's
# own filesystem when local, else the system temp dir (often tmpfs —
# point this at real disk for non-local backends under memory pressure)
_flag("spill_staging_dir", str, "")
# module imported by the raylet before building its store — the hook for
# register_external_storage_scheme plugins (custom spill backends)
_flag("external_storage_setup_module", str, "")
# engine for runtime_env={"container": ...} worker wrapping (a name on
# PATH or an absolute path; tests point this at a fake engine)
_flag("container_runtime", str, "podman")
# Health / fault tolerance
_flag("heartbeat_interval_s", float, 0.5)
_flag("node_death_timeout_s", float, 10.0)
_flag("gcs_rpc_timeout_s", float, 30.0)
_flag("task_retry_delay_ms", int, 100)
_flag("actor_restart_delay_ms", int, 100)
# Reference counting / lineage (ray: reference_count.h, object_recovery_manager.h)
_flag("borrower_poll_timeout_s", float, 600.0)
_flag("borrower_poll_retries", int, 6)
_flag("max_lineage_cache_entries", int, 4096)
_flag("max_object_reconstructions", int, 3)
# GCS fault tolerance (ray: gcs_server.h:101-107 StorageType,
# gcs_failover_worker_reconnect_timeout ray_config_def.h:62)
_flag("gcs_failover_reconnect_timeout_s", float, 10.0)
_flag("gcs_client_reconnect_timeout_s", float, 60.0)
_flag("gcs_store_fsync", bool, False)
# Memory monitor (ray: common/memory_monitor.h:52, worker_killing_policy.h)
_flag("memory_usage_threshold", float, 0.95)
_flag("memory_monitor_refresh_ms", int, 250)
_flag("memory_monitor_test_path", str, "")  # test injection: file with a float
# On-demand profiling (profiler.py: sampled CPU flamegraphs + mem diffs)
_flag("profiler_default_hz", float, 100.0)
_flag("profiler_max_hz", float, 1000.0)
# sampling self-throttles when (time spent sampling / wall time) would
# exceed this fraction — attaching to a loaded worker stays <5% overhead
_flag("profiler_max_overhead_fraction", float, 0.05)
_flag("profiler_max_duration_s", float, 600.0)
_flag("profiler_mem_top_n", int, 30)
_flag("profiler_mem_frames", int, 8)
# GCS remote-KV persistence put pipeline (gcs_store.RemoteKvStore): puts
# are queued onto the kv io thread (ordered, batched) so a slow KV server
# never blocks the GCS event loop; a failed flush trips a circuit breaker
# into the degraded no-persist posture for the cooldown.
_flag("gcs_kv_put_timeout_s", float, 5.0)
_flag("gcs_kv_queue_max", int, 10_000)
_flag("gcs_kv_breaker_cooldown_s", float, 30.0)
# Metrics / events (metrics_core.py: per-process counters/gauges/log2
# histograms behind the metrics_snapshot fan-out + /metrics scrape)
_flag("metrics_enabled", bool, True)  # master switch (overhead A/B lane)
# dashboard head: cadence + depth of the in-head snapshot ring buffer the
# SPA Metrics tab draws its sparkline time-series from
_flag("metrics_history_interval_s", float, 5.0)
_flag("metrics_history_len", int, 120)
# cluster scrape budget: per-node fan-out timeout inside metrics_cluster
_flag("metrics_scrape_timeout_s", float, 10.0)
_flag("metrics_report_interval_s", float, 2.0)
_flag("task_events_buffer_size", int, 10_000)
_flag("event_stats", bool, True)
# Worker-log streaming to drivers (ray: log_monitor.py tail cadence +
# worker.py print_logs). log_to_driver is the master gate for the driver
# subscription (RAY_TPU_TORCH_LOG_TO_DRIVER=0 kills it cluster-wide); raylets
# additionally skip tailing entirely while the GCS reports zero "logs"
# subscribers, so an unwatched cluster pays nothing for the log plane.
_flag("log_tail_interval_s", float, 0.3)
_flag("log_to_driver", bool, True)
# driver-side dedup: identical lines fanning in from many workers within
# this window collapse to one line + "[repeated Nx]" summary
_flag("log_dedup_window_s", float, 1.0)
# length caps on published records: lines longer than this are truncated
# (counted in raylet_log_lines_truncated_total), and one publish batch
# never carries more than log_publish_max_bytes of line payload per tick
# (excess lines defer to the next tick via the tail offset)
_flag("log_max_line_bytes", int, 4096)
_flag("log_publish_max_bytes", int, 2 * 1024 * 1024)
# closed per-task byte-range attribution spans kept per worker for the
# tailer's line -> task-name resolution (bounded ring)
_flag("log_span_history", int, 128)
# Push plane (ray: push_manager.h max_chunks_in_flight per push)
_flag("push_max_chunks_in_flight", int, 8)
_flag("push_rx_expiry_s", float, 60.0)  # abandoned inbound push sessions
# Idle workers spawned at raylet boot (ray: prestart_worker_first_driver)
_flag("worker_prestart", int, 2)
# Direct task push over worker leases (ray: direct_task_transport.cc)
_flag("direct_task_leases", bool, True)
# blocked get() diagnostics: after this many seconds waiting on one ref, log
# a WARNING with the direct-push transport state (and append it to
# RAY_TPU_TORCH_STALL_DUMP_FILE if set). 0 disables.
_flag("get_stall_dump_s", float, 30.0)
_flag("direct_lease_pipeline_depth", int, 4)  # in-flight tasks per lease
_flag("direct_lease_max", int, 16)  # leases per scheduling class per driver
_flag("direct_lease_linger_s", float, 0.5)  # idle hold before lease return
# grace-period return: after the class queue drains (and the feeders'
# linger expires) the pump HOLDS its leases this long before returning
# them, so the next burst rides the already-open lease conns with zero
# raylet round trips. 0 restores return-on-drain (A/B lever).
_flag("direct_lease_grace_s", float, 0.5)
_flag("direct_push_batch_max", int, 64)  # specs per execute_task_batch frame
# idle hold before a per-actor direct sender exits: a sync call loop
# reuses the standing sender (and its pipelined conn) instead of paying
# a task spawn + warm-up tick per call. 0 restores exit-on-drain.
_flag("actor_sender_linger_s", float, 0.5)
# submit_batch ack mode: "batch" = the raylet acks frame ACCEPTANCE and
# schedules in the background (fire-and-forget lane; per-task failures
# surface via the owner's task_result stream + task events), "spec" =
# legacy ack-after-scheduling (A/B lever)
_flag("submit_ack_mode", str, "batch")
# control-plane stage timing (BENCH_CONTROL_PLANE): per-stage histograms
# (envelope build, id mint, result return, submit->run) on the submit
# path; off = one attr check per call
_flag("control_plane_stage_timing", bool, False)
# observability/GC debounce windows. A sync submit->get loop otherwise
# generates one task_events notify (worker->raylet) and one free_objects
# chain (driver->raylet->GCS) PER CALL — on a small box that background
# traffic competes with the call's own round trip for CPU. Events/frees
# buffer for the window and ship as one frame. 0 restores flush-per-tick
# (A/B lever); exit paths still drain synchronously.
_flag("task_events_flush_interval_s", float, 0.02)
_flag("free_flush_interval_s", float, 0.005)
# batch frames in flight per actor sender: >1 keeps the pipe full while the
# next burst accumulates behind it (unbounded pipelining would drain the
# queue one spec at a time and never form a batch)
_flag("actor_direct_max_inflight", int, 2)
_flag("direct_actor_calls", bool, True)  # push actor calls to the worker
# Dispatch / scheduling cadence (raylet loops)
_flag("dispatch_retry_interval_s", float, 0.01)
_flag("infeasible_retry_interval_s", float, 0.5)
_flag("pull_location_poll_interval_s", float, 0.1)
_flag("actor_route_wait_alive_timeout_s", float, 30.0)
# Driver-side get/wait cadence
_flag("wait_poll_interval_s", float, 0.05)
_flag("deferred_release_wait_s", float, 0.5)
_flag("worker_dump_stacks_timeout_s", float, 10.0)
# GCS scheduling retry cadence (actor placement / PG)
_flag("gcs_schedule_retry_interval_s", float, 0.2)
# Per-node dashboard agent (ray: dashboard/agent.py)
_flag("enable_node_agent", bool, True)
# Step observatory (steptrace.py): per-step trainer/collective telemetry.
# steptrace_enabled gates every record path (zero-cost off, same posture
# as metrics_enabled); the ring holds the newest steptrace_ring_size
# records per process (a dropped-old-records counter rides the snapshot).
_flag("steptrace_enabled", bool, True)
_flag("steptrace_ring_size", int, 8192)
# per-node fan-out timeout inside steptrace_cluster
_flag("steptrace_scrape_timeout_s", float, 10.0)
# Memory observatory (memview.py): object lifecycle + arena
# introspection + leak attribution. memview_enabled gates every record
# path (creation-callsite stamping at put(), the spill/restore/transfer
# flow ring) — zero-cost off, same posture as metrics/steptrace.
_flag("memview_enabled", bool, True)
_flag("memview_track_max", int, 8192)  # creation records kept per process
_flag("memview_flow_ring_size", int, 2048)  # flow events kept per process
# per-node fan-out timeout inside memview_cluster
_flag("memview_scrape_timeout_s", float, 10.0)
# Collective / device plane
_flag("collective_timeout_s", float, 120.0)
# Chunked pipeline transport for large store-path allreduces: tensors
# bigger than this are reduce-scattered + allgathered in fixed-size
# chunks (each chunk its own rendezvous sub-key under the op's seq),
# with reduction of chunk N overlapping transport of chunk N+1.
# 0 disables chunking (monolithic single-payload _phase, today's path).
_flag("collective_chunk_bytes", int, 1 << 20)
# in-flight chunk fetches per fetch kind (contribution fetches and
# reduced-chunk fetches each get their own window of this depth, so
# waits on unfinalized reduced chunks can never starve the contribution
# fetches finalization depends on) — the pipeline depth that buys
# transport/reduce overlap
_flag("collective_pipeline_depth", int, 4)
# EQuARX-style block-wise quantization for SUM/MEAN allreduce: "" (off)
# or "int8" (per-chunk symmetric scale + int8 wire). Group-level opt-in
# via create_collective_group(..., quant=) overrides this default.
_flag("collective_quant", str, "")
# straggler-tolerant chunk scheduling: when a peer's EWMA arrival lag
# (seconds behind the fastest peer, measured from receiver-local chunk
# wait times — never cross-host timestamps) exceeds this, its chunks
# are fetched LAST so the bounded pipeline windows stay busy on ranks
# that have already published. 0 (the default) disables reordering
# (FIFO rank order); set well above the transport's RPC round-trip
# floor when enabling.
_flag("collective_straggler_threshold", float, 0.0)
# probe the node's CUDA cards with ``nvidia-smi -L`` when
# CUDA_VISIBLE_DEVICES does not say (the reference's tpu_autodetect)
_flag("gpu_autodetect", bool, False)
# RPC substrate (ray: grpc_server.h / client channel args)
_flag("rpc_max_message_bytes", int, 1 << 31)
# wire frame format: 3 = out-of-band buffer table + CRC32 head trailer,
# 2 = out-of-band buffer table (zero-copy payload buffers), 1 = legacy
# in-band pickle frames. Clients dialing high fall back one version per
# redial when the server doesn't ack it. The v3 CRC covers the frame head
# (count byte + buffer table + envelope): corrupted control data is
# detected and the connection reset instead of unpickling garbage;
# out-of-band payload buffers stay CRC-free (checksumming multi-MB tensors
# would re-scan the memory the zero-copy path exists to avoid).
_flag("rpc_frame_version", int, 3)
# payload buffers at least this big ride v2 frames out-of-band; smaller
# ones stay in the pickle envelope (a table entry + unjoined write costs
# more than a tiny memcpy)
_flag("rpc_oob_min_bytes", int, 512)
_flag("rpc_auth_timeout_s", float, 10.0)
_flag("rpc_connect_retries", int, 30)
# connect() retry backoff: delay starts at rpc_connect_retry_delay_s,
# doubles per attempt, caps at rpc_connect_backoff_max_s (with jitter).
# Budget check: 30 retries = ~3s of doubling + 27 capped waits ≈ 57s
# worst-case, inside gcs_client_reconnect_timeout_s (60s).
_flag("rpc_connect_retry_delay_s", float, 0.1)
_flag("rpc_connect_backoff_max_s", float, 2.0)
# default deadline for Connection.request() when the caller passes no
# timeout — no control-plane RPC may hang forever on a silent peer.
# Long-poll methods (borrower polls, waits) pass explicit timeouts.
_flag("rpc_request_timeout_s", float, 120.0)
# call_with_retries backoff envelope (idempotent control-plane calls and
# token-carrying side-effectful ones)
_flag("rpc_retry_attempts", int, 5)
_flag("rpc_retry_base_delay_s", float, 0.1)
_flag("rpc_retry_max_delay_s", float, 2.0)
# keepalive: ping idle connections every interval; a peer silent for the
# timeout is declared dead (black-holed peers surface in O(timeout)
# instead of hanging a request forever). 0 disables. v3+ sessions only.
_flag("rpc_keepalive_interval_s", float, 2.0)
_flag("rpc_keepalive_timeout_s", float, 20.0)
# Serve (ray: serve/_private defaults)
_flag("serve_control_loop_period_s", float, 0.25)
_flag("serve_default_graceful_shutdown_timeout_s", float, 5.0)
# Handle-side routing staleness guard: replica-reported queue lengths
# older than this are IGNORED by power-of-two-choices scoring (local
# inflight counts only) — a wedged controller's stale snapshot must not
# keep steering traffic at a replica that has since filled up.
_flag("serve_replica_report_max_age_s", float, 5.0)
# LLM serving engine (serve/llm): continuous batching over an arena-
# paged KV cache with prefix-affinity routing. serve_llm_enabled=0
# disables every LLM-specific code path (handle-side prefix biasing,
# LLMServer construction); plain deployments never touch these either
# way. Page geometry: page_tokens tokens per page, kv_dim float32s per
# token; kv_pages is the per-replica page budget admission control
# guards. prefix_digest_max caps the chain hashes a replica reports in
# the controller load probe (wire-size bound on the affinity signal).
_flag("serve_llm_enabled", bool, True)
_flag("serve_llm_page_tokens", int, 16)
_flag("serve_llm_kv_dim", int, 64)
_flag("serve_llm_kv_pages", int, 512)
_flag("serve_llm_max_running", int, 8)
_flag("serve_llm_max_queued", int, 32)
_flag("serve_llm_prefix_cache_pages", int, 128)
_flag("serve_llm_prefix_digest_max", int, 256)
_flag("serve_llm_real_model", bool, False)
# Request observatory (reqtrace.py): per-request serve phase tracing.
# reqtrace_enabled gates every record path (zero-cost off, same posture
# as metrics/steptrace/memview); the ring holds the newest
# reqtrace_ring_size records per process (drop accounting rides the
# snapshot).
_flag("reqtrace_enabled", bool, True)
_flag("reqtrace_ring_size", int, 8192)
# per-node fan-out timeout inside reqtrace_cluster
_flag("reqtrace_scrape_timeout_s", float, 10.0)
# Tune (ray: tune/execution/experiment_state.py checkpoint period)
_flag("tune_experiment_snapshot_period_s", float, 10.0)
# Train (ray: train/_internal/backend_executor timeouts)
_flag("train_worker_start_timeout_s", float, 300.0)
_flag("train_result_poll_timeout_s", float, 900.0)
# Train fault tolerance (gang supervision + checkpointed recovery)
# interval between liveness pings / health polls of the worker gang
_flag("train_health_check_interval_s", float, 1.0)
# a rank that reports no step progress for this long is declared wedged
# (0 disables the progress watchdog; only liveness pings run)
_flag("train_progress_timeout_s", float, 0.0)
# master switch: tear down + re-place + restore-from-checkpoint on failure
# (off -> legacy behavior: surface the error to the trainer retry loop)
_flag("train_recovery_enabled", bool, True)
# SIGTERM drain: how long a worker may run past the signal to reach the
# next step boundary and checkpoint before it hard-exits
_flag("train_drain_grace_s", float, 30.0)
# In-graph gradient collective mode for build_train_step: "" lets the
# XLA partitioner insert the reduction from shardings (default,
# byte-identical to the pre-flag path); "chunked" splits the psum into
# train_ingraph_psum_chunks collectives for latency hiding; "quantized"
# rides the int8 wire format (parallel/collectives.py twins). Usually
# set per-run via JaxConfig(ingraph_psum=...), which fans it out to the
# worker gang.
_flag("train_ingraph_psum", str, "")
_flag("train_ingraph_psum_chunks", int, 4)


GLOBAL_CONFIG = _Config()
