"""External-env sampling: train from environments that live OUTSIDE the
cluster (a game server, a web service, a robot loop).

Reference parity: ray rllib/env/policy_server_input.py +
policy_client.py — the application owns the env loop and talks to a
policy server over HTTP: ``start_episode`` / ``get_action`` /
``log_returns`` / ``end_episode``. The server runs inference with the
latest trained weights (server-side inference mode), records the
transitions, and hands them to the algorithm as ordinary sample batches,
so any off-policy algorithm trains from external traffic unchanged.

Wiring: ``config.env_runners(num_env_runners=N,
policy_server_port=9900)`` replaces the env-stepping runners with
``PolicyServerRunner`` actors listening on consecutive ports
(9900+i). The config's env is probed once for spaces only — it is never
stepped.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import env_spaces, make_env
from ray_tpu_torch.rllib.rl_module import RLModule
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class PolicyServerRunner:
    """Drop-in for EnvRunner whose transitions come from external
    PolicyClients instead of an in-process env loop. Same actor surface:
    sample / get_metrics / set_weights / connector state / evaluate."""

    def __init__(self, env_spec, env_config, module_kwargs: Dict,
                 seed: int = 0, observation_filter=None,
                 host: str = "127.0.0.1", port: int = 9900):
        torch.set_num_threads(1)
        probe = make_env(env_spec, env_config)
        obs_shape, num_actions = env_spaces(probe)
        if hasattr(probe, "close"):
            probe.close()
        self._obs_dim = int(np.prod(obs_shape))
        self.module = RLModule(obs_shape, num_actions, seed=seed,
                               device="cpu", **module_kwargs)
        self._gen = torch.Generator().manual_seed(seed)
        self._lock = threading.Lock()
        self._episodes: Dict[str, dict] = {}
        self._transitions: List[dict] = []
        self._completed: List[dict] = []
        # evaluate() reads this; get_metrics drains _completed, so eval
        # needs its own non-draining record of recent client episodes
        from collections import deque

        self._recent_returns = deque(maxlen=64)
        self._have = threading.Condition(self._lock)
        self._server, self.port = self._start_http(host, port)

    # -- HTTP plumbing --------------------------------------------------
    def _start_http(self, host: str, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass  # client chatter must not spam the runner log

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    out = outer._dispatch(self.path, payload)
                    body = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 -> client error
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=server.serve_forever, daemon=True,
                         name="policy-server").start()
        return server, server.server_address[1]

    def _dispatch(self, path: str, p: dict):
        if path == "/start_episode":
            eid = uuid.uuid4().hex[:16]
            with self._lock:
                self._episodes[eid] = {"obs": None, "action": None,
                                       "reward_acc": 0.0, "return": 0.0,
                                       "len": 0}
            return {"episode_id": eid}
        eid = p["episode_id"]
        if path == "/get_action":
            obs = np.asarray(p["observation"], np.float32)
            action = self._infer(obs)
            with self._have:
                ep = self._episodes[eid]
                if ep["obs"] is not None:
                    self._record_locked(ep, obs, done=False)
                ep["obs"], ep["action"] = obs, action
            return {"action": int(action)}
        if path == "/log_returns":
            with self._lock:
                ep = self._episodes[eid]
                ep["reward_acc"] += float(p["reward"])
                ep["return"] += float(p["reward"])
        elif path == "/end_episode":
            obs = np.asarray(p["observation"], np.float32)
            with self._have:
                ep = self._episodes.pop(eid)
                if ep["obs"] is not None:
                    self._record_locked(ep, obs, done=True)
                self._completed.append(
                    {"return": ep["return"], "len": ep["len"]}
                )
                self._recent_returns.append(ep["return"])
        else:
            raise ValueError(f"unknown endpoint {path!r}")
        return {}

    def _record_locked(self, ep: dict, next_obs, done: bool):
        self._transitions.append({
            "obs": ep["obs"], "action": ep["action"],
            "reward": ep["reward_acc"], "next_obs": next_obs,
            "done": done,
        })
        ep["reward_acc"] = 0.0
        ep["len"] += 1
        self._have.notify_all()

    def _infer(self, obs) -> int:
        # handlers run on ThreadingHTTPServer threads: a draw advances the
        # generator, so concurrent clients take turns
        with self._lock:
            a, _logp, _v = self.module.action_exploration(obs[None, :],
                                                          self._gen)
        return int(a[0])

    # -- runner surface -------------------------------------------------
    def sample(self, num_steps: int,
               timeout_s: float = 300.0) -> SampleBatch:
        """Block until external clients have produced ``num_steps``
        transitions (ray parity: PolicyServerInput.next blocks on the
        queue), then hand them over as an off-policy SampleBatch."""
        deadline = time.monotonic() + timeout_s
        with self._have:
            while len(self._transitions) < num_steps:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break  # partial batch beats a dead train loop
                self._have.wait(timeout=min(remaining, 1.0))
            out, self._transitions = (
                self._transitions[:num_steps],
                self._transitions[num_steps:],
            )
        if not out:
            # placeholder must carry the REAL obs width: the replay
            # buffer's storage shapes latch onto the first batch it sees
            return SampleBatch({
                sb.OBS: np.zeros((0, self._obs_dim), np.float32),
                sb.NEXT_OBS: np.zeros((0, self._obs_dim), np.float32),
                sb.ACTIONS: np.zeros((0,), np.int32),
                sb.REWARDS: np.zeros((0,), np.float32),
                sb.DONES: np.zeros((0,), np.bool_),
                sb.TRUNCATEDS: np.zeros((0,), np.bool_),
            })
        return SampleBatch({
            sb.OBS: np.stack([t["obs"] for t in out]).astype(np.float32),
            sb.NEXT_OBS: np.stack(
                [t["next_obs"] for t in out]
            ).astype(np.float32),
            sb.ACTIONS: np.asarray([t["action"] for t in out], np.int32),
            sb.REWARDS: np.asarray([t["reward"] for t in out], np.float32),
            sb.DONES: np.asarray([t["done"] for t in out], np.bool_),
            sb.TRUNCATEDS: np.zeros(len(out), np.bool_),
        })

    def get_metrics(self) -> Dict[str, float]:
        with self._lock:
            eps, self._completed = self._completed, []
        if not eps:
            return {"episodes_this_iter": 0}
        returns = [e["return"] for e in eps]
        return {
            "episodes_this_iter": len(eps),
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_max": float(np.max(returns)),
            "episode_return_min": float(np.min(returns)),
            "episode_len_mean": float(np.mean([e["len"] for e in eps])),
        }

    def set_weights(self, params):
        # the weights are copied in place: not under a client's forward
        with self._lock:
            self.module.set_state(params)
        return True

    def address(self):
        return self._server.server_address

    def ping(self):
        return True

    # connector surface (external clients own their observations;
    # filtering happens client-side if at all)
    def get_connector_state(self):
        return None

    def pop_connector_delta(self):
        return None

    def set_connector_state(self, _state):
        return True

    def evaluate(self, episodes: int) -> float:
        """External envs can't be rolled out on demand; report the mean
        of the most recent client-driven episodes instead (ray parity:
        external-env metrics come only from client reports). Reads the
        non-draining record — get_metrics clears _completed every train
        iteration, which would leave this NaN."""
        with self._lock:
            eps = list(self._recent_returns)[-episodes:]
        if not eps:
            return float("nan")
        return float(np.mean(eps))

    def shutdown(self):
        try:
            self._server.shutdown()
        except Exception:
            pass


class PolicyClient:
    """The application-side half (ray parity: rllib/env/policy_client.py,
    server-side inference mode): a plain-HTTP client an external env loop
    embeds; no ray_tpu_torch import needed beyond this class."""

    def __init__(self, address: str, timeout_s: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout_s = timeout_s

    def _call(self, path: str, payload: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(
            self.address + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read() or b"{}")

    def start_episode(self) -> str:
        return self._call("/start_episode", {})["episode_id"]

    def get_action(self, episode_id: str, observation) -> int:
        return self._call("/get_action", {
            "episode_id": episode_id,
            "observation": np.asarray(observation).tolist(),
        })["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._call("/log_returns", {"episode_id": episode_id,
                                    "reward": float(reward)})

    def end_episode(self, episode_id: str, observation) -> None:
        self._call("/end_episode", {
            "episode_id": episode_id,
            "observation": np.asarray(observation).tolist(),
        })
