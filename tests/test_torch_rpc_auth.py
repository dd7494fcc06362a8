"""The port's counterpart of ``tests/test_rpc_auth.py`` (2 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

The reference's description:

RPC auth: pickle frames are only read from authenticated peers
(rpcio preamble; plays the reference's cluster-auth-token role).
"""

import pickle
import socket

import ray_tpu_torch

from tests.torch_fixtures import port_regular  # noqa: F401


def test_unauthenticated_peer_rejected(port_regular):
    """A raw TCP client that skips the auth preamble must be disconnected
    without its pickle frame ever being dispatched."""
    import os

    from ray_tpu_torch._private.worker import global_worker

    assert os.environ.get("RAY_TPU_TORCH_CLUSTER_TOKEN"), (
        "head start must have generated a cluster token"
    )
    host, port = global_worker.core_worker.gcs_addr

    # The server holds a garbage (non-preamble) connection until
    # rpc_auth_timeout_s (10s) elapses before closing; the client must
    # wait comfortably PAST that or this test is a 10s-vs-10s coin flip
    # on a loaded box.
    s = socket.create_connection((host, port), timeout=25)
    s.settimeout(25)
    try:
        payload = pickle.dumps((1, 0, "kv_keys", {"prefix": ""}), protocol=5)
        s.sendall(len(payload).to_bytes(4, "little") + payload)
        # server must close without replying (the frame is not a preamble)
        got = b""
        try:
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    break
                got += chunk
        except socket.timeout:
            raise AssertionError(
                "server kept an unauthenticated connection open"
            )
        assert got == b"", f"server answered an unauthenticated peer: {got!r}"
    finally:
        s.close()


def test_authenticated_cluster_still_works(port_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    assert ray_tpu_torch.get(f.remote(21), timeout=60) == 42
