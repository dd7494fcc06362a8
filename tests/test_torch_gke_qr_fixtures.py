"""The port's ``GkeQueuedResourceAPI`` against the reference's recorded
fixtures (``tests/fixtures/gke_qr``): the cases of
``tests/test_gke_qr_fixtures.py``, each request held to the golden
method, URL and body, each recorded response (or error) played back, no
network. The port keeps the reference's request shapes, so the reference's
own fixtures are its yardstick."""

import io
import json
import os
import urllib.error
import urllib.request

import pytest

from ray_tpu_torch.autoscaler.node_provider import GkeQueuedResourceAPI

_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "gke_qr")


def _load(name):
    with open(os.path.join(_FIXTURES, name + ".json")) as f:
        return json.load(f)


class _RecordedTransport:
    """urlopen stand-in that verifies each request against the golden
    fixture and plays back the recorded response (or error)."""

    def __init__(self, monkeypatch, *fixtures):
        self.expected = [_load(f) for f in fixtures]
        self.calls = 0
        monkeypatch.setattr(urllib.request, "urlopen", self)

    def __call__(self, req, timeout=None):
        assert self.calls < len(self.expected), "unexpected extra HTTP call"
        fx = self.expected[self.calls]
        self.calls += 1
        want = fx["request"]
        assert req.get_method() == want["method"]
        assert req.full_url == want["url"]
        body = json.loads(req.data.decode()) if req.data else None
        assert body == want["body"], (
            f"request body drift:\n got={json.dumps(body, indent=1)}\n"
            f"want={json.dumps(want['body'], indent=1)}"
        )
        # bearer token + content type always present
        assert req.get_header("Authorization", "").startswith("Bearer ")
        if "error" in fx:
            err = fx["error"]
            raise urllib.error.HTTPError(
                req.full_url, err["status"], "error", {},
                io.BytesIO(json.dumps(err["body"]).encode()),
            )

        class _Resp:
            def __enter__(self_inner):
                return self_inner

            def __exit__(self_inner, *a):
                return False

            def read(self_inner):
                return json.dumps(fx["response"]).encode()

        return _Resp()

    def assert_drained(self):
        assert self.calls == len(self.expected), (
            f"{len(self.expected) - self.calls} expected calls never made"
        )


@pytest.fixture
def api():
    return GkeQueuedResourceAPI(
        project="proj-1", zone="us-central2-b",
        token_provider=lambda: "tok-abc",
    )


def test_create_with_topology_uses_accelerator_config(api, monkeypatch):
    t = _RecordedTransport(monkeypatch, "create_topology")
    assert api.create("slice-a", "v5litepod-16", "4x4", 4) == "slice-a"
    t.assert_drained()


def test_create_unknown_generation_names_type(api, monkeypatch):
    """No generation enum for the family -> acceleratorType (the two are
    mutually exclusive in the v2 API)."""
    t = _RecordedTransport(monkeypatch, "create_plain_type")
    api.create("slice-b", "weird-8", "4x4", 1)
    t.assert_drained()


def test_status_state_mapping(api, monkeypatch):
    t = _RecordedTransport(
        monkeypatch, "status_active", "status_waiting", "status_suspended"
    )
    st = api.status("slice-a")
    assert st["state"] == "ACTIVE"
    assert len(st["hosts"]) == 2
    assert api.status("slice-a")["state"] == "PROVISIONING"
    assert api.status("slice-a")["state"] == "FAILED"
    t.assert_drained()


def test_delete(api, monkeypatch):
    t = _RecordedTransport(monkeypatch, "delete")
    api.delete("slice-a")
    t.assert_drained()


def test_quota_exhausted_surfaces(api, monkeypatch):
    _RecordedTransport(monkeypatch, "quota_exhausted")
    with pytest.raises(urllib.error.HTTPError) as err:
        api._call(
            "POST",
            f"{api.base}?queuedResourceId=slice-q",
        )
    assert err.value.code == 429


def test_missing_token_provider_is_a_clear_error():
    api = GkeQueuedResourceAPI(project="p", zone="z")
    with pytest.raises(RuntimeError, match="token_provider"):
        api.create("s", "v5litepod-8", None, 1)
