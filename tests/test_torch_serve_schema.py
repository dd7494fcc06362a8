"""The port's counterpart of ``tests/test_serve_schema.py`` (3 cases),
through ``ray_tpu_torch.serve`` with the reference's expected values: every
case is carried under its own name, on ``port_regular`` where the reference
takes ``ray_start_regular``. The import paths name the port's copy of the
reference's application module, ``tests/torch_serve_test_app.py``.

The reference's description:

Declarative Serve deploy (schema + deploy_config + CLI path).

ray parity: serve/schema.py ServeDeploySchema, `serve deploy`,
_private/application_state.py persisted configs.
"""

import pytest

from ray_tpu_torch import serve
from ray_tpu_torch.serve.schema import ServeDeploySchema

from tests.torch_fixtures import port_regular  # noqa: F401


def test_schema_validation():
    with pytest.raises(ValueError, match="applications"):
        ServeDeploySchema.from_dict({})
    with pytest.raises(ValueError, match="duplicate"):
        ServeDeploySchema.from_dict({"applications": [
            {"name": "a", "import_path": "m:x"},
            {"name": "a", "import_path": "m:y"},
        ]})
    with pytest.raises(ValueError, match="unknown deployment config"):
        ServeDeploySchema.from_dict({"applications": [
            {"name": "a", "import_path": "m:x",
             "deployments": [{"name": "d", "bogus": 1}]},
        ]})
    s = ServeDeploySchema.from_dict({"applications": [
        {"name": "a", "import_path": "m:x", "route_prefix": "/a",
         "deployments": [{"name": "d", "num_replicas": 3}]},
    ]})
    assert s.to_dict()["applications"][0]["deployments"][0]["num_replicas"] == 3


def test_deploy_config_and_status(port_regular):
    config = {"applications": [{
        "name": "echo_app",
        "import_path": "tests.torch_serve_test_app:app",
        "route_prefix": "/echo",
        "deployments": [{"name": "Echo", "num_replicas": 2}],
    }]}
    deployed = serve.deploy_config(config)
    assert deployed == ["echo_app"]

    # Overrides took effect: 2 replicas of Echo.
    status = serve.status()
    assert "echo_app" in status
    # persisted config readable from any client
    assert serve.get_deployed_config()["applications"][0]["name"] == "echo_app"

    # The app answers over HTTP on its route prefix.
    import urllib.request

    port = serve.http_port()
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/echo?m=hi", timeout=30
    ) as resp:
        import json

        assert json.loads(resp.read())["echo"] == "hi"

    # App-builder import path (module:function) also deploys.
    config2 = {"applications": [{
        "name": "built_app",
        "import_path": "tests.torch_serve_test_app:app_builder",
        "route_prefix": "/built",
    }]}
    assert serve.deploy_config(config2) == ["built_app"]
    serve.shutdown()


def test_build_emits_config(port_regular):
    from tests.torch_serve_test_app import app

    cfg = serve.build(app, name="myapp")
    assert cfg["name"] == "myapp"
    assert cfg["deployments"][0]["name"] == "Echo"
    # emitted config round-trips through the schema with a real import_path
    cfg["import_path"] = "tests.torch_serve_test_app:app"
    ServeDeploySchema.from_dict({"applications": [cfg]})
