"""The port's counterpart of ``tests/test_runtime_env_plugins.py`` (9
cases), through ``ray_tpu_torch`` with the reference's expected values:
every case is carried under its own name. Port names: the class-path
variable ``RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS``, the wheelhouse variable
``RAY_TPU_TORCH_WHEELHOUSE``, the plugin module
``tests/torch_runtime_env_plugin_mod.py`` (the reference's imports
``ray_tpu``).

``test_custom_plugin_materializes_in_worker`` starts its own cluster, as
the reference's does, so that the raylet and its workers inherit the plugin
variable. The reference's case fails when its file follows one that left
the shared cluster up ("init() called twice"); the port's shuts down a
cluster this process left up first, and
``test_custom_plugin_materializes_after_a_cluster_was_left_up`` holds it to
that.

The reference's description:

Runtime-env plugin framework tests.

Analog of ray: python/ray/tests/test_runtime_env_plugin.py — custom
plugins register via the class-path env var, validate at option time,
and materialize inside worker processes; built-in keys ride the same
registry; unsupported keys still fail fast.
"""

import os

import pytest

import ray_tpu_torch

from tests.torch_fixtures import port_regular_fn  # noqa: F401


def test_custom_plugin_materializes_in_worker(monkeypatch):
    monkeypatch.setenv(
        "RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS",
        "tests.torch_runtime_env_plugin_mod:MarkerPlugin",
    )
    # a cluster left up by an earlier case was started without the plugin
    # variable: its raylet's workers would never load the plugin
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote(runtime_env={"marker": "hello-plugin"})
        def read_marker():
            return os.environ.get("RTPU_TEST_MARKER")

        assert ray_tpu_torch.get(read_marker.remote(),
                                 timeout=60) == "hello-plugin"

        # a worker of a DIFFERENT env (no marker) must not see it
        @ray_tpu_torch.remote
        def read_plain():
            return os.environ.get("RTPU_TEST_MARKER")

        assert ray_tpu_torch.get(read_plain.remote(), timeout=60) is None
    finally:
        ray_tpu_torch.shutdown()


def test_custom_plugin_materializes_after_a_cluster_was_left_up(monkeypatch):
    """The order dependence of the reference's case, played out: a cluster
    started without the plugin variable is still up when the case runs."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=1)
    test_custom_plugin_materializes_in_worker(monkeypatch)
    assert not ray_tpu_torch.is_initialized()


def test_plugin_validate_fails_fast():
    from ray_tpu_torch._private.runtime_env import (
        RuntimeEnvPlugin,
        prepare_runtime_env,
        register_runtime_env_plugin,
    )

    class Picky(RuntimeEnvPlugin):
        name = "picky"

        def validate(self, env):
            if env.get("picky") == "bad":
                raise ValueError("picky rejects bad")

    register_runtime_env_plugin(Picky())
    with pytest.raises(ValueError, match="picky rejects bad"):
        prepare_runtime_env(None, {"picky": "bad"})
    # good values pass through untouched
    assert prepare_runtime_env(None, {"picky": "good"})["picky"] == "good"


def test_malformed_container_still_raises_at_option_time():
    """container graduated from unsupported to a real plugin (worker
    wrapping); malformed specs must still fail at option time, not at
    spawn."""
    from ray_tpu_torch._private.runtime_env import prepare_runtime_env

    with pytest.raises(ValueError, match="image"):
        prepare_runtime_env(None, {"container": ["anything"]})
    out = prepare_runtime_env(None, {"container": {"image": "img:v1"}})
    assert out["container"]["image"] == "img:v1"


def test_pip_without_wheelhouse_raises_documented_error(monkeypatch):
    """Offline path: pip with no wheelhouse fails EARLY with the
    pre-download instructions, not at task time."""
    monkeypatch.delenv("RAY_TPU_TORCH_WHEELHOUSE", raising=False)
    from ray_tpu_torch._private.runtime_env import prepare_runtime_env

    with pytest.raises(ValueError, match="wheelhouse"):
        prepare_runtime_env(None, {"pip": ["somepkg"]})
    with pytest.raises(ValueError, match="pip download"):
        prepare_runtime_env(None, {"pip": ["somepkg"]})
    # missing directory is also an early error
    with pytest.raises(ValueError, match="not a directory"):
        prepare_runtime_env(
            None, {"pip": {"packages": ["p"], "wheelhouse": "/nope"}}
        )


def test_non_json_value_rejected_at_option_time():
    from ray_tpu_torch._private.runtime_env import prepare_runtime_env

    with pytest.raises(ValueError, match="JSON-serializable"):
        prepare_runtime_env(None, {"custom_blob": {1, 2}})


def test_env_vars_shape_validated():
    from ray_tpu_torch._private.runtime_env import prepare_runtime_env

    with pytest.raises(ValueError, match="env_vars"):
        prepare_runtime_env(None, {"env_vars": ["not", "a", "dict"]})


def _make_wheel(wheelhouse, name="rtpu_testwheel", version="1.0",
                body="MAGIC = 42\n"):
    """Hand-craft a minimal pure-Python wheel (a wheel is just a zip with
    dist-info metadata) so the test needs no network or build tooling."""
    import os
    import zipfile

    os.makedirs(wheelhouse, exist_ok=True)
    whl = os.path.join(wheelhouse, f"{name}-{version}-py3-none-any.whl")
    di = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", body)
        zf.writestr(
            f"{di}/METADATA",
            f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n",
        )
        zf.writestr(
            f"{di}/WHEEL",
            "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib: true\n"
            "Tag: py3-none-any\n",
        )
        zf.writestr(
            f"{di}/RECORD",
            f"{name}/__init__.py,,\n{di}/METADATA,,\n{di}/WHEEL,,\n"
            f"{di}/RECORD,,\n",
        )
    return whl


def test_pip_wheelhouse_env_end_to_end(port_regular_fn, tmp_path):
    """A task running under a pip runtime env imports a package that
    exists ONLY as a wheel in the local wheelhouse."""
    wheelhouse = str(tmp_path / "wheels")
    _make_wheel(wheelhouse)

    @ray_tpu_torch.remote(runtime_env={"pip": {"packages": ["rtpu_testwheel"],
                                               "wheelhouse": wheelhouse}})
    def use_wheel():
        import rtpu_testwheel

        return rtpu_testwheel.MAGIC

    assert ray_tpu_torch.get(use_wheel.remote(), timeout=120) == 42

    # the driver itself must NOT see the package (it lives in the
    # worker's venv, not the shared interpreter)
    import importlib.util

    assert importlib.util.find_spec("rtpu_testwheel") is None


def test_conda_named_env_activates(monkeypatch, tmp_path):
    """{'conda': 'name'}: an existing env's site-packages join sys.path
    worker-side; a missing env fails EARLY at validate (no conda binary
    on this image)."""
    import sys

    from ray_tpu_torch._private.runtime_env import (
        _CondaPlugin,
        prepare_runtime_env,
    )

    root = tmp_path / "miniconda"
    sp = root / "envs" / "myenv" / "lib" / "python3.12" / "site-packages"
    sp.mkdir(parents=True)
    (sp / "conda_shipped_mod.py").write_text("VALUE = 41\n")
    monkeypatch.setenv("CONDA_PREFIX", str(root))
    monkeypatch.delenv("CONDA_EXE", raising=False)

    env = prepare_runtime_env(None, {"conda": "myenv"})
    plugin = _CondaPlugin()
    try:
        plugin.materialize(None, env)
        import conda_shipped_mod

        assert conda_shipped_mod.VALUE == 41
    finally:
        sys.path[:] = [p for p in sys.path if str(sp) != p]
        sys.modules.pop("conda_shipped_mod", None)

    with pytest.raises(ValueError, match="no such .?env"):
        prepare_runtime_env(None, {"conda": "missing-env"})


def test_conda_spec_without_binary_raises(monkeypatch):
    monkeypatch.delenv("CONDA_EXE", raising=False)
    monkeypatch.setenv("PATH", "/usr/bin:/bin")
    from ray_tpu_torch._private.runtime_env import prepare_runtime_env

    with pytest.raises(ValueError, match="conda binary"):
        prepare_runtime_env(None, {"conda": {"dependencies": ["numpy"]}})
