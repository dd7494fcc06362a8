"""The port's counterpart of ``tests/test_runtime_env.py`` (5 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name, on ``port_regular`` (the reference's module
takes a fresh ``ray_start_regular`` and shuts it down; so does this one).
The wheelhouse variable is the port's, ``RAY_TPU_TORCH_WHEELHOUSE``.

The reference's description:

Runtime env materialization: working_dir + py_modules + env_vars.

ray parity: python/ray/tests/test_runtime_env_working_dir.py — a task's
runtime_env ships local code/data to the worker that runs it.
"""

import os

import pytest

import ray_tpu_torch

from tests.torch_fixtures import port_regular  # noqa: F401


def test_working_dir_ships_files(port_regular, tmp_path):
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "data.txt").write_text("shipped-payload")
    (wd / "helper.py").write_text("VALUE = 41\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(wd)})
    def read_back():
        # cwd is the materialized working_dir...
        with open("data.txt") as f:
            content = f.read()
        # ...and it is importable
        import helper

        return content, helper.VALUE + 1

    content, value = ray_tpu_torch.get(read_back.remote(), timeout=120)
    assert content == "shipped-payload"
    assert value == 42


def test_py_modules_importable(port_regular, tmp_path):
    mod = tmp_path / "shiny_mod"
    mod.mkdir()
    (mod / "__init__.py").write_text("def answer():\n    return 7\n")

    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(mod)]})
    def use_module():
        import shiny_mod

        return shiny_mod.answer()

    assert ray_tpu_torch.get(use_module.remote(), timeout=120) == 7


def test_env_vars_and_pool_isolation(port_regular, tmp_path):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_FLAG": "on"}})
    def with_flag():
        return os.environ.get("MY_FLAG")

    @ray_tpu_torch.remote
    def without_flag():
        return os.environ.get("MY_FLAG")

    assert ray_tpu_torch.get(with_flag.remote(), timeout=120) == "on"
    # a different env hash means a different worker pool: no leakage
    assert ray_tpu_torch.get(without_flag.remote(), timeout=120) is None


def test_unsupported_plugins_fail_fast(port_regular, monkeypatch):
    # pip is supported WITH a wheelhouse; without one it must still fail
    # at submission time with the documented guidance
    monkeypatch.delenv("RAY_TPU_TORCH_WHEELHOUSE", raising=False)

    @ray_tpu_torch.remote(runtime_env={"pip": ["requests"]})
    def nope():
        return 1

    with pytest.raises(ValueError, match="wheelhouse"):
        nope.remote()

    @ray_tpu_torch.remote(runtime_env={"conda": ["whatever"]})
    def nope2():
        return 1

    with pytest.raises(ValueError, match="env name or an env spec"):
        nope2.remote()


def test_actor_runtime_env(port_regular, tmp_path):
    wd = tmp_path / "awd"
    wd.mkdir()
    (wd / "marker.txt").write_text("actor-env")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(wd)})
    class Reader:
        def read(self):
            with open("marker.txt") as f:
                return f.read()

    r = Reader.remote()
    assert ray_tpu_torch.get(r.read.remote(), timeout=120) == "actor-env"
