"""Every reference case that a slice carried has its counterpart in the
port, under its own name.

For each reference file below (read, never changed), every ``def test_``
name must appear as a ``def`` of the same name in
``tests/test_torch_<name>.py``, and a case the reference marks slow must be
marked slow there too. One parametrised case per file: ``CARRIED`` holds
the control plane and fault tolerance (13 files), ``CARRIED_SLICE_19`` the
runtime environments, Serve and the learner group (8 files), beside which
two cases of ``tests/test_serve.py`` live in ``tests/test_torch_serve.py``,
and ``CARRIED_SLICE_20`` observability (7 files).

``test_every_reference_file_has_a_port_test`` checks the whole tree: every
reference ``tests/test_<name>.py`` has a ``tests/test_torch_<name>.py`` or
a port test that names ``test_<name>``.
"""

import ast
import glob
import os
import re

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

CARRIED = {
    "rpcio_framing": 21, "fault_injection": 17, "topology": 16,
    "control_plane": 15, "native_sched": 7, "gcs_ft": 5, "state_api": 5,
    "config": 5, "concurrency_groups": 3, "usage_stats": 3, "rpc_auth": 2,
    "chaos": 2, "node_agent": 1,
}

CARRIED_SLICE_19 = {
    "runtime_env": 5, "runtime_env_container": 4, "runtime_env_plugins": 9,
    "serve_asgi": 4, "serve_schema": 3, "serve_grpc_typed": 3,
    "serve_proxy_fleet": 2, "learner_group": 4,
}

CARRIED_SLICE_20 = {
    "profiler": 16, "logs": 19, "metrics": 18, "tracing": 4,
    "observability": 4, "dashboard": 4, "compiled_dag": 4,
}

SERVE_CASES = ("test_multiplexed_models", "test_redeploy_updates_code")

# the port's copies of the reference's test helpers that slice 19 needed
HELPERS = ("torch_runtime_env_plugin_mod.py", "torch_serve_test_app.py")


def _cases(path):
    """{name: marked slow} of the module's top-level test functions."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {node.name: any("slow" in ast.unparse(d)
                           for d in node.decorator_list)
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name.startswith("test_")}


def _check_carried(name, count):
    ref = _cases(os.path.join(TESTS, f"test_{name}.py"))
    assert len(ref) == count
    port = _cases(os.path.join(TESTS, f"test_torch_{name}.py"))
    missing = sorted(set(ref) - set(port))
    assert not missing, f"test_torch_{name}.py lacks {missing}"
    slow = {case: port[case] for case in ref if ref[case] != port[case]}
    assert not slow, f"slow marks differ from the reference's: {slow}"


@pytest.mark.parametrize("name", sorted(CARRIED))
def test_reference_cases_are_carried(name):
    _check_carried(name, CARRIED[name])


@pytest.mark.parametrize("name", sorted(CARRIED_SLICE_19))
def test_slice_19_reference_cases_are_carried(name):
    _check_carried(name, CARRIED_SLICE_19[name])


@pytest.mark.parametrize("name", sorted(CARRIED_SLICE_20))
def test_slice_20_reference_cases_are_carried(name):
    _check_carried(name, CARRIED_SLICE_20[name])


def _uncarried(skip=()):
    """The names of the reference's ``tests/test_<name>.py`` files with no
    ``tests/test_torch_<name>.py`` and no port test (``skip`` aside) whose
    text names ``test_<name>``."""
    ports = {}
    for path in glob.glob(os.path.join(TESTS, "test_torch_*.py")):
        if os.path.basename(path) not in skip:
            with open(path, encoding="utf-8") as f:
                ports[os.path.basename(path)] = f.read()
    found = []
    for path in sorted(glob.glob(os.path.join(TESTS, "test_*.py"))):
        base = os.path.basename(path)
        if base.startswith("test_torch_"):
            continue
        name = base[len("test_"):-len(".py")]
        named = re.compile(r"\btest_%s\b" % re.escape(name))
        if f"test_torch_{name}.py" not in ports and \
                not any(named.search(text) for text in ports.values()):
            found.append(name)
    return found


def test_every_reference_file_has_a_port_test():
    assert _uncarried() == []


def test_the_whole_tree_check_sees_a_file_left_uncarried():
    """Without slice 20's files the check names exactly its 7 reference
    files: none of them is named by another port test."""
    skip = {f"test_torch_{name}.py" for name in CARRIED_SLICE_20}
    assert _uncarried(skip) == sorted(CARRIED_SLICE_20)


def test_slice_19_serve_cases_are_carried():
    ref = _cases(os.path.join(TESTS, "test_serve.py"))
    port = _cases(os.path.join(TESTS, "test_torch_serve.py"))
    for case in SERVE_CASES:
        assert case in ref
        assert case in port, f"test_torch_serve.py lacks {case}"
        assert port[case] == ref[case]


@pytest.mark.parametrize("helper", HELPERS)
def test_slice_19_helpers_import_nothing_of_the_reference(helper):
    """A replica or worker imports these by name, so they stand on the
    port alone."""
    with open(os.path.join(TESTS, helper), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "ray_tpu_torch" in roots
    assert not roots & {"ray_tpu", "jax", "flax"}, roots


def test_the_slice_counts_102_cases():
    assert sum(CARRIED.values()) == 102


def test_slice_19_counts_36_cases():
    assert sum(CARRIED_SLICE_19.values()) + len(SERVE_CASES) == 36


def test_slice_20_counts_69_cases():
    assert sum(CARRIED_SLICE_20.values()) == 69
