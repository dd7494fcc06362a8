"""Every reference case of the control plane and fault tolerance has its
counterpart in the port, under its own name.

For each of the 13 reference files below (read, never changed), every
``def test_`` name must appear as a ``def`` of the same name in
``tests/test_torch_<name>.py``, and a case the reference marks slow must be
marked slow there too. One parametrised case per file.
"""

import ast
import os

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

CARRIED = {
    "rpcio_framing": 21, "fault_injection": 17, "topology": 16,
    "control_plane": 15, "native_sched": 7, "gcs_ft": 5, "state_api": 5,
    "config": 5, "concurrency_groups": 3, "usage_stats": 3, "rpc_auth": 2,
    "chaos": 2, "node_agent": 1,
}


def _cases(path):
    """{name: marked slow} of the module's top-level test functions."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {node.name: any("slow" in ast.unparse(d)
                           for d in node.decorator_list)
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name.startswith("test_")}


@pytest.mark.parametrize("name", sorted(CARRIED))
def test_reference_cases_are_carried(name):
    ref = _cases(os.path.join(TESTS, f"test_{name}.py"))
    assert len(ref) == CARRIED[name]
    port = _cases(os.path.join(TESTS, f"test_torch_{name}.py"))
    missing = sorted(set(ref) - set(port))
    assert not missing, f"test_torch_{name}.py lacks {missing}"
    slow = {case: port[case] for case in ref if ref[case] != port[case]}
    assert not slow, f"slow marks differ from the reference's: {slow}"


def test_the_slice_counts_102_cases():
    assert sum(CARRIED.values()) == 102
