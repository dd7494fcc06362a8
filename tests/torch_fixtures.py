"""The port's cluster fixtures for the ``tests/test_torch_*.py`` files that
carry the reference's runtime cases.

They mirror ``tests/conftest.py``'s ``ray_start_regular``,
``ray_start_regular_fn`` and ``ray_start_cluster`` with ``ray_tpu_torch``
in place of ``ray_tpu``: a port cluster boots in ~2 s on the CPU, so each
module boots its own and shuts it down (no cross-module reuse). They bear
other names so that a module using them leaves the reference's shared
cluster in ``tests/conftest.py`` as it is. Import them into a test module:
``from tests.torch_fixtures import port_regular``.
"""

import contextlib

import pytest

import ray_tpu_torch


@contextlib.contextmanager
def own_port_cluster(**init_kwargs):
    """A port cluster of the caller's own, for a module fixture that starts
    one as the reference's module does: a port cluster this process left
    up (an earlier module on the same xdist worker) is shut down first,
    where ``init`` would raise "called twice"."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(**init_kwargs)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port_regular():
    ray_tpu_torch.init(num_cpus=4, resources={"custom": 2.0})
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def port_regular_fn():
    """Function-scoped variant for cases that change the cluster's state:
    like the reference's, it first shuts down the module's cluster."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def port_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cluster = Cluster(initialize_head=False)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()
