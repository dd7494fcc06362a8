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

import pytest

import ray_tpu_torch


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
