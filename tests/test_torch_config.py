"""The port's counterpart of ``tests/test_config.py`` (5 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

Beside them, ``test_defaults_equal_the_reference_apart_from_renames``
holds the flag table to the reference's (``RENAMED`` lists the one
rename).

The reference's description:

Flag table semantics (ray parity: RAY_CONFIG env/system_config layering,
src/ray/common/ray_config_def.h) and wiring into live components.
"""

import os
import subprocess
import sys

from ray_tpu_torch._private.config import GLOBAL_CONFIG


def test_defaults_and_update():
    assert GLOBAL_CONFIG.rpc_max_message_bytes == 1 << 31
    assert GLOBAL_CONFIG.tune_experiment_snapshot_period_s == 10.0
    GLOBAL_CONFIG.update({"rpc_auth_timeout_s": 3.5})
    try:
        assert GLOBAL_CONFIG.rpc_auth_timeout_s == 3.5
    finally:
        GLOBAL_CONFIG.reset()


def test_unknown_flag_rejected():
    import pytest

    with pytest.raises(ValueError, match="Unknown system config"):
        GLOBAL_CONFIG.update({"definitely_not_a_flag": 1})


def test_env_override_in_subprocess():
    """RAY_TPU_TORCH_<NAME> env vars override defaults at process start."""
    out = subprocess.run(
        [sys.executable, "-c",
         "from ray_tpu_torch._private.config import GLOBAL_CONFIG;"
         "print(GLOBAL_CONFIG.serve_control_loop_period_s,"
         "      GLOBAL_CONFIG.gcs_store_fsync)"],
        capture_output=True, text=True, timeout=60,
        env={**os.environ,
             "RAY_TPU_TORCH_serve_control_loop_period_s": "0.75",
             "RAY_TPU_TORCH_gcs_store_fsync": "true",
             "PYTHONPATH": os.path.dirname(os.path.dirname(
                 os.path.abspath(__file__)))},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0.75", "True"]


def test_flag_wiring_serve_graceful_default():
    """Flags are read at use time, not frozen at import: changing the flag
    changes freshly built DeploymentConfigs."""
    from ray_tpu_torch.serve._common import DeploymentConfig

    GLOBAL_CONFIG.update({"serve_default_graceful_shutdown_timeout_s": 2.0})
    try:
        assert DeploymentConfig(name="x").graceful_shutdown_timeout_s == 2.0
    finally:
        GLOBAL_CONFIG.reset()
    assert DeploymentConfig(name="x").graceful_shutdown_timeout_s == 5.0


def test_flag_wiring_rpc_message_cap():
    from ray_tpu_torch._private import rpcio

    GLOBAL_CONFIG.update({"rpc_max_message_bytes": 123})
    try:
        assert rpcio._max_msg() == 123
    finally:
        GLOBAL_CONFIG.reset()


# ---------------------------------------------- held against the reference --

# the flags the port names for what it probes: the reference probes the
# node's TPU chips, the port its CUDA cards
RENAMED = {"tpu_autodetect": "gpu_autodetect"}


def test_defaults_equal_the_reference_apart_from_renames():
    """Every flag of the reference's table is in the port's, with its type
    and default, under its own name or its rename in ``RENAMED``; the
    port has no flag the reference lacks."""
    from ray_tpu._private import config as ref_config
    from ray_tpu_torch._private import config as port_config

    ref = {RENAMED.get(k, k): v for k, v in ref_config._FLAG_DEFS.items()}
    assert port_config._FLAG_DEFS == ref
    assert len(ref) == len(ref_config._FLAG_DEFS)
    # and the live tables agree wherever no env override is set
    env_set = {k for k in ref if f"RAY_TPU_TORCH_{k}" in os.environ} | {
        RENAMED.get(k, k) for k in ref_config._FLAG_DEFS
        if f"RAY_TPU_{k}" in os.environ}
    for name, (_, default) in ref_config._FLAG_DEFS.items():
        port_name = RENAMED.get(name, name)
        if port_name not in env_set:
            assert getattr(GLOBAL_CONFIG, port_name) == default
