"""The port's copy of ``tests/runtime_env_plugin_mod.py``: a custom
runtime-env plugin for ``tests/test_torch_runtime_env_plugins.py``, built on
``ray_tpu_torch``'s plugin base (the reference's module imports
``ray_tpu``, which the port's workers never import)."""

import os

from ray_tpu_torch._private.runtime_env import RuntimeEnvPlugin


class MarkerPlugin(RuntimeEnvPlugin):
    """Materializes runtime_env["marker"] as an env var in the worker."""

    name = "marker"
    priority = 40

    def validate(self, env):
        m = env.get("marker")
        if m is not None and not isinstance(m, str):
            raise ValueError("marker must be a string")

    def materialize(self, core_worker, env):
        if env.get("marker"):
            os.environ["RTPU_TEST_MARKER"] = env["marker"]
