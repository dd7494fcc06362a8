"""Runtime-env materialization: working_dir + py_modules.

ray parity: python/ray/_private/runtime_env/{packaging.py, working_dir.py,
py_modules.py} + the per-node agent (agent/runtime_env_agent.py:159) and
URI cache (uri_cache.py). TPU-native there is no separate agent process:
the DRIVER packages local directories into content-addressed zips stored
in the GCS KV, rewriting the runtime_env to carry URIs; each WORKER
materializes the URIs it needs into a node-local cache before serving
tasks (workers are pooled per runtime-env hash, so one worker serves one
env). pip IS supported offline through a local wheelhouse (see
_PipPlugin: the wheelhouse ships content-addressed like working_dir and
workers build a cached venv from it); conda works against pre-created
named envs; container wraps the worker command in a podman/docker
invocation (_ContainerPlugin + raylet spawn wrapping).
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile
from typing import Dict, List, Optional

_KV_NS = b"runtime_env_packages"
MAX_PACKAGE_BYTES = 200 * 1024 * 1024
# driver-side: (driver client_id, abspath) -> uploaded digest. Keyed per
# connection so a digest cached against one cluster is never trusted on a
# fresh cluster whose KV lacks the package; content changes during one
# driver's lifetime are not re-detected (the reference packages per job).
_UPLOAD_CACHE: dict = {}

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def package_directory(path: str) -> tuple:
    """Zip a directory into (content_hash, zip_bytes). Deterministic:
    sorted entries, zeroed timestamps — equal trees hash equal."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory not found: {path}")
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS
                         and not d.startswith("."))
        for f in sorted(files):
            if f.startswith("."):
                continue
            full = os.path.join(root, f)
            entries.append((os.path.relpath(full, path), full))
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in entries:
            total += os.path.getsize(full)
            if total > MAX_PACKAGE_BYTES:
                raise ValueError(
                    f"runtime_env package exceeds "
                    f"{MAX_PACKAGE_BYTES >> 20}MB: {path}"
                )
            info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            with open(full, "rb") as fh:
                zf.writestr(info, fh.read())
    blob = buf.getvalue()
    digest = hashlib.sha256(blob).hexdigest()[:24]
    return digest, blob


# ---------------------------------------------------------------------------
# Plugin framework (ray parity: _private/runtime_env/plugin.py:24 —
# RuntimeEnvPlugin with per-key validate/create hooks, priority-ordered).
# The built-in keys (working_dir, py_modules, env_vars) are plugins of the
# same registry user plugins join via register_runtime_env_plugin.
# ---------------------------------------------------------------------------


class RuntimeEnvPlugin:
    """One runtime_env key's handling. ``validate`` runs driver-side at
    option time (fail fast); ``prepare`` runs driver-side and may rewrite
    the env dict (e.g. path -> URI); ``materialize`` runs in each worker
    before it serves tasks."""

    name: str = ""
    priority: int = 50  # lower runs first (working_dir before py_modules)

    def validate(self, env: dict) -> None:
        pass

    def prepare(self, core_worker, env: dict) -> None:
        pass

    def materialize(self, core_worker, env: dict) -> None:
        pass


_PLUGINS: dict = {}


def register_runtime_env_plugin(plugin: RuntimeEnvPlugin):
    """Add a custom runtime_env key (ray parity: the plugin framework's
    entry-point registration). The plugin's ``name`` is the env dict key
    it owns."""
    if not plugin.name:
        raise ValueError("plugin needs a name (the runtime_env key it owns)")
    _PLUGINS[plugin.name] = plugin


def _ordered_plugins():
    return sorted(_PLUGINS.values(), key=lambda p: p.priority)


def prepare_runtime_env(core_worker, runtime_env: Optional[dict]
                        ) -> Optional[dict]:
    """Driver-side: run every registered plugin's validate+prepare
    (ray: upload_package_to_gcs and friends). Idempotent on already-
    prepared envs; unsupported keys raise early."""
    if not runtime_env:
        return runtime_env
    env = dict(runtime_env)
    for plugin in _ordered_plugins():
        plugin.validate(env)
        plugin.prepare(core_worker, env)
    # the raylet ships the env to workers as JSON; a non-JSON value (set,
    # bytes, ...) must fail HERE at option time, not inside the raylet's
    # dispatch loop
    import json

    try:
        json.dumps({k: v for k, v in env.items() if k != "env_vars"})
    except TypeError as e:
        raise ValueError(
            f"runtime_env values must be JSON-serializable: {e}"
        ) from None
    return env


def _upload_factory(core_worker):
    def upload(path: str) -> str:
        # One walk+zip+upload per path per driver process: repeated
        # .remote() calls with the same working_dir must not re-hash the
        # tree on every submission (ray packages per job, not per task).
        abspath = os.path.abspath(os.path.expanduser(path))
        cache_key = (core_worker.client_id, abspath)
        cached = _UPLOAD_CACHE.get(cache_key)
        if cached is not None:
            return cached
        digest, blob = package_directory(path)
        key = digest.encode()
        exists = core_worker.io.run(core_worker.gcs.request(
            "kv_exists", {"ns": _KV_NS, "key": key}
        ))
        if not exists:
            core_worker.io.run(core_worker.gcs.request(
                "kv_put", {"ns": _KV_NS, "key": key, "value": blob}
            ))
        _UPLOAD_CACHE[cache_key] = digest
        return digest

    return upload


class _WorkingDirPlugin(RuntimeEnvPlugin):
    name = "working_dir"
    priority = 10

    def prepare(self, core_worker, env: dict) -> None:
        if env.get("working_dir") and not env.get("working_dir_uri"):
            upload = _upload_factory(core_worker)
            env["working_dir_uri"] = upload(env.pop("working_dir"))

    def materialize(self, core_worker, env: dict) -> None:
        wd_uri = env.get("working_dir_uri")
        if not wd_uri:
            return
        path = _fetch_and_extract(_gcs_requester(core_worker), wd_uri)
        os.chdir(path)
        if path not in sys.path:
            sys.path.insert(0, path)


class _PyModulesPlugin(RuntimeEnvPlugin):
    name = "py_modules"
    priority = 20

    def prepare(self, core_worker, env: dict) -> None:
        if env.get("py_modules") and not env.get("py_module_uris"):
            upload = _upload_factory(core_worker)
            uris = []
            for mod_path in env.pop("py_modules"):
                uris.append((os.path.basename(os.path.normpath(mod_path)),
                             upload(mod_path)))
            env["py_module_uris"] = uris

    def materialize(self, core_worker, env: dict) -> None:
        for name, uri in env.get("py_module_uris") or ():
            path = _fetch_and_extract(_gcs_requester(core_worker), uri)
            # extracted dir IS the module content; expose it under its name
            parent = os.path.join(_cache_root(), f"mods_{uri}")
            os.makedirs(parent, exist_ok=True)
            link = os.path.join(parent, name)
            if not os.path.exists(link):
                try:
                    os.symlink(path, link)
                except OSError:
                    pass
            if parent not in sys.path:
                sys.path.insert(0, parent)


class _EnvVarsPlugin(RuntimeEnvPlugin):
    """env_vars apply at worker SPAWN (the raylet exports them before the
    interpreter starts, so sitecustomize/jax see them); this plugin only
    validates shape."""

    name = "env_vars"
    priority = 5

    def validate(self, env: dict) -> None:
        ev = env.get("env_vars")
        if ev is None:
            return
        if not isinstance(ev, dict) or not all(
            isinstance(k, str) for k in ev
        ):
            raise ValueError("runtime_env['env_vars'] must be a str dict")


class _PipPlugin(RuntimeEnvPlugin):
    """pip runtime env backed by a LOCAL WHEELHOUSE (ray parity:
    python/ray/_private/runtime_env/pip.py, constrained to offline
    images: no index access at task time).

    Accepted forms::

        runtime_env={"pip": ["mypkg", "otherpkg==1.2"]}
        runtime_env={"pip": {"packages": [...],
                             "wheelhouse": "/path/to/wheels"}}

    The wheelhouse (the dict key, or ``RAY_TPU_TORCH_WHEELHOUSE``) must be a
    directory of pre-downloaded wheels; validation fails EARLY with a
    clear error when none is configured, rather than at task time. The
    driver uploads the wheelhouse as a content-addressed package to the
    GCS KV (same plane as working_dir), so remote nodes materialize it
    too and updated wheels change the content hash (no stale-venv
    trap). Workers build a ``--system-site-packages`` venv per
    (packages, wheelhouse-content) digest under the node cache —
    atomically, via tmp-dir + rename, because concurrent same-env
    workers race — install with ``pip --no-index --find-links``, and
    add the venv's site-packages to ``sys.path``.

    Priority 8: BEFORE working_dir/py_modules, whose later sys.path
    prepends must shadow wheelhouse packages (user-shipped code wins
    over installed packages, matching the reference's precedence)."""

    name = "pip"
    priority = 8

    @staticmethod
    def _normalize(env: dict):
        spec = env.get("pip")
        if not spec:
            return None, None
        if isinstance(spec, (list, tuple)):
            packages, wheelhouse = list(spec), None
        elif isinstance(spec, dict):
            packages = list(spec.get("packages") or ())
            wheelhouse = spec.get("wheelhouse")
        else:
            raise ValueError(
                "runtime_env['pip'] must be a list of requirements or a "
                "dict with 'packages' (+ optional 'wheelhouse')"
            )
        wheelhouse = wheelhouse or os.environ.get("RAY_TPU_TORCH_WHEELHOUSE")
        return packages, wheelhouse

    def validate(self, env: dict) -> None:
        spec = env.get("pip")
        if isinstance(spec, dict) and spec.get("wheelhouse_uri"):
            return  # already prepared (validate is re-run on re-prepare)
        packages, wheelhouse = self._normalize(env)
        if packages is None:
            return
        if not packages:
            raise ValueError("runtime_env['pip'] lists no packages")
        if not wheelhouse:
            raise ValueError(
                "runtime_env['pip'] needs a local wheelhouse in this "
                "offline image: pass {'pip': {'packages': [...], "
                "'wheelhouse': '/path/to/wheels'}} or set "
                "RAY_TPU_TORCH_WHEELHOUSE. There is no network package "
                "installation at task time; pre-download wheels with "
                "`pip download -d <wheelhouse> <pkgs>` on a connected "
                "machine."
            )
        if not os.path.isdir(wheelhouse):
            raise ValueError(
                f"runtime_env['pip'] wheelhouse {wheelhouse!r} is not a "
                "directory"
            )

    def prepare(self, core_worker, env: dict) -> None:
        spec = env.get("pip")
        if isinstance(spec, dict) and spec.get("wheelhouse_uri"):
            return  # already prepared
        packages, wheelhouse = self._normalize(env)
        if packages is None:
            return
        # ship the wheelhouse content-addressed through the GCS KV: the
        # driver-local path means nothing on other nodes, and the content
        # hash doubles as the venv cache key (updated wheels -> new venv)
        upload = _upload_factory(core_worker)
        env["pip"] = {"packages": sorted(packages),
                      "wheelhouse_uri": upload(wheelhouse)}

    def materialize(self, core_worker, env: dict) -> None:
        import shutil
        import subprocess

        spec = env.get("pip")
        if not spec:
            return
        packages = list(spec.get("packages") or ())
        uri = spec.get("wheelhouse_uri")
        if not packages or not uri:
            return
        wheelhouse = _fetch_and_extract(_gcs_requester(core_worker), uri)
        digest = hashlib.sha256(
            repr((sorted(packages), uri)).encode()
        ).hexdigest()[:16]
        venv_dir = os.path.join(_cache_root(), f"pipenv_{digest}")
        marker = os.path.join(venv_dir, ".ready")
        if not os.path.exists(marker):
            # build in a private tmp dir and publish with one atomic
            # rename; a concurrent same-env worker either wins the rename
            # or discards its build and uses the winner's
            tmp = f"{venv_dir}.building.{os.getpid()}"
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 tmp],
                check=True, capture_output=True,
            )
            proc = subprocess.run(
                [os.path.join(tmp, "bin", "pip"), "install", "--no-index",
                 "--find-links", wheelhouse, *sorted(packages)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    "pip runtime_env install failed (wheelhouse "
                    f"{wheelhouse}):\n{proc.stdout}\n{proc.stderr}"
                )
            with open(os.path.join(tmp, ".ready"), "w") as f:
                f.write("ok")
            try:
                os.rename(tmp, venv_dir)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
        import glob as _glob

        for sp in _glob.glob(
            os.path.join(venv_dir, "lib", "python*", "site-packages")
        ):
            if sp not in sys.path:
                sys.path.insert(0, sp)


class _CondaPlugin(RuntimeEnvPlugin):
    """conda runtime env (ray parity:
    python/ray/_private/runtime_env/conda.py), constrained like pip to
    what an offline image can honor:

    - ``{"conda": "env-name"}`` activates an EXISTING named env: its
      site-packages are prepended to ``sys.path`` worker-side (the same
      in-process activation the pip plugin uses for venvs).
    - ``{"conda": {...env spec...}}`` (env creation) needs a conda binary
      and network/channel access — validation fails EARLY with a clear
      error if no conda binary is on this image, rather than at task time.
    """

    name = "conda"
    priority = 8

    @staticmethod
    def _conda_exe():
        import shutil as _sh

        return (os.environ.get("CONDA_EXE")
                or _sh.which("conda") or _sh.which("mamba"))

    @classmethod
    def _named_env_prefix(cls, name: str):
        """Resolve a named env: cheap directory probes first
        ($CONDA_PREFIX/envs/<name>, ~/.conda/envs/<name>, the root prefix
        itself), then — so custom envs_dirs configurations resolve too —
        `conda env list --json` when a binary exists."""
        roots = []
        base = os.environ.get("CONDA_PREFIX")
        if base:
            # CONDA_PREFIX may itself be an env dir; its parent of parent
            # is the install root
            roots += [base, os.path.dirname(os.path.dirname(base))]
        roots.append(os.path.expanduser("~/.conda"))
        for root in roots:
            cand = os.path.join(root, "envs", name)
            if os.path.isdir(cand):
                return cand
        if base and os.path.basename(base) == name:
            return base
        exe = cls._conda_exe()
        if exe:
            import json as _json
            import subprocess

            try:
                out = subprocess.run(
                    [exe, "env", "list", "--json"], capture_output=True,
                    text=True, timeout=30,
                )
                for prefix in _json.loads(out.stdout or "{}").get(
                    "envs", []
                ):
                    if os.path.basename(prefix) == name:
                        return prefix
            except Exception:
                pass
        return None

    def validate(self, env: dict) -> None:
        spec = env.get("conda")
        if not spec:
            return
        if isinstance(spec, str):
            if self._named_env_prefix(spec) is None and not self._conda_exe():
                raise ValueError(
                    f"runtime_env['conda'] names env {spec!r}, but no such "
                    "env directory exists and no conda binary is available "
                    "to resolve it. Pre-create the env on every node or "
                    "use runtime_env['pip'] with a local wheelhouse."
                )
        elif isinstance(spec, dict):
            if not self._conda_exe():
                raise ValueError(
                    "runtime_env['conda'] with an env spec needs a conda "
                    "binary, which this image does not ship. Use a named "
                    "pre-created env ({'conda': 'name'}) or "
                    "runtime_env['pip'] with a local wheelhouse."
                )
        else:
            raise ValueError(
                "runtime_env['conda'] must be an env name or an env spec "
                "dict"
            )

    def materialize(self, core_worker, env: dict) -> None:
        import glob as _glob
        import subprocess

        spec = env.get("conda")
        if not spec:
            return
        if isinstance(spec, dict):
            exe = self._conda_exe()
            if exe is None:
                # validate ran driver-side; this node may differ
                raise RuntimeError(
                    "runtime_env['conda'] env spec: no conda binary on "
                    "this node"
                )
            # env creation path: hash the spec; build in a private tmp
            # prefix and publish with ONE atomic rename (same recipe as
            # the pip venvs above — a failed or concurrent create must
            # never leave a half-built prefix that later workers treat
            # as ready)
            digest = hashlib.sha256(
                repr(sorted(spec.items())).encode()
            ).hexdigest()[:16]
            prefix = os.path.join(_cache_root(), f"condaenv_{digest}")
            if not os.path.isdir(prefix):
                import shutil
                import tempfile

                with tempfile.NamedTemporaryFile(
                    "w", suffix=".yml", delete=False
                ) as f:
                    import yaml as _yaml

                    _yaml.safe_dump(spec, f)
                    spec_file = f.name
                tmp = f"{prefix}.building.{os.getpid()}"
                try:
                    proc = subprocess.run(
                        [exe, "env", "create", "-p", tmp, "-f", spec_file],
                        capture_output=True, text=True,
                    )
                finally:
                    try:
                        os.unlink(spec_file)
                    except OSError:
                        pass
                if proc.returncode != 0:
                    shutil.rmtree(tmp, ignore_errors=True)
                    raise RuntimeError(
                        f"conda env create failed:\n{proc.stderr}"
                    )
                try:
                    os.rename(tmp, prefix)
                except OSError:  # lost the publish race: use the winner's
                    shutil.rmtree(tmp, ignore_errors=True)
        else:
            prefix = self._named_env_prefix(spec)
            if prefix is None:
                raise RuntimeError(
                    f"conda env {spec!r} not found on this node"
                )
        for sp in _glob.glob(
            os.path.join(prefix, "lib", "python*", "site-packages")
        ):
            if sp not in sys.path:
                sys.path.insert(0, sp)


class _ContainerPlugin(RuntimeEnvPlugin):
    """runtime_env={"container": {"image": ..., "run_options": [...],
    "engine": "podman"|"docker"|<path>}} — the raylet wraps the worker
    command in a container invocation (ray parity:
    _private/runtime_env/container.py, which wraps with podman). The
    image must carry the same python + ray_tpu_torch importable; network/ipc
    stay on the host namespaces so the worker reaches the raylet and
    the /dev/shm object store zero-copy."""

    name = "container"
    priority = 5  # shape-validate before packaging work

    def validate(self, env: dict) -> None:
        c = env.get("container")
        if not c:
            return
        if not isinstance(c, dict) or not c.get("image"):
            raise ValueError(
                "runtime_env['container'] must be a dict with an 'image' "
                f"key (got {c!r})"
            )
        ro = c.get("run_options", [])
        if not isinstance(ro, (list, tuple)) or not all(
            isinstance(o, str) for o in ro
        ):
            raise ValueError(
                "runtime_env['container']['run_options'] must be a list "
                "of strings"
            )

    # materialize: nothing to do inside the worker — by the time the
    # worker runs, it IS in the container (the raylet did the wrapping)


# The variables that choose the worker's device, forwarded into a container
# as the cluster's own are: which cards CUDA shows the process, and in what
# order it numbers them.
DEVICE_ENV_KEYS = ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")


def build_container_command(container: dict, env: Dict[str, str],
                            inner_argv: List[str],
                            extra_env_keys: tuple = (),
                            cidfile: Optional[str] = None) -> List[str]:
    """The worker argv wrapped in a container engine invocation.

    Host network + IPC + **PID** namespaces and /dev/shm + the session
    dir bind-mounted: the control plane (raylet/GCS ports, pid-keyed
    worker registration), the data plane (mmap'd object files), and
    signal delivery must look identical inside the container. The
    repository root rides along read-only so images without ray_tpu_torch
    baked in still work for same-version clusters.

    ``extra_env_keys``: additional env names to forward (the caller's
    runtime_env env_vars — the prefix filter below only covers cluster
    plumbing, and ``DEVICE_ENV_KEYS`` the device's selection).
    ``cidfile``: engine writes the container id there so the raylet can
    force-remove a container whose client process it had to kill
    (SIGKILL never proxies).
    """
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

    engine = container.get("engine") or cfg.container_runtime
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))
    cmd = [engine, "run", "--rm", "--network=host", "--ipc=host",
           "--pid=host", "-v", "/dev/shm:/dev/shm"]
    if cidfile:
        cmd += ["--cidfile", cidfile]
    session = env.get("RAY_TPU_TORCH_SESSION_DIR")
    if session:
        cmd += ["-v", f"{session}:{session}"]
    cmd += ["-v", f"{repo_root}:{repo_root}:ro",
            "-e", f"PYTHONPATH={repo_root}"]
    for k, v in env.items():
        if k.startswith("RAY_TPU_TORCH_") or k in DEVICE_ENV_KEYS \
                or k in extra_env_keys:
            cmd += ["-e", f"{k}={v}"]
    cmd += list(container.get("run_options", []))
    cmd.append(container["image"])
    return cmd + list(inner_argv)


register_runtime_env_plugin(_ContainerPlugin())
register_runtime_env_plugin(_CondaPlugin())
register_runtime_env_plugin(_PipPlugin())
register_runtime_env_plugin(_EnvVarsPlugin())
register_runtime_env_plugin(_WorkingDirPlugin())
register_runtime_env_plugin(_PyModulesPlugin())


def _load_env_plugins():
    """Load plugin classes named in RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS
    ("module:Class,module2:Class2") — the cross-process registration
    path: workers are separate interpreters, so a plugin registered by
    driver code alone would never materialize worker-side (ray parity:
    the RAY_RUNTIME_ENV_PLUGINS class-path env var)."""
    spec = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS", "")
    for item in filter(None, (s.strip() for s in spec.split(","))):
        try:
            mod_name, _, cls_name = item.partition(":")
            import importlib

            cls = getattr(importlib.import_module(mod_name), cls_name)
            register_runtime_env_plugin(cls())
        except Exception:  # a broken plugin must not kill every process
            import logging

            logging.getLogger(__name__).exception(
                "failed to load runtime_env plugin %r", item
            )


_load_env_plugins()


def _cache_root() -> str:
    base = os.environ.get("RAY_TPU_TORCH_SESSION_DIR") or "/tmp"
    return os.path.join(base, "runtime_env_cache")


def _fetch_and_extract(gcs_request, uri: str) -> str:
    """Materialize one package URI into the node-local cache (ray:
    uri_cache.py — content-addressed, so concurrent extracts converge)."""
    target = os.path.join(_cache_root(), uri)
    if os.path.isdir(target):
        return target
    blob = gcs_request("kv_get", {"ns": _KV_NS, "key": uri.encode()})
    if blob is None:
        raise RuntimeError(f"runtime_env package {uri} missing from GCS")
    tmp = target + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, target)
    except OSError:  # lost the race: someone else extracted it
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return target


def _gcs_requester(core_worker):
    def gcs_request(method, payload):
        return core_worker.io.run(core_worker.gcs.request(method, payload))

    return gcs_request


def materialize(core_worker, runtime_env: Optional[dict]) -> None:
    """Worker-side: run every plugin's materialize before this worker
    serves tasks (ray: RuntimeEnvAgent.CreateRuntimeEnv). working_dir
    becomes the process CWD and lands on sys.path; py_modules land on
    sys.path under their original import names; custom plugins run in
    priority order."""
    if not runtime_env:
        return
    for plugin in _ordered_plugins():
        plugin.materialize(core_worker, runtime_env)
