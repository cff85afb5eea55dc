"""Per-task/actor runtime environments.

Parity: reference python/ray/runtime_env/runtime_env.py +
_private/runtime_env/ plugins (design doc: python/ray/runtime_env/
ARCHITECTURE.md) — env_vars, working_dir, py_modules, and a plugin hook
API. The reference materializes envs through a per-node RuntimeEnvAgent
with ref-counted caching; here nodes share a filesystem (fake-multinode
model, SURVEY.md §4), so materialization is in-process at task execution:
env vars are swapped around the task, working_dir/py_modules go onto
sys.path, and plugins get a setup callback in the worker.

Supported fields:
  env_vars: dict[str, str]      — set for the duration of the task; for
                                  actors they persist (dedicated process).
  working_dir: str              — chdir + sys.path for the task. A local
                                  DIRECTORY is packed + uploaded to the
                                  GCS KV at submission (gcskv:// URI,
                                  reference working_dir upload); zip
                                  URIs are extracted node-side.
  py_modules: list[str]         — directories prepended to sys.path
                                  (same packing/URI handling).
  pip: list[str]                — requirements installed into an
                                  isolated, node-cached site-packages dir
                                  (reference: _private/runtime_env/pip.py)
                                  prepended to sys.path for the task.
  config: dict                  — opaque; passed to plugins.
  <plugin name>: Any            — handled by a registered plugin.

Provisioning (pip envs, package extraction) runs in the RAYLET's
RuntimeEnvManager — cached per node, ref-counted per job, GC'd when the
GCS publishes the job-finished event (_private/runtime_env_manager.py).
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, Callable

_KNOWN_FIELDS = {"env_vars", "working_dir", "py_modules", "pip", "config"}

# name -> setup(value, env_dict) callback, run in the executing worker.
_PLUGINS: dict[str, Callable[[Any, dict], None]] = {}


def register_plugin(name: str, setup: Callable[[Any, dict], None]) -> None:
    """Register a runtime_env plugin (parity: reference RuntimeEnvPlugin
    classes registered via RAY_RUNTIME_ENV_PLUGINS)."""
    _PLUGINS[name] = setup


def unregister_plugin(name: str) -> None:
    _PLUGINS.pop(name, None)


class RuntimeEnv(dict):
    """Validated runtime environment; behaves as a plain dict on the wire."""

    def __init__(self, *, env_vars: dict | None = None,
                 working_dir: str | None = None,
                 py_modules: list | None = None,
                 pip: list | None = None,
                 config: dict | None = None, **plugin_fields):
        super().__init__()
        if pip is not None:
            if isinstance(pip, str) or \
                    not all(isinstance(r, str) for r in pip):
                raise TypeError(
                    "pip must be a LIST of requirement strings "
                    "(a bare string would be split per-character)")
            self["pip"] = list(pip)
        if env_vars is not None:
            if not all(isinstance(k, str) and isinstance(v, str)
                       for k, v in env_vars.items()):
                raise TypeError("env_vars must be dict[str, str]")
            self["env_vars"] = dict(env_vars)
        if working_dir is not None:
            if not isinstance(working_dir, str):
                raise TypeError("working_dir must be a path string")
            self["working_dir"] = working_dir
        if py_modules is not None:
            if not isinstance(py_modules, (list, tuple)):
                raise TypeError("py_modules must be a list of paths")
            self["py_modules"] = list(py_modules)
        if config is not None:
            self["config"] = dict(config)
        for k, v in plugin_fields.items():
            if k not in _PLUGINS:
                raise ValueError(
                    f"unknown runtime_env field {k!r} (no plugin registered)")
            self[k] = v

    @staticmethod
    def merge(parent: dict | None, child: dict | None) -> dict | None:
        """Child overrides parent per-field; env_vars merge key-wise
        (reference semantics for job → task inheritance)."""
        if not parent:
            return dict(child) if child else None
        if not child:
            return dict(parent)
        out = dict(parent)
        for k, v in child.items():
            if k == "env_vars" and "env_vars" in out:
                merged = dict(out["env_vars"])
                merged.update(v)
                out["env_vars"] = merged
            else:
                out[k] = v
        return out


# abspath -> uploaded gcskv:// URI. One fingerprint+upload per dir per
# driver process (reference semantics: working_dir is uploaded once per
# job; later edits to the dir are not re-uploaded mid-job) — also keeps
# the per-submission hot path free of directory walks.
_pack_cache: dict = {}


def _is_package_uri(s: str) -> bool:
    return s.startswith(("gcskv://", "file://")) or s.endswith(".zip")


def _upload_local_dir(path: str) -> str:
    """Pack a local dir and store it in the GCS KV; returns gcskv:// URI.
    Content-addressed: identical trees dedupe server-side."""
    from ray_tpu_torch._private.api_internal import core_worker_or_none
    from ray_tpu_torch._private.runtime_env_manager import (
        package_local_dir, package_uri_for)

    path = os.path.abspath(os.path.expanduser(path))
    cw = core_worker_or_none()
    if cw is None:
        return path  # no cluster yet: leave as a direct path
    uri = _pack_cache.get(path)
    if uri is not None:
        return uri
    data = package_local_dir(path)
    uri = package_uri_for(data)
    kv_key = uri[len("gcskv://pkg/"):]
    cw._run(cw.gcs.call("KVPut", {"ns": "pkg", "key": kv_key.encode(),
                                  "value": data, "overwrite": False}))
    _pack_cache[path] = uri
    return uri


def prepare_for_wire(env: dict | None) -> dict | None:
    """Submission-side packaging: local working_dir / py_modules
    directories become uploaded gcskv:// packages so any node can
    materialize them (reference: working_dir/py_modules upload to GCS in
    _private/runtime_env/packaging.py)."""
    if not env:
        return env
    wd = env.get("working_dir")
    mods = env.get("py_modules")
    if not wd and not mods:
        return env
    out = dict(env)
    try:
        if wd and not _is_package_uri(wd) and os.path.isdir(wd):
            out["working_dir"] = _upload_local_dir(wd)
        if mods:
            out["py_modules"] = [
                _upload_local_dir(m)
                if not _is_package_uri(m) and os.path.isdir(m) else m
                for m in mods]
    except ValueError:
        # Oversized package: fall back to the direct path (shared-FS
        # deployments still work; remote nodes would fail at setup).
        return env
    return out


def _resolve_provisioned(env: dict, job_id: str = "") -> dict:
    """Worker-side: ask this node's raylet to materialize pip envs and
    package URIs (cached + ref-counted there under the SUBMITTING job's
    id, so job-finish GC sees real references); swap local paths in."""
    needs = env.get("pip") or _is_package_uri(env.get("working_dir") or "") \
        or any(_is_package_uri(m) for m in env.get("py_modules") or [])
    if not needs:
        return env
    from ray_tpu_torch._private.api_internal import core_worker_or_none

    cw = core_worker_or_none()
    if cw is None or cw.raylet is None:
        raise RuntimeEnvSetupError(
            "provisioned runtime_env fields (pip / package URIs) need a "
            "running cluster")
    ctx = cw.ensure_runtime_env(env, job_id)
    out = dict(env)
    if ctx.get("working_dir"):
        out["working_dir"] = ctx["working_dir"]
    if ctx.get("py_modules"):
        out["py_modules"] = ctx["py_modules"]
    if ctx.get("pip_dir"):
        # Isolated site-packages: prepend like a py_module.
        out["py_modules"] = [ctx["pip_dir"]] + list(out.get("py_modules") or [])
        out.pop("pip", None)
    return out


@contextlib.contextmanager
def runtime_env_context(env: dict | None, *, persistent: bool = False,
                        job_id: str = ""):
    """Materialize `env` in this process for the duration of the block.

    persistent=True (actor creation) applies without restoring — the worker
    process is dedicated to the actor, matching the reference's
    runtime-env-keyed worker processes (worker_pool.cc runtime env hash).
    job_id attributes provisioning references for job-finish GC.
    """
    if not env:
        yield
        return
    env = _resolve_provisioned(env, job_id)

    # Validate BEFORE mutating any process state: a setup error must leave
    # the pooled worker exactly as it was (otherwise a failed task leaks
    # env vars / cwd / sys.path entries into every later task).
    wd = env.get("working_dir")
    if wd:
        wd = os.path.abspath(os.path.expanduser(wd))
        if not os.path.isdir(wd):
            raise RuntimeEnvSetupError(f"working_dir {wd!r} does not exist")
    py_modules = []
    for p in env.get("py_modules") or []:
        p = os.path.abspath(os.path.expanduser(p))
        if not os.path.exists(p):
            raise RuntimeEnvSetupError(f"py_module {p!r} does not exist")
        py_modules.append(p)

    saved_env: dict[str, str | None] = {}
    saved_cwd = None
    added_paths: list[str] = []
    applied = False
    try:
        for k, v in (env.get("env_vars") or {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        if wd:
            saved_cwd = os.getcwd()
            os.chdir(wd)
            if wd not in sys.path:
                sys.path.insert(0, wd)
                added_paths.append(wd)
        for p in py_modules:
            if p not in sys.path:
                sys.path.insert(0, p)
                added_paths.append(p)
        for name, setup in _PLUGINS.items():
            if name in env:
                setup(env[name], env)
        applied = True
        yield
    finally:
        # Restore on any exit except a fully-applied persistent (actor) env.
        if not (persistent and applied):
            for k, old in saved_env.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            if saved_cwd is not None:
                os.chdir(saved_cwd)
            for p in added_paths:
                try:
                    sys.path.remove(p)
                except ValueError:
                    pass


# Job-level default, inherited by tasks/actors without their own
# runtime_env (set by ray_tpu_torch.init(runtime_env=...)).
_job_runtime_env: dict | None = None


def set_job_runtime_env(env: dict | None) -> None:
    global _job_runtime_env
    _job_runtime_env = dict(env) if env else None


def get_job_runtime_env() -> dict | None:
    return _job_runtime_env


from ray_tpu_torch.exceptions import RuntimeEnvSetupError  # noqa: E402  (cycle-safe)

__all__ = ["RuntimeEnv", "register_plugin", "unregister_plugin",
           "runtime_env_context", "set_job_runtime_env",
           "get_job_runtime_env"]
