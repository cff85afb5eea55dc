"""Node-side runtime-environment provisioning with ref-counted caching.

Parity: the reference's per-node RuntimeEnvAgent
(reference: python/ray/runtime_env/ARCHITECTURE.md — create-or-get URIs,
cache across workers, ref-count per consumer, GC at zero refs;
python/ray/_private/runtime_env/{pip,working_dir,py_modules}.py;
raylet side src/ray/raylet/agent_manager.cc). Owned by the raylet: workers
call EnsureRuntimeEnv before activating an env, the raylet materializes
each URI once per node, and releases a job's references when the GCS
publishes the job's finish event.

URI kinds:
  pip://<hash>            isolated site-packages built by `pip install
                          --target` from a requirements list (offline:
                          honors RAY_TPU_TORCH_PIP_ARGS, e.g. "--no-index
                          --find-links /wheels")
  gcskv://pkg/<hash>      zip archive stored in the GCS KV table (local
                          working_dir/py_modules dirs are packed+uploaded
                          at submission, the reference's working_dir
                          upload semantics)
  file://<abs path>.zip   zip archive on a shared filesystem
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import shutil
import subprocess
import sys
import zipfile

logger = logging.getLogger(__name__)

# Archives above this are rejected at pack time (reference default:
# 500 MiB upload cap for working_dir packages).
MAX_PACKAGE_BYTES = 200 * 1024 * 1024

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def package_local_dir(path: str) -> bytes:
    """Zip a local directory into a deterministic archive (sorted entries,
    zeroed timestamps) so equal trees hash equal."""
    import io

    buf = io.BytesIO()
    path = os.path.abspath(path)
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for f in sorted(files):
            full = os.path.join(root, f)
            entries.append((os.path.relpath(full, path), full))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in entries:
            zi = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            zi.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
            with open(full, "rb") as fh:
                zf.writestr(zi, fh.read())
    data = buf.getvalue()
    if len(data) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"packaged dir {path!r} is {len(data)} bytes "
            f"(cap {MAX_PACKAGE_BYTES}); exclude large files")
    return data


def package_uri_for(data: bytes) -> str:
    return "gcskv://pkg/" + hashlib.sha1(data).hexdigest()


def pip_uri_for(reqs: list[str]) -> str:
    blob = "\n".join(sorted(reqs)).encode()
    return "pip://" + hashlib.sha1(blob).hexdigest()


class RuntimeEnvManager:
    """Materializes runtime-env URIs on this node, once each, with
    per-job reference counting and GC at zero references."""

    def __init__(self, session_dir: str, kv_get=None):
        self.base = os.path.join(session_dir, "runtime_envs")
        os.makedirs(self.base, exist_ok=True)
        # kv_get: async callable (ns, key) -> bytes | None, used to fetch
        # gcskv:// packages (wired to the raylet's GCS connection).
        self._kv_get = kv_get
        self._uri_jobs: dict[str, set[str]] = {}   # uri -> referencing jobs
        self._locks: dict[str, asyncio.Lock] = {}
        self._ready: dict[str, str] = {}           # uri -> local path

    # ---------- public ----------

    async def ensure(self, env: dict, job_id: str) -> dict:
        """Materialize every provisioned part of `env` on this node.
        Returns {"pip_dir": path|None, "working_dir": path|None,
        "py_modules": [path, ...]} with URIs resolved to local dirs."""
        out = {"pip_dir": None, "working_dir": None, "py_modules": []}
        reqs = env.get("pip")
        if reqs:
            out["pip_dir"] = await self._ensure_uri(
                pip_uri_for(list(reqs)), job_id, pip_reqs=list(reqs))
        wd = env.get("working_dir")
        if wd and _is_uri(wd):
            out["working_dir"] = await self._ensure_uri(wd, job_id)
        for m in env.get("py_modules") or []:
            if _is_uri(m):
                out["py_modules"].append(await self._ensure_uri(m, job_id))
            else:
                out["py_modules"].append(m)
        return out

    def release_job(self, job_id: str) -> None:
        """Drop all of `job_id`'s references; GC URIs that hit zero
        (reference: URI deleted when no job/actor references remain)."""
        for uri, jobs in list(self._uri_jobs.items()):
            jobs.discard(job_id)
            if not jobs:
                del self._uri_jobs[uri]
                path = self._ready.pop(uri, None)
                # NOTE: the lock object is kept (bounded by distinct URIs
                # per session) — popping it could hand a second lock to a
                # concurrent ensure and race two creations on one dest.
                if path and os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                    logger.info("runtime_env GC: removed %s (%s)", uri, path)

    def uris_in_use(self) -> dict:
        return {uri: sorted(jobs) for uri, jobs in self._uri_jobs.items()}

    # ---------- materialization ----------

    async def _ensure_uri(self, uri: str, job_id: str,
                          pip_reqs: list | None = None) -> str:
        # Job ref registered BEFORE creation so a concurrent release of
        # another job can never see an empty ref set mid-create; rolled
        # back if creation fails (no phantom in-use URIs).
        self._uri_jobs.setdefault(uri, set()).add(job_id)
        lock = self._locks.setdefault(uri, asyncio.Lock())
        try:
            async with lock:
                path = self._ready.get(uri)
                if path and os.path.isdir(path):
                    return path
                path = await self._create(uri, pip_reqs)
                self._ready[uri] = path
                return path
        except BaseException:
            jobs = self._uri_jobs.get(uri)
            if jobs is not None:
                jobs.discard(job_id)
                if not jobs:
                    del self._uri_jobs[uri]
            raise

    async def _create(self, uri: str, pip_reqs: list | None) -> str:
        h = hashlib.sha1(uri.encode()).hexdigest()[:16]
        if uri.startswith("pip://"):
            dest = os.path.join(self.base, f"pip-{h}")
            await asyncio.get_running_loop().run_in_executor(
                None, self._pip_install, pip_reqs or [], dest)
            return dest
        dest = os.path.join(self.base, f"pkg-{h}")
        data = await self._fetch_package(uri)
        tmp = dest + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        import io

        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            zf.extractall(tmp)
        shutil.rmtree(dest, ignore_errors=True)
        os.replace(tmp, dest)
        return dest

    async def _fetch_package(self, uri: str) -> bytes:
        if uri.startswith("gcskv://"):
            ns, key = uri[len("gcskv://"):].split("/", 1)
            if self._kv_get is None:
                raise RuntimeError("no KV access for gcskv:// packages")
            data = await self._kv_get(ns, key)
            if data is None:
                raise FileNotFoundError(f"package {uri} not found in GCS KV")
            return data
        if uri.startswith("file://"):
            with open(uri[len("file://"):], "rb") as f:
                return f.read()
        if uri.endswith(".zip"):  # bare local archive path
            with open(uri, "rb") as f:
                return f.read()
        raise ValueError(f"unsupported runtime_env URI {uri!r}")

    def _pip_install(self, reqs: list[str], dest: str) -> None:
        """Isolated site-packages via `pip install --target` (reference:
        _private/runtime_env/pip.py builds a virtualenv; a --target dir is
        the TPU-image-friendly equivalent — no venv binaries, zero global
        state). Extra args (e.g. --no-index --find-links for the
        zero-egress test environment) come from RAY_TPU_TORCH_PIP_ARGS."""
        tmp = dest + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        cmd = [sys.executable, "-m", "pip", "install", "--quiet",
               "--disable-pip-version-check", "--no-warn-script-location",
               "--target", tmp]
        cmd += os.environ.get("RAY_TPU_TORCH_PIP_ARGS", "").split()
        cmd += list(reqs)
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"pip env creation failed rc={r.returncode}: "
                f"{r.stderr[-1000:]}")
        shutil.rmtree(dest, ignore_errors=True)
        os.replace(tmp, dest)


def _is_uri(s: str) -> bool:
    return s.startswith(("gcskv://", "file://")) or s.endswith(".zip")
