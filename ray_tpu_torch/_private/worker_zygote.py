"""Fork-server ("zygote") worker factory.

Interpreter start is expensive where every worker imports torch (about
a second of CPU each), so cold-spawning one process per worker
serializes actor/worker creation behind repeated identical imports. The
reference mitigates the same cost with worker prestart and
runtime-env-keyed worker reuse (reference:
src/ray/raylet/worker_pool.cc:1657); the zygote goes further: one warm
template process per node pays the import once, and every worker is an
`os.fork()` of it (~10ms), byte-identical to a cold-spawned worker (same
env, same module set, no CUDA context).

Protocol (newline-delimited JSON over a unix socket, one client — the
raylet):
    -> {"env": {...per-worker env...}, "log_path": "..."}
    <- {"pid": <worker pid>}
The zygote is single-threaded and never initializes CUDA (a process
forked after cuInit fails its first CUDA call), so forking is safe;
children reset signals, start their own event loop, and run the normal
worker main, which pins the card a lease names before anything touches
CUDA.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys


_children: set[int] = set()


def _reap(signum, frame):
    try:
        while True:
            pid, _ = os.waitpid(-1, os.WNOHANG)
            if pid == 0:
                break
            _children.discard(pid)
    except ChildProcessError:
        pass


def _kill_children() -> None:
    """Forked workers called setsid, so killing the zygote does not kill
    them — an orderly shutdown must, or they leak past raylet stop()."""
    for pid in list(_children):
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def _spawn(req: dict, inherited_fds: list[int]) -> int:
    pid = os.fork()
    if pid != 0:
        return pid
    # ---- child: become a clean worker process ----
    try:
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        # The spawn loop forks with SIGCHLD blocked; the mask is
        # inherited, and a worker that never unblocks it could not reap
        # ITS subprocesses.
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGCHLD})
        os.setsid()
        # pdeathsig is CLEARED on fork (prctl(2)); re-arm it here so a
        # SIGKILLed zygote (OOM killer, impatient harness) still takes
        # its workers down — our parent is the zygote.
        try:
            import ctypes

            ctypes.CDLL(None).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
            if os.getppid() == 1:
                os._exit(0)
        except Exception:
            pass
        for fd in inherited_fds:
            try:
                os.close(fd)
            except OSError:
                pass
        log_path = req.get("log_path")
        if log_path:
            fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            os.dup2(fd, 1)
            os.dup2(fd, 2)
            os.close(fd)
        os.environ.update(req.get("env") or {})
        # Tells worker.main the template already collect+froze the
        # startup heap — a cold spawn must do it itself.
        os.environ["RAY_TPU_TORCH_FORKED_FROM_ZYGOTE"] = "1"
        # Distinct randomness per fork (the template's PRNG state is
        # copied on write): worker-side ids/jitter must not collide.
        import random

        random.seed(os.urandom(16))
        try:
            import numpy as np

            np.random.seed(int.from_bytes(os.urandom(4), "big"))
        except ImportError:
            pass
        from ray_tpu_torch._private import worker as worker_mod

        worker_mod.main()
        os._exit(0)
    except BaseException:
        import traceback

        traceback.print_exc()
        os._exit(1)


def main() -> None:
    # Die with the raylet: test clusters and crashed nodes SIGKILL the
    # raylet process, so stop()'s orderly shutdown never reaches us.
    # PR_SET_PDEATHSIG delivers SIGTERM on parent death; our handler then
    # kills the forked workers (which inherit the same pdeathsig as a
    # second line of defense — their parent is this zygote).
    try:
        import ctypes

        ctypes.CDLL(None).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
        if os.getppid() == 1:  # parent already gone before prctl landed
            os._exit(0)
    except Exception:
        pass
    sock_path = os.environ["RAY_TPU_TORCH_ZYGOTE_SOCKET"]
    # Pay the heavy imports ONCE, before accepting spawn requests: every
    # fork inherits the warm module set copy-on-write.
    from ray_tpu_torch._private import worker as _worker_mod  # noqa: F401

    # Pre-import the torch MODULE too: tasks import it, and paying that
    # per fork serialized every worker/actor bring-up through the
    # zygote. Importing torch does NOT initialize CUDA (nothing here may:
    # a child forked after cuInit fails its first CUDA call), so each
    # child still pins its cards through CUDA_VISIBLE_DEVICES at its
    # first task.
    try:
        import torch  # noqa: F401
    except ImportError:
        pass
    # And the train package (the session, the worker group, DCP): every
    # TrainWorker, a Tune trial among them, imports it at its first run,
    # about 2 s of CPU an actor otherwise. It makes no CUDA context.
    import ray_tpu_torch.train  # noqa: F401

    # Collect-then-freeze the warm template heap ONCE pre-fork: every
    # child inherits a frozen startup heap (no per-spawn gc.collect —
    # ~70ms each on a warm heap) and its own collections skip the
    # template's permanent objects.
    import gc

    gc.collect()
    gc.freeze()

    signal.signal(signal.SIGCHLD, _reap)
    signal.signal(signal.SIGTERM,
                  lambda s, f: (_kill_children(), os._exit(0)))
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(sock_path)
    server.listen(1)
    # Readiness marker: the raylet connect-retries until this appears.
    print("zygote: ready", flush=True)
    while True:
        try:
            conn, _ = server.accept()
        except InterruptedError:
            continue
        with conn:
            f = conn.makefile("rwb")
            while True:
                try:
                    line = f.readline()
                except InterruptedError:
                    continue
                except OSError:
                    break
                if not line:
                    break  # raylet went away; await a reconnect
                # Per-request errors (fork EAGAIN under memory pressure,
                # malformed frame) must NOT kill the zygote: its death
                # SIGTERMs every live forked worker via pdeathsig. Reply
                # with the error; the raylet falls back to a cold spawn.
                try:
                    req = json.loads(line)
                    if req.get("shutdown"):
                        _kill_children()
                        return
                    # SIGCHLD is blocked across fork + bookkeeping: a
                    # child crashing instantly would otherwise be reaped
                    # BEFORE _children.add, leaving a stale pid that
                    # _kill_children could later deliver to a recycled
                    # process.
                    signal.pthread_sigmask(signal.SIG_BLOCK,
                                           {signal.SIGCHLD})
                    try:
                        pid = _spawn(req, [server.fileno(), conn.fileno()])
                        _children.add(pid)
                    finally:
                        signal.pthread_sigmask(signal.SIG_UNBLOCK,
                                               {signal.SIGCHLD})
                    reply = {"pid": pid}
                except Exception as e:  # noqa: BLE001
                    reply = {"error": f"{type(e).__name__}: {e}"}
                try:
                    f.write((json.dumps(reply) + "\n").encode())
                    f.flush()
                except OSError:
                    break  # raylet hung up mid-reply; await a reconnect


if __name__ == "__main__":
    main()
