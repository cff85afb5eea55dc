"""Build and run the C++ unit tests of the port's native pieces
(ray_tpu_torch/_private/csrc/*_test.cc), one case per binary, as the
reference's tests/test_native_units.py runs its `make test`.

Each binary compiles with g++ into ray_tpu_torch/_build/units/ from the
port's own sources (raylet_core_test.cc includes the GPU card free-list
cases, raylet_lease_test.cc the GPU-demand fallthrough). The ASan/UBSan
and TSan variants are `slow`-marked, as the reference marks them: a
sanitizer build and run takes minutes, so the tier-1 gate
(`-m 'not slow'`) skips them. Every binary takes the directory of its
scratch files (arenas, WAL files) as its argument: the test's tmp_path.
"""

import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import pytest

CSRC = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "ray_tpu_torch", "_private", "csrc"))
BUILD = os.path.normpath(os.path.join(CSRC, "..", "..", "_build", "units"))

# binary -> (sources beside the test, line its success prints)
UNITS = {
    "store_test": (("object_store.cc",), "store_test: OK"),
    "scheduler_test": (("scheduler.cc",), "scheduler_test: OK"),
    "transfer_test": (("transfer.cc", "object_store.cc"),
                      "transfer_test: ALL OK"),
    "raylet_core_test": (("raylet_core.cc",),
                         "raylet_core_test: all passed"),
    "gcs_store_test": (("gcs_store.cc",), "gcs_store_test: all passed"),
    "fastpath_test": (("fastpath.cc",), "fastpath_test: ALL OK"),
    "gcs_service_test": (("gcs_service.cc", "fastpath.cc", "gcs_store.cc"),
                         "gcs_service_test: all OK"),
    "gcs_actor_test": (("gcs_actor.cc", "fastpath.cc"),
                       "gcs_actor_test: all OK"),
    "raylet_lease_test": (("raylet_lease.cc", "fastpath.cc",
                           "raylet_core.cc"), "raylet_lease_test: all OK"),
}

SANITIZERS = {"asan": "-fsanitize=address,undefined",
              "tsan": "-fsanitize=thread"}

_toolchain = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ on this machine")


def _flags(variant: str) -> list:
    # Sanitized builds as the reference's Makefile builds its tests; the
    # plain ones unoptimised, which halves their compile time.
    return (["-O1", "-g", SANITIZERS[variant]] if variant else ["-O0"]) + [
        "-Wall", "-std=c++17"]


def _build(names, variant: str = "") -> dict:
    """Compile every source the binaries `names` need once (in parallel),
    then link each binary; returns {name: path}."""
    out_dir = os.path.join(BUILD, variant or "plain")
    os.makedirs(out_dir, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    srcs = sorted({f"{n}.cc" for n in names}
                  | {s for n in names for s in UNITS[n][0]})

    def compile_one(src):
        obj = os.path.join(out_dir, src[:-3] + ".o")
        cmd = [cxx, *_flags(variant), "-c", "-o", obj,
               os.path.join(CSRC, src)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        assert res.returncode == 0, f"{' '.join(cmd)}\n{res.stderr[-4000:]}"
        return src, obj

    with ThreadPoolExecutor(max_workers=4) as pool:
        objs = dict(pool.map(compile_one, srcs))
    paths = {}
    for n in names:
        out = os.path.join(out_dir, n)
        cmd = [cxx, *_flags(variant), "-o", out, objs[f"{n}.cc"],
               *(objs[s] for s in UNITS[n][0]), "-lpthread"]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        assert res.returncode == 0, f"{' '.join(cmd)}\n{res.stderr[-4000:]}"
        paths[n] = out
    return paths


@pytest.fixture(scope="module")
def plain_binaries():
    """Every plain binary, built once for the module."""
    return _build(sorted(UNITS))


def _run(path: str, scratch, timeout: int = 300):
    return subprocess.run([path, str(scratch)], capture_output=True,
                          text=True, timeout=timeout,
                          cwd=os.path.dirname(path))


@_toolchain
@pytest.mark.parametrize("name", sorted(UNITS))
def test_cpp_unit(name, plain_binaries, tmp_path):
    res = _run(plain_binaries[name], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert UNITS[name][1] in res.stdout


@pytest.mark.slow
@_toolchain
@pytest.mark.parametrize("variant", sorted(SANITIZERS))
@pytest.mark.parametrize("name", sorted(UNITS))
def test_cpp_unit_sanitized(name, variant, tmp_path):
    res = _run(_build([name], variant)[name], tmp_path, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert UNITS[name][1] in res.stdout
    assert "ERROR: AddressSanitizer" not in res.stdout + res.stderr
    assert "WARNING: ThreadSanitizer" not in res.stdout + res.stderr
