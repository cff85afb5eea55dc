"""Quick check of the flash attention kernels on one NVIDIA GPU: the
first call to make after editing ray_tpu_torch/ops/csrc/flash_attention.cu.

Builds the kernels and shows what they compiled to: ptxas's registers
and spills for each flash kernel (when this call built the source), from
`cuobjdump` of the built libraries each kernel's resource use (the paged
decode kernels' too), and each flash kernel's counts of HGMMA (wgmma),
UTMALDG (TMA tile load) and UBLKCP (bulk copy) instructions. Then it
runs chip_smoke.py's flash phase: the kernels against their plain
versions over its cases, and their times at the training shape (B 2,
H 16, S 2048, D 128, causal, bf16) under both of chip_smoke.Timer's
readings (ms, busy_ms), printed as one JSON line per kernel.

    python3 scripts/torch_flash_check.py
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from ray_tpu_torch import _build  # noqa: E402

SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP")


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")


def sass_counts(lib) -> dict:
    """{kernel: {op: count}} over the library's SASS, flash kernels only."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "flash" in name:
            counts[name] = {op: len(re.findall(rf"\b{op}\b", part))
                            for op in SASS_OPS}
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_flash_check: no CUDA device available")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    lib = libs["flash_attention"]
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = _build.build_log  # empty when the libraries were built before
    if "== flash_attention.cu" in log:
        print(log[log.index("== flash_attention.cu"):].split("\n== ")[0])
    for path in libs.values():
        usage = subprocess.run([_cuobjdump(), "-res-usage", str(path)],
                               check=True, capture_output=True, text=True,
                               timeout=300).stdout
        print("\n".join(line.strip() for line in usage.splitlines()
                        if "REG:" in line or "Function" in line))
    for name, counts in sass_counts(lib).items():
        print("sass " + json.dumps({"kernel": name, **counts}))
    for row in chip_smoke.flash_kernel_phase(card).values():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
