"""Quick check of the flash attention kernels on one NVIDIA GPU: the
first call to make after editing ray_tpu_torch/ops/csrc/flash_attention.cu.

Builds the kernels (printing ptxas's register and spill counts for the
flash source when it builds it), then runs chip_smoke.py's flash phase:
the kernels against their plain versions over its cases, and their times
at the training shape (B 2, H 16, S 2048, D 128, causal, bf16), which it
prints as one JSON line per kernel.

    python3 scripts/torch_flash_check.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from ray_tpu_torch import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_flash_check: no CUDA device available")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = _build.build_log  # empty when the libraries were built before
    if "== flash_attention.cu" in log:
        print(log[log.index("== flash_attention.cu"):].split("\n== ")[0])
    for row in chip_smoke.flash_kernel_phase(card).values():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
