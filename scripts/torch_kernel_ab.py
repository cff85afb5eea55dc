"""Times the port's kernels in two or more checkouts on one NVIDIA GPU, in
turns, so that a change can be set against its parent on the same card.

    python3 scripts/torch_kernel_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (a `git archive` of the parent
commit, say); each is timed in a process of its own, in the order given,
with that checkout's `ray_tpu_torch` (built there at first use) and this
checkout's `chip_smoke` inputs and Timer. Kernels, at the shapes of
chip_smoke.py's main rows: the flash forward K1 and backward K1-bwd (B 2,
H 16, S 2048, D 128, causal, bf16, q, k and v as the model's views), the
paged decode kernels K3 and K4 (LLAMA3_8B engine shapes, B 8, bf16) and
K2 (the same pool, the sequence that fills its 9-page table). Prints one
JSON line per (checkout, kernel) with both Timer readings, `ms` and
`busy_ms`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, whichever checkout is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(_REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_tree(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = _chip_smoke()
    from ray_tpu_torch.ops import attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    if os.path.abspath(fa.__file__) != os.path.join(
            os.path.abspath(tree), "ray_tpu_torch", "ops", "attention.py"):
        raise AssertionError(f"ray_tpu_torch came from {fa.__file__}")
    timer = cs.Timer()
    B, H, S, D = cs.TRAIN_B, cs.TRAIN_CFG.n_heads, cs.TRAIN_S, \
        cs.TRAIN_CFG.head_dim
    q, k, v, do = cs.flash_inputs(torch.bfloat16, B, H, S, S, D)
    scale = 1 / math.sqrt(D)
    res = (q, k, v, *fa._flash_forward(q, k, v, scale, True, 512, 512))
    args, lengths = cs.kernel_inputs(cs.MAX_BATCH, torch.bfloat16,
                                     seed=cs.MAX_BATCH)
    full = lengths.index(cs.NP * cs.PAGE)
    one = (args[0][full], args[1], args[2], args[3][full], args[4][full])
    kernels = {
        "flash_attention_forward":
            lambda: fa._flash_forward(q, k, v, scale, True, 512, 512),
        "flash_attention_backward":
            lambda: fa._flash_backward(scale, True, 512, 512, None, res, do),
        "paged_decode_attention_batch":
            lambda: pa.paged_decode_attention_batch(*args),
        "paged_decode_attention_batch_fused":
            lambda: pa.paged_decode_attention_batch(*args, fused_heads=True),
        "paged_decode_attention": lambda: pa.paged_decode_attention(*one),
    }
    for name, fn in kernels.items():
        print(json.dumps({"tree": tree, "kernel": name, "ms": timer(fn),
                          "busy_ms": timer(fn, busy=True)}), flush=True)


def main(argv) -> None:
    if argv[:1] == ["--one"]:
        time_tree(argv[1])
        return
    if not argv:
        sys.exit(__doc__)
    sys.path.insert(0, _REPO)
    print(_chip_smoke().card_line(), flush=True)
    for tree in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True, timeout=900)


if __name__ == "__main__":
    main(sys.argv[1:])
