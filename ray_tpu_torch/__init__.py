"""PyTorch and CUDA port of ray_tpu's compute layer, for NVIDIA Hopper.

The JAX package `ray_tpu` stays the reference; this package keeps its
module layout and names so each counterpart is easy to find:

- `ray_tpu_torch.ops.paged_attention`: paged decode attention, a CUDA
  kernel for sm_90a (`ops/csrc/paged_decode.cu`) beside its plain
  PyTorch version, and the host-side `PageAllocator`.
- `ray_tpu_torch.models`: the Llama decoder, flax weight conversion and
  the dense-cache `Generator`.
- `ray_tpu_torch.serve.llm`: the continuous-batching `LLMEngine` over a
  dense or a paged KV cache, its decode chunk a CUDA graph on the card.

Nothing here imports jax or ray_tpu, and importing a module does no CUDA
work: kernels are built with nvcc at first use (`_build.py`). Entry
points take `device=None`, which means CUDA, and raise where no card is
present; pass `device="cpu"` to run the plain versions on the CPU.
"""
