"""The paged decode CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.
The file imports neither jax nor ray_tpu, so it runs where only the port
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.ops import paged_attention as pa  # noqa: E402

pytestmark = pytest.mark.cuda

# f32 as the JAX package's paged tests; bf16/f16 one or two output ulps.
TOLERANCES = [pytest.param(torch.float32, 2e-4, id="f32"),
              pytest.param(torch.bfloat16, 2e-2, id="bf16"),
              pytest.param(torch.float16, 2e-3, id="f16")]
# (H, Hkv, D, page): MHA, the LLAMA3_8B engine shape, MQA over two
# chunks per page, a page that is not a power of two, a group large
# enough that the chunk shrinks to fit shared memory, and a page of 12
# (TMA boxes of 4 rows, unswizzled) with D 72 (a column atom half used).
SHAPES = [(8, 8, 32, 8), (32, 8, 128, 64), (8, 1, 256, 128), (12, 4, 16, 48),
          (64, 1, 256, 128), (8, 2, 72, 12)]
NP = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, dtype, H, Hkv, D, page, lengths=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    if lengths is None:
        lengths = [1, page, page + 1, NP * page - 1, NP * page, NP * page + 5]
    B, P = len(lengths), len(lengths) * NP + 1

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    k_pool, v_pool, q = randn(P, Hkv, page, D), randn(P, Hkv, page, D), \
        randn(B, H, D)
    perm = torch.randperm(P, generator=g, device=dev).tolist()
    rows = []
    for length in lengths:
        own = [perm.pop() for _ in range(max(1, min(-(-length // page), NP)))]
        rows.append((own + [own[-1]] * NP)[:NP])
    tables = torch.tensor(rows, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, tables, torch.tensor(lengths, dtype=torch.int32,
                                                   device=dev)


@pytest.mark.parametrize("dtype,tol", TOLERANCES)
@pytest.mark.parametrize("H,Hkv,D,page", SHAPES)
@pytest.mark.parametrize("fused_heads", [False, True])
def test_batch_kernel_matches_plain(cuda, dtype, tol, H, Hkv, D, page,
                                    fused_heads):
    args = _inputs(cuda, dtype, H, Hkv, D, page)
    key = ("paged_decode_attention_batch_fused" if fused_heads
           else "paged_decode_attention_batch")
    before = pa.launch_counts[key]
    out = pa.paged_decode_attention_batch(*args, fused_heads=fused_heads)
    want = pa.paged_decode_attention_batch_reference(*args)
    torch.cuda.synchronize()
    assert pa.launch_counts[key] == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", TOLERANCES[:2])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_split_kernel_at_engine_shapes(cuda, dtype, tol, B):
    """K4 (split over the page table) at the LLAMA3_8B engine's shapes: a
    9-page table of 64-token pages, B * Hkv = 8, 64 and 256 blocks' worth
    of (sequence, KV head) against 132 SMs (split 9, 5 and 2 ways). Every
    batch holds lengths 1, 63, 64, 65 and the whole table (B = 1 takes
    them one by one). At length 1 the one token's p is exp(0) = 1, so K4
    and K3 both give that token's V to the bit."""
    H, Hkv, D, page, n_pages = 32, 8, 128, 64, 9
    g = torch.Generator(device=cuda).manual_seed(B)
    edge = [1, 63, 64, 65, n_pages * page]
    batches = [[x] for x in edge] if B == 1 else \
        [edge + torch.randint(1, n_pages * page + 1, (B - len(edge),),
                              generator=g, device=cuda).tolist()]
    for lengths in batches:
        P = B * n_pages + 1
        k_pool, v_pool = (torch.randn(P, Hkv, page, D, generator=g,
                                      device=cuda).to(dtype)
                          for _ in range(2))
        q = torch.randn(B, H, D, generator=g, device=cuda).to(dtype)
        perm = torch.randperm(P, generator=g, device=cuda).tolist()
        rows = []
        for length in lengths:
            own = [perm.pop() for _ in range(-(-length // page))]
            rows.append((own + [own[-1]] * n_pages)[:n_pages])
        args = (q, k_pool, v_pool,
                torch.tensor(rows, dtype=torch.int32, device=cuda),
                torch.tensor(lengths, dtype=torch.int32, device=cuda))
        before = pa.launch_counts["paged_decode_attention_batch_fused"]
        out = pa.paged_decode_attention_batch(*args, fused_heads=True)
        want = pa.paged_decode_attention_batch_reference(*args)
        k3 = pa.paged_decode_attention_batch(*args)
        torch.cuda.synchronize()
        assert pa.launch_counts["paged_decode_attention_batch_fused"] == \
            before + 1
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        for i in (i for i, x in enumerate(lengths) if x == 1):
            v0 = v_pool[rows[i][0], :, 0].repeat_interleave(H // Hkv, dim=0)
            assert torch.equal(out[i], v0) and torch.equal(k3[i], v0)


@pytest.mark.parametrize("dtype,tol", TOLERANCES)
@pytest.mark.parametrize("H,Hkv,D,page", [(8, 8, 32, 8), (32, 8, 128, 64),
                                          (8, 2, 72, 12)])
def test_length_zero_averages_the_table(cuda, dtype, tol, H, Hkv, D, page):
    """At length 0 every score is -1e30, so the reference's p is exp(0) = 1
    on all NP * page tokens of the table, padding included: K2, K3 and K4
    give the mean of V over the table, as the plain version does, beside
    sequences of other lengths in the same batch."""
    args = _inputs(cuda, dtype, H, Hkv, D, page,
                   lengths=[0, 3, 0, NP * page, 0], seed=1)
    want = pa.paged_decode_attention_batch_reference(*args)
    q, k_pool, v_pool, tables, lengths = args
    mean = v_pool[tables[0].long()].float().mean(dim=(0, 2))  # (Hkv, D)
    torch.testing.assert_close(
        want[0].float(), mean.repeat_interleave(H // Hkv, dim=0).to(dtype)
        .float(), rtol=tol, atol=tol)
    for fused in (False, True):
        out = pa.paged_decode_attention_batch(*args, fused_heads=fused)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
    for b in (0, 2, 4):
        one = (q[b], k_pool, v_pool, tables[b], lengths[b])
        torch.testing.assert_close(
            pa.paged_decode_attention(*one).float(),
            pa.paged_decode_attention_reference(*one).float(), rtol=tol,
            atol=tol)


@pytest.mark.parametrize("dtype,tol", TOLERANCES)
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_cluster_kernel_grid(cuda, dtype, tol, B, G, D, page):
    """The K2/K3 kernel over its split choices: B 1, 8 and 32 sequences of
    mixed lengths (a 9-page table), G query rows a KV head, and two calls
    bitwise equal (the splits merge in a fixed order)."""
    Hkv, n_pages = 4, 9
    g = torch.Generator(device=cuda).manual_seed(B * 100 + G)
    lengths = torch.randint(0, n_pages * page + 1, (B,), generator=g,
                            device=cuda).tolist()
    lengths[0] = n_pages * page
    P = B * n_pages + 1
    k_pool, v_pool = (torch.randn(P, Hkv, page, D, generator=g,
                                  device=cuda).to(dtype) for _ in range(2))
    q = torch.randn(B, G * Hkv, D, generator=g, device=cuda).to(dtype)
    tables = torch.randperm(P, generator=g, device=cuda)[:B * n_pages].to(
        torch.int32).view(B, n_pages)
    args = (q, k_pool, v_pool, tables,
            torch.tensor(lengths, dtype=torch.int32, device=cuda))
    before = pa.launch_counts["paged_decode_attention_batch"]
    out = pa.paged_decode_attention_batch(*args)
    again = pa.paged_decode_attention_batch(*args)
    want = pa.paged_decode_attention_batch_reference(*args)
    torch.cuda.synchronize()
    assert pa.launch_counts["paged_decode_attention_batch"] == before + 2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


def test_single_sequence_kernel_matches_plain(cuda):
    q, k_pool, v_pool, tables, lengths = _inputs(cuda, torch.float32,
                                                 32, 8, 128, 64)
    before = pa.launch_counts["paged_decode_attention"]
    for b in range(q.shape[0]):
        out = pa.paged_decode_attention(q[b], k_pool, v_pool, tables[b],
                                        lengths[b])
        want = pa.paged_decode_attention_reference(q[b], k_pool, v_pool,
                                                   tables[b], lengths[b])
        torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()
    assert pa.launch_counts["paged_decode_attention"] == before + q.shape[0]


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k_pool, v_pool, tables, lengths = _inputs(cuda, torch.float32,
                                                 8, 8, 32, 8)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_decode_attention_batch(q, k_pool, v_pool, tables.long(),
                                        lengths)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_decode_attention_batch(q.double(), k_pool.double(),
                                        v_pool.double(), tables, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention_batch(q.transpose(0, 1).contiguous()
                                        .transpose(0, 1), k_pool, v_pool,
                                        tables, lengths)
    with pytest.raises(ValueError, match="multiple of 8"):
        pa.paged_decode_attention_batch(q[..., :20].contiguous(),
                                        k_pool[..., :20].contiguous(),
                                        v_pool[..., :20].contiguous(),
                                        tables, lengths)
    # a contiguous view one float past an aligned allocation
    unaligned = torch.empty(k_pool.numel() + 1, device=cuda)[1:].view(
        k_pool.shape)
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_decode_attention_batch(q, unaligned, v_pool, tables, lengths)
