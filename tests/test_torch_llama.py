"""The port's Llama against the JAX package's, on weights converted from
the flax tree: full forward, dense-cache prefill + decode, and one paged
decode step (logits and the updated pools). f32 on the CPU, tolerance
1e-4; the JAX paged kernel runs in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# The GQA tiny config of tests/test_llm_paged.py.
SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, attention="reference",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="reference")
    jmodel = jl.LlamaModel(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32))
    tparams = convert.params_from_flax(jax.device_get(jparams), tcfg)
    tmodel = tl.LlamaModel.from_params(tcfg, tparams, torch.device("cpu"))
    # jit: one compile per call shape instead of op-by-op dispatch.
    return jcfg, jax.jit(jmodel.apply), jparams, tcfg, tmodel


def test_full_forward_matches_jax(models):
    _, japply, jparams, _, tmodel = models
    tokens = np.random.default_rng(0).integers(0, 128, (2, 12))
    want = japply(jparams, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_cache_prefill_then_decode_matches_jax(models):
    jcfg, japply, jparams, tcfg, tmodel = models
    B, S, L = 2, 9, 32
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 128, (B, S))
    nxt = rng.integers(0, 128, (B,))
    pos = np.arange(S)[None].repeat(B, 0)

    jl_pre, jc = japply(jparams, jnp.asarray(tokens, jnp.int32),
                        jnp.asarray(pos), kv_caches=jl.init_kv_caches(
                            jcfg, B, L))
    jl_dec, jc = japply(jparams, jnp.asarray(nxt[:, None], jnp.int32),
                        jnp.full((B, 1), S), kv_caches=jc)
    with torch.no_grad():
        tl_pre, tc = tmodel(torch.from_numpy(tokens), torch.from_numpy(pos),
                            kv_caches=tl.init_kv_caches(tcfg, B, L))
        tl_dec, tc = tmodel(torch.from_numpy(nxt[:, None]),
                            torch.full((B, 1), S), kv_caches=tc)
    np.testing.assert_allclose(tl_pre.numpy(), np.asarray(jl_pre), **TOL)
    np.testing.assert_allclose(tl_dec.numpy(), np.asarray(jl_dec), **TOL)
    for (jk, jv, jn), (tk, tv, tn) in zip(jc, tc):
        assert int(jn) == tn == S + 1
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_paged_decode_step_matches_jax(models):
    jcfg, japply, jparams, tcfg, tmodel = models
    B, P, page, NP = 3, 12, 16, 3
    Hkv, Dh = jcfg.n_kv_heads, jcfg.head_dim
    rng = np.random.default_rng(2)
    pools = [tuple(rng.standard_normal((P, Hkv, page, Dh)).astype(np.float32)
                   for _ in range(2)) for _ in range(jcfg.n_layers)]
    tables = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    lens = np.array([5, 16, 40], np.int32)   # write offsets, one per page
    token = rng.integers(0, 128, (B, 1))
    pos = lens[:, None].astype(np.int64)

    jcaches = [jl.PagedKVCache(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(tables), jnp.asarray(lens))
               for k, v in pools]
    jlogits, jnew = japply(jparams, jnp.asarray(token, jnp.int32),
                           jnp.asarray(pos), kv_caches=jcaches)
    tcaches = [tl.PagedKVCache(torch.from_numpy(k.copy()),
                               torch.from_numpy(v.copy()),
                               torch.from_numpy(tables), torch.from_numpy(lens))
               for k, v in pools]
    with torch.no_grad():
        tlogits, tnew = tmodel(torch.from_numpy(token), torch.from_numpy(pos),
                               kv_caches=tcaches)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for jc, tc in zip(jnew, tnew):
        np.testing.assert_array_equal(tc.length.numpy(), lens + 1)
        np.testing.assert_allclose(tc.k_pool.numpy(), np.asarray(jc.k_pool),
                                   **TOL)
        np.testing.assert_allclose(tc.v_pool.numpy(), np.asarray(jc.v_pool),
                                   **TOL)


def test_bf16_params_convert_bit_exact():
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.bfloat16, attention="reference",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.bfloat16, attention="reference")
    tree = jax.device_get(jax.jit(jl.LlamaModel(jcfg).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32)))
    got = convert.params_from_flax(tree, tcfg)
    p = tree["params"]
    pairs = [(got["embed.weight"], p["embed"]["embedding"]),
             (got["lm_head.weight"], p["lm_head"]["kernel"].T),
             (got["layers.1.attn.k_proj.weight"],
              p["layers_1"]["attn"]["k_proj"]["kernel"].T),
             (got["layers.0.mlp.down_proj.weight"],
              p["layers_0"]["mlp"]["down_proj"]["kernel"].T),
             (got["norm.scale"], p["norm"]["scale"])]
    for t, a in pairs:
        a = np.ascontiguousarray(a)
        assert str(t.dtype).split(".")[1] == a.dtype.name
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(
            t.view(torch.int16 if bits is np.uint16 else torch.int32)
            .numpy().view(bits), a.view(bits))
    # Every converted tensor loads into the port's model as it is.
    model = tl.LlamaModel.from_params(tcfg, got, torch.device("cpu"))
    assert model.layers[0].attn.q_proj.weight.dtype == torch.bfloat16
    assert model.norm.scale.dtype == torch.float32
