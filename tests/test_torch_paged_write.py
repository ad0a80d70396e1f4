"""PyTorch port vs the JAX package: K9's fused paged write on the CPU.

The plain version of ``ops/paged_write.py::paged_write_kv`` (which
``kv_cache.write_kv``/``write_kv_flat`` call; on a CPU tensor the wrapper
runs it) must leave the page pool bit-identical to the JAX package's
``write_kv``/``write_kv_flat``: every storage mode and scale form, exact
ties at (n + 1/2)·s and values past the clamp, pad rows, a strided V (a
view of a fused qkv tensor, as the model hands it over), int32 and int64
indices.  Inputs are made with numpy and go through both packages."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_v2_tpu.serving import kv_cache as JKV
from gptq_v2_tpu_torch.ops import paged_write as TPW
from gptq_v2_tpu_torch.serving import kv_cache as TKV
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

L_, P, PS, HKV, HD = 2, 13, 4, 4, 16
# per-head scales; the powers of two make (n + 1/2)·s an exact tie
HEAD_SCALES = {0: (0.03125, 0.027, 0.0625, 0.041), 4: (0.25, 0.3, 0.5, 0.37)}
# pool dtype, input dtype, kv_bits, k scale, v scale ("h": one per kv head)
STORES = {
    "bf16": ("bfloat16", "bfloat16", 0, None, None),
    "bf16_from_fp32": ("bfloat16", "float32", 0, None, None),
    "fp32": ("float32", "float32", 0, None, None),
    "int8": ("int8", "float32", 0, 0.03125, 0.027),
    "int8_per_head": ("int8", "bfloat16", 0, "h", "h"),
    "int8_mixed": ("int8", "float32", 0, 0.0625, "h"),
    "int4": ("int8", "bfloat16", 4, "h", "h"),
    "int4_scalar": ("int8", "float32", 4, 0.25, 0.37),
    "int4_mixed": ("int8", "bfloat16", 4, "h", 0.5),
}


def _scales(store):
    """Per-layer scales for the port (floats or tuples) and for JAX.  The
    JAX paged int8 path divides by the layer's entry as given, so a
    per-head int8 scale goes to it as an ``(n_kv, 1)`` array."""
    _, _, bits, ks, vs = STORES[store]
    if ks is None:
        return None, None, None, None
    port, jax_ = [], []
    for s in (ks, vs):
        s = HEAD_SCALES[bits] if s == "h" else s
        layers = tuple(s if isinstance(s, float) else tuple(x * (1 + 0.1 * li) for x in s)
                       for li in range(L_))
        port.append(layers)
        jax_.append(layers if bits == 4 else tuple(
            s if isinstance(s, float) else np.asarray(s, np.float32)[:, None] for s in layers))
    return port[0], port[1], jax_[0], jax_[1]


def _caches(store, rng):
    pool_dtype, _, bits, _, _ = STORES[store]
    ks, vs, jks, jvs = _scales(store)
    n_comb = HKV if bits == 4 else 2 * HKV
    if pool_dtype == "int8":
        pool = rng.integers(-128, 128, (L_, P, PS, n_comb, HD)).astype(np.int8)
    else:
        pool = rng.standard_normal((L_, P, PS, n_comb, HD)).astype(np.float32)
    jc = JKV.PagedKVCache(jnp.asarray(pool).astype(getattr(jnp, pool_dtype)), PS, jks, jvs,
                          kv_bits=bits)
    tc = TKV.paged_cache_from_numpy(np.asarray(jc.kv), PS, ks, vs, kv_bits=bits, device="cpu")
    return jc, tc


def _inputs(store, lead, layer, rng):
    """K and V as fp32 numpy with ties at (n + 1/2)·s of this layer's
    scales and values past the clamp; the port's V a strided view."""
    _, in_dtype, bits, _, _ = STORES[store]
    ks, vs, _, _ = _scales(store)
    kw = HKV * HD
    a = (rng.standard_normal((*lead, 3 * kw)) * 2).astype(np.float32)
    a[..., ::23] *= 40
    for j, s in enumerate((ks, vs)):
        if s is None:
            continue
        per = np.broadcast_to(np.asarray(s[layer], np.float32), (HKV,))
        blk = a[..., (1 + j) * kw:(2 + j) * kw].reshape(*lead, HKV, HD)
        blk[..., :HD // 2] = (np.arange(-4, 4, dtype=np.float32) + 0.5)[None] * per[:, None]
        a[..., (1 + j) * kw:(2 + j) * kw] = blk.reshape(*lead, kw)
    k = a[..., kw:2 * kw].reshape(*lead, HKV, HD)
    v = a[..., 2 * kw:].reshape(*lead, HKV, HD)
    jk, jv = (jnp.asarray(x).astype(getattr(jnp, in_dtype)) for x in (k, v))
    qkv = torch.from_numpy(a).to(getattr(torch, in_dtype))
    tk = qkv[..., kw:2 * kw].reshape(*lead, HKV, HD).contiguous()
    tv = qkv[..., 2 * kw:].reshape(*lead, HKV, HD)
    assert not tv.is_contiguous()
    return jk, jv, tk, tv


def _check_trash(tc, jc, pad_rows):
    """Page 0 as JAX leaves it, but the trash slot (page 0, offset 0), where
    pad rows land in any order: each of its elements from one of them."""
    got, want = tc.kv.float().numpy(), np.asarray(jc.kv).astype(np.float32)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_array_equal(got[:, 0, 1:], want[:, 0, 1:])
    for layer, rows in pad_rows:
        rows = np.asarray(rows).astype(np.float32)
        assert (got[layer, 0, 0][None] == rows).any(0).all()


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("store", list(STORES))
def test_paged_write_kv_matches_jax_write_kv(store, idx_dtype):
    """``write_kv`` (block tables, positions, a pad mask) over two layers."""
    rng = np.random.default_rng(len(store))
    jc, tc = _caches(store, rng)
    tables = np.array([[3, 7, 1, 0], [5, 2, 8, 0]], np.int32)
    pos = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    pad = np.array([[0, 0, 0, 1, 1], [0, 0, 0, 0, 1]], bool)
    pad_rows = []
    n0 = TPW.paged_write_kv.launches
    for layer in (0, 1):
        jk, jv, tk, tv = _inputs(store, (2, 5), layer, rng)
        jc = JKV.write_kv(jc, layer, jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                          pad_mask=jnp.asarray(pad))
        TKV.write_kv(tc, layer, tk, tv, torch.from_numpy(tables).to(idx_dtype),
                     torch.from_numpy(pos).to(idx_dtype), pad_mask=torch.from_numpy(pad))
        qk, qv = JKV.quantize_kv_write(jc, layer, jk[pad], jv[pad])
        pad_rows.append((layer, JKV.interleave_kv(qk, qv)))
    _check_trash(tc, jc, pad_rows)
    assert TPW.paged_write_kv.launches == n0  # CPU: the plain version


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("store", list(STORES))
def test_paged_write_kv_matches_jax_write_kv_flat(store, idx_dtype):
    """``write_kv_flat`` (host-computed pages and offsets, two pad rows on
    the trash slot) over two layers."""
    rng = np.random.default_rng(10 + len(store))
    jc, tc = _caches(store, rng)
    pages = np.array([4, 4, 9, 12, 6, 0, 0], np.int32)
    offs = np.array([0, 3, 1, 2, 0, 0, 0], np.int32)
    pad_rows = []
    n0 = TPW.paged_write_kv.launches
    for layer in (0, 1):
        jk, jv, tk, tv = _inputs(store, (7,), layer, rng)
        jc = JKV.write_kv_flat(jc, layer, jk, jv, jnp.asarray(pages), jnp.asarray(offs))
        TKV.write_kv_flat(tc, layer, tk, tv, torch.from_numpy(pages).to(idx_dtype),
                          torch.from_numpy(offs).to(idx_dtype))
        qk, qv = JKV.quantize_kv_write(jc, layer, jk[5:, None], jv[5:, None])
        pad_rows.append((layer, JKV.interleave_kv(qk[:, 0], qv[:, 0])))
    _check_trash(tc, jc, pad_rows)
    assert TPW.paged_write_kv.launches == n0


@pytest.mark.parametrize("bits,per_head", [(0, False), (0, True), (4, False), (4, True)])
def test_storage_rows_one_definition(bits, per_head):
    """``kv_cache.quantize_kv_write`` on the paged cache is the helpers of
    ``ops/paged_write.py``, and both equal JAX's ``quantize_kv_write``."""
    store = {(0, False): "int8", (0, True): "int8_per_head", (4, False): "int4_scalar",
             (4, True): "int4"}[(bits, per_head)]
    rng = np.random.default_rng(bits + per_head)
    jc, tc = _caches(store, rng)
    jk, jv, tk, tv = _inputs(store, (3, 2), 1, rng)
    want = JKV.quantize_kv_write(jc, 1, jk, jv)
    got = TKV.quantize_kv_write(tc, 1, tk, tv)
    direct = (TPW.storage_rows(tk, tc.k_scale_t[1], torch.int8, bits),
              TPW.storage_rows(tv, tc.v_scale_t[1], torch.int8, bits))
    for g, d, w in zip(got, direct, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(d.numpy(), np.asarray(w))
