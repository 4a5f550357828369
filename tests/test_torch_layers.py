"""Each ported layer function of ``repro_torch.models.layers`` against
``repro.models.layers`` on the same numpy inputs, in f32 on the CPU
(atol 1e-5: the two frameworks sum in different orders)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as ref  # noqa: E402
from repro_torch.models import layers as pt  # noqa: E402

ATOL = 1e-5
RNG = np.random.default_rng(5)


def _normal(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got), np.asarray(want, np.float32),
        atol=atol, rtol=0)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def test_rms_norm():
    x, w = _normal(2, 5, 32), _normal(32)
    _close(pt.rms_norm(T(x), T(w), 1e-6), ref.rms_norm(J(x), J(w), 1e-6))


def test_rope():
    _close(pt.rope_freqs(16, 1e6), ref.rope_freqs(16, 1e6))
    x = _normal(2, 7, 4, 16)
    pos = np.arange(3, 10, dtype=np.int32)[None].repeat(2, 0)
    _close(pt.apply_rope(T(x), T(pos), 1e6), ref.apply_rope(J(x), J(pos),
                                                            1e6))


ATTN_CASES = [
    dict(causal=True, window=None),
    dict(causal=True, window=5),
    dict(causal=False, window=None),
]


@pytest.mark.parametrize("kw", ATTN_CASES)
@pytest.mark.parametrize("path", ["full", "blocked", "flash_plain"])
def test_attention_paths(kw, path):
    """full-mask and double-blocked plain paths, and the flash kernel's
    plain version (impl='pallas' on the CPU), against the reference's
    XLA attention."""
    B, S, H, Hkv, D = 2, 32, 4, 2, 16
    q, k, v = _normal(B, S, H, D), _normal(B, S, Hkv, D), _normal(B, S, Hkv,
                                                                   D)
    want = ref.attention(J(q), J(k), J(v), impl="xla", **kw)
    if path == "full":
        got = pt.attention(T(q), T(k), T(v), impl="xla", **kw)
    elif path == "blocked":
        got = pt._attention_blocked(T(q), T(k), T(v), q_chunk=8,
                                    k_chunk=16, **kw)
        _close(got, ref._attention_blocked(J(q), J(k), J(v), q_chunk=8,
                                           k_chunk=16, **kw))
    else:
        got = pt.attention(T(q), T(k), T(v), impl="pallas", **kw)
    _close(got, want)


def test_attention_q_offset():
    B, S, Sk, H, Hkv, D = 1, 8, 24, 4, 2, 16
    q, k, v = _normal(B, S, H, D), _normal(B, Sk, Hkv, D), _normal(B, Sk,
                                                                    Hkv, D)
    _close(pt.attention(T(q), T(k), T(v), q_offset=16),
           ref.attention(J(q), J(k), J(v), q_offset=16, impl="xla"))


def test_quantize_roundtrip():
    x = _normal(3, 5, 2, 16)
    qp, sp = pt.quantize_kv(T(x))
    qr, sr = ref.quantize_kv(J(x))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qr))
    _close(sp, sr)
    _close(pt.dequantize_kv(qp, sp), ref.dequantize_kv(qr, sr))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("chunk", [4096, 8])
def test_decode_attention(quant, chunk):
    B, S, H, Hkv, D = 3, 32, 4, 2, 16
    q = _normal(B, 1, H, D)
    kc, vc = _normal(B, S, Hkv, D), _normal(B, S, Hkv, D)
    lens = np.asarray([5, 32, 17], np.int32)
    if quant:
        (kq, ks), (vq, vs) = ref.quantize_kv(J(kc)), ref.quantize_kv(J(vc))
        want = ref.decode_attention(J(q), kq, vq, J(lens), ks, vs,
                                    chunk=chunk)
        got = pt.decode_attention(T(q), T(kq), T(vq), T(lens), T(ks), T(vs),
                                  chunk=chunk)
    else:
        want = ref.decode_attention(J(q), J(kc), J(vc), J(lens), chunk=chunk)
        got = pt.decode_attention(T(q), T(kc), T(vc), T(lens), chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T_new,impl", [(3, "xla"), (1, "xla"),
                                        (1, "pallas")])
def test_paged_decode_attention(quant, T_new, impl):
    """The gather path for any T, and the kernel path (its plain version on
    the CPU) for T == 1, against the reference's gather path."""
    B, H, Hkv, D, P, pg = 3, 4, 2, 16, 10, 8
    q = _normal(B, T_new, H, D)
    kp, vp = _normal(P, pg, Hkv, D), _normal(P, pg, Hkv, D)
    pt_tab = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    lens = np.asarray([20, 9, 28], np.int32)
    sc = ()
    if quant:
        (kp, ks), (vp, vs) = ref.quantize_kv(J(kp)), ref.quantize_kv(J(vp))
        kp, vp, sc = np.asarray(kp), np.asarray(vp), (np.asarray(ks),
                                                      np.asarray(vs))
    want = ref.paged_decode_attention(J(q), J(kp), J(vp), J(pt_tab),
                                      J(lens), *map(J, sc), impl="xla")
    got = pt.paged_decode_attention(T(q), T(kp), T(vp), T(pt_tab), T(lens),
                                    *map(T, sc), impl=impl)
    _close(got, want)


def test_swiglu():
    x = _normal(2, 3, 16)
    wg, wu, wd = _normal(16, 32, scale=0.2), _normal(16, 32, scale=0.2), \
        _normal(32, 16, scale=0.2)
    _close(pt.swiglu(T(x), T(wg), T(wu), T(wd)),
           ref.swiglu(J(x), J(wg), J(wu), J(wd)))
