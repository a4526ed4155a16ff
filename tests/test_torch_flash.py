"""The port's ``flash_attention`` (on CPU tensors: its plain version,
``flash_attention_plain``) against the reference's Pallas
``flash_attention`` (interpret mode) and its oracle ``flash_attention_ref``,
at the cases and tolerances of ``tests/test_flash_attention.py``: 2e-4 in
f32, 2e-2 in bf16.  Inputs are seeded numpy arrays handed to both
packages.  The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro_torch.kernels import flash_attention as FA


def _inputs(b, sq, sk, h, kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dh)).astype(np.float32))


def _check(qkv, dtype, tol, **kw):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in qkv)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in qkv)
    out = FA.flash_attention(tq, tk, tv, **kw)
    assert out.dtype == td and out.shape == tq.shape
    assert torch.equal(out, FA.flash_attention_plain(tq, tk, tv, **kw))
    o = out.float().numpy()
    pal = jflash(jq, jk, jv, bq=64, bk=64, interpret=True, **kw)
    ref = jflash_ref(jq, k=jk, v=jv, **kw)
    np.testing.assert_allclose(o, np.asarray(pal, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(o, np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,kv,dh", [
    (1, 128, 4, 4, 64), (2, 256, 4, 2, 64), (1, 256, 8, 2, 128),
    (2, 128, 6, 6, 64),
])
def test_causal_matches_reference(b, s, h, kv, dh):
    _check(_inputs(b, s, s, h, kv, dh), "f32", 2e-4, causal=True)


def test_noncausal_and_bf16():
    _check(_inputs(1, 128, 128, 4, 4, 64, seed=1), "bf16", 2e-2, causal=False)


def test_sliding_window():
    _check(_inputs(1, 256, 256, 4, 4, 64, seed=2), "f32", 2e-4, causal=True,
           window=64)


def test_softcap_gemma2_style():
    _check(_inputs(1, 128, 128, 4, 2, 64, seed=3), "f32", 2e-4, causal=True,
           softcap=50.0)


def test_wrapper_refuses_bad_heads_and_windows():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 6, 4, 16))
    with pytest.raises(ValueError, match="multiple of"):
        FA.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, v, window=0)
