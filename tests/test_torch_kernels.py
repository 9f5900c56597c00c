"""The port's plain kernel versions (``repro_torch.kernels.ref``, the CPU
route of ``kernels.ops``) against the reference's Pallas kernels, run in
interpret mode as ``tests/test_kernels.py`` runs them, on the same inputs
made with numpy.  Shapes, dtypes and bounds are that file's: 2e-2 absolute
for RMSNorm (fp32 and bf16), 1e-4 absolute for fp32 flash attention."""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash import flash_attention as jflash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RMS_BOUND = 2e-2      # tests/test_kernels.py::test_rmsnorm_pallas
FLASH_BOUND = 1e-4    # tests/test_kernels.py::test_flash_attention_pallas

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(a):
    return np.asarray(a, np.float32) if not torch.is_tensor(a) else a.float().numpy()


@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 128), (3, 5, 256)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_pallas(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    scale = np.linspace(0.5, 1.5, shape[-1]).astype(np.float32)
    y_pallas = rmsnorm_pallas(jnp.asarray(x, jdt), jnp.asarray(scale))
    y_port = ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale))
    assert y_port.dtype == tdt and y_port.shape == shape
    assert np.abs(_f32(y_port) - _f32(y_pallas)).max() < RMS_BOUND
    # and the reference's own oracle, bit for bit in fp32 up to rounding order
    y_jref = jref.rmsnorm_ref(jnp.asarray(x, jdt), jnp.asarray(scale))
    assert np.abs(_f32(ref.rmsnorm_ref(torch.from_numpy(x).to(tdt),
                                       torch.from_numpy(scale))) - _f32(y_jref)).max() < RMS_BOUND


def _qkv(B, Sq, Sk, Hq, Hkv, h, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((B, Sq, Hq, h)).astype(np.float32),
            rs.standard_normal((B, Sk, Hkv, h)).astype(np.float32),
            rs.standard_normal((B, Sk, Hkv, h)).astype(np.float32))


@pytest.mark.parametrize("B,S,Hq,Hkv,h", [(1, 64, 2, 2, 16), (2, 128, 4, 2, 32),
                                           (1, 96, 6, 3, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas(B, S, Hq, Hkv, h, causal):
    q, k, v = _qkv(B, S, S, Hq, Hkv, h)
    o_pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                      q_block=32, kv_block=32)
    o_port = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    assert o_port.shape == (B, S, Hq, h)
    assert np.abs(o_port.numpy() - np.asarray(o_pallas)).max() < FLASH_BOUND


@pytest.mark.parametrize("Sq,Sk", [(50, 50), (37, 81)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_any_length(Sq, Sk, causal):
    """The Pallas kernel needs block multiples; the port's plain version takes
    any Sq, Sk.  Held against the dense formula of tests/test_kernels.py,
    with both positions counted from 0 as the kernel counts them."""
    B, Hq, Hkv, h = 2, 4, 2, 32
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, h, seed=1)
    G = Hq // Hkv
    kk, vv = jnp.repeat(jnp.asarray(k), G, axis=2), jnp.repeat(jnp.asarray(v), G, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kk) / math.sqrt(h)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((Sq, Sk), bool))[None, None], s, -1e30)
    o_dense = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), vv)
    o_port = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    assert np.abs(o_port.numpy() - np.asarray(o_dense)).max() < FLASH_BOUND
