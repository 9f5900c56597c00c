"""Kernel dispatch of the port (``repro_torch.kernels.ops``), and the CUDA
kernels against their plain versions on the card.

No JAX here, so the same file runs on the machine with the card:
``python -m pytest tests/test_torch_ops.py -m gpu``.  The CUDA cases are
marked ``gpu`` and skip, with the reason, where no card is present.
Bounds: RMSNorm 2e-2 absolute (the reference's bound, fp32/bf16/fp16)
and 1e-5 in fp32; flash attention 1e-4 absolute in fp32 (the reference's
bound) and 2e-2 in bf16/fp16, where the output itself is rounded to
2^-8 relative."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

RMS_BOUND = 2e-2
RMS_BOUND_F32 = 1e-5
FLASH_BOUND_F32 = 1e-4
FLASH_BOUND_HALF = 2e-2


def _t(shape, seed=0, dtype=torch.float32, device="cpu"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launches()
    x, s = _t((3, 5, 64)), torch.linspace(0.5, 1.5, 64)
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    q, k, v = _t((2, 40, 4, 16), 1), _t((2, 40, 2, 16), 2), _t((2, 40, 2, 16), 3)
    assert torch.equal(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    assert torch.equal(ops.flash_attention(q, k, v, backend="ref", causal=False),
                       ref.flash_attention_ref(q, k, v, causal=False))
    assert ops.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0}
    assert _build._LIB is None          # nothing was built for the CPU route


def test_cuda_backend_on_cpu_tensor_raises():
    x, s = _t((4, 64)), torch.ones(64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, s, backend="cuda")
    q = _t((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.rmsnorm(x, s, backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm_cuda(x, s)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)
    assert _build._LIB is None


def test_reset_launches():
    ops.LAUNCHES["rmsnorm"] = 7
    ops.reset_launches()
    assert ops.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 128), (3, 5, 256), (8, 4096),
                                   (5, 100), (1, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("scale_fp32", [True, False])
def test_rmsnorm_kernel_matches_ref(cuda, shape, dtype, scale_fp32):
    x = _t(shape, dtype=dtype, device=cuda)
    s = torch.linspace(0.5, 1.5, shape[-1], device=cuda)
    s = s if scale_fp32 else s.to(dtype)
    ops.reset_launches()
    y = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == 1
    assert y.dtype == dtype and y.shape == x.shape
    err = (y.float() - ref.rmsnorm_ref(x, s).float()).abs().max().item()
    assert err < (RMS_BOUND_F32 if dtype == torch.float32 else RMS_BOUND)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,h", [
    (1, 64, 64, 2, 2, 16), (2, 128, 128, 4, 2, 32), (1, 96, 96, 6, 3, 64),
    (2, 300, 300, 32, 8, 128), (1, 37, 81, 4, 1, 64), (3, 1, 70, 8, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_kernel_matches_ref(cuda, B, Sq, Sk, Hq, Hkv, h, causal, dtype):
    q = _t((B, Sq, Hq, h), 1, dtype, cuda)
    k = _t((B, Sk, Hkv, h), 2, dtype, cuda)
    v = _t((B, Sk, Hkv, h), 3, dtype, cuda)
    ops.reset_launches()
    o = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert o.dtype == dtype and o.shape == q.shape
    err = (o.float() - ref.flash_attention_ref(q, k, v, causal=causal).float()).abs().max().item()
    assert err < (FLASH_BOUND_F32 if dtype == torch.float32 else FLASH_BOUND_HALF)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = _t((1, 8, 2, 48), device=cuda)          # head dim 48 is not instantiated
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    x = _t((4, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        rmsnorm_cuda(x, torch.ones(64, device=cuda, dtype=torch.float16))
