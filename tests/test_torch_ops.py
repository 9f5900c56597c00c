"""Kernel dispatch of the port (``repro_torch.kernels.ops``), and the CUDA
kernels against their plain versions on the card.

No JAX here, so the same file runs on the machine with the card:
``python -m pytest tests/test_torch_ops.py -m gpu``.  The CUDA cases are
marked ``gpu`` and skip, with the reason, where no card is present.
Bounds: RMSNorm 2e-2 absolute (the reference's bound, fp32/bf16/fp16)
and 1e-5 in fp32; flash attention 1e-4 absolute in fp32 (the reference's
bound) and 2e-2 in bf16/fp16, where the output itself is rounded to
2^-8 relative; the SSD and WKV6 scans 1e-3 (fp32) and 3e-2 (bf16)
relative to max|y|, and to max(1, max|state|) for the final state (the
reference's bounds, tests/test_kernels.py), and their fp32 kernels 2e-5
against the step oracles in fp64; the smoke models through the
kernels against ``backend="ref"`` 1e-3 absolute on the logits (fp32, the
bound of ``chip_smoke.py``'s slice parity).  The backward kernels, which the
reference does not have, against autograd through the plain versions on
the same inputs: fp32 within 1e-5 (RMSNorm, of each gradient's max|g|) and
1e-4 (flash, its forward's bound, of max|g| over dq, dk and dv), against
the plain versions in fp64; bf16 and fp16 within 2e-2 of max|g| (the
forward's half-precision bound).  The SSD backward kernel (``SSDFn``), which
the reference does not have either, against fp64 autograd of the step
oracle and the plain backward ``ref.ssd_chunked_bwd_ref`` in fp64: within
1e-5 of each gradient's max|g| (its products are fp32 on the CUDA cores; its
exponents and dcum's cancelling sums are fp64)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash import HEAD_DIMS, flash_attention_bwd_cuda, flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.ssd import ssd_bwd_cuda, ssd_cuda
from repro_torch.kernels.wkv6 import wkv6_cuda
from repro_torch.models import model as M

RMS_BOUND = 2e-2
RMS_BOUND_F32 = 1e-5
FLASH_BOUND_F32 = 1e-4
FLASH_BOUND_HALF = 2e-2
SCAN_RTOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
# SSD's fp32 kernels against the step oracle in fp64: the chunk products are
# fp32-exact (3xTF32); one TF32 product per chunk product errs by ~8e-4
SSD_EXACT_RTOL = 2e-5
# WKV6's fp32 kernels against the step oracle in fp64, as SSD_EXACT_RTOL: their
# exponents are sums over the rows they span, so strong decays cost no accuracy
WKV6_EXACT_RTOL = 2e-5
MODEL_LOGITS_BOUND = 1e-3
RMS_GRAD_BOUND = 1e-5            # relative to max|g|, fp32 against the plain version in fp64
FLASH_GRAD_BOUND = 1e-4          # relative to max|g|, fp32 against the plain version in fp64
HALF_GRAD_BOUND = 2e-2           # relative to max|g|, bf16/fp16
SSD_GRAD_BOUND = 1e-5           # relative to each gradient's max|g|, fp32 against fp64
NO_LAUNCHES = {"rmsnorm": 0, "flash_attention": 0, "ssd": 0, "wkv6": 0, "rmsnorm_bwd": 0,
               "flash_attention_bwd": 0, "ssd_bwd": 0}


def _t(shape, seed=0, dtype=torch.float32, device="cpu"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _wkv(B, S, H, K, V, dtype=torch.float32, device="cpu", seed=0, spread=0.5):
    """r, k (B,S,H,K), v (B,S,H,V) in ``dtype``; w_log (B,S,H,K) ≤ 0 and u
    (H,K) in fp32, as tests/test_kernels.py draws them; w_log =
    −exp(spread · randn), so spread = 2 gives steps that decay by e^-1000
    and more beside steps that hardly decay."""
    r, k = _t((B, S, H, K), seed, dtype, device), _t((B, S, H, K), seed + 1, dtype, device)
    v = _t((B, S, H, V), seed + 2, dtype, device)
    w = -torch.exp(_t((B, S, H, K), seed + 3, device=device) * spread)
    return r, k, v, w, _t((H, K), seed + 4, device=device) * 0.1


def _ssd(B, S, H, P, N, dtype=torch.float32, device="cpu", seed=0):
    """x (B,S,H,P), Bm, Cm (B,S,H,N) in ``dtype``; dt (B,S,H) > 0, A (H,) < 0
    and D (H,) in fp32."""
    x = _t((B, S, H, P), seed, dtype, device)
    dt = torch.nn.functional.softplus(_t((B, S, H), seed + 1, device=device))
    A = -torch.exp(_t((H,), seed + 2, device=device) * 0.3)
    Bm, Cm = _t((B, S, H, N), seed + 3, dtype, device), _t((B, S, H, N), seed + 4, dtype, device)
    return x, dt, A, Bm, Cm, torch.ones(H, device=device)


def _ssd_views(B, S, H, P, G, N, dtype=torch.float32, device="cpu", seed=0):
    """x (B,S,H,P), Bm and Cm (B,S,G,N) as views of one (B, S, H·P + 2·G·N)
    buffer, as the Mamba2 block's conv output holds them."""
    buf = _t((B, S, H * P + 2 * G * N), seed, dtype, device)
    x, Bm, Cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    return x.unflatten(-1, (H, P)), Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))


def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launches()
    x, s = _t((3, 5, 64)), torch.linspace(0.5, 1.5, 64)
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    q, k, v = _t((2, 40, 4, 16), 1), _t((2, 40, 2, 16), 2), _t((2, 40, 2, 16), 3)
    assert torch.equal(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    assert torch.equal(ops.flash_attention(q, k, v, backend="ref", causal=False),
                       ref.flash_attention_ref(q, k, v, causal=False))
    r, k, v, w, u = _wkv(2, 40, 3, 16, 16)
    y, st = ops.wkv6(r, k, v, w, u)
    y2, st2 = ref.wkv6_chunked_ref(*(ops._pad_seq(a, 32) for a in (r, k, v, w)), u, chunk=32)
    assert torch.equal(y, y2[:, :40]) and torch.equal(st, st2)
    one = [a[:, :1] for a in (r, k, v, w)]
    assert all(torch.equal(a, b) for a, b in zip(ops.wkv6(*one, u), ref.wkv6_ref(*one, u)))
    x, dt, A, Bm, Cm, D = _ssd(2, 40, 3, 16, 16)
    y, st = ops.ssd(x, dt, A, Bm, Cm, D)
    xp, dtp, Bp, Cp = (ops._pad_seq(a, 64) for a in (x, dt, Bm, Cm))
    y2, st2 = ref.ssd_chunked_ref(xp, dtp, A, Bp, Cp, D)
    assert torch.equal(y, y2[:, :40]) and torch.equal(st, st2)
    assert all(torch.equal(a, b) for a, b in zip(ops.ssd(x, dt, A, Bm, Cm, D, backend="ref"),
                                                 ref.ssd_ref(x, dt, A, Bm, Cm, D)))
    assert ops.LAUNCHES == NO_LAUNCHES
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
    r, k, v, w, u = _wkv(1, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.wkv6(r, k, v, w, u, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_cuda(r, k, v, w, u)
    x, dt, A, Bm, Cm, D = _ssd(1, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ssd(x, dt, A, Bm, Cm, D, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda(x, dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.ssd(x, dt, A, Bm, Cm, D, backend="pallas")
    assert _build._LIB is None


@pytest.mark.parametrize("S", [1, 40])
def test_ssd_plain_routes_take_groups_views_and_out_state(S):
    """On CPU tensors ``ops.ssd`` expands grouped B and C to the heads, reads
    strided views, and copies the final state into ``out_state`` (which may
    be ``state``): the same numbers as head-expanded contiguous inputs."""
    x, Bm, Cm = _ssd_views(2, S, 6, 16, 2, 16)
    _, dt, A, _, _, D = _ssd(2, S, 6, 16, 16)
    s0 = _t((2, 6, 16, 16), 5)
    Be, Ce = (a.repeat_interleave(3, dim=2).contiguous() for a in (Bm, Cm))
    for backend in (None, "ref", "chunked"):
        y_ref, st_ref = ops.ssd(x.contiguous(), dt, A, Be, Ce, D, s0, backend=backend)
        st = s0.clone()
        y, st_out = ops.ssd(x, dt, A, Bm, Cm, D, st, out_state=st, backend=backend)
        assert st_out is st and torch.equal(y, y_ref) and torch.equal(st, st_ref)
    with pytest.raises(ValueError, match="groups"):
        ops.ssd(x, dt, A, Bm[:, :, :1].expand(2, S, 4, 16), Cm[:, :, :1].expand(2, S, 4, 16), D)
    assert ops.LAUNCHES == NO_LAUNCHES


@pytest.mark.parametrize("S", [1, 40])
def test_ssd_ref_computes_in_fp64_for_fp64_inputs(S):
    """The step oracle keeps fp64 inputs in fp64 (the card's yardstick for
    the fp32 kernels' accuracy), keeps fp32 as it was, and the two agree."""
    args = _ssd(2, S, 3, 16, 16)
    s0 = _t((2, 3, 16, 16), 5)
    y32, st32 = ref.ssd_ref(*args, s0)
    y64, st64 = ref.ssd_ref(*(a.double() for a in args), s0.double())
    assert y32.dtype == st32.dtype == torch.float32
    assert y64.dtype == st64.dtype == torch.float64
    assert (y64 - y32.double()).abs().max().item() < 1e-5 * y64.abs().max().item()
    assert (st64 - st32.double()).abs().max().item() < 1e-5 * max(1.0, st64.abs().max().item())


@pytest.mark.parametrize("S", [1, 40])
def test_wkv6_ref_computes_in_fp64_for_fp64_inputs(S):
    """The WKV6 step oracle keeps fp64 inputs in fp64 (the card's yardstick
    for the fp32 kernels' accuracy), keeps fp32 as it was, and the two
    agree."""
    args = _wkv(2, S, 3, 16, 32)
    s0 = _t((2, 3, 16, 32), 5)
    y32, st32 = ref.wkv6_ref(*args, s0)
    y64, st64 = ref.wkv6_ref(*(a.double() for a in args), s0.double())
    assert y32.dtype == st32.dtype == torch.float32
    assert y64.dtype == st64.dtype == torch.float64
    assert (y64 - y32.double()).abs().max().item() < 1e-5 * y64.abs().max().item()
    assert (st64 - st32.double()).abs().max().item() < 1e-5 * max(1.0, st64.abs().max().item())


@pytest.mark.parametrize("S", [1, 40])
def test_wkv6_plain_routes_take_out_state(S):
    """On CPU tensors ``ops.wkv6`` copies the final state into ``out_state``
    (which may be ``state``) and returns that tensor: the same numbers as a
    call without it, on every plain route."""
    args = _wkv(2, S, 3, 16, 32)
    s0 = _t((2, 3, 16, 32), 5)
    for backend in (None, "ref", "chunked"):
        y_ref, st_ref = ops.wkv6(*args, s0, backend=backend)
        st = s0.clone()
        y, st_out = ops.wkv6(*args, st, out_state=st, backend=backend)
        assert st_out is st and torch.equal(y, y_ref) and torch.equal(st, st_ref)
    assert ops.LAUNCHES == NO_LAUNCHES


def test_cpu_gradients_take_the_plain_versions():
    """With grad enabled, CPU tensors go through the plain versions and
    autograd: the gradients are autograd's through ``ref``, and nothing is
    launched or built."""
    ops.reset_launches()
    x, s = _t((3, 5, 64)).requires_grad_(), torch.linspace(0.5, 1.5, 64).requires_grad_()
    q, k, v = (_t(shape, i).requires_grad_() for i, shape in
               enumerate(((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16))))
    dy, do = _t((3, 5, 64), 7), _t((2, 40, 4, 16), 8)
    got = torch.autograd.grad([ops.rmsnorm(x, s), ops.flash_attention(q, k, v)],
                              [x, s, q, k, v], [dy, do])
    want = torch.autograd.grad([ref.rmsnorm_ref(x, s), ref.flash_attention_ref(q, k, v)],
                               [x, s, q, k, v], [dy, do])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.LAUNCHES == NO_LAUNCHES
    assert _build._LIB is None


def test_reset_launches():
    ops.LAUNCHES["rmsnorm"] = 7
    ops.LAUNCHES["ssd"] = 3
    ops.LAUNCHES["flash_attention_bwd"] = 2
    ops.LAUNCHES_BY_SHAPE["rmsnorm D=64"] = 7
    ops.LAUNCHES_BY_SHAPE["rmsnorm_bwd D=512"] = 4
    ops.LAUNCHES_BY_SHAPE["flash_attention_bwd h=64 full Sq>1 Sk!=Sq"] = 2
    ops.reset_launches()
    assert ops.LAUNCHES == NO_LAUNCHES and not ops.LAUNCHES_BY_SHAPE


@pytest.mark.parametrize("Sq,Sk,causal,want", [
    (300, 300, True, "flash_attention h=64 causal Sq>1 Sk=Sq"),
    (300, 64, False, "flash_attention h=64 full Sq>1 Sk!=Sq"),
    (1, 64, False, "flash_attention h=64 full Sq=1 Sk!=Sq"),
    (64, 64, False, "flash_attention h=64 full Sq>1 Sk=Sq"),
    # the backward's, as whisper trains: its encoder, decoder and cross-attention
    (1500, 1500, False, "flash_attention_bwd h=64 full Sq>1 Sk=Sq"),
    (448, 448, True, "flash_attention_bwd h=64 causal Sq>1 Sk=Sq"),
    (448, 1500, False, "flash_attention_bwd h=64 full Sq>1 Sk!=Sq")])
def test_shape_class(Sq, Sk, causal, want):
    """The classes phases 15 and 16 of chip_smoke.py split flash's launches
    by, forward and backward; RMSNorm's by its last dim."""
    q, k = torch.empty(2, Sq, 4, 64), torch.empty(2, Sk, 4, 64)
    name = want.split(" ")[0]
    assert ops.shape_class(name, q, k, causal) == want
    norm = "rmsnorm_bwd" if name.endswith("_bwd") else "rmsnorm"
    assert ops.shape_class(norm, torch.empty(3, 5, 512)) == f"{norm} D=512"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the forward's path edges: a warp a row up to 32 x 8 vectors (D 128, 512,
# 1024 in fp32), a block a row past that (1032) up to 8 vectors a thread
# (7168, 8192), the generic path past it (16384); rows: one, a decode batch,
# a count that is no multiple of a sweep or a ring stage, fewer rows than the
# grid has blocks, and several stages a block
_RMS_FWD_SHAPES = ([(4, 64), (2, 7, 128), (3, 5, 256), (8, 4096), (5, 100), (1, 3), (4, 16384)]
                   + [(rows, D) for D in (128, 512, 1024, 1032, 2048, 3584, 7168, 8192)
                      for rows in (1, 8, 33, 100, 4099)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _RMS_FWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("scale_fp32", [True, False])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_kernel_matches_ref(cuda, shape, dtype, scale_fp32, offset):
    """The forward kernel against the plain version; at ``offset`` 1, x is a
    view one element past a 16-byte boundary (the generic path).  A second
    run gives the same bits."""
    n = int(np.prod(shape))
    x = _t((n + offset,), dtype=dtype, device=cuda)[offset:].view(shape)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    s = torch.linspace(0.5, 1.5, shape[-1], device=cuda)
    s = s if scale_fp32 else s.to(dtype)
    ops.reset_launches()
    y = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == 1
    assert y.dtype == dtype and y.shape == x.shape
    err = (y.float() - ref.rmsnorm_ref(x, s).float()).abs().max().item()
    assert err < (RMS_BOUND_F32 if dtype == torch.float32 else RMS_BOUND)
    assert torch.equal(ops.rmsnorm(x, s), y)


@pytest.mark.gpu
def test_rmsnorm_fwd_instantiations_do_not_spill(cuda):
    """What ptxas says of every instantiation of the RMSNorm forward, built
    with the port's flags (``chip_smoke.rmsnorm_fwd_build_report``, which
    fails on a spill or a missing one): 8 for each of the 5 dtype pairs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    report = chip_smoke.rmsnorm_fwd_build_report()
    assert len(report) == 40
    assert all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in report.values())


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,h", [
    (1, 64, 64, 2, 2, 16), (2, 128, 128, 4, 2, 32), (1, 96, 96, 6, 3, 64),
    (2, 300, 300, 32, 8, 128), (1, 37, 81, 4, 1, 64), (3, 1, 70, 8, 8, 128),
    (2, 200, 200, 32, 32, 112), (1, 1, 45, 4, 4, 112),
    # the tile edges of the kernel's 128-row query tiles and 64-key K/V
    # tiles: one m16n8k8 tile (16 rows, 8 keys, h = 16); one key past a K/V
    # tile (65); one row past a query tile (129); exactly one query tile
    # over two K/V tiles (128) and one short of each (127 rows, 63 keys);
    # ragged lengths inside one tile (33); one query row against a ragged
    # tile; a single key; more keys than queries
    (1, 16, 8, 1, 1, 16), (1, 65, 65, 2, 2, 64), (2, 129, 129, 4, 2, 128),
    (2, 128, 128, 4, 1, 112), (1, 127, 63, 2, 2, 64),
    (2, 33, 33, 2, 1, 112), (2, 1, 33, 4, 2, 128), (2, 7, 1, 2, 1, 16),
    (1, 48, 130, 4, 4, 128)])
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


def _alibi(Hq):
    """Slopes as the models draw them (``layers.alibi_slopes``)."""
    from repro_torch.models.layers import alibi_slopes

    return alibi_slopes(Hq)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,h", [
    (2, 200, 200, 32, 32, 80), (1, 129, 129, 4, 1, 80), (2, 1, 45, 8, 2, 80),
    (1, 300, 300, 8, 2, 128), (2, 65, 130, 4, 4, 64), (1, 600, 600, 4, 1, 80)])
@pytest.mark.parametrize("window", [0, 1, 16, 100, 256])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_window_alibi_h80_match_ref(cuda, B, Sq, Sk, Hq, Hkv, h, window,
                                                 alibi, causal):
    """Head dim 80, sliding windows (1 key, less than one K/V tile, more
    than one, more than the query tile) and ALiBi, each alone and together,
    fp32, against the plain version: one launch each, within 1e-4."""
    q = _t((B, Sq, Hq, h), 1, device=cuda)
    k, v = _t((B, Sk, Hkv, h), 2, device=cuda), _t((B, Sk, Hkv, h), 3, device=cuda)
    slopes = _alibi(Hq).to(cuda) if alibi else None
    ops.reset_launches()
    o = ops.flash_attention(q, k, v, causal=causal, window=window, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and o.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, alibi_slopes=slopes)
    assert (o - want).abs().max().item() < FLASH_BOUND_F32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_window_h80_half(cuda, dtype):
    q = _t((2, 300, 8, 80), 1, dtype, cuda)
    k, v = _t((2, 300, 2, 80), 2, dtype, cuda), _t((2, 300, 2, 80), 3, dtype, cuda)
    o = ops.flash_attention(q, k, v, window=70)
    want = ref.flash_attention_ref(q, k, v, window=70)
    assert o.dtype == dtype and (o.float() - want.float()).abs().max().item() < FLASH_BOUND_HALF


@pytest.mark.gpu
def test_flash_without_window_or_alibi_is_unchanged(cuda):
    """window = 0 and no slopes run the kernel the llama3-8b path always ran:
    bit-equal to a window wider than every row's reach."""
    q = _t((2, 300, 8, 128), 1, device=cuda)
    k, v = _t((2, 300, 2, 128), 2, device=cuda), _t((2, 300, 2, 128), 3, device=cuda)
    assert torch.equal(flash_attention_cuda(q, k, v), flash_attention_cuda(q, k, v, window=300))


@pytest.mark.gpu
def test_flash_alibi_kernel_refuses_what_it_does_not_take(cuda):
    q = _t((1, 8, 4, 64), device=cuda)
    s = _alibi(4).to(cuda)
    with pytest.raises(ValueError, match="fp32"):
        flash_attention_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16(), alibi_slopes=s)
    with pytest.raises(ValueError, match="fp32"):
        flash_attention_cuda(q.half(), q.half(), q.half(), alibi_slopes=s, with_lse=True)
    with pytest.raises(ValueError, match="alibi_slopes"):
        flash_attention_cuda(q, q, q, alibi_slopes=s[:2])
    with pytest.raises(ValueError, match="window"):
        flash_attention_cuda(q, q, q, window=-1)


@pytest.mark.parametrize("what", ["bf16_alibi", "fp16_alibi", "negative_window",
                                  "short_slopes"])
def test_flash_attention_fn_refuses_what_the_kernels_do_not_take(what):
    """What the kernels do not take (ALiBi in bf16 or fp16, a negative
    window, slopes of the wrong shape) raises ``ValueError`` at
    ``FlashAttentionFn``'s forward, saying so, before any kernel runs (so
    on any device)."""
    dtype = {"bf16_alibi": torch.bfloat16, "fp16_alibi": torch.float16}.get(what, torch.float32)
    q = _t((1, 8, 4, 80), dtype=dtype).requires_grad_()
    window = -1 if what == "negative_window" else 0
    slopes = None if what == "negative_window" else _alibi(2 if what == "short_slopes" else 4)
    match = {"negative_window": "window", "short_slopes": "alibi_slopes"}.get(what, "fp32")
    ops.reset_launches()
    with pytest.raises(ValueError, match=match):
        ops.FlashAttentionFn.apply(q, q, q, True, window, slopes)
    assert ops.LAUNCHES == NO_LAUNCHES


@pytest.mark.gpu
def test_flash_refuses_unaligned_tensors(cuda):
    """The kernel copies fp32 rows in 16-byte pieces: a contiguous fp32 view
    that starts 4 bytes into its storage is refused, not read misaligned."""
    shape = (1, 8, 2, 16)
    buf = _t((1 + int(np.prod(shape)),), device=cuda)
    q = buf[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    k = _t(shape, 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(k, q, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_takes_unaligned_half_tensors(cuda, dtype):
    """bf16 and fp16 rows are read element by element: a view that starts 2
    bytes into its storage is taken, and matches the plain version."""
    shape = (1, 40, 2, 64)
    buf = _t((1 + int(np.prod(shape)),), 1, dtype, cuda)
    q = buf[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    k, v = _t(shape, 2, dtype, cuda), _t(shape, 3, dtype, cuda)
    o = flash_attention_cuda(q, k, v, causal=True)
    err = (o.float() - ref.flash_attention_ref(q, k, v, causal=True).float()).abs().max().item()
    assert err < FLASH_BOUND_HALF


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = _t((1, 8, 2, 48), device=cuda)          # head dim 48 is not instantiated
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    x = _t((4, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        rmsnorm_cuda(x, torch.ones(64, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="P=48"):
        ssd_cuda(*_ssd(1, 4, 2, 48, 16, device=cuda))
    with pytest.raises(ValueError, match="K=48"):
        wkv6_cuda(*_wkv(1, 4, 2, 48, 64, device=cuda))
    with pytest.raises(TypeError):
        wkv6_cuda(*_wkv(1, 4, 2, 64, 64, dtype=torch.float16, device=cuda))


def _close_scan(y, st, y_ref, st_ref, dtype, rtol=None):
    rtol = SCAN_RTOL[dtype] if rtol is None else rtol
    y_ref, st_ref = y_ref.double(), st_ref.double()
    assert y.dtype == dtype and st.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert (y.double() - y_ref).abs().max().item() < rtol * (y_ref.abs().max().item() or 1.0)
    assert (st.double() - st_ref).abs().max().item() < rtol * max(1.0, st_ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,P,N", [(2, 4, 128, 16), (2, 112, 64, 64), (1, 3, 32, 128),
                                     (1, 2, 128, 128)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 100, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("layout", ["expanded", "grouped", "strided"])
def test_ssd_kernel_matches_ref(cuda, B, H, P, N, S, dtype, with_state, layout):
    """Smoke zamba2 (P=128, N=16) and full zamba2-7b (P=N=64) heads, and
    P = N = 128, the one shape whose chunked kernel has a single input
    buffer; S = 1 (decode), chunk multiples and not, the chunk's edges.
    ``expanded``: B and C per head (G = H), contiguous; ``grouped``: one
    group (G = 1), x, B and C views of one conv-output buffer, as the
    Mamba2 block passes them; ``strided``: G = H, as such views.  fp32 is
    also held to the step oracle in fp64, at a bound that one TF32 product
    per chunk product would not meet."""
    x, dt, A, Bm, Cm, D = _ssd(B, S, H, P, N, dtype, cuda)
    if layout != "expanded":
        x, Bm, Cm = _ssd_views(B, S, H, P, 1 if layout == "grouped" else H, N, dtype, cuda)
        assert B * S == 1 or not x.is_contiguous()
    s0 = _t((B, H, P, N), 9, device=cuda) if with_state else None
    ops.reset_launches()
    y, st = ops.ssd(x, dt, A, Bm, Cm, D, s0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd"] == 1 and y.shape == x.shape
    _close_scan(y, st, *ops.ssd(x, dt, A, Bm, Cm, D, s0, backend="ref"), dtype)
    _close_scan(y, st, *ops.ssd(x, dt, A, Bm, Cm, D, s0, backend="chunked"), dtype)
    if dtype == torch.float32:
        exact = ops.ssd(*(a.double() for a in (x, dt, A, Bm, Cm, D)),
                        None if s0 is None else s0.double(), backend="ref")
        _close_scan(y, st, *exact, dtype, rtol=SSD_EXACT_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_updates_state_in_place(cuda, S, dtype):
    """``out_state`` aliasing ``state`` (the decode kernel at S = 1, the
    chunked one at S = 100): the call returns that tensor, holding exactly
    what a call into a new tensor gives, and y is the same."""
    B, H, P, N = 2, 8, 64, 64
    x, Bm, Cm = _ssd_views(B, S, H, P, 1, N, dtype, cuda)
    _, dt, A, _, _, D = _ssd(B, S, H, P, N, device=cuda)
    s0 = _t((B, H, P, N), 9, device=cuda)
    y_new, st_new = ops.ssd(x, dt, A, Bm, Cm, D, s0)
    st = s0.clone()
    y, st_out = ops.ssd(x, dt, A, Bm, Cm, D, st, out_state=st)
    torch.cuda.synchronize()
    assert st_out is st and torch.equal(y, y_new) and torch.equal(st, st_new)
    _close_scan(y, st, *ops.ssd(x, dt, A, Bm, Cm, D, s0, backend="ref"), dtype)


@pytest.mark.gpu
def test_ssd_refuses_misaligned_or_unpacked_views(cuda):
    """fp32 x, B, C must start on 16 bytes and have row strides of whole
    16-byte pieces (cp.async); every view needs a contiguous last dim and
    packed heads; G must divide H.  bf16 views need no alignment."""
    B, S, H, P, N = 2, 8, 4, 16, 16
    x, dt, A, Bm, Cm, D = _ssd(B, S, H, P, N, device=cuda)
    odd = _t((B, S, H * P + 2 * N + 1), device=cuda)       # rows of 97 floats
    with pytest.raises(ValueError, match="16-byte"):
        ssd_cuda(odd[..., :H * P].unflatten(-1, (H, P)), dt, A, Bm, Cm, D)
    flat = _t((B * S * H * P + 1,), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):             # base one float off
        ssd_cuda(flat[1:].view(B, S, H, P), dt, A, Bm, Cm, D)
    wide = _t((B, S, H, 2 * N), device=cuda)
    with pytest.raises(ValueError, match="packed"):
        ssd_cuda(x, dt, A, wide[..., :N], Cm, D)
    with pytest.raises(ValueError, match="packed"):
        ssd_cuda(x, dt, A, Bm, Cm.transpose(2, 3).contiguous().transpose(2, 3), D)
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_cuda(x, dt, A, Bm[:, :, :3], Cm[:, :, :3], D)
    with pytest.raises(ValueError, match="out_state"):
        ssd_cuda(x, dt, A, Bm, Cm, D, out_state=torch.empty(B, H, P, N, device=cuda,
                                                              dtype=torch.bfloat16))
    oddb = odd.to(torch.bfloat16)[..., 1:]                    # 2-byte aligned views
    xb, Bb, Cb = (oddb[..., :H * P].unflatten(-1, (H, P)),
                  oddb[..., H * P:H * P + N].unflatten(-1, (1, N)),
                  oddb[..., H * P + N:].unflatten(-1, (1, N)))
    y, st = ssd_cuda(xb, dt, A, Bb, Cb, D)
    torch.cuda.synchronize()
    _close_scan(y, st, *ops.ssd(xb, dt, A, Bb, Cb, D, backend="ref"), torch.bfloat16)


def _ssd_grads_fp64(x, dt, A, Bm, Cm, D, s0, dy, dse):
    """fp64 autograd of the step oracle (B and C expanded from their groups,
    so their gradients sum over each group's heads) for the output
    gradients dy and dse (or none for the final state)."""
    leaves = [t.detach().double().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    s = None if s0 is None else s0.detach().double().requires_grad_()
    y, st = ops.ssd(*leaves, s, backend="ref")
    loss = (y * dy.double()).sum() + (0.0 if dse is None else (st * dse.double()).sum())
    return torch.autograd.grad(loss, leaves + ([s] if s is not None else []))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,G,P,N", [(2, 8, 2, 64, 64), (2, 4, 1, 128, 16),
                                       (1, 3, 3, 64, 64)])
@pytest.mark.parametrize("S", [1, 64, 100, 500])
@pytest.mark.parametrize("states", [False, True])
def test_ssd_bwd_kernel_matches_autograd_of_ref(cuda, B, H, G, P, N, S, states):
    """``ops.ssd`` under grad on the card (``SSDFn``: the forward with its
    chunk states, then ``csrc/ssd_bwd.cu``) at the two instantiated (P, N),
    zamba2-7b's and its smoke config's, with G < H (the group sums) and
    G = H, S of one row, one chunk, a part chunk and 500 rows, x, B and C
    as views of one conv buffer; with an initial state and the final
    state's gradient or neither.  Every gradient within SSD_GRAD_BOUND of
    its max|g| of fp64 autograd of the step oracle and of the plain
    backward in fp64; one launch of each kernel; y as the forward's."""
    x, Bm, Cm = _ssd_views(B, S, H, P, G, N, device=cuda)
    _, dt, A, _, _, D = _ssd(B, S, H, P, N, device=cuda, seed=1)
    D = D + 0.5 * _t((H,), 8, device=cuda)
    s0 = _t((B, H, P, N), 9, device=cuda) if states else None
    dy = _t((B, S, H, P), 10, device=cuda)
    dse = _t((B, H, P, N), 11, device=cuda) if states else None
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    s_leaf = None if s0 is None else s0.clone().requires_grad_()
    ops.reset_launches()
    y, st = ops.ssd(*leaves, s_leaf)
    loss = (y * dy).sum() + (0.0 if dse is None else (st * dse).sum())
    got = torch.autograd.grad(loss, leaves + ([s_leaf] if states else []))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == dict(NO_LAUNCHES, ssd=1, ssd_bwd=1)
    y_fwd, _ = ops.ssd(x, dt, A, Bm, Cm, D, s0)
    assert torch.equal(y.detach(), y_fwd)
    want = _ssd_grads_fp64(x, dt, A, Bm, Cm, D, s0, dy, dse)
    plain = ref.ssd_chunked_bwd_ref(*(t.double() for t in (x, dt, A, Bm, Cm, D)),
                                    None if s0 is None else s0.double(), dy.double(),
                                    None if dse is None else dse.double())
    names = ["dx", "ddt", "dA", "dB", "dC", "dD", "dstate0"]
    for name, g, w, w2 in zip(names, got, want, plain):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        for oracle in (w, w2):      # a gradient that is zero (dA at S = 1) stays zero
            err = (g.double() - oracle).abs().max().item()
            assert err <= SSD_GRAD_BOUND * oracle.abs().max().item(), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 500])
def test_ssd_kernels_at_zamba2_decays(cuda, S):
    """zamba2-7b's initial decays, A = −linspace(1, 16, H) (cum reaches about
    −700 in a chunk, where an fp32 difference of two running sums errs by
    up to 4e-5 between neighbouring rows): y within SSD_EXACT_RTOL and every
    gradient within SSD_GRAD_BOUND of its max|g| of fp64 autograd of the
    step oracle."""
    B, H, P, N = 2, 16, 64, 64
    x, Bm, Cm = _ssd_views(B, S, H, P, 1, N, device=cuda)
    _, dt, _, _, _, D = _ssd(B, S, H, P, N, device=cuda, seed=1)
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    dy = _t((B, S, H, P), 10, device=cuda)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    y, _ = ops.ssd(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    y64, _ = ops.ssd(*(t.double() for t in (x, dt, A, Bm, Cm, D)), backend="ref")
    assert _rel_err(y.detach(), y64) <= SSD_EXACT_RTOL
    want = _ssd_grads_fp64(x, dt, A, Bm, Cm, D, None, dy, None)
    for name, g, w in zip(["dx", "ddt", "dA", "dB", "dC", "dD"], got, want):
        assert _rel_err(g, w) <= SSD_GRAD_BOUND, (name, _rel_err(g, w))


@pytest.mark.gpu
def test_ssd_bwd_is_deterministic(cuda):
    """Two backward passes of the same call give the same bits (every sum in
    a fixed order: the group sum of dB and dC too)."""
    x, Bm, Cm = _ssd_views(2, 300, 8, 64, 1, 64, device=cuda)
    _, dt, A, _, _, D = _ssd(2, 300, 8, 64, 64, device=cuda)
    dy = _t((2, 300, 8, 64), 3, device=cuda)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
        runs.append(torch.autograd.grad(ops.ssd(*leaves)[0], leaves, dy))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_ssd_bwd_refuses_what_it_does_not_take(cuda):
    """Under grad, before any launch: bf16 (``TypeError`` naming where the
    other dtypes wait), a (P, N) the backward is not built for
    (``ValueError`` listing those it takes), and ``out_state``; the
    backward wrapper refuses chunk states of another shape."""
    x, dt, A, Bm, Cm, D = _ssd(1, 70, 2, 64, 64, device=cuda)
    ops.reset_launches()
    with pytest.raises(TypeError, match="queue 2 item 3"):
        ops.ssd(x.bfloat16().requires_grad_(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D)
    x32, dt32, A32, B32, C32, D32 = _ssd(1, 70, 2, 32, 32, device=cuda)
    with pytest.raises(ValueError, match=r"\(64, 64\), \(128, 16\)"):
        ops.ssd(x32, dt32, A32.requires_grad_(), B32, C32, D32)
    st = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="out_state"):
        ops.ssd(x, dt, A, Bm, Cm, D.requires_grad_(), st, out_state=st)
    assert ops.LAUNCHES == NO_LAUNCHES
    y, _, hc = ssd_cuda(x, dt, A, Bm, Cm, D.detach(), save_states=True)
    assert hc.shape == (1, 2, 2, 64, 64)
    with pytest.raises(ValueError, match="chunk states"):
        ssd_bwd_cuda(x, dt, A, Bm, Cm, D.detach(), hc[:, :, :1].contiguous(), y)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 64, 130])
def test_ssd_forward_saves_the_chunk_start_states(cuda, S):
    """``ssd_cuda(save_states=True)``: chunk c's start state is the final
    state of a call over its first 64 c rows (the initial state at c = 0),
    and y and the final state are those of a call without it."""
    B, H, P, N = 2, 4, 64, 64
    x, dt, A, Bm, Cm, D = _ssd(B, S, H, P, N, device=cuda)
    s0 = _t((B, H, P, N), 9, device=cuda)
    y, st, hc = ssd_cuda(x, dt, A, Bm, Cm, D, s0, save_states=True)
    y2, st2 = ssd_cuda(x, dt, A, Bm, Cm, D, s0)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert torch.equal(hc[:, :, 0], s0)
    for c in range(1, hc.shape[2]):
        _, want = ssd_cuda(*(t[:, :64 * c] for t in (x, dt)), A, Bm[:, :64 * c],
                           Cm[:, :64 * c], D, s0)
        assert torch.equal(hc[:, :, c], want), c


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,K,V", [(2, 4, 64, 64), (2, 32, 64, 64), (1, 3, 16, 128),
                                     (1, 2, 128, 16), (1, 2, 128, 128), (1, 3, 32, 32)])
@pytest.mark.parametrize("S", [1, 32, 45, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("spread", [0.5, 2.0])
def test_wkv6_kernel_matches_ref(cuda, B, H, K, V, S, dtype, with_state, spread):
    """Smoke and full rwkv6 heads (K=V=64), and the corner instantiations
    (K = V = 128 has one input buffer); S = 1 (the decode step), chunk
    multiples and not; decays as the reference draws them and strong ones
    (spread 2).  fp32 is also held to the step oracle in fp64."""
    r, k, v, w, u = _wkv(B, S, H, K, V, dtype, cuda, spread=spread)
    s0 = _t((B, H, K, V), 9, device=cuda) if with_state else None
    ops.reset_launches()
    y, st = ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6"] == 1 and y.shape == v.shape
    _close_scan(y, st, *ref.wkv6_ref(r, k, v, w, u, s0), dtype)
    _close_scan(y, st, *ops.wkv6(r, k, v, w, u, s0, backend="chunked"), dtype)
    if dtype == torch.float32:
        exact = ref.wkv6_ref(*(a.double() for a in (r, k, v, w, u)),
                             None if s0 is None else s0.double())
        _close_scan(y, st, *exact, dtype, rtol=WKV6_EXACT_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_updates_state_in_place(cuda, S, dtype):
    """``out_state`` aliasing ``state`` (the decode step at S = 1, the chunked
    kernel at S = 100): the call returns that tensor, holding exactly what a
    call into a new tensor gives, and y is the same."""
    B, H, K, V = 2, 8, 64, 64
    r, k, v, w, u = _wkv(B, S, H, K, V, dtype, cuda)
    s0 = _t((B, H, K, V), 9, device=cuda)
    y_new, st_new = ops.wkv6(r, k, v, w, u, s0)
    st = s0.clone()
    y, st_out = ops.wkv6(r, k, v, w, u, st, out_state=st)
    torch.cuda.synchronize()
    assert st_out is st and torch.equal(y, y_new) and torch.equal(st, st_new)
    _close_scan(y, st, *ref.wkv6_ref(r, k, v, w, u, s0), dtype)


@pytest.mark.gpu
def test_wkv6_refuses_bad_out_state_or_misaligned_inputs(cuda):
    """``out_state`` must be a contiguous fp32 CUDA tensor of the state's
    shape, 16-byte aligned, as must the state, r, k, v and w_log (the kernels
    move rows in 16-byte pieces)."""
    B, S, H, K, V = 2, 8, 2, 16, 32
    args = _wkv(B, S, H, K, V, device=cuda)
    shape = (B, H, K, V)
    for bad in (torch.empty(shape, device=cuda, dtype=torch.bfloat16),
                torch.empty((B, H, K, V + 4), device=cuda),
                torch.empty((B, H, V, K), device=cuda).transpose(2, 3),
                torch.empty(shape)):
        with pytest.raises(ValueError, match="out_state"):
            wkv6_cuda(*args, out_state=bad)
    flat = torch.empty(int(np.prod(shape)) + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        wkv6_cuda(*args, out_state=flat[1:].view(shape))
    with pytest.raises(ValueError, match="16-byte"):
        wkv6_cuda(*args, flat[1:].view(shape))
    r = torch.empty(B * S * H * K + 1, device=cuda)[1:].view(B, S, H, K)
    with pytest.raises(ValueError, match="16-byte"):
        wkv6_cuda(r, *args[1:])
    with pytest.raises(ValueError, match="state must be"):
        wkv6_cuda(*args, torch.zeros((B, H, K, K), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers", [("zamba2-7b", 3), ("rwkv6-1.6b", 2)])
def test_smoke_model_kernels_match_ref(cuda, arch, layers):
    """A cached prefill of 70 tokens and two decode steps of the smoke model,
    through the kernels and through backend="ref": logits within 1e-3, and
    every scan launch counted (one per Mamba2 or RWKV6 layer and forward)."""
    cfg = get_smoke_config(arch).replace(num_layers=layers)
    model = M.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 72), generator=torch.Generator().manual_seed(0))
    toks = toks.to(cuda)
    out = {}
    with torch.inference_mode():
        for backend in (None, "ref"):
            ops.reset_launches()
            c = M.init_caches(cfg, 2, 128, device=cuda)
            _, c, _ = M.forward_hidden(cfg, model, {"tokens": toks[:, :70]}, c, backend=backend)
            logits = []
            for j in range(2):
                lg, c = M.decode_step(cfg, model, toks[:, 70 + j:71 + j], c, backend=backend)
                logits.append(lg)
            out[backend] = (torch.cat(logits, 1), dict(ops.LAUNCHES))
    (lk, launches), (lr, none) = out[None], out["ref"]
    assert none == NO_LAUNCHES
    scan = "wkv6" if cfg.family == "ssm" else "ssd"
    assert launches[scan] == 3 * layers
    assert (lk - lr).abs().max().item() < MODEL_LOGITS_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-small", "deepseek-v2-lite-16b", "qwen2-vl-72b"])
def test_other_family_smoke_models_kernels_match_ref(cuda, arch):
    """The other families' smoke models through the kernels and through
    backend="ref": whisper with its frames (flash in the encoder, the
    cached prefill and every cross-attention), deepseek-v2-lite's MLA (the
    latent's RMSNorm), qwen2-vl with 256 patches (M-RoPE's grid); a cached
    prefill of 300 positions and two decode steps, logits within 1e-3 and
    the launches equal to the code's."""
    cfg = get_smoke_config(arch)
    model = M.init_params(cfg, 0, device=cuda)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 302), generator=gen).to(cuda)
    batch = {"tokens": toks[:, :300]}
    if cfg.family == "audio":
        batch["frames"] = (torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
                           * 0.02).to(cuda)
    if cfg.family == "vlm":
        batch["patches"] = (torch.randn((2, M.N_PATCHES, cfg.d_model), generator=gen)
                            * 0.02).to(cuda)
    out = {}
    with torch.inference_mode():
        for backend in (None, "ref"):
            ops.reset_launches()
            c = M.init_caches(cfg, 2, 320, device=cuda)
            _, c, _ = M.forward_hidden(cfg, model, batch, c, backend=backend)
            logits = []
            for j in range(2):
                lg, c = M.decode_step(cfg, model, toks[:, 300 + j:301 + j], c, backend=backend)
                logits.append(lg)
            out[backend] = (torch.cat(logits, 1), dict(ops.LAUNCHES),
                             dict(ops.LAUNCHES_BY_SHAPE))
    (lk, launches, shapes), (lr, none, _) = out[None], out["ref"]
    assert none == NO_LAUNCHES
    L = cfg.num_layers
    want = {"whisper-small": dict(rmsnorm=0, flash_attention=cfg.encoder_layers + L + 3 * L),
            "deepseek-v2-lite-16b": dict(rmsnorm=3 * (3 * L + 1), flash_attention=0),
            "qwen2-vl-72b": dict(rmsnorm=3 * (2 * L + 1), flash_attention=L)}[arch]
    assert launches == dict(NO_LAUNCHES, **want)
    f, d = "flash_attention h=64", cfg.d_model
    want_shapes = {
        "whisper-small": {f"{f} full Sq>1 Sk=Sq": cfg.encoder_layers, f"{f} causal Sq>1 Sk=Sq": L,
                          f"{f} full Sq>1 Sk!=Sq": L, f"{f} full Sq=1 Sk!=Sq": 2 * L},
        "deepseek-v2-lite-16b": {f"rmsnorm D={d}": 3 * (2 * L + 1),
                                 f"rmsnorm D={cfg.kv_lora_rank}": 3 * L},
        "qwen2-vl-72b": {f"rmsnorm D={d}": 3 * (2 * L + 1), f"{f} causal Sq>1 Sk=Sq": L}}[arch]
    assert shapes == want_shapes
    assert (lk - lr).abs().max().item() < MODEL_LOGITS_BOUND


def _expected_train_launches(cfg):
    """One remat train step's launches of the other families' smoke models,
    by kernel and by shape class: each layer's kernels run in the forward
    and again in its recompute, and once backward."""
    L, f, fb = cfg.num_layers, "flash_attention h=64", "flash_attention_bwd h=64"
    if cfg.family == "audio":      # the encoder's full flash; self- and cross-attention
        E = cfg.encoder_layers
        shapes = {f"{f} full Sq>1 Sk=Sq": 2 * E, f"{f} causal Sq>1 Sk=Sq": 2 * L,
                  f"{f} full Sq>1 Sk!=Sq": 2 * L, f"{fb} full Sq>1 Sk=Sq": E,
                  f"{fb} causal Sq>1 Sk=Sq": L, f"{fb} full Sq>1 Sk!=Sq": L}
    elif cfg.attn_kind == "mla":   # ln1, ln2, the latent's kv_a_norm; no flash
        d, r = cfg.d_model, cfg.kv_lora_rank
        shapes = {f"rmsnorm D={d}": 4 * L + 1, f"rmsnorm D={r}": 2 * L,
                  f"rmsnorm_bwd D={d}": 2 * L + 1, f"rmsnorm_bwd D={r}": L}
    else:
        d = cfg.d_model
        shapes = {f"rmsnorm D={d}": 4 * L + 1, f"{f} causal Sq>1 Sk=Sq": 2 * L,
                  f"rmsnorm_bwd D={d}": 2 * L + 1, f"{fb} causal Sq>1 Sk=Sq": L}
    launches = dict(NO_LAUNCHES)
    for key, n in shapes.items():
        launches[key.split(" ")[0]] += n
    return launches, shapes


@pytest.mark.parametrize("arch", ["whisper-small", "deepseek-v2-lite-16b", "qwen2-vl-72b"])
def test_chip_smoke_expected_train_launches(arch):
    """``chip_smoke.expected_train_launches``, phase 16's gate on the
    trained runs' launches, counts what the shape classes below count for
    the smoke config (whose step the card test holds) and, over passes,
    for the full config."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    smoke, full = get_smoke_config(arch), get_config(arch)
    assert chip_smoke.expected_train_launches(smoke, 1) == _expected_train_launches(smoke)[0]
    assert chip_smoke.expected_train_launches(full, 3) == {
        k: 3 * v for k, v in _expected_train_launches(full)[0].items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-small", "deepseek-v2-lite-16b", "qwen2-vl-72b"])
def test_other_family_smoke_models_train_through_the_kernels(cuda, arch):
    """One AdamW step of each other family's smoke model (whisper with its
    frames, deepseek-v2-lite's MLA and MoE, qwen2-vl with 256 patches)
    through the kernels and through backend="ref" from the same weights,
    the plain step replaying the kernels' routing: updated parameters
    within 1e-4, loss and grad_norm within 1e-5 relative (eps 1e-3, as
    chip_smoke.py's parity steps), and the launches, forward and backward,
    by kernel and by shape class, equal to the code's."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, stub_inputs
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as T

    cfg = get_smoke_config(arch)
    # whisper's 48 text positions against the smoke encoder's 64 frames: its
    # cross-attention has Sk != Sq
    B, S = (1, M.N_PATCHES + 64) if cfg.family == "vlm" else (2, 48)
    batch = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                       seed=1)).batch(0)
    batch.update(stub_inputs(cfg, B))
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
    out, routing = {}, None
    for backend in (None, "ref"):
        model = M.init_params(cfg, 0, device=cuda)
        state = adamw.init_state(dict(model.named_parameters()))
        step = T.make_train_step(cfg, T.TrainConfig(
            opt=adamw.AdamWConfig(lr=3e-4, eps=1e-3), warmup=2, total_steps=10,
            backend=backend))
        ops.reset_launches()
        with L.record_routing(routing) as rec:
            model, state, m = step(model, state, batch, 1)
        torch.cuda.synchronize()
        routing = rec
        out[backend] = ({n: p.detach() for n, p in model.named_parameters()},
                        float(m["loss"]), float(m["grad_norm"]), dict(ops.LAUNCHES),
                        dict(ops.LAUNCHES_BY_SHAPE))
    (pk, lk, gk, launches, shapes), (pr, lr, gr, none, _) = out[None], out["ref"]
    assert none == NO_LAUNCHES
    want, want_shapes = _expected_train_launches(cfg)
    assert launches == want and shapes == want_shapes
    assert np.isfinite(lk) and abs(lk - lr) <= 1e-5 * abs(lr)
    assert abs(gk - gr) <= 1e-5 * gr
    for n, p in pk.items():
        assert (p - pr[n]).abs().max().item() <= 1e-4, n


def _grads(fn, inputs, dout):
    """Autograd's gradients of ``fn(*inputs)`` for the output gradient
    ``dout``, on leaf copies of ``inputs``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, dout.to(out.dtype))


def _rel_err(got, want) -> float:
    """max|got - want| over max|want|."""
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 128), (8, 4096), (300, 4096), (5, 100),
                                   (1, 3), (1000, 256), (64, 1030), (16, 8192), (4, 16384)])
@pytest.mark.parametrize("dtype,scale_fp32", [(torch.float32, True), (torch.bfloat16, True),
                                              (torch.bfloat16, False), (torch.float16, False)])
def test_rmsnorm_bwd_kernel_matches_autograd_of_ref(cuda, shape, dtype, scale_fp32):
    """ops.rmsnorm with grad on CUDA tensors launches the forward and the
    backward kernel once each; dx and dscale match autograd through the
    plain version in fp64 on the same inputs."""
    x = _t(shape, dtype=dtype, device=cuda)
    s = torch.linspace(0.5, 1.5, shape[-1], device=cuda)
    s = s if scale_fp32 else s.to(dtype)
    dy = _t(shape, 1, dtype, cuda)
    ops.reset_launches()
    y, (dx, ds) = _grads(ops.rmsnorm, (x, s), dy)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == 1 and ops.LAUNCHES["rmsnorm_bwd"] == 1
    assert dx.dtype == dtype and ds.dtype == s.dtype and dx.shape == x.shape
    _, (dx64, ds64) = _grads(ref.rmsnorm_ref, (x.double(), s.double()), dy.double())
    bound = RMS_GRAD_BOUND if dtype == torch.float32 else HALF_GRAD_BOUND
    assert _rel_err(dx, dx64) < bound and _rel_err(ds, ds64) < bound


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_takes_misaligned_views(cuda, dtype):
    """Contiguous x and dy that start 1 element past a 16-byte boundary take
    the kernel's generic path and meet the same bounds."""
    rows, D = 64, 4096
    x = _t((rows * D + 1,), dtype=dtype, device=cuda)[1:].view(rows, D)
    dy = _t((rows * D + 1,), 1, dtype, cuda)[1:].view(rows, D)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    s = torch.linspace(0.5, 1.5, D, device=cuda)
    dx, ds = rmsnorm_bwd_cuda(x, s, dy)
    _, (dx64, ds64) = _grads(ref.rmsnorm_ref, (x.double(), s.double()), dy.double())
    bound = RMS_GRAD_BOUND if dtype == torch.float32 else HALF_GRAD_BOUND
    assert _rel_err(dx, dx64) < bound and _rel_err(ds, ds64) < bound


@pytest.mark.gpu
def test_rmsnorm_bwd_is_deterministic(cuda):
    """dscale is summed in a fixed order: two runs give the same bits."""
    x, dy = _t((4096, 4096), device=cuda), _t((4096, 4096), 1, device=cuda)
    s = torch.linspace(0.5, 1.5, 4096, device=cuda)
    a = rmsnorm_bwd_cuda(x, s, dy)
    b = rmsnorm_bwd_cuda(x, s, dy)
    assert all(torch.equal(u, w) for u, w in zip(a, b))


_FLASH_BWD_CASES = (
    [(1, S, S, 2 * G, 2, h) for h in HEAD_DIMS for G in (1, 4) for S in (1, 63, 512)]
    + [(1, 2048, 2048, 8, 2, 128), (1, 2048, 2048, 2, 2, 64),
       # Sq, Sk not tile multiples, Sq != Sk, one key, more keys than queries
       (2, 100, 100, 4, 1, 128), (1, 37, 81, 4, 1, 64), (2, 129, 129, 8, 2, 112),
       (1, 7, 1, 2, 1, 16), (1, 48, 130, 4, 4, 32), (1, 130, 48, 4, 2, 128),
       # a long sum: each key's dk, dv over 4 x 8192 queries (summed in the
       # MMA's accumulate, which rounds toward zero, dv erred by 1.6e-4 of
       # max|g| on an H100: tools/bwd_variants.py)
       (1, 8192, 8192, 8, 2, 128)])


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,h", _FLASH_BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_autograd_of_ref(cuda, B, Sq, Sk, Hq, Hkv, h, causal):
    """ops.flash_attention with grad on CUDA tensors launches the forward
    and the backward once each; dq, dk and dv (dk and dv summed over each
    KV head's query heads) match autograd through the plain version in
    fp64 within 1e-4 of max|g|, and in fp32 as well."""
    q = _t((B, Sq, Hq, h), 1, device=cuda)
    k, v = _t((B, Sk, Hkv, h), 2, device=cuda), _t((B, Sk, Hkv, h), 3, device=cuda)
    do = _t((B, Sq, Hq, h), 4, device=cuda)
    ops.reset_launches()
    o, got = _grads(lambda *a: ops.flash_attention(*a, causal=causal), (q, k, v), do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and ops.LAUNCHES["flash_attention_bwd"] == 1
    f = lambda *a: ref.flash_attention_ref(*a, causal=causal)  # noqa: E731
    _, want64 = _grads(f, (q.double(), k.double(), v.double()), do.double())
    _, want32 = _grads(f, (q, k, v), do)
    # max|g| over dq, dk and dv: at Sk = 1 dq is zero (the one weight is 1)
    gmax = max(w.abs().max().item() for w in want64)
    for g, w64, w32 in zip(got, want64, want32):
        assert g.dtype == torch.float32 and g.shape == w64.shape
        assert (g.double() - w64).abs().max().item() < FLASH_GRAD_BOUND * gmax
        assert (g - w32).abs().max().item() < FLASH_GRAD_BOUND * gmax


# yi-34b's attention: 56 query heads over 8 KV heads (a GQA group of 7,
# which no other model has), h 128; S 2048 is the pipeline's training length
@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 300), (2, 512), (1, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_group_of_seven(cuda, B, S, causal):
    """At yi-34b's heads the forward matches the plain version within 1e-4
    (fp32), and ops.flash_attention with grad launches the forward and the
    backward once each, dq, dk and dv within 1e-4 of max|g| of autograd
    through the plain version in fp64 (dk and dv summed over each KV
    head's seven query heads)."""
    q, do = _t((B, S, 56, 128), 1, device=cuda), _t((B, S, 56, 128), 4, device=cuda)
    k, v = _t((B, S, 8, 128), 2, device=cuda), _t((B, S, 8, 128), 3, device=cuda)
    f = lambda *a: ref.flash_attention_ref(*a, causal=causal)  # noqa: E731
    assert (flash_attention_cuda(q, k, v, causal=causal) - f(q, k, v)).abs().max().item() \
        < FLASH_BOUND_F32
    ops.reset_launches()
    _, got = _grads(lambda *a: ops.flash_attention(*a, causal=causal), (q, k, v), do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and ops.LAUNCHES["flash_attention_bwd"] == 1
    _, want = _grads(f, (q.double(), k.double(), v.double()), do.double())
    gmax = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g.double() - w).abs().max().item() < FLASH_GRAD_BOUND * gmax


# yi-34b's d_model: 7168 fp32 is 1792 16-byte vectors a row, so the RMSNorm
# backward takes its register path's 8-vector instantiation (bf16: 4)
@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 300, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_at_d_7168(cuda, rows, dtype):
    """The forward against the plain version (1e-5 in fp32; in bf16 2e-2 of
    max(1, |y|), since outputs past 4 are a bf16 step of 2^-5 apart, and
    two roundings of one fp32 value may differ by one) and the backward
    kernel's dx and dscale against autograd through the plain version in
    fp64 (1e-5 of max|g| in fp32, 2e-2 in bf16)."""
    D = 7168
    x, dy = _t((rows, D), dtype=dtype, device=cuda), _t((rows, D), 1, dtype, cuda)
    s = torch.linspace(0.5, 1.5, D, device=cuda)
    want = ref.rmsnorm_ref(x, s).float()
    err = ((rmsnorm_cuda(x, s).float() - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert err < (RMS_BOUND_F32 if dtype == torch.float32 else RMS_BOUND)
    dx, ds = rmsnorm_bwd_cuda(x, s, dy)
    _, (dx64, ds64) = _grads(ref.rmsnorm_ref, (x.double(), s.double()), dy.double())
    bound = RMS_GRAD_BOUND if dtype == torch.float32 else HALF_GRAD_BOUND
    assert _rel_err(dx, dx64) < bound and _rel_err(ds, ds64) < bound


_FLASH_BWD_WINDOW_CASES = [
    (2, 200, 200, 32, 32, 80), (1, 129, 129, 4, 1, 80), (1, 600, 600, 4, 1, 80),
    (2, 300, 300, 8, 2, 128), (2, 65, 130, 4, 4, 64),
    # a training length: windows that mask many tiles of both kernels
    (1, 2048, 2048, 8, 2, 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,h", _FLASH_BWD_WINDOW_CASES)
# one key; inside a 32-key tile (16, 37); over several tiles (100, 256);
# wider than S (5000, which masks nothing)
@pytest.mark.parametrize("window", [0, 1, 16, 37, 100, 256, 5000])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_window_alibi_match_autograd_of_ref(cuda, B, Sq, Sk, Hq, Hkv, h,
                                                             window, alibi, causal):
    """The backward at head dim 80, sliding windows and ALiBi (fp32), each
    alone and together: ops.flash_attention with grad launches the forward
    and the backward once each; dq, dk and dv match autograd through the
    plain version in fp64 within 1e-4 of max|g|."""
    q, do = _t((B, Sq, Hq, h), 1, device=cuda), _t((B, Sq, Hq, h), 4, device=cuda)
    k, v = _t((B, Sk, Hkv, h), 2, device=cuda), _t((B, Sk, Hkv, h), 3, device=cuda)
    slopes = _alibi(Hq).to(cuda) if alibi else None
    kw = dict(causal=causal, window=window, alibi_slopes=slopes)
    ops.reset_launches()
    _, got = _grads(lambda *a: ops.flash_attention(*a, **kw), (q, k, v), do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and ops.LAUNCHES["flash_attention_bwd"] == 1
    kw64 = dict(kw, alibi_slopes=None if slopes is None else slopes.double())
    _, want = _grads(lambda *a: ref.flash_attention_ref(*a, **kw64),
                     (q.double(), k.double(), v.double()), do.double())
    gmax = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g.double() - w).abs().max().item() < FLASH_GRAD_BOUND * gmax


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_half_precision(cuda, dtype, causal):
    q = _t((2, 200, 8, 128), 1, dtype, cuda)
    k, v = _t((2, 200, 2, 128), 2, dtype, cuda), _t((2, 200, 2, 128), 3, dtype, cuda)
    do = _t((2, 200, 8, 128), 4, dtype, cuda)
    _, got = _grads(lambda *a: ops.flash_attention(*a, causal=causal), (q, k, v), do)
    f = lambda *a: ref.flash_attention_ref(*a, causal=causal)  # noqa: E731
    _, want = _grads(f, (q.double(), k.double(), v.double()), do.double())
    gmax = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert (g.double() - w).abs().max().item() < HALF_GRAD_BOUND * gmax


@pytest.mark.gpu
@pytest.mark.parametrize("h,window,alibi", [(112, 0, False), (128, 0, False),
                                            (80, 100, False), (128, 0, True),
                                            (80, 37, True)])
def test_flash_bwd_is_deterministic(cuda, h, window, alibi):
    """Every gradient is a plain sum in a fixed order (no atomics; dk and dv
    summed over the GQA group in one block): two calls give the same bits,
    with a window and ALiBi too."""
    q, do = _t((2, 300, 8, h), 1, device=cuda), _t((2, 300, 8, h), 4, device=cuda)
    k, v = _t((2, 300, 2, h), 2, device=cuda), _t((2, 300, 2, h), 3, device=cuda)
    kw = dict(causal=True, window=window, alibi_slopes=_alibi(8).to(cuda) if alibi else None)
    o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    a = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    b = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_lse_is_the_rows_logsumexp(cuda, causal):
    """The forward's lse is each row's log-sum-exp of its scaled, masked
    scores, and asking for it leaves o as it was."""
    B, Sq, Sk, Hq, Hkv, h = 2, 150, 150, 8, 2, 64
    q = _t((B, Sq, Hq, h), 1, device=cuda)
    k, v = _t((B, Sk, Hkv, h), 2, device=cuda), _t((B, Sk, Hkv, h), 3, device=cuda)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
    assert torch.equal(o, flash_attention_cuda(q, k, v, causal=causal))
    kk = k.double().repeat_interleave(Hq // Hkv, dim=2)
    sc = torch.einsum("bqhd,bshd->bhqs", q.double(), kk) / h ** 0.5
    if causal:
        sc = sc.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool, device=cuda).triu(1), -1e30)
    assert (lse.double() - torch.logsumexp(sc, dim=-1)).abs().max().item() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("window,alibi", [(0, True), (37, False), (100, True)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_lse_with_window_and_alibi(cuda, window, alibi, causal):
    """With a window and ALiBi the forward's lse is each row's log-sum-exp
    of its scaled, biased, masked scores, and asking for it leaves o as it
    was."""
    B, S, Hq, Hkv, h = 2, 300, 8, 2, 80
    q = _t((B, S, Hq, h), 1, device=cuda)
    k, v = _t((B, S, Hkv, h), 2, device=cuda), _t((B, S, Hkv, h), 3, device=cuda)
    slopes = _alibi(Hq).to(cuda) if alibi else None
    kw = dict(causal=causal, window=window, alibi_slopes=slopes)
    o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    assert torch.equal(o, flash_attention_cuda(q, k, v, **kw))
    kk = k.double().repeat_interleave(Hq // Hkv, dim=2)
    sc = torch.einsum("bqhd,bshd->bhqs", q.double(), kk) / h ** 0.5
    dist = (torch.arange(S, device=cuda)[None, :] - torch.arange(S, device=cuda)[:, None])
    if alibi:
        sc = sc + slopes.double().view(Hq, 1, 1) * dist.double()
    keep = torch.ones(S, S, dtype=torch.bool, device=cuda)
    if causal:
        keep &= dist <= 0
    if window:
        keep &= -dist < window
    sc = sc.masked_fill(~keep, -1e30)
    assert (lse.double() - torch.logsumexp(sc, dim=-1)).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    q = _t((1, 8, 2, 64), device=cuda)
    o, lse = flash_attention_cuda(q, q, q, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, q, q, o, lse[:, :, :4], o)
    with pytest.raises(ValueError, match="must match"):
        flash_attention_bwd_cuda(q, q, q, o, lse, o[:, :4])
    # fp32 o and do one element past a 16-byte boundary (cp.async copies
    # 16-byte pieces): refused, not read wrong
    mis = torch.empty(o.numel() + 1, device=cuda)[1:].view(o.shape).copy_(o)
    assert mis.is_contiguous() and mis.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bwd_cuda(q, q, q, mis, lse, o)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bwd_cuda(q, q, q, o, lse, mis)
    # ALiBi is built for fp32 only; a window is never negative
    qb, ob, s = q.bfloat16(), o.bfloat16(), _alibi(2).to(cuda)
    with pytest.raises(ValueError, match="fp32"):
        flash_attention_bwd_cuda(qb, qb, qb, ob, lse, ob, alibi_slopes=s)
    with pytest.raises(ValueError, match="window"):
        flash_attention_bwd_cuda(q, q, q, o, lse, o, window=-1)


def _forward_only_calls(cuda):
    """Each forward-only wrapper with only a parameter-like input needing a
    gradient: RMSNorm's scale, SSD's A and D, WKV6's u."""
    x, s = _t((4, 64), device=cuda), torch.ones(64, device=cuda)
    x6, dt, A, Bm, Cm, D = _ssd(1, 8, 2, 64, 64, device=cuda)
    r, k, v, w, u = _wkv(1, 8, 2, 64, 64, device=cuda)
    return {
        "rmsnorm scale": lambda: rmsnorm_cuda(x, s.requires_grad_()),
        "ssd A": lambda: ssd_cuda(x6, dt, A.requires_grad_(), Bm, Cm, D),
        "ssd D": lambda: ssd_cuda(x6, dt, A.detach(), Bm, Cm, D.requires_grad_()),
        "wkv6 u": lambda: wkv6_cuda(r, k, v, w, u.requires_grad_()),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["rmsnorm scale", "ssd A", "ssd D", "wkv6 u"])
def test_forward_only_wrappers_refuse_parameter_gradients(cuda, what):
    """A parameter that needs a gradient makes the forward-only wrapper
    raise, instead of returning an output detached from it."""
    with pytest.raises(RuntimeError, match="forward-only"):
        _forward_only_calls(cuda)[what]()
