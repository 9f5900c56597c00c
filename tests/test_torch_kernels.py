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

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.flash import flash_attention as jflash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.kernels.ssd import ssd_pallas  # noqa: E402
from repro.kernels.wkv6 import wkv6_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RMS_BOUND = 2e-2      # tests/test_kernels.py::test_rmsnorm_pallas
FLASH_BOUND = 1e-4    # tests/test_kernels.py::test_flash_attention_pallas
SCAN_RTOL = {"float32": 1e-3, "bfloat16": 3e-2}   # tests/test_kernels.py, ssd and wkv6

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(a):
    return np.asarray(a, np.float32) if not torch.is_tensor(a) else a.float().numpy()


# (3, 512) and (2, 3584): widths on either side of the CUDA forward's split
# between a warp a row and a block a row
@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 128), (3, 5, 256), (3, 512), (2, 3584)])
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


@pytest.mark.parametrize("B,S,Hq,Hkv", [(2, 64, 4, 2), (1, 96, 8, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_at_h80(B, S, Hq, Hkv, causal):
    """Head dim 80 (phi2-2b, stablelm-3b, h2o-danube-1.8b), which the CUDA
    kernel gained with the dense families."""
    q, k, v = _qkv(B, S, S, Hq, Hkv, 80, seed=2)
    o_pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                      q_block=32, kv_block=32)
    o_port = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    assert np.abs(o_port.numpy() - np.asarray(o_pallas)).max() < FLASH_BOUND


@pytest.mark.parametrize("change", [dict(sliding_window=16), dict(pos_kind="alibi"),
                                    dict(sliding_window=5, head_dim=80),
                                    dict(pos_kind="alibi", num_heads=4, num_kv_heads=1)],
                         ids=["window", "alibi", "window-h80", "alibi-gqa"])
@pytest.mark.parametrize("blockwise", [False, True])
def test_flash_ref_window_alibi_match_reference_attention(change, blockwise):
    """The plain version's window and ALiBi (through the port's attention,
    uncached, which takes the flash route) against the reference's uncached
    ``layers.attention`` (its ``bias_fn``): dense, and blockwise over key
    blocks of 16 (``blockwise_threshold`` lowered to reach it)."""
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import layers as JL
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L

    cfg = get_smoke_config("llama3-8b").replace(**change)
    jcfg = jget_smoke("llama3-8b").replace(**change)
    jp = JL.init_attention(jax.random.PRNGKey(3), jcfg)
    attn = L.Attention(cfg)
    attn.load_state_dict({f"{n}.weight": torch.from_numpy(np.asarray(jp[n]["w"]).T.copy())
                          for n in "qkvo"})
    B, S = 2, 40
    x = np.random.default_rng(4).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(blockwise_threshold=16, kv_block=16) if blockwise else {}
    want, _ = JL.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), **kw)
    with torch.no_grad():
        got, _ = L.attention(attn, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert np.abs(got.numpy() - np.asarray(want)).max() < FLASH_BOUND


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


def _tf32(x):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: the operand type of the CUDA
    flash kernel's tensor-core products."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncated(x):
    """fp32 cut to TF32 by dropping its low 13 mantissa bits: how the TF32
    tensor core reads an fp32 word that was not rounded first."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, terms):
    """a @ b with TF32 operands and fp32 accumulation: one product, or the
    3xTF32 split of csrc/flash.cu (big = x rounded to TF32, small = x − big
    passed raw and so truncated to TF32; big·big + big·small + small·big)."""
    if terms == 1:
        return _tf32(a) @ _tf32(b)
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_truncated(a - a_big), _tf32_truncated(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


@pytest.mark.parametrize("h", [112, 128])
def test_flash_3xtf32_meets_the_bound_and_1xtf32_does_not(h):
    """The premise of the CUDA flash kernel's design, where no card is: causal
    attention at S = 512 (one head, the served models' head dims) whose two
    products are emulated on TF32 operands meets the reference's fp32 bound
    against its Pallas kernel (interpret mode) with the three-product split,
    and misses it with one product."""
    S = 512
    q, k, v = (a[0, :, 0] for a in _qkv(1, S, S, 1, 1, h, seed=3))
    o_pallas = np.asarray(jflash(*(jnp.asarray(a[None, :, None]) for a in (q, k, v)),
                                 causal=True))[0, :, 0]
    keep = np.tril(np.ones((S, S), bool))
    errs = {}
    for terms in (1, 3):
        s = _tf32_matmul(q, k.T, terms) * np.float32(1 / math.sqrt(h))
        s = np.where(keep, s, np.float32(-1e30))
        p = np.exp(s - s.max(-1, keepdims=True))
        o = _tf32_matmul(p, v, terms) / np.maximum(p.sum(-1, keepdims=True), 1e-20)
        errs[terms] = float(np.abs(o - o_pallas).max())
    assert errs[3] < FLASH_BOUND < errs[1], errs


@pytest.mark.parametrize("h,alibi", [pytest.param(112, False, id="112"),
                                     pytest.param(128, False, id="128"),
                                     pytest.param(80, False, id="80"),
                                     pytest.param(128, True, id="128-alibi")])
def test_flash_bwd_3xtf32_meets_the_bound_and_1xtf32_does_not(h, alibi):
    """The premise of the CUDA flash backward's design: one causal head at
    S = 512 whose five backward products (S, dP, dV, dK, dQ) are emulated on
    TF32 operands meets 1e-4 of max|g| against ``jax.vjp`` of the
    reference's attention math with the three-product split, and misses it
    with one product.  lse and o are the forward's, computed in fp32.  With
    ALiBi the head is mpt-7b's last (slope 2^-8, the weakest bias, so the
    scores reach furthest back), the bias added to the scaled scores in
    fp32 as the kernels add it."""
    from repro.models.layers import NEG_INF, _gqa_scores_to_out, alibi_slopes

    S = 512
    q, k, v = (a[0, :, 0] for a in _qkv(1, S, S, 1, 1, h, seed=3))
    do = np.random.default_rng(4).standard_normal((S, h)).astype(np.float32)
    keep = np.tril(np.ones((S, S), bool))
    dist = (np.arange(S)[None, :] - np.arange(S)[:, None]).astype(np.float32)   # kpos − qpos
    slope = np.asarray(alibi_slopes(32))[-1] if alibi else np.float32(0)
    ab = (slope * dist).astype(np.float32)
    bias = jnp.asarray(np.where(keep, ab, NEG_INF), jnp.float32)
    scale = np.float32(1 / math.sqrt(h))

    def attn(q, k, v):
        o = _gqa_scores_to_out(q.reshape(1, S, 1, 1, h), k.reshape(1, S, 1, h),
                               v.reshape(1, S, 1, h), bias, 1.0 / math.sqrt(h))
        return o.reshape(S, h)

    _, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    gmax = max(np.abs(w).max() for w in want)
    s = np.where(keep, (q @ k.T) * scale + ab, np.float32(-1e30))
    m = s.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True))).astype(np.float32)
    o = np.exp(s - lse) @ v
    D = (do * o).sum(-1, keepdims=True)
    errs = {}
    for terms in (1, 3):
        s = np.where(keep, _tf32_matmul(q, k.T, terms) * scale + ab, np.float32(-1e30))
        p = np.exp(s - lse)
        dp = _tf32_matmul(do, v.T, terms)
        ds = p * (dp - D)
        got = (_tf32_matmul(ds, k, terms) * scale, _tf32_matmul(ds.T, q, terms) * scale,
               _tf32_matmul(p.T, do, terms))
        errs[terms] = max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / gmax
    assert errs[3] < GRAD_BOUND["flash"] < errs[1], errs


# ---------------------------------------------------------------------------
# the scans: SSD and WKV6
# ---------------------------------------------------------------------------

def _wkv_np(B, S, H, K, seed=0):
    """r, k, v, w_log (B,S,H,K) and u (H,K), as tests/test_kernels.py draws them."""
    rs = np.random.default_rng(seed)
    r, k, v = (rs.standard_normal((B, S, H, K)).astype(np.float32) for _ in range(3))
    w_log = -np.exp(rs.standard_normal((B, S, H, K)) * 0.5).astype(np.float32)
    u = (rs.standard_normal((H, K)) * 0.1).astype(np.float32)
    return r, k, v, w_log, u


def _ssd_np(B, S, H, P, N, seed=0):
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm, Cm (B,S,H,N), D (H,)."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((B, S, H)))).astype(np.float32)   # softplus
    A = -np.exp(rs.standard_normal(H) * 0.3).astype(np.float32)
    Bm, Cm = (rs.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(2))
    return x, dt, A, Bm, Cm, np.ones(H, np.float32)


# which inputs take the working dtype (the others stay fp32, as in the model)
_WKV_CAST = (True, True, True, False, True)
_SSD_CAST = (True, False, False, True, True, False)


def _both(arrays, cast, dtype):
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) if c else jnp.asarray(a) for a, c in zip(arrays, cast)]
    t = [torch.from_numpy(a).to(tdt) if c else torch.from_numpy(a) for a, c in zip(arrays, cast)]
    return j, t


def _close_scan(y, st, jy, jst, dtype):
    """Bounds of tests/test_kernels.py: relative to max|y| of the JAX side, and to
    max(1, max|state|) for the state."""
    rtol = SCAN_RTOL[dtype]
    jy, jst = _f32(jy), _f32(jst)
    assert np.abs(_f32(y) - jy).max() < rtol * (float(np.abs(jy).max()) or 1.0)
    assert st.dtype == torch.float32
    assert np.abs(_f32(st) - jst).max() < rtol * max(1.0, float(np.abs(jst).max()))


@pytest.mark.parametrize("B,S,H,K", [(1, 32, 1, 8), (2, 64, 3, 16), (2, 96, 2, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wkv6_plain_matches_pallas(B, S, H, K, dtype):
    (jr, jk, jv, jw, ju), targs = _both(_wkv_np(B, S, H, K), _WKV_CAST, dtype)
    jy, jst = wkv6_pallas(jr, jk, jv, jw, ju, chunk=32)
    for fn in (ref.wkv6_ref, lambda *a: ref.wkv6_chunked_ref(*a, chunk=32),
               lambda *a: ref.wkv6_subchunked_ref(*a, chunk=32, sub=8),
               lambda *a: ref.wkv6_subchunked_ref(*a, chunk=32, sub=16)):
        y, st = fn(*targs)
        assert y.dtype == targs[2].dtype and y.shape == (B, S, H, K)
        _close_scan(y, st, jy, jst, dtype)


# the sub-chunked WKV6 against the step oracle in fp64 (× max|y|, and the
# state × max(1, max|state|)): the bound of the CUDA kernels on the card
WKV6_EXACT_RTOL = 2e-5


@pytest.mark.parametrize("sub", [8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wkv6_subchunked_ref_holds_at_strong_decays(sub, seed):
    """w_log = −exp(2·randn), so that some steps decay by e^-1000 and more
    (w_log below −1000) and others by e^-0.01: the sub-chunk-factored
    algorithm, in fp32, stays finite and within 2e-5 of max|y| of the step
    oracle in fp64, with a state carried in.  Its exponents are sums over the
    rows they span; at S = 96 it runs three chunks."""
    B, S, H, K = 2, 96, 3, 32
    rs = np.random.default_rng(40 + seed)
    r, k, v = (rs.standard_normal((B, S, H, K)).astype(np.float32) for _ in range(3))
    w = -np.exp(rs.standard_normal((B, S, H, K)) * 2.0).astype(np.float32)
    u = (rs.standard_normal((H, K)) * 0.1).astype(np.float32)
    s0 = rs.standard_normal((B, H, K, K)).astype(np.float32)
    assert w.min() < -1000 and w.max() > -0.01
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    y, st = ref.wkv6_subchunked_ref(*args, chunk=32, sub=sub)
    y64, st64 = ref.wkv6_ref(*(a.double() for a in args))
    assert y.dtype == st.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert (y.double() - y64).abs().max().item() < WKV6_EXACT_RTOL * y64.abs().max().item()
    assert ((st.double() - st64).abs().max().item()
            < WKV6_EXACT_RTOL * max(1.0, st64.abs().max().item()))


@pytest.mark.parametrize("B,S,H,P,N", [(1, 32, 1, 4, 8), (2, 64, 3, 8, 16), (1, 128, 2, 16, 32)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_plain_matches_pallas(B, S, H, P, N, dtype):
    jargs, targs = _both(_ssd_np(B, S, H, P, N), _SSD_CAST, dtype)
    jy, jst = ssd_pallas(*jargs, chunk=32)
    for fn in (ref.ssd_ref, lambda *a: ref.ssd_chunked_ref(*a, chunk=32)):
        y, st = fn(*targs)
        assert y.dtype == targs[0].dtype and y.shape == (B, S, H, P)
        _close_scan(y, st, jy, jst, dtype)


def test_scans_state_continuation():
    """Two calls carrying the state equal one call over the whole sequence:
    the port's plain versions against the JAX kernels over all of it."""
    (jr, jk, jv, jw, ju), (r, k, v, w, u) = _both(_wkv_np(2, 64, 2, 16, 1), _WKV_CAST, "float32")
    jy, jst = wkv6_pallas(jr, jk, jv, jw, ju, chunk=32)
    for fn in (ref.wkv6_ref, lambda *a: ref.wkv6_chunked_ref(*a, chunk=16)):
        ya, sa = fn(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u)
        yb, sb = fn(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, sa)
        _close_scan(torch.cat([ya, yb], 1), sb, jy, jst, "float32")

    jargs, (x, dt, A, Bm, Cm, D) = _both(_ssd_np(2, 64, 2, 8, 16, 1), _SSD_CAST, "float32")
    jy, jst = ssd_pallas(*jargs, chunk=32)
    for fn in (ref.ssd_ref, lambda *a: ref.ssd_chunked_ref(*a, chunk=16)):
        ya, sa = fn(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], D)
        yb, sb = fn(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], D, sa)
        _close_scan(torch.cat([ya, yb], 1), sb, jy, jst, "float32")


@pytest.mark.parametrize("S", [1, 45, 77])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scan_ops_any_length(S, dtype):
    """``ops.wkv6`` and ``ops.ssd`` on CPU tensors at S = 1 and at S not a
    chunk multiple, with a passed-in state, against the reference's
    ``ops`` through its Pallas kernel (which pads) and its S = 1 route."""
    rs = np.random.default_rng(S)
    st_w = rs.standard_normal((2, 3, 16, 16)).astype(np.float32)
    (jr, jk, jv, jw, ju), targs = _both(_wkv_np(2, S, 3, 16, 2), _WKV_CAST, dtype)
    jy, jst = jops.wkv6(jr, jk, jv, jw, ju, jnp.asarray(st_w), backend="pallas")
    y, st = ops.wkv6(*targs, torch.from_numpy(st_w))
    assert y.shape == (2, S, 3, 16)
    _close_scan(y, st, jy, jst, dtype)

    st_s = rs.standard_normal((2, 3, 8, 16)).astype(np.float32)
    jargs, targs = _both(_ssd_np(2, S, 3, 8, 16, 2), _SSD_CAST, dtype)
    jy, jst = jops.ssd(*jargs, jnp.asarray(st_s), backend="pallas")
    y, st = ops.ssd(*targs, torch.from_numpy(st_s))
    assert y.shape == (2, S, 3, 8)
    _close_scan(y, st, jy, jst, dtype)


@pytest.mark.parametrize("S", [1, 45])
def test_wkv6_out_state_aliases_state(S):
    """An ``out_state`` that is ``state`` itself: ``ops.wkv6`` returns that
    tensor, holding what a call without it returns, and both agree with the
    reference's ``ops.wkv6`` through its Pallas kernel (its S = 1 route at
    S = 1)."""
    rs = np.random.default_rng(11 + S)
    st0 = rs.standard_normal((2, 3, 16, 16)).astype(np.float32)
    (jr, jk, jv, jw, ju), targs = _both(_wkv_np(2, S, 3, 16, seed=S), _WKV_CAST, "float32")
    y_new, st_new = ops.wkv6(*targs, torch.from_numpy(st0.copy()))
    st = torch.from_numpy(st0.copy())
    y, st_out = ops.wkv6(*targs, st, out_state=st)
    assert st_out is st
    assert torch.equal(y, y_new) and torch.equal(st, st_new)
    jy, jst = jops.wkv6(jr, jk, jv, jw, ju, jnp.asarray(st0), backend="pallas")
    _close_scan(y, st, jy, jst, "float32")


def _conv_views(buf, H, P, G, N):
    """x (B,S,H,P), Bm and Cm (B,S,G,N) as views of one (B, S, H·P + 2·G·N)
    buffer, as the Mamba2 block's conv output holds them."""
    x, Bm, Cm = torch.split(buf, [H * P, G * N, G * N], dim=-1)
    return x.unflatten(-1, (H, P)), Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("S", [1, 45, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_ops_grouped_strided_matches_pallas(G, S, dtype):
    """``ops.ssd`` with B and C per group (G = 1 and 3 at H = 6) and x, B, C
    as strided views of one conv-output buffer, with a state, against the
    reference's ``ops.ssd`` through its Pallas kernel (its S = 1 route at
    S = 1) on the head-expanded, contiguous inputs."""
    B, H, P, N = 2, 6, 8, 16
    rs = np.random.default_rng(100 + S + G)
    buf = rs.standard_normal((B, S, H * P + 2 * G * N)).astype(np.float32)
    _, dt, A, _, _, D = _ssd_np(B, S, H, P, N, seed=S)
    st = rs.standard_normal((B, H, P, N)).astype(np.float32)
    xs = buf[..., :H * P].reshape(B, S, H, P)
    Be, Ce = (np.repeat(buf[..., H * P + i * G * N:H * P + (i + 1) * G * N]
                        .reshape(B, S, G, N), H // G, axis=2) for i in (0, 1))
    jargs, targs = _both((xs, dt, A, Be, Ce, D), _SSD_CAST, dtype)
    jy, jst = jops.ssd(*jargs, jnp.asarray(st), backend="pallas")
    tx, tB, tC = _conv_views(torch.from_numpy(buf).to(DTYPES[dtype][1]), H, P, G, N)
    assert not (tx.is_contiguous() or tB.is_contiguous()) and tB.shape == (B, S, G, N)
    y, tst = ops.ssd(tx, targs[1], targs[2], tB, tC, targs[5], torch.from_numpy(st))
    assert y.shape == (B, S, H, P) and y.dtype == DTYPES[dtype][1]
    _close_scan(y, tst, jy, jst, dtype)


@pytest.mark.parametrize("S", [1, 45])
def test_ssd_out_state_aliases_state(S):
    """An ``out_state`` that is ``state`` itself: ``ops.ssd`` returns that
    tensor, holding what a call without it returns, and both agree with the
    reference."""
    rs = np.random.default_rng(7 + S)
    st0 = rs.standard_normal((2, 3, 8, 16)).astype(np.float32)
    jargs, targs = _both(_ssd_np(2, S, 3, 8, 16, seed=S), _SSD_CAST, "float32")
    y_new, st_new = ops.ssd(*targs, torch.from_numpy(st0.copy()))
    st = torch.from_numpy(st0.copy())
    y, st_out = ops.ssd(*targs, st, out_state=st)
    assert st_out is st
    assert torch.equal(y, y_new) and torch.equal(st, st_new)
    jy, jst = jops.ssd(*jargs, jnp.asarray(st0), backend="pallas")
    _close_scan(y, st, jy, jst, "float32")


def _ssd_chunk(mm, x, dt, a, Bm, Cm, h0, d):
    """One chunk of the CUDA SSD kernel's arithmetic with products ``mm``:
    G = C Bᵀ, decayed and masked; y = (C h0ᵀ) e^{cum} + G x + D x;
    h = e^{cum_end} h0 + (w x)ᵀ B with w_s = e^{cum_end − cum_s} dt_s."""
    Q = x.shape[0]
    cum = np.cumsum(dt * a)
    keep = np.tril(np.ones((Q, Q), bool))
    L = np.exp(np.where(keep, cum[:, None] - cum[None, :], 0.0))
    G = np.where(keep, mm(Cm, Bm.T) * L * dt[None, :], 0.0)
    y = mm(Cm, h0.T) * np.exp(cum)[:, None] + mm(G, x) + d * x
    w = np.exp(cum[-1] - cum) * dt
    return y, np.exp(cum[-1]) * h0 + mm((w[:, None] * x).T, Bm)


def test_ssd_3xtf32_chunk_meets_1e5_and_1xtf32_does_not():
    """The premise of the CUDA SSD kernel's design, where no card is: one
    64-row chunk at P = N = 64 with an initial state, inputs drawn as
    ``chip_smoke.py`` draws them, its four products emulated on TF32
    operands (small passed raw and truncated, as the MMA reads it), against
    the same chunk in float64: the three-product split stays within 1e-5 of
    max|y| (and of max(1, max|state|)), one product does not.  The float64
    chunk is the reference's function: it agrees with ``ssd_pallas``."""
    Q, P, N = 64, 64, 64
    rs = np.random.default_rng(15)
    x = rs.standard_normal((Q, P)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal(Q))).astype(np.float32)
    a = np.float32(-np.exp(rs.standard_normal() * 0.3))
    Bm, Cm = (rs.standard_normal((Q, N)).astype(np.float32) for _ in range(2))
    h0 = rs.standard_normal((P, N)).astype(np.float32)
    f64 = [v.astype(np.float64) for v in (x, dt, a, Bm, Cm, h0)]
    y_ex, h_ex = _ssd_chunk(np.matmul, *f64, 1.0)
    jy, jst = ssd_pallas(*(jnp.asarray(v) for v in (x[None, :, None], dt[None, :, None],
                                                    np.full(1, a), Bm[None, :, None],
                                                    Cm[None, :, None], np.ones(1, np.float32))),
                         jnp.asarray(h0[None, None]), chunk=Q)
    _close_scan(y_ex, torch.from_numpy(h_ex.astype(np.float32)), np.asarray(jy)[0, :, 0],
                np.asarray(jst)[0, 0], "float32")
    errs = {}
    for terms in (1, 3):
        y, h = _ssd_chunk(lambda u, v: _tf32_matmul(u.astype(np.float32), v.astype(np.float32),
                                                    terms),
                          x, dt, a, Bm, Cm, h0, np.float32(1.0))
        errs[terms] = max(np.abs(y - y_ex).max() / np.abs(y_ex).max(),
                          np.abs(h - h_ex).max() / max(1.0, np.abs(h_ex).max()))
    assert errs[3] < 1e-5 < errs[1], errs


# The backward kernels' oracles: autograd through the port's plain versions
# against jax.grad through the reference's math (the reference trains through
# plain jnp: its RMSNorm oracle and its layers' dense GQA attention), on the
# same numpy inputs and output gradients; 1e-5 (RMSNorm) and 1e-4 (attention)
# of each gradient's max|g|, fp32.
GRAD_BOUND = {"rmsnorm": 1e-5, "flash": 1e-4}


@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 128), (3, 5, 256)])
def test_rmsnorm_ref_grads_match_jax(shape):
    rs = np.random.default_rng(2)
    x, dy = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    scale = np.linspace(0.5, 1.5, shape[-1]).astype(np.float32)
    _, vjp = jax.vjp(jref.rmsnorm_ref, jnp.asarray(x), jnp.asarray(scale))
    want = vjp(jnp.asarray(dy))
    xt, st = torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale).requires_grad_()
    got = torch.autograd.grad(ref.rmsnorm_ref(xt, st), (xt, st), torch.from_numpy(dy))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_BOUND["rmsnorm"] * np.abs(w).max()


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,h,window,alibi", [
    pytest.param(64, 64, 4, 2, 16, 0, False, id="64-64-4-2-16"),
    pytest.param(37, 81, 4, 1, 32, 0, False, id="37-81-4-1-32"),
    pytest.param(50, 50, 8, 2, 64, 0, False, id="50-50-8-2-64"),
    # head dim 80, windows (one that cuts a 32-key tile, one of a key,
    # one wider than S), ALiBi alone and with a window
    pytest.param(64, 64, 4, 2, 80, 0, False, id="64-64-4-2-80"),
    pytest.param(64, 64, 4, 1, 80, 19, False, id="64-64-4-1-80-w19"),
    pytest.param(50, 50, 8, 2, 64, 1, False, id="50-50-8-2-64-w1"),
    pytest.param(50, 50, 8, 2, 64, 200, False, id="50-50-8-2-64-w200"),
    pytest.param(37, 81, 4, 4, 32, 0, True, id="37-81-4-4-32-alibi"),
    pytest.param(64, 64, 8, 2, 80, 9, True, id="64-64-8-2-80-w9-alibi")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_grads_match_jax(Sq, Sk, Hq, Hkv, h, window, alibi, causal):
    """Autograd of the plain version against ``jax.vjp`` of the reference's
    attention math with the additive bias its ``bias_fn`` builds: the
    causal mask, the window (``qpos − kpos < window``) and ALiBi's
    ``slope·(kpos − qpos)`` with the reference's slopes."""
    from repro.models.layers import NEG_INF, _gqa_scores_to_out, alibi_slopes
    from repro_torch.models.layers import alibi_slopes as port_slopes

    q, k, v = _qkv(2, Sq, Sk, Hq, Hkv, h, seed=3)
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    G = Hq // Hkv
    dist = np.arange(Sk)[None, :] - np.arange(Sq)[:, None]         # kpos − qpos
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= dist <= 0
    if window:
        keep &= -dist < window
    bias = jnp.asarray(np.where(keep, 0.0, NEG_INF), jnp.float32)
    if alibi:
        bias = bias + alibi_slopes(Hq).reshape(Hkv, G, 1, 1) * jnp.asarray(dist, jnp.float32)

    def attn(q, k, v):
        o = _gqa_scores_to_out(q.reshape(2, Sq, Hkv, G, h), k, v, bias, 1.0 / math.sqrt(h))
        return o.reshape(q.shape)

    _, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(
        ref.flash_attention_ref(*ts, causal=causal, window=window,
                                alibi_slopes=port_slopes(Hq) if alibi else None),
        ts, torch.from_numpy(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_BOUND["flash"] * np.abs(w).max()
