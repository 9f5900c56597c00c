"""The port's optimizer and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``) on the same numpy inputs.

Bounds: AdamW's updated parameters, moments and ``grad_norm`` within 1e-6
relative (fp32 both sides; the port fuses the moment updates, so the last
bit may differ); the schedules within 1e-7 absolute (fp32 scalars of one
formula); the quadratic and the clip case are
``tests/test_substrate.py``'s own checks, run on the port."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as JA, schedules as JS  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

ADAMW_RTOL = 1e-6
SCHEDULE_ATOL = 1e-7


def _tree(seed, shapes, scale=1.0):
    rs = np.random.default_rng(seed)
    return {k: np.asarray(rs.standard_normal(s) * scale, np.float32) for k, s in shapes.items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


SHAPES = {"a": (7, 5), "b": (13,), "c": (2, 3, 4), "s": ()}


@pytest.mark.parametrize("grad_scale,clip_norm", [(0.01, 1.0), (10.0, 1.0), (1.0, 100.0)])
@pytest.mark.parametrize("lr_scale", [1.0, 0.25])
def test_apply_updates_matches_reference(grad_scale, clip_norm, lr_scale):
    """Three steps on random trees, with and without clipping: parameters,
    mu, nu, count and the pre-clip grad_norm as the reference's."""
    cfg_kw = dict(lr=1e-2, clip_norm=clip_norm)
    params = _tree(0, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = JA.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw.init_state(tp)
    for step in range(3):
        grads = _tree(10 + step, SHAPES, grad_scale)
        jp, js, jm = JA.apply_updates(jp, {k: jnp.asarray(v) for k, v in grads.items()}, js,
                                      JA.AdamWConfig(**cfg_kw), jnp.float32(lr_scale))
        tm = adamw.apply_updates(tp, {k: torch.from_numpy(v) for k, v in grads.items()}, ts,
                                 adamw.AdamWConfig(**cfg_kw), torch.tensor(lr_scale))
        assert _rel(tm["grad_norm"], jm["grad_norm"]) < ADAMW_RTOL
        assert _rel(tm["lr"], jm["lr"]) < ADAMW_RTOL
        for k in SHAPES:
            assert _rel(tp[k], jp[k]) < ADAMW_RTOL
            assert _rel(ts["mu"][k], js["mu"][k]) < ADAMW_RTOL
            assert _rel(ts["nu"][k], js["nu"][k]) < ADAMW_RTOL
        assert int(ts["count"]) == int(js["count"]) == step + 1
    assert ts["count"].dtype == torch.int64
    assert all(m.dtype == torch.float32 for m in ts["mu"].values())


def test_moments_are_fp32_for_bf16_parameters():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw.init_state(p)
    adamw.apply_updates(p, {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, st,
                        adamw.AdamWConfig(lr=0.1))
    assert p["w"].dtype == torch.bfloat16 and st["mu"]["w"].dtype == torch.float32
    assert float(p["w"][0]) < 1.0


def test_grad_clipping():
    """tests/test_substrate.py::test_grad_clipping on the port: grad_norm
    is reported before clipping."""
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(params)
    m = adamw.apply_updates(params, {"w": torch.ones(3) * 1e6}, state,
                            adamw.AdamWConfig(clip_norm=1.0))
    assert float(m["grad_norm"]) > 1e5


def test_adamw_minimizes_quadratic():
    """tests/test_substrate.py::test_adamw_minimizes_quadratic on the port."""
    w = torch.tensor([5.0, -3.0], requires_grad=True)
    params = {"w": w}
    state = adamw.init_state(params)
    cfg = adamw.AdamWConfig(lr=0.2, weight_decay=0.0)
    for _ in range(120):
        (g,) = torch.autograd.grad(torch.sum((w - 1.0) ** 2), [w])
        adamw.apply_updates(params, {"w": g}, state, cfg)
    assert (w.detach() - 1.0).abs().max().item() < 0.05


@pytest.mark.parametrize("kw", [dict(), dict(warmup=100, total=1000),
                                dict(warmup=3, total=25, floor=0.0), dict(warmup=0, total=1)])
def test_schedules_match_reference(kw):
    """warmup_cosine and constant at steps 0…1000, on an int step and on a
    tensor of steps."""
    steps = np.arange(0, 1001)
    want = np.asarray(JS.warmup_cosine(jnp.asarray(steps), **kw))
    got = schedules.warmup_cosine(torch.from_numpy(steps), **kw).numpy()
    assert got.dtype == np.float32 and np.abs(got - want).max() <= SCHEDULE_ATOL
    for s in (0, 1, 50, 1000):
        assert abs(float(schedules.warmup_cosine(s, **kw)) - float(want[s])) <= SCHEDULE_ATOL
    assert np.array_equal(schedules.constant(torch.from_numpy(steps), **kw).numpy(),
                          np.asarray(JS.constant(jnp.asarray(steps), **kw)))
    assert float(schedules.constant(7)) == 1.0
