"""Training the hybrid family on the port, against the JAX reference on the
CPU: the plain SSD backward (``kernels.ref.ssd_chunked_bwd_ref``, the
algorithm of ``csrc/ssd_bwd.cu``) and smoke ``zamba2-7b`` trained through
the port's ``make_train_step`` and launcher.

Bounds:
- the plain backward in fp64 within 1e-9 of each gradient's max|g| of
  fp64 autograd of the port's step oracle ``ref.ssd_ref`` (the two differ
  only in the order of their sums);
- the plain backward in fp32 within 1e-5 of each max|g| of ``jax.grad`` of
  the reference's ``ssd_chunked_ref`` on the same seeded numpy inputs, but
  dA within 1e-4: each head's dA sums B·S signed terms that cancel, and
  the reference, which sums them in fp32, errs by up to 1.3e-5 of max|dA|
  from the fp64 value at these inputs; the port's plain backward sums them
  in fp64 (as its kernel does) and is itself held within 1e-5 of every
  max|g| of the fp64 gradients (3.7e-7 on dA);
- smoke zamba2's loss and every gradient as
  ``tests/test_torch_other_families_train.py`` holds the other families:
  each gradient within 1e-4 of its parameter's max|g|; one AdamW step
  with updated parameters and moments within 1e-5 absolute, loss and
  grad_norm within 1e-5 relative, at eps = 1e-3.

Parameters are drawn by the port (seed 0) and converted to the reference's
tree through numpy (``convert.params_to_jax``, exact both ways); the
batches come from the reference's ``data.pipeline.make_batch``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs.shapes import InputShape  # noqa: E402
from repro.data.pipeline import make_batch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer as T  # noqa: E402

ARCH = "zamba2-7b"
LAYERS = {"zamba2-7b": 2, "zamba2-7b-tail": 3}     # one group; a group and a tail layer
PLAIN_FP64_BOUND = 1e-9
JAX_FP32_BOUND = 1e-5
DA_FP32_BOUND = 1e-4             # dA's cancellation: see the module docstring
GRAD_BOUND = 1e-4
STEP_ATOL = STEP_RTOL = 1e-5
STEP_OPT = dict(lr=1e-2, eps=1e-3)
STEP_SCHED = dict(warmup=2, total_steps=10)
B, S = 2, 64
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dstate0")


def _inputs(Bz, Sq, H, G, P, N, states, dtype=np.float64, seed=0):
    """x, dt (> 0), A (< 0), B and C per group, D, and the initial state,
    the output gradient dy and the final state's gradient (None without
    ``states``), drawn with numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(dtype)

    x, dt = n(Bz, Sq, H, P), np.log1p(np.exp(n(Bz, Sq, H)))
    A, Bm, Cm, D = -np.exp(0.3 * n(H)), n(Bz, Sq, G, N), n(Bz, Sq, G, N), 1.0 + 0.5 * n(H)
    s0, dy, dse = n(Bz, H, P, N), n(Bz, Sq, H, P), n(Bz, H, P, N)
    return (x, dt, A.astype(dtype), Bm, Cm, D.astype(dtype), s0 if states else None, dy,
            dse if states else None)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, bound, names=NAMES, bounds=None):
    """Each gradient within ``bound`` of its max|g| (``bounds`` by name
    where one differs)."""
    for name, g, w in zip(names, got, want):
        w = torch.from_numpy(np.array(w)).to(torch.float64)
        assert g.shape == w.shape, name
        err = (g.double() - w).abs().max().item() / w.abs().max().item()
        assert err <= (bounds or {}).get(name, bound), (name, err)


@pytest.mark.parametrize("Sq,H,G,states", [(100, 4, 2, True), (100, 4, 2, False),
                                           (64, 3, 3, True), (130, 2, 1, False)])
def test_plain_backward_matches_fp64_autograd(Sq, H, G, states):
    """``ssd_chunked_bwd_ref`` in fp64 against fp64 autograd of the step
    oracle (B and C expanded to the heads, so their gradients sum over each
    group's heads): G < H and G = H, S a multiple of the chunk or not, with
    an initial state and the final state's gradient or neither."""
    x, dt, A, Bm, Cm, D, s0, dy, dse = map(_t, _inputs(2, Sq, H, G, 8, 4, states))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    s_leaf = None if s0 is None else s0.clone().requires_grad_()
    y, st = ops.ssd(*leaves, s_leaf, backend="ref")
    loss = (y * dy).sum() + (0.0 if dse is None else (st * dse).sum())
    want = torch.autograd.grad(loss, leaves + ([s_leaf] if states else []))
    got = ref.ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D, s0, dy, dse)
    assert all(g.dtype == torch.float64 for g in got)
    assert (got[-1] is not None) and got[-1].shape == (2, H, 8, 4)
    _close(got, want, PLAIN_FP64_BOUND)


@pytest.mark.parametrize("states", [True, False])
def test_plain_backward_matches_jax_grad(states):
    """The same gradients in fp32 against ``jax.grad`` of the reference's
    ``ssd_chunked_ref`` (the Pallas kernel's algorithm, head-expanded B and
    C, S a multiple of 64), from the same numpy inputs."""
    H, G = 4, 2
    args = _inputs(2, 128, H, G, 16, 8, states, dtype=np.float32, seed=3)
    x, dt, A, Bm, Cm, D, s0, dy, dse = args

    def loss(x, dt, A, Bm, Cm, D, s0):
        y, st = jref.ssd_chunked_ref(x, dt, A, jnp.repeat(Bm, H // G, axis=2),
                                     jnp.repeat(Cm, H // G, axis=2), D, s0)
        return jnp.sum(y * dy) + (0.0 if dse is None else jnp.sum(st * dse))

    argnums = tuple(range(7 if states else 6))
    want = jax.grad(loss, argnums=argnums)(x, dt, A, Bm, Cm, D, s0)
    got = ref.ssd_chunked_bwd_ref(*map(_t, args))
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want, JAX_FP32_BOUND, bounds={"dA": DA_FP32_BOUND})
    exact = ref.ssd_chunked_bwd_ref(*(None if a is None else torch.from_numpy(a).double()
                                      for a in args))
    _close(got, [e.numpy() for e in exact], JAX_FP32_BOUND)


@pytest.fixture(scope="module")
def built():
    """Each variant's (cfg, jcfg, reference params, their numpy tree, the
    batch), made once for the module from the port's seed-0 weights."""
    cache = {}

    def get(variant):
        if variant not in cache:
            n = LAYERS[variant]
            cfg, jcfg = (get_smoke_config(ARCH).replace(num_layers=n),
                         jget_smoke(ARCH).replace(num_layers=n))
            tree = params_to_jax(cfg, M.init_params(cfg, 0, device="cpu"))
            batch = make_batch(jcfg, InputShape("t", S, B, "train"), seed=1)
            cache[variant] = cfg, jcfg, jax.tree.map(jnp.asarray, tree), tree, batch
        return cache[variant]

    return get


def _model(cfg, tree):
    m = M.init_params(cfg, 0, device="cpu")
    m.load_state_dict(params_from_jax(cfg, tree))
    return m


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("variant", sorted(LAYERS))
def test_zamba2_gradients_match_reference(built, variant, remat):
    """The loss and every parameter's gradient of ``loss_and_metrics`` with
    the port's remat on (each Mamba layer checkpointed, the shared block
    not) or off, at one group (2 layers) and at a group and a tail layer
    (3), against ``jax.grad`` of the reference's loss with its remat on."""
    cfg, jcfg, jp, tree, b = built(variant)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, bb: JM.loss_and_metrics(jcfg, p, bb, remat=True)[0]))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    m = _model(cfg, tree)
    loss, _ = M.loss_and_metrics(cfg, m, {k: torch.from_numpy(v) for k, v in b.items()},
                                 remat=remat)
    names, params = zip(*m.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, params)))
    assert abs(loss.item() - float(jloss)) <= STEP_RTOL * abs(float(jloss))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape, k
        assert (g - w).abs().max().item() <= GRAD_BOUND * w.abs().max().item(), k


def test_zamba2_train_step_matches_reference(built):
    """One AdamW step of smoke zamba2 with its tail layer (remat on, as both
    trainers default) from the same parameters on the same batch: updated
    parameters, mu and nu, loss and grad_norm as the reference's
    ``make_train_step``."""
    cfg, jcfg, jp, tree, b = built("zamba2-7b-tail")
    jstep = jax.jit(JT.make_train_step(
        jcfg, JT.TrainConfig(opt=JA.AdamWConfig(**STEP_OPT), **STEP_SCHED)))
    jp2, js2, jm = jstep(jp, JA.init_state(jp), {k: jnp.asarray(v) for k, v in b.items()},
                         jnp.asarray(1))
    m = _model(cfg, tree)
    state = adamw.init_state(dict(m.named_parameters()))
    step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**STEP_OPT),
                                                **STEP_SCHED))
    m, state, tm = step(m, state, {k: torch.from_numpy(v) for k, v in b.items()}, 1)
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP_RTOL * abs(float(jm[k])), k
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jp2))
    want_state = opt_state_from_jax(cfg, jax.tree.map(np.asarray, js2))
    got = m.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert (got[k] - w).abs().max().item() <= STEP_ATOL, k
        for mm in ("mu", "nu"):
            assert (state[mm][k] - want_state[mm][k]).abs().max().item() <= STEP_ATOL, (mm, k)


def test_zamba2_grad_accum_matches_the_whole_batch(built):
    """``grad_accum=2`` (contiguous halves, gradients summed in fp32) takes
    the same step as the whole batch, within the step bounds."""
    cfg, _, _, tree, b = built("zamba2-7b")
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    out = []
    for accum in (1, 2):
        m = _model(cfg, tree)
        state = adamw.init_state(dict(m.named_parameters()))
        step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**STEP_OPT),
                                                    grad_accum=accum, **STEP_SCHED))
        m, state, tm = step(m, state, batch, 1)
        out.append((m.state_dict(), float(tm["grad_norm"])))
    (p1, g1), (p2, g2) = out
    assert abs(g1 - g2) <= STEP_RTOL * g1
    for k, w in p1.items():
        assert (p2[k] - w).abs().max().item() <= STEP_ATOL, k


def test_launcher_trains_zamba2_and_names_what_it_refuses():
    """``python -m repro_torch.launch.train --arch zamba2-7b --smoke`` trains
    two steps on the CPU with finite losses; ``--mesh 1x4`` raises before
    any process group starts, naming the placement of the recurrent trunks,
    and rwkv6-1.6b's training raises naming the WKV6 backward."""
    argv = ["--smoke", "--steps", "2", "--seq", "32", "--batch", "2", "--log-every", "1",
            "--device", "cpu"]
    out = train.main(["--arch", ARCH] + argv)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    with pytest.raises(NotImplementedError, match=r"placing the recurrent trunks.*14\.3"):
        train.main(["--arch", ARCH, "--mesh", "1x4"] + argv)
    with pytest.raises(NotImplementedError, match=r"WKV6 backward.*14\.2"):
        train.main(["--arch", "rwkv6-1.6b"] + argv)


def test_ssd_fake_route_runs_ssdfn_under_grad():
    """Under grad, fake tensors take ``SSDFn`` as the card's do: the
    backward gives the inputs' shapes, counts ``ssd_bwd``'s operations and
    launches nothing; what the backward kernel refuses (bf16) raises."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    x, dt, A, Bm, Cm, D, s0, dy, _ = map(_t, _inputs(1, 70, 2, 1, 64, 64, True,
                                                    dtype=np.float32))
    launches, flops = dict(ops.LAUNCHES), dict(ops.FAKE_FLOPS)
    with FakeTensorMode() as mode:
        leaves = [mode.from_tensor(t).requires_grad_() for t in (x, dt, A, Bm, Cm, D, s0)]
        y, st = ops.ssd(*leaves)
        grads = torch.autograd.grad((y * mode.from_tensor(dy)).sum() + st.sum(), leaves)
        assert all(isinstance(g, FakeTensor) and g.shape == t.shape
                   for g, t in zip(grads, leaves))
        with pytest.raises(TypeError, match="queue 2 item 3"):
            ops.ssd(leaves[0].detach().bfloat16().requires_grad_(), *leaves[1:3],
                    *(t.detach().bfloat16() for t in leaves[3:5]), leaves[5])
    assert ops.LAUNCHES == launches
    assert ops.FAKE_FLOPS["ssd_bwd"] > flops["ssd_bwd"]
    assert ops.FAKE_FLOPS["ssd"] > flops["ssd"]


def test_chip_smoke_expected_train_launches_of_the_hybrid_trunk():
    """``chip_smoke.expected_train_launches``, phase 17's gate on zamba2's
    trained runs, for a remat step of passes p: each Mamba layer's ln,
    gated norm and SSD scan in the forward and its recompute and once
    backward; the shared block's ln1, ln2 and flash once each way (it is
    not checkpointed); ln_f once each way."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = get_smoke_config(ARCH).replace(num_layers=13)
    cfg = cfg.replace(shared_attn_every=6)          # full zamba2's split: 2 groups, 1 tail
    want = dict(chip_smoke.NO_LAUNCHES, rmsnorm=3 * (4 * 13 + 2 * 2 + 1),
                rmsnorm_bwd=3 * (2 * 13 + 2 * 2 + 1), ssd=3 * 2 * 13, ssd_bwd=3 * 13,
                flash_attention=3 * 2, flash_attention_bwd=3 * 2)
    assert chip_smoke.expected_train_launches(cfg, 3) == want
