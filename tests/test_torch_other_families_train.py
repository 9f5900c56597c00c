"""Training the other families on the port, against the JAX reference on
the CPU in fp32: smoke ``whisper-small`` (an encoder over stub frames,
cross-attention, tied embeddings, learned positions), ``deepseek-v2-lite-16b``
(MLA in a MoE trunk with shared experts) and ``qwen2-vl-72b`` (M-RoPE, with
and without 256 image patches).  Parameters are drawn by the port (seed
0) and converted to the reference's tree through numpy
(``convert.params_to_jax``, exact both ways); the batches come from the
reference's
``data.pipeline.make_batch`` (tokens, targets, mask and its stub frames or
patches), the same numpy arrays through both.

Bounds, as ``tests/test_torch_families_train.py``'s: every gradient within
1e-4 of its parameter's max|g|; one AdamW step with updated parameters and
moments within 1e-5 absolute, loss and grad_norm within 1e-5 relative, at
eps = 1e-3.

qwen2-vl with patches is held to ``jax.grad`` of the reference's
``chunked_ce`` over its cached-prefill states, which mask by index as the
port does; its own loss runs its uncached forward, which masks the text by
the temporal M-RoPE position (ROADMAP.md, queue 3 item 9;
``tests/test_torch_other_families.py``).

The reference's training launcher gives whisper no frames and fails with
``KeyError: 'frames'`` (ROADMAP.md, queue 3 item 10); the port's launcher
draws them as ``make_batch`` does, shown side by side below."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs.shapes import InputShape  # noqa: E402
from repro.data.pipeline import make_batch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer as T  # noqa: E402

ARCHS = ("whisper-small", "deepseek-v2-lite-16b", "qwen2-vl-72b")
AUDIO, MLA, VLM = ARCHS
GRAD_BOUND = 1e-4
ZERO_GRAD = 1e-6             # of the model's largest gradient: zero but for rounding
STEP_ATOL = STEP_RTOL = 1e-5
STEP_OPT = dict(lr=1e-2, eps=1e-3)
STEP_SCHED = dict(warmup=2, total_steps=10)
B, S = 2, 64
PATCH_S = 320                # 256 patches, then 64 text positions


@pytest.fixture(scope="module")
def built():
    """Each arch's (cfg, jcfg, reference params, their numpy tree), made
    once for the module from the port's seed-0 weights; each test loads a
    fresh port model from the tree (``model``)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
            tree = params_to_jax(cfg, M.init_params(cfg, 0, device="cpu"))
            cache[arch] = cfg, jcfg, jax.tree.map(jnp.asarray, tree), tree
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def jitted():
    """The reference's functions, each JIT-compiled once for the module."""
    cache = {}

    def get(key, make):
        if key not in cache:
            cache[key] = jax.jit(make())
        return cache[key]

    return get


def model(cfg, tree):
    m = M.init_params(cfg, 0, device="cpu")
    m.load_state_dict(params_from_jax(cfg, tree))
    return m


def batch_of(jcfg, *, patches: bool = False):
    """The reference's ``make_batch``: B x S with whisper's frames; qwen2-vl
    without its patches, or with them at the head of one row of PATCH_S."""
    if patches:
        return make_batch(jcfg, InputShape("t", PATCH_S, 1, "train"), seed=1)
    b = make_batch(jcfg, InputShape("t", S, B, "train"), seed=1)
    b.pop("patches", None)
    return b


def port_grads(cfg, m, b, remat):
    loss, _ = M.loss_and_metrics(cfg, m, {k: torch.from_numpy(v) for k, v in b.items()},
                                 remat=remat)
    names, params = zip(*m.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def assert_grads_close(got, want):
    """Each leaf within GRAD_BOUND of its max|g|; a leaf whose gradient is
    zero but for rounding (the reference's below ZERO_GRAD of the model's
    largest: whisper's key biases, which add the same q·b to every score
    of a row, no rotary position to tell the keys apart) must be so in the
    port too."""
    assert sorted(got) == sorted(want)
    top = max(w.abs().max().item() for w in want.values())
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape, k
        wmax = w.abs().max().item()
        if wmax <= ZERO_GRAD * top:
            assert g.abs().max().item() <= ZERO_GRAD * top, k
        else:
            assert (g - w).abs().max().item() <= GRAD_BOUND * wmax, k


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(built, jitted, arch, remat):
    """Every parameter's gradient of ``loss_and_metrics`` with the port's
    remat on or off (whisper with its frames: the tied embedding's gradient
    sums the lookup and the head, ``dec_pos`` gets rows below S only;
    deepseek's MLA latent norm, its dense first layer, routed and shared
    experts and the aux loss; qwen2-vl on tokens) against ``jax.grad`` of
    the reference's loss, taken once with its remat on (its whisper encoder
    always remats; remat changes no value)."""
    cfg, jcfg, jp, tree = built(arch)
    b = batch_of(jcfg)
    jg = jitted(("grad", arch), lambda: jax.grad(
        lambda p, bb: JM.loss_and_metrics(jcfg, p, bb, remat=True)[0]))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    _, got = port_grads(cfg, model(cfg, tree), b, remat)
    assert_grads_close(got, params_from_jax(cfg, jax.tree.map(np.asarray, jg)))
    if cfg.family == "audio":
        assert got["dec_pos"][S:].abs().max().item() == 0.0
        assert got["dec_pos"][:S].abs().max().item() > 0.0


@pytest.mark.parametrize("remat", [True, False])
def test_vlm_patch_gradients_match_reference_cached_prefill(built, jitted, remat):
    """qwen2-vl with 256 patches: the gradients of the port's loss (the
    patch rows' mask zeroed, attention masked by index) against
    ``jax.grad`` of the reference's ``chunked_ce`` over its cached-prefill
    states, the same mask zeroed; the loss too."""
    cfg, jcfg, jp, tree = built(VLM)
    b = batch_of(jcfg, patches=True)
    mask = b["mask"].copy()
    mask[:, :M.N_PATCHES] = 0.0

    def make():
        def loss(p, bb, m):
            x = JM.forward_hidden(jcfg, p, bb, JM.init_caches(jcfg, 1, PATCH_S))[0]
            return JM.chunked_ce(jcfg, p, x, bb["targets"], m)

        return jax.value_and_grad(loss)

    jloss, jg = jitted(("patch grad",), make)(jp, {k: jnp.asarray(v) for k, v in b.items()},
                                              mask)
    loss, got = port_grads(cfg, model(cfg, tree), b, remat)
    assert abs(loss.item() - float(jloss)) <= STEP_RTOL * abs(float(jloss))
    assert_grads_close(got, params_from_jax(cfg, jax.tree.map(np.asarray, jg)))


def test_whisper_train_step_matches_reference(built, jitted):
    """One AdamW step of whisper from the same parameters on the same batch
    with its frames: updated parameters, mu and nu, loss and grad_norm as
    the reference's ``make_train_step``."""
    cfg, jcfg, jp, tree = built(AUDIO)
    b = batch_of(jcfg)
    jstep = jitted(("step",), lambda: JT.make_train_step(
        jcfg, JT.TrainConfig(opt=JA.AdamWConfig(**STEP_OPT), **STEP_SCHED)))
    jp2, js2, jm = jstep(jp, JA.init_state(jp), {k: jnp.asarray(v) for k, v in b.items()},
                         jnp.asarray(1))
    m = model(cfg, tree)
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


@pytest.mark.parametrize("strided", [False, True], ids=["grad_accum", "microbatches"])
def test_split_cuts_frames_and_patches_by_row(strided):
    """The trainer's microbatches (``grad_accum``: contiguous rows, as the
    reference's reshape; ``microbatches`` and ACCO: every n-th row, as its
    ``a[i::n]``) cut frames (B, 1500, D) and patches (B, 256, D) by row with
    the tokens."""
    rows = np.arange(4)
    batch = {"tokens": torch.from_numpy(np.repeat(rows[:, None], 8, 1)),
             "frames": torch.from_numpy(np.repeat(rows, 1500 * 3).reshape(4, 1500, 3)),
             "patches": torch.from_numpy(np.repeat(rows, 256 * 3).reshape(4, 256, 3))}
    for i, mb in enumerate(T._split(batch, 2, strided=strided)):
        want = rows[i::2] if strided else rows.reshape(2, 2)[i]
        for k, a in mb.items():
            assert a.shape[1:] == batch[k].shape[1:], k
            assert np.array_equal(a[:, 0].reshape(2, -1)[:, 0].numpy(), want), k


def test_stub_inputs_are_the_references(built):
    """``data.pipeline.stub_inputs`` and the port's ``make_batch`` draw the
    frames and patches byte-equal to the reference's ``make_batch``."""
    for arch in (AUDIO, VLM):
        cfg, jcfg = built(arch)[:2]
        want = make_batch(jcfg, InputShape("t", 300, 3, "train"), step=2, seed=5)
        got = pipeline.make_batch(cfg, InputShape("t", 300, 3, "train"), step=2, seed=5)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (arch, k)
    assert pipeline.stub_inputs(built(MLA)[0], 3) == {}


def test_launcher_trains_whisper_where_the_reference_fails(built, monkeypatch):
    """``python -m repro_torch.launch.train --arch whisper-small --smoke``
    trains on the CPU: every step's batch carries the frames of the
    reference's ``make_batch`` (byte-equal, with its tokens), and the
    losses are finite.  The reference's launcher, given the same flags,
    fails with ``KeyError: 'frames'``."""
    argv = ["--arch", AUDIO, "--smoke", "--steps", "2", "--seq", "32", "--batch", "2",
            "--log-every", "1"]
    seen = []
    make = T.make_train_step

    def spy(cfg, tcfg):
        step_fn = make(cfg, tcfg)

        def step(model, state, batch, k):
            seen.append({n: a.numpy().copy() for n, a in batch.items()})
            return step_fn(model, state, batch, k)

        return step

    monkeypatch.setattr(T, "make_train_step", spy)
    out = train.main(argv + ["--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    jcfg = built(AUDIO)[1]
    for k, b in enumerate(seen):
        want = make_batch(jcfg, InputShape("t", 32, 2, "train"), step=k)
        assert sorted(b) == sorted(want)
        for n, w in want.items():
            assert np.array_equal(b[n], w), (k, n)
    with pytest.raises(KeyError, match="frames"):
        jtrain.main(argv)
