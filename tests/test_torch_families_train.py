"""Training the dense families of Lagom's Table 2 on the port, against the
JAX reference on the CPU in fp32: smoke ``phi2-2b`` (parallel block, GELU
with biases, LayerNorm), ``mpt-7b`` (ALiBi), ``phi4-mini-3.8b`` (tied
vocabulary, partial rotary), ``stablelm-3b`` (LayerNorm, partial rotary)
and ``h2o-danube-1.8b`` (a sliding window of 16 in the smoke config, which
masks at S = 64).  Parameters are made by ``jax.random`` and converted
through numpy; the same numpy batches go through both.

Bounds, as ``tests/test_torch_train.py``'s: every gradient within 1e-4 of
its parameter's max|g| (with remat, the reference's ``loss_and_metrics``
under ``jax.grad``); one AdamW step with updated parameters and moments
within 1e-5 absolute, loss and grad_norm within 1e-5 relative, at eps =
1e-3 (Adam's first step is sign(g) where |g| >> eps, so a gradient element
that is rounding noise would flip its update by 2 lr)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer as T  # noqa: E402

ARCHS = ("phi2-2b", "mpt-7b", "phi4-mini-3.8b", "stablelm-3b", "h2o-danube-1.8b")
STEP_ARCHS = ("phi2-2b", "h2o-danube-1.8b")
GRAD_BOUND = 1e-4
STEP_ATOL = STEP_RTOL = 1e-5
STEP_OPT = dict(lr=1e-2, eps=1e-3)
STEP_SCHED = dict(warmup=2, total_steps=10)
B, S = 2, 64                 # S = 64 is four of danube's smoke windows


def _setup(arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(sd)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1)
    return cfg, jcfg, jp, model, SyntheticCorpus(dc).batch(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_gradients_match_reference(arch):
    """Every parameter's gradient of the loss with per-layer remat against
    jax.grad of the reference's, converted through params_from_jax."""
    cfg, jcfg, jp, model, b = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jg = jax.jit(jax.grad(lambda p, bb: JM.loss_and_metrics(jcfg, p, bb, remat=True)[0]))(
        jp, jb)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    loss, _ = M.loss_and_metrics(cfg, model, {k: torch.from_numpy(v) for k, v in b.items()},
                                 remat=True)
    names, params = zip(*model.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, params)))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape, k
        assert (g - w).abs().max().item() <= GRAD_BOUND * w.abs().max().item(), k


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_family_train_step_matches_reference(arch):
    """One plain AdamW step from the same parameters on the same batch:
    updated parameters, mu and nu, loss and grad_norm as the reference's
    make_train_step."""
    cfg, jcfg, jp, model, b = _setup(arch)
    jstep = jax.jit(JT.make_train_step(jcfg, JT.TrainConfig(opt=JA.AdamWConfig(**STEP_OPT),
                                                             **STEP_SCHED)))
    jp2, js2, jm = jstep(jp, JA.init_state(jp), {k: jnp.asarray(v) for k, v in b.items()},
                         jnp.asarray(1))
    state = adamw.init_state(dict(model.named_parameters()))
    step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**STEP_OPT),
                                                **STEP_SCHED))
    model, state, tm = step(model, state, {k: torch.from_numpy(v) for k, v in b.items()}, 1)
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP_RTOL * abs(float(jm[k])), k
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jp2))
    want_state = opt_state_from_jax(cfg, jax.tree.map(np.asarray, js2))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert (got[k] - w).abs().max().item() <= STEP_ATOL, k
        for m in ("mu", "nu"):
            assert (state[m][k] - want_state[m][k]).abs().max().item() <= STEP_ATOL, (m, k)
    assert int(state["count"]) == int(want_state["count"]) == 1
