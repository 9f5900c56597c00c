"""The port's continuous-batching engine against the reference's, on the
CPU in fp32 with the reference's weights converted: per-slot positions,
ragged prompts in isolated slots, more requests than slots, a reused slot
reset before it serves again, and the recurrent families (equal-length
admits serve as the reference's; ragged admits raise ``ValueError``, where
the reference's states would absorb the padding).

Tolerance: exact equality of the greedy tokens.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.continuous import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving.types import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import ContinuousEngine, Engine, Request  # noqa: E402

MAX_SEQ = 48


def _pair(arch, seed=0):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(seed))
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return cfg, jcfg, jp, model


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3-8b")


def _serve(engine, req_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(i, p, max_new=max_new[i] if isinstance(max_new, list)
                              else max_new))
    return {r.rid: r.out for r in engine.run()}


def _both(pair, slots, prompts, max_new):
    """(port tokens, reference tokens) by request id."""
    cfg, jcfg, jp, model = pair
    got = _serve(ContinuousEngine(cfg, model, slots=slots, max_seq=MAX_SEQ), Request,
                 prompts, max_new)
    want = _serve(JContinuous(jcfg, jp, slots=slots, max_seq=MAX_SEQ), JRequest,
                  prompts, max_new)
    return got, want


def test_matches_lockstep_engine(llama):
    cfg, _, _, model = llama
    p = np.random.default_rng(0).integers(0, cfg.vocab_size, size=6).astype(np.int32)
    lockstep = Engine(cfg, model, batch_size=2, max_seq=MAX_SEQ).generate([p, p], max_new=4)
    got, want = _both(llama, 1, [p], 4)
    assert got[0] == want[0] == lockstep[0]


def test_ragged_prompts_isolated_slots(llama):
    """Each ragged request gives the tokens of a solo run, and the
    reference's."""
    cfg, _, _, model = llama
    rs = np.random.default_rng(1)
    prompts = [rs.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (3, 7, 5)]
    solo = [_serve(ContinuousEngine(cfg, model, slots=1, max_seq=MAX_SEQ), Request,
                   [p], 3)[0] for p in prompts]
    got, want = _both(llama, 3, prompts, 3)
    assert got == want
    assert [got[i] for i in range(3)] == solo


def test_slot_refill_more_requests_than_slots(llama):
    cfg = llama[0]
    rs = np.random.default_rng(2)
    prompts = [rs.integers(0, cfg.vocab_size, size=4 + i).astype(np.int32) for i in range(5)]
    budgets = [2 + i % 3 for i in range(5)]
    got, want = _both(llama, 2, prompts, budgets)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3, 4]
    assert all(len(got[i]) == budgets[i] for i in got)


def test_reused_slot_is_reset(llama):
    """A slot that served a long request serves a short one as a fresh
    engine would: the admit overwrites the whole row of its caches."""
    cfg, _, _, model = llama
    rs = np.random.default_rng(3)
    long_ = rs.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    short = rs.integers(0, cfg.vocab_size, size=3).astype(np.int32)
    eng = ContinuousEngine(cfg, model, slots=1, max_seq=MAX_SEQ)
    _serve(eng, Request, [long_], 8)
    again = _serve(eng, Request, [short], 5)
    fresh = _serve(ContinuousEngine(cfg, model, slots=1, max_seq=MAX_SEQ), Request, [short], 5)
    assert again == fresh


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_recurrent_families(arch):
    pair = _pair(arch, seed=2)
    cfg, _, _, model = pair
    rs = np.random.default_rng(4)
    prompts = [rs.integers(0, cfg.vocab_size, size=6).astype(np.int32) for _ in range(3)]
    got, want = _both(pair, 2, prompts, 3)
    assert got == want
    eng = ContinuousEngine(cfg, model, slots=2, max_seq=MAX_SEQ)
    eng.submit(Request(0, prompts[0], max_new=2))
    eng.submit(Request(1, prompts[1][:4], max_new=2))
    with pytest.raises(ValueError, match="equal-length"):
        eng.run()
