"""Plan-aware serving of the port against the reference, on smoke
``llama3-8b`` (2 layers) in fp32 on the CPU, with the reference's weights
converted: ``serve.layer{i}.*`` site precedence, one plan driving two
decode layers to different issued structure (the port's ``record_issued``
in place of the reference's count of ``scan`` loops in a jaxpr), the fixed
engine under a plan (scoped, restored on every exit path, tokens equal to
the unplanned engine and to the reference's ``Engine(plan=...)``),
repository banding (``plan_stats`` equal to the reference's), a hot-swap
between batches of the continuous engine, and ``make_engine``'s modes.

Tolerance: exact equality of tokens, stats and resolved knobs.
"""
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import core as J  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import collectives as JC  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import make_engine as jmake_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.serving import (ContinuousEngine, Engine, Request,  # noqa: E402
                                 available_engines, make_engine, make_serve_step)

ARCH = "llama3-8b"
CFG = get_smoke_config(ARCH)          # 2 dense layers
TWO_LAYERS = {"serve.layer0.mlp.ag": ("ring", 2), "serve.layer1.mlp.ag": ("ring", 4)}


def _plan(pkg, spec):
    return {k: pkg.CollectiveRuntime(*v) for k, v in spec.items()}


@pytest.fixture(autouse=True)
def _clean_plan_state():
    yield
    for pkg in (C, JC):
        pkg.install_runtime_plan({})
        pkg.reset_degraded_warnings()


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_smoke(ARCH)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    model = M.init_params(CFG, 0, device="cpu")
    model.load_state_dict(params_from_jax(CFG, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, model


def _prompts(n, rng_seed=0, lo=4, hi=9):
    rs = np.random.default_rng(rng_seed)
    sizes = [int(rs.integers(lo, hi)) for _ in range(n)]
    return [rs.integers(0, CFG.vocab_size, size=s).astype(np.int32) for s in sizes]


# ---------------------------------------------------------------------------
# serve.* site resolution precedence: exact > dotted prefix > class
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,cls", [("serve.layer0.mlp.ag", "ag"),
                                      ("serve.layer0.mlp.rs", "rs"),
                                      ("serve.layer1.mlp.ag", "ag"),
                                      ("serve.layer1.mlp.rs", None)])
def test_serve_site_precedence(site, cls):
    spec = {"serve.layer0.mlp.ag": ("ring", 8), "serve.layer0": ("ring", 4),
            "ag": ("chunked", 2)}
    got = {}
    for name, pkg in (("port", C), ("reference", JC)):
        with pkg.use_runtime_plan(_plan(pkg, spec)):
            rt, src = pkg.explain_runtime(site, cls)
            got[name] = (rt.strategy, rt.num_chunks, src)
    assert got["port"] == got["reference"]
    want_src = {"serve.layer0.mlp.ag": "serve.layer0.mlp.ag", "serve.layer0.mlp.rs":
                "serve.layer0", "serve.layer1.mlp.ag": "ag", "serve.layer1.mlp.rs": ""}
    assert got["port"][2] == want_src[site]


# ---------------------------------------------------------------------------
# one plan drives two decode layers to different issued structure
# ---------------------------------------------------------------------------

def _issued_by_site(model, plan):
    mesh = make_mesh()
    caches = M.init_caches(CFG, 4, 32, device="cpu")
    toks = torch.zeros((4, 1), dtype=torch.int64)
    step = make_serve_step(CFG, mesh=mesh)
    with torch.no_grad(), C.record_issued() as rows:
        if plan is None:
            step(model, toks, caches)
        else:
            with C.use_runtime_plan(plan):
                step(model, toks, caches)
    return sorted({(r.site, r.op, r.num_chunks, r.matmuls) for r in rows})


@pytest.mark.parametrize("variant", ["tuned", "uniform"])
def test_one_plan_two_layers_diverge_in_issued_structure(pair, variant):
    _, _, model = pair
    plain = _issued_by_site(model, None)
    tuned = _issued_by_site(model, _plan(C, TWO_LAYERS))
    uniform = _issued_by_site(model, _plan(C, {k: ("ring", 2) for k in TWO_LAYERS}))
    assert all(chunks == 1 for _, _, chunks, _ in plain)
    got = {site: chunks for site, op, chunks, _ in (tuned if variant == "tuned" else uniform)
           if op == "ring_ag_matmul"}
    layer1 = 4 if variant == "tuned" else 2
    assert got == {"serve.layer0.mlp.ag": 2, "serve.layer1.mlp.ag": layer1}
    assert tuned != plain and tuned != uniform


# ---------------------------------------------------------------------------
# fixed engine: plans scoped per batch, restored on every exit path
# ---------------------------------------------------------------------------

def test_fixed_engine_plan_scoped_and_restored(pair):
    jcfg, jp, model = pair
    prompts = _prompts(4, lo=8, hi=9)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the port warns nothing: no degraded site
        want = make_engine(CFG, model, mode="fixed", batch_size=4,
                           max_seq=32).generate(prompts, max_new=4)
        eng = make_engine(CFG, model, mode="fixed", batch_size=4, max_seq=32,
                          plan=_plan(C, TWO_LAYERS))
        with C.record_issued() as rows:
            got = eng.generate(prompts, max_new=4)
    # (the reference runs outside the filter: jax itself may warn a deprecation)
    ref = jmake_engine(jcfg, jp, mode="fixed", batch_size=4, max_seq=32,
                       plan=_plan(JC, TWO_LAYERS)).generate(prompts, max_new=4)
    assert got == want == ref  # chunking is numerically identity
    assert {(r.site, r.num_chunks) for r in rows
            if r.site.endswith(".ag")} == {("serve.layer0.mlp.ag", 2),
                                           ("serve.layer1.mlp.ag", 4)}
    assert eng.mesh.size == 1 and eng.mesh.group is None
    assert C.active_runtime_plan() == {}  # scoped, not installed

    # an exception inside the scoped region restores the ambient plan too
    binding = eng._binding
    with pytest.raises(RuntimeError, match="boom"):
        with binding.scope(binding.current):
            assert C.active_runtime_plan() == _plan(C, TWO_LAYERS)
            raise RuntimeError("boom")
    assert C.active_runtime_plan() == {}

    # a step that raises (a token past the vocabulary) restores it as well
    step, _ = eng._compiled(binding.current)
    with pytest.raises(IndexError):
        step(torch.full((4, 1), CFG.vocab_size), M.init_caches(CFG, 4, 32, device="cpu"))
    assert C.active_runtime_plan() == {}


# ---------------------------------------------------------------------------
# repository binding: banded resolution as the serving shape drifts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    path = tmp_path_factory.mktemp("repo")
    wl = J.extract_decode_workload(jget_smoke(ARCH), J.ParallelPlan(kind="tp", tp=2),
                                   global_batch=4, seq=32)
    J.tune(wl, "tpu-v5e", method="nccl", repo=str(path))
    return str(path)


@pytest.mark.parametrize("batch,band", [(6, 0.5), (4, 0.5), (6, 0.1)])
def test_engine_repo_banded_resolution(pair, repo, batch, band):
    jcfg, jp, model = pair
    prompts = _prompts(batch, lo=8, hi=9)
    kw = dict(mode="fixed", batch_size=batch, max_seq=32, repo=repo,
              plan_hardware="tpu-v5e", plan_parallel="tp:2", plan_band=band)
    eng = make_engine(CFG, model, **kw)
    got = eng.generate(prompts, max_new=2)
    ref = jmake_engine(jcfg, jp, **kw)
    assert got == ref.generate(prompts, max_new=2)
    assert eng.plan_stats == ref.plan_stats
    how = {(6, 0.5): "banded", (4, 0.5): "exact", (6, 0.1): "miss"}[batch, band]
    assert eng.plan_stats[how] == 1
    if how == "miss":
        assert eng._binding.current is None  # a miss serves untuned
    else:
        assert any(s.startswith("serve.") for s in eng._binding.current)


# ---------------------------------------------------------------------------
# continuous engine: hot-swap between batches, re-resolution on shape drift
# ---------------------------------------------------------------------------

def _run_batch(eng, seed, req_cls, n=3):
    rs = np.random.default_rng(seed)
    for i in range(n):
        eng.submit(req_cls(rid=i, prompt=rs.integers(0, CFG.vocab_size, size=6)
                           .astype(np.int32), max_new=4))
    return [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]


def test_continuous_engine_hot_swap_between_batches(pair):
    jcfg, jp, model = pair
    spec = {"serve.layer0.mlp.ag": ("ring", 2), "serve.layer1.mlp.rs": ("chunked", 2)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        base = make_engine(CFG, model, mode="continuous", slots=2, max_seq=32)
        want1, want2 = _run_batch(base, 1, Request), _run_batch(base, 2, Request)
        eng = make_engine(CFG, model, mode="continuous", slots=2, max_seq=32,
                          plan=_plan(C, spec))
        got1 = _run_batch(eng, 1, Request)  # tuned batch
        eng.set_plan(None)  # hot-swap to untuned between batches
        got2 = _run_batch(eng, 2, Request)
    ref = jmake_engine(jcfg, jp, mode="continuous", slots=2, max_seq=32)
    assert got1 == want1 == _run_batch(ref, 1, JRequest)
    assert got2 == want2
    assert eng.plan_stats["swaps"] == 1
    assert len(eng._fns) == 2  # one step per plan digest, not reused
    assert C.active_runtime_plan() == {}


def test_continuous_engine_readmits_resolve_on_shape_drift(pair, tmp_path):
    jcfg, jp, model = pair
    wl = J.extract_decode_workload(jcfg, J.ParallelPlan(kind="tp", tp=2),
                                   global_batch=3, seq=32)
    J.tune(wl, "tpu-v5e", method="nccl", repo=str(tmp_path))
    stats = []
    for make, req_cls, params, cfg in ((make_engine, Request, model, CFG),
                                       (jmake_engine, JRequest, jp, jcfg)):
        eng = make(cfg, params, mode="continuous", slots=3, max_seq=32, repo=str(tmp_path),
                   plan_hardware="tpu-v5e", plan_parallel="tp:2", plan_band=0.5)
        rs = np.random.default_rng(0)
        # 2 requests in flight first (banded: the tuned shape is batch 3),
        # then 3 (exact)
        outs = []
        for rids in (range(2), range(2, 5)):
            for rid in rids:
                eng.submit(req_cls(rid=rid, prompt=rs.integers(0, CFG.vocab_size, size=5)
                                   .astype(np.int32), max_new=2))
            outs += [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]
        stats.append((eng.plan_stats, outs))
    assert stats[0] == stats[1]
    got = stats[0][0]
    assert got["banded"] >= 1 and got["exact"] >= 1 and got["miss"] == 0


# ---------------------------------------------------------------------------
# make_engine factory + unified Request
# ---------------------------------------------------------------------------

def test_make_engine_modes(pair):
    _, _, model = pair
    assert available_engines() == ["continuous", "fixed"]
    assert isinstance(make_engine(CFG, model, mode="fixed", batch_size=2, max_seq=32),
                      Engine)
    assert isinstance(make_engine(CFG, model, mode="continuous", slots=2, max_seq=32),
                      ContinuousEngine)
    with pytest.raises(KeyError, match="unknown engine mode 'nope'"):
        make_engine(CFG, model, mode="nope")


def test_request_is_one_class():
    import repro_torch.serving.continuous as cont
    import repro_torch.serving.engine as eng
    from repro_torch.serving.types import Request as R

    assert eng.Request is R and cont.Request is R and Request is R
    r = Request(rid=3, prompt=np.asarray([1, 2], np.int32), max_new=5)
    assert (r.rid, r.max_new, r.out) == (3, 5, [])
