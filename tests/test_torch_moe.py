"""The port's MoE family against the JAX reference on the CPU, fp32, with
the reference's weights (initialised in JAX, converted through numpy): the
smoke configs of ``deepseek-moe-16b`` (a leading dense layer, shared
experts), ``olmoe-1b-7b`` (``qk_norm``; top-2 of 4 at smoke size) and
``qwen2-moe-a2.7b`` (``attn_bias``, a gated shared expert, its experts
padded with ``ep_pad`` 16: 4 real, 12 padded, as the reference's dry run
pads them).

Covered: ``moe_block``'s output and aux with and without overflow (the
capacity checked to drop or not), the loss (``ce + router_aux_coef ·
aux``) and every gradient, the logits, a cached prefill and decode, the
fixed and continuous engines' tokens (the continuous engine routes each
slot alone, as the reference's vmap does), a plan hot swap on the MoE
sites and the repository re-admission case, the per-layer
``ep.layer{j}.moe.a2a_disp|comb`` structure and the sited trunk's
numerics on a size-1 mesh, the indivisible buffer's warning, and the
reference's aux check of ``tests/test_models.py``.

Bounds: 1e-4 absolute for block outputs, logits and losses
(``tests/test_torch_model.py``'s; the frameworks sum matrix products in
different orders), 1e-5 relative for aux, gradients 1e-4 of each leaf's
max|g| (``tests/test_torch_tp_train.py``'s); tokens exactly.
"""
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import layers as JL, model as JM  # noqa: E402
from repro.serving import Request as JRequest, make_engine as jmake_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.models import layers as L, model as M  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.serving import Request, make_engine  # noqa: E402

ARCHS = {"deepseek-moe-16b": 1, "olmoe-1b-7b": 1, "qwen2-moe-a2.7b": 16}   # arch -> ep_pad
BOUND = 1e-4
AUX_RTOL = 1e-5
GRAD_BOUND = 1e-4
MAX_SEQ = 48


@pytest.fixture(autouse=True)
def _clean_plan_state():
    yield
    C.install_runtime_plan({})
    C.reset_degraded_warnings()


def _make(arch):
    pad = ARCHS[arch]
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key, ep_pad=pad))(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jp)
    model = M.init_params(cfg, 0, device="cpu", ep_pad=pad)
    model.load_state_dict(params_from_jax(cfg, tree))
    return cfg, jcfg, jp, tree, model


@pytest.fixture(scope="module", params=list(ARCHS))
def trio(request):
    return _make(request.param)


@pytest.fixture(scope="module")
def olmoe():
    return _make("olmoe-1b-7b")


def _np(a):
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_params_round_trip(trio):
    """Every leaf survives ``params_from_jax`` and back, the experts in the
    reference's (E, d, f) layout (not transposed), padded experts included."""
    cfg, _, _, tree, model = trio
    back = params_to_jax(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    moe = model.trunk.moe_layers[0].moe
    assert moe.experts == moe.gate.shape[0] == L.moe_pad_experts(cfg.num_experts,
                                                                  ARCHS[cfg.name])
    assert moe.router.weight.shape == (cfg.num_experts, cfg.d_model)


@pytest.mark.parametrize("cf,overflow", [(0.5, True), (4.0, False)])
def test_moe_block_matches_reference(trio, cf, overflow):
    """The first MoE layer's block on a numpy input: output and aux, with a
    capacity that drops tokens and one that keeps them all."""
    cfg, jcfg, jp, _, model = trio
    jmoe = jax.tree.map(lambda a: a[0], jp["trunk"]["moe_layers"])["moe"]
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, jaux = JL.moe_block(jmoe, jcfg, jnp.asarray(x), capacity_factor=cf)
    with torch.no_grad():
        got, aux = L.moe_block(model.trunk.moe_layers[0].moe, cfg, torch.from_numpy(x),
                               capacity_factor=cf)
    assert _err(got, want) < BOUND
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))
    probs = jax.nn.softmax(JL.linear(jmoe["router"], jnp.asarray(x.reshape(-1, cfg.d_model))))
    counts = np.bincount(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]).reshape(-1),
                         minlength=cfg.num_experts)
    cap = max(1, int(32 * cfg.top_k * cf / cfg.num_experts))
    assert bool((counts > cap).any()) == overflow


def test_loss_and_gradients_match_reference(trio):
    """``loss_and_metrics`` with remat: loss, ce and aux, and every gradient
    against ``jax.grad`` of the reference's."""
    cfg, jcfg, jp, _, model = trio
    toks = _tokens(cfg, 2, 17, seed=5)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jm = JM.loss_and_metrics(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax.grad(lambda q: JM.loss_and_metrics(
        jcfg, q, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    loss, m = M.loss_and_metrics(cfg, model, {k: torch.as_tensor(v) for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert abs(loss.item() - float(jloss)) < BOUND
    assert abs(m["ce"].item() - float(jm["ce"])) < BOUND
    assert abs(m["aux"].item() - float(jm["aux"])) <= AUX_RTOL * abs(float(jm["aux"]))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    for n, g in zip(names, grads):
        w = want[n].numpy()
        assert _err(g, w) <= GRAD_BOUND * float(np.abs(w).max()), n


def test_forward_logits_match_reference(trio):
    cfg, jcfg, jp, _, model = trio
    toks = _tokens(cfg, 2, 16, seed=7)
    with torch.no_grad():
        x, _, aux = M.forward_hidden(cfg, model, {"tokens": torch.as_tensor(toks)})
        logits = M._unembed(cfg, model, x)
    jx, _, jaux = JM.forward_hidden(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert _err(logits, JM._unembed(jcfg, jp, jx)) < BOUND
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))


def test_prefill_then_decode_matches_reference(trio):
    """A cached prefill of S-1 tokens (both segments' caches) and one decode
    step: the decode logits against the reference's."""
    cfg, jcfg, jp, _, model = trio
    toks = _tokens(cfg, 2, 12, seed=9)
    S = toks.shape[1]
    with torch.no_grad():
        c = M.init_caches(cfg, 2, 32, device="cpu")
        _, c, _ = M.forward_hidden(cfg, model, {"tokens": torch.as_tensor(toks[:, :S - 1])}, c)
        logits, c2 = M.decode_step(cfg, model, torch.as_tensor(toks[:, S - 1:]), c)
    assert set(c["trunk"]) == set(JM.init_caches(jcfg, 2, 32)["trunk"])
    jc = JM.init_caches(jcfg, 2, 32)
    _, jc, _ = JM.forward_hidden(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S - 1])}, jc)
    jlogits, _ = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, S - 1:]), jc)
    assert _err(logits, jlogits) < BOUND
    assert c2["pos"] == S and all(seg["pos"] == S for seg in c2["trunk"].values())


def _prompts(cfg, n, lo=5, hi=10, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.integers(0, cfg.vocab_size, int(rs.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def test_fixed_engine_matches_reference(trio):
    """Ragged prompts through both fixed engines: equal greedy tokens, and
    the teacher-forced logits' argmax is the port's tokens."""
    cfg, jcfg, jp, _, model = trio
    prompts = _prompts(cfg, 3)
    got = make_engine(cfg, model, batch_size=3, max_seq=MAX_SEQ).generate(prompts, max_new=5)
    want = jmake_engine(jcfg, jp, batch_size=3, max_seq=MAX_SEQ).generate(prompts, max_new=5)
    assert got == want
    eng = make_engine(cfg, model, batch_size=3, max_seq=MAX_SEQ)
    assert eng.teacher_forced_logits(prompts, got).argmax(-1).tolist() == got


def _serve(engine, req_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(rid=i, prompt=p, max_new=max_new))
    return {r.rid: r.out for r in engine.run()}


def test_continuous_engine_matches_reference(trio):
    """More requests than slots, ragged admits and reused slots: each slot
    routes its tokens alone, so the tokens equal the reference's vmapped
    engine's."""
    cfg, jcfg, jp, _, model = trio
    prompts = _prompts(cfg, 5, seed=1)
    got = _serve(make_engine(cfg, model, mode="continuous", slots=2, max_seq=MAX_SEQ),
                 Request, prompts, 4)
    want = _serve(jmake_engine(jcfg, jp, mode="continuous", slots=2, max_seq=MAX_SEQ),
                  JRequest, prompts, 4)
    assert got == want


def test_continuous_hot_swap_on_moe_sites(olmoe):
    """The reference's ``tests/test_serving_plan.py`` hot swap on the MoE
    sites: a plan that chunks layer 0's dispatch by 2 and layer 1's combine
    by 4, then no plan, between batches of a continuous engine on the
    size-1 mesh: tokens equal to the unplanned engine's and the reference's,
    one swap, one step per plan digest, the ambient plan restored."""
    cfg, jcfg, jp, _, model = olmoe
    plan = {"serve.layer0.moe.a2a_disp": C.CollectiveRuntime("chunked", 2),
            "serve.layer1.moe.a2a_comb": C.CollectiveRuntime("chunked", 4)}

    def run_batch(eng, seed, req_cls):
        rs = np.random.default_rng(seed)
        for i in range(3):
            eng.submit(req_cls(rid=i, prompt=rs.integers(0, cfg.vocab_size, size=6)
                               .astype(np.int32), max_new=4))
        return [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        base = make_engine(cfg, model, mode="continuous", slots=2, max_seq=32)
        want1, want2 = run_batch(base, 1, Request), run_batch(base, 2, Request)
        eng = make_engine(cfg, model, mode="continuous", slots=2, max_seq=32, plan=plan)
        with C.record_issued() as rows:
            got1 = run_batch(eng, 1, Request)
        eng.set_plan(None)
        got2 = run_batch(eng, 2, Request)
    ref = jmake_engine(jcfg, jp, mode="continuous", slots=2, max_seq=32)
    assert got1 == want1 == run_batch(ref, 1, JRequest)
    assert got2 == want2
    assert eng.plan_stats["swaps"] == 1 and len(eng._fns) == 2
    assert C.active_runtime_plan() == {}
    chunks = {(r.site, r.op, r.num_chunks) for r in rows}
    assert ("serve.layer0.moe.a2a_disp", "all_to_all", 2) in chunks
    assert ("serve.layer1.moe.a2a_comb", "all_to_all", 4) in chunks
    assert ("serve.layer0.moe.a2a_comb", "all_to_all", 1) in chunks


def test_continuous_readmits_resolve_on_shape_drift(olmoe, tmp_path):
    """The reference's re-admission case: an ep:2 decode plan in a
    repository, two requests in flight (banded) then three (exact); the
    plan stats and tokens equal the reference engine's."""
    cfg, jcfg, jp, _, model = olmoe
    wl = J.extract_decode_workload(jcfg, J.ParallelPlan(kind="ep", ep=2), global_batch=3,
                                   seq=32)
    J.tune(wl, "tpu-v5e", method="nccl", repo=str(tmp_path))
    stats = []
    for make, req_cls, params, c in ((make_engine, Request, model, cfg),
                                     (jmake_engine, JRequest, jp, jcfg)):
        eng = make(c, params, mode="continuous", slots=3, max_seq=32, repo=str(tmp_path),
                   plan_hardware="tpu-v5e", plan_parallel="ep:2", plan_band=0.5)
        rs = np.random.default_rng(0)
        outs = []
        for rids in (range(2), range(2, 5)):
            for rid in rids:
                eng.submit(req_cls(rid=rid, prompt=rs.integers(0, cfg.vocab_size, size=5)
                                   .astype(np.int32), max_new=2))
            outs += [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]
        stats.append((eng.plan_stats, outs))
    assert stats[0] == stats[1]
    got = stats[0][0]
    assert got["banded"] >= 1 and got["exact"] >= 1 and got["miss"] == 0


def _issued(cfg, model, batch, plan):
    with C.use_runtime_plan(plan), C.record_issued() as rows, torch.no_grad():
        M.forward_hidden(cfg, model, batch, mesh=make_mesh())
    return sorted({(r.site, r.num_chunks) for r in rows if r.site.startswith("ep.")})


def test_moe_per_layer_a2a_sites_change_structure():
    """The reference's per-layer a2a test (``tests/test_plan_sites.py``):
    one plan entry at ``ep.layer0.moe`` drives both of that layer's
    all-to-alls, ``...a2a_disp`` the dispatch alone; deepseek's MoE layer
    is layer 0 of its segment (the dense layer 0 keeps ``tp.layer0.mlp``)."""
    cfg, _, _, _, model = _make("deepseek-moe-16b")
    batch = {"tokens": torch.arange(16).reshape(2, 8) % cfg.vocab_size}
    rt = C.CollectiveRuntime
    a = _issued(cfg, model, batch, {"ep.layer0.moe": rt("chunked", 2)})
    b = _issued(cfg, model, batch, {"ep.layer0.moe": rt("chunked", 4)})
    c = _issued(cfg, model, batch, {"ep.layer0.moe.a2a_disp": rt("chunked", 2)})
    assert a == [("ep.layer0.moe.a2a_comb", 2), ("ep.layer0.moe.a2a_disp", 2)]
    assert b == [("ep.layer0.moe.a2a_comb", 4), ("ep.layer0.moe.a2a_disp", 4)]
    assert c == [("ep.layer0.moe.a2a_comb", 1), ("ep.layer0.moe.a2a_disp", 2)]
    with C.record_issued() as rows, torch.no_grad():
        M.forward_hidden(cfg, model, batch, mesh=make_mesh())
    assert {r.site for r in rows} >= {"tp.layer0.mlp.ag", "tp.layer0.mlp.rs"}


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_sited_trunk_matches_unsited_numerics(arch):
    """``tests/test_plan_sites.py``'s check: the sited trunk on a size-1
    mesh under ``tp`` and ``ep`` plans of 2 chunks, against the unsited."""
    cfg = get_smoke_config(arch)
    model = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.arange(16).reshape(2, 8) % cfg.vocab_size}
    plan = {"tp": C.CollectiveRuntime("chunked", 2), "ep": C.CollectiveRuntime("chunked", 2)}
    with torch.no_grad():
        ref, _, aux_ref = M.forward_hidden(cfg, model, batch)
        with C.use_runtime_plan(plan):
            out, _, aux = M.forward_hidden(cfg, model, batch, mesh=make_mesh())
    assert _err(out, ref) < BOUND
    assert abs(float(aux) - float(aux_ref)) <= AUX_RTOL * max(abs(float(aux_ref)), 1e-30)


def test_moe_buffer_guard_warns_with_site_and_matches_plain():
    """``tests/test_plan_sites.py``'s buffer guard: E = 4 and cap = 10 do
    not divide a 3-rank model axis; the block warns once naming the site and
    computes every expert, equal to the plain block.  The reference's
    own warning is held beside it."""
    from repro.parallel import collectives as JC

    cfg, jcfg, jp, _, model = _make("deepseek-moe-16b")
    p = model.trunk.moe_layers[0].moe
    x = torch.ones((2, 8, cfg.d_model)) * 0.1
    with torch.no_grad():
        ref, aux_ref = L.moe_block(p, cfg, x)
        with pytest.warns(C.CollectiveDegradedWarning, match="ep.layer0.moe"):
            out, aux = L.moe_block(p, cfg, x, mesh=Mesh(None, 3, 0), site="ep.layer0.moe")
    assert torch.equal(out, ref) and torch.equal(aux, aux_ref)

    class FakeMesh:
        shape = {"model": 3}

    JC.reset_degraded_warnings()
    jmoe = jax.tree.map(lambda a: a[0], jp["trunk"]["moe_layers"])["moe"]
    with pytest.warns(RuntimeWarning, match="cap=10"):
        JL.moe_block(jmoe, jcfg, jnp.asarray(x.numpy()), mesh=FakeMesh(), site="ep.layer0.moe")


def test_a2a_indivisible_chunks_warn_with_site():
    """``tests/test_plan_sites.py``'s a2a case: 3 chunks do not divide a
    trailing dim of 10; the dispatch site warns once, naming itself, and
    issues one unchunked all-to-all."""
    x = torch.ones((4, 4, 10))
    with C.record_issued() as rows, pytest.warns(C.CollectiveDegradedWarning,
                                                 match="ep.layer0.moe.a2a_disp"):
        y = C.chunked_all_to_all(x, Mesh(None), split_axis=1, concat_axis=0, num_chunks=3,
                                 site="ep.layer0.moe.a2a_disp")
    assert torch.equal(y, x)
    assert [(r.site, r.num_chunks) for r in rows] == [("ep.layer0.moe.a2a_disp", 1)]


def test_moe_aux_loss_signals_imbalance():
    """``tests/test_models.py``'s check on the port: E · Σ me·ce of a
    near-uniform router is about 1."""
    cfg = get_smoke_config("olmoe-1b-7b")
    model = M.init_params(cfg, 0, device="cpu")
    toks = _tokens(cfg, 2, 17, seed=0)
    with torch.no_grad():
        _, m = M.loss_and_metrics(cfg, model, {"tokens": torch.as_tensor(toks[:, :-1]),
                                               "targets": torch.as_tensor(toks[:, 1:])})
    assert float(m["aux"]) > 0.9


def test_top_k_orders_ties_as_the_reference():
    """Equal probabilities: the lower expert index comes first, as in
    ``lax.top_k``, so a token's slots (and their cumsum positions) agree."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    vals, idx = L._top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(jv))


def test_launchers_take_a_moe_arch_on_cpu(capsys):
    """``launch.serve`` and ``launch.train`` with ``--arch olmoe-1b-7b
    --smoke`` on the CPU: the server emits tokens, the trainer logs aux."""
    from repro_torch.launch import serve, train

    serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--max-new", "3", "--max-seq", "32"])
    run = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--steps", "2",
                      "--seq", "16", "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(run["losses"]) == 2 and all(np.isfinite(run["losses"]))
    assert " aux " in out


def test_routing_replay_forces_the_recorded_choices(olmoe, monkeypatch):
    """``layers.record_routing`` records each MoE site's choices in call
    order; replayed into a run whose top-k picks other experts, every block
    takes the recorded ones, so the output equals the recording run's
    exactly; a data rank's replay takes its rows of the record."""
    cfg, _, _, _, model = olmoe
    toks = torch.as_tensor(_tokens(cfg, 2, 16, seed=13))
    with torch.no_grad(), L.record_routing() as rec:
        want, _, _ = M.forward_hidden(cfg, model, {"tokens": toks})
    assert sorted(rec.calls) == ["ep.layer0.moe", "ep.layer1.moe"]
    assert rec.calls["ep.layer0.moe"][0].shape == (32, cfg.top_k)
    top_k = L._top_k
    monkeypatch.setattr(L, "_top_k", lambda probs, k: top_k(-probs, k))   # the least likely
    with torch.no_grad():
        moved, _, _ = M.forward_hidden(cfg, model, {"tokens": toks})
        with L.record_routing(replay=rec) as again:
            forced, _, _ = M.forward_hidden(cfg, model, {"tokens": toks})
    monkeypatch.undo()
    assert again is rec and again._next == {"ep.layer0.moe": 1, "ep.layer1.moe": 1}
    assert _err(moved, want) > 1e-2
    assert torch.equal(forced, want)
    with torch.no_grad(), L.record_routing() as rows:
        M.forward_hidden(cfg, model, {"tokens": toks[1:]})
    part = L.Routing()
    part.calls = rec.calls
    assert torch.equal(part.replay("ep.layer0.moe", slice(16, 32)), rows.calls["ep.layer0.moe"][0])
