"""The port's training path (``repro_torch.train``, ``models.model``'s loss,
``data.pipeline``) against the JAX reference on smoke ``llama3-8b`` in fp32:
parameters made by ``jax.random`` and converted through numpy, the same
numpy batches through both.

Bounds (the reference sets none for port-vs-reference training):
  * the data pipeline: byte-equal batches;
  * the loss and its metrics: 1e-5 absolute (fp32, the two frameworks sum
    in different orders);
  * gradients: 1e-4 of each parameter's max|g| (the bound of the port's
    attention outputs against the reference, tests/test_torch_model.py);
  * one train step (plain, grad_accum=2, microbatches=2, ACCO): updated
    parameters and moments within 1e-5 absolute, loss and grad_norm within
    1e-5 relative.  Adam's first step is sign(g) where |g| ≫ eps, so a
    gradient element that is rounding noise would flip its update by 2·lr;
    the step tests use eps = 1e-3, which bounds the update's sensitivity to
    a gradient error by lr / eps.
ACCO runs on 4 gloo ranks (one process each, ``file://`` rendezvous)
against the reference's ACCO step under ``shard_map`` on 4 host devices
(a fifth process), as ``tests/test_torch_collectives.py`` does."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticCorpus as JCorpus  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import dense, model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.train import metrics as MET, trainer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3-8b"
LOSS_BOUND = 1e-5
GRAD_BOUND = 1e-4
STEP_ATOL = STEP_RTOL = 1e-5
BLOCKWISE_S = 2112          # > 2048: the reference takes _blockwise_attention
STEP_OPT = dict(lr=1e-2, eps=1e-3)
STEP_SCHED = dict(warmup=2, total_steps=10)
N = 4


@pytest.fixture(scope="module")
def ref():
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    return cfg, jcfg, jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp))


def _model(cfg, sd):
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(sd)
    return model


def _batch(cfg, B, S, *, step=0, seed=0):
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=seed)
    return SyntheticCorpus(dc).batch(step)


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _np_tree(cfg, tree):
    return params_from_jax(cfg, jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 1), (0, 4), (11, 2)])
def test_synthetic_corpus_matches_reference(seed, shards):
    kw = dict(vocab_size=512, seq_len=33, global_batch=8, seed=seed)
    for shard in range(shards):
        mine = SyntheticCorpus(DataConfig(**kw), shard=shard, num_shards=shards)
        theirs = JCorpus(JDataConfig(**kw), shard=shard, num_shards=shards)
        for step in (0, 1, 7):
            a, b = mine.batch(step), theirs.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,mask", [(256, "ones"), (200, "random"), (96, "absent")])
def test_loss_matches_reference(ref, S, mask):
    """chunked_ce and loss_and_metrics at S a multiple of the 256 chunk and
    at ragged S with a mask; without a mask, the mask defaults to ones."""
    cfg, jcfg, jp, sd = ref
    b = _batch(cfg, 2, S)
    if mask == "random":
        b["mask"] = (np.random.default_rng(1).random(b["mask"].shape) < 0.7).astype(np.float32)
    elif mask == "absent":
        del b["mask"]
    jl, jm = JM.loss_and_metrics(jcfg, jp, _jax(b))
    with torch.no_grad():
        tl, tm = M.loss_and_metrics(cfg, _model(cfg, sd), _torch(b))
    assert abs(float(tl) - float(jl)) < LOSS_BOUND
    assert sorted(tm) == sorted(jm) == ["aux", "ce", "loss"]
    for k in tm:
        assert abs(float(tm[k]) - float(jm[k])) < LOSS_BOUND


@pytest.mark.parametrize("S,remat", [(96, True), (96, False), (BLOCKWISE_S, True)])
def test_gradients_match_reference(ref, S, remat):
    """Every parameter's gradient against jax.grad's (converted through
    params_from_jax's transposes), with remat on and off, and at S = 2112,
    where the reference's attention is blockwise and the port's plain
    version computes the dense scores."""
    cfg, jcfg, jp, sd = ref
    B = 1 if S == BLOCKWISE_S else 2
    b = _batch(cfg, B, S)
    jg = jax.jit(jax.grad(lambda p, bb: JM.loss_and_metrics(jcfg, p, bb, remat=remat)[0]))(
        jp, _jax(b))
    want = _np_tree(cfg, jg)
    model = _model(cfg, sd)
    loss, _ = M.loss_and_metrics(cfg, model, _torch(b), remat=remat)
    names, params = zip(*model.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, params)))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape, k
        assert (g - w).abs().max().item() <= GRAD_BOUND * w.abs().max().item(), k


def test_remat_recomputes_each_layer(ref, monkeypatch):
    """remat=True runs each layer's forward once more in the backward and
    gives the same gradients as remat=False (the same ops on the same
    inputs)."""
    cfg, _, _, sd = ref
    b = _torch(_batch(cfg, 2, 64))
    calls = []
    real = dense.layer_fwd
    monkeypatch.setattr(dense, "layer_fwd", lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    out = {}
    for remat in (False, True):
        calls.clear()
        model = _model(cfg, sd)
        loss, _ = M.loss_and_metrics(cfg, model, b, remat=remat)
        names, params = zip(*model.named_parameters())
        out[remat] = torch.autograd.grad(loss, params)
        assert len(calls) == (2 if remat else 1) * cfg.num_layers
    assert all(torch.equal(a, c) for a, c in zip(out[False], out[True]))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

MODES = {"plain": {}, "grad_accum2": dict(grad_accum=2), "microbatches2": dict(microbatches=2)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_step_matches_reference(ref, mode):
    """One step of each mode from the same parameters on the same batch:
    updated parameters, mu and nu, loss and grad_norm as the reference's
    make_train_step in the same mode."""
    cfg, jcfg, jp, sd = ref
    b = _batch(cfg, 4, 64)
    jstep = jax.jit(JT.make_train_step(jcfg, JT.TrainConfig(
        opt=JA.AdamWConfig(**STEP_OPT), **STEP_SCHED, **MODES[mode])))
    jp2, js2, jm = jstep(jp, JA.init_state(jp), _jax(b), jnp.asarray(1))
    model = _model(cfg, sd)
    state = adamw.init_state(dict(model.named_parameters()))
    step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**STEP_OPT),
                                                **STEP_SCHED, **MODES[mode]))
    model, state, tm = step(model, state, _torch(b), 1)
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP_RTOL * abs(float(jm[k])), k
    want, want_state = _np_tree(cfg, jp2), opt_state_from_jax(
        cfg, jax.tree.map(np.asarray, js2))
    got = model.state_dict()
    for k, w in want.items():
        assert (got[k] - w).abs().max().item() <= STEP_ATOL, k
        for m in ("mu", "nu"):
            assert (state[m][k] - want_state[m][k]).abs().max().item() <= STEP_ATOL, (m, k)
    assert int(state["count"]) == int(want_state["count"]) == 1
    back = params_to_jax(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp2))


@pytest.mark.parametrize("arch", [ARCH, "stablelm-3b"])
def test_train_loop_reduces_loss(arch):
    """tests/test_substrate.py::test_training_reduces_loss on the port: its
    own model, smoke stablelm-3b (LayerNorm, partial rotary), and smoke
    llama3-8b; 25 steps on the port's SyntheticCorpus, the last five steps'
    mean loss 0.2 below the first five's."""
    cfg = get_smoke_config(arch)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    tcfg = T.TrainConfig(warmup=3, total_steps=25)
    _, hist = T.train_loop(cfg, tcfg, iter(SyntheticCorpus(dc)), steps=25, device="cpu",
                           log_every=0)
    assert sorted(hist) == ["loss", "mfu", "step_time"]
    assert all(len(v) == 25 for v in hist.values())
    assert np.mean(hist["loss"][-5:]) < np.mean(hist["loss"][:5]) - 0.2


def test_train_loop_is_seeded():
    """The loop makes its model from ``seed`` (a torch.Generator): the same
    seed gives the same history of losses, another seed another."""
    cfg = get_smoke_config(ARCH).replace(num_layers=1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    runs = [T.train_loop(cfg, T.TrainConfig(warmup=1, total_steps=3),
                         iter(SyntheticCorpus(dc)), steps=3, seed=s, device="cpu",
                         log_every=0)[1]["loss"] for s in (0, 0, 1)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_metrics_default_to_the_h100():
    cfg = get_smoke_config(ARCH)
    f = MET.train_step_flops(cfg, 1000)
    assert f.model == 6.0 * cfg.param_count(active_only=True) * 1000
    assert f.executed == 8.0 / 6.0 * f.model
    assert MET.H100_BF16_PEAK == 989.4e12 and MET.H100_FP32_PEAK == 67e12
    assert MET.mfu(cfg, 1000, 1.0) == f.model / 989.4e12
    tr = MET.Tracker(cfg, 1000, peak=MET.H100_FP32_PEAK)
    assert tr.update(2.0)["mfu"] == f.model / 2.0 / 67e12


# ---------------------------------------------------------------------------
# the sited path
# ---------------------------------------------------------------------------

def test_sited_path_at_one_rank_trains_as_unsited(ref):
    """The sited trunk on a size-1 mesh under a plan: the loss and every
    gradient as the unsited trunk's, every tp.layer{i}.mlp site issued."""
    cfg, _, _, sd = ref
    b = _torch(_batch(cfg, 2, 64))
    model = _model(cfg, sd)
    names, params = zip(*model.named_parameters())
    loss_u, _ = M.loss_and_metrics(cfg, model, b)
    g_u = torch.autograd.grad(loss_u, params)
    plan = {"tp.layer0.mlp.ag": C.CollectiveRuntime("ring", 2),
            "tp.layer1.mlp.rs": C.CollectiveRuntime("chunked", 2)}
    with C.use_runtime_plan(plan), C.record_issued() as rows:
        loss_s, _ = M.loss_and_metrics(cfg, model, b, mesh=Mesh(None))
        g_s = torch.autograd.grad(loss_s, params)
    assert abs(loss_s.item() - loss_u.item()) < LOSS_BOUND
    for n, a, c in zip(names, g_s, g_u):
        assert (a - c).abs().max().item() <= GRAD_BOUND * c.abs().max().item(), n
    sites = {(r.site, r.num_chunks) for r in rows}
    assert sites == {("tp.layer0.mlp.ag", 2), ("tp.layer0.mlp.rs", 1),
                     ("tp.layer1.mlp.ag", 1), ("tp.layer1.mlp.rs", 2)}


def test_remat_recomputes_under_the_forwards_plan(ref):
    """On the card autograd runs the backward, and so remat's recompute, on
    its own device thread, where the forward's scoped plan (a context
    variable) is not active.  Here the backward runs on another thread:
    the recompute must still chunk as the forward did (or checkpoint
    refuses the different tensors it saved), the backward must use the
    forward's chunk count and log into the forward's recorder, and the
    gradients equal those of a backward on the forward's thread."""
    import threading

    cfg, _, _, sd = ref
    b = _torch(_batch(cfg, 2, 64))
    model = _model(cfg, sd)
    names, params = zip(*model.named_parameters())
    plan = {"tp.layer0.mlp.rs": C.CollectiveRuntime("chunked", 4)}
    grads = {}
    for where in ("same thread", "other thread"):
        with C.use_runtime_plan(plan), C.record_issued() as rows:
            loss, _ = M.loss_and_metrics(cfg, model, b, mesh=Mesh(None))
        if where == "same thread":
            grads[where] = torch.autograd.grad(loss, params)
            continue
        t = threading.Thread(target=lambda: grads.__setitem__(
            where, torch.autograd.grad(loss, params)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        # the forward, remat's recompute and the backward, each at 4 chunks
        assert [(r.op, r.num_chunks) for r in rows if r.site == "tp.layer0.mlp.rs"] == [
            ("mm_reduce_scatter", 4), ("mm_reduce_scatter", 4), ("mm_reduce_scatter.bwd", 4)]
    assert all(torch.equal(a, c) for a, c in zip(grads["same thread"], grads["other thread"]))


_TWO_RANKS = r"""
import sys, numpy as np, torch, torch.distributed as dist
rank, rdv, sd, inp, out = int(sys.argv[1]), *sys.argv[2:6]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=2)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import trainer as T
cfg = get_smoke_config("llama3-8b")
model = M.init_params(cfg, 0, device="cpu")
model.load_state_dict(torch.load(sd))
mesh = make_mesh()
M.shard_(cfg, model, mesh)
assert model.trunk.dense_layers[0].mlp.gate.weight.shape[0] == cfg.d_ff // 2
d = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(lr=1e-2, eps=1e-3), warmup=2,
                                            total_steps=10, sited_mesh=mesh))
model, state, m = step(model, adamw.init_state(dict(model.named_parameters())), d, 1)
full = params_from_jax(cfg, params_to_jax(cfg, model))     # the shards gathered
if rank == 0:
    np.savez(out, loss=m["loss"].numpy(), **{k: v.numpy() for k, v in full.items()})
dist.destroy_process_group()
"""


def test_sited_training_beyond_one_rank_names_its_slice(ref, tmp_path):
    """Beyond one rank the sited trunk no longer raises naming a later
    slice: it trains.  At mesh size 2 (2 gloo ranks), the model sharded in
    place, one step equals the unsited step on one process: the loss and
    every parameter (the shards gathered) within 1e-5."""
    cfg, _, _, sd = ref
    b = _batch(cfg, 2, 64)
    torch.save(sd, tmp_path / "params.pt")
    np.savez(tmp_path / "batch.npz", **b)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), str(tmp_path / "rdv"),
                               str(tmp_path / "params.pt"), str(tmp_path / "batch.npz"),
                               str(tmp_path / "out.npz")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    got = dict(np.load(tmp_path / "out.npz"))
    model = _model(cfg, sd)
    step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**STEP_OPT), **STEP_SCHED))
    model, _, m = step(model, adamw.init_state(dict(model.named_parameters())), _torch(b), 1)
    assert abs(float(got["loss"]) - float(m["loss"])) <= STEP_RTOL * abs(float(m["loss"]))
    for k, w in model.state_dict().items():
        assert np.abs(got[k] - w.numpy()).max() <= STEP_ATOL, k


def test_sharding_guards(ref):
    """An unsharded trunk at mesh size 2 under grad refuses (its MLP copies
    would carry no gradient to the model); a trunk sharded in place runs
    only on its mesh, and is sharded once."""
    cfg, _, _, sd = ref
    model = _model(cfg, sd)
    b = _torch(_batch(cfg, 2, 64))
    with pytest.raises(ValueError, match="shard the trunk in place"):
        M.loss_and_metrics(cfg, model, b, mesh=Mesh(None, size=2))
    mesh = Mesh(None)
    M.shard_(cfg, model, mesh)
    assert model.trunk.mlp_mesh is mesh
    assert all(model.placement.axes(n) == () for n, _ in model.named_parameters())
    for kw in ({}, dict(mesh=Mesh(None, size=2))):
        with pytest.raises(ValueError, match="run it on that mesh"):
            M.loss_and_metrics(cfg, model, b, **kw)
    with pytest.raises(ValueError, match="already sharded"):
        M.shard_(cfg, model, mesh)
    loss, _ = M.loss_and_metrics(cfg, model, b, mesh=mesh)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# ACCO on 4 gloo ranks against the reference on 4 host devices
# ---------------------------------------------------------------------------

ACCO_PLAN = {"acc.step0.rs_grads": ("chunked", 2), "acc.step1.rs_grads": ("chunked", 4)}
ACCO_B, ACCO_S = 16, 32          # 4 sequences a rank, 2 microbatches of 2

_ACCO_PORT = r"""
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, rdv, inp, sd, out = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.train import trainer as T

d = dict(np.load(inp))
opt = json.loads(str(d["opt"]))
cfg = get_smoke_config("llama3-8b")
mesh = make_mesh()
k = d["tokens"].shape[0] // world
batch = {n: torch.from_numpy(d[n][rank * k:(rank + 1) * k]) for n in ("tokens", "targets", "mask")}
res, log = {}, {}
for name, plan in json.loads(str(d["plans"])).items():
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(torch.load(sd))
    state = adamw.init_state(dict(model.named_parameters()))
    step = T.make_train_step(cfg, T.TrainConfig(
        opt=adamw.AdamWConfig(**opt), warmup=2, total_steps=10, grad_accum=2,
        accum_axis=mesh))
    events = []
    real = M.loss_and_metrics
    def traced(*a, **kw):      # each microbatch's forward, after what was issued so far
        events.append(("forward", len(rows)))
        return real(*a, **kw)
    M.loss_and_metrics = traced
    with C.use_runtime_plan({s: C.CollectiveRuntime(*v) for s, v in plan.items()}), \
            C.record_issued() as rows:
        model, state, m = step(model, state, batch, 1)
    M.loss_and_metrics = real
    for n, t in model.state_dict().items():
        res[f"{name}.{n}"] = t.numpy()
    res[f"{name}.loss"] = m["loss"].numpy()
    res[f"{name}.grad_norm"] = m["grad_norm"].numpy()
    log[name] = {"rows": [dataclasses.astuple(r) for r in rows], "events": events}
np.savez(out + ".npz", **res)
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
"""

_ACCO_REFERENCE = r"""
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.parallel import collectives as C
from repro.parallel.collectives import shard_map
from repro.train import trainer as JT

inp, out = sys.argv[1:3]
d = dict(np.load(inp))
opt = json.loads(str(d["opt"]))
cfg = get_smoke_config("llama3-8b")
mesh = make_mesh((4,), ("data",))
p = jax.jit(lambda k: JM.init_params(cfg, k))(jax.random.PRNGKey(0))
batch = {n: jnp.asarray(d[n]) for n in ("tokens", "targets", "mask")}
res = {}
for name, plan in json.loads(str(d["plans"])).items():
    tcfg = JT.TrainConfig(opt=JA.AdamWConfig(**opt), warmup=2, total_steps=10, grad_accum=2,
                          accum_axis="data")
    step = JT.make_train_step(cfg, tcfg)

    def body(params, state, b):
        params, state, m = step(params, state, b, jnp.asarray(1))
        return params, state, {k: m[k][None] for k in ("loss", "grad_norm")}

    with C.use_runtime_plan({s: C.CollectiveRuntime(*v) for s, v in plan.items()}), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(), P("data")),
                               out_specs=(P(), P(), P("data")), check_vma=False))
        params, _, m = fn(p, JA.init_state(p), batch)
    for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        res[f"{name}." + "/".join(x.key for x in k)] = np.asarray(v)
    res[f"{name}.loss"] = np.asarray(m["loss"])
    res[f"{name}.grad_norm"] = np.asarray(m["grad_norm"])
np.savez(out + ".npz", **res)
"""


@pytest.fixture(scope="module")
def acco(tmp_path_factory, ref):
    """ACCO (grad_accum=2 over the data-parallel axis) on 4 gloo ranks and
    on 4 host devices, under no plan and under ACCO_PLAN, concurrently."""
    cfg = ref[0]
    tmp = tmp_path_factory.mktemp("acco")
    b = _batch(cfg, ACCO_B, ACCO_S, seed=5)
    np.savez(tmp / "inputs.npz", **b, opt=np.asarray(json.dumps(STEP_OPT)),
             plans=np.asarray(json.dumps({"none": {}, "planned": ACCO_PLAN})))
    torch.save(ref[3], tmp / "params.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ACCO_PORT, str(r), str(N), str(tmp / "rdv"),
         str(tmp / "inputs.npz"), str(tmp / "params.pt"), str(tmp / f"rank{r}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(N)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _ACCO_REFERENCE, str(tmp / "inputs.npz"), str(tmp / "reference")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    ranks = []
    for r in range(N):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append((dict(np.load(tmp / f"rank{r}.npz")), json.load(f)))
    return cfg, ranks, dict(np.load(tmp / "reference.npz"))


@pytest.mark.parametrize("plan", ["none", "planned"])
def test_acco_matches_reference_on_four_ranks(acco, plan):
    """Every rank's updated parameters equal the reference's (one replicated
    tree) within 1e-5; each rank's loss and grad_norm are its shard's, as
    the reference's are."""
    cfg, ranks, want = acco
    tree = {}
    for key, a in want.items():
        name, _, path = key.partition(".")
        if name != plan or path in ("loss", "grad_norm"):
            continue
        node = tree
        parts = path.split("/")
        for x in parts[:-1]:
            node = node.setdefault(x, {})
        node[parts[-1]] = a
    want_sd = params_from_jax(cfg, tree)
    for r, (got, _) in enumerate(ranks):
        for k, w in want_sd.items():
            assert np.abs(got[f"{plan}.{k}"] - w.numpy()).max() <= STEP_ATOL, (r, k)
        for k in ("loss", "grad_norm"):
            w = float(want[f"{plan}.{k}"][r])
            assert abs(float(got[f"{plan}.{k}"]) - w) <= STEP_RTOL * abs(w), (r, k)


@pytest.mark.parametrize("plan", ["none", "planned"])
def test_acco_issues_each_microbatch_reduce_before_the_next_forward(acco, plan):
    """Step k's gradient sync is issued at site acc.step{k}.rs_grads with
    the plan's chunk count (1 unplanned), one all-reduce per chunk of every
    parameter, and step 0's are all issued before microbatch 1's forward."""
    cfg, ranks, _ = acco
    n_leaves = len(M.Model(cfg, device="meta").state_dict())
    chunks = {s: v[1] for s, v in ACCO_PLAN.items()} if plan == "planned" else {}
    for _, log in ranks:
        rows = [tuple(r) for r in log[plan]["rows"]]
        assert len(rows) == 2 * n_leaves
        for k in (0, 1):
            nc = chunks.get(f"acc.step{k}.rs_grads", 1)
            want = (f"acc.step{k}.rs_grads", "psum", nc, 0, nc)
            assert rows[k * n_leaves:(k + 1) * n_leaves] == [want] * n_leaves
        assert log[plan]["events"] == [["forward", 0], ["forward", n_leaves]]
