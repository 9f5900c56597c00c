"""Tensor-parallel training of the port at 4 ranks against the reference's
sited path on 4 host devices, on smoke ``llama3-8b`` in fp32 with the
reference's weights (converted through numpy) and the same batches.

Four ``gloo`` ranks (one process each, ``file://`` rendezvous) run the
port with the model sharded in place (``models.model.shard_``); a fifth
process runs the reference with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and ``mesh=`` its
``make_mesh((4,), ("model",))`` or ``make_mesh((2, 2), ("data",
"model"))`` as the sited mesh.  Both run under ``PLAN``, which gives
layers 0 and 1 different chunk counts at both sites.

Bounds are those of ``tests/test_torch_train.py``: the loss 1e-5
absolute, gradients 1e-4 of each parameter's max|g| (the shards gathered),
and one train step 1e-5 (parameters, AdamW's moments absolute; loss and
grad_norm relative), with eps = 1e-3 as there.  The replicated parameters
(the norms, and k and v: smoke llama3-8b's one KV head does not split) must
be bit-equal on every rank after three steps.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 4
ARCH = "llama3-8b"
B, S = 4, 32                    # 8 rows a rank's sequence shard: 2 and 4 chunks divide it
LOSS_BOUND, GRAD_BOUND, STEP_ATOL, STEP_RTOL = 1e-5, 1e-4, 1e-5, 1e-5
STEP_OPT = dict(lr=1e-2, eps=1e-3)
CLIP_NORM = 0.05                # the gradients' norm is about 10: clipping bites
PLAN = {"tp.layer0.mlp.ag": ("ring", 2), "tp.layer0.mlp.rs": ("chunked", 4),
        "tp.layer1.mlp.ag": ("ring", 4), "tp.layer1.mlp.rs": ("chunked", 2)}
# port mode -> (TrainConfig fields, the reference mode it is held to)
MODES = {"plain": ({}, "plain"), "grad_accum2": (dict(grad_accum=2), "grad_accum2"),
         "microbatches2": (dict(microbatches=2), "microbatches2"),
         "acco": (dict(grad_accum=2), "grad_accum2"),
         "clip": ({}, "clip")}

_PORT = r"""
import dataclasses, hashlib, json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, rdv, inp, sd, out = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.train import trainer as T

d = dict(np.load(inp))
cfg = get_smoke_config("llama3-8b")
plan = {k: C.CollectiveRuntime(*v) for k, v in json.loads(str(d["plan"])).items()}
opt = json.loads(str(d["opt"]))
modes = json.loads(str(d["modes"]))
full = torch.load(sd)
batch = {n: torch.from_numpy(d[n]) for n in ("tokens", "targets", "mask")}
meshes = {"1x4": make_mesh((1, 4), ("data", "model")), "2x2": make_mesh((2, 2), ("data", "model"))}
res, log = {}, {}

def fresh(mesh):
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(full)
    return M.shard_(cfg, model, mesh["model"])

def gather(name, t, model):
    place = model.placement
    if "model" not in place.axes(name):
        return t
    dim = place.dim(name, "model")
    g = C.all_gather_rows((t if dim == 0 else t.T).contiguous(), place.meshes["model"])
    return g if dim == 0 else g.T

def rows_of(mesh):
    k = B // mesh["data"].size
    return {n: a[mesh["data"].rank * k:(mesh["data"].rank + 1) * k] for n, a in batch.items()}

B = batch["tokens"].shape[0]
mesh = meshes["1x4"]
model = fresh(mesh)
with C.use_runtime_plan(plan), C.record_issued() as rows:
    loss, _ = M.loss_and_metrics(cfg, model, batch, mesh=mesh["model"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
res["grads.loss"] = loss.detach()
for n, g in zip(names, grads):
    res[f"grads.{n}"] = gather(n, g, model)
log["grads"] = [dataclasses.astuple(r) for r in rows]

def one_step(tag, mesh, kw, acco, clip=None):
    model = fresh(mesh)
    state = adamw.init_state(dict(model.named_parameters()))
    o = dict(opt, clip_norm=clip) if clip else opt
    tcfg = T.TrainConfig(opt=adamw.AdamWConfig(**o), warmup=2, total_steps=10,
                         sited_mesh=mesh["model"], data_axis=mesh["data"],
                         accum_axis=mesh["data"] if acco else None, **kw)
    with C.use_runtime_plan(plan):
        model, state, m = T.make_train_step(cfg, tcfg)(model, state, rows_of(mesh), 1)
    for n, p in model.named_parameters():
        res[f"{tag}.{n}"] = gather(n, p.detach(), model)
        for k in ("mu", "nu"):
            res[f"{tag}.{k}.{n}"] = gather(n, state[k][n], model)
    for k in ("loss", "grad_norm"):
        res[f"{tag}.{k}"] = m[k]

for mode, kw in modes.items():
    one_step(mode, mesh, kw, mode == "acco", CLIP if mode == "clip" else None)
for mode, kw in (("plain", {}), ("acco", dict(grad_accum=2))):
    one_step(f"2x2.{mode}", meshes["2x2"], kw, mode == "acco")

log["digests"] = {}
for name, mesh in meshes.items():
    model = fresh(mesh)
    state = adamw.init_state(dict(model.named_parameters()))
    step = T.make_train_step(cfg, T.TrainConfig(opt=adamw.AdamWConfig(**opt), warmup=2,
                                                total_steps=10, sited_mesh=mesh["model"],
                                                data_axis=mesh["data"]))
    with C.use_runtime_plan(plan):
        for k in range(3):
            model, state, _ = step(model, state, rows_of(mesh), k + 1)
    log["digests"][name] = {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                            for n, p in model.named_parameters()}
    log.setdefault("shapes", {})[name] = {n: list(p.shape) for n, p in model.named_parameters()}
np.savez(out + ".npz", **{k: v.numpy() for k, v in res.items()})
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
""".replace("CLIP", repr(CLIP_NORM))

_REFERENCE = r"""
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.parallel import collectives as C
from repro.train import trainer as JT

inp, out = sys.argv[1:3]
d = dict(np.load(inp))
cfg = get_smoke_config("llama3-8b")
plan = {k: C.CollectiveRuntime(*v) for k, v in json.loads(str(d["plan"])).items()}
opt = json.loads(str(d["opt"]))
batch = {n: jnp.asarray(d[n]) for n in ("tokens", "targets", "mask")}
p = jax.jit(lambda k: JM.init_params(cfg, k))(jax.random.PRNGKey(0))
mesh4 = make_mesh((4,), ("model",))
mesh22 = make_mesh((2, 2), ("data", "model"))
res = {}

def put(tag, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{tag}." + "/".join(x.key for x in k)] = np.asarray(v)

MODES = {"plain": {}, "grad_accum2": dict(grad_accum=2), "microbatches2": dict(microbatches=2),
         "clip": {}}
with C.use_runtime_plan(plan), warnings.catch_warnings():       # plans bind at trace time
    warnings.simplefilter("ignore")
    loss, g = jax.jit(jax.value_and_grad(lambda q, b: JM.loss_and_metrics(
        cfg, q, b, remat=True, mesh=mesh4)[0]))(p, batch)
    res["grads.loss"] = np.asarray(loss)
    put("grads", g)
    for tag, mesh, mode in [(m, mesh4, m) for m in MODES] + [
            ("2x2.plain", mesh22, "plain"), ("2x2.grad_accum2", mesh22, "grad_accum2")]:
        o = dict(opt, clip_norm=CLIP) if mode == "clip" else opt
        step = jax.jit(JT.make_train_step(cfg, JT.TrainConfig(
            opt=JA.AdamWConfig(**o), warmup=2, total_steps=10, sited_mesh=mesh, **MODES[mode])))
        p2, s2, m = step(p, JA.init_state(p), batch, jnp.asarray(1))
        put(tag, p2)
        put(tag + ".mu", s2["mu"])
        put(tag + ".nu", s2["nu"])
        res[f"{tag}.loss"] = np.asarray(m["loss"])
        res[f"{tag}.grad_norm"] = np.asarray(m["grad_norm"])
np.savez(out + ".npz", **res)
""".replace("CLIP", repr(CLIP_NORM))


def _tree(flat, prefix):
    """The nested tree of the reference's leaves saved under ``prefix.``."""
    tree = {}
    for key, a in flat.items():
        rest = key[len(prefix) + 1:]
        if not key.startswith(prefix + ".") or "." in rest or "/" not in rest:
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for x in parts[:-1]:
            node = node.setdefault(x, {})
        node[parts[-1]] = a
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on 4 gloo ranks and the reference on 4 host devices,
    concurrently; returns (per-rank results, per-rank logs, reference)."""
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM

    tmp = tmp_path_factory.mktemp("tp_train")
    cfg = get_smoke_config(ARCH)
    b = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                   seed=5)).batch(0)
    modes = {m: kw for m, (kw, _) in MODES.items()}
    np.savez(tmp / "inputs.npz", **b, plan=np.asarray(json.dumps(PLAN)),
             opt=np.asarray(json.dumps(STEP_OPT)), modes=np.asarray(json.dumps(modes)))
    jp = jax.jit(lambda key: JM.init_params(jget_smoke(ARCH), key))(jax.random.PRNGKey(0))
    torch.save(params_from_jax(cfg, jax.tree.map(np.asarray, jp)), tmp / "params.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT, str(r), str(N), str(tmp / "rdv"),
         str(tmp / "inputs.npz"), str(tmp / "params.pt"), str(tmp / f"rank{r}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(N)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.npz"), str(tmp / "reference")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
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


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float64)).max())


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("rank", range(N))
def test_sited_loss_and_gradients_match_reference(runs, rank):
    """The loss and every gradient of the sharded model at 1x4 under PLAN
    (each rank's MLP shard gradients gathered) against the reference's
    sited ``jax.value_and_grad`` with remat."""
    cfg, ranks, ref = runs
    got = ranks[rank][0]
    assert abs(float(got["grads.loss"]) - float(ref["grads.loss"])) < LOSS_BOUND
    want = params_from_jax(cfg, _tree(ref, "grads"))
    for k, w in want.items():
        g = got[f"grads.{k}"]
        assert g.shape == tuple(w.shape), k
        assert _diff(g, w) <= GRAD_BOUND * _max(w), k


def _site_rows(rows):
    out = {}
    for site, op, chunks, *_ in rows:
        out.setdefault(site, []).append((op, chunks))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("rank", range(N))
def test_layers_issue_their_own_forward_and_backward_structure(runs, rank):
    """One forward and backward under PLAN: each site's forward runs once
    and once more in remat's recompute, its backward once (the ring's for
    gate and up, twice a layer), every one at that layer's chunk count.
    The placement's all-reduces, unchunked: attention's rows summed at
    ``tp.layer{i}.attn.ar`` (forward and recompute), its input's gradient
    at ``.ar.bwd``, and, smoke llama3-8b's one KV head being whole on
    ``model``, the k and v weights' gradients at ``.kv.ar.bwd``; the
    embedding once, the cross-entropy's chunk twice (two sums each) and its
    input's gradient once."""
    _, ranks, _ = runs
    rows = _site_rows(ranks[rank][1]["grads"])
    want = {}
    for site, (_, nc) in PLAN.items():
        op = "ring_ag_matmul" if site.endswith(".ag") else "mm_reduce_scatter"
        k = 2 if site.endswith(".ag") else 1
        want[site] = sorted([(op, nc)] * 2 * k + [(op + ".bwd", nc)] * k)
    for i in range(2):
        want[f"tp.layer{i}.attn.ar"] = [("all_reduce", 1)] * 2
        want[f"tp.layer{i}.attn.ar.bwd"] = [("all_reduce.bwd", 1)]
        want[f"tp.layer{i}.attn.kv.ar.bwd"] = [("all_reduce.bwd", 1)] * 2
    want.update({"tp.embed.ar": [("all_reduce", 1)], "tp.ce.ar": [("vocab_ce", 1)] * 2,
                 "tp.ce.ar.bwd": [("all_reduce.bwd", 1)]})
    assert rows == want
    assert rows["tp.layer0.mlp.ag"] != rows["tp.layer1.mlp.ag"]


def _check_step(cfg, got, ref, tag, ref_tag, *, loss: bool = True):
    want = params_from_jax(cfg, _tree(ref, ref_tag))
    for k, w in want.items():
        assert _diff(got[f"{tag}.{k}"], w) <= STEP_ATOL, (tag, k)
    for m in ("mu", "nu"):
        for k, w in params_from_jax(cfg, _tree(ref, f"{ref_tag}.{m}")).items():
            assert _diff(got[f"{tag}.{m}.{k}"], w) <= STEP_ATOL, (tag, m, k)
    for k in ("loss", "grad_norm") if loss else ("grad_norm",):
        w = float(ref[f"{ref_tag}.{k}"])
        assert abs(float(got[f"{tag}.{k}"]) - w) <= STEP_RTOL * abs(w), (tag, k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tp_train_step_matches_reference(runs, mode):
    """One step of each mode at 1x4 under PLAN from the reference's weights
    against the reference's sited step in that mode: ACCO (over the 1-rank
    data axis) is held to ``grad_accum=2``, which takes the same mean
    gradient; ``clip`` clips the norm to 0.05, so a norm summed over one
    rank's shards only would clip by another factor."""
    cfg, ranks, ref = runs
    if mode == "clip":
        assert float(ref["clip.grad_norm"]) > 10 * CLIP_NORM
    for got, _ in ranks:
        _check_step(cfg, got, ref, mode, MODES[mode][1])


@pytest.mark.parametrize("mode", ["plain", "acco"])
def test_two_by_two_mesh_matches_reference(runs, mode):
    """(data 2) x (model 2): each data rank takes its two rows of the batch.
    A plain step averages the gradients over the data axis; an ACCO step
    (grad_accum=2 over the data axis) reduces them in its own sync.  Both
    against the reference's sited step on its 2x2 mesh (ACCO's against
    ``grad_accum=2``; its loss is its data rank's, so only grad_norm)."""
    cfg, ranks, ref = runs
    ref_tag = "2x2.plain" if mode == "plain" else "2x2.grad_accum2"
    for got, _ in ranks:
        _check_step(cfg, got, ref, f"2x2.{mode}", ref_tag, loss=mode == "plain")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_replicated_parameters_stay_bit_equal(runs, mesh):
    """After three steps every replicated parameter (the norms, and k and v,
    whole on ``model`` since smoke llama3-8b's one KV head does not split)
    is bit-equal on every rank, and each shard on the ranks that hold the
    same shard.  Each rank holds 1/m of the query heads, of ``o``'s rows,
    of the MLP and of the vocabulary (embedding and head)."""
    cfg, ranks, _ = runs
    digests = [log["digests"][mesh] for _, log in ranks]
    model = 4 if mesh == "1x4" else 2
    place = M.shard_(cfg, M.init_params(cfg, 0, device="cpu"),
                     Mesh(None, model, 0, "model")).placement
    for name in digests[0]:
        if place.axes(name):
            for r in range(N):
                assert digests[r][name] == digests[r % model][name], (name, r)
        else:
            assert len({d[name] for d in digests}) == 1, name
    attn = "trunk.dense_layers.0.attn."
    replicated = {n for n in digests[0] if not place.axes(n)}
    assert replicated == {n for n in digests[0] if n.endswith((".scale", "k.weight",
                                                                "v.weight"))}
    D, q, V = cfg.d_model, cfg.q_dim // model, cfg.vocab_size // model
    want = {attn + "q.weight": [q, D], attn + "k.weight": [cfg.kv_dim, D],
            attn + "o.weight": [D, q], "embed.weight": [V, D], "head.weight": [V, D],
            "trunk.dense_layers.0.mlp.gate.weight": [cfg.d_ff // model, D]}
    for _, log in ranks:
        assert {n: log["shapes"][mesh][n] for n in want} == want


def test_mesh_lays_ranks_out_as_the_reference():
    """``make_mesh((d, m), ("data", "model"))`` puts rank ``i·m + j`` at data
    index ``i`` and model index ``j``, as ``jax.make_mesh`` orders its
    devices; a shape that is not the world size is refused."""
    from repro_torch.launch.mesh import make_mesh

    script = r"""
import json, sys, torch.distributed as dist
rank, rdv = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=4)
from repro_torch.launch.mesh import make_mesh
out = {}
for shape in ((2, 2), (1, 4), (4, 1), (4,)):
    axes = ("data", "model")[:len(shape)]
    ms = make_mesh(shape, axes)
    out["x".join(map(str, shape))] = {a: [m.size, m.rank, dist.get_process_group_ranks(m.group)]
                                      for a, m in ms.items()}
try:
    make_mesh((2, 4), ("data", "model"))
except ValueError as e:
    out["refused"] = str(e)
print(json.dumps(out))
dist.destroy_process_group()
"""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", script, str(r), tmp + "/rdv"],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(N)]
        outs = [p.communicate(timeout=120) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-2000:]
    for r, (o, _) in enumerate(outs):
        got = json.loads(o.strip().splitlines()[-1])
        assert got["2x2"] == {"data": [2, r // 2, [r % 2, r % 2 + 2]],
                              "model": [2, r % 2, [r - r % 2, r - r % 2 + 1]]}
        assert got["1x4"] == {"data": [1, 0, [r]], "model": [4, r, [0, 1, 2, 3]]}
        assert got["4x1"] == {"data": [4, r, [0, 1, 2, 3]], "model": [1, 0, [r]]}
        assert got["4"] == {"data": [4, r, [0, 1, 2, 3]]}
        assert "needs 8 ranks" in got["refused"]
    assert make_mesh().size == 1
