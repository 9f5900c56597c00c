"""FSDP placements of the port at 4 ranks against the reference's GSPMD
step on 4 host devices, on smoke ``llama3-8b`` in fp32 with the
reference's weights (converted through numpy) and the same batches.

Four ``gloo`` ranks (one process each, ``file://`` rendezvous) place the
model (``models.model.shard_`` on ``make_mesh((4, 1))`` and ``((2, 2))``,
data x model): every F dim is this rank's slice over ``data``, the MLP's
T dims over ``model``; each rank takes its rows of the global batch and
trains under ``constraints.use_axes`` with the sited trunk on the model
axis (``PLAN`` at 2x2).  A fifth process runs the reference as its
launcher does: ``param_specs`` placements ``device_put`` on a mesh of 4
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
under ``use_axes``, ``jax.jit`` of its train step.

Bounds are ``tests/test_torch_tp_train.py``'s: the loss 1e-5 absolute,
gradients 1e-4 of each leaf's max|g| (the slices gathered), one step 1e-5
(parameters and AdamW's moments absolute; loss and grad_norm relative),
with eps = 1e-3.  After three steps the leaves that ranks hold alike must
be bit-equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, reference_layout  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 4
ARCH = "llama3-8b"
B, S = 8, 32                    # 2 rows a rank at 4x1: grad_accum=2 and microbatches=2 split them
LOSS_BOUND, GRAD_BOUND, STEP_ATOL, STEP_RTOL = 1e-5, 1e-4, 1e-5, 1e-5
STEP_OPT = dict(lr=1e-2, eps=1e-3)
CLIP_NORM = 0.05
PLAN = {"tp.layer0.mlp.ag": ("ring", 2), "tp.layer0.mlp.rs": ("chunked", 4),
        "tp.layer1.mlp.ag": ("ring", 4), "tp.layer1.mlp.rs": ("chunked", 2)}
# (mesh, mode) -> TrainConfig fields
STEPS = {("4x1", "plain"): {}, ("4x1", "grad_accum2"): dict(grad_accum=2),
         ("4x1", "microbatches2"): dict(microbatches=2), ("4x1", "clip"): {},
         ("2x2", "plain"): {}, ("2x2", "grad_accum2"): dict(grad_accum=2)}

_PORT = r"""
import dataclasses, hashlib, json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, rdv, inp, sd, out = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C, constraints as CT
from repro_torch.train import trainer as T

d = dict(np.load(inp))
cfg = get_smoke_config("llama3-8b")
plan = {k: C.CollectiveRuntime(*v) for k, v in json.loads(str(d["plan"])).items()}
opt = json.loads(str(d["opt"]))
steps = json.loads(str(d["steps"]))
full = torch.load(sd)
batch = {n: torch.from_numpy(d[n]) for n in ("tokens", "targets", "mask")}
B = batch["tokens"].shape[0]
meshes = {"4x1": make_mesh((4, 1), ("data", "model")), "2x2": make_mesh((2, 2), ("data", "model"))}
res, log = {}, {"shapes": {}, "issued": {}, "digests": {}}

def fresh(mesh):
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(full)
    return M.shard_(cfg, model, mesh)

def rows_of(mesh):
    k = B // mesh["data"].size
    return {n: a[mesh["data"].rank * k:(mesh["data"].rank + 1) * k] for n, a in batch.items()}

def axes(mesh):
    return CT.use_axes(("data",), "model", sizes={a: m.size for a, m in mesh.items()}, batch=B)

def tcfg(mesh, **kw):
    return T.TrainConfig(opt=adamw.AdamWConfig(**opt), warmup=2, total_steps=10,
                         sited_mesh=mesh["model"], data_axis=mesh["data"], **kw)

for name, mesh in meshes.items():
    model = fresh(mesh)
    place = model.placement
    log["shapes"][name] = {n: list(p.shape) for n, p in model.named_parameters()}
    dm = mesh["data"]
    with C.use_runtime_plan(plan), axes(mesh), C.record_issued() as rows:
        loss, _ = M.loss_and_metrics(cfg, model, rows_of(mesh), mesh=mesh["model"])
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    log["issued"][name] = [dataclasses.astuple(r) for r in rows]
    split = {n for n in names if "data" in place.axes(n)}
    whole = C.psum_tree({n: g for n, g in zip(names, grads) if n not in split}, dm)
    res[f"{name}.grads.loss"] = C.psum_tree(loss.detach(), dm) / dm.size
    for n, g in zip(names, grads):
        res[f"{name}.grads.{n}"] = place.full(n, (g if n in split else whole[n]) / dm.size)

for key, kw in steps.items():
    name, mode = key.split("/")
    mesh = meshes[name]
    model = fresh(mesh)
    state = adamw.init_state(dict(model.named_parameters()))
    cfg_t = tcfg(mesh, **kw)
    if mode == "clip":
        cfg_t = dataclasses.replace(cfg_t, opt=adamw.AdamWConfig(**dict(opt, clip_norm=CLIP)))
    with C.use_runtime_plan(plan), axes(mesh):
        model, state, m = T.make_train_step(cfg, cfg_t)(model, state, rows_of(mesh), 1)
    place = model.placement
    for n, p in model.named_parameters():
        res[f"{name}.{mode}.{n}"] = place.full(n, p.detach())
        for k in ("mu", "nu"):
            res[f"{name}.{mode}.{k}.{n}"] = place.full(n, state[k][n])
    for k in ("loss", "grad_norm"):
        res[f"{name}.{mode}.{k}"] = m[k]

for name, mesh in meshes.items():
    model = fresh(mesh)
    state = adamw.init_state(dict(model.named_parameters()))
    step = T.make_train_step(cfg, tcfg(mesh))
    with C.use_runtime_plan(plan), axes(mesh):
        for k in range(3):
            model, state, _ = step(model, state, rows_of(mesh), k + 1)
    log["digests"][name] = {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                            for n, p in model.named_parameters()}

mesh = meshes["4x1"]
model = fresh(mesh)
try:
    T.make_train_step(cfg, T.TrainConfig(grad_accum=2, accum_axis=mesh["data"],
                                         data_axis=mesh["data"]))(
        model, adamw.init_state(dict(model.named_parameters())), rows_of(mesh), 1)
except NotImplementedError as e:
    log["acco"] = str(e)
try:
    T.make_train_step(cfg, T.TrainConfig())(
        model, adamw.init_state(dict(model.named_parameters())), rows_of(mesh), 1)
except ValueError as e:
    log["no_data_axis"] = str(e)
with axes(mesh):
    try:
        M.loss_and_metrics(cfg, model, batch, mesh=mesh["model"])
    except ValueError as e:
        log["whole_batch"] = str(e)
np.savez(out + ".npz", **{k: v.numpy() for k, v in res.items()})
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
""".replace("CLIP", repr(CLIP_NORM))

_REFERENCE = r"""
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.parallel import constraints as CT, sharding as SH
from repro.train import trainer as JT

inp, out = sys.argv[1:3]
d = dict(np.load(inp))
cfg = get_smoke_config("llama3-8b")
opt = json.loads(str(d["opt"]))
steps = json.loads(str(d["steps"]))
batch = {n: jnp.asarray(d[n]) for n in ("tokens", "targets", "mask")}
p = jax.jit(lambda k: JM.init_params(cfg, k))(jax.random.PRNGKey(0))
res = {}

def put(tag, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{tag}." + "/".join(x.key for x in k)] = np.asarray(v)

MODES = {"plain": {}, "grad_accum2": dict(grad_accum=2), "microbatches2": dict(microbatches=2),
         "clip": {}}
for name, shape in (("4x1", (4, 1)), ("2x2", (2, 2))):
    mesh = make_mesh(shape, ("data", "model"))
    jax.sharding.set_mesh(mesh)
    with CT.use_axes(("data",), "model"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec = SH.param_specs(p, mesh)
        ps = jax.device_put(p, jax.tree.map(lambda s: NamedSharding(mesh, s), spec))
        loss, g = jax.jit(jax.value_and_grad(lambda q, b: JM.loss_and_metrics(
            cfg, q, b, remat=True)[0]))(ps, batch)
        res[f"{name}.grads.loss"] = np.asarray(loss)
        put(f"{name}.grads", g)
        for key in steps:
            if not key.startswith(name + "/"):
                continue
            mode = key.split("/")[1]
            o = dict(opt, clip_norm=CLIP) if mode == "clip" else opt
            step = jax.jit(JT.make_train_step(cfg, JT.TrainConfig(
                opt=JA.AdamWConfig(**o), warmup=2, total_steps=10, **MODES[mode])))
            p2, s2, m = step(ps, JA.init_state(ps), batch, jnp.asarray(1))
            tag = f"{name}.{mode}"
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
        node, parts = tree, rest.split("/")
        for x in parts[:-1]:
            node = node.setdefault(x, {})
        node[parts[-1]] = a
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on 4 gloo ranks and the reference on 4 host devices,
    concurrently; returns (config, per-rank (results, log), reference)."""
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM

    tmp = tmp_path_factory.mktemp("fsdp_train")
    cfg = get_smoke_config(ARCH)
    b = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                   seed=7)).batch(0)
    steps = {f"{m}/{mode}": kw for (m, mode), kw in STEPS.items()}
    np.savez(tmp / "inputs.npz", **b, plan=np.asarray(json.dumps(PLAN)),
             opt=np.asarray(json.dumps(STEP_OPT)), steps=np.asarray(json.dumps(steps)))
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
@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_fsdp_loss_and_gradients_match_reference(runs, mesh, rank):
    """The global batch's loss and every gradient (each rank's reduce-
    scattered slices divided by the data size, the whole leaves averaged
    over data, gathered) against the reference's ``jax.value_and_grad`` of
    its placed parameters, with remat."""
    cfg, ranks, ref = runs
    got = ranks[rank][0]
    assert abs(float(got[f"{mesh}.grads.loss"]) - float(ref[f"{mesh}.grads.loss"])) < LOSS_BOUND
    want = params_from_jax(cfg, _tree(ref, f"{mesh}.grads"))
    for k, w in want.items():
        g = got[f"{mesh}.grads.{k}"]
        assert g.shape == tuple(w.shape), k
        assert _diff(g, w) <= GRAD_BOUND * _max(w), (k, _diff(g, w), _max(w))


@pytest.mark.parametrize("mesh,mode", sorted(STEPS))
def test_fsdp_train_step_matches_reference(runs, mesh, mode):
    """One step of each mode from the reference's weights against the
    reference's GSPMD step of that mode: each rank's parameters and
    moments (gathered) within 1e-5, loss and grad_norm within 1e-5
    relative.  ``grad_accum=2`` splits each rank's rows, where the
    reference splits the global batch: the mean gradient is the same."""
    cfg, ranks, ref = runs
    tag = f"{mesh}.{mode}"
    if mode == "clip":
        assert float(ref[f"{tag}.grad_norm"]) > 10 * CLIP_NORM
    for got, _ in ranks:
        for k, w in params_from_jax(cfg, _tree(ref, tag)).items():
            assert _diff(got[f"{tag}.{k}"], w) <= STEP_ATOL, (tag, k)
        for m in ("mu", "nu"):
            for k, w in params_from_jax(cfg, _tree(ref, f"{tag}.{m}")).items():
                assert _diff(got[f"{tag}.{m}.{k}"], w) <= STEP_ATOL, (tag, m, k)
        for k in ("loss", "grad_norm"):
            w = float(ref[f"{tag}.{k}"])
            assert abs(float(got[f"{tag}.{k}"]) - w) <= STEP_RTOL * abs(w), (tag, k)


def _held(cfg, mesh):
    """Port name -> the reference spec's axes on that leaf in the port's
    layout (stacked dims dropped, ``w`` leaves reversed), the T dims kept
    on attention's q and o, the MLP weights, the embedding and the head; k
    and v keep theirs whole, as smoke llama3-8b's one KV head does not split
    over ``model``."""
    from repro.parallel import sharding as JSH

    shape = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    stub = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((shape["data"], shape["model"])))
    layout = reference_layout(cfg, M.init_params(cfg, 0, device="cpu"))
    specs = JSH.param_specs({p: jax.ShapeDtypeStruct(leaf.shape, np.float32)
                             for p, leaf in {lf.path: lf for lf in layout.values()}.items()},
                            stub)
    out = {}
    for name, leaf in layout.items():
        s = tuple(specs[leaf.path])
        s = (s + (None,) * (len(leaf.shape) - len(s)))[leaf.lead:]
        s = s[::-1] if leaf.transposed else s
        held = ".mlp." in name or name.endswith(
            ("attn.q.weight", "attn.o.weight", "embed.weight", "head.weight"))
        out[name] = tuple(a if a == "data" or held else None for a in s)
    return out, shape


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_each_rank_holds_its_slice(runs, mesh):
    """Each rank's parameters have the shapes the reference's specs give:
    every dim split over ``data`` (or, on attention's q and o, the MLP, the
    embedding and the head, ``model``) divided by that axis's size, the rest
    whole."""
    cfg, ranks, _ = runs
    held, shape = _held(cfg, mesh)
    whole = M.init_params(cfg, 0, device="cpu").state_dict()
    split_some = False
    for _, log in ranks:
        got = log["shapes"][mesh]
        assert set(got) == set(held)
        for name, spec in held.items():
            want = [n // shape[a] if a else n for n, a in zip(whole[name].shape, spec)]
            assert got[name] == want, (name, spec)
            split_some |= want != list(whole[name].shape)
    assert split_some


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_leaves_held_alike_stay_bit_equal(runs, mesh):
    """After three steps every leaf is bit-equal on the ranks that hold the
    same slice of it: the norms on all four; at 2x2 the slices of k and v
    (whole on ``model``) on both model ranks of a data index."""
    cfg, ranks, _ = runs
    held, shape = _held(cfg, mesh)
    digests = [log["digests"][mesh] for _, log in ranks]
    m = shape["model"]
    for name, spec in held.items():
        coord = {r: tuple((r // m) if a == "data" else (r % m) for a in spec if a)
                 for r in range(N)}
        for r in range(N):
            for q in range(N):
                if coord[r] == coord[q]:
                    assert digests[r][name] == digests[q][name], (name, r, q)


def test_gathers_issue_a_collective_each(runs):
    """One forward and backward at 4x1: each layer's split weights are
    gathered at ``fsdp.layer{i}.ag_params`` twice (the forward and remat's
    recompute) and reduce-scattered once, the embedding and the head once
    each way, every call one collective."""
    cfg, ranks, _ = runs
    per_layer = sum(1 for n, s in _held(cfg, "4x1")[0].items()
                    if n.startswith("trunk.dense_layers.0.") and "data" in s)
    for _, log in ranks:
        rows = {}
        for site, op, chunks, matmuls, colls in log["issued"]["4x1"]:
            if site.startswith("fsdp."):
                assert colls == 1 and chunks == 1 and matmuls == 0
                rows.setdefault(site, []).append(op)
        want = {f"fsdp.layer{i}.ag_params": ["all_gather"] * 2 * per_layer
                + ["all_gather.bwd"] * per_layer for i in range(cfg.num_layers)}
        want.update({f"fsdp.{k}.ag_params": ["all_gather", "all_gather.bwd"]
                     for k in ("embed", "head")})
        assert {k: sorted(v) for k, v in rows.items()} == {k: sorted(v) for k, v in want.items()}


def test_placement_refusals(runs):
    """ACCO (``accum_axis``) on a model placed over data raises
    ``NotImplementedError``; a placed model without its data axis refuses
    to train; with the axes and batch installed, the whole global batch on
    one rank fails the constraint check."""
    _, ranks, _ = runs
    for _, log in ranks:
        assert "ACCO" in log["acco"]
        assert "data_axis" in log["no_data_axis"]
        assert "share of the global batch" in log["whole_batch"]
