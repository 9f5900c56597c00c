"""The port's chunked collectives and its sited dense trunk at 4 ranks
against their dense oracles (``*_ref``) and against the reference's
helpers on 4 host devices, on the same inputs.

Four ``gloo`` ranks (one process each, ``file://`` rendezvous in a
temporary directory) run the port; one more process runs the reference
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (this session
keeps jax at one device).  Each runs every case once and writes its
results; the tests below compare them.

Bounds are the reference's (``tests/test_collectives.py:26,34,43``): 1e-4
for the all-gather matmul, 1e-3 for the reduce-scatter matmul, 1e-6 for
the all-to-all; 1e-4 for the summed trees (as the all-gather matmul);
the trunk's logits 1e-4 (``LOGITS_BOUND`` of ``tests/test_torch_serving.py``).
A chunk count of 3 divides none of the shards here and must warn
``CollectiveDegradedWarning`` with the reference's site and detail.
Gradients: each helper's dx and dw at 4 ranks against ``jax.grad`` of the
reference's helper on the same inputs and output gradient, at every chunk
count, within the same bounds; the backward's ``Issued`` rows (the
forward's chunk count, its products and collectives); the sequence slice
and the row gather against their transposes; and at one rank each helper
keeps its graph.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 4
CHUNKS = (1, 2, 4, 3)              # 3 divides none of the shards: degrades
AG_BOUND, RS_BOUND, A2A_BOUND = 1e-4, 1e-3, 1e-6
PSUM_BOUND = LOGITS_BOUND = 1e-4
ARCH, B, S, MAX_SEQ, DECODE = "llama3-8b", 4, 16, 32, 2
# layer 0 and layer 1 get different chunk counts; at decode (B·S = 4
# tokens over 4 ranks) serve.layer1.mlp.ag and serve.layer0.mlp.rs degrade
PLAN = {"tp.layer0.mlp.ag": ("ring", 2), "tp.layer1.mlp.ag": ("ring", 4),
        "serve.layer1.mlp.ag": ("ring", 2), "serve.layer0.mlp.rs": ("chunked", 2)}
HELPERS = ("ag", "rs", "a2a", "psum")

_PORT = r"""
import dataclasses, json, sys, warnings
import numpy as np, torch, torch.distributed as dist
rank, world, rdv, inp, sd, out = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.parallel import collectives as C

d = dict(np.load(inp))
plan = {k: C.CollectiveRuntime(*v) for k, v in json.loads(str(d.pop("plan")))}
mesh = make_mesh()
assert (mesh.size, mesh.rank) == (world, rank)
res, log = {}, {"warnings": {}, "issued": {}}

def shard(a, axis):
    k = a.shape[axis] // world
    return torch.from_numpy(np.take(a, range(rank * k, (rank + 1) * k), axis=axis).copy())

def run(name, fn):
    with warnings.catch_warnings(record=True) as ws, C.record_issued() as rows:
        warnings.simplefilter("always")
        y = fn()
    log["warnings"][name] = sorted({str(w.message) for w in ws
                                    if issubclass(w.category, C.CollectiveDegradedWarning)})
    log["issued"][name] = [dataclasses.astuple(r) for r in rows]
    return y

x, w, xf, wf = shard(d["x"], 1), shard(d["w"], 1), shard(d["xf"], 2), shard(d["wf"], 0)
xa = shard(d["xa"], 0)
tree = {"a": torch.from_numpy(d["pa"][rank]), "b": torch.tensor(float(d["pb"][rank])),
        "c": torch.from_numpy(d["pc"][rank])}
for nc in [int(c) for c in d["chunks"]]:
    res[f"ag{nc}"] = run(f"ag{nc}", lambda: C.ring_ag_matmul(x, w, mesh, num_chunks=nc))
    res[f"rs{nc}"] = run(f"rs{nc}", lambda: C.mm_reduce_scatter(xf, wf, mesh, num_chunks=nc))
    res[f"a2a{nc}"] = run(f"a2a{nc}", lambda: C.chunked_all_to_all(
        xa, mesh, split_axis=1, concat_axis=0, num_chunks=nc))
    t = run(f"psum{nc}", lambda: C.psum_tree_chunked(tree, mesh, num_chunks=nc))
    res[f"psum{nc}.a"], res[f"psum{nc}.b"], res[f"psum{nc}.c"] = t["a"], t["b"], t["c"]
    res[f"psum_tree{nc}.a"] = C.psum_tree(tree, mesh)["a"]

def grad(a):
    return a.clone().requires_grad_()

def grads_of(name, fn, ins, dy):
    C.reset_degraded_warnings()          # a degraded site warns again, as its forward did
    ins = [grad(a) for a in ins]
    gs = run(name, lambda: torch.autograd.grad(fn(*ins), ins, dy))
    for k, g in zip("xw", gs):
        res[f"{name}.{k}"] = g

dy_ag, dz_rs, dy_a2a = shard(d["dy_ag"], 2), shard(d["dz_rs"], 1), shard(d["dy_a2a"], 0)
for nc in [int(c) for c in d["chunks"]] + [None]:     # None: the site's default
    tag = "" if nc is None else nc
    grads_of(f"gag{tag}", lambda a, b: C.ring_ag_matmul(a, b, mesh, num_chunks=nc), (x, w), dy_ag)
    grads_of(f"grs{tag}", lambda a, b: C.mm_reduce_scatter(a, b, mesh, num_chunks=nc),
             (xf, wf), dz_rs)
    grads_of(f"ga2a{tag}", lambda a: C.chunked_all_to_all(
        a, mesh, split_axis=1, concat_axis=0, num_chunks=nc), (xa,), dy_a2a)
dyr = torch.from_numpy(d["dyr"])                          # the same on every rank
grads_of("ggather", lambda a: C.all_gather_rows(a, mesh), (x,), dyr)
grads_of("gslice", lambda a: C.shard_rows(a, mesh), (torch.from_numpy(d["x"]),), shard(d["dyr"], 1))

cfg = get_smoke_config("llama3-8b")
model = M.init_params(cfg, 0, device="cpu")
model.load_state_dict(torch.load(sd))
toks, nxt = torch.from_numpy(d["tokens"]).long(), torch.from_numpy(d["next"]).long()

def served(sited):
    kw = dict(mesh=mesh) if sited else {}
    caches = M.init_caches(cfg, toks.shape[0], int(d["max_seq"]), device="cpu")
    caches = M.forward_hidden(cfg, model, {"tokens": toks}, caches, **kw)[1]
    cur, out = toks[:, -1:], []
    for j in range(nxt.shape[1]):
        logits, caches = M.decode_step(cfg, model, cur, caches, **kw)
        out.append(logits[:, -1])
        cur = nxt[:, j:j + 1]
    return torch.stack(out, 1)

with torch.no_grad(), C.use_runtime_plan(plan):
    res["tp.sited"] = run("tp", lambda: M._unembed(
        cfg, model, M.forward_hidden(cfg, model, {"tokens": toks}, mesh=mesh)[0]))
    res["tp.unsited"] = M._unembed(cfg, model, M.forward_hidden(cfg, model, {"tokens": toks})[0])
    res["serve.sited"] = run("serve", lambda: served(True))
    res["serve.unsited"] = served(False)
np.savez(out + ".npz", **{k: v.numpy() for k, v in res.items()})
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
"""

_REFERENCE = r"""
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.parallel import collectives as C
from repro.parallel.collectives import shard_map

inp, out = sys.argv[1:3]
d = dict(np.load(inp))
plan = {k: C.CollectiveRuntime(*v) for k, v in json.loads(str(d.pop("plan")))}
mesh = make_mesh((4,), ("model",))
res, log = {}, {"warnings": {}}

def run(name, fn):
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        y = fn()
    log["warnings"][name] = sorted({str(w.message) for w in ws
                                    if issubclass(w.category, C.CollectiveDegradedWarning)})
    return np.asarray(y)

M_ = "model"
for nc in [int(c) for c in d["chunks"]]:
    res[f"ag{nc}"] = run(f"ag{nc}", lambda: C.ring_ag_matmul(
        d["x"], d["w"], mesh, axis=M_, x_spec=P(None, M_, None), w_spec=P(None, M_),
        out_spec=P(None, None, M_), num_chunks=nc))
    res[f"rs{nc}"] = run(f"rs{nc}", lambda: C.mm_reduce_scatter(
        d["xf"], d["wf"], mesh, axis=M_, x_spec=P(None, None, M_), w_spec=P(M_, None),
        out_spec=P(None, M_, None), num_chunks=nc))
    res[f"a2a{nc}"] = run(f"a2a{nc}", lambda: C.chunked_all_to_all(
        d["xa"], mesh, axis=M_, split_axis=1, concat_axis=0, x_spec=P(M_, None, None),
        out_spec=P(M_, None, None), num_chunks=nc))

    def body(t, nc=nc):
        t = dict(t, b=t["b"][0])                      # each rank's scalar
        s = C.psum_tree_chunked(t, M_, num_chunks=nc)
        return dict(s, b=s["b"][None])

    leaves = {"a": d["pa"].reshape(-1, d["pa"].shape[-1]), "b": d["pb"],
              "c": d["pc"].reshape(-1, d["pc"].shape[-1])}
    spec = {"a": P(M_), "b": P(M_), "c": P(M_)}
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        s = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec)(leaves)
    log["warnings"][f"psum{nc}"] = sorted({str(w.message) for w in ws
                                           if issubclass(w.category, C.CollectiveDegradedWarning)})
    res[f"psum{nc}.a"] = np.asarray(s["a"])[:d["pa"].shape[1]]
    res[f"psum{nc}.b"] = np.asarray(s["b"])[0]
    res[f"psum{nc}.c"] = np.asarray(s["c"])[:d["pc"].shape[1]]

cfg = get_smoke_config("llama3-8b")
p = jax.jit(lambda k: JM.init_params(cfg, k))(jax.random.PRNGKey(0))
toks, nxt = jnp.asarray(d["tokens"]), d["next"]
with C.use_runtime_plan(plan):                 # plans bind at trace time
    tp = jax.jit(lambda p, t: JM._unembed(cfg, p, JM.forward_hidden(
        cfg, p, {"tokens": t}, mesh=mesh)[0]))
    prefill = jax.jit(lambda p, t, c: JM.forward_hidden(cfg, p, {"tokens": t}, c,
                                                        mesh=mesh)[1])
    step = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c, mesh=mesh))
    res["tp.sited"] = run("tp", lambda: tp(p, toks))

    def served():
        caches = prefill(p, toks, JM.init_caches(cfg, toks.shape[0], int(d["max_seq"])))
        cur, outs = toks[:, -1:], []
        for j in range(nxt.shape[1]):
            logits, caches = step(p, cur, caches)
            outs.append(logits[:, -1])
            cur = jnp.asarray(nxt[:, j:j + 1])
        return jnp.stack(outs, 1)

    res["serve.sited"] = run("serve", served)

def grads(name, f, args, dy):
    gs = jax.grad(lambda *a: jnp.sum(f(*a) * dy), argnums=tuple(range(len(args))))(*args)
    for k, g in zip("xw", gs):
        res[f"{name}.{k}"] = np.asarray(g)

for nc in [int(c) for c in d["chunks"]]:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        grads(f"gag{nc}", lambda a, b: C.ring_ag_matmul(
            a, b, mesh, axis=M_, x_spec=P(None, M_, None), w_spec=P(None, M_),
            out_spec=P(None, None, M_), num_chunks=nc), (d["x"], d["w"]), d["dy_ag"])
        grads(f"grs{nc}", lambda a, b: C.mm_reduce_scatter(
            a, b, mesh, axis=M_, x_spec=P(None, None, M_), w_spec=P(M_, None),
            out_spec=P(None, M_, None), num_chunks=nc), (d["xf"], d["wf"]), d["dz_rs"])
        grads(f"ga2a{nc}", lambda a: C.chunked_all_to_all(
            a, mesh, axis=M_, split_axis=1, concat_axis=0, x_spec=P(M_, None, None),
            out_spec=P(M_, None, None), num_chunks=nc), (d["xa"],), d["dy_a2a"])
np.savez(out + ".npz", **res)
with open(out + ".json", "w") as f:
    json.dump(log, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the port on 4 gloo ranks and the reference on 4 host devices,
    concurrently, on the same inputs; returns (inputs, per-rank results,
    per-rank logs, reference results, reference log)."""
    tmp = tmp_path_factory.mktemp("collectives")
    rs = np.random.default_rng(0)
    cfg = get_smoke_config(ARCH)
    f32 = np.float32
    inputs = {
        "x": rs.standard_normal((2, 16, 32)).astype(f32),
        "w": rs.standard_normal((32, 64)).astype(f32),
        "xf": rs.standard_normal((2, 16, 64)).astype(f32),
        "wf": rs.standard_normal((64, 32)).astype(f32),
        "xa": rs.standard_normal((8, 4, 16)).astype(f32),
        "dy_ag": rs.standard_normal((2, 16, 64)).astype(f32),
        "dz_rs": rs.standard_normal((2, 16, 32)).astype(f32),
        "dy_a2a": rs.standard_normal((4 * 8, 1, 16)).astype(f32),
        "dyr": rs.standard_normal((2, 16, 32)).astype(f32),
        "pa": rs.standard_normal((N, 8, 3)).astype(f32),
        "pb": rs.standard_normal((N,)).astype(f32),
        "pc": rs.standard_normal((N, 8, 2)).astype(f32),
        "tokens": rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "next": rs.integers(0, cfg.vocab_size, (B, DECODE)).astype(np.int32),
        "chunks": np.asarray(CHUNKS), "max_seq": np.asarray(MAX_SEQ),
        "plan": np.asarray(json.dumps(sorted(PLAN.items()))),
    }
    np.savez(tmp / "inputs.npz", **inputs)
    jcfg = jget_smoke(ARCH)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
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
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]

    def load(name):
        with open(tmp / f"{name}.json") as f:
            return dict(np.load(tmp / f"{name}.npz")), json.load(f)

    ranks = [load(f"rank{r}") for r in range(N)]
    ref, ref_log = load("reference")
    return inputs, [r[0] for r in ranks], [r[1] for r in ranks], ref, ref_log


def _rank_slice(a, axis, r):
    k = a.shape[axis] // N
    return np.take(a, range(r * k, (r + 1) * k), axis=axis)


def _oracle(helper, inputs, r):
    """This rank's expected output from the global inputs, by the ``*_ref``
    oracles (the all-to-all's tiles taken by hand: it has none)."""
    t = torch.from_numpy
    if helper == "ag":
        return C.ag_matmul_ref(t(inputs["x"]), t(_rank_slice(inputs["w"], 1, r))).numpy(), AG_BOUND
    if helper == "rs":
        y = C.mm_rs_ref(t(inputs["xf"]), t(inputs["wf"])).numpy()
        return _rank_slice(y, 1, r), RS_BOUND
    if helper == "a2a":
        shards = [_rank_slice(inputs["xa"], 0, j) for j in range(N)]
        return np.concatenate([_rank_slice(s, 1, r) for s in shards], axis=0), A2A_BOUND
    return {k: inputs[f"p{k}"].sum(0) for k in "abc"}, PSUM_BOUND


def _reference_rank(helper, ref, nc, r):
    if helper == "ag":
        return _rank_slice(ref[f"ag{nc}"], 2, r)
    if helper == "rs":
        return _rank_slice(ref[f"rs{nc}"], 1, r)
    if helper == "a2a":
        return _rank_slice(ref[f"a2a{nc}"], 0, r)
    return {k: ref[f"psum{nc}.{k}"] for k in "abc"}


def _port_rank(helper, res, nc):
    if helper == "psum":
        return {k: res[f"psum{nc}.{k}"] for k in "abc"}
    return res[f"{helper}{nc}"]


def _err(a, b) -> float:
    if isinstance(a, dict):
        return max(_err(a[k], b[k]) for k in a)
    assert np.shape(a) == np.shape(b)
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("nc", CHUNKS)
@pytest.mark.parametrize("helper", HELPERS)
def test_helper_matches_ref_and_reference(runs, helper, nc):
    inputs, port, _, ref, _ = runs
    for r in range(N):
        want, bound = _oracle(helper, inputs, r)
        got = _port_rank(helper, port[r], nc)
        assert _err(got, want) < bound, (helper, nc, r, "oracle")
        assert _err(got, _reference_rank(helper, ref, nc, r)) < bound, (helper, nc, r)


@pytest.mark.parametrize("helper", HELPERS)
def test_degraded_counts_warn_as_the_reference(runs, helper):
    _, _, logs, _, ref_log = runs
    for nc in CHUNKS:
        want = ref_log["warnings"][f"{helper}{nc}"]
        assert bool(want) == (nc == 3), (helper, nc, want)
        for log in logs:
            assert log["warnings"][f"{helper}{nc}"] == want, (helper, nc)


@pytest.mark.parametrize("nc", CHUNKS)
@pytest.mark.parametrize("helper", HELPERS)
def test_issued_structure(runs, helper, nc):
    """What each call issued: the chunks it used (1 when degraded), its
    matmuls and its collective calls, on every rank."""
    _, port, logs, _, _ = runs
    used = 1 if nc == 3 else nc
    want = {"ag": ("ring_ag_matmul", used, N * used, N - 1),
            "rs": ("mm_reduce_scatter", used, used, used),
            "a2a": ("all_to_all", used, 0, used)}
    for log in logs:
        rows = [tuple(r) for r in log["issued"][f"{helper}{nc}"]]
        if helper == "psum":
            # leaves a (8, 3) and c (8, 2) chunk; the scalar b reduces whole
            chunks = (used, 1, used)
            assert rows == [("acc", "psum", c, 0, c) for c in chunks], rows
        else:
            name, chunks, mm, coll = want[helper]
            assert rows == [(helper, name, chunks, mm, coll)], rows
    for res in port:
        assert _err(res[f"psum_tree{nc}.a"], res[f"psum{nc}.a"]) < PSUM_BOUND


@pytest.mark.parametrize("path", ["tp", "serve"])
def test_sited_trunk_matches_unsited_and_reference(runs, path):
    """The sited trunk at 4 ranks under a plan that chunks layers 0 and 1
    differently: logits equal the unsited port trunk's and the reference's
    sited trunk's (``tp``: a forward without a cache; ``serve``: a cached
    prefill and two decode steps)."""
    _, port, _, ref, _ = runs
    for res in port:
        sited = res[f"{path}.sited"]
        assert np.isfinite(sited).all()
        assert _err(sited, res[f"{path}.unsited"]) < LOGITS_BOUND
        assert _err(sited, ref[f"{path}.sited"]) < LOGITS_BOUND


@pytest.mark.parametrize("path", ["tp", "serve"])
def test_sited_trunk_degrades_as_the_reference(runs, path):
    _, _, logs, _, ref_log = runs
    want = ref_log["warnings"][path]
    assert bool(want) == (path == "serve")   # decode: 4 tokens over 4 ranks
    for log in logs:
        assert log["warnings"][path] == want


def test_plan_drives_two_layers_to_different_structure(runs):
    """One plan, two layers: ``tp.layer0.mlp.ag`` issues 2 chunks a step of
    its ring and ``tp.layer1.mlp.ag`` 4; the down projections stay whole."""
    _, _, logs, _, _ = runs
    for log in logs:
        rows = [dataclasses.astuple(C.Issued(*r)) for r in log["issued"]["tp"]]
        by_site = {}
        for site, op, chunks, *_ in rows:
            by_site.setdefault(site, set()).add((op, chunks))
        assert by_site == {
            "tp.layer0.mlp.ag": {("ring_ag_matmul", 2)},
            "tp.layer0.mlp.rs": {("mm_reduce_scatter", 1)},
            "tp.layer1.mlp.ag": {("ring_ag_matmul", 4)},
            "tp.layer1.mlp.rs": {("mm_reduce_scatter", 1)},
        }
        assert len(rows) == 6          # gate and up, then down, per layer


# each helper's backward: (name, inputs' sharded dims, the output gradient's)
GRAD_HELPERS = {"ag": ("ring_ag_matmul", (1, 1), AG_BOUND),
                "rs": ("mm_reduce_scatter", (2, 0), RS_BOUND),
                "a2a": ("all_to_all", (0,), A2A_BOUND)}


@pytest.mark.parametrize("nc", CHUNKS)
@pytest.mark.parametrize("helper", sorted(GRAD_HELPERS))
def test_helper_gradients_match_reference(runs, helper, nc):
    """dx and dw of every rank's shards against ``jax.grad`` of the
    reference's helper on the global inputs, with the same output gradient
    (a chunk count of 3 degrades in both, and warns once)."""
    _, port, logs, ref, _ = runs
    _, dims, bound = GRAD_HELPERS[helper]
    for r in range(N):
        for k, dim in zip("xw", dims):
            got = port[r][f"g{helper}{nc}.{k}"]
            assert _err(got, _rank_slice(ref[f"g{helper}{nc}.{k}"], dim, r)) < bound, (k, r)
        warned = logs[r]["warnings"][f"g{helper}{nc}"]
        assert bool(warned) == (nc == 3) and warned == logs[r]["warnings"][f"{helper}{nc}"]


@pytest.mark.parametrize("nc", CHUNKS)
@pytest.mark.parametrize("helper", sorted(GRAD_HELPERS))
def test_backward_issued_structure(runs, helper, nc):
    """What each backward issued, logged as ``<op>.bwd`` after its forward:
    the forward's chunk count; the ring's dx products with their chunked
    reduce-scatters and its dw ring (n·chunks products, n-1 hops); the
    reduce-scatter's all-gather of each chunk of dy and two products a
    chunk; the all-to-all's inverse, one call a chunk."""
    _, _, logs, _, _ = runs
    used = 1 if nc == 3 else nc
    op = GRAD_HELPERS[helper][0]
    want = {"ag": (used, used + N * used, used + N - 1), "rs": (used, 2 * used, used),
            "a2a": (used, 0, used)}[helper]
    for log in logs:
        rows = [tuple(r) for r in log["issued"][f"g{helper}{nc}"]]
        assert [row[1] for row in rows] == [op, op + ".bwd"], rows
        assert rows[1] == (helper, op + ".bwd") + want, rows


CALLS = ("ring_ag_matmul x", "ring_ag_matmul w", "mm_reduce_scatter x",
         "mm_reduce_scatter w", "all_gather_rows", "chunked_all_to_all")
CALL_KEYS = {"ring_ag_matmul x": "gag.x", "ring_ag_matmul w": "gag.w",
             "mm_reduce_scatter x": "grs.x", "mm_reduce_scatter w": "grs.w",
             "chunked_all_to_all": "ga2a.x"}


def _dense_grads(call, inputs, r):
    """This rank's expected gradient for ``call``, from autograd of the
    dense oracle on the global inputs with the global output gradient."""
    t = {k: torch.from_numpy(inputs[k]).double().requires_grad_()
         for k in ("x", "w", "xf", "wf")}
    if call.startswith("ring_ag_matmul"):
        gx, gw = torch.autograd.grad(C.ag_matmul_ref(t["x"], t["w"]), (t["x"], t["w"]),
                                     torch.from_numpy(inputs["dy_ag"]).double())
        return (_rank_slice(gx.numpy(), 1, r) if call.endswith("x")
                else _rank_slice(gw.numpy(), 1, r)), AG_BOUND
    if call.startswith("mm_reduce_scatter"):
        gx, gw = torch.autograd.grad(C.mm_rs_ref(t["xf"], t["wf"]), (t["xf"], t["wf"]),
                                     torch.from_numpy(inputs["dz_rs"]).double())
        return (_rank_slice(gx.numpy(), 2, r) if call.endswith("x")
                else _rank_slice(gw.numpy(), 0, r)), RS_BOUND
    # the all-to-all only moves tiles: its transpose moves them back
    shards = [_rank_slice(inputs["dy_a2a"], 0, j) for j in range(N)]
    return np.concatenate([_rank_slice(s, 0, r) for s in shards], axis=1), A2A_BOUND


@pytest.mark.parametrize("call", CALLS)
def test_helpers_refuse_gradients_beyond_one_rank(runs, call):
    """At 4 ranks under grad no helper refuses any more: each call at its
    site's default structure, with an input (or weight) that needs a
    gradient, returns this rank's part of the dense oracle's gradient; the
    row gather's backward is this rank's slice of the output gradient, and
    the sequence slice's the gather of every rank's."""
    inputs, port, _, _, _ = runs
    for r in range(N):
        if call == "all_gather_rows":
            assert _err(port[r]["ggather.x"], _rank_slice(inputs["dyr"], 1, r)) == 0
            assert _err(port[r]["gslice.x"], inputs["dyr"]) == 0
            continue
        got = port[r][CALL_KEYS[call]]
        want, bound = _dense_grads(call, inputs, r)
        assert _err(got, want) < bound, (call, r)


@pytest.mark.parametrize("helper", ["ring_ag_matmul", "mm_reduce_scatter",
                                    "all_gather_rows", "chunked_all_to_all"])
def test_helpers_keep_their_graph_at_one_rank(helper):
    """At mesh size 1 under grad nothing is refused: each helper returns
    its local result with its autograd graph, and the gradients equal the
    oracle's."""
    rs = np.random.default_rng(5)
    arrays = [rs.standard_normal(s).astype(np.float32)
              for s in ((2, 8, 16), (16, 12), (2, 8, 12), (12, 16), (4, 2, 6))]
    leaves = x, w, xf, wf, xa = [torch.from_numpy(a).requires_grad_() for a in arrays]
    mesh = Mesh(None)
    got, want = {
        "ring_ag_matmul": lambda: (C.ring_ag_matmul(x, w, mesh, num_chunks=2),
                                   C.ag_matmul_ref(x, w)),
        "mm_reduce_scatter": lambda: (C.mm_reduce_scatter(xf, wf, mesh, num_chunks=2),
                                      C.mm_rs_ref(xf, wf)),
        "all_gather_rows": lambda: (C.all_gather_rows(x * 2, mesh), x * 2),
        "chunked_all_to_all": lambda: (C.chunked_all_to_all(
            xa, mesh, split_axis=1, concat_axis=0, num_chunks=2), xa),
    }[helper]()
    assert got.requires_grad and got.shape == want.shape
    assert _err(got.detach().numpy(), want.detach().numpy()) < 1e-5
    dy = torch.from_numpy(rs.standard_normal(tuple(got.shape)).astype(np.float32))
    g_got = torch.autograd.grad(got, leaves, dy, allow_unused=True)
    g_want = torch.autograd.grad(want, leaves, dy, allow_unused=True)
    for a, b in zip(g_got, g_want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _err(a.numpy(), b.numpy()) < 1e-5
