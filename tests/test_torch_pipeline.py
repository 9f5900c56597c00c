"""The port's pipeline (``repro_torch.parallel.pipeline``) on 4 gloo ranks
against the reference's ``pipeline_apply`` on 4 host devices.

One fixture starts four ``gloo`` ranks (one process each, ``file://``
rendezvous, a stage each on ``make_mesh((4,), ("stage",))``) and, beside
them, one reference process with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on
``make_test_mesh((4,), ("stage",))``; both take the same inputs, made
from seeds with numpy.  Cases:

* the toy stages of ``tests/test_pipeline.py`` with tanh and non-zero
  biases, M = 2, 4 and 8, under a ``p2p`` plan of 1, 2, 3 and 4 chunks (3
  does not divide D = 16: the transfer goes whole, with one warning
  naming the site): the forward within 1e-5 absolute (the reference's own
  bound, ``tests/test_pipeline.py``), the gradients of the parameters and
  of x within 1e-4 of max|g| of ``jax.grad``; x's gradient bit-equal on
  every rank, each rank's parameter gradient its own stage's row only,
  none S times the reference's; each rank's ``Issued`` rows as the
  module's docstring gives them;
* the dense stages (``models.model.pipeline_loss``) at 4 layers, one a
  stage, of smoke ``llama3-8b`` and of smoke ``yi-34b`` with a GQA group
  of 7 (7 query heads over 1 KV head, head_dim 32, d_model 224), B 4 x S
  16, M = 2 and 4, the reference's weights converted through numpy: the
  loss within 1e-5 of the reference's (its embedding, ``layer_fwd`` of
  each of the stage's layers under ``jax.checkpoint`` in
  ``pipeline_apply``, its final norm and ``chunked_ce``), every gradient
  within 1e-4 of max|g| of ``jax.grad`` (``tests/test_torch_train.py``'s
  bounds).

The whole file takes about 40 s on a shared CPU host (the reference's
16 compiles set it).
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings
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
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply, transfer_ticks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 4                                   # stages, one a rank
D, ROWS = 16, 8                         # the toy stages' width and global batch
MICRO = (2, 4, 8)
CHUNKS = (1, 2, 3, 4)                   # 3 does not divide D
FWD_BOUND, GRAD_BOUND, LOSS_BOUND = 1e-5, 1e-4, 1e-5
# the dense models: (smoke config, fields replaced); ``yi-34b-g7`` keeps
# yi-34b's GQA group of 7, which ``smoke()`` turns into 4 query heads over 1
ARCHS = {"llama3-8b": ("llama3-8b", dict(num_layers=4)),
         "yi-34b-g7": ("yi-34b", dict(num_layers=4, num_heads=7, num_kv_heads=1,
                                      head_dim=32, d_model=224))}
DENSE_MICRO = (2, 4)
B, S = 4, 16


def _cfg(arch):
    base, kw = ARCHS[arch]
    return dataclasses.replace(get_smoke_config(base), **kw)


_PORT = r"""
import dataclasses, json, sys, warnings
import numpy as np, torch, torch.distributed as dist
rank, world, rdv, inp, sd_dir, out = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.parallel import collectives as C
from repro_torch.parallel.pipeline import pipeline_apply

d = dict(np.load(inp))
MICRO, CHUNKS, DENSE_MICRO, ARCHS = json.loads(str(d["meta"]))
mesh = make_mesh((world,), ("stage",))["stage"]
res, log = {}, {}

def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])

for m_ in MICRO:
    for nc in CHUNKS:
        tag = f"toy.M{m_}.c{nc}"
        w, b, x = (torch.from_numpy(d[k]).requires_grad_() for k in ("w", "b", "x"))
        C.reset_degraded_warnings()
        with C.use_runtime_plan({"p2p": C.CollectiveRuntime("chunked", nc)}), \
                C.record_issued() as rows, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y = pipeline_apply(stage_fn, {"w": w, "b": b}, x, mesh=mesh, microbatches=m_)
            gw, gb, gx = torch.autograd.grad((y * torch.from_numpy(d["dy"])).sum(), (w, b, x))
        for k, v in (("y", y), ("w", gw), ("b", gb), ("x", gx)):
            res[f"{tag}.{k}"] = v.detach()
        log[tag] = {"rows": [[r.site, r.op, r.num_chunks, r.matmuls, r.collectives]
                             for r in rows],
                    "warnings": [str(c.message) for c in caught
                                 if issubclass(c.category, C.CollectiveDegradedWarning)]}

# this rank's own stage (a leading dim of 1), as shard_map hands it
w, b, x = (torch.from_numpy(d[k]) for k in ("w", "b", "x"))
own = {"w": w[rank:rank + 1].clone().requires_grad_(), "b": b[rank:rank + 1].clone().requires_grad_()}
x = x.clone().requires_grad_()
y = pipeline_apply(stage_fn, own, x, mesh=mesh, microbatches=4)
gw, gb, gx = torch.autograd.grad((y * torch.from_numpy(d["dy"])).sum(), (own["w"], own["b"], x))
res.update({"own.y": y.detach(), "own.w": gw, "own.b": gb, "own.x": gx})

for arch, (base, kw) in ARCHS.items():
    cfg = dataclasses.replace(get_smoke_config(base), **kw)
    batch = {k: torch.from_numpy(d[k]) for k in ("tokens", "targets", "mask")}
    for m_ in DENSE_MICRO:
        model = M.init_params(cfg, 0, device="cpu")
        model.load_state_dict(torch.load(f"{sd_dir}/{arch}.pt"))
        loss, _ = M.pipeline_loss(cfg, model, batch, mesh=mesh, microbatches=m_)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        res[f"{arch}.M{m_}.loss"] = loss.detach()
        held = []
        for n, g in zip(names, grads):
            if g is not None:
                res[f"{arch}.M{m_}.g.{n}"] = g
                held.append(n)
        log[f"{arch}.M{m_}.held"] = held
np.savez(out + ".npz", **{k: v.numpy() for k, v in res.items()})
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
"""

_REFERENCE = r"""
import dataclasses, json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
inp, out = sys.argv[1:3]
from repro.configs import get_smoke_config
from repro.launch.mesh import make_test_mesh
from repro.models import dense as JD, layers as JL, model as JM
from repro.parallel import collectives as JC
from repro.parallel.pipeline import pipeline_apply

d = dict(np.load(inp))
MICRO, CHUNKS, DENSE_MICRO, ARCHS = json.loads(str(d["meta"]))
mesh = make_test_mesh((4,), ("stage",))
res = {}

def stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])

params = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
x, dy = jnp.asarray(d["x"]), jnp.asarray(d["dy"])
warnings.simplefilter("ignore")
for m_ in MICRO:
    for nc in CHUNKS:
        def loss(p, v, m_=m_):
            y = pipeline_apply(stage_fn, p, v, mesh=mesh, microbatches=m_)
            return (y * dy).sum(), y
        with JC.use_runtime_plan({"p2p": JC.CollectiveRuntime("chunked", nc)}):
            (_, y), (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                         has_aux=True))(params, x)
        tag = f"toy.M{m_}.c{nc}"
        res.update({f"{tag}.y": y, f"{tag}.w": g["w"], f"{tag}.b": g["b"], f"{tag}.x": gx})

def put(tag, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{tag}." + "/".join(x.key for x in k)] = np.asarray(v)

batch = {k: jnp.asarray(d[k]) for k in ("tokens", "targets", "mask")}
B, S = batch["tokens"].shape
for arch, (base, kw) in ARCHS.items():
    cfg = dataclasses.replace(get_smoke_config(base), **kw)
    p = jax.jit(lambda key: JM.init_params(cfg, key))(jax.random.PRNGKey(0))
    np.savez(f"{out}.{arch}.params.npz", **{"/".join(x.key for x in k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(p)[0]})
    for m_ in DENSE_MICRO:
        def loss(p, m_=m_):
            h = JM._embed_inputs(cfg, p, batch)
            pos = JM._positions(cfg, batch, B // m_, S, 0)
            st = jax.tree.map(lambda a: a.reshape((4, a.shape[0] // 4) + a.shape[1:]),
                              p["trunk"]["dense_layers"])

            def fn(q, v):
                for j in range(jax.tree.leaves(q)[0].shape[0]):
                    lp = jax.tree.map(lambda a: a[j], q)
                    v = jax.checkpoint(lambda lp, v: JD.layer_fwd(
                        lp, cfg, v, pos, None, use_moe=False)[0])(lp, v)
                return v

            h = pipeline_apply(fn, st, h, mesh=mesh, microbatches=m_)
            h = JL.norm(p["ln_f"], h, cfg.norm_kind)
            return JM.chunked_ce(cfg, p, h, batch["targets"], batch["mask"])
        l, g = jax.jit(jax.value_and_grad(loss))(p)
        res[f"{arch}.M{m_}.loss"] = l
        put(f"{arch}.M{m_}.g", g)
np.savez(out + ".npz", **{k: np.asarray(v) for k, v in res.items()})
"""


def _tree(flat, prefix):
    """The nested tree of the leaves saved under ``prefix.`` (paths joined
    by "/")."""
    tree = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "."):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for x in parts[:-1]:
            node = node.setdefault(x, {})
        node[parts[-1]] = a
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on 4 gloo ranks and the reference on 4 host devices, the
    reference first (its weights go to the port through numpy), the ranks
    concurrently; returns (per-rank results, per-rank logs, reference)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    toy = {"w": (rng.standard_normal((N, D, D)) * 0.3).astype(np.float32),
           "b": (rng.standard_normal((N, D)) * 0.1).astype(np.float32),
           "x": rng.standard_normal((ROWS, D)).astype(np.float32),
           "dy": rng.standard_normal((ROWS, D)).astype(np.float32)}
    vocab = min(_cfg(a).vocab_size for a in ARCHS)
    batch = SyntheticCorpus(DataConfig(vocab_size=vocab, seq_len=S, global_batch=B,
                                       seed=3)).batch(0)
    meta = json.dumps([MICRO, CHUNKS, DENSE_MICRO, ARCHS])
    np.savez(tmp / "inputs.npz", **toy, **batch, meta=np.asarray(meta))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "inputs.npz"),
                          str(tmp / "reference")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-4000:]
    for arch in ARCHS:
        flat = dict(np.load(tmp / f"reference.{arch}.params.npz"))
        torch.save(params_from_jax(_cfg(arch), _tree({f"p.{k}": v for k, v in flat.items()},
                                                     "p")),
                   tmp / f"{arch}.pt")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT, str(r), str(N), str(tmp / "rdv"),
         str(tmp / "inputs.npz"), str(tmp), str(tmp / f"rank{r}")],
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(N)]
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
    return ranks, dict(np.load(tmp / "reference.npz"))


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float64)).max())


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("micro", MICRO)
@pytest.mark.parametrize("chunks", CHUNKS)
def test_toy_stages_match_reference(runs, micro, chunks):
    """The toy stages under a ``p2p`` plan of ``chunks``: every rank's output
    within 1e-5 of the reference's, the gradients of w, b and x within
    1e-4 of max|g| of ``jax.grad`` (a rank's w and b rows: its own stage's)."""
    ranks, ref = runs
    tag = f"toy.M{micro}.c{chunks}"
    for r, (got, _) in enumerate(ranks):
        assert _diff(got[f"{tag}.y"], ref[f"{tag}.y"]) < FWD_BOUND
        for k in ("w", "b"):
            want = ref[f"{tag}.{k}"][r]
            assert _diff(got[f"{tag}.{k}"][r], want) <= GRAD_BOUND * _max(ref[f"{tag}.{k}"])
        assert _diff(got[f"{tag}.x"], ref[f"{tag}.x"]) <= GRAD_BOUND * _max(ref[f"{tag}.x"])


@pytest.mark.parametrize("micro", MICRO)
@pytest.mark.parametrize("chunks", CHUNKS)
def test_backward_invariants(runs, micro, chunks):
    """The cotangent is taken once (no gradient is S times the reference's),
    x's gradient is stage 0's on every rank (bit-equal), and each rank's
    stacked-parameter gradient is zero but for its own stage's row."""
    ranks, ref = runs
    tag = f"toy.M{micro}.c{chunks}"
    gx = [got[f"{tag}.x"] for got, _ in ranks]
    assert all(np.array_equal(g, gx[0]) for g in gx)
    for r, (got, _) in enumerate(ranks):
        for k in ("w", "b"):
            g, want = got[f"{tag}.{k}"], ref[f"{tag}.{k}"]
            assert not np.any(np.delete(g, r, axis=0))
            assert _max(g[r]) < 1.5 * _max(want[r]) and _max(g[r]) > 0.5 * _max(want[r])
        assert _max(gx[r]) < 1.5 * _max(ref[f"{tag}.x"])


def test_own_stage_form_matches_stacked(runs):
    """``stage_params`` as this rank's own stage (a leading dim of 1) gives
    the stacked form's output and gradients (M = 4, unchunked)."""
    ranks, _ = runs
    for r, (got, _) in enumerate(ranks):
        assert np.array_equal(got["own.y"], got["toy.M4.c1.y"])
        assert np.array_equal(got["own.x"], got["toy.M4.c1.x"])
        for k in ("w", "b"):
            assert np.array_equal(got[f"own.{k}"][0], got[f"toy.M4.c1.{k}"][r])


@pytest.mark.parametrize("micro", MICRO)
@pytest.mark.parametrize("chunks", CHUNKS)
def test_issued_rows_as_the_docstring(runs, micro, chunks):
    """Rank s logs a ``ppermute`` row for each forward tick at which it sends
    or receives and a ``ppermute.bwd`` row for each backward one: M a pass
    on the first and last stage, M + 1 between; each at the chunk count
    used (3 does not divide D = 16: 1, with one warning naming the site)."""
    ranks, _ = runs
    used = 1 if D % chunks else chunks
    for r, (_, log) in enumerate(ranks):
        entry = log[f"toy.M{micro}.c{chunks}"]
        want = micro if r in (0, N - 1) else micro + 1
        assert len(transfer_ticks(N, micro, r)) == want
        rows = entry["rows"]
        assert [row[1] for row in rows] == ["ppermute"] * want + ["ppermute.bwd"] * want
        assert all(row[0] == "p2p" and row[2:] == [used, 0, used] for row in rows)
        if chunks == 3:
            assert len(entry["warnings"]) == 1 and "'p2p'" in entry["warnings"][0]
            assert "trailing activation dim (16)" in entry["warnings"][0]
        else:
            assert entry["warnings"] == []


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("micro", DENSE_MICRO)
def test_dense_stages_match_reference(runs, arch, micro):
    """``pipeline_loss`` at 4 layers, one a stage: every rank's loss within
    1e-5 of the reference's, every gradient it holds within 1e-4 of max|g|
    of ``jax.grad``: its stage's layers, and the embedding, final norm and
    head (the same on every rank); no other layer's."""
    ranks, ref = runs
    cfg = _cfg(arch)
    tag = f"{arch}.M{micro}"
    want = params_from_jax(cfg, _tree(ref, f"{tag}.g"))
    for r, (got, log) in enumerate(ranks):
        assert abs(float(got[f"{tag}.loss"]) - float(ref[f"{tag}.loss"])) < LOSS_BOUND
        held = set(log[f"{tag}.held"])
        assert held == {n for n in want if not n.startswith("trunk.")
                        or n.startswith(f"trunk.dense_layers.{r}.")}
        for n in held:
            assert _diff(got[f"{tag}.g.{n}"], want[n]) <= GRAD_BOUND * _max(want[n]), n


def test_size_one_warns_and_equals_unchunked():
    """The counterpart of ``tests/test_plan_sites.py``'s size-1 case: on a
    mesh of one stage with ``{"pp": ("chunked", 3)}`` a transfer of D = 5
    warns, naming ``pp.tick.p2p``, and the result equals the unchunked one;
    nothing is issued."""
    C.reset_degraded_warnings()
    params = {"w": torch.ones((1, 5, 5), requires_grad=True)}
    x = torch.ones((4, 5))
    mesh = Mesh(None, axis="stage")

    def fn(p, v):
        return v @ p["w"]

    with C.use_runtime_plan({"pp": C.CollectiveRuntime("chunked", 3)}), \
            C.record_issued() as rows:
        with pytest.warns(RuntimeWarning, match="pp.tick.p2p"):
            y = pipeline_apply(fn, params, x, mesh=mesh, axis="stage", microbatches=2,
                               site="pp.tick.p2p")
        (g,) = torch.autograd.grad(y.sum(), (params["w"],))
    assert torch.equal(y, x @ params["w"][0])
    assert torch.equal(g[0], torch.full((5, 5), 4.0))
    assert rows == []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y5 = pipeline_apply(fn, params, x, mesh=mesh, microbatches=2)
    assert torch.equal(y5, y)


def test_init_stage_holds_the_whole_models_layers():
    """Stage s of 4 of ``init_stage`` holds the layers that the one-stage
    model holds at s·L/4 ...; the embedding, final norm and head are the
    same in every stage."""
    cfg = _cfg("yi-34b-g7")
    whole = M.init_stage(cfg, 0, device="cpu").state_dict()
    for s in range(N):
        part = M.init_stage(cfg, 0, s, N, device="cpu").state_dict()
        for n, t in part.items():
            if n.startswith("trunk.dense_layers."):
                _, _, j, rest = n.split(".", 3)
                n = f"trunk.dense_layers.{s * cfg.num_layers // N + int(j)}.{rest}"
            assert torch.equal(t, whole[n]), n


def test_pipeline_refuses_what_it_does_not_run():
    """A MoE config raises naming its slice; a batch that does not split
    into M microbatches, and a model that is neither whole nor one stage,
    raise ``ValueError``."""
    with pytest.raises(NotImplementedError, match="MoE follow-ups"):
        M.init_stage(get_smoke_config("olmoe-1b-7b"), 0, device="cpu")
    cfg = _cfg("llama3-8b")
    model = M.init_stage(cfg, 0, device="cpu")
    toks = torch.zeros((3, 8), dtype=torch.long)
    batch = {"tokens": toks, "targets": toks}
    with pytest.raises(ValueError, match="microbatches"):
        M.pipeline_loss(cfg, model, batch, mesh=Mesh(None, axis="stage"), microbatches=2)
    with pytest.raises(ValueError, match="holds 4 layers"):
        M.pipeline_loss(cfg.replace(num_layers=8), model, batch,
                        mesh=Mesh(None, 3, 0, "stage"), microbatches=1)
