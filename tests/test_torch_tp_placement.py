"""The reference's tensor-parallel placement at 4 ranks: attention heads,
the shared experts and the vocabulary split over ``model`` (1x4), against
the reference's sited step on 4 host devices, in fp32 with the reference's
weights (converted through numpy) and the same batch.

Four ``gloo`` ranks (one process each, ``file://`` rendezvous) place each
model (``models.model.shard_`` on ``make_mesh((1, 4), ("data",
"model"))``) and run one forward and backward and one plain train step
through the sited trunk: smoke ``mpt-7b`` (4/4 heads split by head, ALiBi's
slopes sliced, a tied vocab-parallel head, the GELU MLP), smoke
``llama3-8b`` with 8 query and 4 KV heads of 32 (a GQA group of 2, split by
head) and smoke ``qwen2-moe-a2.7b`` (attention biases, the gated shared
experts over ``model``).  A fifth process runs the reference's sited
``jax.value_and_grad`` and train step with ``sited_mesh`` a mesh of 4 host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

The same ranks hold the pieces against one process's plain versions:
``collectives.copy_to`` and ``reduce_from`` around a column-then-row
product, the vocab-parallel embedding and cross-entropy, forward and
backward, with their ``Issued`` rows at m = 4 and none at m = 1; and smoke
``llama3-8b`` with 6 query and 2 KV heads of 32, which 4 does not divide:
attention stays whole (warned once), and the loss and gradients equal the
unplaced model's on one process.

Bounds are ``tests/test_torch_tp_train.py``'s: the loss 1e-5 absolute,
gradients 1e-4 of each leaf's max|g| (the slices gathered), one step 1e-5
(parameters and AdamW's moments absolute; loss and grad_norm relative)
with eps = 1e-3; the unit cases 1e-5 absolute.  After the step the leaves
that stay whole (the norms, ``o``'s and ``down``'s biases, the router, the
shared gate) are bit-equal on every rank.
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

ROOT = Path(__file__).resolve().parents[1]
N = 4
B, S = 4, 32
LOSS_BOUND, GRAD_BOUND, STEP_ATOL, STEP_RTOL, UNIT_ATOL = 1e-5, 1e-4, 1e-5, 1e-5, 1e-5
STEP_OPT = dict(lr=1e-2, eps=1e-3)
# name -> (smoke config, fields replaced); every one splits by heads at m = 4
CASES = {"mpt-7b": ("mpt-7b", {}),
         "llama3-8b-8x4": ("llama3-8b", dict(num_heads=8, num_kv_heads=4, head_dim=32)),
         "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {})}
WHOLE = ("llama3-8b", dict(num_heads=6, num_kv_heads=2, head_dim=32))

_COMMON = r"""
import dataclasses, hashlib, json, sys, warnings
import numpy as np
d = dict(np.load(sys.argv[-2]))
CASES = json.loads(str(d["cases"]))
WHOLE = json.loads(str(d["whole"]))
opt = json.loads(str(d["opt"]))
"""

_PORT = _COMMON + r"""
import torch, torch.distributed as dist
rank, world, rdv, sd = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
out = sys.argv[-1]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
import torch.nn.functional as F
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C
from repro_torch.train import trainer as T

batch = {n: torch.from_numpy(d[n]) for n in ("tokens", "targets", "mask")}
mesh = make_mesh((1, 4), ("data", "model"))
m4 = mesh["model"]
res, log = {}, {"issued": {}, "shapes": {}, "digests": {}}

def config(arch, over):
    return dataclasses.replace(get_smoke_config(arch), **over)

def sha(t):
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()

for name, (arch, over) in CASES.items():
    cfg = config(arch, over)
    full = torch.load(f"{sd}/{name}.pt")

    def fresh():
        model = M.init_params(cfg, 0, device="cpu")
        model.load_state_dict(full)
        return M.shard_(cfg, model, mesh)

    model = fresh()
    place = model.placement
    log["shapes"][name] = {n: list(p.shape) for n, p in model.named_parameters()}
    with C.record_issued() as rows:
        loss, _ = M.loss_and_metrics(cfg, model, batch, mesh=m4)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    log["issued"][name] = [dataclasses.astuple(r) for r in rows]
    res[f"{name}.grads.loss"] = loss.detach()
    for n, g in zip(names, grads):
        res[f"{name}.grads.{n}"] = place.full(n, g)
    model = fresh()
    state = adamw.init_state(dict(model.named_parameters()))
    tcfg = T.TrainConfig(opt=adamw.AdamWConfig(**opt), warmup=2, total_steps=10, sited_mesh=m4)
    model, state, m = T.make_train_step(cfg, tcfg)(model, state, batch, 1)
    for n, p in model.named_parameters():
        res[f"{name}.step.{n}"] = place.full(n, p.detach())
        for k in ("mu", "nu"):
            res[f"{name}.step.{k}.{n}"] = place.full(n, state[k][n])
    for k in ("loss", "grad_norm"):
        res[f"{name}.step.{k}"] = m[k]
    log["digests"][name] = {n: sha(p) for n, p in model.named_parameters()}

# 4 divides neither 6 query nor 2 KV heads: attention stays whole, warned once
cfg = config(*WHOLE)
placed = []
with warnings.catch_warnings(record=True) as ws:
    warnings.simplefilter("always")
    for _ in range(2):
        placed.append(M.shard_(cfg, M.init_params(cfg, 0, device="cpu"), mesh))
log["whole_warned"] = [str(w.message) for w in ws if issubclass(w.category, RuntimeWarning)]
model = placed[0]
log["shapes"]["whole"] = {n: list(p.shape) for n, p in model.named_parameters()}
plain = M.init_params(cfg, 0, device="cpu")
for which, mdl, kw in (("placed", model, dict(mesh=m4)), ("plain", plain, {})):
    with C.record_issued() as rows:
        loss, _ = M.loss_and_metrics(cfg, mdl, batch, **kw)
        names, params = zip(*mdl.named_parameters())
        grads = torch.autograd.grad(loss, params)
    res[f"whole.{which}.loss"] = loss.detach()
    for n, g in zip(names, grads):
        res[f"whole.{which}.{n}"] = g if mdl.placement is None else mdl.placement.full(n, g)
    log["issued"][f"whole.{which}"] = [dataclasses.astuple(r) for r in rows]

# the pieces, against one process's plain versions
g = torch.Generator().manual_seed(7)
x = torch.randn(2, 8, 16, generator=g)
W, V = torch.randn(16, 12, generator=g), torch.randn(12, 16, generator=g)
table = torch.randn(24, 16, generator=g)
tok = torch.randint(0, 24, (2, 8), generator=g)
mask = (torch.rand(2, 8, generator=g) > 0.25).float()
dy = torch.randn(2, 8, 16, generator=g)

def unit(mm):
    f, v = 12 // mm.size, 24 // mm.size
    cols, vrows = slice(mm.rank * f, (mm.rank + 1) * f), slice(mm.rank * v, (mm.rank + 1) * v)
    xa, Wa, Va = x.clone().requires_grad_(), W[:, cols].clone().requires_grad_(), \
        V[cols].clone().requires_grad_()
    y = C.reduce_from((C.copy_to(xa, mm, site="u.ar.bwd") @ Wa) @ Va, mm, site="u.ar")
    gx, gW, gV = torch.autograd.grad(y, (xa, Wa, Va), dy)
    ta = table[vrows].clone().requires_grad_()
    mine = (tok >= vrows.start) & (tok < vrows.stop)
    e = C.reduce_from(F.embedding(torch.where(mine, tok - vrows.start, 0), ta)
                      * mine[..., None].float(), mm, site="u.embed.ar")
    ge, = torch.autograd.grad(e, (ta,), dy)
    xc, tc = x.clone().requires_grad_(), table[vrows].clone().requires_grad_()
    ce = C.vocab_parallel_ce(C.copy_to(xc, mm, site="u.ce.ar.bwd") @ tc.T, tok, mask, mm,
                             site="u.ce.ar")
    gxc, gtc = torch.autograd.grad(ce, (xc, tc))
    return {"y": y, "gx": gx, "gW": gW, "gV": gV, "e": e, "ge": ge, "ce": ce, "gxc": gxc,
            "gtc": gtc}

for tag, mm in (("m4", m4), ("m1", Mesh(None))):
    with C.record_issued() as rows:
        got = unit(mm)
    for k, v in got.items():
        res[f"unit.{tag}.{k}"] = v.detach()
    log["issued"][f"unit.{tag}"] = [dataclasses.astuple(r) for r in rows]
# a placed model on a model axis of 1 (smoke llama3-8b at 4x1): no tp.* rows
fsdp = make_mesh((4, 1), ("data", "model"))
cfg = get_smoke_config("llama3-8b")
model = M.shard_(cfg, M.init_params(cfg, 0, device="cpu"), fsdp)
k = batch["tokens"].shape[0] // 4
rows_of = {n: a[rank * k:(rank + 1) * k] for n, a in batch.items()}
with C.record_issued() as rows:
    loss, _ = M.loss_and_metrics(cfg, model, rows_of, mesh=fsdp["model"])
    torch.autograd.grad(loss, list(model.parameters()))
log["issued"]["m1.model"] = [dataclasses.astuple(r) for r in rows]

np.savez(out + ".npz", **{k: v.numpy() for k, v in res.items()})
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
"""

_REFERENCE = _COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.train import trainer as JT

out = sys.argv[-1]
batch = {n: jnp.asarray(d[n]) for n in ("tokens", "targets", "mask")}
mesh4 = make_mesh((4,), ("model",))
res = {}

def put(tag, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{tag}." + "/".join(x.key for x in k)] = np.asarray(v)

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    for name, (arch, over) in CASES.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        p = jax.jit(lambda k: JM.init_params(cfg, k))(jax.random.PRNGKey(0))
        loss, g = jax.jit(jax.value_and_grad(lambda q, b: JM.loss_and_metrics(
            cfg, q, b, remat=True, mesh=mesh4)[0]))(p, batch)
        res[f"{name}.grads.loss"] = np.asarray(loss)
        put(f"{name}.grads", g)
        step = jax.jit(JT.make_train_step(cfg, JT.TrainConfig(
            opt=JA.AdamWConfig(**opt), warmup=2, total_steps=10, sited_mesh=mesh4)))
        p2, s2, m = step(p, JA.init_state(p), batch, jnp.asarray(1))
        put(f"{name}.step", p2)
        put(f"{name}.step.mu", s2["mu"])
        put(f"{name}.step.nu", s2["nu"])
        for k in ("loss", "grad_norm"):
            res[f"{name}.step.{k}"] = np.asarray(m[k])
np.savez(out + ".npz", **res)
"""


def _cfg(arch, over):
    import dataclasses

    return dataclasses.replace(get_smoke_config(arch), **over)


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
    concurrently; returns (per-rank (results, log), reference)."""
    import dataclasses

    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM

    tmp = tmp_path_factory.mktemp("tp_placement")
    b = SyntheticCorpus(DataConfig(vocab_size=512, seq_len=S, global_batch=B,
                                   seed=13)).batch(0)
    np.savez(tmp / "inputs.npz", **b, cases=np.asarray(json.dumps(CASES)),
             whole=np.asarray(json.dumps(WHOLE)), opt=np.asarray(json.dumps(STEP_OPT)))
    (tmp / "params").mkdir()
    for name, (arch, over) in CASES.items():
        jcfg = dataclasses.replace(jget_smoke(arch), **over)
        jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
        torch.save(params_from_jax(_cfg(arch, over), jax.tree.map(np.asarray, jp)),
                   tmp / "params" / f"{name}.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT, str(r), str(N), str(tmp / "rdv"), str(tmp / "params"),
         str(tmp / "inputs.npz"), str(tmp / f"rank{r}")],
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
    return ranks, dict(np.load(tmp / "reference.npz"))


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float64)).max())


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_reference(runs, name):
    """The loss and every gradient of the placed model at 1x4 (each rank's
    slices gathered) against the reference's sited ``jax.value_and_grad``
    with remat."""
    ranks, ref = runs
    cfg = _cfg(*CASES[name])
    want = params_from_jax(cfg, _tree(ref, f"{name}.grads"))
    for got, _ in ranks:
        assert abs(float(got[f"{name}.grads.loss"]) - float(ref[f"{name}.grads.loss"])) \
            < LOSS_BOUND
        for k, w in want.items():
            g = got[f"{name}.grads.{k}"]
            assert g.shape == tuple(w.shape), k
            assert _diff(g, w) <= GRAD_BOUND * _max(w), (name, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference(runs, name):
    """One plain step at 1x4 from the reference's weights against the
    reference's sited step: parameters and AdamW's moments within 1e-5,
    loss and grad_norm within 1e-5 relative."""
    ranks, ref = runs
    cfg = _cfg(*CASES[name])
    tag = f"{name}.step"
    for got, _ in ranks:
        for k, w in params_from_jax(cfg, _tree(ref, tag)).items():
            assert _diff(got[f"{tag}.{k}"], w) <= STEP_ATOL, (tag, k)
        for m in ("mu", "nu"):
            for k, w in params_from_jax(cfg, _tree(ref, f"{tag}.{m}")).items():
                assert _diff(got[f"{tag}.{m}.{k}"], w) <= STEP_ATOL, (tag, m, k)
        for k in ("loss", "grad_norm"):
            w = float(ref[f"{tag}.{k}"])
            assert abs(float(got[f"{tag}.{k}"]) - w) <= STEP_RTOL * abs(w), (tag, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_a_quarter_and_whole_leaves_stay_equal(runs, name):
    """Each rank holds a quarter of the query, key and value heads, of
    ``o``'s rows, of the vocabulary (the embedding; the head where it is
    untied) and of the shared experts' hidden units; after the step those
    slices differ between the ranks, and the leaves that stay whole (the
    norms, ``o``'s bias, the router, the shared gate) are bit-equal on all
    four."""
    ranks, _ = runs
    cfg = _cfg(*CASES[name])
    layer = "trunk.moe_layers.0." if cfg.is_moe else "trunk.dense_layers.0."
    D, h = cfg.d_model, cfg.head_dim
    want = {layer + "attn.q.weight": [cfg.num_heads // N * h, D],
            layer + "attn.k.weight": [cfg.num_kv_heads // N * h, D],
            layer + "attn.v.weight": [cfg.num_kv_heads // N * h, D],
            layer + "attn.o.weight": [D, cfg.num_heads // N * h],
            "embed.weight": [cfg.vocab_size // N, D]}
    if not cfg.tie_embeddings:
        want["head.weight"] = [cfg.vocab_size // N, D]
    if cfg.attn_bias:
        want[layer + "attn.q.bias"] = [cfg.num_heads // N * h]
        want[layer + "attn.o.bias"] = [D]
    if cfg.num_shared_experts:
        sf = cfg.shared_d_ff or cfg.moe_d_ff * cfg.num_shared_experts
        want[layer + "moe.shared.up.weight"] = [sf // N, D]
        want[layer + "moe.shared.down.weight"] = [D, sf // N]
        want[layer + "moe.shared_gate.weight"] = [1, D]
    digests = [log["digests"][name] for _, log in ranks]
    for _, log in ranks:
        shapes = log["shapes"][name]
        for k, s in want.items():
            assert shapes[k] == s, (k, shapes[k], s)
    whole = ["ln_f.scale", layer + "ln1.scale"]
    whole += [layer + "attn.o.bias"] if cfg.attn_bias else []
    whole += [layer + "moe.router.weight"] if cfg.is_moe else []
    whole += [layer + "moe.shared_gate.weight"] if cfg.shared_expert_gate else []
    for k in whole:
        assert len({d[k] for d in digests}) == 1, k
    for k in (layer + "attn.q.weight", "embed.weight"):
        assert len({d[k] for d in digests}) == N, k


def _rows(rows):
    out = {}
    for site, op, chunks, matmuls, colls in rows:
        out.setdefault(site, {}).setdefault(op, []).append(colls)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_placement_issues_its_all_reduces(runs, name):
    """One forward and backward with remat: each layer's attention sums its
    rows at ``tp.layer{i}.attn.ar`` in the forward and in remat's
    recompute, and its input's gradient at ``.ar.bwd`` once; a MoE layer's
    shared experts likewise at ``ep.layer{j}.moe.shared.ar``; the
    embedding's rows once at ``tp.embed.ar``; the cross-entropy's sums (two
    all-reduces) at ``tp.ce.ar`` in the forward and the recompute of its one
    chunk, its input's gradient at ``tp.ce.ar.bwd`` once."""
    ranks, _ = runs
    cfg = _cfg(*CASES[name])
    want = {"tp.embed.ar": {"all_reduce": [1]}, "tp.ce.ar": {"vocab_ce": [2, 2]},
            "tp.ce.ar.bwd": {"all_reduce.bwd": [1]}}
    for i in range(cfg.num_layers):
        want[f"tp.layer{i}.attn.ar"] = {"all_reduce": [1, 1]}
        want[f"tp.layer{i}.attn.ar.bwd"] = {"all_reduce.bwd": [1]}
        if cfg.num_shared_experts:
            want[f"ep.layer{i}.moe.shared.ar"] = {"all_reduce": [1, 1]}
            want[f"ep.layer{i}.moe.shared.ar.bwd"] = {"all_reduce.bwd": [1]}
    for _, log in ranks:
        got = {s: ops for s, ops in _rows(log["issued"][name]).items()
               if ".ar" in s or s.startswith("tp.embed")}
        assert got == want


def test_whole_attention_warns_once_and_matches_the_unplaced_model(runs):
    """6 query and 2 KV heads over 4 model ranks: placing warns once (a
    second placement in the process is silent) and keeps q, k, v and o
    whole on every rank, issuing no attention all-reduce; the vocabulary and
    the MLP still split.  The loss and every gradient (gathered) equal the
    unplaced model's on one process within the bounds above."""
    ranks, _ = runs
    cfg = _cfg(*WHOLE)
    for got, log in ranks:
        warned = log["whole_warned"]
        assert len(warned) == 1, warned
        assert "6 query heads over 2 KV heads do not split" in warned[0], warned
        shapes = log["shapes"]["whole"]
        assert shapes["trunk.dense_layers.0.attn.q.weight"] == [cfg.q_dim, cfg.d_model]
        assert shapes["trunk.dense_layers.0.attn.k.weight"] == [cfg.kv_dim, cfg.d_model]
        assert shapes["embed.weight"] == [cfg.vocab_size // N, cfg.d_model]
        sites = set(_rows(log["issued"]["whole.placed"]))
        assert not any(".attn." in s for s in sites) and "tp.embed.ar" in sites
        assert not log["issued"]["whole.plain"]
        assert abs(float(got["whole.placed.loss"]) - float(got["whole.plain.loss"])) \
            < LOSS_BOUND
        names = [k[len("whole.plain."):] for k in got
                 if k.startswith("whole.plain.") and k != "whole.plain.loss"]
        assert names
        for n in names:
            w = got[f"whole.plain.{n}"]
            assert _diff(got[f"whole.placed.{n}"], w) <= GRAD_BOUND * _max(w), n


def _plain_units():
    """The unit cases' plain versions on one process (the same draws)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 8, 16, generator=g)
    W, V = torch.randn(16, 12, generator=g), torch.randn(12, 16, generator=g)
    table = torch.randn(24, 16, generator=g)
    tok = torch.randint(0, 24, (2, 8), generator=g)
    mask = (torch.rand(2, 8, generator=g) > 0.25).float()
    dy = torch.randn(2, 8, 16, generator=g)
    xa, Wa, Va, ta = (t.clone().requires_grad_() for t in (x, W, V, table))
    y = xa @ Wa @ Va
    gx, gW, gV = torch.autograd.grad(y, (xa, Wa, Va), dy)
    e = F.embedding(tok, ta)
    ge, = torch.autograd.grad(e, (ta,), dy)
    xc, tc = x.clone().requires_grad_(), table.clone().requires_grad_()
    logits = xc @ tc.T
    ce = ((torch.logsumexp(logits, -1) - logits.gather(-1, tok[..., None])[..., 0])
          * mask).sum()
    gxc, gtc = torch.autograd.grad(ce, (xc, tc))
    return {"y": y, "gx": gx, "gW": gW, "gV": gV, "e": e, "ge": ge, "ce": ce, "gxc": gxc,
            "gtc": gtc}


@pytest.mark.parametrize("mesh", ["m4", "m1"])
def test_conjugate_pair_and_vocab_pieces_match_plain(runs, mesh):
    """On 4 ranks (and on a mesh of 1): ``copy_to`` then this rank's columns
    of W and rows of V, then ``reduce_from``, equals x·W·V with x's whole
    gradient on every rank and each rank's slices of W's and V's; the
    vocab-parallel embedding (ids in the rank's range, the rest zeroed,
    summed) equals ``F.embedding`` and its rows' gradient the slice of the
    whole one; the vocab-parallel cross-entropy's masked sum, x's gradient
    and the table slice's gradient equal the plain ones.  Within 1e-5."""
    ranks, _ = runs
    want = {k: v.detach().numpy() for k, v in _plain_units().items()}
    for r, (got, _) in enumerate(ranks):
        m = N if mesh == "m4" else 1
        q = r if mesh == "m4" else 0
        cols, vrows = slice(q * 12 // m, (q + 1) * 12 // m), slice(q * 24 // m, (q + 1) * 24 // m)
        sliced = dict(want, gW=want["gW"][:, cols], gV=want["gV"][cols],
                      ge=want["ge"][vrows], gtc=want["gtc"][vrows])
        for k, w in sliced.items():
            a = got[f"unit.{mesh}.{k}"]
            assert a.shape == w.shape and _diff(a, w) <= UNIT_ATOL * max(1.0, _max(w)), (k, r)


def test_issued_rows_at_four_ranks_and_none_at_one(runs):
    """At 4 ranks each piece logs one row where it issues its all-reduce:
    ``copy_to``'s backward, ``reduce_from``'s forward, the cross-entropy's
    two sums; on a mesh of 1 and on a model placed at 4x1 (a model axis of
    1) nothing is issued or logged at any ``tp`` all-reduce site."""
    ranks, _ = runs
    for _, log in ranks:
        assert _rows(log["issued"]["unit.m4"]) == {
            "u.ar.bwd": {"all_reduce.bwd": [1]}, "u.ar": {"all_reduce": [1]},
            "u.embed.ar": {"all_reduce": [1]}, "u.ce.ar": {"vocab_ce": [2]},
            "u.ce.ar.bwd": {"all_reduce.bwd": [1]}}
        assert log["issued"]["unit.m1"] == []
        sites = set(_rows(log["issued"]["m1.model"]))
        assert "fsdp.embed.ag_params" in sites
        assert not any(s.startswith(("tp.embed", "tp.ce")) or ".attn." in s for s in sites)
