"""Expert parallelism of the port at 4 ranks against the reference's sited
step on 4 host devices, on smoke ``olmoe-1b-7b`` (2 MoE layers, 4 experts,
top-2, ``qk_norm``) in fp32 with the reference's weights (converted through
numpy) and the same batch.

Four ``gloo`` ranks (one process each, ``file://`` rendezvous) place the
model (``models.model.shard_`` on ``make_mesh((1, 4))`` and ``((2, 2))``,
data x model): each rank holds E/m experts, their d over ``data``; each
takes its rows of the global batch and trains one plain step through the
sited trunk under ``PLAN``, whose per-site chunk counts (1, 2 and 4) the
dispatch and combine all-to-alls at ``ep.layer{j}.moe.a2a_disp|comb``
must issue, forward (and remat's recompute) and backward.  The capacity
factor 0.75 makes every step drop tokens (the test asserts it), so the
routing must be the global batch's: at 2x2 each data rank offsets its
slots by the counts of the ranks before it and ``aux`` sums over ``data``.
A capacity that the model axis does not divide (``DEGRADED_CF``: cap 97
at 1x4) warns once naming the site and runs the degraded expert layout,
held against the reference's plain (unsited) step.  A fifth process runs
the reference: ``jax.jit`` of its train step with ``sited_mesh`` a mesh of
4 host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

Bounds are ``tests/test_torch_fsdp_train.py``'s one-step bounds: every
updated parameter within 1e-5 absolute (lr 1e-2, eps 1e-3), loss,
grad_norm and aux within 1e-5 relative.  After the step the leaves that
ranks hold alike must be bit-equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 4
ARCH = "olmoe-1b-7b"
B, S = 8, 32                 # T = 256, k = 2, E = 4: cap = int(512·cf/4)
CF = 0.75                    # cap 96: divides 4 and 2, drops tokens
DEGRADED_CF = 0.76           # cap 97: divides neither
STEP_ATOL, STEP_RTOL = 1e-5, 1e-5
STEP_OPT = dict(lr=1e-2, eps=1e-3)
PLAN = {"ep.layer0.moe.a2a_disp": ("chunked", 2), "ep.layer0.moe.a2a_comb": ("chunked", 4),
        "ep.layer1.moe.a2a_disp": ("chunked", 4)}          # layer 1's comb: 1 chunk
MESHES = ("1x4", "2x2")

_PORT = r"""
import dataclasses, hashlib, json, sys, warnings
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
base = get_smoke_config("olmoe-1b-7b")
plan = {k: C.CollectiveRuntime(*v) for k, v in json.loads(str(d["plan"])).items()}
opt = json.loads(str(d["opt"]))
full = torch.load(sd)
batch = {n: torch.from_numpy(d[n]) for n in ("tokens", "targets", "mask")}
B = batch["tokens"].shape[0]
meshes = {"1x4": make_mesh((1, 4), ("data", "model")),
          "2x2": make_mesh((2, 2), ("data", "model"))}
res, log = {}, {"issued": {}, "digests": {}, "shapes": {}, "warned": []}

def step(name, cf, record=False):
    mesh = meshes[name]
    cfg = base.replace(capacity_factor=cf)
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(full)
    M.shard_(cfg, model, mesh)
    log["shapes"][name] = {n: list(p.shape) for n, p in model.named_parameters()}
    dm = mesh["data"]
    k = B // dm.size
    rows = {n: a[dm.rank * k:(dm.rank + 1) * k] for n, a in batch.items()}
    tcfg = T.TrainConfig(opt=adamw.AdamWConfig(**opt), warmup=2, total_steps=10,
                         sited_mesh=mesh["model"], data_axis=dm if dm.size > 1 else None)
    state = adamw.init_state(dict(model.named_parameters()))
    with C.use_runtime_plan(plan), C.record_issued() as issued, \
            CT.use_axes(("data",), "model", sizes={a: m.size for a, m in mesh.items()}, batch=B):
        model, state, m = T.make_train_step(cfg, tcfg)(model, state, rows, 1)
    place = model.placement
    tag = f"{name}.cf{cf}"
    for n, p in model.named_parameters():
        res[f"{tag}.{n}"] = place.full(n, p.detach())
    for key in ("loss", "aux", "grad_norm"):
        res[f"{tag}.{key}"] = m[key]
    if record:
        log["issued"][name] = [dataclasses.astuple(r) for r in issued]
        log["digests"][name] = {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                                for n, p in model.named_parameters()}

for name in meshes:
    step(name, float(d["cf"]), record=True)
C.reset_degraded_warnings()
with warnings.catch_warnings(record=True) as ws:
    warnings.simplefilter("always")
    step("1x4", float(d["degraded_cf"]))
log["warned"] = [str(w.message) for w in ws if issubclass(w.category, C.CollectiveDegradedWarning)]
np.savez(out + ".npz", **{k: v.numpy() for k, v in res.items()})
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
"""

_REFERENCE = r"""
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import layers as JL, model as JM
from repro.optim import adamw as JA
from repro.parallel import collectives as C
from repro.train import trainer as JT

inp, out = sys.argv[1:3]
d = dict(np.load(inp))
base = get_smoke_config("olmoe-1b-7b")
plan = {k: C.CollectiveRuntime(*v) for k, v in json.loads(str(d["plan"])).items()}
opt = json.loads(str(d["opt"]))
batch = {n: jnp.asarray(d[n]) for n in ("tokens", "targets", "mask")}
p = jax.jit(lambda k: JM.init_params(base, k))(jax.random.PRNGKey(0))
res = {}

def put(tag, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{tag}." + "/".join(x.key for x in k)] = np.asarray(v)

def one(tag, cfg, mesh):
    step = jax.jit(JT.make_train_step(cfg, JT.TrainConfig(
        opt=JA.AdamWConfig(**opt), warmup=2, total_steps=10, sited_mesh=mesh)))
    p2, _, m = step(p, JA.init_state(p), batch, jnp.asarray(1))
    put(tag, p2)
    for key in ("loss", "aux", "grad_norm"):
        res[f"{tag}.{key}"] = np.asarray(m[key])

cf = float(d["cf"])
with C.use_runtime_plan(plan), warnings.catch_warnings():       # plans bind at trace time
    warnings.simplefilter("ignore")
    for name, shape, axes in (("1x4", (4,), ("model",)), ("2x2", (2, 2), ("data", "model"))):
        one(f"{name}.cf{cf}", base.replace(capacity_factor=cf), make_mesh(shape, axes))
    dcf = float(d["degraded_cf"])
    one(f"1x4.cf{dcf}", base.replace(capacity_factor=dcf), None)

# the (token, slot) pairs each layer's routing drops, at the first step's weights
def drops(cfg):
    from repro.models import dense as JD
    x = JM._embed_inputs(cfg, p, batch)
    pos = JM._positions(cfg, batch, *batch["tokens"].shape, 0)
    out = []
    for j in range(cfg.num_layers):
        lp = jax.tree.map(lambda a: a[j], p["trunk"]["moe_layers"])
        h, _ = JL.attention(lp["attn"], cfg, JL.norm(lp["ln1"], x, cfg.norm_kind), pos)
        xt = JL.norm(lp["ln2"], x + h, cfg.norm_kind).reshape(-1, cfg.d_model)
        probs = jax.nn.softmax(JL.linear(lp["moe"]["router"], xt), axis=-1)
        counts = np.bincount(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]).reshape(-1),
                             minlength=cfg.num_experts)
        cap = max(1, int(xt.shape[0] * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
        out.append(int(np.maximum(counts - cap, 0).sum()))
        x = JD.layer_fwd(lp, cfg, x, pos, None, use_moe=True)[0]
    return out
res["drops"] = np.asarray(drops(base.replace(capacity_factor=cf)))
np.savez(out + ".npz", **res)
"""


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

    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg = get_smoke_config(ARCH)
    b = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                   seed=11)).batch(0)
    np.savez(tmp / "inputs.npz", **b, plan=np.asarray(json.dumps(PLAN)),
             opt=np.asarray(json.dumps(STEP_OPT)), cf=np.asarray(CF),
             degraded_cf=np.asarray(DEGRADED_CF))
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


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_the_capacity_drops_tokens(runs):
    """Each MoE layer's routing of the global batch at ``CF`` drops (token,
    slot) pairs in the reference: the parity below covers the overflow."""
    _, _, ref = runs
    assert (ref["drops"] > 0).all(), ref["drops"]


@pytest.mark.parametrize("mesh,cf", [("1x4", CF), ("2x2", CF), ("1x4", DEGRADED_CF)])
def test_ep_step_matches_reference(runs, mesh, cf):
    """One plain step on each rank, every parameter gathered, against the
    reference's sited step on its mesh (the degraded capacity, at 1x4:
    against its plain step): parameters within 1e-5, loss, aux and
    grad_norm within 1e-5 relative."""
    cfg, ranks, ref = runs
    tag = f"{mesh}.cf{cf}"
    want = params_from_jax(cfg, _tree(ref, tag))
    for got, _ in ranks:
        assert set(k for k in want) <= {k[len(tag) + 1:] for k in got}
        for k, w in want.items():
            assert _diff(got[f"{tag}.{k}"], w) <= STEP_ATOL, (tag, k, _diff(got[f"{tag}.{k}"], w))
        for key in ("loss", "aux", "grad_norm"):
            w = float(ref[f"{tag}.{key}"])
            assert abs(float(got[f"{tag}.{key}"]) - w) <= STEP_RTOL * abs(w), (tag, key)


@pytest.mark.parametrize("mesh", MESHES)
def test_a2a_sites_issue_the_plans_chunks(runs, mesh):
    """Each MoE layer's dispatch and combine issue an all-to-all at its
    plan's chunk count in the forward and in remat's recompute, and one
    inverse all-to-all in the backward at the same count, every chunk one
    collective; the layers' experts split E over the model axis."""
    cfg, ranks, _ = runs
    chunks = {f"ep.layer{j}.moe.{k}": PLAN.get(f"ep.layer{j}.moe.{k}", ("xla", 1))[1]
              for j in range(cfg.num_layers) for k in ("a2a_disp", "a2a_comb")}
    m = int(mesh.split("x")[1])
    d = int(mesh.split("x")[0])
    for _, log in ranks:
        rows = {}
        for site, op, nc, matmuls, colls in log["issued"][mesh]:
            if site.startswith("ep."):
                assert nc == chunks[site] and colls == nc and matmuls == 0, (site, op, nc)
                rows.setdefault(site, []).append(op)
        want = {s: ["all_to_all", "all_to_all", "all_to_all.bwd"] for s in chunks}
        assert {s: sorted(v) for s, v in rows.items()} == want
        shapes = log["shapes"][mesh]
        E, D, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        assert shapes["trunk.moe_layers.0.moe.gate"] == [E // m, D // d, f]
        assert shapes["trunk.moe_layers.0.moe.down"] == [E // m, f, D // d]
        assert shapes["trunk.moe_layers.0.moe.router.weight"] == [E, D // d]


def test_indivisible_buffer_warns_with_the_site(runs):
    """cap 97 over 4 model ranks: each MoE site warns once, naming it, and
    issues no all-to-all (the step's numbers are held above)."""
    _, ranks, _ = runs
    for _, log in ranks:
        assert any("ep.layer0.moe" in w and "cap=97" in w for w in log["warned"])
        assert any("ep.layer1.moe" in w for w in log["warned"])


@pytest.mark.parametrize("mesh", MESHES)
def test_leaves_held_alike_stay_bit_equal(runs, mesh):
    """After the step every leaf that ``model`` does not split is bit-equal
    on the ranks of one data index (the router, the norms, qk_norm's scales:
    every model rank holds the same slice), and a 1-D leaf (the norms) on all
    four; the leaves it splits (the experts, attention's heads, the
    vocabulary) hold 1/m each and differ between the model ranks."""
    cfg, ranks, _ = runs
    m = int(mesh.split("x")[1])
    d = N // m
    digests = [log["digests"][mesh] for _, log in ranks]
    shapes = ranks[0][1]["shapes"][mesh]
    split = (".moe.gate", ".moe.up", ".moe.down", "attn.q.weight", "attn.k.weight",
             "attn.v.weight", "attn.o.weight", "embed.weight", "head.weight")
    for name in digests[0]:
        if name.endswith(split):
            assert len({dg[name] for dg in digests[:m]}) == m, name
            continue
        for r in range(N):
            for q in range(N):
                if r // m == q // m or len(shapes[name]) == 1:
                    assert digests[r][name] == digests[q][name], (name, r, q)
    D, q, V = cfg.d_model, cfg.q_dim // m, cfg.vocab_size // m
    attn = "trunk.moe_layers.0.attn."
    assert shapes[attn + "q.weight"] == [q, D // d] and shapes[attn + "o.weight"] == [D // d, q]
    assert shapes["embed.weight"] == shapes["head.weight"] == [V, D // d]
