"""The other families placed on a (data, model) mesh of 4 ranks: whisper-small
(encoder, self- and cross-attention by heads, GELU MLPs, learned positions),
deepseek-v2-lite-16b (MLA by heads, its experts over ``model``) and
qwen2-vl-72b (M-RoPE's GQA), against the reference's GSPMD step on 4 host
devices, in fp32 with the reference's weights (converted through numpy) and
the same batch.

Four ``gloo`` ranks (one process each, ``file://`` rendezvous) place each
smoke model (``models.model.shard_`` on ``make_mesh(shape, ("data",
"model"))``): whisper-small with its frames at 1x4 and 2x2,
deepseek-v2-lite-16b at 1x4 and 2x2, qwen2-vl-72b at 1x4 with 8 query and 4
KV heads of 32 (the smoke config's 4/1 keeps k and v whole; here they split
too), on tokens alone.  Each rank takes its rows of the global batch, runs
one forward and backward (the loss and every gradient, the slices gathered)
and one plain train step through the sited trunk.  A fifth process runs the
reference as its launcher does: ``param_specs`` placements ``device_put``
on a mesh of 4 host devices (``XLA_FLAGS=--xla_force_host_platform_
device_count=4``), under ``use_axes``, ``jax.jit`` of its train step's
plain path with ``sited_mesh`` that mesh (``value_and_grad`` of its loss,
its schedule and ``adamw.apply_updates``, the gradients returned beside
the step: one backward to compile), in three processes side by side.

With 256 image patches at the head of each row the reference masks by the
temporal position (ROADMAP.md, queue 3 item 9), so qwen2-vl-72b with
patches is held against the unplaced port on one process instead.

Bounds are ``tests/test_torch_tp_train.py``'s: the loss 1e-5 absolute,
gradients 1e-4 of each leaf's max|g|, one step 1e-5 (parameters and
AdamW's moments absolute; loss and grad_norm relative) with eps = 1e-3.
After the step the leaves that stay whole on ``model`` (the norms, the
``o`` and ``down`` biases, ``kv_a`` at 1x4, ``enc_pos``) are bit-equal on
every rank.
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
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, stub_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 4
B, S = 4, 32
S_PATCHES = 288                 # 256 patches and 32 tokens a row
ODD_FRAMES = 62                 # frames that do not split over 4 model ranks
LOSS_BOUND, GRAD_BOUND, STEP_ATOL, STEP_RTOL = 1e-5, 1e-4, 1e-5, 1e-5
ZERO_GRAD = 1e-6        # of the model's largest gradient: zero but for rounding
STEP_OPT = dict(lr=1e-2, eps=1e-3)
# name -> (smoke config, fields replaced)
MODELS = {"whisper-small": ("whisper-small", {}),
          "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
          "qwen2-vl-72b-8x4": ("qwen2-vl-72b", dict(num_heads=8, num_kv_heads=4, head_dim=32,
                                                    mrope_sections=(6, 5, 5)))}
# (model, data x model)
CASES = [("whisper-small", "1x4"), ("whisper-small", "2x2"),
         ("deepseek-v2-lite-16b", "1x4"), ("deepseek-v2-lite-16b", "2x2"),
         ("qwen2-vl-72b-8x4", "1x4")]
PATCHES = "qwen2-vl-72b-8x4"
# the reference's cases (indices into CASES) by process: each case's jit
# takes 12-18 s of a host core, so three processes run them side by side
REFERENCE_SPLIT = ("0,1", "2,4", "3")

_COMMON = r"""
import dataclasses, hashlib, json, sys, warnings
import numpy as np
d = dict(np.load(sys.argv[-2]))
MODELS = json.loads(str(d["models"]))
CASES = json.loads(str(d["cases"]))
opt = json.loads(str(d["opt"]))

def inputs(name):
    out = {n: d[n] for n in ("tokens", "targets", "mask")}
    if f"frames.{name}" in d:
        out["frames"] = d[f"frames.{name}"]
    return out
"""

_PORT = _COMMON + r"""
import torch, torch.distributed as dist
rank, world, rdv, sd = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
out = sys.argv[-1]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C, constraints as CT
from repro_torch.train import trainer as T

meshes = {"1x4": make_mesh((1, 4), ("data", "model")),
          "2x2": make_mesh((2, 2), ("data", "model"))}
res, log = {}, {"issued": {}, "shapes": {}, "digests": {}}

def config(name):
    arch, over = MODELS[name]
    return dataclasses.replace(get_smoke_config(arch), **over)

def fresh(cfg, name, mesh):
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(torch.load(f"{sd}/{name}.pt"))
    return model if mesh is None else M.shard_(cfg, model, mesh)

for name, mname in CASES:
    cfg, mesh = config(name), meshes[mname]
    dm = mesh["data"]
    glob = {n: torch.from_numpy(a) for n, a in inputs(name).items()}
    k = glob["tokens"].shape[0] // dm.size
    rows = {n: a[dm.rank * k:(dm.rank + 1) * k] for n, a in glob.items()}
    sizes = {a: m.size for a, m in mesh.items()}
    tag = f"{name}.{mname}"

    def axes():
        return CT.use_axes(("data",), "model", sizes=sizes, batch=glob["tokens"].shape[0])

    model = fresh(cfg, name, mesh)
    place = model.placement
    log["shapes"][tag] = {n: list(p.shape) for n, p in model.named_parameters()}
    with axes(), C.record_issued() as issued:
        loss, _ = M.loss_and_metrics(cfg, model, rows, mesh=mesh["model"])
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    log["issued"][tag] = [dataclasses.astuple(r) for r in issued]
    split = {n for n in names if "data" in place.axes(n)}
    whole = C.psum_tree({n: g for n, g in zip(names, grads) if n not in split}, dm)
    res[f"{tag}.grads.loss"] = C.psum_tree(loss.detach(), dm) / dm.size
    for n, g in zip(names, grads):
        res[f"{tag}.grads.{n}"] = place.full(n, (g if n in split else whole[n]) / dm.size)
    model = fresh(cfg, name, mesh)
    state = adamw.init_state(dict(model.named_parameters()))
    tcfg = T.TrainConfig(opt=adamw.AdamWConfig(**opt), warmup=2, total_steps=10,
                         sited_mesh=mesh["model"], data_axis=dm)
    with axes():
        model, state, m = T.make_train_step(cfg, tcfg)(model, state, rows, 1)
    for n, p in model.named_parameters():
        res[f"{tag}.step.{n}"] = place.full(n, p.detach())
        for key in ("mu", "nu"):
            res[f"{tag}.step.{key}.{n}"] = place.full(n, state[key][n])
    for key in ("loss", "grad_norm"):
        res[f"{tag}.step.{key}"] = m[key]
    log["digests"][tag] = {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                           for n, p in model.named_parameters()}
    # init_placed draws the same slices as shard_ of init_params, a module at a time
    a = M.shard_(cfg, M.init_params(cfg, 0, device="cpu"), mesh)
    b = M.init_placed(cfg, 0, mesh, device="cpu")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    log.setdefault("init_placed", {})[tag] = (
        list(pa) == list(pb) and all(torch.equal(pa[n], pb[n]) for n in pa)
        and a.placement.specs == b.placement.specs and b.trunk.mlp_mesh is mesh["model"])

# qwen2-vl with 256 patches at 1x4 against the unplaced port on this process
cfg, mesh = config(PATCHES), meshes["1x4"]
batch = {n: torch.from_numpy(d[f"patches.{n}"]) for n in ("tokens", "targets", "mask",
                                                          "patches")}
for which, mdl, kw in (("placed", fresh(cfg, PATCHES, mesh), dict(mesh=mesh["model"])),
                       ("plain", fresh(cfg, PATCHES, None), {})):
    loss, _ = M.loss_and_metrics(cfg, mdl, batch, **kw)
    names, params = zip(*mdl.named_parameters())
    grads = torch.autograd.grad(loss, params)
    res[f"patches.{which}.loss"] = loss.detach()
    for n, g in zip(names, grads):
        res[f"patches.{which}.{n}"] = g if mdl.placement is None else mdl.placement.full(n, g)

# whisper over 62 frames at 1x4: the encoder's MLPs run column-then-row
cfg, mesh = config("whisper-small"), meshes["1x4"]
batch = {n: torch.from_numpy(a) for n, a in inputs("whisper-small").items()}
batch["frames"] = torch.from_numpy(d["odd_frames"])
for which, mdl, kw in (("placed", fresh(cfg, "whisper-small", mesh), dict(mesh=mesh["model"])),
                       ("plain", fresh(cfg, "whisper-small", None), {})):
    with C.record_issued() as issued:
        loss, _ = M.loss_and_metrics(cfg, mdl, batch, **kw)
        names, params = zip(*mdl.named_parameters())
        grads = torch.autograd.grad(loss, params)
    log["issued"][f"odd.{which}"] = [dataclasses.astuple(r) for r in issued]
    res[f"odd.{which}.loss"] = loss.detach()
    for n, g in zip(names, grads):
        res[f"odd.{which}.{n}"] = g if mdl.placement is None else mdl.placement.full(n, g)

np.savez(out + ".npz", **{k: v.numpy() for k, v in res.items()})
with open(out + ".json", "w") as f:
    json.dump(log, f)
dist.destroy_process_group()
""".replace("PATCHES", repr(PATCHES))

_REFERENCE = _COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.optim import adamw as JA, schedules as JS
from repro.parallel import constraints as CT, sharding as SH
from repro.train import trainer as JT

out = sys.argv[-1]
res = {}
mine = [CASES[int(i)] for i in sys.argv[1].split(",")]

def put(tag, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{tag}." + "/".join(x.key for x in k)] = np.asarray(v)

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    for name, mname in mine:
        arch, over = MODELS[name]
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        batch = {n: jnp.asarray(a) for n, a in inputs(name).items()}
        mesh = make_mesh(tuple(int(x) for x in mname.split("x")), ("data", "model"))
        jax.sharding.set_mesh(mesh)
        tag = f"{name}.{mname}"
        with CT.use_axes(("data",), "model"):
            p = jax.jit(lambda k: JM.init_params(cfg, k))(jax.random.PRNGKey(0))
            spec = SH.param_specs(p, mesh)
            p = jax.device_put(p, jax.tree.map(lambda s: NamedSharding(mesh, s), spec))
            tcfg = JT.TrainConfig(opt=JA.AdamWConfig(**opt), warmup=2, total_steps=10,
                                  sited_mesh=mesh)

            @jax.jit
            def both(p, b):
                # the plain path of JT.make_train_step's train_step, its
                # gradients returned beside the step (one jit, one backward)
                (loss, _), g = jax.value_and_grad(lambda q: JM.loss_and_metrics(
                    cfg, q, b, remat=tcfg.remat, mesh=tcfg.sited_mesh), has_aux=True)(p)
                lr_scale = getattr(JS, tcfg.schedule)(jnp.asarray(1), warmup=tcfg.warmup,
                                                      total=tcfg.total_steps)
                p2, s2, m = JA.apply_updates(p, g, JA.init_state(p), tcfg.opt, lr_scale)
                return (loss, g), (p2, s2, dict(m, loss=loss))

            (loss, g), (p2, s2, m) = both(p, batch)
        res[f"{tag}.grads.loss"] = np.asarray(loss)
        put(f"{tag}.grads", g)
        put(f"{tag}.step", p2)
        put(f"{tag}.step.mu", s2["mu"])
        put(f"{tag}.step.nu", s2["nu"])
        for k in ("loss", "grad_norm"):
            res[f"{tag}.step.{k}"] = np.asarray(m[k])
np.savez(out + ".npz", **res)
"""


def _cfg(name):
    import dataclasses

    arch, over = MODELS[name]
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
    """The port on 4 gloo ranks and the reference on 4 host devices (in
    three processes), concurrently; returns (per-rank (results, log),
    reference)."""
    import dataclasses

    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM

    tmp = tmp_path_factory.mktemp("families_placement")
    b = SyntheticCorpus(DataConfig(vocab_size=512, seq_len=S, global_batch=B,
                                   seed=13)).batch(0)
    pb = SyntheticCorpus(DataConfig(vocab_size=512, seq_len=S_PATCHES, global_batch=2,
                                    seed=14)).batch(0)
    pb.update(stub_inputs(_cfg(PATCHES), 2, seed=14))
    extra = {f"patches.{k}": v for k, v in pb.items()}
    extra["odd_frames"] = np.random.default_rng(15).standard_normal(
        (B, ODD_FRAMES, _cfg("whisper-small").d_model)).astype(np.float32) * 0.02
    for name in MODELS:
        extra.update({f"frames.{name}": v for k, v in stub_inputs(_cfg(name), B, seed=13)
                      .items() if k == "frames"})
    np.savez(tmp / "inputs.npz", **b, **extra, models=np.asarray(json.dumps(MODELS)),
             cases=np.asarray(json.dumps(CASES)), opt=np.asarray(json.dumps(STEP_OPT)))
    (tmp / "params").mkdir()
    for name, (arch, over) in MODELS.items():
        jcfg = dataclasses.replace(jget_smoke(arch), **over)
        jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
        torch.save(params_from_jax(_cfg(name), jax.tree.map(np.asarray, jp)),
                   tmp / "params" / f"{name}.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT, str(r), str(N), str(tmp / "rdv"), str(tmp / "params"),
         str(tmp / "inputs.npz"), str(tmp / f"rank{r}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(N)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, part, str(tmp / "inputs.npz"),
         str(tmp / f"reference{j}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for j, part in enumerate(REFERENCE_SPLIT)]
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
    ref = {}
    for j in range(len(REFERENCE_SPLIT)):
        ref.update(np.load(tmp / f"reference{j}.npz"))
    return ranks, ref


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float64)).max())


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _id(case):
    return f"{case[0]}-{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_loss_and_gradients_match_reference(runs, case):
    """The global batch's loss and every gradient of the placed model (each
    rank's slices gathered; the whole leaves averaged over ``data``)
    against the reference's GSPMD ``jax.value_and_grad`` with remat."""
    ranks, ref = runs
    tag = f"{case[0]}.{case[1]}"
    want = params_from_jax(_cfg(case[0]), _tree(ref, f"{tag}.grads"))
    for got, _ in ranks:
        assert abs(float(got[f"{tag}.grads.loss"]) - float(ref[f"{tag}.grads.loss"])) \
            < LOSS_BOUND
        _grads_close({k: got[f"{tag}.grads.{k}"] for k in want}, want)


def _grads_close(got, want):
    """Each leaf within GRAD_BOUND of its max|g|; a leaf whose gradient is
    zero but for rounding (below ZERO_GRAD of the model's largest: whisper's
    key biases, which add the same q·b to every score of a row) must be so
    in both."""
    top = max(_max(w) for w in want.values())
    for k, w in want.items():
        g = got[k]
        assert g.shape == tuple(w.shape), k
        if _max(w) <= ZERO_GRAD * top:
            assert _max(g) <= ZERO_GRAD * top, k
        else:
            assert _diff(g, w) <= GRAD_BOUND * _max(w), k


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_step_matches_reference(runs, case):
    """One plain step from the reference's weights against the reference's
    GSPMD step: parameters and AdamW's moments within 1e-5, loss and
    grad_norm within 1e-5 relative."""
    ranks, ref = runs
    cfg = _cfg(case[0])
    tag = f"{case[0]}.{case[1]}.step"
    for got, _ in ranks:
        for k, w in params_from_jax(cfg, _tree(ref, tag)).items():
            assert _diff(got[f"{tag}.{k}"], w) <= STEP_ATOL, (tag, k)
        for m in ("mu", "nu"):
            for k, w in params_from_jax(cfg, _tree(ref, f"{tag}.{m}")).items():
                assert _diff(got[f"{tag}.{m}.{k}"], w) <= STEP_ATOL, (tag, m, k)
        for k in ("loss", "grad_norm"):
            w = float(ref[f"{tag}.{k}"])
            assert abs(float(got[f"{tag}.{k}"]) - w) <= STEP_RTOL * abs(w), (tag, k)


def _whole_on_model(name, mesh):
    """State-dict names that stay whole on ``model`` and, at ``mesh``, on
    every rank: the norms, the ``o`` and ``down`` biases, whisper's
    ``enc_pos``, MLA's ``kv_a`` at 1x4 (its d splits over ``data``)."""
    if name == "whisper-small":
        out = ["ln_f.scale", "ln_f.bias", "trunk.enc_pos", "trunk.enc_ln.scale"]
        for i in range(2):
            out += [f"trunk.enc_layers.{i}.ln1.scale", f"trunk.enc_layers.{i}.attn.o.bias",
                    f"trunk.enc_layers.{i}.mlp.down.bias", f"trunk.dec_layers.{i}.ln_x.bias",
                    f"trunk.dec_layers.{i}.self_attn.o.bias",
                    f"trunk.dec_layers.{i}.cross_attn.o.bias",
                    f"trunk.dec_layers.{i}.mlp.down.bias"]
        return out
    if name.startswith("deepseek"):
        out = ["ln_f.scale", "trunk.dense_layers.0.ln1.scale",
               "trunk.dense_layers.0.attn.kv_a_norm.scale", "trunk.moe_layers.0.ln2.scale",
               "trunk.moe_layers.0.attn.kv_a_norm.scale"]
        if mesh == "1x4":
            out += ["trunk.dense_layers.0.attn.kv_a.weight",
                    "trunk.moe_layers.0.attn.kv_a.weight"]
        return out
    return ["ln_f.scale", "trunk.dense_layers.0.ln1.scale", "trunk.dense_layers.1.ln2.scale",
            "trunk.dense_layers.0.attn.o.bias"]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ranks_hold_whole_heads_and_whole_leaves_stay_equal(runs, case):
    """Each rank holds its share of the heads (whisper's encoder, self- and
    cross-attention; MLA's q and kv_b rows and o's columns; qwen2-vl's 2
    query and 1 KV head of 8/4), whisper's tied vocabulary of 512 split
    over ``model`` and ``dec_pos`` over ``data``; after the step the leaves
    that stay whole on ``model`` are bit-equal on all four ranks and a
    head-split leaf differs between the model ranks."""
    ranks, _ = runs
    name, mesh = case
    cfg = _cfg(name)
    d, m = (int(x) for x in mesh.split("x"))
    tag = f"{name}.{mesh}"
    D = cfg.d_model
    if name == "whisper-small":
        h = cfg.head_dim
        want = {f"trunk.{att}.q.weight": [cfg.num_heads // m * h, D // d]
                for att in ("enc_layers.0.attn", "dec_layers.1.self_attn",
                            "dec_layers.1.cross_attn")}
        want.update({"trunk.dec_layers.0.cross_attn.k.bias": [cfg.num_heads // m * h],
                     "trunk.enc_layers.1.attn.o.weight": [D // d, cfg.num_heads // m * h],
                     "embed.weight": [cfg.vocab_size // m, D // d],
                     "dec_pos": [cfg.max_seq_len // d, D], "trunk.enc_pos": [cfg.encoder_seq, D]})
        split = "trunk.enc_layers.0.attn.q.weight"
    elif name.startswith("deepseek"):
        H = cfg.num_heads // m
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        att = "trunk.moe_layers.0.attn."
        want = {att + "q.weight": [H * qk, D // d],
                att + "kv_b.weight": [H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                      cfg.kv_lora_rank],
                att + "o.weight": [D // d, H * cfg.v_head_dim],
                att + "kv_a.weight": [cfg.kv_lora_rank + cfg.qk_rope_head_dim, D // d],
                "trunk.moe_layers.0.moe.gate": [cfg.num_experts // m, D // d, cfg.moe_d_ff]}
        split = att + "kv_b.weight"
    else:
        h = cfg.head_dim
        att = "trunk.dense_layers.0.attn."
        want = {att + "q.weight": [2 * h, D], att + "k.weight": [h, D],
                att + "v.bias": [h], "head.weight": [cfg.vocab_size // m, D]}
        split = att + "k.weight"
    digests = [log["digests"][tag] for _, log in ranks]
    for _, log in ranks:
        shapes = log["shapes"][tag]
        for k, s in want.items():
            assert shapes[k] == s, (k, shapes[k], s)
    for k in _whole_on_model(name, mesh):
        assert len({dg[k] for dg in digests}) == 1, k
    # a leaf split over model alone (MLA's kv_b) is one of m slices, else of N
    assert len({dg[split] for dg in digests}) == (m if name.startswith("deepseek") else N), \
        split


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_init_placed_draws_the_slices_of_init_params(runs, case):
    """``models.model.init_placed`` (each module drawn whole and cut at once)
    gives every rank exactly ``shard_`` of ``init_params``: the same
    parameters, bit-equal, and the same placement."""
    ranks, _ = runs
    for _, log in ranks:
        assert log["init_placed"][f"{case[0]}.{case[1]}"]


def _sites(rows):
    out = {}
    for site, op, chunks, matmuls, colls in rows:
        out.setdefault(site, {}).setdefault(op, []).append(colls)
    return out


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_placement_issues_its_all_reduces(runs, case):
    """One forward and backward with remat: each attention sums its heads'
    rows at ``{site}.ar`` in the forward and in remat's recompute and its
    input's gradient at ``.ar.bwd`` once, at whisper's ``tp.enc{i}.attn``,
    ``tp.layer{i}.attn`` and ``tp.layer{i}.cross_attn`` (whose memory's
    gradient sums at ``.mem.ar.bwd``), deepseek's MLA at ``tp.layer{i}.attn``
    (its whole ``kv_a`` and latent norm at ``.kv.ar.bwd``, two leaves);
    whisper's FSDP gathers at ``fsdp.enc{i}.ag_params`` and
    ``fsdp.layer{i}.ag_params``, its positions at ``fsdp.dec_pos.ag_params``."""
    ranks, _ = runs
    name, mesh = case
    cfg = _cfg(name)
    fwd = {"all_reduce": [1, 1]}
    bwd = {"all_reduce.bwd": [1]}
    want = {}
    if name == "whisper-small":
        for i in range(cfg.encoder_layers):
            want.update({f"tp.enc{i}.attn.ar": fwd, f"tp.enc{i}.attn.ar.bwd": bwd})
        for i in range(cfg.num_layers):
            for a in ("attn", "cross_attn"):
                want.update({f"tp.layer{i}.{a}.ar": fwd, f"tp.layer{i}.{a}.ar.bwd": bwd})
            want[f"tp.layer{i}.cross_attn.mem.ar.bwd"] = bwd
    elif name.startswith("deepseek"):
        for i in range(cfg.num_layers):
            want.update({f"tp.layer{i}.attn.ar": fwd, f"tp.layer{i}.attn.ar.bwd": bwd,
                         f"tp.layer{i}.attn.kv.ar.bwd": {"all_reduce.bwd": [1, 1]}})
    else:
        for i in range(cfg.num_layers):
            want.update({f"tp.layer{i}.attn.ar": fwd, f"tp.layer{i}.attn.ar.bwd": bwd})
    for _, log in ranks:
        sites = _sites(log["issued"][f"{name}.{mesh}"])
        got = {s: ops for s, ops in sites.items() if "attn." in s}
        assert got == want
        if name == "whisper-small":
            gathers = {s for s in sites if s.startswith("fsdp.")}
            assert {"fsdp.enc0.ag_params", "fsdp.layer1.ag_params",
                    "fsdp.dec_pos.ag_params", "fsdp.embed.ag_params"} <= gathers


def test_whisper_mlp_over_a_sequence_that_does_not_split(runs):
    """Whisper over 62 frames at 1x4 (62 does not split over 4): the
    encoder's MLPs run column-then-row (``tp.enc{i}.mlp.ar`` once: remat's
    recompute stops at the layer's last saved tensor, before the sum;
    ``.ar.bwd`` once), the decoder's over its 32
    tokens stay sequence-parallel (``tp.layer{i}.mlp.ag|rs``); the loss and
    every gradient equal the unplaced port's within 1e-5 and 1e-4 of max|g|."""
    ranks, _ = runs
    cfg = _cfg("whisper-small")
    for got, log in ranks:
        sites = _sites(log["issued"]["odd.placed"])
        for i in range(cfg.encoder_layers):
            assert sites[f"tp.enc{i}.mlp.ar"] == {"all_reduce": [1]}
            assert sites[f"tp.enc{i}.mlp.ar.bwd"] == {"all_reduce.bwd": [1]}
            assert f"tp.enc{i}.mlp.ag" not in sites
        assert all(f"tp.layer{i}.mlp.rs" in sites for i in range(cfg.num_layers))
        assert not log["issued"]["odd.plain"]
        assert abs(float(got["odd.placed.loss"]) - float(got["odd.plain.loss"])) < LOSS_BOUND
        names = [k[len("odd.plain."):] for k in got
                 if k.startswith("odd.plain.") and k != "odd.plain.loss"]
        assert names
        _grads_close({n: got[f"odd.placed.{n}"] for n in names},
                     {n: got[f"odd.plain.{n}"] for n in names})


def test_qwen2_vl_with_patches_matches_the_unplaced_port(runs):
    """qwen2-vl-72b (8/4 heads) with 256 patches at the head of each row,
    placed at 1x4, against the unplaced port on one process: the patches
    overwrite the sequence's head after the vocab-parallel embedding and
    M-RoPE takes the patches' grid on every rank; the loss within 1e-5 and
    every gradient (gathered) within 1e-4 of its max|g|."""
    ranks, _ = runs
    for got, _ in ranks:
        assert abs(float(got["patches.placed.loss"]) - float(got["patches.plain.loss"])) \
            < LOSS_BOUND
        names = [k[len("patches.plain."):] for k in got
                 if k.startswith("patches.plain.") and k != "patches.plain.loss"]
        assert names
        _grads_close({n: got[f"patches.placed.{n}"] for n in names},
                     {n: got[f"patches.plain.{n}"] for n in names})
