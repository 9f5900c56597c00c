"""The port's training launcher (``repro_torch.launch.train``), its run
configs (``launch.config``) and its checkpoints (``train.checkpoint``)
against the reference's: checkpoints cross between the packages both ways
and fall back past a corrupt step as the reference's do; the config
loader resolves as the reference's; ``--plan-repo`` hits and misses as
``tests/test_plan_repo.py`` holds the reference's launcher to; and
``--mesh 2x2`` over 4 gloo ranks gives the reference launcher's step
losses on its 2x2 mesh of host devices within 1e-5, from the same weights
(the reference's, converted) and the same batches."""
import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import ml_dtypes  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import config as JCONF  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import ParallelPlan, extract_workload, tune  # noqa: E402
from repro_torch.launch import config as CONF, train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3-8b"
LOSS_BOUND = 1e-5


@pytest.fixture(scope="module")
def ref():
    cfg = get_smoke_config(ARCH)
    jp = jax.jit(lambda key: JM.init_params(jget_smoke(ARCH), key))(jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, jp)


def _equal(a, b) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return (jax.tree.structure(a) == jax.tree.structure(b)
            and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb)))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

MIXED = {"b": {"z": np.arange(6, dtype=np.float32).reshape(2, 3), "a": np.ones(2, np.int32)},
         "a": np.float32(2.5), "c": [np.zeros(1), np.arange(3.0)], "d": (np.ones((1, 1)),)}


@pytest.mark.parametrize("tree", ["params", "mixed"])
def test_port_checkpoint_restores_in_the_reference(ref, tmp_path, tree):
    """What the port saves, the reference restores equal, with its step;
    the manifest names the structure as ``jax.tree.structure`` does."""
    t = ref[1] if tree == "params" else MIXED
    ck = CK.save(str(tmp_path), t, step=7, extra={"note": "x"})
    got, step = JCK.restore(str(tmp_path), t)
    assert step == 7 and _equal(jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, t))
    with open(os.path.join(ck, "manifest.json")) as f:
        man = json.load(f)
    assert man["treedef"] == str(jax.tree.structure(t))
    assert man["num_leaves"] == len(jax.tree.leaves(t)) and man["extra"] == {"note": "x"}


@pytest.mark.parametrize("tree", ["params", "mixed"])
def test_reference_checkpoint_restores_in_the_port(ref, tmp_path, tree):
    t = ref[1] if tree == "params" else MIXED
    JCK.save(str(tmp_path), t, step=3)
    got, step = CK.restore(str(tmp_path), t)
    assert step == 3 and _equal(got, jax.tree.map(np.asarray, t))


def test_model_crosses_both_ways_through_checkpoints(ref, tmp_path):
    """A port model saved as the reference's tree restores in the reference;
    a reference checkpoint loads into a port model with the same tensors."""
    cfg, jp = ref
    model = M.init_params(cfg, 3, device="cpu")
    CK.save(str(tmp_path / "port"), params_to_jax(cfg, model), step=1)
    got, _ = JCK.restore(str(tmp_path / "port"), jp)
    for k, v in params_from_jax(cfg, jax.tree.map(np.asarray, got)).items():
        assert torch.equal(v, model.state_dict()[k]), k
    JCK.save(str(tmp_path / "ref"), jp, step=2)
    tree, _ = CK.restore(str(tmp_path / "ref"), jp)
    model.load_state_dict(params_from_jax(cfg, tree))
    assert _equal(params_to_jax(cfg, model), jp)


def test_bf16_leaves_read_through_their_two_byte_view(ref, tmp_path):
    """The reference writes bf16 leaves (``ml_dtypes``); the port reads
    each through its 2-byte view, widened to fp32 exactly."""
    jb = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16), ref[1])
    JCK.save(str(tmp_path), jb, step=1)
    got, _ = CK.restore(str(tmp_path), ref[1])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jb)):
        assert g.dtype == np.float32 and np.array_equal(g, w.astype(np.float32))


def _corrupt(path: Path, how: str) -> None:
    if how == "truncated":
        data = (path / "arrays.npz").read_bytes()
        (path / "arrays.npz").write_bytes(data[:len(data) // 2])
    else:
        (path / "manifest.json").write_text("{not json")


@pytest.mark.parametrize("how", ["truncated", "manifest"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_corrupt_step_falls_back_as_the_reference(tmp_path, how, writer):
    """Steps 1-3 saved, step 3 corrupted: both packages warn the same
    warning and restore step 2; with every step corrupted both raise the
    same ``FileNotFoundError``."""
    save = CK.save if writer == "port" else JCK.save
    for s in (1, 2, 3):
        save(str(tmp_path), {"w": np.full(3, s, np.float32)}, step=s)
    _corrupt(tmp_path / "step_00000003", how)
    like = {"w": np.zeros(3, np.float32)}
    msgs = {}
    for name, restore in (("port", CK.restore), ("reference", JCK.restore)):
        with pytest.warns(RuntimeWarning, match="falling back to step_00000002") as ws:
            tree, step = restore(str(tmp_path), like)
        assert step == 2 and np.array_equal(tree["w"], np.full(3, 2, np.float32))
        msgs[name] = [str(w.message) for w in ws]
    assert msgs["port"] == msgs["reference"]
    for s in (1, 2):
        _corrupt(tmp_path / f"step_{s:08d}", how)
    errs = {}
    for name, restore in (("port", CK.restore), ("reference", JCK.restore)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(FileNotFoundError) as e:
                restore(str(tmp_path), like)
        errs[name] = str(e.value)
    assert errs["port"] == errs["reference"]


def test_wrong_leaf_count_falls_back(tmp_path):
    CK.save(str(tmp_path), {"w": np.zeros(2)}, step=1)
    CK.save(str(tmp_path), {"w": np.zeros(2), "v": np.zeros(1)}, step=2)
    with pytest.warns(RuntimeWarning, match="checkpoint has 2 leaves, model expects 1"):
        _, step = CK.restore(str(tmp_path), {"w": np.zeros(2)})
    assert step == 1


def test_keep_and_latest_as_the_reference(tmp_path):
    """``keep`` bounds the steps kept, ``latest`` names the newest, and an
    explicit ``step`` restores that one; no ``.tmp`` directory is left."""
    for name, save in (("port", CK.save), ("reference", JCK.save)):
        d = tmp_path / name
        for s in range(5):
            save(str(d), {"w": np.full(2, s, np.float32)}, step=s, keep=2)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "reference")) \
        == ["latest", "step_00000003", "step_00000004"]
    assert (tmp_path / "port" / "latest").read_text() == "step_00000004"
    tree, step = CK.restore(str(tmp_path / "port"), {"w": np.zeros(2, np.float32)}, step=3)
    assert step == 3 and tree["w"][0] == 3


# ---------------------------------------------------------------------------
# run configs
# ---------------------------------------------------------------------------

DEFAULTS = dict(steps=100, seq=256, batch=8, lr=3e-4, grad_accum=1, mesh=None, ckpt=None,
                log_every=10)      # the launchers' argparse defaults


def _namespace(**kw):
    return argparse.Namespace(**dict(DEFAULTS, **kw))


@pytest.mark.parametrize("run,cli", [
    ({"arch": "llama3-8b", "smoke": True, "steps": 5}, {}),
    ({"arch": "llama3-8b", "overrides": {"num_layers": 2}, "seq": 2048, "batch": 4}, {"steps": 3}),
    ({"arch": "zamba2-7b", "smoke": True, "mesh": "2x2"}, {"mesh": "1x4", "lr": 1e-3}),
])
def test_run_config_resolves_as_the_reference(tmp_path, run, cli):
    path = tmp_path / "run.json"
    path.write_text(json.dumps(run))
    mine, theirs = CONF.load_run_config(str(path)), JCONF.load_run_config(str(path))
    assert mine == theirs
    args = _namespace(**cli)
    merged = CONF.merge_cli(mine, args, defaults=DEFAULTS)
    assert merged == JCONF.merge_cli(theirs, args, defaults=DEFAULTS)
    assert dataclasses.asdict(CONF.resolve_model(merged)) == dataclasses.asdict(
        JCONF.resolve_model(merged))


def test_run_config_refuses_unknown_keys(tmp_path):
    path = tmp_path / "run.json"
    path.write_text(json.dumps({"arch": "llama3-8b", "stepz": 3}))
    for mod in (CONF, JCONF):
        with pytest.raises(ValueError, match=r"unknown run-config keys: \['stepz'\]"):
            mod.load_run_config(str(path))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.fixture
def no_plan():
    yield
    C.install_runtime_plan(None)


def _wl(seq=32, batch=2):
    cfg = get_smoke_config(ARCH)
    return extract_workload(cfg, ParallelPlan(kind="fsdp", dp=8), seq=seq, global_batch=batch)


def test_train_launcher_resolves_repo_plan_end_to_end(tmp_path, capsys, no_plan):
    """tests/test_plan_repo.py's launcher case on the port: a plan stored
    for this launch's workload on h100-sxm installs with zero tuning work,
    its lowering exactly; the run trains and writes its checkpoint."""
    wl = _wl()
    plan = tune(wl, "h100-sxm", repo=str(tmp_path / "repo"))
    out = train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--seq", "32", "--batch", "2",
                      "--plan-repo", str(tmp_path / "repo"), "--plan-parallel", "fsdp:8",
                      "--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    text = capsys.readouterr().out
    assert "zero tuning at launch" in text and "checkpoint written to" in text
    rt = plan.runtime_plan(wl)
    assert C.active_runtime_plan() == rt
    for sid, knobs in rt.items():
        assert C.runtime_for(sid) == knobs
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    tree, step = CK.restore(str(tmp_path / "ck"), params_to_jax(get_smoke_config(ARCH),
                                                                out["model"]))
    assert step == 2


def test_train_launcher_repo_miss_warns_and_runs_untuned(tmp_path, no_plan):
    argv = ["--arch", ARCH, "--smoke", "--steps", "1", "--seq", "32", "--batch", "2",
            "--plan-repo", str(tmp_path), "--device", "cpu"]
    with pytest.warns(RuntimeWarning, match="launches untuned"):
        train.main(argv)
    assert C.active_runtime_plan() == {}


def test_train_launcher_needs_a_process_group_for_a_mesh(no_plan, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--seq", "32", "--batch", "2",
                    "--mesh", "2x2", "--device", "cpu"])


_PORT_RANK = r"""
import json, sys, numpy as np, torch, torch.distributed as dist
from repro_torch.models import model as M
from repro_torch.launch import train
sd, argv, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
ckpt = argv[argv.index("--ckpt") + 1] if "--ckpt" in argv else None
if ckpt:           # the group outlives the launcher's run: the restore below gathers
    dist.init_process_group("gloo")
real = M.init_params

def reference_weights(cfg, seed=0, *, device="cuda"):      # the reference's weights
    model = real(cfg, seed, device=device)
    model.load_state_dict(torch.load(sd))
    return model

def reference_placed(cfg, seed, mesh, *, device="cuda"):  # placed as the launcher places
    return M.shard_(cfg, reference_weights(cfg, seed, device=device), mesh)

M.init_params, M.init_placed = reference_weights, reference_placed
res = train.main(argv)
log = {"losses": res["losses"]}
if ckpt:           # the checkpoint restored into this rank's slices, exactly
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax, params_to_jax
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint
    cfg = get_smoke_config("llama3-8b")
    model = res["model"]
    tree = params_to_jax(cfg, model)
    meshes = make_mesh(train.mesh_shape(argv[argv.index("--mesh") + 1]), ("data", "model"))
    back, step = checkpoint.restore(ckpt, tree)
    mine = params_from_jax(cfg, back, meshes)
    log.update(step=step, shapes={k: list(v.shape) for k, v in mine.items()},
               restored_equal=all(torch.equal(mine[k], v) for k, v in model.state_dict().items()))
    if dist.get_rank() == 0:
        def flat(t, pre=""):
            for k, v in t.items():
                yield from flat(v, pre + k + "/") if isinstance(v, dict) else [(pre + k, v)]
        np.savez(out + ".npz", **dict(flat(tree)))
    dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(log, f)
"""

_REFERENCE_LAUNCH = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.launch import train
argv, out = json.loads(sys.argv[1]), sys.argv[2]
losses = []

class _Jax:                      # the launcher's jax, recording each step's loss
    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        f = jax.jit(fn, **kw)

        def step(*a):
            out = f(*a)
            losses.append(float(out[2]["loss"]))
            return out
        return step

train.jax = _Jax()
train.main(argv)
with open(out, "w") as f:
    json.dump(losses, f)
"""


def _launch_pair(ref, tmp_path, mesh, port_flags=()):
    """``--mesh`` on 4 gloo ranks (a ``torchrun`` environment: RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=localhost) and the reference
    launcher with the same flags on 4 host devices, concurrently, from the
    reference's weights; returns (each rank's log, rank 0's output, the
    reference's losses)."""
    cfg, jp = ref
    torch.save(params_from_jax(cfg, jp), tmp_path / "params.pt")
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--seq", "32", "--batch", "4",
            "--mesh", mesh, "--log-every", "1"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE="4")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT_RANK, str(tmp_path / "params.pt"),
         json.dumps(argv + ["--device", "cpu", *port_flags]), str(tmp_path / f"rank{r}.json")],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_LAUNCH, json.dumps(argv),
         str(tmp_path / "reference.json")], env=base, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    want = json.loads((tmp_path / "reference.json").read_text())
    assert len(want) == 3
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    for r, got in enumerate(ranks):
        got = got["losses"]
        assert len(got) == 3 and max(abs(a - b) for a, b in zip(got, want)) < LOSS_BOUND, (
            r, got, want)
    return ranks, logs[0], want


def test_mesh_2x2_launch_matches_reference_launcher(ref, tmp_path):
    """``--mesh 2x2`` against the reference launcher on its 2x2 mesh of
    host devices: each step's loss (the global batch's, averaged over the
    data axis) within 1e-5; every rank reports the same losses."""
    _, out, _ = _launch_pair(ref, tmp_path, "2x2")
    assert "step    2 loss" in out


def test_mesh_4x1_launch_matches_reference_launcher_and_checkpoints(ref, tmp_path):
    """``--mesh 4x1`` (pure FSDP: each rank holds a quarter of every F dim
    and one row of the batch) against the reference launcher's 4x1 within
    1e-5 a step.  Its checkpoint, written from the slices, restores in
    ``repro.train.checkpoint`` equal to the gathered parameters, and back
    into each rank's slices exactly."""
    cfg, jp = ref
    ranks, out, _ = _launch_pair(ref, tmp_path, "4x1", ("--ckpt", str(tmp_path / "ck")))
    assert "step    2 loss" in out and "checkpoint written to" in out
    tree, step = JCK.restore(str(tmp_path / "ck"), jp)
    gathered = dict(np.load(tmp_path / "rank0.json.npz"))
    flat = {"/".join(x.key for x in k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert step == 3 and set(flat) == set(gathered)
    for k, v in flat.items():
        assert v.dtype == gathered[k].dtype and np.array_equal(v, gathered[k]), k
    whole = params_from_jax(cfg, jp)
    for log in ranks:
        assert log["step"] == 3 and log["restored_equal"]
        q = log["shapes"]["trunk.dense_layers.0.attn.q.weight"]
        assert q == [whole["trunk.dense_layers.0.attn.q.weight"].shape[0],
                     whole["trunk.dense_layers.0.attn.q.weight"].shape[1] // 4]


def test_train_launcher_refuses_a_one_axis_mesh(no_plan):
    """``--mesh 4`` raises, naming ``--mesh 4x1`` (the reference's launcher
    fails there with ``KeyError: 'model'``), before any process group."""
    with pytest.raises(ValueError, match=r"--mesh 4x1"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--seq", "32", "--batch", "4",
                    "--mesh", "4", "--device", "cpu"])
