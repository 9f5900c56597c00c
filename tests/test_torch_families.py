"""The dense families of Lagom's Table 2 that the port serves, against
the JAX reference on the CPU in fp32: smoke
``phi2-2b`` (parallel block, LayerNorm, GELU MLP with biases, attention
biases, partial rotary), ``mpt-7b`` (ALiBi, LayerNorm, GELU, tied head),
``phi4-mini-3.8b`` (partial rotary, tied vocabulary), ``stablelm-3b``
(partial rotary, LayerNorm) and ``h2o-danube-1.8b`` (a sliding window of
16 in the smoke config, a ring of 16 slots).  Each is initialised in JAX
and converted through numpy.

Bounds: 1e-4 absolute for hidden states, logits and cached decode
(``BOUND`` of tests/test_torch_model.py); 5e-3 for decode against the full
forward (``PREFILL_DECODE_BOUND``, tests/test_models.py's).  Greedy tokens
must be equal.

The reference adds ALiBi only on its uncached path (ROADMAP.md, queue 3):
its cached prefill and decode of ``mpt-7b`` have no positions at all, which
``test_reference_cache_path_drops_alibi`` shows.  So ``mpt-7b``'s cached
routes are held against the reference's uncached forward instead, and its
engines against a greedy loop over that forward, with the last prompt
token fed twice as the engines feed it.

Last, the GELU ``tp_mlp`` and ``serve_mlp`` (biases included) on 2 and 4
``gloo`` ranks against the reference's ``tp_mlp``/``serve_mlp`` on 4 host
devices (a process with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``).
"""
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
from repro.models import model as JM  # noqa: E402
from repro.serving import make_engine as jmake_engine  # noqa: E402
from repro.serving.continuous import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving.types import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import ContinuousEngine, Request, make_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("phi2-2b", "mpt-7b", "phi4-mini-3.8b", "stablelm-3b", "h2o-danube-1.8b")
ALIBI = "mpt-7b"
BOUND = 1e-4
PREFILL_DECODE_BOUND = 5e-3
MAX_SEQ = 64                 # h2o-danube's smoke window is 16: a ring of 16 slots
B, PREFILL, DECODE = 2, 10, 26   # 36 positions: danube's ring wraps twice
LENS, MAX_NEW = (9, 14), 24      # engine prompts (<= the smoke window) and new tokens


@pytest.fixture(scope="module")
def fam(request):
    arch = request.param
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, tree))
    model.requires_grad_(False)
    return cfg, jcfg, jp, tree, model


def _np(a):
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("fam", ARCHS, indirect=True)
def test_params_round_trip_is_exact(fam):
    """Every leaf, biases (MLP, attention, LayerNorm) and the layers without
    ``ln2`` included, through ``params_from_jax`` and back, bit for bit."""
    cfg, _, _, tree, model = fam
    back = params_to_jax(cfg, model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(a, flat_b[path]), path
    layer = tree["trunk"]["dense_layers"]
    assert ("ln2" in layer) == (not cfg.parallel_block)
    assert ("b" in layer["mlp"]["up"]) == (cfg.mlp_kind == "gelu")
    assert ("bias" in layer["ln1"]) == (cfg.norm_kind == "layernorm")


@pytest.mark.parametrize("fam", ARCHS, indirect=True)
def test_forward_hidden_and_logits_match(fam):
    cfg, jcfg, jp, _, model = fam
    toks = _tokens(cfg, (B, 12), 1)
    jx = jax.jit(lambda p, t: JM.forward_hidden(jcfg, p, {"tokens": t})[0])(jp, toks)
    x, _, _ = M.forward_hidden(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert _err(x, jx) < BOUND
    jl = jax.jit(lambda p, x: JM._unembed(jcfg, p, x))(jp, jx)
    assert _err(M._unembed(cfg, model, x), jl) < BOUND


def _port_prefill_decode(cfg, model, toks, nxt):
    """Cached prefill of ``toks`` into fresh caches, then one decode step per
    column of ``nxt`` (the first step takes the last prompt token's
    successor, ``nxt[:, 0]``): (prefill hidden, per-step logits)."""
    caches = M.init_caches(cfg, B, MAX_SEQ, device="cpu")
    x, caches, _ = M.forward_hidden(cfg, model, {"tokens": torch.from_numpy(toks)}, caches)
    out = []
    for j in range(nxt.shape[1]):
        logits, caches = M.decode_step(cfg, model, torch.from_numpy(nxt[:, j:j + 1]), caches)
        out.append(logits[:, -1])
    return x, torch.stack(out, 1)


@pytest.mark.parametrize("fam", [a for a in ARCHS if a != ALIBI], indirect=True)
def test_prefill_decode_matches_reference_cached_path(fam):
    """Cached prefill, then decode steps past the smoke window (h2o-danube's
    ring of 16 slots wraps), against the reference's same calls."""
    cfg, jcfg, jp, _, model = fam
    toks, nxt = _tokens(cfg, (B, PREFILL), 2), _tokens(cfg, (B, DECODE), 3)
    x, logits = _port_prefill_decode(cfg, model, toks, nxt)

    @jax.jit
    def jrun(p, t, n):
        c = JM.init_caches(jcfg, B, MAX_SEQ)
        jx, c, _ = JM.forward_hidden(jcfg, p, {"tokens": t}, c)
        out = []
        for j in range(n.shape[1]):
            lg, c = JM.decode_step(jcfg, p, n[:, j:j + 1], c)
            out.append(lg[:, -1])
        return jx, jnp.stack(out, 1)

    jx, jlogits = jrun(jp, toks, nxt)
    assert _err(x, jx) < BOUND
    assert _err(logits, jlogits) < BOUND
    if cfg.sliding_window:
        assert cfg.sliding_window < PREFILL + DECODE
        assert M.init_caches(cfg, B, MAX_SEQ, device="cpu")[
            "trunk"]["dense_layers"]["k"].shape[2] == cfg.sliding_window


def test_mpt_cached_routes_match_the_uncached_forward():
    """mpt-7b: the port's cached prefill equals the reference's uncached
    forward within 1e-4, and each decode step's logits its full forward over
    the whole sequence so far within 5e-3."""
    cfg, jcfg = get_smoke_config(ALIBI), jget_smoke(ALIBI)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    toks, nxt = _tokens(cfg, (B, PREFILL), 2), _tokens(cfg, (B, 6), 3)
    x, logits = _port_prefill_decode(cfg, model, toks, nxt)
    full = np.concatenate([toks, nxt], axis=1)
    fwd = jax.jit(lambda p, t: JM._unembed(
        jcfg, p, JM.forward_hidden(jcfg, p, {"tokens": t})[0]))
    jx = jax.jit(lambda p, t: JM.forward_hidden(jcfg, p, {"tokens": t})[0])(jp, toks)
    assert _err(x, jx) < BOUND
    jl = fwd(jp, full)
    # step j takes nxt[:, j] at position PREFILL + j
    assert _err(logits, jl[:, PREFILL:]) < PREFILL_DECODE_BOUND


def test_reference_cache_path_drops_alibi():
    """The reference's fault that the port does not copy: mpt-7b's hidden
    states through its cache path differ from its uncached forward by more
    than 0.1 (its cache path adds no ALiBi term); the port's agree."""
    cfg, jcfg = get_smoke_config(ALIBI), jget_smoke(ALIBI)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    toks = _tokens(cfg, (B, 12), 0)
    plain = jax.jit(lambda p, t: JM.forward_hidden(jcfg, p, {"tokens": t})[0])(jp, toks)
    cached = jax.jit(lambda p, t: JM.forward_hidden(
        jcfg, p, {"tokens": t}, JM.init_caches(jcfg, B, 32))[0])(jp, toks)
    assert _err(plain, cached) > 0.1
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    t = torch.from_numpy(toks)
    px = M.forward_hidden(cfg, model, {"tokens": t})[0]
    pc = M.forward_hidden(cfg, model, {"tokens": t},
                          M.init_caches(cfg, B, 32, device="cpu"))[0]
    assert _err(px, plain) < BOUND and _err(pc, plain) < BOUND


def _prompts(cfg):
    rs = np.random.default_rng(4)
    return [rs.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]


def _serve(engine, req_cls, prompts):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(i, p, max_new=MAX_NEW))
    return [r.out for r in sorted(engine.run(), key=lambda r: r.rid)]


def _greedy_uncached(jcfg, jp, prompt, n):
    """n greedy tokens of the reference's uncached forward, the last prompt
    token fed twice (the engines' first decode step takes it again): one
    compiled forward over a fixed length, read at the last real position
    (causal, so the trailing zeros change nothing before it)."""
    width = len(prompt) + 1 + n
    fwd = jax.jit(lambda p, t: JM._unembed(jcfg, p, JM.forward_hidden(
        jcfg, p, {"tokens": t})[0]))
    seq, out = list(prompt) + [int(prompt[-1])], []
    for _ in range(n):
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(seq)] = seq
        t = int(np.argmax(np.asarray(fwd(jp, toks))[0, len(seq) - 1]))
        out.append(t)
        seq.append(t)
    return out


def _fixed_alone(jcfg, jp, prompts):
    """The reference's fixed engine serving each prompt alone (no pad gap)."""
    return [jmake_engine(jcfg, jp, mode="fixed", batch_size=1, max_seq=MAX_SEQ)
            .generate([p], max_new=MAX_NEW)[0] for p in prompts]


@pytest.mark.parametrize("fam", ["phi2-2b", "h2o-danube-1.8b", ALIBI], indirect=True)
def test_engines_match_the_reference(fam):
    """Both engines over ragged prompts of 9 and 14 tokens, 24 new tokens
    each (h2o-danube's ring wraps): the fixed engine's and the continuous
    engine's tokens equal the reference's engines' (mpt-7b: the greedy loop
    over the reference's uncached forward).  For h2o-danube the reference's
    engines serve each prompt alone: beside a longer prompt, their window
    loses the row's pad gap
    (``test_reference_engines_shorten_padded_windows``)."""
    cfg, jcfg, jp, _, model = fam
    prompts = _prompts(cfg)
    fixed = make_engine(cfg, model, mode="fixed", batch_size=B, max_seq=MAX_SEQ)
    got_fixed = fixed.generate(prompts, max_new=MAX_NEW)
    got_cont = _serve(ContinuousEngine(cfg, model, slots=B, max_seq=MAX_SEQ), Request,
                      prompts)
    if cfg.name == ALIBI:
        want = [_greedy_uncached(jcfg, jp, p, MAX_NEW) for p in prompts]
        assert got_fixed == want and got_cont == want
        return
    if cfg.sliding_window:
        want_fixed = _fixed_alone(jcfg, jp, prompts)
        want_cont = [_serve(JContinuous(jcfg, jp, slots=1, max_seq=MAX_SEQ), JRequest,
                            [p])[0] for p in prompts]
    else:
        want_fixed = jmake_engine(jcfg, jp, mode="fixed", batch_size=B,
                                  max_seq=MAX_SEQ).generate(prompts, max_new=MAX_NEW)
        want_cont = _serve(JContinuous(jcfg, jp, slots=B, max_seq=MAX_SEQ), JRequest,
                           prompts)
    assert got_fixed == want_fixed
    assert got_cont == want_cont


@pytest.mark.parametrize("engine", ["fixed", "continuous"])
def test_reference_engines_shorten_padded_windows(engine):
    """A fault of the reference's engines that the port does not copy: a
    right-padded row decodes on the padded counter (the fixed engine's
    shared one; the continuous engine's admit clamps each slot's top-level
    ``pos`` to its prompt's length but leaves the layers' caches at the
    padded length), so a sliding-window row beside a longer prompt masks
    its window, and writes its ring, a pad gap ahead, and drops that many
    prompt keys: its tokens depend on what it was batched with.  The
    port's rows decode at their true positions: served beside the longer
    prompt or alone, the same tokens."""
    arch = "h2o-danube-1.8b"
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    prompts = _prompts(cfg)
    if engine == "fixed":
        ref_pair = jmake_engine(jcfg, jp, mode="fixed", batch_size=B,
                                max_seq=MAX_SEQ).generate(prompts, max_new=MAX_NEW)
        ref_alone = _fixed_alone(jcfg, jp, prompts[:1])
        port_pair = make_engine(cfg, model, mode="fixed", batch_size=B,
                                max_seq=MAX_SEQ).generate(prompts, max_new=MAX_NEW)
        port_alone = make_engine(cfg, model, mode="fixed", batch_size=1,
                                 max_seq=MAX_SEQ).generate(prompts[:1], max_new=MAX_NEW)
    else:
        ref_pair = _serve(JContinuous(jcfg, jp, slots=B, max_seq=MAX_SEQ), JRequest,
                          prompts)
        ref_alone = _serve(JContinuous(jcfg, jp, slots=1, max_seq=MAX_SEQ), JRequest,
                           prompts[:1])
        port_pair = _serve(ContinuousEngine(cfg, model, slots=B, max_seq=MAX_SEQ),
                           Request, prompts)
        port_alone = _serve(ContinuousEngine(cfg, model, slots=1, max_seq=MAX_SEQ),
                            Request, prompts[:1])
    assert ref_pair[0] != ref_alone[0]
    assert port_pair[0] == port_alone[0] == ref_alone[0]


def test_ring_shorter_than_the_window_refuses_to_wrap():
    """A cache of fewer slots than the window (max_seq < window) is no ring:
    a position past it raises, for the int and the per-row positions."""
    cfg = get_smoke_config("h2o-danube-1.8b")
    model = M.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (B, 8), 5))
    caches = M.init_caches(cfg, B, 10, device="cpu")
    _, caches, _ = M.forward_hidden(cfg, model, {"tokens": toks}, caches)
    for _ in range(2):
        _, caches = M.decode_step(cfg, model, toks[:, :1], caches)
    with pytest.raises(ValueError, match="10 slots"):
        M.decode_step(cfg, model, toks[:, :1], caches)
    rows = dict(caches, pos=torch.tensor([9, 10]))
    with pytest.raises(ValueError, match="10 slots"):
        M.decode_step(cfg, model, toks[:, :1], rows)


# ---------------------------------------------------------------------------
# the GELU tensor-parallel MLP on gloo ranks against the reference's
# ---------------------------------------------------------------------------

D, F, TOKENS = 32, 64, (2, 8)

_PORT = r"""
import sys
import numpy as np, torch, torch.distributed as dist
rank, world, rdv, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import dense, layers as L

d = dict(np.load(inp))
mlp = L.MLP(d["uw"].shape[0], d["uw"].shape[1], "gelu")
with torch.no_grad():
    mlp.up.weight.copy_(torch.from_numpy(d["uw"].T))
    mlp.up.bias.copy_(torch.from_numpy(d["ub"]))
    mlp.down.weight.copy_(torch.from_numpy(d["dw"].T))
    mlp.down.bias.copy_(torch.from_numpy(d["db"]))
mesh = make_mesh()
shard = dense.shard_mlp(mlp, mesh)
x = torch.from_numpy(d["x"])
with torch.no_grad():
    res = {"tp": dense.tp_mlp(shard, x, "gelu", mesh).numpy(),
           "serve": dense.serve_mlp(shard, x, "gelu", mesh).numpy(),
           "plain": L.mlp(mlp, x, "gelu").numpy()}
# 7 rows split over neither 2 nor 4 ranks: tp_mlp runs column-then-row
torch.manual_seed(0)
swiglu = L.MLP(mlp.up.in_features, mlp.up.out_features, "swiglu")
for kind, whole in (("gelu", mlp), ("swiglu", swiglu)):
    for which, p in (("odd_tp", dense.shard_mlp(whole, mesh)), ("odd_plain", whole)):
        xo = x[:, :7].clone().requires_grad_()
        y = (dense.tp_mlp(p, xo, kind, mesh) if which == "odd_tp" else L.mlp(p, xo, kind))
        y.pow(2).sum().backward()
        res[f"{which}_{kind}"] = y.detach().numpy()
        res[f"{which}_{kind}_dx"] = xo.grad.numpy()
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
"""

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.models import dense, layers as L

inp, out = sys.argv[1:3]
d = dict(np.load(inp))
p = {"up": {"w": jnp.asarray(d["uw"]), "b": jnp.asarray(d["ub"])},
     "down": {"w": jnp.asarray(d["dw"]), "b": jnp.asarray(d["db"])}}
mesh = make_mesh((4,), ("model",))
x = jnp.asarray(d["x"])
res = {"tp": jax.jit(lambda p, x: dense.tp_mlp(p, x, "gelu", mesh))(p, x),
       "serve": jax.jit(lambda p, x: dense.serve_mlp(p, x, "gelu", mesh))(p, x),
       "plain": jax.jit(lambda p, x: L.mlp(p, x, "gelu"))(p, x)}
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def gelu_tp(tmp_path_factory):
    """The port's GELU MLP on 2 and on 4 gloo ranks and the reference's on 4
    host devices, concurrently, on one set of weights with nonzero biases;
    returns {"port2", "port4", "reference"} -> {"tp", "serve", "plain"}."""
    tmp = tmp_path_factory.mktemp("gelu_tp")
    rs = np.random.default_rng(7)
    f32 = np.float32
    inputs = {"uw": rs.standard_normal((D, F)).astype(f32) / np.sqrt(D),
              "ub": rs.standard_normal(F).astype(f32),
              "dw": rs.standard_normal((F, D)).astype(f32) / np.sqrt(F),
              "db": rs.standard_normal(D).astype(f32),
              "x": rs.standard_normal(TOKENS + (D,)).astype(f32)}
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = []
    for world in (2, 4):
        procs += [subprocess.Popen(
            [sys.executable, "-c", _PORT, str(r), str(world), str(tmp / f"rdv{world}"),
             str(tmp / "inputs.npz"), str(tmp / f"port{world}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.npz"),
         str(tmp / "reference.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    return {name: dict(np.load(tmp / f"{name}.npz"))
            for name in ("port2", "port4", "reference")}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn", ["tp", "serve"])
def test_gelu_tp_mlp_matches_reference(gelu_tp, world, fn):
    """``tp_mlp``/``serve_mlp`` with GELU: this rank's slice of ``up``'s bias
    before the GELU, ``down``'s bias once after the reduce-scatter; against
    the reference's helper on 4 devices and against the plain MLP."""
    port, ref = gelu_tp[f"port{world}"], gelu_tp["reference"]
    assert _err(port["plain"], ref["plain"]) < BOUND
    assert _err(port[fn], ref[fn]) < BOUND
    assert _err(port[fn], ref["plain"]) < BOUND


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_tp_mlp_runs_column_then_row_where_the_sequence_does_not_split(gelu_tp, world, kind):
    """``tp_mlp`` over 7 rows, which split over neither 2 nor 4 ranks: the
    whole sequence through this rank's hidden units, the rows summed over
    the ranks; its output and its input's gradient are the plain MLP's."""
    port = gelu_tp[f"port{world}"]
    for key in (kind, f"{kind}_dx"):
        assert _err(port[f"odd_tp_{key}"], port[f"odd_plain_{key}"]) < BOUND
