"""The port's models (``repro_torch.models``) against the JAX reference on
smoke ``llama3-8b``, ``zamba2-7b`` (also at 3 layers, which gives it a
tail after its one group) and ``rwkv6-1.6b`` in fp32: the same weights
(initialised in JAX, converted with ``convert.params_from_jax``) and the
same numpy inputs through both.  Bounds, all absolute in fp32: 1e-5 for RoPE, 1e-4
for attention outputs, caches and logits (the two frameworks sum matrix
products in different orders), and the reference's 5e-3 for its
prefill-then-decode check (tests/test_models.py)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config, get_smoke_config as jget_smoke  # noqa: E402
from repro.models import layers as JL, model as JM  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import layers as L, model as M  # noqa: E402

ARCH = "llama3-8b"
RECURRENT = {"zamba2-7b": 2, "zamba2-7b-tail": 3, "rwkv6-1.6b": 2}   # variant -> layers
ROPE_BOUND = 1e-5
BOUND = 1e-4
PREFILL_DECODE_BOUND = 5e-3     # tests/test_models.py::test_prefill_decode_matches_full_forward


@pytest.fixture(scope="module")
def pair():
    cfg = get_smoke_config(ARCH)
    jcfg = jget_smoke(ARCH)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, tree))
    model.requires_grad_(False)
    return cfg, jp, tree, model


def _np(a):
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def _close(a, b, bound):
    err = float(np.abs(_np(a) - _np(b)).max())
    assert err < bound, err


def test_configs_match_the_reference():
    """All 15 architectures, full and smoke, and the input shapes."""
    from repro.configs import ALL_ARCHS as JALL, INPUT_SHAPES as JSHAPES
    from repro_torch.configs import INPUT_SHAPES

    assert ALL_ARCHS == JALL and len(ALL_ARCHS) == 15
    for arch in ALL_ARCHS:
        for get, jget in ((get_config, jget_config), (get_smoke_config, jget_smoke)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert ({k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in JSHAPES.items()})
    for get in (get_config, jget_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("gpt-5")


def test_params_round_trip(pair):
    cfg, _, tree, model = pair
    back = params_to_jax(cfg, model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(a, flat_b[path]), path
    assert model.trunk.dense_layers[1].attn.q.weight.shape == (cfg.q_dim, cfg.d_model)


def test_apply_rope(pair):
    cfg = pair[0]
    rs = np.random.default_rng(0)
    B, S, h = 2, 9, cfg.head_dim
    q = rs.standard_normal((B, S, cfg.num_heads, h)).astype(np.float32)
    k = rs.standard_normal((B, S, cfg.num_kv_heads, h)).astype(np.float32)
    pos = (np.arange(S)[None] + np.array([[0], [37]])).astype(np.int32)
    jq, jk = JL.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                           head_dim=h, theta=cfg.rope_theta)
    tq, tk = L.apply_rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos),
                          head_dim=h, theta=cfg.rope_theta)
    _close(tq, jq, ROPE_BOUND)
    _close(tk, jk, ROPE_BOUND)


def _layer0(pair):
    cfg, jp, _, model = pair
    return cfg, jax.tree.map(lambda a: a[0], jp["trunk"]["dense_layers"])["attn"], \
        model.trunk.dense_layers[0].attn


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _pos(B, S, t0=0):
    return np.broadcast_to(t0 + np.arange(S, dtype=np.int32)[None], (B, S)).copy()


def _jattention(p, cfg, x, pos, cache=None):
    return jax.jit(lambda p, x, pos, c: JL.attention(p, cfg, x, pos, cache=c))(p, x, pos, cache)


def test_attention_without_cache(pair):
    cfg, jattn, tattn = _layer0(pair)
    x, pos = _x(cfg, 2, 24, 1), _pos(2, 24)
    jo, _ = _jattention(jattn, cfg, jnp.asarray(x), jnp.asarray(pos))
    to, tc = L.attention(tattn, cfg, torch.from_numpy(x), torch.from_numpy(pos).long())
    assert tc is None
    _close(to, jo, BOUND)


def _jcache(cfg, B, W):
    return JL.init_kv_cache(cfg, B, W)


def _tcache(cfg, B, W):
    return L.init_kv_cache(cfg, B, W)


def _close_cache(tc, jc):
    _close(tc["k"], jc["k"], BOUND)
    _close(tc["v"], jc["v"], BOUND)
    assert np.array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    assert tc["pos"] == int(jc["pos"])


def test_attention_cached_prefill_then_decode_with_holes(pair):
    """Cached prefill at pos 0, then one decode step after invalidating row 0's
    right-padded slots (slot_pos = -1), as the fixed engine does."""
    cfg, jattn, tattn = _layer0(pair)
    B, S, W = 2, 16, 32
    x, pos = _x(cfg, B, S, 2), _pos(B, S)
    jo, jc = _jattention(jattn, cfg, jnp.asarray(x), jnp.asarray(pos), _jcache(cfg, B, W))
    to, tc = L.attention(tattn, cfg, torch.from_numpy(x), torch.from_numpy(pos).long(),
                         cache=_tcache(cfg, B, W))
    _close(to, jo, BOUND)
    _close_cache(tc, jc)

    lens = np.array([11, 16])
    hole = np.arange(W)[None, :] >= lens[:, None]
    jc = dict(jc, slot_pos=jnp.where(jnp.asarray(hole), -1, jc["slot_pos"]))
    tc["slot_pos"].masked_fill_(torch.from_numpy(hole), -1)
    x1 = _x(cfg, B, 1, 3)
    pos1 = np.array([[S - (S - 11)], [S]], np.int32)      # row 0 keeps its true position
    jo, jc = _jattention(jattn, cfg, jnp.asarray(x1), jnp.asarray(pos1), jc)
    to, tc = L.attention(tattn, cfg, torch.from_numpy(x1), torch.from_numpy(pos1).long(),
                         cache=tc)
    _close(to, jo, BOUND)
    _close_cache(tc, jc)


def test_cached_prefill_into_nonempty_cache_raises(pair):
    cfg, _, tattn = _layer0(pair)
    cache = dict(_tcache(cfg, 1, 32), pos=4)
    with pytest.raises(NotImplementedError, match="non-empty cache"):
        L.attention(tattn, cfg, torch.zeros(1, 3, cfg.d_model), torch.zeros(1, 3).long(),
                    cache=cache)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_forward_hidden_logits(pair):
    cfg, jp, _, model = pair
    toks = _tokens(cfg, 2, 32)
    jx, jcaches, _ = jax.jit(lambda p, t: JM.forward_hidden(cfg, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tx, tcaches, aux = M.forward_hidden(cfg, model, {"tokens": torch.from_numpy(toks).long()})
        tlogits = M._unembed(cfg, model, tx)
    assert jcaches is None and tcaches is None and float(aux) == 0.0
    assert tx.shape == (2, 32, cfg.d_model)
    _close(tlogits, JM._unembed(cfg, jp, jx), BOUND)


def test_prefill_then_decode_matches_full_forward(pair):
    """tests/test_models.py's cache-consistency check, on the port, and the
    port's decode logits against the reference's."""
    cfg, jp, _, model = pair
    B, S = 2, 12
    toks = _tokens(cfg, B, S, seed=5)
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        x, _, _ = M.forward_hidden(cfg, model, {"tokens": tt})
        full = M._unembed(cfg, model, x)[:, -1]
        caches = M.init_caches(cfg, B, 32, device="cpu")
        _, caches, _ = M.forward_hidden(cfg, model, {"tokens": tt[:, :S - 1]}, caches)
        logits, caches = M.decode_step(cfg, model, tt[:, S - 1:], caches)
    assert caches["pos"] == S and logits.shape == (B, 1, cfg.vocab_size)
    _close(logits[:, 0], full, PREFILL_DECODE_BOUND)

    @jax.jit
    def jax_prefill_decode(p, t):
        c = JM.init_caches(cfg, B, 32)
        _, c, _ = JM.forward_hidden(cfg, p, {"tokens": t[:, :S - 1]}, c)
        return JM.decode_step(cfg, p, t[:, S - 1:], c)[0]
    jlogits = jax_prefill_decode(jp, jnp.asarray(toks))
    _close(logits, jlogits, BOUND)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_registered_archs_build_or_name_their_slice(arch):
    """Every registered config builds at smoke size (a model the port could
    not run would raise at build, naming the slice that brings it; since
    the other-families slice none does)."""
    model = M.init_params(get_smoke_config(arch), 0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


# the variants of the other-families slice, on smoke llama3-8b's widths
# (head_dim 64: M-RoPE's sections sum to 32, as smoke qwen2-vl-72b's)
OTHER_VARIANTS = {
    "mla": dict(attn_kind="mla", kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16),
    "audio": dict(family="audio", pos_kind="learned", encoder_layers=1, encoder_seq=16),
    "mrope": dict(family="vlm", pos_kind="mrope", mrope_sections=(12, 10, 10)),
    "learned": dict(pos_kind="learned"),
}


@pytest.mark.parametrize("change", list(OTHER_VARIANTS.values()), ids=list(OTHER_VARIANTS))
def test_unported_variants_raise(change):
    """The name is kept only to keep the count of tests: these variants no
    longer raise where it says.  They raised at build before the
    other-families slice and build now (``test_ported_variants_build_and_run`` runs them), and since
    their placement they place on a mesh too (over a fake world of 4 ranks
    at 1x4: their attention split by heads); what still raises of them is
    serving a cache on a model placed over ``model``, which names its
    ROADMAP item."""
    from repro_torch.launch.mesh import fake_world, make_mesh

    cfg = get_smoke_config(ARCH).replace(**change)
    model = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int64)}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((2, cfg.encoder_seq, cfg.d_model))
    with fake_world(4):
        M.shard_(cfg, model, make_mesh((1, 4), ("data", "model")))
    held = dict(model.named_parameters())
    q = next(n for n in held if n.endswith("attn.q.weight"))
    assert model.placement.axes(q) == ("model",) and held[q].shape[0] * 4 == (
        cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                         if cfg.attn_kind == "mla" else cfg.head_dim))
    with pytest.raises(ValueError, match="queue 1 item 8"):
        M.forward_hidden(cfg, model, batch, M.init_caches(cfg, 2, 16, device="cpu"))


@pytest.mark.parametrize("change", [dict(sliding_window=16), dict(mlp_kind="gelu"),
                                    dict(pos_kind="alibi"), dict(parallel_block=True),
                                    dict(pos_kind="alibi", sliding_window=16),
                                    *OTHER_VARIANTS.values()],
                         ids=["sliding_window", "gelu", "alibi", "parallel_block",
                              "alibi+window", *OTHER_VARIANTS])
def test_ported_variants_build_and_run(change):
    """The variants the dense families' slice and the other-families slice
    ported (they raised before): the model builds, runs a forward, a cached
    prefill and a decode step, with finite outputs of the expected shapes
    (an audio model with its frames).  Their numbers are held to the
    reference in tests/test_torch_families.py and
    tests/test_torch_other_families.py."""
    cfg = get_smoke_config(ARCH).replace(**change)
    model = M.init_params(cfg, 0, device="cpu")
    rs = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rs.integers(0, cfg.vocab_size, (2, 12)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rs.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    x, _, _ = M.forward_hidden(cfg, model, batch)
    assert x.shape == (2, 12, cfg.d_model) and bool(torch.isfinite(x).all())
    caches = M.init_caches(cfg, 2, 32, device="cpu")
    xc, caches, _ = M.forward_hidden(cfg, model, batch, caches)
    _close(xc, x, BOUND)
    logits, _ = M.decode_step(cfg, model, batch["tokens"][:, -1:], caches)
    assert logits.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the recurrent families: zamba2 (hybrid) and rwkv6 (ssm)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(RECURRENT))
def rpair(request):
    arch = request.param.replace("-tail", "")
    n = RECURRENT[request.param]
    cfg = get_smoke_config(arch).replace(num_layers=n)
    jcfg = jget_smoke(arch).replace(num_layers=n)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jp)
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, tree))
    model.requires_grad_(False)
    return cfg, jp, tree, model


def test_recurrent_params_round_trip(rpair):
    """Every leaf of the reference's tree survives params_from_jax and back;
    raw matrices keep the reference's (d_in, d_out) layout, linears are
    transposed, and the nested stacks land on the right modules."""
    cfg, _, tree, model = rpair
    back = params_to_jax(cfg, model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(a, flat_b[path]), path
    t, D = tree["trunk"], cfg.d_model
    if cfg.family == "ssm":
        tm, jtm = model.trunk.layers[1].tm, t["layers"]["tm"]
        for name, shape in (("maa_w1", (D, 160)), ("maa_w2", (5, 32, D)),
                            ("decay_w1", (D, 64)), ("decay_w2", (64, D)), ("Wr", (D, D))):
            assert tuple(getattr(tm, name).shape) == shape
            assert np.array_equal(getattr(tm, name).numpy(), jtm[name][1]), name
        cm = model.trunk.layers[0].cm
        assert tuple(cm.Wk.shape) == (D, cfg.d_ff) and tuple(cm.Wv.shape) == (cfg.d_ff, D)
        assert np.array_equal(cm.Wv.numpy(), t["layers"]["cm"]["Wv"][0])
    else:
        every, groups, tail = cfg.shared_attn_every, cfg.num_layers // 2, cfg.num_layers % 2
        assert len(model.trunk.groups) == groups and len(model.trunk.groups[0]) == every
        mb, jmb = model.trunk.groups[0][1].mamba, t["groups"]["mamba"]
        assert np.array_equal(mb.xbc_proj.weight.numpy(), jmb["xbc_proj"]["w"][0, 1].T)
        assert np.array_equal(mb.conv_w.numpy(), jmb["conv_w"][0, 1])     # (K, C)
        assert np.array_equal(model.trunk.app_in[0].weight.numpy(), t["app_in"]["w"][0].T)
        assert tuple(model.trunk.app_in[0].weight.shape) == (D, 2 * D)
        if tail:
            assert np.array_equal(model.trunk.tail[0].mamba.A_log.numpy(),
                                  t["tail"]["mamba"]["A_log"][0])
        else:
            assert not hasattr(model.trunk, "tail")


def test_recurrent_forward_hidden(rpair):
    """forward_hidden at S = 40, not a chunk multiple of either scan."""
    cfg, jp, _, model = rpair
    toks = _tokens(cfg, 2, 40, seed=3)
    jx, _, _ = jax.jit(lambda p, t: JM.forward_hidden(cfg, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tx, tcaches, aux = M.forward_hidden(cfg, model, {"tokens": torch.from_numpy(toks).long()})
    assert tcaches is None and float(aux) == 0.0 and tx.shape == (2, 40, cfg.d_model)
    _close(tx, jx, BOUND)


def _close_tree(tc, jc, bound):
    for name, a in tc.items():
        if isinstance(a, dict):
            _close_tree(a, jc[name], bound)
        elif name == "pos":
            assert a == int(np.asarray(jc[name]).reshape(-1)[0]), name
        elif name == "slot_pos":
            assert np.array_equal(a.numpy(), np.asarray(jc[name])), name
        else:
            assert a.shape == jc[name].shape, name
            _close(a, jc[name], bound)


def test_recurrent_prefill_then_decode(rpair):
    """A cached prefill of 21 tokens and three decode steps: the port's
    logits and caches (conv carries, SSD and WKV states, token shifts, the
    shared attention's KV caches) against the reference's."""
    cfg, jp, _, model = rpair
    B, S, W = 2, 21, 32
    toks = _tokens(cfg, B, S + 3, seed=4)

    @jax.jit
    def jax_run(p, t):
        c = JM.init_caches(cfg, B, W)
        _, c, _ = JM.forward_hidden(cfg, p, {"tokens": t[:, :S]}, c)
        out = []
        for j in range(3):
            logits, c = JM.decode_step(cfg, p, t[:, S + j:S + j + 1], c)
            out.append(logits)
        return out, c
    jlogits, jc = jax_run(jp, jnp.asarray(toks))

    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        c = M.init_caches(cfg, B, W, device="cpu")
        _, c, _ = M.forward_hidden(cfg, model, {"tokens": tt[:, :S]}, c)
        for j in range(3):
            logits, c = M.decode_step(cfg, model, tt[:, S + j:S + j + 1], c)
            assert logits.shape == (B, 1, cfg.vocab_size)
            _close(logits, jlogits[j], BOUND)
    assert c["pos"] == S + 3
    _close_tree(c["trunk"], jc["trunk"], BOUND)


def test_rwkv6_trunk_updates_the_wkv_cache_in_place(monkeypatch):
    """A cached prefill of 21 tokens and two decode steps of smoke rwkv6: every
    WKV6 call writes its layer's state into that layer's slice of the cache
    (the state it is given, returned as the new state), the stacked cache
    stays the same tensor, and its values are the reference's."""
    from repro_torch.models import rwkv6

    arch, n = "rwkv6-1.6b", RECURRENT["rwkv6-1.6b"]
    cfg, jcfg = get_smoke_config(arch).replace(num_layers=n), jget_smoke(arch).replace(num_layers=n)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(5))
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    model.requires_grad_(False)
    B, S, W = 2, 21, 32
    toks = _tokens(cfg, B, S + 2, seed=6)

    @jax.jit
    def jax_run(p, t):
        c = JM.init_caches(cfg, B, W)
        _, c, _ = JM.forward_hidden(cfg, p, {"tokens": t[:, :S]}, c)
        for j in range(2):
            _, c = JM.decode_step(cfg, p, t[:, S + j:S + j + 1], c)
        return c
    jc = jax_run(jp, jnp.asarray(toks))

    seen, wkv6 = [], rwkv6.ops.wkv6

    def spy(*args, out_state=None, **kw):
        y, st = wkv6(*args, out_state=out_state, **kw)
        assert out_state is not None and st is out_state and args[5] is out_state
        seen.append(st.data_ptr())
        return y, st

    monkeypatch.setattr(rwkv6.ops, "wkv6", spy)
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        c = M.init_caches(cfg, B, W, device="cpu")
        wkv = c["trunk"]["layers"]["wkv"]
        _, c, _ = M.forward_hidden(cfg, model, {"tokens": tt[:, :S]}, c)
        for j in range(2):
            _, c = M.decode_step(cfg, model, tt[:, S + j:S + j + 1], c)
    assert c["trunk"]["layers"]["wkv"] is wkv
    assert seen == [wkv[i].data_ptr() for i in range(n)] * 3
    _close(wkv, jc["trunk"]["layers"]["wkv"], BOUND)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [1, 21])
def test_mamba2_block_updates_its_state_in_place(groups, S):
    """One cached call of the port's Mamba2 block against the reference's, with
    B and C read per group (G = 1 and 2 at the smoke config's 4 heads): the
    same output, conv carry and SSD state.  The new state is written into the
    cache's own tensor, which the block returns; the conv carry is a new
    tensor and the cache's carry is left as it was."""
    from repro.models import mamba2 as jmamba2
    from repro_torch.models import mamba2

    cfg = get_smoke_config("zamba2-7b").replace(ssm_groups=groups)
    jcfg = jget_smoke("zamba2-7b").replace(ssm_groups=groups)
    jp = jmamba2.init_block(jax.random.PRNGKey(2), jcfg)
    block = mamba2.Block(cfg)
    block.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    block.requires_grad_(False)
    H, P, N = cfg.ssm_heads, mamba2.head_p(cfg), cfg.ssm_state
    rs = np.random.default_rng(S + groups)
    x = rs.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    conv = rs.standard_normal((2, cfg.conv_kernel - 1, mamba2.conv_channels(cfg))).astype(np.float32)
    state = rs.standard_normal((2, H, P, N)).astype(np.float32)
    jout, jc = jmamba2.block_fwd(jp, jcfg, jnp.asarray(x),
                                 {"conv": jnp.asarray(conv), "state": jnp.asarray(state)})
    cache = {"conv": torch.from_numpy(conv.copy()), "state": torch.from_numpy(state.copy())}
    with torch.no_grad():
        out, nc = mamba2.block_fwd(block, cfg, torch.from_numpy(x), cache)
    assert nc["state"] is cache["state"] and nc["conv"] is not cache["conv"]
    assert np.array_equal(cache["conv"].numpy(), conv)
    _close(out, jout, BOUND)
    _close(nc["conv"], jc["conv"], BOUND)
    _close(nc["state"], jc["state"], BOUND)
