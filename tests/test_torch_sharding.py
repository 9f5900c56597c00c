"""The port's sharding rules (``repro_torch.parallel.sharding``) and
activation checks (``parallel.constraints``) against the reference's.

``param_specs``, ``batch_specs`` and ``cache_specs`` must equal the
reference's, as tuples, for all 15 configs at full size (``jax.eval_shape``
trees, no memory) on stub meshes of (4,1), (2,2), (1,4), (2,4) and (8,1)
(data x model), whose non-dividing dims take the per-dim fallback.  The
port-layout specs of smoke dense, moe, hybrid and ssm models must be the
reference's specs carried through ``convert``'s transposes and unstacking:
each leaf's reference array holds its own flat indices, so the converted
tensor says which reference dim each of its dims is.
"""
import functools
import re
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import ALL_ARCHS, get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs.shapes import INPUT_SHAPES, shape_applicable  # noqa: E402
from repro.launch import specs as JSPECS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, reference_layout  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import constraints as CT, sharding as SH  # noqa: E402

MESHES = [(4, 1), (2, 2), (1, 4), (2, 4), (8, 1)]


def _stub(shape):
    return SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape))


def _path_str(path) -> str:
    return "/".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)


def _flat(tree, is_leaf=None):
    return {_path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(config, parameter shapes, {shape name: batch or cache shapes})."""
    cfg = jget_config(arch)
    params = JSPECS.param_specs_shapes(cfg, ep_pad=16 if cfg.is_moe else 1)
    inputs = {}
    for name, shape in INPUT_SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        if shape.kind == "decode":
            d = JSPECS.decode_input_specs(cfg, shape)
            inputs[name] = ({"tokens": d["tokens"]}, d["caches"])
        else:
            inputs[name] = (JSPECS.input_specs(cfg, shape), None)
    return cfg, params, inputs


def _shapes(tree):
    return {k: (None if v is None else tuple(v.shape)) for k, v in tree.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_the_reference(arch, mesh):
    """Parameter, batch and decode-cache specs of each config at full size
    on each stub mesh: the port's tuples equal the reference's."""
    cfg, params, inputs = _trees(arch)
    stub, sizes = _stub(mesh), dict(zip(("data", "model"), mesh))
    want = {k: tuple(v) for k, v in _flat(JSH.param_specs(params, stub)).items()}
    assert SH.param_specs(_shapes(_flat(params)), sizes) == want
    for name, (batch, caches) in inputs.items():
        want_b = _flat(JSH.batch_specs(cfg, batch, stub), is_leaf=lambda x: x is None)
        got_b = SH.batch_specs(cfg, _shapes(_flat(batch)), sizes)
        assert got_b == {k: None if v is None else tuple(v) for k, v in want_b.items()}, name
        if caches is not None:
            want_c = {k: tuple(v) for k, v in _flat(JSH.cache_specs(cfg, caches, stub)).items()}
            assert SH.cache_specs(cfg, _shapes(_flat(caches)), sizes) == want_c, name


def test_fallbacks_are_exercised():
    """The stub meshes reach the per-dim fallback: whisper-small's vocabulary
    (51865) does not divide over a model axis of 2 or 4, so its table stays
    whole there (and is still split over data), the only leaf of the 15
    configs to fall back; long_500k's batch of one is replicated while its
    caches shard the sequence over data."""
    dropped = set()
    for arch in ALL_ARCHS:
        cfg, params, _ = _trees(arch)
        shapes = _shapes(_flat(params))
        for mesh in MESHES:
            specs = SH.param_specs(shapes, dict(zip(("data", "model"), mesh)))
            for path, spec in specs.items():
                rule = next(t for rx, t in SH._RULES + ((r"", ()),) if re.search(rx, path))
                if sum(t is not None for t in rule) > sum(a is not None for a in spec):
                    dropped.add((arch, mesh, path, spec))
    assert dropped == {("whisper-small", m, "embed/table", (None, "data"))
                       for m in ((2, 2), (1, 4), (2, 4))}
    cfg, _, inputs = _trees("zamba2-7b")
    batch, caches = inputs["long_500k"]
    assert SH.batch_specs(cfg, _shapes(_flat(batch)), {"data": 2, "model": 4}) == {
        "tokens": (None, None)}
    specs = SH.cache_specs(cfg, _shapes(_flat(caches)), {"data": 2, "model": 4})
    assert any("data" in s and s.index("data") == len(s) - 3 for s in specs.values())


def test_mesh_without_a_model_axis_names_dx1():
    """The reference raises ``KeyError: 'model'`` on a 1-D data mesh; the
    port refuses it with a ``ValueError`` that names the mesh ``Dx1``."""
    cfg, params, _ = _trees("llama3-8b")
    stub = SimpleNamespace(axis_names=("data",), devices=np.empty((4,)))
    with pytest.raises(KeyError, match="model"):
        JSH.param_specs(params, stub)
    with pytest.raises(ValueError, match=r"--mesh 4x1"):
        SH.param_specs(_shapes(_flat(params)), {"data": 4})
    with pytest.raises(ValueError, match=r"4x1"):
        SH.cache_specs(cfg, {}, {"data": 4})
    from repro_torch.launch import train
    with pytest.raises(ValueError, match=r"--mesh 4x1"):
        train.mesh_shape("4")


# ---------------------------------------------------------------------------
# the port's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b", "rwkv6-1.6b", "deepseek-moe-16b",
                                  "olmoe-1b-7b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_port_layout_specs_follow_convert(arch, mesh):
    """Each port leaf's spec (``port_specs`` of ``convert.reference_layout``)
    is the reference's spec of its leaf, dim by dim through ``convert``:
    the dims ``params_from_jax`` unstacks are dropped and a transposed
    ``w`` leaf's are reversed; the model axis is kept on the leaves
    ``TP_HELD`` names (attention's q, k, v and o, the MLPs, the shared and
    routed experts, E over ``model`` and d over ``data``, the embedding and
    the head), as ``place`` records it, attention by whole heads: k and v
    stay whole where the model axis does not divide the KV heads, all of
    attention where it does not divide the query heads; the router and the
    biases of ``o`` and ``down`` keep their dims whole, as the norms do.
    Split leaves have each dim divided by the size of the axis that splits
    it."""
    cfg = get_smoke_config(arch)
    jt = jax.eval_shape(lambda k: JM.init_params(jget_smoke(arch), k), jax.random.PRNGKey(0))
    jt = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jt)
    sizes = dict(zip(("data", "model"), mesh))
    ref = {k: tuple(v) for k, v in _flat(JSH.param_specs(jt, _stub(mesh))).items()}
    model = M.init_params(cfg, 0, device="cpu")
    layout = reference_layout(cfg, model)
    heads = (cfg.num_heads, cfg.num_kv_heads)
    got = SH.port_specs(layout, sizes, heads=heads)
    m = mesh[1]
    attn_whole = heads[0] % m or (heads[1] % m and (heads[0] // heads[1]) % (heads[0] // m))
    kv_whole = attn_whole or heads[1] % m
    idx_tree = jax.tree.map(lambda a: np.arange(a.size, dtype=np.int64).reshape(a.shape), jt)
    converted = params_from_jax(cfg, idx_tree)
    assert set(got) == set(converted) == set(model.state_dict())
    for name, t in converted.items():
        leaf = layout[name]
        ref_dims = leaf.shape
        full = ref[leaf.path] + (None,) * (len(ref_dims) - len(ref[leaf.path]))
        origin = np.unravel_index(int(t.reshape(-1)[0]), ref_dims)
        for d in range(t.ndim):
            if t.shape[d] == 1:
                continue
            step = np.unravel_index(int(t.select(d, 1).reshape(-1)[0]) if t.ndim > 1
                                    else int(t[1]), ref_dims)
            moved = [k for k in range(len(ref_dims)) if step[k] != origin[k]]
            assert len(moved) == 1, (name, d)
            want = full[moved[0]]
            held = ((re.search(r"\.attn\.[kv]\.(weight|bias)$", name) and not kv_whole)
                    or (re.search(r"\.attn\.(q\.(weight|bias)|o\.weight)$", name)
                        and not attn_whole)
                    or ".mlp." in name or ".moe.shared." in name
                    or name.endswith((".moe.gate", ".moe.up", ".moe.down"))
                    or name in ("embed.weight", "head.weight"))
            if want == "model" and not held:
                want = None
            assert got[name][d] == want, (name, d, got[name], full)
        local = SH.Placement(got, {a: Mesh(None, n, n - 1, a) for a, n in sizes.items()}
                             ).local(name, t)
        assert list(local.shape) == [n // (sizes[a] if a else 1)
                                     for n, a in zip(t.shape, got[name])], name
    if cfg.family in ("dense", "moe"):
        held = SH.place(layout, {"data": Mesh(None, mesh[0], 0, "data"),
                                 "model": Mesh(None, mesh[1], 0, "model")},
                        heads=heads).specs
        assert held == got


FAMILIES = ("whisper-small", "deepseek-v2-lite-16b", "qwen2-vl-72b")


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_port_specs_of_the_other_families_equal_the_reference(arch, mesh):
    """At full size (shapes only: the port's meta model, the reference's
    ``eval_shape`` tree) every port leaf of whisper-small, deepseek-v2-lite-16b
    and qwen2-vl-72b takes the reference's ``param_specs`` of its leaf, its
    stacked layer dims dropped and a ``w`` leaf's dims reversed, and nothing
    else: the model axis stays on every leaf the reference splits there
    (attention by whole heads, whisper's self- and cross-attention, MLA's q,
    ``kv_b`` and o, the MLPs and experts, the vocabulary).  Whisper's
    vocabulary of 51865 stays whole on ``model`` and its table's d splits
    over ``data``; its learned positions ``dec_pos`` split their 32768
    positions over ``data``; MLA's ``kv_a`` splits d over ``data`` alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import param_specs as port_model

    cfg, params, _ = _trees(arch)
    sizes = dict(zip(("data", "model"), mesh))
    ref = {k: tuple(v) for k, v in _flat(JSH.param_specs(params, _stub(mesh))).items()}
    pcfg = get_config(arch)
    layout = reference_layout(pcfg, port_model(pcfg, ep_pad=16 if pcfg.is_moe else 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # every attention splits by whole heads
        got = SH.port_specs(layout, sizes, heads=SH.heads_of(pcfg))
    assert set(got) == set(layout)
    for name, leaf in layout.items():
        spec = ref[leaf.path] + (None,) * (len(leaf.shape) - len(ref[leaf.path]))
        spec = spec[leaf.lead:]
        assert got[name] == (spec[::-1] if leaf.transposed else spec), name
    D, M_ = mesh
    if arch == "whisper-small":
        assert got["embed.weight"] == (None if M_ > 1 else "model", "data")
        assert got["dec_pos"] == ("data", None) and got["trunk.enc_pos"] == (None, None)
        for att in ("trunk.dec_layers.0.self_attn.", "trunk.dec_layers.0.cross_attn.",
                    "trunk.enc_layers.0.attn."):
            assert got[att + "q.weight"] == ("model", "data"), att
            assert got[att + "o.weight"] == ("data", "model") and got[att + "o.bias"] == (None,)
    if arch == "deepseek-v2-lite-16b":
        att = "trunk.moe_layers.0.attn."
        assert got[att + "kv_a.weight"] == (None, "data")
        assert got[att + "kv_b.weight"] == ("model", None)
        assert got[att + "kv_a_norm.scale"] == (None,)
        assert got["trunk.moe_layers.0.moe.gate"] == ("model", "data", None)


def test_placement_slices_and_gathers_back():
    """``Placement.local`` keeps rank r's slice of each split dim and
    ``full`` on a size-1 mesh is the tensor itself; ``place`` over a bare
    Mesh is the model axis alone; by the config's heads, k and v stay
    whole where the model axis does not divide the KV heads (warned
    once)."""
    cfg = get_smoke_config("llama3-8b")
    heads = (cfg.num_heads, cfg.num_kv_heads)
    model = M.init_params(cfg, 0, device="cpu")
    layout = reference_layout(cfg, model)
    # smoke llama3-8b's 4 query heads split over 2, its 1 KV head does not
    SH._WARNED.clear()
    with pytest.warns(RuntimeWarning, match="1 KV heads do not split over 2"):
        place = SH.place(layout, {"data": Mesh(None, 4, 2, "data"),
                                  "model": Mesh(None, 2, 1, "model")}, heads=heads)
    w = model.trunk.dense_layers[0].mlp.gate.weight.detach()
    name = "trunk.dense_layers.0.mlp.gate.weight"
    assert place.specs[name] == ("model", "data") and place.axes(name) == ("data", "model")
    local = place.local(name, w)
    f, d = w.shape[0] // 2, w.shape[1] // 4
    assert torch.equal(local, w[f:2 * f, 2 * d:3 * d])
    q = model.trunk.dense_layers[0].attn.q.weight.detach()
    qname = "trunk.dense_layers.0.attn.q.weight"
    assert place.specs[qname] == ("model", "data")
    hq = q.shape[0] // 2
    assert torch.equal(place.local(qname, q), q[hq:, 2 * d:3 * d])
    assert place.axes("ln_f.scale") == () and place.local("ln_f.scale", w) is w
    attn = "trunk.dense_layers.0.attn."
    assert place.dim(attn + "o.weight", "model") == 1
    assert place.axes(attn + "k.weight") == place.axes(attn + "v.weight") == ("data",)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # warned once a process
        bare = SH.place(layout, Mesh(None, 2, 0, "model"), heads=heads)
    assert set(bare.meshes) == {"model"} and bare.dim("embed.weight", "data") is None
    assert bare.dim(qname, "model") == 0 and bare.axes(attn + "k.weight") == ()
    one = SH.place(layout, {"data": Mesh(None), "model": Mesh(None)}, heads=heads)
    assert one.full(name, w) is w and one.axes(name) == ()


def test_placed_slices_own_their_storage():
    """A slice of dim 0 is contiguous as a view; kept as one, it would hold
    the whole parameter's storage alive on every rank (the experts' and the
    MLP's up rows: four times their bytes at 1x4).  Every parameter of a
    model placed at 1x4 and 2x2 holds exactly its own bytes, and a leaf
    that no axis splits stays the very tensor."""
    cfg = get_smoke_config("qwen2-vl-72b")
    for shape in ((1, 4), (2, 2)):
        model = M.init_params(cfg, 0, device="cpu")
        q = "trunk.dense_layers.0.attn.q.weight"
        whole = dict(model.named_parameters())
        meshes = {"data": Mesh(None, shape[0], shape[0] - 1, "data"),
                  "model": Mesh(None, shape[1], shape[1] - 1, "model")}
        place = SH.place(reference_layout(cfg, model), meshes, heads=SH.heads_of(cfg))
        assert place.local("ln_f.scale", whole["ln_f.scale"]) is whole["ln_f.scale"]
        for name, p in whole.items():
            t = place.local(name, p.detach())
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), (shape, name)
            assert t.is_contiguous(), (shape, name)
        assert place.axes(q) == (("data", "model") if shape[0] > 1 else ("model",))


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------

def test_constraints_identity_without_axes():
    x = torch.zeros(3, 4, 5)
    for fn in (CT.btd, CT.btf, CT.ecd, CT.logits):
        assert fn(x) is x
    assert CT.axes() is None


def test_constraints_check_the_local_batch():
    """With the axes, the mesh sizes and the global batch installed, an
    activation must hold this rank's share of the batch (divided by the
    trainer's microbatches); a wrong one raises, a right one is returned
    as it is.  A batch the data axis does not divide is whole on each rank
    (``batch_specs``' fallback); without sizes nothing is checked."""
    share = torch.zeros(2, 4, 5)
    with CT.use_axes(("data",), "model", sizes={"data": 4, "model": 2}, batch=8):
        assert CT.axes()["dp"] == ("data",)
        for fn in (CT.btd, CT.btf, CT.logits):
            assert fn(share) is share
            with pytest.raises(ValueError, match="share of the global batch 8"):
                fn(torch.zeros(8, 4, 5))
        assert CT.ecd(torch.zeros(8, 4, 5)).shape[0] == 8
        with CT.microbatches(2):
            assert CT.btd(share[:1]) is not None
            with pytest.raises(ValueError, match="in 2 microbatch"):
                CT.btd(share)
        assert CT.btd(torch.zeros(2, 1)).shape == (2, 1)          # not (B, S, D)
    with CT.use_axes(("data",), "model", sizes={"data": 4, "model": 1}, batch=6):
        assert CT.btd(torch.zeros(6, 1, 1)).shape[0] == 6
    with CT.use_axes(("data",), "model"):
        assert CT.btd(torch.zeros(7, 1, 1)).shape[0] == 7
    assert CT.axes() is None
