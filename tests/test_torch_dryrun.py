"""The port's dry run (``repro_torch.launch.dryrun`` and ``launch.specs``)
and the kernels' fake route (``repro_torch.kernels.ops``) it runs on.

Tolerance: exact equality throughout.  Parameter counts are held to the
reference's ``param_specs_shapes`` (``jax.eval_shape``) on the same config.
The records run llama3-8b's step at 2 layers (the config's widths; depth
cut, as the record says) on the 16 × 16 production mesh over a fake world
of 256 ranks, and their collective bytes are held to a count this file
makes from the config and the placement, term by term.
"""
import math
import warnings

import jax
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS, get_config as j_config
from repro.launch import specs as JSPEC
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SPEC
from repro_torch.launch.mesh import fake_world

# the families placed last (ROADMAP.md, queue 1 item 8.1): they train and
# prefill placed; their decode, a cache on a placed model, is item 8.3
FAMILY_LATER = {"whisper-small", "qwen2-vl-72b", "deepseek-v2-lite-16b"}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def _ref_params(cfg) -> int:
    pad = 16 if cfg.is_moe else 1
    return sum(math.prod(a.shape)
               for a in jax.tree.leaves(JSPEC.param_specs_shapes(cfg, ep_pad=pad)))


# ---------------------------------------------------------------------------
# specs: the reference's parameter counts, with no allocation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_matches_the_reference(arch):
    cfg = get_config(arch)
    shapes = SPEC.param_specs_shapes(cfg, ep_pad=16 if cfg.is_moe else 1)
    assert sum(math.prod(s) for s in shapes.values()) == _ref_params(j_config(arch))


def _ref_params_rank(cfg, mesh) -> int:
    """A rank's parameters under the reference's ``param_specs`` on a
    (data, model) mesh of ``mesh`` sizes (its per-dim fallback included)."""
    import numpy as np
    from types import SimpleNamespace

    from repro.parallel import sharding as JSH

    pad = 16 if cfg.is_moe else 1
    shapes = JSPEC.param_specs_shapes(cfg, ep_pad=pad)
    stub = SimpleNamespace(axis_names=("data", "model"), devices=np.empty(mesh))
    sizes = dict(zip(("data", "model"), mesh))
    specs = jax.tree.leaves(JSH.param_specs(shapes, stub),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), specs):
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        total += math.prod(n // (sizes[a] if a else 1) for n, a in zip(leaf.shape, spec))
    return total


@pytest.mark.parametrize("arch", sorted(FAMILY_LATER))
def test_param_specs_of_a_later_family_raise_naming_the_slice(arch, tmp_path):
    """The name is kept only to keep the count of tests: placing these
    families no longer raises.  Their specs build (their counts are held
    above) and, since their placement, place as the dry run places them: a training
    step at 2 layers records ``ok`` on the hybrid4 mesh (16 x 4 x 4: FSDP
    over 64 ranks, tensor parallelism over 4, which splits every family's
    heads), each rank holding the parameters the reference's
    ``param_specs`` give it (whisper's vocabulary of 51865 whole on
    ``model``, as the reference's per-dim fallback keeps it)."""
    assert arch in J_ARCHS
    rec = DR.run_one(arch, "train_4k", False, out_dir=str(tmp_path), layers=L,
                     sharding="hybrid4")
    assert rec["status"] == "ok", rec.get("error")
    jcfg = j_config(arch).replace(num_layers=L, dtype="bfloat16")
    assert rec["params"] == _ref_params(jcfg)
    assert rec["params_rank"] == _ref_params_rank(jcfg, (64, 4))
    assert rec["flops"] > 0 and rec["collectives"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", sorted(FAMILY_LATER))
def test_decode_of_a_later_family_is_an_error_naming_item_8(arch, tmp_path):
    """Their decode shapes stay ``error`` records: a model placed over
    ``model`` serves no cache (ROADMAP.md, queue 1 item 8)."""
    rec = DR.run_one(arch, "decode_32k", False, out_dir=str(tmp_path), layers=L)
    assert rec["status"] == "error"
    assert "queue 1 item 8" in rec["error"]


def test_specs_allocate_nothing():
    cfg = get_config("llama3-8b")
    from repro_torch.configs import INPUT_SHAPES

    batch = SPEC.input_specs(cfg, INPUT_SHAPES["train_4k"])
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in batch.items()} == {
        "tokens": ((256, 4096), torch.int32, "meta"),
        "targets": ((256, 4096), torch.int32, "meta"),
        "mask": ((256, 4096), torch.float32, "meta")}
    dec = SPEC.decode_input_specs(cfg, INPUT_SHAPES["decode_32k"], "bfloat16")
    assert dec["tokens"].shape == (128, 1)
    kv = list(DR._tensors(dec["caches"]["trunk"]))
    assert kv and all(t.device.type == "meta" for t in kv)
    assert any(t.dtype == torch.bfloat16 and 32768 in t.shape for t in kv)


# ---------------------------------------------------------------------------
# the kernels' fake route: the plain versions' shapes and dtypes, no launch
# ---------------------------------------------------------------------------

def _flash(window=0):
    def run(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, window=window)

    def plain(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window)
    return run, plain


def _grads(fn, *inputs):
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    fn(*inputs).float().sum().backward()
    return tuple(t.grad for t in inputs)


def _shapes(out):
    if isinstance(out, (tuple, list)):
        return [_shapes(o) for o in out]
    return (tuple(out.shape), out.dtype)


def _case_inputs(name):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    if name.startswith("rmsnorm"):
        return (r(2, 5, 64, dtype=torch.bfloat16), r(64))
    if name.startswith("flash"):
        return (r(2, 16, 4, 32), r(2, 16, 2, 32), r(2, 16, 2, 32))
    if name.startswith("ssd"):
        S = 1 if name.endswith("decode") else 9
        return (r(1, S, 4, 16), r(1, S, 4).abs(), -r(4).abs(), r(1, S, 2, 16),
                r(1, S, 2, 16), r(4), r(1, 4, 16, 16))
    S = 1 if name.endswith("decode") else 9
    return (r(1, S, 2, 16), r(1, S, 2, 16), r(1, S, 2, 32), -r(1, S, 2, 16).abs(),
            r(2, 16), r(1, 2, 16, 32))


FAKE_CASES = {
    "rmsnorm": (lambda x, s: ops.rmsnorm(x, s), lambda x, s: ref.rmsnorm_ref(x, s)),
    "rmsnorm_bwd": (lambda x, s: _grads(ops.rmsnorm, x, s),
                    lambda x, s: _grads(ref.rmsnorm_ref, x, s)),
    "flash": _flash(),
    "flash_window": _flash(window=5),
    "flash_bwd": (lambda *a: _grads(_flash()[0], *a), lambda *a: _grads(_flash()[1], *a)),
    "ssd": (lambda *a: ops.ssd(*a[:6], a[6]), lambda *a: ops.ssd(*a[:6], a[6])),
    "ssd_decode": (lambda *a: ops.ssd(*a[:6], a[6]), lambda *a: ops.ssd(*a[:6], a[6])),
    "wkv6": (lambda *a: ops.wkv6(*a[:5], a[5]), lambda *a: ops.wkv6(*a[:5], a[5])),
    "wkv6_decode": (lambda *a: ops.wkv6(*a[:5], a[5]), lambda *a: ops.wkv6(*a[:5], a[5])),
}


@pytest.mark.parametrize("name", sorted(FAKE_CASES))
def test_fake_route_gives_the_plain_versions_shapes(name):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    fake_fn, plain_fn = FAKE_CASES[name]
    inputs = _case_inputs(name)
    want = _shapes(plain_fn(*inputs))
    launches, flops = dict(ops.LAUNCHES), dict(ops.FAKE_FLOPS)
    with FakeTensorMode() as mode:
        got = fake_fn(*(mode.from_tensor(t) for t in inputs))
    leaves = got if isinstance(got, tuple) else (got,)
    assert all(isinstance(t, FakeTensor) for t in leaves)
    assert _shapes(got) == want
    assert ops.LAUNCHES == launches                   # no launch
    assert ops.FAKE_FLOPS != flops                    # the work is counted


def test_fake_route_refuses_what_the_card_refuses():
    from torch._subclasses.fake_tensor import FakeTensorMode

    q, k, v = (t.to(torch.bfloat16) for t in _case_inputs("flash"))
    with FakeTensorMode() as mode:
        q, k, v = (mode.from_tensor(t) for t in (q, k, v))
        with pytest.raises(ValueError, match="ALiBi kernels are built for fp32"):
            ops.flash_attention(q, k, v, alibi_slopes=torch.ones(4))


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------

L, M, D_AX = 2, 16, 16          # depth cut; the model and data axes of 16 x 16


def _llama_terms(shape_name):
    """(rows, bf16 bytes of one (rows, S, D) activation, of its sequence
    shard, the FSDP slices (local, gathered) of one layer, of the embedding
    or the head) for llama3-8b on 16 × 16: the data axis splits every D dim
    (F), the model axis q's and o's heads, the MLP's hidden units and the
    vocabulary (T); 8 KV heads do not split over 16 ranks, so k and v stay
    whole on model."""
    cfg = get_config("llama3-8b")
    from repro_torch.configs import INPUT_SHAPES

    shape = INPUT_SHAPES[shape_name]
    B, S, D, Fh, V = shape.global_batch // D_AX, shape.seq_len, cfg.d_model, cfg.d_ff, \
        cfg.vocab_size
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    b = 2
    local = [qh // M * D // D_AX, kvh * D // D_AX, kvh * D // D_AX, D // D_AX * qh // M,
             Fh // M * D // D_AX, Fh // M * D // D_AX, D // D_AX * Fh // M]
    layer_local = sum(local) * b
    emb_local = V // M * D // D_AX * b
    return dict(B=B, S=S, D=D, act=B * S * D * b, shard=B * S // M * D * b,
                layer_local=layer_local, layer_gathered=layer_local * D_AX,
                emb_local=emb_local, emb_gathered=emb_local * D_AX,
                kv_whole=kvh * D * b)


def expected_prefill(t):
    """Forward only, no remat: the embedding's and the head's gathers and
    the embedding's all-reduce; a layer's weights gathered once, attention's
    all-reduce, the two rings (gate, up) of 15 hops of the sequence shard,
    one reduce-scatter (no plan: 1 chunk) and the output's gather."""
    ag = 2 * t["emb_gathered"] + L * (t["layer_gathered"] + t["act"])
    return {"all-gather": ag, "all-reduce": (1 + L) * t["act"],
            "reduce-scatter": L * t["shard"], "all-to-all": 0,
            "collective-permute": L * 2 * (M - 1) * t["shard"],
            "count": 3 + L * (7 + 1 + 2 * (M - 1) + 1 + 1)}


def expected_train(t):
    """One step at grad_accum 1 with remat: a layer's forward runs twice
    (the recompute stops at its last saved tensor, so the MLP output's
    gather runs once); the backward adds the FSDP gradients'
    reduce-scatters, the rings' backwards (a chunked reduce-scatter of dx
    and a second ring for dw), the matmul-reduce-scatter's gather of dy,
    the sequence slice's gather, attention's input all-reduce and the whole
    k and v weights' gradient all-reduces over model.  Outside the layers:
    the embedding's and the head's gathers and gradient reduce-scatters,
    the embedding's all-reduce and the loss's input all-reduce, 16 loss
    chunks twice of two fp32 all-reduces ((B, 256) max, (2, B, 256) sums),
    the global norm's three fp32 scalars (the data and model groups), the
    data mean of the 2L + 1 norm scales' gradients and of three metrics."""
    B, D = t["B"], t["D"]
    ag = 2 * t["emb_gathered"] + L * (2 * t["layer_gathered"] + 3 * t["act"])
    rs = 2 * t["emb_local"] + L * (t["layer_local"] + 4 * t["shard"])
    ar = (L * (3 * t["act"] + 2 * t["kv_whole"]) + 2 * t["act"]
          + 16 * 2 * (B * 256 * 4 + 2 * B * 256 * 4) + 3 * 4 + (2 * L + 1) * D * 2 + 3 * 4)
    count = (2 + L * (2 * 7 + 3) + 2 + L * (7 + 4) + L * (3 + 2) + 2 + 64 + 3 + (2 * L + 1)
             + 3 + L * 6 * (M - 1))
    return {"all-gather": ag, "all-reduce": ar, "reduce-scatter": rs, "all-to-all": 0,
            "collective-permute": L * 6 * (M - 1) * t["shard"], "count": count}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return {s: DR.run_one("llama3-8b", s, False, out_dir=str(out), layers=L)
                for s in ("train_4k", "prefill_32k", "decode_32k")}


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_record_of_llama3_8b_on_the_16x16_mesh(records, shape_name):
    rec = records[shape_name]
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["mesh"], rec["layers"], rec["rows"]) == ("16x16", L, 16 if shape_name ==
                                                          "train_4k" else 2)
    assert rec["params"] == _ref_params(j_config("llama3-8b").replace(num_layers=L,
                                                                       dtype="bfloat16"))
    want = (expected_train if shape_name == "train_4k" else expected_prefill)(
        _llama_terms(shape_name))
    assert rec["collectives"] == want
    assert rec["flops"] > 0 and rec["kernel_flops"]["flash_attention"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    if shape_name == "train_4k":
        assert rec["grad_accum"] == 1 and not rec["seq_shard"]
        assert rec["kernel_flops"]["flash_attention_bwd"] > 0


def test_decode_of_a_placed_model_is_an_error_record_naming_item_8(records):
    rec = records["decode_32k"]
    assert rec["status"] == "error"
    assert "queue 1 item 8" in rec["error"]


def test_grad_accum_and_seq_shard_follow_the_reference_rule():
    from repro_torch.configs import INPUT_SHAPES

    cfg = get_config("llama3-8b")
    assert DR.grad_accum_for(cfg, INPUT_SHAPES["train_4k"], 16) == 16
    assert DR.grad_accum_for(cfg.replace(num_layers=L), INPUT_SHAPES["train_4k"], 16) == 1
    moe = get_config("olmoe-1b-7b")
    assert DR.grad_accum_for(moe, INPUT_SHAPES["train_4k"], 16) == 16


def test_cli_writes_records_and_exits_1_on_an_error(tmp_path, capsys):
    """An error record (whisper-small's decode on its placed mesh) is written
    and the CLI exits 1."""
    with pytest.raises(SystemExit) as ei:
        DR.main(["--arch", "whisper-small", "--shape", "decode_32k", "--layers", "2",
                 "--out-dir", str(tmp_path)])
    assert ei.value.code == 1
    assert "queue 1 item 8" in capsys.readouterr().out
    assert (tmp_path / "whisper-small_decode_32k_pod1.json").exists()


def test_dry_run_refuses_over_an_existing_group():
    with fake_world(2):
        with pytest.raises(RuntimeError, match="default process group exists"):
            DR.build_dryrun("llama3-8b", "prefill_32k", layers=1)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_the_fake_world(multi_pod):
    from repro_torch.launch.mesh import axis_mesh, make_production_mesh, mesh_axes

    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        dp_axes, tp_axis = mesh_axes(mesh)
        sizes = {a: m.size for a, m in mesh.items()}
        joint = axis_mesh(*DR.production_shape(multi_pod=multi_pod), dp_axes, "data")
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(joint.group)
    assert sizes == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                     else {"data": 16, "model": 16})
    assert tp_axis == "model" and dp_axes == (("pod", "data") if multi_pod else ("data",))
    # rank 0's FSDP group: one rank a model row, pod major
    assert (joint.size, joint.rank, ranks[:3]) == (world // 16, 0, [0, 16, 32])
