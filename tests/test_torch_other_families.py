"""The other families against the JAX reference on the CPU in fp32: smoke
``whisper-small`` (the ``audio`` family: an encoder over stub frames,
cross-attention, learned positions, LayerNorms, GELU), ``deepseek-v2-lite-16b``
(MLA with its compressed cache, in a MoE trunk) and ``qwen2-vl-72b`` (the
``vlm`` family: M-RoPE, with and without image patches).  Each is
initialised in JAX and converted through numpy.

Bounds: 1e-4 absolute for hidden states, logits and cached decode
(``BOUND`` of tests/test_torch_model.py).  Greedy tokens must be equal.

Two faults of the reference that the port does not copy, each shown here
beside the port's behaviour:

* its fixed engine cannot serve whisper: it puts the frames into the
  caches' memory and prefills with the tokens alone, and ``forward_hidden``
  fails at ``batch["frames"]`` (``KeyError``).  The port's engine passes the
  frames into the prefill batch; it is held to a loop of the reference's own
  ``forward_hidden({"tokens", "frames"}, caches)`` and ``decode_step`` calls
  with argmax;
* its uncached vlm forward with patches masks by the M-RoPE temporal
  position, not by index: text at index 256 + j sees keys 0 ... 16 + j only.
  The port masks by index on every route, as the reference's cached prefill
  does, and is held to that.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import layers as JL, model as JM  # noqa: E402
from repro.serving import make_engine as jmake_engine  # noqa: E402
from repro.serving.continuous import ContinuousEngine as JContinuous  # noqa: E402
from repro.serving.engine import _invalidate_pad_slots as j_invalidate  # noqa: E402
from repro.serving.types import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L, model as M  # noqa: E402
from repro_torch.serving import ContinuousEngine, Request, make_engine  # noqa: E402

ARCHS = ("whisper-small", "deepseek-v2-lite-16b", "qwen2-vl-72b")
AUDIO, MLA, VLM = ARCHS
BOUND = 1e-4
MAX_SEQ = 48
B, PREFILL, DECODE = 2, 10, 6
LENS, MAX_NEW = (9, 14), 12              # ragged engine prompts and new tokens
PATCH_S, FLIPPED, READ = 320, 300, 310   # a vlm prompt with 256 patches


@pytest.fixture(scope="module")
def built():
    """Each arch's (cfg, jcfg, reference params, their numpy tree, port
    model), made once for the module whatever order the tests run in."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
            jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, jp)
            model = M.init_params(cfg, 0, device="cpu")
            model.load_state_dict(params_from_jax(cfg, tree))
            model.requires_grad_(False)
            cache[arch] = cfg, jcfg, jp, tree, model
        return cache[arch]

    return get


@pytest.fixture
def fam(request, built):
    return built(request.param)


def _np(a):
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, rows, seed=7):
    """Stub frames as the reference's launcher draws them, N(0, 0.02²)."""
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((rows, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _batches(cfg, toks):
    """(the reference's batch, the port's) of ``toks``, with frames for audio."""
    jb, tb = {"tokens": toks}, {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "audio":
        fr = _frames(cfg, toks.shape[0])
        jb["frames"], tb["frames"] = fr, torch.from_numpy(fr)
    return jb, tb


@pytest.mark.parametrize("fam", ARCHS, indirect=True)
def test_params_round_trip_is_exact(fam):
    """Every leaf through ``params_from_jax`` and back, bit for bit: MLA's
    projections and latent norm; whisper's ``enc_pos``, both stacks, the
    cross-attention, ``ln_x`` and ``dec_pos``."""
    cfg, _, _, tree, model = fam
    back = params_to_jax(cfg, model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(a, flat_b[path]), path
    if cfg.family == "audio":
        assert model.dec_pos.shape == (cfg.max_seq_len, cfg.d_model)
        assert set(tree["trunk"]["dec_layers"]) >= {"self_attn", "cross_attn", "ln_x"}
    if cfg.attn_kind == "mla":
        assert isinstance(model.trunk.dense_layers[0].attn, L.MLA)


@pytest.mark.parametrize("fam", ARCHS, indirect=True)
def test_forward_hidden_and_logits_match(fam):
    cfg, jcfg, jp, _, model = fam
    jb, tb = _batches(cfg, _tokens(cfg, (B, 12), 1))
    jx = jax.jit(lambda p, b: JM.forward_hidden(jcfg, p, b)[0])(jp, jb)
    x, _, _ = M.forward_hidden(cfg, model, tb)
    assert _err(x, jx) < BOUND
    jl = jax.jit(lambda p, x: JM._unembed(jcfg, p, x))(jp, jx)
    assert _err(M._unembed(cfg, model, x), jl) < BOUND


@pytest.mark.parametrize("fam", ARCHS, indirect=True)
def test_prefill_decode_matches_reference_cached_path(fam):
    """Cached prefill, then decode steps, against the reference's same
    calls (whisper: the frames in the prefill batch, the memory in the
    caches after it)."""
    cfg, jcfg, jp, _, model = fam
    toks, nxt = _tokens(cfg, (B, PREFILL), 2), _tokens(cfg, (B, DECODE), 3)
    jb, tb = _batches(cfg, toks)

    @jax.jit
    def jrun(p, b, n):
        c = JM.init_caches(jcfg, B, MAX_SEQ)
        jx, c, _ = JM.forward_hidden(jcfg, p, b, c)
        out = []
        for j in range(n.shape[1]):
            lg, c = JM.decode_step(jcfg, p, n[:, j:j + 1], c)
            out.append(lg[:, -1])
        return jx, jnp.stack(out, 1)

    jx, jlogits = jrun(jp, jb, nxt)
    caches = M.init_caches(cfg, B, MAX_SEQ, device="cpu")
    x, caches, _ = M.forward_hidden(cfg, model, tb, caches)
    if cfg.family == "audio":
        assert caches["memory"].shape == (B, cfg.encoder_seq, cfg.d_model)
    out = []
    for j in range(DECODE):
        logits, caches = M.decode_step(cfg, model, torch.from_numpy(nxt[:, j:j + 1]).long(),
                                       caches)
        out.append(logits[:, -1])
    assert caches["pos"] == PREFILL + DECODE
    assert _err(x, jx) < BOUND
    assert _err(torch.stack(out, 1), jlogits) < BOUND


def _prompts(cfg):
    rs = np.random.default_rng(4)
    return [rs.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]


def _serve(engine, req_cls, prompts):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(i, p, max_new=MAX_NEW))
    return [r.out for r in sorted(engine.run(), key=lambda r: r.rid)]


def _whisper_reference_loop(jcfg, jp, prompts, frames):
    """What the reference's fixed engine means to do with whisper, through
    its own calls: the right-padded prompts and the frames prefilled into
    fresh caches, the pad slots marked dead, then ``decode_step`` with each
    row's pad gap as ``pos_offset`` and argmax."""
    plen = max(len(p) for p in prompts)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    prefill = jax.jit(lambda p, b: JM.forward_hidden(
        jcfg, p, b, JM.init_caches(jcfg, len(prompts), MAX_SEQ))[1])
    step = jax.jit(lambda p, t, c, o: JM.decode_step(jcfg, p, t, c, pos_offset=o))
    caches = j_invalidate(prefill(jp, {"tokens": toks, "frames": frames}), jnp.asarray(lens))
    cur, offs = toks[np.arange(len(prompts)), lens - 1][:, None], plen - lens
    outs = [[] for _ in prompts]
    for _ in range(MAX_NEW):
        logits, caches = step(jp, cur, caches, offs)
        cur = np.asarray(jnp.argmax(logits[:, -1], axis=-1)).astype(np.int32)[:, None]
        for i, t in enumerate(cur[:, 0]):
            outs[i].append(int(t))
    return outs


@pytest.mark.parametrize("fam", ARCHS, indirect=True)
def test_fixed_engine_matches_the_reference(fam):
    """The fixed engine over ragged prompts of 9 and 14 tokens: its tokens
    equal the reference's fixed engine's (whisper: the loop of the
    reference's calls, ``_whisper_reference_loop``, since its engine
    fails), and the teacher-forced logits agree with ``generate``."""
    cfg, jcfg, jp, _, model = fam
    prompts = _prompts(cfg)
    frames = _frames(cfg, B) if cfg.family == "audio" else None
    engine = make_engine(cfg, model, mode="fixed", batch_size=B, max_seq=MAX_SEQ)
    got = engine.generate(prompts, max_new=MAX_NEW, frames=frames)
    if cfg.family == "audio":
        want = _whisper_reference_loop(jcfg, jp, prompts, frames)
    else:
        want = jmake_engine(jcfg, jp, mode="fixed", batch_size=B,
                            max_seq=MAX_SEQ).generate(prompts, max_new=MAX_NEW)
    assert got == want
    forced = engine.teacher_forced_logits(prompts, got, frames=frames)
    assert forced.argmax(-1).tolist() == got


@pytest.mark.parametrize("fam", [MLA, VLM], indirect=True)
def test_continuous_engine_matches_the_reference(fam):
    """The continuous engine on the decoder-only families (MLA's compressed
    cache per slot; vlm on text), against the reference's continuous
    engine."""
    cfg, jcfg, jp, _, model = fam
    prompts = _prompts(cfg)
    got = _serve(ContinuousEngine(cfg, model, slots=B, max_seq=MAX_SEQ), Request, prompts)
    want = _serve(JContinuous(jcfg, jp, slots=B, max_seq=MAX_SEQ), JRequest, prompts)
    assert got == want


@pytest.mark.parametrize("fam", [AUDIO], indirect=True)
def test_reference_engines_cannot_serve_whisper(fam):
    """The reference's fault that the port repairs: its fixed engine fails
    with ``KeyError: 'frames'`` (it prefills without them), and its
    continuous engine asserts that the model is decoder-only.  The port's
    fixed engine serves it (held above); its continuous engine refuses it
    with a ``ValueError`` naming the fixed engine, as the reference
    refuses."""
    cfg, jcfg, jp, _, model = fam
    prompts = _prompts(cfg)
    with pytest.raises(KeyError, match="frames"):
        jmake_engine(jcfg, jp, mode="fixed", batch_size=B, max_seq=MAX_SEQ).generate(
            prompts, max_new=2, frames=_frames(cfg, B))
    with pytest.raises(AssertionError):
        JContinuous(jcfg, jp, slots=B, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="fixed engine"):
        ContinuousEngine(cfg, model, slots=B, max_seq=MAX_SEQ)
    engine = make_engine(cfg, model, mode="fixed", batch_size=B, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="frames"):
        engine.generate(prompts, max_new=2)


def _patch_batches(cfg, toks, seed=8):
    rs = np.random.default_rng(seed)
    patches = (rs.standard_normal((toks.shape[0], M.N_PATCHES, cfg.d_model)) * 0.02
               ).astype(np.float32)
    return ({"tokens": toks, "patches": patches},
            {"tokens": torch.from_numpy(toks).long(), "patches": torch.from_numpy(patches)})


@pytest.mark.parametrize("fam", [VLM], indirect=True)
def test_vlm_patches_match_the_reference_cached_prefill(fam):
    """qwen2-vl with 256 patches at the head of 320 positions: the port's
    uncached and cached forwards against the reference's cached prefill
    (which masks by index), a decode step after it (at t0 on all three
    M-RoPE axes, as the reference's ``decode_step``), and the loss, whose
    patch rows carry no target, against the reference's cross-entropy of
    those states (its own loss runs its uncached forward, whose mask
    differs: ``test_reference_uncached_patch_mask_is_by_temporal_position``)."""
    cfg, jcfg, jp, _, model = fam
    toks = _tokens(cfg, (1, PATCH_S), 5)
    jb, tb = _patch_batches(cfg, toks)
    nxt = _tokens(cfg, (1, 1), 6)

    @jax.jit
    def jcached(p, b, n):
        jx, c, _ = JM.forward_hidden(jcfg, p, b, JM.init_caches(jcfg, 1, PATCH_S + 1))
        return jx, JM.decode_step(jcfg, p, n, c)[0]

    jx, jlogits = jcached(jp, jb, nxt)
    x, _, _ = M.forward_hidden(cfg, model, tb)
    caches = M.init_caches(cfg, 1, PATCH_S + 1, device="cpu")
    xc, caches, _ = M.forward_hidden(cfg, model, tb, caches)
    logits, _ = M.decode_step(cfg, model, torch.from_numpy(nxt).long(), caches)
    assert _err(x, jx) < BOUND and _err(xc, jx) < BOUND
    assert _err(logits, jlogits) < BOUND

    # the loss: the reference's chunked cross-entropy of its index-masked
    # states, the patch rows' mask zeroed as its loss_and_metrics zeroes it
    targets = _tokens(cfg, (1, PATCH_S), 9)
    mask = np.ones((1, PATCH_S), np.float32)
    mask[:, :M.N_PATCHES] = 0.0
    jloss = jax.jit(lambda p, x, t, m: JM.chunked_ce(jcfg, p, x, t, m))(jp, jx, targets, mask)
    loss, _ = M.loss_and_metrics(cfg, model, dict(tb, targets=torch.from_numpy(targets)),
                                 remat=False)
    assert abs(float(loss) - float(jloss)) < BOUND


@pytest.mark.parametrize("fam", [VLM], indirect=True)
def test_reference_uncached_patch_mask_is_by_temporal_position(fam):
    """The reference's fault that the port does not copy: with patches its
    uncached forward masks by the temporal M-RoPE position, so the text at
    index 310 (temporal position 70) never sees token 300 (position 60...
    it sees keys 0 to 70 only): flipping token 300 moves its hidden state
    by exactly 0.  The port masks by index: the state moves."""
    cfg, jcfg, jp, _, model = fam
    toks = _tokens(cfg, (1, PATCH_S), 5)
    flipped = toks.copy()
    flipped[0, FLIPPED] = (flipped[0, FLIPPED] + 1) % cfg.vocab_size
    fwd = jax.jit(lambda p, b: JM.forward_hidden(jcfg, p, b)[0])
    (ja, ta), (jb, tb) = _patch_batches(cfg, toks), _patch_batches(cfg, flipped)
    assert _err(fwd(jp, ja)[:, READ], fwd(jp, jb)[:, READ]) == 0.0
    moved = _err(M.forward_hidden(cfg, model, ta)[0][:, READ],
                 M.forward_hidden(cfg, model, tb)[0][:, READ])
    assert moved > 1e-2


def test_mla_blockwise_above_2048_keys_matches_the_reference():
    """MLA's uncached attention at 2100 positions (blockwise in both:
    above 2048 keys), at a narrow width: the port's blockwise loop against
    the reference's ``_mla_blockwise`` through ``mla_attention``, and
    against the port's own dense route."""
    narrow = dict(d_model=32, num_heads=2, kv_lora_rank=16, qk_nope_head_dim=8,
                  qk_rope_head_dim=8, v_head_dim=8)
    cfg = get_smoke_config(MLA).replace(**narrow)
    jcfg = jget_smoke(MLA).replace(**narrow)
    S = 2100
    jp = JL.init_mla(jax.random.PRNGKey(3), jcfg)
    mod = L.MLA(cfg)
    with torch.no_grad():
        for name in ("q", "kv_a", "kv_b", "o"):
            getattr(mod, name).weight.copy_(torch.from_numpy(np.array(jp[name]["w"]).T))
        mod.kv_a_norm.scale.copy_(torch.from_numpy(np.array(jp["kv_a_norm"]["scale"])))
    x = np.random.default_rng(2).standard_normal((1, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want = jax.jit(lambda p, x, q: JL.mla_attention(p, jcfg, x, q)[0])(jp, x, pos)
    with torch.no_grad():
        got = L.mla_attention(mod, cfg, torch.from_numpy(x), torch.from_numpy(pos).long())[0]
        dense = L.mla_attention(mod, cfg, torch.from_numpy(x), torch.from_numpy(pos).long(),
                                blockwise_threshold=S)[0]
    assert _err(got, want) < BOUND
    assert _err(got, dense) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    """The launcher serves each smoke model on the CPU: its tokens are the
    fixed engine's on the weights and prompts of its seed, whisper's with
    frames drawn after the prompts from the same generator, N(0, 0.02²)."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--max-new", "4", "--max-seq", "32"])
    out = capsys.readouterr().out.splitlines()
    cfg = get_smoke_config(arch)
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, size=8).astype(np.int32) for _ in range(2)]
    frames = None
    if cfg.family == "audio":
        frames = rs.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
    eng = make_engine(cfg, M.init_params(cfg, 0, device="cpu"), batch_size=2, max_seq=32)
    want = eng.generate(prompts, max_new=4, frames=frames)
    assert out[:2] == [f"request {i}: {o}" for i, o in enumerate(want)]
    assert out[2].startswith("decode throughput:") and out[2].endswith("batch 2, cpu)")


def test_serve_cli_refuses_whisper_continuous():
    with pytest.raises(ValueError, match="decoder-only"):
        serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu", "--engine", "continuous",
                    "--batch", "2", "--prompt-len", "8", "--max-new", "2", "--max-seq", "32"])
