"""The port's fixed-batch engine against the JAX engine on smoke
``llama3-8b`` in fp32, on the CPU: the same weights (converted from the
reference's) and ragged prompts of 12 and 16 tokens, ``max_new=6``.  The
greedy tokens must be identical, and the teacher-forced logits of every
decode step must agree within 1e-4 absolute (fp32; the frameworks sum
matrix products in different orders).  The recurrent families (smoke
``zamba2-7b`` and ``rwkv6-1.6b``) serve two equal-length prompts of 12
tokens, as the reference requires, under the same checks; ragged prompts
raise ``ValueError`` there."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import make_engine as jmake_engine  # noqa: E402
from repro.serving.engine import _invalidate_pad_slots as j_invalidate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import available_engines, make_engine  # noqa: E402

ARCH = "llama3-8b"
LOGITS_BOUND = 1e-4
LENS, MAX_NEW, MAX_SEQ = (12, 16), 6, 64


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    jcfg = jget_smoke(ARCH)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(0))
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]
    return cfg, jp, model, prompts


def _jax_teacher_forced(cfg, jp, prompts, tokens):
    """The JAX engine's decode loop (repro/serving/engine.py) with the emitted
    tokens forced: right-pad, cached prefill, pad-slot invalidation, then
    decode steps from each row's last prompt token with the pad-gap offsets."""
    B = len(prompts)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    plen = int(lens.max())
    toks = np.zeros((B, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    prefill = jax.jit(lambda p, t, c: JM.forward_hidden(cfg, p, {"tokens": t}, c)[1])
    step = jax.jit(lambda p, t, c, o: JM.decode_step(cfg, p, t, c, pos_offset=o))
    caches = prefill(jp, jnp.asarray(toks), JM.init_caches(cfg, B, MAX_SEQ))
    caches = j_invalidate(caches, jnp.asarray(lens))
    cur = jnp.asarray(toks[np.arange(B), lens - 1][:, None])
    offs = jnp.asarray(plen - lens, jnp.int32)
    out = []
    for j in range(len(tokens[0])):
        logits, caches = step(jp, cur, caches, offs)
        out.append(np.asarray(logits[:, -1]))
        cur = jnp.asarray(np.asarray(tokens)[:, j:j + 1], jnp.int32)
    return np.stack(out, axis=1)


def test_port_engine_matches_jax_engine(setup):
    cfg, jp, model, prompts = setup
    jeng = jmake_engine(cfg, jp, mode="fixed", batch_size=2, max_seq=MAX_SEQ)
    teng = make_engine(cfg, model, mode="fixed", batch_size=2, max_seq=MAX_SEQ)
    jouts = jeng.generate(prompts, max_new=MAX_NEW)
    touts = teng.generate(prompts, max_new=MAX_NEW)
    assert touts == jouts
    assert len(teng.last_timing["decode_s"]) == MAX_NEW

    tl = teng.teacher_forced_logits(prompts, touts)
    assert tl.shape == (2, MAX_NEW, cfg.vocab_size)
    # greedy tokens are the argmax of the teacher-forced logits
    assert tl.argmax(-1).tolist() == touts
    jl = _jax_teacher_forced(cfg, jp, prompts, touts)
    assert float(np.abs(tl.numpy() - jl).max()) < LOGITS_BOUND


def test_engine_surface(setup):
    cfg, _, model, prompts = setup
    assert available_engines() == ["continuous", "fixed"]
    with pytest.raises(KeyError, match="continuous"):
        make_engine(cfg, model, mode="nope", slots=2, max_seq=MAX_SEQ)
    with pytest.raises(FileNotFoundError):
        make_engine(cfg, model, batch_size=2, max_seq=MAX_SEQ, plan="no-such-plan.json")
    with pytest.raises(TypeError):
        make_engine(cfg, model, batch_size=2, max_seq=MAX_SEQ, no_such_option=1)
    eng = make_engine(cfg, model, batch_size=2, max_seq=MAX_SEQ, backend="ref")
    with pytest.raises(ValueError, match="prompts"):
        eng.generate(prompts[:1])
    probe = eng.throughput_probe(steps=2)
    assert probe["tokens_per_s"] > 0


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--max-new", "4", "--max-seq", "32"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("request 0: [") and out[1].startswith("request 1: [")
    assert len(eval(out[0].split(": ", 1)[1])) == 4
    assert out[2].startswith("decode throughput:") and out[2].endswith("batch 2, cpu)")


@pytest.fixture(scope="module", params=["zamba2-7b", "rwkv6-1.6b"])
def rsetup(request):
    cfg, jcfg = get_smoke_config(request.param), jget_smoke(request.param)
    jp = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(2))
    model = M.init_params(cfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    rs = np.random.default_rng(1)
    prompts = [rs.integers(0, cfg.vocab_size, 12).astype(np.int32) for _ in range(2)]
    return cfg, jp, model, prompts


def test_recurrent_engine_matches_jax_engine(rsetup):
    cfg, jp, model, prompts = rsetup
    jeng = jmake_engine(cfg, jp, mode="fixed", batch_size=2, max_seq=MAX_SEQ)
    teng = make_engine(cfg, model, mode="fixed", batch_size=2, max_seq=MAX_SEQ)
    jouts = jeng.generate(prompts, max_new=MAX_NEW)
    touts = teng.generate(prompts, max_new=MAX_NEW)
    assert touts == jouts
    tl = teng.teacher_forced_logits(prompts, touts)
    assert tl.argmax(-1).tolist() == touts
    jl = _jax_teacher_forced(cfg, jp, prompts, touts)
    assert float(np.abs(tl.numpy() - jl).max()) < LOGITS_BOUND


def test_recurrent_engine_refuses_ragged_prompts(rsetup):
    cfg, _, model, prompts = rsetup
    eng = make_engine(cfg, model, batch_size=2, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="equal-length"):
        eng.generate([prompts[0], prompts[1][:9]], max_new=2)
    with pytest.raises(ValueError, match="equal-length"):
        eng.teacher_forced_logits([prompts[0][:5], prompts[1]], [[0], [0]])


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_serve_cli_recurrent_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--max-new", "4", "--max-seq", "32"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("request 0: [") and out[1].startswith("request 1: [")
    assert len(eval(out[0].split(": ", 1)[1])) == 4
    assert out[2].startswith("decode throughput:") and out[2].endswith("batch 2, cpu)")
