"""Whole-prompt prefill in the port (flash attention) against the
reference, on the CPU: the plain version of the flash kernel
(kernels/ref.py::flash_attention_ref) against ``repro.kernels.ref`` and
the Pallas kernel in interpret mode, ``models/flash.py`` against the
reference's XLA twin ``repro.models.flash``, tiny gemma2-2b whole-sequence
attention and forward at 2048 and 2560 tokens, the engine with
``chunked_prefill=False`` at padded lengths of 2048 tokens and more
(teacher-forced against the reference, and against the port's
``generate``), and the CLI. The CUDA kernel itself is checked against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. Kernel-level comparisons are in fp32 and differ only in
summation order: 1e-5 on outputs of size ~1 (measured below 2e-6). Model
calls use the reference's own fp32 parameters, and their fp32 noise grows
with the sequence: RoPE angles pos*freq lose about pos * 2**-24 rad, and
the tiny model's fan-in-scaled init carries a residual stream of ~70. At
2048-2560 tokens the logits (|logit| ~ 1) differ by up to 1.5e-4 and the
caches by up to 1.3e-4 of their largest value (the dense path, already
ported, reaches 1.0e-4 and 6e-5 at 1536 tokens); both are held to 5e-4.
Engine rows follow tests/test_torch_engine.py (the pool stores bf16 k/v
where the reference keeps fp32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving.engine import AdmissionPolicy, Engine, \
    Request  # noqa: E402
from repro_torch.serving.engine import engine as engine_mod  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5                 # fp32 kernel-level outputs of size ~1
LONG_LOGIT_TOL = 5e-4      # fp32 logits at 2048-2560 tokens
CACHE_RTOL = 5e-4          # of the largest |value|, at 2048-2560 tokens
ROW_TOL = 0.25             # as tests/test_torch_engine.py
ROW_MEDIAN_TOL = 0.05


def _qkv(B, S, T, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


# ------------------------------------------------- (a) the plain version --
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 128, 0.0), (False, 0, 0.0), (True, 0, 30.0)])
@pytest.mark.parametrize("H,K", [(4, 2), (2, 2), (4, 1)])
def test_plain_flash_matches_reference_and_pallas(causal, window, cap, H, K):
    """The reference's own grid (tests/test_kernels.py::test_flash_kernel):
    the port's flash_attention_ref against repro.kernels.ref's and the
    Pallas kernel in interpret mode, S = 256, hd = 32."""
    q, k, v = _qkv(2, 256, 256, H, K, 32, seed=H * 10 + K)
    kw = dict(causal=causal, window=window, cap=cap)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _err(got, jref.flash_attention_ref(q, k, v, **kw)) < TOL
    pallas = jfa.flash_attention_fwd(q, k, v, bq=64, bkv=64, interpret=True,
                                     **kw)
    assert _err(got, pallas) < TOL


@pytest.mark.parametrize("causal,window,cap", [
    (False, 0, 0.0), (False, 64, 30.0), (True, 0, 0.0), (True, 96, 30.0)])
def test_plain_flash_with_longer_kv(causal, window, cap):
    """T != S (T = 384 > S = 256): full attention (cross-attention's case
    in the reference), with and without a window, and causal. Every query
    keeps at least one valid key."""
    q, k, v = _qkv(1, 256, 384, 4, 2, 32, seed=7)
    kw = dict(causal=causal, window=window, cap=cap)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    assert _err(got, jref.flash_attention_ref(q, k, v, **kw)) < TOL
    pallas = jfa.flash_attention_fwd(q, k, v, bq=64, bkv=64, interpret=True,
                                     **kw)
    assert _err(got, pallas) < TOL


def test_cpu_wrapper_and_dispatch_take_the_plain_version():
    """On CPU tensors the kernel wrapper and ops.flash_attention ("auto"
    and "ref") return the plain version and count no launch; "cuda"
    refuses CPU tensors instead of falling back; unknown modes are
    rejected."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, 64, 64, 4, 2, 32, seed=3))
    tfa.reset_launches()
    want = tref.flash_attention_ref(q, k, v, causal=True, window=16, cap=20.0)
    for got in (tfa.flash_attention_fwd(q, k, v, window=16, cap=20.0),
                tops.flash_attention(q, k, v, window=16, cap=20.0),
                tops.flash_attention(q, k, v, window=16, cap=20.0,
                                     mode="ref")):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(ValueError, match="cuda"):
        tops.flash_attention(q, k, v, mode="cuda")
    with pytest.raises(ValueError, match="unknown"):
        tops.flash_attention(q, k, v, mode="pallas")
    assert tfa.LAUNCHES == {"flash_attention_fwd": 0}


# ------------------------------------------------- (b) models/flash.py --
@pytest.mark.parametrize("kind,window,cap", [
    ("global", 0, 0.0), ("local", 64, 0.0), ("bidir", 0, 0.0),
    ("global", 0, 20.0), ("local", 100, 30.0)])
@pytest.mark.parametrize("H,K", [(4, 2), (4, 1)])
def test_models_flash_matches_reference_forward(kind, window, cap, H, K):
    """models/flash.py::flash_attention on the CPU against the reference's
    XLA twin (repro.models.flash) over its 512-blocks, S = 1024, hd = 16."""
    q, k, v = _qkv(1, 1024, 1024, H, K, 16, seed=11)
    want = jflash.flash_attention(q, k, v, kind, window, cap)
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)), kind,
                                 window, cap)
    assert _err(got, want) < TOL


# ------------------------------------------ (e) contract and no gradient --
@pytest.mark.parametrize("S,T", [(1000, 1000), (1024, 1000), (2100, 2100)])
def test_models_flash_rejects_what_the_reference_rejects(S, T):
    """S or T neither shorter than nor a multiple of the 512 block: the
    reference asserts, the port raises ValueError."""
    q, k, v = _qkv(1, S, T, 2, 1, 16)
    with pytest.raises(AssertionError):
        jflash.flash_attention(q, k, v, "global", 0, 0.0)
    with pytest.raises(ValueError, match="multiples of 512"):
        tflash.flash_attention(*map(torch.from_numpy, (q, k, v)), "global")


def test_models_flash_rejects_bad_kinds():
    q, k, v = map(torch.from_numpy, _qkv(1, 512, 512, 2, 1, 16))
    with pytest.raises(ValueError, match="kind"):
        tflash.flash_attention(q, k, v, "sliding", 64)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention(q, k, v, "local", 0)


def test_models_flash_backward_raises():
    """The forward is an autograd.Function whose backward, once a
    NotImplementedError, is now the reference's custom VJP ported: asking
    for a gradient gives the reference's (jax.grad through
    repro.models.flash) at fp32, never a wrong one. The full grid is
    tests/test_torch_flash_bwd.py."""
    qn, kn, vn = _qkv(1, 512, 512, 2, 1, 16)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    q.requires_grad_()
    out = tflash.flash_attention(q, k, v, "global")
    out.sum().backward()
    want = jax.grad(lambda a: jnp.sum(jflash.flash_attention(
        a, jnp.asarray(kn), jnp.asarray(vn), "global")))(jnp.asarray(qn))
    assert _err(q.grad.numpy(), want) <= TOL * float(np.abs(want).max())


# ------------------------------------------------ (c) tiny gemma2-2b --
@pytest.fixture(scope="module")
def models():
    jm = j_build(j_tiny("gemma2-2b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    tm = t_build(t_tiny("gemma2-2b"))
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp))


def _cache_close(got, want):
    want = np.asarray(want, np.float32)
    return _err(got, want) <= CACHE_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("S", [2048, 2560])
@pytest.mark.parametrize("slot", ["sub0", "sub1"])
def test_attention_fwd_long_matches_reference(models, S, slot):
    """One layer's whole-sequence attention at S >= FLASH_MIN, local
    (sub0, window 32: every 128-row tile of the CUDA kernel straddles the
    window edge) and global (sub1): output and the chronological cache."""
    jm, jp, tm, tp = models
    cfg = jm.cfg
    kind = cfg.attn_pattern[int(slot[3:])]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want, wc = jattn.attention_fwd(
        jax.tree.map(lambda a: a[0], jp["blocks"][slot]["attn"]),
        jnp.asarray(x), kind, cfg, jnp.asarray(pos), ring=False)
    got, gc = tattn.attention_fwd(
        {n: w[0] for n, w in tp["blocks"][slot]["attn"].items()},
        torch.from_numpy(x), kind, tm.cfg, torch.from_numpy(pos))
    assert _err(got, want) <= CACHE_RTOL * float(np.abs(want).max())
    for kv in ("k", "v"):
        assert _cache_close(gc[kv], wc[kv])


@pytest.mark.parametrize("S", [2048, 2560])
def test_forward_long_matches_reference(models, S):
    """The tiny model's forward at S >= FLASH_MIN in fp32: logits of every
    row and the full-layout caches of every layer."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(S + 1).integers(
        2, jm.cfg.vocab_size, (1, S)).astype(np.int32)
    want, wcache, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                                    want_cache=True, cache_layout="full")
    got, gcache, _, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                                   want_cache=True, cache_layout="full")
    assert got.shape == want.shape
    assert _err(got, want) < LONG_LOGIT_TOL
    for slot in wcache:
        for kv in ("k", "v"):
            assert _cache_close(gcache[slot][kv], wcache[slot][kv])


# ------------------------------------------------------- (d) the engine --
def _policy(**kw):
    base = dict(hw_name="test", max_model_len=64, page_size=8,
                num_pages=10_000, max_batch=3, prefill_chunk=2048,
                quant_bits=16, decode_slo_s=0.03, est_decode_s=0.0,
                est_prefill_s=0.0)
    base.update(kw)
    return AdmissionPolicy(**base)


def _count_flash(monkeypatch):
    """Count the model's calls into the flash dispatch (their q lengths)."""
    calls = []
    real = tops.flash_attention

    def counting(q, *a, **kw):
        calls.append(q.shape[1])
        return real(q, *a, **kw)

    monkeypatch.setattr(tops, "flash_attention", counting)
    return calls


def _serve_recording(engine, reqs):
    """Serve ``reqs`` through ``engine`` and record, as
    tests/test_torch_engine.py does, the logits row behind every sampled
    token, keyed (rid, output index), and the q lengths of the flash calls.
    Returns (outputs, rows, flash calls)."""
    rows, current = {}, {}
    sample = engine_mod.sample_token

    def step_generator(seq):
        current["key"] = (seq.req.rid,
                          len(seq.req.prompt) + len(seq.generated))
        return None

    def recording_sample(row, temperature, generator):
        rows[current["key"]] = np.array(row)
        return sample(row, temperature, generator)

    with pytest.MonkeyPatch.context() as mp:
        calls = _count_flash(mp)
        mp.setattr(engine, "_step_generator", step_generator)
        mp.setattr(engine_mod, "sample_token", recording_sample)
        outs = engine.run(reqs)
    return outs, rows, calls


def _check_teacher_forced(jm, jp, reqs, outs, rows):
    """Every sampled row against the reference forward over the same
    tokens, all padded to one multiple of 512 of at least 2048 so the
    reference takes its flash path too (causal masking keeps the rows
    before the pad exact; only those are read)."""
    n_max = max(len(outs[r.rid]) - 1 for r in reqs)
    L = max(2048, -(-n_max // 512) * 512)
    errs = []
    for r in reqs:
        o = outs[r.rid]
        assert len(o) == len(r.prompt) + r.max_new
        toks = np.zeros((1, L), np.int32)
        toks[0, :len(o) - 1] = o[:-1]
        logits = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)},
                                       cache_layout="full")[0][0])
        for idx in range(len(r.prompt), len(o)):
            want = logits[idx - 1]
            errs.append(float(np.abs(rows[(r.rid, idx)] - want).max()))
            top2 = np.sort(want)[-2:]
            assert o[idx] == want.argmax() or top2[1] - top2[0] <= ROW_TOL, \
                (r.rid, idx)
    assert max(errs) <= ROW_TOL, max(errs)
    assert float(np.median(errs)) <= ROW_MEDIAN_TOL, np.median(errs)


@pytest.fixture(scope="module")
def long_run(models):
    """chunked_prefill=False with a 2048-token chunk over three short
    prompts and one of 2048 tokens: each whole-prompt prefill pads to 2048
    rows. Returns (requests, engine, outputs, rows, flash calls)."""
    _, _, tm, tp = models
    rng = np.random.default_rng(20)
    lens = [int(n) for n in rng.integers(4, 45, 3)] + [2048]
    reqs = [Request(rid=i, prompt=rng.integers(2, 512, n).astype(np.int32),
                    max_new=int(rng.integers(4, 9)))
            for i, n in enumerate(lens)]
    engine = Engine(tm, tp, _policy(max_model_len=2056),
                    chunked_prefill=False)
    return (reqs, engine) + _serve_recording(engine, reqs)


def test_engine_whole_prompt_flash_teacher_forced(models, long_run):
    """Every prefill runs the flash path (one call per layer over 2048
    padded rows), and every sampled row matches the reference."""
    jm, jp, tm, _ = models
    reqs, engine, outs, rows, calls = long_run
    assert engine.stats["prefill_chunks"] == 0
    assert engine.stats["prefills"] == len(reqs)
    assert calls == [2048] * (tm.cfg.num_layers * len(reqs))
    assert engine.kv.allocator.num_allocated == 0
    _check_teacher_forced(jm, jp, reqs, outs, rows)


def test_engine_whole_prompt_flash_matches_generate(models, long_run):
    """Greedy tokens of the whole-prompt engine against the port's own
    generate (which prefills the 2048-token prompt through flash too),
    equal up to the first near tie."""
    _, _, tm, tp = models
    reqs, _, outs, _, _ = long_run
    for r in reqs:
        want = generate(tm, tp, torch.from_numpy(r.prompt[None]),
                        r.max_new, page_size=8)[0].numpy()
        got = outs[r.rid]
        diff = np.nonzero(want != got)[0]
        if diff.size:
            i = int(diff[0])
            assert i >= len(r.prompt)
            toks = np.zeros((1, max(2048, -(-i // 512) * 512)), np.int32)
            toks[0, :i] = got[:i]
            logits = tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0]
            top2 = np.sort(logits[0, i - 1].numpy())[-2:]
            assert top2[1] - top2[0] <= ROW_TOL, (r.rid, i)


def test_engine_whole_prompt_flash_preemption(models):
    """A pool of 8 usable pages for 3 sequences growing to 4 pages each
    forces youngest-first preemption; each resumed sequence is
    re-prefilled as a prompt-extension through the flash path, and its
    rows still match the reference."""
    jm, jp, tm, tp = models
    reqs = [Request(rid=i, prompt=np.random.default_rng(30 + i).integers(
        2, 512, 12).astype(np.int32), max_new=16) for i in range(3)]
    engine = Engine(tm, tp, _policy(num_pages=9), chunked_prefill=False)
    outs, rows, calls = _serve_recording(engine, reqs)
    assert engine.stats["preemptions"] > 0
    assert engine.stats["prefills"] > len(reqs)
    assert calls == [2048] * (tm.cfg.num_layers * engine.stats["prefills"])
    assert engine.kv.allocator.num_allocated == 0
    _check_teacher_forced(jm, jp, reqs, outs, rows)


# ----------------------------------------------------------- (f) the CLI --
def test_serve_cli_long_prompts_on_cpu(capsys, monkeypatch):
    """The launcher at tiny size on the CPU with prompts of 2048 tokens or
    more: engine mode with --no-chunked-prefill (prompts of 2179 and 1632
    tokens, both padded to the 2560 chunk) and --sequential (2048)."""
    from repro_torch.launch import serve
    calls = _count_flash(monkeypatch)
    base = ["--arch", "gemma2-2b", "--tiny", "--device", "cpu", "--gen",
            "3"]
    serve.main(base + ["--requests", "2", "--prompt-len", "2560",
                       "--prefill-chunk", "2560", "--max-batch", "2",
                       "--no-chunked-prefill"])
    out = capsys.readouterr().out
    assert "chunked=False" in out and "served 2 requests, 6 tokens" in out
    assert calls == [2560] * (2 * 4)
    serve.main(base + ["--sequential", "--batch", "1", "--prompt-len",
                       "2048"])
    assert "generated 3 tokens x batch 1" in capsys.readouterr().out
    assert calls[8:] == [2048] * 4
