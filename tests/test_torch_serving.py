"""The port's host-side serving pieces against the reference: admission
policies (including the h100-sxm target), the page pool's span writer,
the scheduler's admission/growth/preemption bookkeeping, and the modules
the port keeps as verbatim copies (configs, telemetry, scheduler)."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.core import hardware_model as j_hwm  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.serving.engine import admission as j_adm  # noqa: E402
from repro.serving.engine import pool as j_pool  # noqa: E402
from repro.serving.engine import scheduler as j_sched  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.core import hardware_model as t_hwm  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving.engine import admission as t_adm  # noqa: E402
from repro_torch.serving.engine import pool as t_pool  # noqa: E402
from repro_torch.serving.engine import scheduler as t_sched  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _same_policy(a, b):
    """Integer fields equal; latencies equal to fp32 rounding (the
    reference prices in fp32 arrays, the port in Python floats)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, float):
            assert y == pytest.approx(x, rel=1e-5), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("hw", ["v5e-1chip", "v5e-pod256"])
@pytest.mark.parametrize("arch,tiny,max_len", [
    ("gemma2-2b", True, 64), ("gemma2-2b", False, 1088),
    ("gemma2-2b", False, 4232), ("granite-3-8b", False, 2048)])
def test_derive_policy_matches_reference(hw, arch, tiny, max_len):
    jc = j_tiny(arch) if tiny else j_get(arch)
    tc = t_tiny(arch) if tiny else t_get(arch)
    want = j_adm.derive_policy(jc, j_hwm.HARDWARES[hw],
                               max_model_len=max_len)
    got = t_adm.derive_policy(tc, t_hwm.HARDWARES[hw], max_model_len=max_len)
    _same_policy(want, got)


@pytest.mark.parametrize("max_len", [576, 1088, 4232])
def test_h100_policy_matches_reference_with_same_constants(max_len):
    """The port's h100-sxm entry, given to the reference's own
    derive_policy as a Hardware of the same constants, sizes the same
    policy; at full gemma2-2b width it keeps bf16 weights and pool."""
    h = t_hwm.HARDWARES["h100-sxm"]
    j_h100 = j_hwm.Hardware(h.name, chips=h.chips,
                            peak_flops_bf16=h.peak_flops_bf16,
                            peak_flops_int8=h.peak_flops_int8,
                            hbm_bw=h.hbm_bw, ici_bw=h.ici_bw,
                            hbm_bytes=h.hbm_bytes)
    pb = t_build(t_get("gemma2-2b")).param_bytes()
    want = j_adm.derive_policy(j_get("gemma2-2b"), j_h100,
                               max_model_len=max_len, param_bytes=pb)
    got = t_adm.derive_policy(t_get("gemma2-2b"), h, max_model_len=max_len,
                              param_bytes=pb)
    _same_policy(want, got)
    assert got.quant_bits == 16 and got.kv_bits is None
    assert t_hwm.DEFAULT_HW == "h100-sxm"


def test_param_bytes_match_reference():
    for arch in ("gemma2-2b", "granite-3-8b"):
        assert t_build(t_get(arch)).param_bytes() == \
            j_build(j_get(arch)).param_bytes()


def test_write_prefill_spans_match_reference():
    """Whole-prompt and page-aligned span writes land the same pages."""
    cfg = j_tiny("gemma2-2b")
    jm, tm = j_build(cfg), t_build(t_tiny("gemma2-2b"))
    jp = j_pool.PagedKVPool(jm, 12, 4)
    tp = t_pool.PagedKVPool(tm, 12, 4, device="cpu")
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers // 2, 1, 10, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    for pages, start in (([3, 7, 2], 0), ([3, 7, 2, 9, 5], 8)):
        cache = {f"sub{j}": {kv: np.asarray(jnp.asarray(
            rng.standard_normal(shape), jnp.bfloat16)) for kv in "kv"}
            for j in range(2)}
        jp.write_prefill(jax.tree.map(jnp.asarray, cache), pages,
                         start=start)
        tp.write_prefill(from_jax_params(cache), pages, start=start)
    for j in range(2):
        for kv in "kv":
            assert np.array_equal(
                np.asarray(jp.pool[f"sub{j}"][kv], np.float32),
                tp.pool[f"sub{j}"][kv].float().numpy())
    with pytest.raises(ValueError):
        tp.write_prefill(from_jax_params(cache), [1, 2], start=3)


def test_scheduler_bookkeeping_matches_reference():
    """Drive both schedulers through admission, growth, preemption and
    release with the same decisions; slots, pages and the queue agree at
    every step."""
    def make(mod, pmod):
        return mod.Scheduler(pmod.PageAllocator(9, 4), 3, 40)

    js, ts = make(j_sched, j_pool), make(t_sched, t_pool)
    rng = np.random.default_rng(3)
    for i in range(5):
        prompt = rng.integers(2, 100, int(rng.integers(3, 12))) \
            .astype(np.int32)
        for s, mod in ((js, j_sched), (ts, t_sched)):
            s.submit(mod.Request(rid=i, prompt=prompt, max_new=12))

    def state(s):
        return (sorted((k, v.req.rid, list(v.pages), v.pos)
                       for k, v in s.active.items()),
                [(r.rid, len(r.prompt)) for r in s.queue],
                s.allocator.num_free, s.num_preempted)

    for _ in range(12):
        for s in (js, ts):
            for seq in s.admit():
                seq.prefill_progress = seq.pos = len(seq.req.prompt)
                seq.generated.append(1)
            for seq in sorted(s.decode_ready(), key=lambda q: q.birth):
                if s.active.get(seq.slot) is not seq:
                    continue
                while not s.ensure_capacity(seq):
                    victim = s.youngest_active()
                    s.preempt(victim)
                    if victim is seq:
                        break
                if s.active.get(seq.slot) is seq:
                    seq.pos += 1
                    seq.generated.append(1)
                    if seq.is_done():
                        s.release(seq)
        assert state(js) == state(ts)
    assert js.num_preempted > 0


@pytest.mark.parametrize("pkg", ["configs", "serving/telemetry"])
def test_verbatim_copies_match_reference(pkg):
    """configs/ and serving/telemetry/ are kept verbatim, imports
    rewritten; the scheduler too."""
    ref_dir = ROOT / "src" / "repro" / pkg
    port_dir = ROOT / "src" / "repro_torch" / pkg
    names = sorted(p.name for p in ref_dir.glob("*.py"))
    assert names == sorted(p.name for p in port_dir.glob("*.py"))
    for name in names + (["../engine/scheduler.py"]
                         if pkg == "serving/telemetry" else []):
        ref = (ref_dir / name).read_text()
        port = (port_dir / name).read_text().replace("repro_torch.",
                                                     "repro.")
        assert port == ref, name
