"""The redesigned flash-attention kernel's plan, layouts and arithmetic, on
the CPU (csrc/flash_attention.cu runs only on the card; tests/
test_torch_cuda.py and chip_smoke.py hold it against its plain version
there):

- ``flash_plan``, whose positions a CTA the kernel takes, with the kv-tile
  range each CTA computes from it (``kernel_tile``, a mirror of
  ``flash_fwd_kernel``'s lines in csrc/flash_attention.cu), covers every
  (row, key) pair that ``flash_attention_ref``'s mask keeps exactly once,
  and visits no kv tile that no row of its CTA needs;
- the q tile's TMA box (q viewed as (hd, H, S, B), box {64, G, P, 1})
  lands row r = p*G + g as query head kh*G + g at position s0 + p, the
  rows the Pallas kernel fuses as (G, bq), and the epilogue writes each
  (position, head) of a kv head once;
- the S accumulator, re-packed in place as P's A fragments, covers each
  (row, key) slot of wgmma's documented m64k16 bf16 A layout once, with
  the row and key the accumulator's documented m64nN layout gives it;
- a plain-torch emulation of the kernel's rounding points (log2(e) folded
  into the scale and exp2, P rounded to bf16, l summed over the rounded
  weights, tile by tile over the plan) matches ``flash_attention_ref``
  and the Pallas kernel in interpret mode at the kernel tolerance
  (2**-7·|ref| + 2**-7·row max, chip_smoke.py's); the cap applied after
  the mask misses it, and l over the unrounded weights breaks the
  output's convex-combination property, which the kernel keeps to fp32
  rounding (1e-6): on scores built so that every weight but one rounds
  down by nearly 2**-8, it moves a constant v by a bf16 ulp.
"""
import math
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_cases import (PROBE_V, PROBE_V_UNROUNDED_L,  # noqa: E402
                              bf16_close, flash_rounding_probe)

torch.set_num_threads(1)

LENGTHS = (1, 200, 300, 2048, 2560, 4096)
GROUPS = (1, 2, 3, 4, 5, 6, 12)
WINDOWS = (0, 32, 4096)
LOG2E = 1.4426950408889634


# ------------------------------------------------------------ the plan --
def kernel_tile(plan, i):
    """(s0, s1, lo, hi): what CTA i (blockIdx.y) of ``flash_fwd_kernel``
    takes, mirrored from csrc/flash_attention.cu, where the kernel computes
    it from the plan's positions and the shapes: positions [s0, s1) and kv
    tiles lo..hi, from the first position's window start to the last
    position's diagonal (none when lo > hi), the last row tiles (the
    longest causal ranges) first."""
    t = plan.tiles - 1 - i
    s0, s1 = t * plan.positions, min((t + 1) * plan.positions, plan.S)
    hi = (plan.T - 1) // plan.bn
    if plan.causal:
        hi = min(hi, (s1 - 1) // plan.bn)
    lo = max(s0 - plan.window + 1, 0) // plan.bn if plan.window else 0
    return s0, s1, lo, hi


@lru_cache(maxsize=None)
def _mask_rows(S, T, causal, window):
    """Per query position: whether any key is valid, and the first and
    last valid key of flash_attention_ref's mask (built as it builds it);
    each row's valid keys are checked to be one run."""
    i = torch.arange(S)[:, None]
    j = torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    any_ = mask.any(1)
    first = mask.int().argmax(1)
    last = T - 1 - mask.flip(1).int().argmax(1)
    count = mask.sum(1)
    assert torch.equal(count[any_], (last - first + 1)[any_])
    return any_.numpy(), first.numpy(), last.numpy()


@pytest.mark.parametrize("G", GROUPS)
def test_flash_plan_covers_the_mask_exactly_once(G):
    """For every S, T in LENGTHS, causal or not, window in WINDOWS and both
    kv tile widths (hd 256: 80 keys; hd 128: 128): the CTAs' positions
    partition [0, S); each position's valid keys lie inside its CTA's kv
    tiles lo..hi (each visited once), so every pair the mask keeps is
    covered exactly once and only masked pairs are skipped; where every
    row of a CTA has a valid key, lo and hi are the tiles of its first
    and last valid key (no kv tile is visited that no row needs); and a
    causal layer without a window launches its CTAs longest range first."""
    for S in LENGTHS:
        for T in LENGTHS:
            for causal in (True, False):
                for window in WINDOWS:
                    any_, first, last = _mask_rows(S, T, causal, window)
                    for hd in (256, 128):
                        plan = tfa.flash_plan(S, T, G, causal, window, hd)
                        assert plan.positions == tfa.ROWS // G
                        assert plan.bn == tfa.kv_tile(hd)
                        owner = np.full(S, -1)
                        work = []
                        for i in range(plan.tiles):
                            s0, s1, lo, hi = kernel_tile(plan, i)
                            assert 0 <= s0 < s1 <= S
                            assert s1 - s0 <= plan.positions
                            assert (owner[s0:s1] == -1).all()
                            owner[s0:s1] = i
                            work.append(hi - lo + 1)
                            rows = np.arange(s0, s1)[any_[s0:s1]]
                            if len(rows) == 0:
                                continue
                            assert lo * plan.bn <= first[rows].min()
                            assert last[rows].max() < (hi + 1) * plan.bn
                            if len(rows) == s1 - s0:
                                assert lo == first[rows].min() // plan.bn
                                assert hi == last[rows].max() // plan.bn
                        assert (owner >= 0).all()
                        if causal and not window:
                            assert work == sorted(work, reverse=True)


def test_flash_plan_refuses_groups_past_a_tile():
    """More than 128 query heads per kv head leave no position for a CTA's
    128 rows: the plan (and so the wrapper) raises."""
    with pytest.raises(ValueError, match="G = H/K"):
        tfa.flash_plan(64, 64, 129, True, 0, 128)


# --------------------------------------------------------- the q box ----
def tma_box(flat, dims, strides, box, coords):
    """What a TMA tensor copy lands in shared memory: the box (``box[0]``
    innermost) at ``coords`` of a tensor ``dims`` (innermost first) with
    element ``strides`` (dimension 0 contiguous) over ``flat``, row-major
    from the outermost box dimension in, zeros past the tensor's edge."""
    idx = np.indices(tuple(reversed(box)))       # outermost first
    n = len(box)
    c = [coords[d] + idx[n - 1 - d] for d in range(n)]
    inside = np.all([c[d] < dims[d] for d in range(n)], axis=0)
    off = sum(np.where(inside, c[d], 0) * strides[d] for d in range(n))
    return np.where(inside, flat[off], 0).astype(flat.dtype)


@pytest.mark.parametrize("G", GROUPS)
def test_q_box_rows_are_the_fused_rows(G):
    """B = 2 sequences of S = 37 positions (a ragged last CTA), K = 2 kv
    heads, hd = 128 (two 64-column chunks): the kernel's q box of chunk c
    at (c*64, kh*G, s0, b) over q viewed as (hd, H, S, B) gives smem row
    r = p*G + g = q[b, s0 + p, kh*G + g, chunk c], zero past S; these are
    the Pallas kernel's fused (G, bq) rows of the same positions; and the
    rows the epilogue keeps (r < P*G, position < S) write every
    (position, head) of each kv head exactly once."""
    B, S, K, hd = 2, 37, 2, 128
    H = K * G
    rng = np.random.default_rng(G)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    plan = tfa.flash_plan(S, S, G, True, 0, hd)
    P = plan.positions
    dims = (hd, H, S, B)
    strides = (1, hd, H * hd, S * H * hd)
    # the Pallas kernel's layout: (B*K, G, S, hd), a tile (G, bq) of it
    fused = q.reshape(B, S, K, G, hd).transpose(0, 2, 3, 1, 4) \
        .reshape(B * K, G, S, hd)
    written = np.zeros((B, S, H), int)
    for b in range(B):
        for kh in range(K):
            for i in range(plan.tiles):
                s0, s1, _, _ = kernel_tile(plan, i)
                chunks = [tma_box(q.reshape(-1), dims, strides, (64, G, P, 1),
                                  (c * 64, kh * G, s0, b)).reshape(P * G, 64)
                          for c in range(hd // 64)]
                tile = np.concatenate(chunks, axis=1)
                for r in range(tfa.ROWS):
                    p, g = r // G, r % G
                    if r >= P * G:
                        continue              # idle rows: never stored
                    if s0 + p >= S:
                        assert not tile[r].any()
                        continue
                    assert np.array_equal(tile[r], q[b, s0 + p, kh * G + g])
                    assert np.array_equal(tile[r],
                                          fused[b * K + kh, g, s0 + p])
                    written[b, s0 + p, kh * G + g] += 1
    assert (written == 1).all()


# ------------------------------------------- S accumulator -> P frag ----
def d_slot(warp, lane, e):
    """(row, column) of accumulator register e of thread (warp, lane) in
    wgmma's m64nN fp32 D fragment (PTX ISA, "Register fragment layout for
    accumulator matrix D", .m64nNk16): warp w owns rows 16w..16w+15;
    registers 4j..4j+3 hold columns 8j + 2*tig, +1 of row gid (0, 1) and
    of row gid + 8 (2, 3)."""
    gid, tig = lane // 4, lane % 4
    return (16 * warp + gid + 8 * ((e >> 1) & 1),
            8 * (e // 4) + 2 * tig + (e & 1))


def a_slot(warp, lane, kt, r, half):
    """(row, k) of half ``half`` (0: low 16 bits) of register r of the
    16-deep step kt in wgmma's m64k16 bf16 A fragment (PTX ISA, "Register
    fragment layout for matrix A", .m64nNk16 with .bf16): registers 0 and
    2 hold row gid, 1 and 3 row gid + 8; 0 and 1 hold k 2*tig, +1 and 2
    and 3 k 8 + 2*tig, +1."""
    gid, tig = lane // 4, lane % 4
    return (16 * warp + gid + 8 * (r & 1),
            16 * kt + 8 * (r >> 1) + 2 * tig + half)


@pytest.mark.parametrize("bn", [64, 128])
def test_s_accumulator_repacks_into_p_fragments(bn):
    """The kernel forms A register pa[j // 4][j % 4] of each thread from
    its S registers (sc[2j], sc[2j + 1]) (low, high half). Each such half
    sits, in the A layout, at exactly the (row, key) the D layout gives
    its S register; over the 128 threads the A fragments of the bn/16
    steps fill the 64 x bn slots once. The kernel's own index arithmetic
    (mask key 8*(e/4) + 2*tig + (e & 1), row half (e >> 1) & 1; P row
    half j & 1) agrees with the documented D layout."""
    seen = {}
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            for e in range(bn // 2):
                row, col = d_slot(warp, lane, e)
                assert col == 8 * (e // 4) + 2 * tig + (e & 1)
                assert row == 16 * warp + gid + 8 * ((e >> 1) & 1)
            for j in range(bn // 4):
                for half in range(2):
                    a = a_slot(warp, lane, j // 4, j % 4, half)
                    assert a == d_slot(warp, lane, 2 * j + half)
                    assert a[0] == 16 * warp + gid + 8 * (j & 1)
                    seen[a] = seen.get(a, 0) + 1
    assert len(seen) == 64 * bn and set(seen.values()) == {1}


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_output_fragment_writes_each_element_once(hd):
    """The epilogue stores o[4j + 2h + c] of thread (warp, lane) as row
    16w + gid + 8h, column 8j + 2tig + c: the m64n(hd) D layout, each of
    the 64 x hd elements of a consumer's rows once."""
    seen = set()
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane // 4, lane % 4
            for j in range(hd // 8):
                for h in range(2):
                    for c in range(2):
                        e = 4 * j + 2 * h + c
                        slot = (16 * warp + gid + 8 * h, 8 * j + 2 * tig + c)
                        assert d_slot(warp, lane, e) == slot
                        seen.add(slot)
    assert len(seen) == 64 * hd


# -------------------------------------------- the rounding points ----
def emulate(q, k, v, *, causal, window, cap, cap_after_mask=False,
            l_unrounded=False):
    """The kernel's arithmetic in plain torch, fp32 out (round it to bf16
    for the kernel's output): per (sequence, kv head) and plan CTA, its G
    heads' rows against kv tiles lo..hi of bn keys (zero past T, masked);
    scores (q k^T) in fp32 times hd**-0.5 with log2(e) folded in, the cap
    cap*log2(e)*tanh(s*scale/cap) before the mask as the kernel's
    softcap2 computes it, cap2 - 2*cap2 / (1 + 2**(2*log2(e)*s*scale/cap))
    (a plain cap after the mask, with ``cap_after_mask``), masked -1e30,
    m from -1e30, exp2, P rounded to bf16 for P v and for l (l over the
    unrounded weights with ``l_unrounded``), l clamped at 1e-30."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    plan = tfa.flash_plan(S, T, G, causal, window, hd)
    bn = plan.bn
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    mul = 2 * LOG2E * scale / cap if cap else scale * LOG2E
    cap2 = cap * LOG2E
    q, k, v = q.float(), k.float(), v.float()
    pad = -(-T // bn) * bn - T
    kp = torch.cat([k, k.new_zeros((B, pad, K, hd))], 1)
    vp = torch.cat([v, v.new_zeros((B, pad, K, hd))], 1)
    out = torch.zeros((B, S, H, hd))
    for b in range(B):
        for kh in range(K):
            for i in range(plan.tiles):
                s0, s1, lo, hi = kernel_tile(plan, i)
                qt = q[b, s0:s1, kh * G:(kh + 1) * G].reshape(-1, hd)
                pos = torch.arange(s0, s1).repeat_interleave(G)[:, None]
                m = torch.full((qt.shape[0],), -1e30)
                l = torch.zeros(qt.shape[0])
                acc = torch.zeros((qt.shape[0], hd))
                for j in range(lo, hi + 1):
                    kt = kp[b, j * bn:(j + 1) * bn, kh]
                    vt = vp[b, j * bn:(j + 1) * bn, kh]
                    s = qt @ kt.T
                    key = torch.arange(j * bn, (j + 1) * bn)[None, :]
                    valid = key < T
                    if causal:
                        valid = valid & (key <= pos)
                    if window:
                        valid = valid & (key > pos - window)
                    if cap and cap_after_mask:
                        x = torch.where(valid, s * scale, -1e30)
                        x = cap * LOG2E * torch.tanh(x / cap)
                    else:
                        x = cap2 - 2 * cap2 / (1 + torch.exp2(s * mul)) \
                            if cap else s * mul
                        x = torch.where(valid, x, -1e30)
                    mx = torch.maximum(m, x.max(1).values)
                    corr = torch.exp2(m - mx)
                    m = mx
                    p_raw = torch.exp2(x - m[:, None])
                    p = p_raw.bfloat16().float()
                    l = l * corr + (p_raw if l_unrounded else p).sum(1)
                    acc = acc * corr[:, None] + p @ vt
                o = acc / torch.clamp(l, min=1e-30)[:, None]
                out[b, s0:s1, kh * G:(kh + 1) * G] = o.reshape(s1 - s0, G,
                                                               hd)
    return out


def _bf16_inputs(B, S, T, H, K, hd, q_scale, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd)) * q_scale)
    k = torch.from_numpy(rng.standard_normal((B, T, K, hd)))
    v = torch.from_numpy(rng.standard_normal((B, T, K, hd)))
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


@pytest.mark.parametrize("hd", [32, 128, 256])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 64, 50.0), (False, 0, 0.0), (True, 0, 50.0)])
def test_rounding_points_match_reference_and_pallas(hd, causal, window,
                                                    cap):
    """B = 1, S = T = 256, H = 4, K = 2 (G = 2), bf16 inputs (q scaled by
    20 with the cap, so that scores reach it): the emulation, rounded to
    bf16, matches flash_attention_ref (bf16 out) and the Pallas kernel in
    interpret mode (fp32 out, on the same bf16 values) at the kernel
    tolerance; with a cap, the reference without it misses."""
    q, k, v = _bf16_inputs(1, 256, 256, 4, 2, hd, 20.0 if cap else 1.0,
                           seed=hd + window)
    kw = dict(causal=causal, window=window, cap=cap)
    got = emulate(q, k, v, **kw).bfloat16().float()
    want = tref.flash_attention_ref(q, k, v, **kw).float()
    assert bf16_close(got, want)
    pallas = jfa.flash_attention_fwd(*(t.float().numpy() for t in (q, k, v)),
                                     bq=64, bkv=64, interpret=True, **kw)
    assert bf16_close(got, torch.from_numpy(np.array(pallas)))
    if cap:
        nocap = tref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window).float()
        assert not bf16_close(nocap, want)


def test_cap_after_the_mask_misses():
    """Scores held at the cap's floor (q = +20, k = -1 plus noise: every
    capped score about -50, hd 32) make the mask's order visible: capped
    before the mask, masked keys stay at -1e30 and weigh nothing; capped
    after it they become -50, as heavy as the valid ones. The kernel's
    order matches the reference; the other misses it."""
    rng = np.random.default_rng(3)
    S, hd = 256, 32
    q = torch.from_numpy(20.0 + rng.standard_normal((1, S, 4, hd)) * 0.1)
    k = torch.from_numpy(-1.0 + rng.standard_normal((1, S, 2, hd)) * 0.1)
    v = torch.from_numpy(rng.standard_normal((1, S, 2, hd)))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kw = dict(causal=True, window=0, cap=50.0)
    want = tref.flash_attention_ref(q, k, v, **kw).float()
    assert bf16_close(emulate(q, k, v, **kw).bfloat16().float(), want)
    after = emulate(q, k, v, cap_after_mask=True, **kw).bfloat16().float()
    assert not bf16_close(after, want)


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_l_over_rounded_weights_keeps_a_convex_combination(cap):
    """With v constant (0.75 everywhere), an output that is a convex
    combination of v rows is 0.75. The kernel's l, summed over the same
    bf16-rounded weights that multiply v, keeps that to fp32 rounding
    (1e-6) on random scores; l over the unrounded weights scales each row
    by (sum of rounded) / (sum of unrounded) and misses it."""
    q, k, _ = _bf16_inputs(1, 256, 256, 4, 2, 64, 20.0 if cap else 1.0,
                           seed=11)
    v = torch.full((1, 256, 2, 64), 0.75).bfloat16()
    kw = dict(causal=True, window=64, cap=cap)
    got = emulate(q, k, v, **kw)
    assert float((got - 0.75).abs().max()) <= 1e-6
    assert bf16_close(got.bfloat16().float(),
                      tref.flash_attention_ref(q, k, v, **kw).float())
    off = emulate(q, k, v, l_unrounded=True, **kw)
    assert float((off - 0.75).abs().max()) > 1e-5
    assert math.isfinite(float(off.abs().max()))


@pytest.mark.parametrize("hd", [64, 256])
def test_l_over_unrounded_weights_moves_the_bf16_output(hd):
    """On ``flash_rounding_probe``'s scores, where every weight but one
    rounds down by nearly 2**-8 and v is constant: the emulation, rounded
    to bf16 as the kernel rounds its output, gives v exactly, as the
    reference does; l over the unrounded weights gives the bf16 value
    one ulp below it in every element."""
    q, k, v = flash_rounding_probe(hd)
    kw = dict(causal=False, window=0, cap=0.0)
    got = emulate(q, k, v, **kw).bfloat16()
    assert bool((got == PROBE_V).all())
    assert bool((tref.flash_attention_ref(q, k, v, **kw) == PROBE_V).all())
    off = emulate(q, k, v, l_unrounded=True, **kw).bfloat16()
    assert bool((off == PROBE_V_UNROUNDED_L).all())
