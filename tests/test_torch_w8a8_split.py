"""The redesigned W8A8 kernel's operand layout and arithmetic, on the CPU:
a numpy emulation of how each thread of the s8 wgmma kernel forms its
8-bit A fragments from the code tile (four 32-bit loads of four channels
each, a 4x4 byte transpose), held against wgmma's documented m64k32
8-bit A layout; and an emulation of the split-K plan's int32 partials,
their reduction in split order and the rescale, held bit for bit against
the port's plain version and within two fp32 roundings of the reference's
Pallas kernel in interpret mode. The CUDA kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. The int32 products and their sums are exact, and the rescale
runs in the plain version's order, (float(acc) * x_scale) * w_scale, so
the emulation equals ``ref.quant_matmul_w8a8`` bit for bit in fp32 at
every split count. The Pallas kernel multiplies x_scale * w_scale first:
each side rounds twice, so the two differ by at most 2**-22 of the
result (two fp32 roundings of a half ulp each, on either side)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_cases import split_chunks  # noqa: E402

torch.set_num_threads(1)

# gemma2-2b's projections (K, N): q/o, the kv pair, ffn in/gate, ffn out
PROJECTIONS = ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
               (9216, 2304))
ROWS = (1, 2, 8, 37, 2000)
COLS = 64           # output channels emulated of each projection


# ------------------------------------------------ the A fragment ----------
def swizzled(off, bc):
    """The byte offset TMA stores byte ``off`` of a tile of bc-byte rows
    at, and the kernel reads it back from (quant_matmul.cu::swizzled):
    128-byte rows XOR bits 4-6 with 7-9, 64-byte rows bits 4-5 with 7-8."""
    return off ^ ((off >> 3) & (0x70 if bc == 128 else 0x30))


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on words as lists of 4 bytes (byte 0 first):
    result byte i is byte (sel >> 4i) & 7 of the 8 bytes x then y."""
    src = list(x) + list(y)
    return [src[(sel >> (4 * i)) & 7] for i in range(4)]


def thread_fragments(smem, mt, warp, gid, tig, kk):
    """af[t][r]: the four bytes of A register r of m64 tile t that thread
    (warp, gid, tig) forms for the k32 product kk, as the kernel does: 32-
    bit loads of its 2*MT channels cb.. at k rows 32kk + 4tig + i and 16
    more (``load_codes``), then ``s8_fragment``'s byte transpose."""
    bc = 64 * mt
    cb = 2 * mt * (8 * warp + gid)
    words = []
    for base in (32 * kk + 4 * tig, 32 * kk + 16 + 4 * tig):
        for i in range(4):
            off = swizzled((base + i) * bc + cb, bc)
            word = list(smem[off:off + 2 * mt])
            words.append(word + [None] * (4 - len(word)))   # 16-bit load
    af = [[None] * 4 for _ in range(mt)]
    for q in range(2):
        r = words[4 * q:4 * q + 4]
        lo01 = byte_perm(r[0], r[1], 0x5140)
        lo23 = byte_perm(r[2], r[3], 0x5140)
        af[0][2 * q] = byte_perm(lo01, lo23, 0x5410)
        af[0][2 * q + 1] = byte_perm(lo01, lo23, 0x7632)
        if mt == 2:
            hi01 = byte_perm(r[0], r[1], 0x7362)
            hi23 = byte_perm(r[2], r[3], 0x7362)
            af[1][2 * q] = byte_perm(hi01, hi23, 0x5410)
            af[1][2 * q + 1] = byte_perm(hi01, hi23, 0x7632)
    return af


def wgmma_a_slot(warp, gid, tig, r, b):
    """(row, k) of byte b of A register r in wgmma's m64nNk32 8-bit A
    fragment (PTX ISA, "Register fragment layout for matrix A",
    .m64nNk32; CUTLASS's ALayout_64x32): warp w owns rows 16w..16w+15;
    registers 0 and 2 hold row gid, 1 and 3 row gid + 8; registers 0 and 1
    hold k 4tig..4tig+3, 2 and 3 k 16 + 4tig..; byte b is k + b."""
    return 16 * warp + gid + 8 * (r % 2), 4 * tig + 16 * (r // 2) + b


def tagged_tile(mt):
    """The code tile as TMA lands it: byte (k, c) of the logical 64 x 64MT
    tile, tagged with its coordinates, at its swizzled offset."""
    bc = 64 * mt
    smem = [None] * (64 * bc)
    for k in range(64):
        for c in range(bc):
            smem[swizzled(k * bc + c, bc)] = (k, c)
    return smem


@pytest.mark.parametrize("mt", [1, 2])
def test_a_fragment_covers_the_tile_in_wgmma_layout(mt):
    """Every byte a thread's A registers hold, placed where wgmma's 8-bit
    A layout reads it (row, k), is code (k0 + k, c) of one channel c per
    (tile, row): each m64k32 tile's 64 x 32 slots filled exactly once, by
    the channel the epilogue writes for that row (cb + 2t, and cb + 2t + 1
    for row gid + 8), the MT tiles together covering the CTA's 64*MT
    channels x 64 k exactly once per K step."""
    smem = tagged_tile(mt)
    seen = set()
    for kk in range(2):
        for t in range(mt):
            slots = {}
            for warp in range(4):
                for lane in range(32):
                    gid, tig = lane // 4, lane % 4
                    af = thread_fragments(smem, mt, warp, gid, tig, kk)
                    for r in range(4):
                        for b in range(4):
                            row, k = wgmma_a_slot(warp, gid, tig, r, b)
                            code = af[t][r][b]
                            assert code is not None
                            assert (row, k) not in slots
                            slots[(row, k)] = code
                            cb = 2 * mt * (8 * warp + gid)
                            assert code == (32 * kk + k,
                                            cb + 2 * t + (row % 16 >= 8))
                            seen.add(code)
            assert len(slots) == 64 * 32
            assert {row for row, _ in slots} == set(range(64))
    assert seen == {(k, c) for k in range(64) for c in range(64 * mt)}


@pytest.mark.parametrize("mt", [1, 2])
def test_a_fragment_product_equals_codes_product(mt):
    """The emulated registers as wgmma multiplies them: for each k32
    product, A (64 rows x 32 k, built from the thread fragments through
    the documented layout) times B (32 k x 8 tokens of x) accumulated in
    int32 over the K step, rows mapped to channels as the epilogue maps
    them, equals codes^T x^T exactly; a layout with rows gid and gid + 8
    swapped must not."""
    rng = np.random.default_rng(mt)
    bc = 64 * mt
    codes = rng.integers(-127, 128, (64, bc)).astype(np.int64)
    x = rng.integers(-127, 128, (8, 64)).astype(np.int64)
    smem = [None] * (64 * bc)
    for k in range(64):
        for c in range(bc):
            smem[swizzled(k * bc + c, bc)] = int(codes[k, c])
    out = np.zeros((bc, 8), np.int64)
    swapped = np.zeros((bc, 8), np.int64)
    for t in range(mt):
        acc = np.zeros((64, 8), np.int64)
        row_channel = {}
        for kk in range(2):
            a = np.zeros((64, 32), np.int64)
            for warp in range(4):
                for lane in range(32):
                    gid, tig = lane // 4, lane % 4
                    af = thread_fragments(smem, mt, warp, gid, tig, kk)
                    cb = 2 * mt * (8 * warp + gid)
                    for r in range(4):
                        for b in range(4):
                            row, k = wgmma_a_slot(warp, gid, tig, r, b)
                            a[row, k] = af[t][r][b]
                            row_channel[row] = cb + 2 * t + (row % 16 >= 8)
            acc += a @ x[:, 32 * kk:32 * kk + 32].T
        for row, c in row_channel.items():
            out[c] = acc[row]
            swapped[c] = acc[row ^ 8]
    want = codes.T @ x.T
    assert np.array_equal(out, want)
    assert not np.array_equal(swapped, want)


# ------------------------------------------- split-K and the rescale ------
def emulate_w8a8(xq, xs, wq, ws, n_split, *, drop_split=False,
                 pallas_order=False):
    """What the s8 wgmma kernel and its reduce compute: per split, the
    exact int32 product over its K chunk; the partials summed in split
    order (exact); then (float(acc) * x_scale) * w_scale in fp32 (or, for
    ``pallas_order``, float(acc) * (x_scale * w_scale))."""
    parts = [(xq[:, k0:k1].double() @ wq[k0:k1].double()).to(torch.int32)
             for k0, k1 in split_chunks(xq.shape[1], n_split)]
    if drop_split:
        parts = parts[1:]
    acc = parts[0].to(torch.int64)
    for p in parts[1:]:
        acc = acc + p
    assert int(acc.abs().max()) < 2 ** 31      # no int32 overflow
    accf = acc.to(torch.int32).to(torch.float32)
    if pallas_order:
        return accf * (xs * ws[None, :])
    return accf * xs * ws[None, :]


def _case(M, K, N, per_tensor, seed):
    """x quantized per tensor and COLS output channels of a K x N weight
    quantized per channel (or, ``per_tensor``, one scale), as the hook
    makes them."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((K, COLS)).astype(np.float32)
                         * K ** -0.5)
    wq, ws = tref.quantize_w8(w)
    if per_tensor:
        ws = ws.amax().reshape(1)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    xq, xs = tref.quantize_a8(x)
    return xq, xs, wq, ws


@pytest.mark.parametrize("K,N", PROJECTIONS)
def test_split_reduce_and_rescale_bit_identical(K, N):
    """At every M in {1, 2, 8, 37, 2000} and the split count qmm_splits
    gives for the full projection (up to 18 at decode, 2 at M = 2000 on
    the kv projection), the emulated int32 partials, summed in split order
    and rescaled in the plain version's order, equal ref.quant_matmul_w8a8
    bit for bit in fp32, and its bf16 output is that fp32 result rounded
    once; both scale forms. Controls: dropping a split, and the Pallas
    kernel's order of the scales, must change some bits."""
    order_seen = False
    for M in ROWS:
        n_split = tqm.qmm_splits(M, N, K)
        assert (K // tqm.TILE) % n_split == 0
        for per_tensor in (False, True):
            xq, xs, wq, ws = _case(M, K, N, per_tensor, seed=M + K + N)
            want = tref.quant_matmul_w8a8(xq, xs, wq, ws, torch.float32)
            got = emulate_w8a8(xq, xs, wq, ws, n_split)
            assert torch.equal(got, want), (M, n_split, per_tensor)
            assert torch.equal(got.bfloat16(),
                               tref.quant_matmul_w8a8(xq, xs, wq, ws))
            if n_split > 1:
                assert not torch.equal(emulate_w8a8(
                    xq, xs, wq, ws, n_split, drop_split=True), want)
            if not per_tensor:
                order_seen |= not torch.equal(emulate_w8a8(
                    xq, xs, wq, ws, n_split, pallas_order=True), want)
    assert order_seen


def test_split_plan_splits_the_decode_projections():
    """The plan the kernel shares with W8A16: at M = 8 every projection
    but the lm_head is split (9, 18, 8, 2, 8 ways), a 4096-row chunk never
    is; the grid holds at least 132 CTAs where split."""
    want = {(2304, 2048): 9, (2304, 1024): 18, (2048, 2304): 8,
            (2304, 9216): 2, (9216, 2304): 8}
    for (K, N), n in want.items():
        plan = tqm.qmm_plan(8, N, K)
        assert plan["n_split"] == n and plan["BT"] == 8 and plan["MT"] == 2
        gx, gy, gz = plan["grid"]
        assert gx * gy * gz >= tqm.SMS and gz == n
        assert tqm.qmm_plan(4096, N, K)["n_split"] == 1
    assert tqm.qmm_plan(8, 256000, 2304)["n_split"] == 1


@pytest.mark.parametrize("K,N", PROJECTIONS)
def test_within_two_roundings_of_pallas(K, N):
    """At the decode-sized M the reference's Pallas kernel takes (its
    blocks must divide M: 1, 2, 8, 37), run in interpret mode on the same
    int8 inputs, both scale forms: the emulated split kernel is within
    2**-22 of each output (the Pallas kernel rounds x_scale * w_scale
    first; each side rounds twice)."""
    for M in (1, 2, 8, 37):
        n_split = tqm.qmm_splits(M, N, K)
        for per_tensor in (False, True):
            xq, xs, wq, ws = _case(M, K, N, per_tensor, seed=M * K + N)
            got = emulate_w8a8(xq, xs, wq, ws, n_split)
            pallas = torch.from_numpy(np.array(jqmm.quant_matmul_w8a8(
                jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()),
                jnp.asarray(wq.numpy()),
                jnp.asarray(ws.expand(COLS).contiguous().numpy()),
                out_dtype=jnp.float32, interpret=True)))
            assert bool(((got - pallas).abs()
                         <= 2.0 ** -22 * pallas.abs()).all()), (M, K, N)
