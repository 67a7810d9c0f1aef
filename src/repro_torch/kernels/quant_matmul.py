"""Python wrappers of the hand-written Hopper weight-quantized matmuls
(``csrc/quant_matmul.cu``): HAQ's serving-time runtime.

Each replaces the Pallas TPU kernel of the same name in
``repro.kernels.quant_matmul``:
  * ``quant_matmul_w8a16`` — x (M, K) bf16/fp32 times int8 codes (K, N),
    in fp32, times the weight scale, cast to x's type;
  * ``quant_matmul_w4a16`` — the same over int4 codes packed two per byte
    along K (K//2, N): row 2i in the low nibble, 2i+1 in the high one;
  * ``quant_matmul_w8a8`` — int8 x times int8 codes into an exact int32
    accumulator, rescaled (acc * x_scale) * w_scale, cast to ``out_dtype``.
The weight scale is (N,), one per output channel as the reference's
kernels take it, or (1,), one per tensor as ``serving/quant.py`` stores it
(the kernel reads it with a stride of 0).

What bounds them on the H100: at decode (M = 8) the bytes of the stored
codes over 3.35 TB/s, which int4 halves; at a 4096-row prefill chunk the
operations over the tensor cores' rate. W8A16/W4A16 over bf16 x (what the
engine runs) launch one ``wgmma`` product, out^T = W^T x^T: the codes,
converted in registers, are its A operand and the tokens its N axis
(``token_tile``), fed by a TMA ring; where the grid would have fewer CTAs
than the card's 132 SMs (a decode tick), K is split (``qmm_splits``) into
fp32 partials that a second kernel sums in a fixed order. W8A8 runs the
same design on an s8 ``wgmma`` (the codes wgmma's A operand as stored,
int8 x its B operand) into an exact int32 accumulator; split, its int32
partials are summed and rescaled by a second kernel, so an fp32 output is
bit-identical to the plain version at any split count. fp32 x through
W8A16/W4A16 keeps the ``mma.sync`` template (``qmm_kernel``). The wrapper
picks the kernel by x's dtype alone. See the source's header note.

On a CPU tensor each wrapper returns its plain version from
``kernels/ref.py``; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper, nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of each kernel; a wrapper adds one where it launches, and only
# there (chip_smoke.py zeroes these around each path it drives)
LAUNCHES = {"quant_matmul_w8a16": 0, "quant_matmul_w4a16": 0,
            "quant_matmul_w8a8": 0}

TILE = 64             # K and N must be multiples of this (the CTA tile)
SMS = 132             # the H100's SMs: the least CTAs a split grid fills


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def token_tile(M: int) -> int:
    """Tokens a wgmma CTA takes (wgmma's N): the least of 8, 16, 32, 64
    that holds M, else 128."""
    for bt in (8, 16, 32, 64):
        if M <= bt:
            return bt
    return 128


def channel_tile(N: int) -> int:
    """Output channels a wgmma CTA takes: two m64 tiles where N allows."""
    return 128 if N % 128 == 0 else 64


def qmm_plan(M: int, N: int, K: int) -> dict:
    """The wgmma kernels' launch plan: token tile BT, m64 tiles MT per
    CTA, K splits and the product's grid (N / 64 MT, ceil(M / BT),
    n_split)."""
    bt, bc, n_split = token_tile(M), channel_tile(N), qmm_splits(M, N, K)
    return {"BT": bt, "MT": bc // 64, "n_split": n_split,
            "grid": (N // bc, -(-M // bt), n_split)}


def qmm_splits(M: int, N: int, K: int) -> int:
    """K splits of the wgmma product, from the shapes alone: 1 when the
    (N / channel_tile) * ceil(M / token_tile) CTAs fill the SMS, else the
    least divisor of the K/64 steps that gives at least SMS CTAs (equal,
    64-aligned chunks), or one step a split."""
    ctas = N // channel_tile(N) * -(-M // token_tile(M))
    steps = K // TILE
    if ctas >= SMS:
        return 1
    return next((s for s in range(2, steps + 1)
                 if steps % s == 0 and (ctas * s >= SMS or s == steps)), 1)


def _check(name, x, w, scale, x_dtypes, rows_per_k, x_scale=None):
    """Validate a launch: device, dtypes, shapes, contiguity, the tile
    multiples and 16-byte alignment. Returns (library, M, N, K,
    scale_stride)."""
    named = [("x", x), ("w", w), ("scale", scale)]
    if x_scale is not None:
        named.append(("x_scale", x_scale))
    if not all(t.is_cuda for _, t in named):
        raise ValueError(f"{name}: every tensor must be on the CUDA device")
    if x.dtype not in x_dtypes or w.dtype != torch.int8 \
            or scale.dtype != torch.float32 \
            or (x_scale is not None and x_scale.dtype != torch.float32):
        raise TypeError(f"{name} takes x in {x_dtypes}, int8 w and fp32 "
                        f"scales, got {x.dtype}, {w.dtype}, {scale.dtype}")
    for n, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x and w must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if w.shape[0] * rows_per_k != K:
        raise ValueError(f"{name}: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if scale.shape not in ((N,), (1,)):
        raise ValueError(f"{name}: scale must be ({N},) or (1,), got "
                         f"{tuple(scale.shape)}")
    if x_scale is not None and x_scale.numel() != 1:
        raise ValueError(f"{name}: x_scale must hold one value")
    if M == 0 or K % TILE or N % TILE:
        raise ValueError(f"{name}: needs M > 0 and K, N multiples of "
                         f"{TILE}, got M={M}, K={K}, N={N}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned "
                         f"(cp.async)")
    return build.load("quant_matmul"), M, N, K, int(scale.shape[0] != 1)


def _split_scratch(M: int, N: int, K: int, dtype, device):
    """(n_split, partials): the wgmma product's K splits and, split, its
    (n_split, M, N) scratch of ``dtype`` (empty when unsplit)."""
    n_split = qmm_splits(M, N, K)
    return n_split, torch.empty(n_split * M * N if n_split > 1 else 0,
                                dtype=dtype, device=device)


def _raise_on(lib, rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.qmm_error_string(rc).decode()}")


def _wa16(name, x, w, scale, rows_per_k):
    """bf16 x: the wgmma kernel (and, split, its reduce); fp32 x: the
    mma.sync template."""
    lib, M, N, K, stride = _check(name, x, w, scale,
                                  (torch.bfloat16, torch.float32),
                                  rows_per_k)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bits = 8 // rows_per_k
    if x.dtype == torch.bfloat16:
        n_split, part = _split_scratch(M, N, K, torch.float32, x.device)
        rc = lib.qmm_wa16_bf16(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), part.data_ptr() or None, M, N,
                               K, stride, bits, n_split, stream)
    else:
        rc = lib.qmm_wa16_f32(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), M, N, K, stride, bits, stream)
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def quant_matmul_w8a16(x, w_q, scale):
    """x (M, K) bf16/fp32, w_q (K, N) int8, scale (N,) or (1,) fp32 ->
    (M, N) x.dtype."""
    if x.device.type == "cpu":
        return ref.quant_matmul_w8a16(x, w_q, scale)
    return _wa16("quant_matmul_w8a16", x, w_q, scale, 1)


def quant_matmul_w4a16(x, w_packed, scale):
    """x (M, K) bf16/fp32, w_packed (K//2, N) int8 (two int4 codes per
    byte along K), scale (N,) or (1,) fp32 -> (M, N) x.dtype."""
    if x.device.type == "cpu":
        return ref.quant_matmul_w4a16(x, w_packed, scale)
    return _wa16("quant_matmul_w4a16", x, w_packed, scale, 2)


def quant_matmul_w8a8(x_q, x_scale, w_q, w_scale, out_dtype=torch.bfloat16):
    """x_q (M, K) int8, x_scale () fp32, w_q (K, N) int8, w_scale (N,) or
    (1,) fp32 -> (M, N) ``out_dtype`` (bf16 or fp32)."""
    if x_q.device.type == "cpu":
        return ref.quant_matmul_w8a8(x_q, x_scale, w_q, w_scale, out_dtype)
    name = "quant_matmul_w8a8"
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype must be bf16 or fp32, got "
                        f"{out_dtype}")
    lib, M, N, K, stride = _check(name, x_q, w_q, w_scale, (torch.int8,), 1,
                                  x_scale=x_scale)
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    n_split, part = _split_scratch(M, N, K, torch.int32, x_q.device)
    rc = lib.qmm_w8a8(x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(),
                      w_scale.data_ptr(), out.data_ptr(),
                      part.data_ptr() or None, M, N, K, stride,
                      int(out_dtype == torch.float32), n_split, stream)
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out
