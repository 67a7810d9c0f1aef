"""Time the port's flash-attention kernel (src/repro_torch/kernels/
flash_attention.py::flash_attention_fwd) on the card at whole-prompt
prefill shapes: B = 1, S in {2048, 2560, 4096, 8192}, causal, gemma2-2b's
heads (H = 8, K = 4, hd = 256: G = 2) and granite-3-8b's (H = 32, K = 8,
hd = 128: G = 4), a global and a local (window 4096) layer, cap 0 and 50.
Beside each: one PyTorch call the port never calls (``scaled_dot_product_attention``: is_causal where the
window reaches every key, else a boolean mask; it has no softcap), and the
bound (4*hd flops per valid (query head, key) pair over 989 TFLOP/s, or
q, k, v and the output once over 3.35 TB/s, the larger). With ``--other
DIR`` (a checkout of another commit, such as the parent, unpacked under a
git-ignored directory) that checkout's kernel is timed too, in turns:
other, this, this, other, each in its own process, so both are compared
on one card in one call. ``--sass`` instead counts, per kernel instance
of the built flash_attention library, the tensor-core instructions
``cuobjdump -sass`` shows (HGMMA: wgmma; HMMA: mma.sync) and the waits
on them (DEPBAR: WARPGROUP.DEPBAR), and fails unless every instance has
HGMMA, no HMMA and fewer waits than products (ptxas waits after every
product when it serializes them). Needs a CUDA card (and, for
``--sass``, the CUDA toolkit); prints one line per case and a JSON
summary.

    python scripts/bench_torch_flash.py [--other DIR] [--out FILE] [--sass]
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (2048, 2560, 4096, 8192)
HEADS = ((8, 4, 256), (32, 8, 128))     # (H, K, hd)
LAYERS = ((0, "global"), (4096, "local"))
CAPS = (0.0, 50.0)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
REPS = 10


def device_ms(fn, reps=REPS):
    """Device ms of one ``fn()``: ``reps`` calls captured in a CUDA graph
    and replayed 3 times between CUDA events (the host's launch cost out
    of the measurement)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / (3 * reps)


def valid_pairs(S, window):
    """(query, key) pairs a causal layer over S tokens keeps."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def bound_ms(S, H, K, hd, window):
    t_bytes = 2 * (2 * S * H * hd + 2 * S * K * hd) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * hd * H * valid_pairs(S, window) / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, window):
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not window or window >= q.shape[1]:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def worker(root: Path, extra: bool):
    """Time ``root``'s kernel (and, with ``extra``, SDPA); print one JSON
    object of case -> numbers."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for H, K, hd in HEADS:
        for S in LENGTHS:
            q0 = torch.randn((1, S, H, hd), generator=g, device="cuda")
            k = torch.randn((1, S, K, hd), generator=g, device="cuda") \
                .bfloat16()
            v = torch.randn((1, S, K, hd), generator=g, device="cuda") \
                .bfloat16()
            for window, label in LAYERS:
                lib_ms = None
                if extra:
                    lib_ms = device_ms(sdpa_call(q0.bfloat16(), k, v,
                                                 window))
                for cap in CAPS:
                    q = (q0 * (20.0 if cap else 1.0)).bfloat16()
                    row = {"ms": device_ms(lambda: fa.flash_attention_fwd(
                        q, k, v, causal=True, window=window, cap=cap))}
                    if extra:
                        row["library_ms"] = lib_ms
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        S, H, K, hd, window)
                    row["tflops"] = (4e-9 * hd * H * valid_pairs(S, window)
                                     / row["ms"])
                    out[f"H={H} K={K} hd={hd} S={S} {label} cap={cap:g}"] = \
                        row
                    del q
            del q0, k, v
            torch.cuda.empty_cache()
    print(json.dumps(out))


def sass_counts() -> dict:
    """Kernel instance -> {instruction: count} of the tensor-core
    instructions in this checkout's built flash_attention library."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.compile_library("flash_attention")
    tool = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run(
        [str(tool), "-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts.setdefault(fn, {})
            continue
        op = re.search(r"\b(HGMMA|HMMA)\.|WARPGROUP\.(DEPBAR)", line)
        if op and fn:
            name = op.group(1) or op.group(2)
            c = counts[fn]
            c[name] = c.get(name, 0) + 1
    return counts


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default="",
                    help="root of another checkout to time in turns")
    ap.add_argument("--out", default="", help="write the JSON summary here")
    ap.add_argument("--sass", action="store_true",
                    help="count tensor-core SASS instructions and stop")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--extra", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker).resolve(), args.extra)
        return 0
    if args.sass:
        counts = sass_counts()
        totals = {}
        for fn, c in sorted(counts.items()):
            print(f"{fn}: {json.dumps(c)}")
            for op, n in c.items():
                totals[op] = totals.get(op, 0) + n
        print(json.dumps({"sass_totals": totals}))
        flash = {fn: c for fn, c in counts.items() if "flash_fwd" in fn}
        if not flash or any(c.get("HMMA") or not c.get("HGMMA")
                            or c.get("DEPBAR", 0) >= c["HGMMA"]
                            for c in flash.values()):
            print("bench_torch_flash: a flash instance lacks HGMMA, has "
                  "HMMA or serializes its products", file=sys.stderr)
            return 1
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_flash: no CUDA device", file=sys.stderr)
        return 2
    order = [("this", ROOT)] * 2
    if args.other:
        other = Path(args.other).resolve()
        order = [("other", other)] + order + [("other", other)]
    runs = {"this": [], "other": []}
    for i, (label, root) in enumerate(order):
        extra = label == "this" and not runs["this"]
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root)] + (["--extra"] if extra else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {"card": card_line(), "cases": {}}
    for case, first in runs["this"][0].items():
        row = dict(first, ms=[r[case]["ms"] for r in runs["this"]])
        if runs["other"]:
            row["other_ms"] = [r[case]["ms"] for r in runs["other"]]
        summary["cases"][case] = row
        other = f" other {row['other_ms']}" if runs["other"] else ""
        print(f"{case}: ms {row['ms']}{other} sdpa "
              f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}) {row['tflops']:.1f} TFLOP/s",
              flush=True)
    print(summary["card"])
    print(json.dumps(summary))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
