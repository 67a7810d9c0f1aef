"""Time the port's weight-quantized matmul kernels (src/repro_torch/
kernels/quant_matmul.py: W8A16 and W4A16 over bf16 x, W8A8 over x
quantized to int8 beforehand) on the card at gemma2-2b's five projection
shapes (K, N), at a decode tick's M = 8 and a prefill chunk's M = 4096,
beside one PyTorch call the port never calls (a yardstick): cuBLAS on the
weights pre-dequantized to bf16 for W8A16/W4A16, ``torch._int_mm`` on the
int8 codes for W8A8 (which needs more than 16 rows: at M = 8 it takes x
zero-padded to 24 rows, labelled so), and the bound (bytes over 3.35 TB/s
or operations over 989 TFLOP/s bf16 / 1979 TOP/s int8, the larger). With
``--other DIR`` (a checkout of another commit, such as the parent,
unpacked under a git-ignored directory) the other checkout's kernels are
timed too, in turns: other, this, this, other, each in its own process,
so both are compared on one card in one call. ``--sass`` instead counts,
per kernel instance of the built quant_matmul library, the tensor-core
instructions ``cuobjdump -sass`` shows (HGMMA/IGMMA: wgmma; HMMA/IMMA:
mma.sync). Needs a CUDA card (and, for ``--sass``, the CUDA toolkit);
prints one line per case and a JSON summary.

    python scripts/bench_torch_qmm.py [--other DIR] [--out FILE] [--sass]
"""
import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROJECTIONS = ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
               (9216, 2304))
ROWS = (8, 4096)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
COLD_BYTES = 200 * 10 ** 6     # weight copies cycled past the 50 MB L2
KERNELS = ("quant_matmul_w8a16", "quant_matmul_w4a16", "quant_matmul_w8a8")
INT_MM_MIN_ROWS = 24           # torch._int_mm needs more than 16 rows


def device_ms(fn, arg_sets, reps):
    """Device ms of one ``fn(*args)``: ``reps`` calls cycling through
    ``arg_sets``, captured in a CUDA graph and replayed 3 times between
    CUDA events (the host's launch cost out of the measurement)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (3 * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound_ms(name, M, K, N):
    w8a8 = name == "quant_matmul_w8a8"
    code_bytes = K * N // 2 if name == "quant_matmul_w4a16" else K * N
    x_bytes = M * K * (1 if w8a8 else 2)
    t_bytes = (x_bytes + code_bytes + 4 * N + 2 * M * N) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * K * N / (INT8_OPS if w8a8 else BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(name, x, codes, unpacked, scale, cold):
    """(fn, arg sets, label) of the yardstick: cuBLAS on the weight
    dequantized to bf16, or torch._int_mm on x quantized to int8 (zero-
    padded to INT_MM_MIN_ROWS rows where it has fewer) and the codes as a
    column-major B; ``cold`` bytes of weight copies."""
    import torch
    from repro_torch.kernels import ref
    if name != "quant_matmul_w8a8":
        w = (unpacked.float() * scale).bfloat16()
        a = x
        fn, label = torch.matmul, "torch.matmul"
    else:
        a, _ = ref.quantize_a8(x)
        if a.shape[0] < INT_MM_MIN_ROWS:
            a = torch.cat([a, a.new_zeros((INT_MM_MIN_ROWS - a.shape[0],
                                           a.shape[1]))])
            label = f"torch._int_mm, x padded to {INT_MM_MIN_ROWS} rows"
        else:
            label = "torch._int_mm"
        w = codes.t().contiguous().t()
        fn = torch._int_mm
    copies = max(1, math.ceil(cold / w.nbytes))
    return fn, [(a, w)] + [(a, w.clone()) for _ in range(copies - 1)], \
        label


def kernel_args(name, x, codes, scale):
    """The wrapper's arguments: W8A8 takes x quantized beforehand."""
    if name != "quant_matmul_w8a8":
        return (x, codes, scale)
    from repro_torch.kernels import ref
    xq, xs = ref.quantize_a8(x)
    return (xq, xs, codes, scale)


def worker(root: Path, library: bool):
    """Time ``root``'s kernels (and, with ``library``, cuBLAS); print one
    JSON object of case -> numbers."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref
    plan = getattr(qm, "qmm_splits", None)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for K, N in PROJECTIONS:
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        for name, quantize in zip(KERNELS, (ref.quantize_w8,
                                            ref.quantize_w4_packed,
                                            ref.quantize_w8)):
            fwd = getattr(qm, name)
            codes, scale = quantize(w)
            copies = max(1, math.ceil(COLD_BYTES / codes.nbytes))
            reps = max(20, min(copies, 200))
            weights = [codes] + [codes.clone() for _ in range(copies - 1)]
            unpacked = ref.unpack_w4(codes) if name.endswith("w4a16") \
                else codes
            for M in ROWS:
                x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
                args = kernel_args(name, x, codes, scale)
                sets = [args[:-2] + (c, args[-1]) for c in weights]
                row = {"ms": device_ms(fwd, sets, reps)}
                if plan is not None:
                    row["n_split"] = plan(M, N, K)
                if library:
                    fn, lib_sets, row["library"] = library_call(
                        name, x, codes, unpacked, scale, COLD_BYTES)
                    row["library_ms"] = device_ms(
                        fn, lib_sets, max(20, min(len(lib_sets), 200)))
                    del lib_sets
                row["bound_ms"], row["bound_by"] = bound_ms(name, M, K, N)
                out[f"{name} M={M} K={K} N={N}"] = row
                del x, args, sets
            del weights, codes, scale, unpacked
            torch.cuda.empty_cache()
    print(json.dumps(out))


def sass_counts() -> dict:
    """Kernel instance -> {instruction: count} of the tensor-core
    instructions in this checkout's built quant_matmul library."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.compile_library("quant_matmul")
    tool = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run(
        [str(tool), "-sass", str(build.library_path("quant_matmul"))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            continue
        op = re.search(r"\b(HGMMA|IGMMA|HMMA|IMMA)\.", line)
        if op and fn:
            c = counts.setdefault(fn, {})
            c[op.group(1)] = c.get(op.group(1), 0) + 1
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
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker).resolve(), args.library)
        return 0
    if args.sass:
        counts = sass_counts()
        totals = {}
        for fn, c in sorted(counts.items()):
            print(f"{fn}: {json.dumps(c)}")
            for op, n in c.items():
                totals[op] = totals.get(op, 0) + n
        print(json.dumps({"sass_totals": totals}))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_qmm: no CUDA device", file=sys.stderr)
        return 2
    order = [("this", ROOT)] * 2
    if args.other:
        other = Path(args.other).resolve()
        order = [("other", other)] + order + [("other", other)]
    runs = {"this": [], "other": []}
    for i, (label, root) in enumerate(order):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root)] + (["--library"] if label == "this" and i < 2
                             else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {"card": card_line(), "cases": {}}
    for case, first in runs["this"][0].items():
        row = {"ms": [r[case]["ms"] for r in runs["this"]],
               "library_ms": first.get("library_ms"),
               "library": first.get("library"),
               "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
               "n_split": first.get("n_split")}
        if runs["other"]:
            row["other_ms"] = [r[case]["ms"] for r in runs["other"]]
        summary["cases"][case] = row
        other = f" other {row['other_ms']}" if runs["other"] else ""
        print(f"{case}: ms {row['ms']}{other} library "
              f"{row['library_ms']} ({row['library']}) bound "
              f"{row['bound_ms']:.5f} "
              f"({row['bound_by']}) n_split {row['n_split']}", flush=True)
    print(summary["card"])
    print(json.dumps(summary))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
