"""The tables' runner (port of ``benchmarks/run.py``): one section per
paper table, then the roofline report. Prints ``name,us_per_call,derived``
CSV (tables/common.py), ``# <tag>: us_per_call is ...`` before each
section and ``# <tag> done in <s>s`` after it; exits non-zero if any
section failed. The reference's ``engine`` section is the engine
benchmark's, not a table's, and is not here.

    PYTHONPATH=src python -m repro_torch.tables.run [table1 table3 ...] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import importlib
import time
import traceback

SECTIONS = [
    ("table1", "repro_torch.tables.table1_specialization"),
    ("table2", "repro_torch.tables.table2_cross_hw"),
    ("table3", "repro_torch.tables.table3_amc_speedup"),
    ("table4", "repro_torch.tables.table4_amc_vs_uniform"),
    ("table5", "repro_torch.tables.table5_cross_hw_quant"),
    ("table6", "repro_torch.tables.table6_haq_latency"),
    ("table7", "repro_torch.tables.table7_transfer"),
    ("roofline", "repro_torch.tables.roofline_report"),
]


def run_sections(want=(), *, device="cuda"):
    """Run every section in ``want`` (all if empty), each at the
    reference's sizes on ``device``. Returns ({tag: main's result}, [(tag,
    repr(error))]): a failed section is recorded, printed with its
    traceback, and the next one runs."""
    unknown = set(want) - {tag for tag, _ in SECTIONS}
    if unknown:
        raise ValueError(f"no such section: {sorted(unknown)}")
    print("name,us_per_call,derived", flush=True)
    results, failures = {}, []
    for tag, mod_name in SECTIONS:
        if want and tag not in want:
            continue
        t0 = time.time()
        try:
            mod = importlib.import_module(mod_name)
            print(f"# {tag}: us_per_call is {mod.US_PER_CALL}", flush=True)
            results[tag] = mod.main(device=device)
            print(f"# {tag} done in {time.time() - t0:.1f}s", flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append((tag, repr(e)))
            traceback.print_exc()
            print(f"# {tag} FAILED: {e!r}", flush=True)
    return results, failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*",
                    help=f"any of {[tag for tag, _ in SECTIONS]} (all if "
                         f"none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, failures = run_sections(args.sections, device=args.device)
    if failures:
        raise SystemExit(f"{len(failures)} table sections failed")


if __name__ == "__main__":
    main()
