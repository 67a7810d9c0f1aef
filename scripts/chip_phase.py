"""Run one phase of ``chip_smoke.py`` alone on the card: build every
kernel, then call the phase's function by name.

    python3 scripts/chip_phase.py phase_mesh_families
    python3 scripts/chip_phase.py phase_train_mesh 2.2

For phases that take no arguments, or numbers (phase 18's
``phase_train_mesh`` takes phase 12's step seconds, which it prints
beside its own), and return what they print (phase 22's
``phase_moe_quant``, phase 21's ``phase_mesh_families``, phase 20's
``phase_mesh_serve``), so that a phase is rehearsed without the whole
script's 15 minutes. Several names run one after the other. Prints the
build's seconds, each phase's own lines, its seconds and what it
returned.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import torch
    import chip_smoke
    from repro_torch.kernels import build
    calls = []
    for arg in sys.argv[1:]:
        if arg.startswith("phase_"):
            calls.append((arg, []))
        elif calls:
            calls[-1][1].append(float(arg))
        else:
            calls = []
            break
    if not calls:
        raise SystemExit("usage: chip_phase.py phase_<name> [number ...] "
                         "[phase_<name> ...]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"build: {build.build_all()} s of nvcc", flush=True)
    for name, args in calls:
        t1 = time.perf_counter()
        out = getattr(chip_smoke, name)(*args)
        print(f"{name}: {time.perf_counter() - t1:.1f} s, returned "
              f"{out}; {time.perf_counter() - t0:.1f} s with the build",
              flush=True)


if __name__ == "__main__":      # the phases' worlds re-import this module
    main()
