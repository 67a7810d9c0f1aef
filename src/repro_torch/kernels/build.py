"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/kernels/`` at the
repository root, named by a hash of the source, the headers it includes
(``csrc/common.cuh``, ``csrc/hopper.cuh``) and the flags: a changed source
or header builds anew, an unchanged one is loaded as it is. The library is
bound with ``ctypes``. Nothing here runs at import; the first wrapper call
on a CUDA tensor builds and loads.

    python -m repro_torch.kernels.build     # build every kernel, print times
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of each library's entry points: name -> (restype, argtypes)
SIGNATURES = {
    "paged_attention": {
        "paged_decode_bf16": (_I, [_P] * 7 + [_I] * 7 + [_F, _I, _P]),
        "paged_prefill_bf16": (_I, [_P] * 6 + [_I] * 8 + [_F, _P]),
        "paged_decode_quant": (_I, [_P] * 9 + [_I] * 7 + [_F, _I, _I, _P]),
        "paged_prefill_quant": (_I, [_P] * 8 + [_I] * 8 + [_F, _I, _P]),
        "paged_smem_bytes": (ctypes.c_size_t, [_I] * 3),
        "paged_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "flash_fwd_bf16": (_I, [_P] * 5 + [_I] * 9 + [_F, _P]),
        "flash_error_string": (ctypes.c_char_p, [_I]),
    },
    "quant_matmul": {
        "qmm_wa16_bf16": (_I, [_P] * 5 + [_I] * 6 + [_P]),
        "qmm_wa16_f32": (_I, [_P] * 4 + [_I] * 5 + [_P]),
        "qmm_w8a8": (_I, [_P] * 6 + [_I] * 6 + [_P]),
        "qmm_error_string": (ctypes.c_char_p, [_I]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels build on a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes with ``#include
    "..."`` (resolved beside the including file), recursively, in a fixed
    order."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header the
    source includes and the flags: an edit to any of them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def compile_library(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Returns the seconds spent in nvcc (0.0 when it was already built)."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all() -> Dict[str, float]:
    """Compile every kernel source at once, one nvcc each, in parallel.
    Returns name -> nvcc seconds."""
    names = sorted(SIGNATURES)
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        secs = list(ex.map(compile_library, names))
    return dict(zip(names, secs))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        compile_library(name)
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return lib


if __name__ == "__main__":
    for lib_name, s in build_all().items():
        print(f"{lib_name}: {s:.1f}s nvcc -> {library_path(lib_name)}")
