"""Builds ``tisph_tpu_torch/csrc/*.cu`` into one shared library with a
plain C interface and loads it with ctypes: one ``nvcc -c`` per source,
all started together, then one link.

The one place that runs ``nvcc``.  The library lands in
``build/tisph_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so a checkout builds once on first use and a changed
source builds anew; delete that directory to force a rebuild.  A missing
``nvcc`` or a failed build raises with the compiler's output: there is no
CPU fallback.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from tisph_tpu_torch.utils.profiling import count

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tisph_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every pointer and the stream are c_void_p so
# ctypes never cuts a 64-bit address to a C int.
_SIGNATURES = {
    "tisph_rebuild": [_P, _P, _I, _I, _P, _I, _I, _P, _P],
    "tisph_sweep": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                    _I, _I, _I, _I, _I,
                    _F, _F, _F, _F, _F, _F, _F, _F, _F, _P],
    "tisph_linear_sweep": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _I,
                           _F, _F, _F, _F, _F, _F, _F, _F, _F, _P],
    "tisph_legacy_sweep": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P],
    "tisph_eos_pack": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _F, _F, _F, _F, _I, _I, _F, _P],
    "tisph_advance": [_I, _I, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _F, _F, _P],
    "tisph_legacy_pos_pack": [_I, _I, _P, _P, _P, _P],
    "tisph_legacy_eos_pack": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _I,
                              _P],
    "tisph_legacy_advance": [_I, _I, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _F, _F,
                             _I, _P],
    "tisph_error_string": [_I],
}


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME)")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtisph_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")


def build() -> tuple[Path, float]:
    """Compile the library unless a build of the current sources exists:
    one nvcc per source, all at once, then one link.  Returns (path,
    seconds spent compiling; 0.0 when it was cached)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in srcs]
        with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
            list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                                 for s, o in zip(srcs, objs)]))
        so = os.path.join(tmp, "lib.so")
        _run([nvcc, "-shared", "-o", so, *objs])
        os.replace(so, out)  # atomic: concurrent builds race harmlessly
    return out, time.perf_counter() - t0


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its functions;
    the build's seconds go to the counter ``build.s`` (0 when it found the
    library).  Never first called inside a CUDA graph capture (``models.graphs``
    warms a group up before its capture)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("build.load: first call inside a CUDA graph capture (warm up first)")
    path, seconds = build()
    count("build.s", seconds)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tisph_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        msg = load().tisph_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
