"""Builds ``tisph_tpu_torch/csrc/*.cu`` into one shared library with a
plain C interface and loads it with ctypes: one ``nvcc -c`` per source,
all started together, then one link.

The one place that runs ``nvcc``, and the one launch path of the
wrappers in ``ops/cuda``: :func:`launch` calls an entry point on the
current stream, raises on a refused launch and counts it, and
:func:`check_tensors` is their tensor check.  The library lands in
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

import torch

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
    "tisph_cell_sort": [_P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P],
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


def launch(name: str, entry: str, device: torch.device, *args, what: str | None = None,
           **counts: int) -> None:
    """One launch of the library's ``entry`` on ``device``: ``args``, then
    the current stream, read at every call (the capture stream under
    ``torch.cuda.graph``, so a capture records the launch).  A non-zero
    return raises through :func:`check` as ``what`` (``name`` by default).
    Counts ``launches.<name>`` in ``utils.profiling``'s registry, and each
    of ``counts`` as ``<kind>.<name>`` (the sweeps' ``rows`` and
    ``part_launches``)."""
    with torch.cuda.device(device):
        err = getattr(load(), entry)(*args, torch.cuda.current_stream().cuda_stream)
    check(err, what or name)
    count(f"launches.{name}")
    for kind, n in counts.items():
        count(f"{kind}.{name}", n)


def check_tensors(name: str, n: int, dim: int, tensors: dict) -> None:
    """``dim`` 2 or 3, ``n`` rows in int32, and every tensor of ``tensors``
    ({key: (tensor, dtype, shape)}) on the first one's CUDA device, of its
    dtype and shape, contiguous."""
    if dim not in (2, 3):
        raise ValueError(f"{name}: dim must be 2 or 3, got {dim}")
    if n >= 2**31 - 1:
        raise ValueError(f"{name}: {n} rows do not fit in int32")
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for key, (t, dtype, shape) in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: {key} must be a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, want {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
