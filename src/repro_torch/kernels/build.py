"""Build and load the port's CUDA kernels (nvcc → one shared library → ctypes).

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers.  At first use each ``.cu`` file is
compiled to an object by its own ``nvcc`` process, all started together
(``decode_attention.cu``, whose 48 instances took most of the build, as six
objects of 8 instances each: ``PARTS``), then the objects are linked into
one ``.so`` for ``sm_90a``.  The library
lands in ``kernels/_build/<hash>/``, keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import: the CPU never builds or loads anything.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("gram.cu", "aggregate.cu", "topk_mask.cu", "decode_attention.cu", "threefry.cu")
HEADERS = ("common.cuh",)
LIB_NAME = "libflrce_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH_FLAGS]
# sources compiled as several objects, each with the macro that picks a part;
# the source itself defines the count as that macro's name + "S"
PARTS = {"decode_attention.cu": "FLRCE_DECODE_PART"}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``; raises if absent."""
    candidates: List[Optional[str]] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    return h.hexdigest()[:16]


def part_count(src: str, macro: str) -> int:
    """The parts of ``src``: its ``#define <macro>S n`` line."""
    found = re.search(rf"^#define {macro}S (\d+)$", (CSRC / src).read_text(), re.M)
    if found is None:
        raise RuntimeError(f"{src} defines no {macro}S, the count of its parts")
    return int(found.group(1))


def compile_units() -> List[Tuple[str, List[str], str]]:
    """Each object of the library as (source, its extra nvcc flags, object
    stem): one a source, or one a part of a source in ``PARTS``."""
    units: List[Tuple[str, List[str], str]] = []
    for src in SOURCES:
        stem = Path(src).stem
        if src in PARTS:
            macro = PARTS[src]
            n = part_count(src, macro)
            units += [(src, [f"-D{macro}={p}"], f"{stem}.{p}") for p in range(n)]
        else:
            units.append((src, [], stem))
    return units


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands concurrently; raise with the compiler output on failure."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outs = []
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def build() -> Path:
    """Compile the sources if the hashed library is missing; return its path."""
    target_dir = BUILD_ROOT / source_hash()
    lib_path = target_dir / LIB_NAME
    log_path = target_dir / "build.log"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, built=False,
                          log=log_path.read_text() if log_path.exists() else "")
        return lib_path
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        units = compile_units()
        objs = [work / f"{stem}.o" for _, _, stem in units]
        logs = _run_all([
            [nvcc, *NVCC_FLAGS, *flags, f"-I{CSRC}", "-c", str(CSRC / src), "-o", str(obj)]
            for (src, flags, _), obj in zip(units, objs)
        ])
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(work / LIB_NAME),
                           *map(str, objs)]])
        (work / "build.log").write_text("\n".join(logs))
        try:
            os.replace(work, target_dir)
        except OSError:
            # another process finished the same build first; use its library
            if not lib_path.exists():
                raise
    finally:
        shutil.rmtree(work, ignore_errors=True)
    BUILD_INFO.update(
        path=str(lib_path), seconds=time.perf_counter() - t0, built=True,
        log=log_path.read_text() if log_path.exists() else "",
    )
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.flrce_cross_gram_stream.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i32, i32, i64, i64,
                                            i32, p]
    lib.flrce_cross_gram_stream.restype = i32
    lib.flrce_cross_gram_stream_occupancy.argtypes = [i32, i32, i32, ctypes.POINTER(i32),
                                                      ctypes.POINTER(i32)]
    lib.flrce_cross_gram_stream_occupancy.restype = i32
    lib.flrce_cross_gram_ring.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i32, i32, i32, i32,
                                          i64, i32, i32, i32, p]
    lib.flrce_cross_gram_ring.restype = i32
    lib.flrce_cross_gram_ring_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32),
                                                    ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.flrce_cross_gram_ring_occupancy.restype = i32
    lib.flrce_gram.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.flrce_gram.restype = i32
    lib.flrce_weighted_aggregate.argtypes = [p, p, p, p, i64, i64, i64, i32, p]
    lib.flrce_weighted_aggregate.restype = i32
    lib.flrce_topk_mask_rows.argtypes = [p, p, i64, i64, i64, i64, i32, i64, p]
    lib.flrce_topk_mask_rows.restype = i32
    lib.flrce_gram_occupancy.argtypes = [i64, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.flrce_gram_occupancy.restype = i32
    lib.flrce_topk_mask_occupancy.argtypes = [i64, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.flrce_topk_mask_occupancy.restype = i32
    lib.flrce_decode_attention.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64,
                                           i64, i64, i32, i32, ctypes.c_float, p]
    lib.flrce_decode_attention.restype = i32
    lib.flrce_decode_attention_occupancy.argtypes = [i32, i64, i64, ctypes.POINTER(i32),
                                                     ctypes.POINTER(i32)]
    lib.flrce_decode_attention_occupancy.restype = i32
    u32 = ctypes.c_uint32
    lib.flrce_threefry_normal.argtypes = [u32, u32, p, i64, i64, p]
    lib.flrce_threefry_normal.restype = i32
    lib.flrce_threefry_rounding.argtypes = [u32, u32, p, p, p, i64, p, i64, i64, i64, p]
    lib.flrce_threefry_rounding.restype = i32
    lib.flrce_threefry_attributes.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32),
                                              ctypes.POINTER(i32)]
    lib.flrce_threefry_attributes.restype = i32
    lib.flrce_error_string.argtypes = [i32]
    lib.flrce_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _LIB = lib
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().flrce_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
