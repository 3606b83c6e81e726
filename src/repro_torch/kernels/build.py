"""Build and load the port's CUDA kernels (plain C interface, `ctypes`).

At first use, every `csrc/*.cu` is compiled by its own `nvcc` process, all
started together, and the objects are linked into one shared library under
`_build/` (listed in `.gitignore`).  The library is named by a hash of the
sources and flags, so an edited source is never served from a stale build.

Flags: `sm_90a` (Hopper), `-O3`, `--fmad=false` — no multiply-add is fused
unless the source says so with `__fmaf_rn`, which the bitwise contract of
`msp_update` needs — and no `-use_fast_math`.  Each C entry point launches
on the stream it is given and returns `cudaGetLastError()`; `check` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F, _L = ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "msp_update_launch": [_P] * 9 + [_I] + [_F] * 6 + [_I, _P],
    "m2l_separable_launch": [_P] * 4 + [_I, _P],
    "gaussian_nbody_launch": [_P] * 4 + [_I, _I, _F, _P],
    "synaptic_input_launch": [_P] * 7 + [_L, _L, _I, _P],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError(f"nvcc not found at {path}; the CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return str(path)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def compile_library(verbose: bool = False) -> tuple[Path, str]:
    """Compile (if needed) and return (library path, compiler log).

    verbose adds `-Xptxas -v`, whose per-kernel register, shared-memory and
    spill report lands in the log; it always rebuilds."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for s in srcs:
        digest.update(s.name.encode() + s.read_bytes())
    lib = BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"
    if lib.is_file() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    # Objects named by the process: ranks that start on their cards at once
    # each build alone, and the last rename wins with the same library.
    objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc(), *ARCH, *FLAGS, *extra, "-c", str(s),
                               "-o", str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    log = []
    for s, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        log.append(f"== {s.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run([nvcc(), *ARCH, "-shared", *map(str, objs), "-o",
                           str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    tmp.replace(lib)
    for o in objs:
        o.unlink(missing_ok=True)
    return lib, "\n".join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's argtypes set."""
    path, _ = compile_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
