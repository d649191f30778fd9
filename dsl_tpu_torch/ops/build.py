"""Build the port's CUDA and host C++ sources into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` (a kernel) or ``csrc/<name>.cpp`` (host code, such
as the PNG unfilter) becomes ``_build/lib<name>-<hash>.so`` (the hash is of
the source and the flags, so an edited source is rebuilt), compiled with
``nvcc`` (for ``sm_90a``; a ``.cpp`` goes to its host compiler) at first
use; nothing here runs at import time. :func:`build_all` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: the NMS kernel's IoU must round like the plain version's
# separate torch ops (an FMA changes a result at the threshold).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# libraries a source links against, beyond the CUDA runtime
LINK_FLAGS = {"nvjpeg_decode": ("-lnvjpeg",)}
SOURCES = tuple(sorted(p.stem for p in (*CSRC_DIR.glob("*.cu"),
                                        *CSRC_DIR.glob("*.cpp"))))

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + LINK_FLAGS.get(name, ())


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _target(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES, verbose: bool = False) -> dict[str, Path]:
    """Compile every ``csrc/<name>.{cu,cpp}`` of ``names`` that is not built yet,
    one ``nvcc`` each, all started together; return name -> library path.

    With ``verbose`` the compiler prints the kernels' registers and shared
    memory (``-Xptxas -v``)."""
    targets = {name: _target(name) for name in names}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        if verbose and out:
            print(out, end="")
        os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.{cu,cpp}`` unless it is built already; return the path."""
    return build_all((name,), verbose)[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.{cu,cpp}``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
