"""Build and load the package's CUDA kernels.

Each kernel source in `csrc/` is compiled at first use with `nvcc` for
`sm_90a` into a shared library with a plain C interface, and loaded with
`ctypes`. The library goes to `kernels/build/` inside the package, named by
a hash of its source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source is rebuilt and an unchanged one is not. `build` compiles
several sources at once, one `nvcc` each. Nothing here runs at import.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "build", "build_log", "disassemble"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump): from CUDA_HOME or
    CUDA_PATH, PATH, or /usr/local/cuda."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / name).exists():
            return str(Path(root) / "bin" / name)
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(f"{name} not found: set CUDA_HOME or put it on PATH")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}_{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its library is missing, then load it."""
    lib = _lib_path(name)
    if not lib.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def build(names) -> None:
    """Compile the libraries of several sources at once, one `nvcc` process
    each; raises the first build's error."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(load_library, name) for name in names]:
            fut.result()


def build_log(name: str) -> str:
    """The compiler's output (`-Xptxas -v`: registers, shared memory,
    spills) from the build of `csrc/<name>.cu`, or '' if it was not built."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def disassemble(name: str) -> str:
    """The SASS of the built library of `csrc/<name>.cu` (`cuobjdump
    -sass`), building it first if needed."""
    load_library(name)
    proc = subprocess.run([_tool("cuobjdump"), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True)
    return proc.stdout
