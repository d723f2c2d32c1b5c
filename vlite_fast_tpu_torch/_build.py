"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc into a shared library with a
plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o build/vlite_fast_tpu_torch/lib<name>-<hash>.so

The library lands in `build/vlite_fast_tpu_torch/` at the repo root, named
by a hash of its source and of every `csrc/` header it includes, so an
edited kernel or header is rebuilt and a stale one is never loaded.
nvcc's output (the `-Xptxas -v` register and shared memory report) is
kept beside it as `.log`.  Nothing here runs at import time: the first
call of `load` builds (`load_all` builds several at once, one nvcc
each).  A failed build raises with the compiler's message; nothing falls
back.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "vlite_fast_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# every library of the port, by csrc/<name>.cu
LIBRARIES = ("chain", "chain_v4", "dedisperse", "ema", "pretranspose",
             "rfi_front")

_LIBS: dict = {}
BUILD_SECONDS: dict = {}   # name -> wall seconds of the nvcc run (0 if cached)
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source on first use")
    return found


def sources(name: str) -> list:
    """csrc/<name>.cu and the csrc headers it includes, transitively."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(ARCH_FLAGS).encode())
    for src in sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of this exact source
    exists; returns its path."""
    out = lib_path(name)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def load_all(names=LIBRARIES) -> None:
    """Build the libraries not built yet, one nvcc each, all started
    together; then load them."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build, names))
    for name in names:
        load(name)


def check(rc: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry (every
    library exports vf_error_string for its message)."""
    if rc != 0:
        lib.vf_error_string.restype = ctypes.c_char_p
        lib.vf_error_string.argtypes = [ctypes.c_int]
        msg = lib.vf_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
