"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
into a shared library at first use and loaded with ``ctypes`` — seconds to
build, where a source that includes PyTorch's headers takes minutes. The
library lands in ``csrc/build/`` (listed in ``.gitignore``) under a name
that carries the source's hash, so an edited source is rebuilt and a
stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "source at first use"
        )
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built to, keyed by the hash of the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for part in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, part), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_libraries(names: Sequence[str]) -> Dict[str, Tuple[str, str]]:
    """Build every named source that has no up-to-date library, one ``nvcc``
    per source, all started together. Returns ``{name: (path, log)}`` where
    ``log`` is the compiler's output (ptxas register / spill report), empty
    for a library that was already built. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = (path, "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
        out[name] = (path, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path, _ = build_libraries([name])[name]
    return ctypes.CDLL(path)
