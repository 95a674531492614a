"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes``: no PyTorch headers, so a
build takes seconds.  Libraries land in ``build/repro_torch/`` at the
repository root, named by a hash of the sources and flags, so an edited
source is rebuilt and concurrent builds never see a half-written file.
:func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["ARCH_FLAGS", "BUILD_DIR", "KERNELS", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("decode_attention", "prefill_attention")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels build only where CUDA is "
                           "installed")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the .cu and the shared .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every missing library, all ``nvcc`` runs in parallel.

    Writes each compiler's output (``-Xptxas -v``: registers, shared
    memory, spills) to ``<library>.log``; raises with it on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_all((name,))[name]))
    return _loaded[name]
