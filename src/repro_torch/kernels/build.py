"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into a shared library of its
own with a plain C interface, all sources at once (one ``nvcc`` process
each, started together), into the git-ignored ``_build/`` directory,
keyed by the hash of all the sources. The libraries are loaded with
``ctypes``; each kernel module binds its own launcher through
:func:`library`. Nothing is built or loaded when a module is imported:
the first launch on a CUDA tensor does it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict

_CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin`` when ``CUDA_HOME`` is set, else from
    ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    nvcc = shutil.which("nvcc", path=os.path.join(home, "bin") if home
                        else None)
    if nvcc is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "port's CUDA kernels cannot be built")
    return nvcc


def build_library() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` into ``_build/<hash>/<name>.so``, once
    per hash of all the sources, the builds running in parallel. The
    compiler's resource report is kept beside each library (``.log``).
    Returns ``{source stem: library path}``. Raises if ``nvcc`` is
    missing or a build fails."""
    sources = sorted(_CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    out_dir = _BUILD_DIR / digest.hexdigest()[:16]
    libs = {src.stem: out_dir / f"{src.stem}.so" for src in sources}
    todo = [src for src in sources if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out_dir / f"{src.stem}.{os.getpid()}.tmp"
        procs.append((src, tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        report = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{report}")
            continue
        libs[src.stem].with_suffix(".log").write_text(report)
        os.replace(tmp, libs[src.stem])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return libs


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first need;
    ``bind`` sets its launchers' argument and result types once."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library()[name]))
        bind(lib)
        _libs[name] = lib
    return lib
