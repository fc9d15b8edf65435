"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` (the hash is of
the source and of every ``csrc`` header, so an edited source or header never
loads a stale library). Sources are compiled for ``sm_90a`` at first use, one
``nvcc`` per source, all started together. Nothing is built when this module
is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def hashed_library(build_dir: Path, name: str, sources) -> Path:
    """``build_dir/lib<name>-<hash>.so``, the hash of every file of
    ``sources`` in order: the name a library built from them takes, so that
    an edited source never loads a stale library. The port's host library
    (``native/loader.py``) is named by the same rule."""
    digest = hashlib.sha256()
    for path in sources:
        digest.update(Path(path).read_bytes())
    return Path(build_dir) / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _target(name: str) -> Path:
    return hashed_library(BUILD_DIR, name, (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))))


def build_all(names=None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc``) that has no
    library yet. Returns the ptxas report of each build; raises with the
    compiler's output if any build fails."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(str(_target(name)))
