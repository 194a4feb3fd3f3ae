"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source (``kernels/<name>/<name>.cu``) exports a plain C
interface and is compiled on its own into a shared library for
``sm_90a``, at first use, into ``kernels/_build/`` (listed in
``.gitignore``).  A library's file name carries a hash of its source, the
headers (``*.cuh``) beside it and its flags, so an edited source or header
is rebuilt; the compiler's output is kept beside it (``.log``), so a later
process that finds the library built still has its ptxas report.
``build_all`` starts one ``nvcc`` per library at once, which is what
``chip_smoke.py`` calls up front.  A library in ``DEFINES`` is a variant
of another's source built with extra macros: ``flash_attention_bwd_faults``
is K4b with the planted faults that the checks must catch, kept out of
the shipped kernel, ``ssm_decode_faults`` K5 with its and
``moe_experts_faults`` K6 with its.

Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
SOURCES = {
    "matcher": KERNELS_DIR / "matcher" / "matcher.cu",
    "ddt": KERNELS_DIR / "ddt" / "ddt_gather.cu",
    "checksum": KERNELS_DIR / "checksum" / "checksum.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "flash_attention.cu",
    "flash_attention_bwd": (KERNELS_DIR / "flash_attention"
                            / "flash_attention_bwd.cu"),
    "flash_attention_bwd_faults": (KERNELS_DIR / "flash_attention"
                                   / "flash_attention_bwd.cu"),
    "ssm_decode": KERNELS_DIR / "ssm_decode" / "ssm_decode.cu",
    "ssm_decode_faults": KERNELS_DIR / "ssm_decode" / "ssm_decode.cu",
    "moe_experts": KERNELS_DIR / "moe_experts" / "moe_experts.cu",
    "moe_experts_faults": KERNELS_DIR / "moe_experts" / "moe_experts.cu",
}
DEFINES = {"flash_attention_bwd_faults": ["-DREPRO_K4B_PLANTED_FAULTS"],
           "ssm_decode_faults": ["-DREPRO_K5_PLANTED_FAULTS"],
           "moe_experts_faults": ["-DREPRO_K6_PLANTED_FAULTS"]}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# compiler output (ptxas register / shared-memory report) per built kernel
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch: nvcc not found (needs the CUDA toolkit)")


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):   # included by the source
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + DEFINES.get(name, [])).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *DEFINES.get(name, []), "-o", str(tmp),
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: List[str] = None) -> None:
    """Compile every kernel that has no up-to-date library, one ``nvcc``
    per library, all started together."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        started = [(n, *_start(n)) for n in names if not _lib_path(n).exists()]
        for n, proc, tmp, out in started:
            _finish(n, proc, tmp, out)
        for n in names:
            saved = _lib_path(n).with_suffix(".log")
            if n not in build_logs and saved.exists():
                build_logs[n] = saved.read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib
