"""Build and load the CUDA kernels (csrc/) as a ctypes library.

`nvcc` compiles csrc/kernels.cu (which includes csrc/field.cuh) for
sm_90a into build/libstarks_kernels_<hash>.so at the repository root,
on first use; the hash covers the sources and flags, so an edited
source is rebuilt. The library has a plain C interface, so no PyTorch
header is compiled. Nothing is built or loaded at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("field.cuh", "kernels.cu")       # what the library is built from
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_U = ctypes.c_uint32

# C entry points of csrc/kernels.cu: argument types, stream last.
SIGNATURES = {
    "starks_ntt_dif": [_P, _P, _P, _P, _P, _U, _U, _U, _P],
    "starks_ntt_dit": [_P, _P, _P, _P, _U, _U, _U, _U, _P],
    "starks_scale": [_P, _U, _P, _U, _P, _P, _U, _U, _P],
    "starks_db_map": [_P, _P, _P, _P, _U, _P, _U, _P, _P, _P, _P, _P, _P,
                      _U, _U, _U, _P],
    "starks_l_map": [_P, _P, _P, _P, _U, _P, _U, _P, _U, _U, _P],
    "starks_fold4": [_P, _P, _P, _P, _P, _U, _U, _U, _P],
    "starks_mul": [_P, _U, _U, _P, _U, _U, _P, _U, _U, _P],
    "starks_add": [_P, _U, _U, _P, _U, _U, _P, _U, _U, _P],
    "starks_sub": [_P, _U, _U, _P, _U, _U, _P, _U, _U, _P],
    "starks_cube": [_P, _P, _U, _U, _P],
    "starks_mimc_trace": [_P, _P, _U, _P, _U, _U, _P],
    "starks_mimc_trace_canonical": [_P, _P, _U, _P, _U, _U, _P],
    "starks_chain_probe": [_U, _U, _P, _P],
    "starks_batch_inv": [_P, _P, _P, _U, _U, _U, _U, _U, _P],
    "starks_batch_inv_runs": [_P, _P, _U, _U, _P],
}

_LIB = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand, "bin", "nvcc")
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libstarks_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet.
    The compiler's report (registers, spills) is kept beside it as .log."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "kernels.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from csrc/kernels.cu and declare argtypes
    and restype for every entry point."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The CUDA kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        _LIB = bind(build())
    return _LIB
