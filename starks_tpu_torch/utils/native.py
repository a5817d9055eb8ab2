"""The native host runtime (csrc/starkrt.cpp) through ctypes.

The port's own copy of `starks_tpu/utils/native.py`. g++ builds
csrc/starkrt.cpp into build/libstarkrt_<hash>.so at the repository root
on first use; the hash covers the source and flags, so an edited source
is rebuilt. There is no fallback: without a C++ compiler the functions
raise, and `models/mimc.trace_host` stays as the plain version the
tests hold the native trace against.

Element encoding at the ABI: 32 bytes little-endian per field element,
which is the port's [n, 8] int32 layout, so arrays pass as plain views.
Every array passed by address is held in a name until the call returns.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "starkrt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
MODULUS = 2**256 - 351 * 2**32 + 1

_P = ctypes.c_void_p
_N = ctypes.c_uint64
SIGNATURES = {
    "starkrt_mimc_trace": [_P, _N, _P, _N, _P],
    "starkrt_power_table": [_P, _N, _P],
    "starkrt_geometric": [_P, _P, _N, _P],
    "starkrt_power_grid": [_P, _N, _N, _N, _P],
    "starkrt_inv_vanishing2": [_P, _N, _P, _P, _P],
    "starkrt_batch_inv": [_P, _P, _N],
    "starkrt_ntt": [_P, _P, _N, _P],
}

_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libstarkrt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime if this source hash has no library yet."""
    out = library_path()
    if out.exists():
        return out
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found: the native host runtime "
                           "(csrc/starkrt.cpp) needs a C++ compiler "
                           "(set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The runtime library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _LIB = lib
    return _LIB


def _elems(ints) -> np.ndarray:
    """Ints -> [n, 8] int32 elements (reduced mod p)."""
    buf = b"".join((x % MODULUS).to_bytes(32, "little") for x in ints)
    return np.frombuffer(buf, dtype="<i4").reshape(-1, 8).copy()


def _ints(elems: np.ndarray) -> list:
    raw = np.ascontiguousarray(elems).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def mimc_trace(inp: int, steps: int, round_constants) -> np.ndarray:
    """The MiMC trace x_0 = inp, x_{i+1} = x_i^3 + c_{i mod len(c)} as a
    [steps, 8] int32 array."""
    start, consts = _elems([inp]), _elems(round_constants)
    out = np.empty((steps, 8), np.int32)
    load().starkrt_mimc_trace(start.ctypes.data, steps, consts.ctypes.data,
                              len(round_constants), out.ctypes.data)
    return out


def power_table(g: int, n: int) -> np.ndarray:
    """[n, 8] int32 array of g^0 .. g^(n-1)."""
    base = _elems([g])
    out = np.empty((n, 8), np.int32)
    load().starkrt_power_table(base.ctypes.data, n, out.ctypes.data)
    return out


def power_slice(g: int, start: int, n: int) -> np.ndarray:
    """[n, 8] int32 rows start .. start + n - 1 of g's power table."""
    base, gg = _elems([pow(g, start, MODULUS)]), _elems([g])
    out = np.empty((n, 8), np.int32)
    load().starkrt_geometric(base.ctypes.data, gg.ctypes.data, n,
                             out.ctypes.data)
    return out


def power_grid(g: int, row0: int, rows: int, cols: int) -> np.ndarray:
    """[rows, cols, 8] int32 grid of g^((row0 + r) * c)."""
    gg = _elems([g])
    out = np.empty((rows, cols, 8), np.int32)
    load().starkrt_power_grid(gg.ctypes.data, row0, rows, cols,
                              out.ctypes.data)
    return out


def inv_vanishing2(xs: np.ndarray, a: int, b: int) -> np.ndarray:
    """1 / ((x - a)(x - b)) for each x of an [n, 8] int32 array (zero
    where the product is zero, as `hostfield.multi_inv`)."""
    xs = np.ascontiguousarray(xs, dtype=np.int32)
    av, bv = _elems([a]), _elems([b])
    out = np.empty_like(xs)
    load().starkrt_inv_vanishing2(xs.ctypes.data, xs.shape[0], av.ctypes.data,
                                  bv.ctypes.data, out.ctypes.data)
    return out


def batch_inv_ints(xs: list) -> list:
    """Modular inverses of ints (zero maps to zero, as
    `hostfield.multi_inv`)."""
    buf = _elems(xs)
    out = np.empty_like(buf)
    load().starkrt_batch_inv(buf.ctypes.data, out.ctypes.data, len(xs))
    return _ints(out)


def ntt_ints(vals: list, root_of_unity: int, inverse: bool = False) -> list:
    """Host NTT over ints, natural order in and out, as
    `hostfield.host_ntt`."""
    n = len(vals)
    if n & (n - 1):
        raise ValueError(f"NTT length {n} is not a power of two")
    g = (pow(root_of_unity, MODULUS - 2, MODULUS) if inverse
         else root_of_unity)
    buf, roots = _elems(vals), power_table(g, n)
    out = np.empty_like(buf)
    load().starkrt_ntt(buf.ctypes.data, roots.ctypes.data, n,
                       out.ctypes.data)
    res = _ints(out)
    if inverse:
        n_inv = pow(n, MODULUS - 2, MODULUS)
        res = [x * n_inv % MODULUS for x in res]
    return res
