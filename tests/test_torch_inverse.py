"""Field inversion in the port against the JAX package, on the CPU.

`ops/limbs.inv` against JAX `limbs.inv`; `ops/limbs.batch_inv` and
`plimbs.batch_inv` (on CPU tensors: its plain version) against JAX
`limbs.batch_inv` and `fused.batch_inv_scan`, each under `jax.jit`;
and the body of `batch_inv_kernel` (csrc/kernels.cu, built by g++)
against the plain version at run lengths 1, 7 and 64. Inputs are made
from a numpy seed: zeros (one alone, scattered, and a block longer than
a run), 1, p - 1 and random elements, at 1, 3, 257, 4096 and 2^16 + 7
points. Every comparison is exact equality.

The JAX functions run in a child process started with this module, on
all the cases at once (one compile each): the inverses are unique, so
each case's values are a slice of the whole."""

import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from starks_tpu_torch.ops import _build, plimbs
from starks_tpu_torch.ops import limbs as fl
from starks_tpu_torch.utils.conversions import tensor_to_ints
from _torch_support import JaxChild

M = fl.MODULUS
SIZES = (1, 3, 257, 4096, 2 ** 16 + 7)
INV_SIZES = SIZES[:3]          # inv: 503 plain products over the array
RUNS = (1, 7, 64)
JAX_TIMEOUT_S = 600
# The JAX batch inverses see the cases end to end, padded with ones to
# JAX_ROWS x 140 elements, in that many rows.
JAX_ROWS = 512
JAX_POINTS = JAX_ROWS * 140

# The three compiles run in threads (XLA compiles without the GIL).
_JAX_INVERSES = f"""
import functools
from concurrent.futures import ThreadPoolExecutor
from starks_tpu.ops import fused, limbs
jobs = {{"inv": (limbs.inv, inputs["small"]),
        "batch_inv": (functools.partial(limbs.batch_inv, rows={JAX_ROWS}),
                      inputs["all"]),
        "batch_inv_scan": (functools.partial(fused.batch_inv_scan,
                                             rows={JAX_ROWS}),
                           inputs["all"])}}
lowered = {{k: jax.jit(f).lower(x) for k, (f, x) in jobs.items()}}
with ThreadPoolExecutor(len(jobs)) as pool:
    compiled = dict(zip(lowered, pool.map(lambda l: l.compile(),
                                          lowered.values())))
for k, (f, x) in jobs.items():
    outputs[k] = np.asarray(compiled[k](x))
"""


@functools.lru_cache(maxsize=None)
def case(n: int) -> torch.Tensor:
    """n seeded elements as [n, 8]: p - 1, 0, 1 up front, then random
    ones (a top word below 2^32 - 1 keeps each below p) with about one
    in 50 zero and, from 257 elements on, a block of 70 zeros."""
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64)
    words[:, 7] %= 2 ** 32 - 1
    words[rng.random(n) < 0.02] = 0
    if n >= 257:
        words[100:170] = 0
    front = [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
             for v in (M - 1, 0, 1)]
    words[:3] = np.asarray(front, dtype=np.uint64)[:n]
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _offsets(sizes):
    starts = np.cumsum((0,) + sizes)
    return {n: (int(a), int(b)) for n, a, b in zip(sizes, starts, starts[1:])}


@pytest.fixture(scope="module", autouse=True)
def jax_child(tmp_path_factory):
    everything = torch.cat([case(n) for n in SIZES])
    pad = torch.zeros(JAX_POINTS - everything.shape[0], 8, dtype=torch.int32)
    pad[:, 0] = 1
    child = JaxChild(
        _JAX_INVERSES, tmp_path_factory.mktemp("jax_inverses"),
        small=fl.to_jax_limbs(torch.cat([case(n) for n in INV_SIZES])),
        all=fl.to_jax_limbs(torch.cat([everything, pad])))
    yield child
    child.stop()


def _jax(child, name: str, n: int) -> np.ndarray:
    lo, hi = _offsets(INV_SIZES if name == "inv" else SIZES)[n]
    return child.result(JAX_TIMEOUT_S)[name][lo:hi]


def test_case_values():
    vals = tensor_to_ints(case(257))
    assert vals[:3] == [M - 1, 0, 1] and set(vals[100:170]) == {0}
    assert all(v < M for v in vals)
    assert len(set(vals)) == 257 - vals.count(0) + 1    # the rest distinct


@pytest.mark.parametrize("rows", [2, 5, 64])
def test_batch_inv_layout_changes_no_value(rows):
    x = case(257)
    assert fl.batch_inv(x, rows).equal(fl.batch_inv(x))


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/kernels.cu built by g++: the kernel bodies run as host loops
    behind the same C interface."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    out = tmp_path_factory.mktemp("host_kernels") / "libhost_kernels.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2",
                    "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    str(_build.CSRC / "kernels.cu"), "-o", str(out)],
                   check=True)
    return _build.bind(Path(out))


@functools.lru_cache(maxsize=None)
def plain(n: int) -> torch.Tensor:
    """`limbs.batch_inv` of case n (plimbs.batch_inv_plain's)."""
    return fl.batch_inv(case(n))


# Run 1 (a Fermat inverse per element) up to 4096 elements.
@pytest.mark.parametrize("n,run", [(n, r) for n in SIZES for r in RUNS
                                   if r > 1 or n <= 4096])
def test_kernel_body_matches_plain(host_kernels, n, run):
    """One thread per run, the last run short when run does not divide n
    (2^16 + 7, 257, 3), and runs of zeros only (the block of 70)."""
    x = case(n)
    out = torch.empty_like(x)
    assert host_kernels.starks_batch_inv(x.data_ptr(), out.data_ptr(), n,
                                         run, None) == 0
    assert out.equal(plain(n))


def test_default_run_keeps_about_2_15_threads():
    """The run length chosen on the card: n / 2^15 rounded up (16 at 2^19
    elements, 256 at 2^23), so never more than 2^15 threads."""
    sizes = (1, 2 ** 16 + 7, 2 ** 19, 2 ** 21, 2 ** 23, 2 ** 30)
    assert [plimbs.batch_inv_run(n) for n in sizes] == [1, 3, 16, 64, 256,
                                                        2 ** 15]
    for n in sizes:
        assert -(-n // plimbs.batch_inv_run(n)) <= 2 ** 15


def test_kernel_rejects_run_zero(host_kernels):
    x = case(3)
    assert host_kernels.starks_batch_inv(x.data_ptr(), x.data_ptr(), 3, 0,
                                         None) != 0


def test_batch_inv_checks_arguments_and_counts_no_launch_on_cpu():
    plimbs.reset_launches()
    x = case(3)
    assert plimbs.batch_inv(x, run=1).equal(fl.batch_inv(x))
    assert plimbs.LAUNCHES["batch_inv"] == 0
    for bad in (x[0], x[:0], torch.zeros(3, 4, dtype=torch.int32)):
        with pytest.raises(ValueError):
            plimbs.batch_inv(bad)
    for run in (0, 2 ** 16 + 1):
        with pytest.raises(ValueError):
            plimbs.batch_inv(x, run=run)
    with pytest.raises(ValueError):
        plimbs.batch_inv(torch.empty((64, 8), dtype=torch.int32,
                                     device="meta"))


# -- against the JAX package (last: they wait for the child) --------------

@pytest.mark.parametrize("n", INV_SIZES)
def test_inv_matches_jax(jax_child, n):
    got = fl.inv(case(n))
    assert np.array_equal(fl.to_jax_limbs(got), _jax(jax_child, "inv", n))


@pytest.mark.parametrize("port", ["limbs", "plimbs"])
@pytest.mark.parametrize("n", SIZES)
def test_batch_inv_matches_jax(jax_child, n, port):
    got = fl.to_jax_limbs(plain(n) if port == "limbs"
                          else plimbs.batch_inv(case(n)))
    assert np.array_equal(got, _jax(jax_child, "batch_inv", n))
    assert np.array_equal(got, _jax(jax_child, "batch_inv_scan", n))
