"""Field inversion in the port against the JAX package, on the CPU.

`ops/limbs.inv` against JAX `limbs.inv`; `ops/limbs.batch_inv` and
`plimbs.batch_inv` (on CPU tensors: its plain version) against JAX
`limbs.batch_inv` and `fused.batch_inv_scan`, each under `jax.jit`;
and the bodies of the CUDA kernels (csrc/kernels.cu, built by g++)
against the plain version: the block scan at tile shapes that take the
cases through one to four levels (the wrapper's own shapes among them),
at a tile's edges and on one element (its inverse,
`field::inv_chain`, also against `field::inv`); and the design it
replaced, one thread per run (runs 1, 7 and 64). Inputs are made from a
numpy seed: zeros (one alone, scattered, and a block of 70, which
covers a whole block of 32 and crosses block borders), 1, p - 1 and
random elements, at 1, 3, 257, 4096 and 2^16 + 7 points. Every
comparison is exact equality.

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
from starks_tpu_torch.utils.conversions import (ints_to_tensor,
                                                tensor_to_ints)
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


# The replaced design (starks_batch_inv_runs), run 1 (a Fermat inverse
# per element) up to 4096 elements.
@pytest.mark.parametrize("n,run", [(n, r) for n in SIZES for r in RUNS
                                   if r > 1 or n <= 4096])
def test_kernel_body_matches_plain(host_kernels, n, run):
    """One thread per run, the last run short when run does not divide n
    (2^16 + 7, 257, 3), and runs of zeros only (the block of 70)."""
    x = case(n)
    out = torch.empty_like(x)
    assert host_kernels.starks_batch_inv_runs(x.data_ptr(), out.data_ptr(),
                                              n, run, None) == 0
    assert out.equal(plain(n))


def test_kernel_rejects_run_zero(host_kernels):
    x = case(3)
    assert host_kernels.starks_batch_inv_runs(x.data_ptr(), x.data_ptr(), 3,
                                              0, None) != 0


# The block scan: (threads, k, k_up) tile shapes, from blocks of 32
# elements at every level to the largest tiles (256 x 16, 32 x 16), with
# the wrapper's shapes at 2^16 and at 2^19 and up (256, 2 or 16, 2).
SHAPES = ((32, 1, 1), (32, 2, 1), (64, 4, 2), (256, 8, 8), (32, 16, 4),
          (256, 2, 2), (256, 16, 2), (128, 4, 16), (64, 1, 8), (32, 8, 2))


def scan(lib, x, threads, k, k_up, short=0):
    """The scan's C entry on x at a tile shape: (return code, out)."""
    n = x.shape[0]
    length = plimbs.batch_inv_scratch(n, threads, k, k_up)
    out = torch.empty_like(x)
    scratch = torch.empty((max(length, 1), 8), dtype=torch.int32)
    rc = lib.starks_batch_inv(x.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), length - short, n, threads,
                              k, k_up, None)
    return rc, out


def test_cases_reach_every_level_ragged():
    """At blocks of 32, 4096 points take three levels and 2^16 + 7 four,
    the last block ragged at every level below the top (2049, 65 and 3
    blocks); 257 points hold a whole block of zeros (elements 128-159)
    and zeros across the borders at 128 and 160."""
    levels = {n: plimbs.batch_inv_levels(n, 32, 1, 1) for n in SIZES}
    assert [len(v) for v in levels.values()] == [1, 1, 2, 3, 4]
    assert levels[2 ** 16 + 7] == [2 ** 16 + 7, 2049, 65, 3]
    assert all(m % 32 for m in levels[2 ** 16 + 7])
    x = case(257)
    assert not fl.eq_zero(x[99:100]).any()
    assert bool(fl.eq_zero(x[100:170]).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", SIZES)
def test_scan_body_matches_plain(host_kernels, n, shape):
    rc, out = scan(host_kernels, case(n), *shape)
    assert rc == 0 and out.equal(plain(n))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_scan_at_tile_edges(host_kernels, edge, shape):
    """n = tile - 1 and tile (one level), tile + 1 (two)."""
    threads, k, _ = shape
    n = threads * k + edge
    x = case(2 ** 16 + 7)[:n].clone()
    rc, out = scan(host_kernels, x, *shape)
    assert rc == 0 and out.equal(fl.batch_inv(x))
    assert len(plimbs.batch_inv_levels(n, *shape)) == (2 if edge > 0 else 1)


_RNG = np.random.default_rng(13)
ONE = {"0": 0, "1": 1, "p-1": M - 1, "p-2": M - 2,
       **{f"random{i}": int.from_bytes(_RNG.bytes(32), "little") % M
          for i in range(3)}}


@pytest.mark.parametrize("value", ONE.values(), ids=ONE.keys())
def test_scan_inverts_one_element(host_kernels, value):
    """One element: the top block alone, so field::inv_chain, held to
    Python's pow, the plain version and field::inv (the replaced
    design at run 1)."""
    x = ints_to_tensor([value])
    fermat = torch.empty_like(x)
    assert host_kernels.starks_batch_inv_runs(x.data_ptr(), fermat.data_ptr(),
                                              1, 1, None) == 0
    rc, out = scan(host_kernels, x, *plimbs.batch_inv_shape(1))
    assert rc == 0 and tensor_to_ints(out) == [pow(value, M - 2, M)]
    assert out.equal(fermat) and out.equal(fl.batch_inv(x))


def test_scan_rejects_bad_shapes_and_short_scratch(host_kernels):
    x = case(300)
    out, scratch = torch.empty_like(x), torch.empty_like(x)
    for shape in ((16, 1, 1), (48, 1, 1), (512, 1, 1), (32, 3, 1),
                  (32, 32, 1), (32, 1, 0), (32, 0, 1)):
        assert host_kernels.starks_batch_inv(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), 300, 300,
            *shape, None) != 0
    assert scan(host_kernels, x, 32, 1, 1, short=1)[0] != 0
    assert scan(host_kernels, x, 32, 1, 1)[0] == 0


def test_shape_rule_fills_the_card():
    """256 threads a block; k the most (up to 16) that leaves 128 blocks,
    about one an SM: 2, 4, 16, 16, 16 at the sizes a set-up inverts
    (2^16, 2^17, 2^19, 2^21, 2^23), so 2^21 and 2^23 make 512 and 2048
    blocks; groups of 2 above level 0, so the top block holds at most
    512 elements: two levels up to 2^21 elements, three at 2^22 and
    2^23."""
    sizes = (1, 2 ** 16, 2 ** 17, 2 ** 19, 2 ** 21, 2 ** 22, 2 ** 23)
    shapes = [plimbs.batch_inv_shape(n) for n in sizes]
    assert [k for _, k, _ in shapes] == [1, 2, 4, 16, 16, 16, 16]
    assert {(t, u) for t, _, u in shapes} == {(256, 2)}
    levels = [plimbs.batch_inv_levels(n, *sh) for n, sh in zip(sizes, shapes)]
    assert [v[1:] for v in levels] == [[], [128], [128], [128], [512],
                                       [1024, 2], [2048, 4]]
    assert plimbs.batch_inv_scratch(2 ** 23, *shapes[-1]) == 2 * (2048 + 4)


def test_batch_inv_checks_arguments_and_counts_no_launch_on_cpu():
    plimbs.reset_launches()
    x = case(3)
    assert plimbs.batch_inv(x).equal(fl.batch_inv(x))
    assert plimbs.LAUNCHES["batch_inv"] == 0
    for bad in (x[0], x[:0], torch.zeros(3, 4, dtype=torch.int32)):
        with pytest.raises(ValueError):
            plimbs.batch_inv(bad)
    with pytest.raises(TypeError):
        plimbs.batch_inv(x, run=1)
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
