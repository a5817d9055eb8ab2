"""The port's native host runtime (starks_tpu_torch.utils.native, built
by g++ from csrc/starkrt.cpp into build/) against Python bigints, the
port's plain versions and the JAX package's native runtime."""

import random

import numpy as np
import pytest
import torch

from starks_tpu.utils import native as jnative
import starks_tpu_torch as stt
from starks_tpu_torch.models import mimc
from starks_tpu_torch.ops import fused
from starks_tpu_torch.ops import limbs as fl
from starks_tpu_torch.utils import hostfield as hf
from starks_tpu_torch.utils import native
from starks_tpu_torch.utils.conversions import ints_to_tensor, tensor_to_ints

M = 2 ** 256 - 351 * 2 ** 32 + 1
CONSTS = [(i ** 7) ^ 42 for i in range(16)]


@pytest.mark.parametrize("inp,steps,consts", [
    (3, 64, CONSTS), (M - 1, 256, CONSTS[:4]), (M + 5, 32, CONSTS[:2]),
    (0, 128, [c + M for c in CONSTS])])
def test_mimc_trace_equals_trace_host(inp, steps, consts):
    """The native trace (inputs and constants reduced mod p) equals the
    plain bigint trace, in the port's [steps, 8] int32 layout."""
    got = mimc.trace_limbs(inp, steps, consts)
    assert got.dtype == np.int32 and got.shape == (steps, 8)
    want = mimc.trace_host(inp % M, steps, [c % M for c in consts])
    assert torch.from_numpy(got).equal(ints_to_tensor(want))


def test_mimc_trace_equals_jax_native():
    got = native.mimc_trace(3, 512, CONSTS)
    want = jnative.mimc_trace(3, 512, CONSTS)
    assert want is not None
    assert torch.from_numpy(got).equal(fl.from_jax_limbs(
        want.astype(np.uint32)))


@pytest.mark.parametrize("n", [1, 8, 512])
def test_power_table_equals_powers(n):
    g = pow(7, (M - 1) // 512, M)
    table = native.power_table(g, n)
    assert tensor_to_ints(torch.from_numpy(table)) == fused.powers(g, n)
    assert fused.power_table(g, n).equal(torch.from_numpy(table))


@pytest.mark.parametrize("start,n", [(0, 1), (100, 50), (511, 1)])
def test_power_slice_equals_powers(start, n):
    g = pow(7, (M - 1) // 512, M)
    got = native.power_slice(g, start, n)
    assert tensor_to_ints(torch.from_numpy(got)) == fused.powers(
        g, start + n)[start:]


def test_power_grid_equals_powers():
    g = pow(7, (M - 1) // 1024, M)
    got = native.power_grid(g, 5, 3, 16)
    assert got.shape == (3, 16, 8)
    assert tensor_to_ints(torch.from_numpy(got.reshape(-1, 8))) == [
        pow(g, r * c, M) for r in range(5, 8) for c in range(16)]


def test_inv_vanishing2_equals_multi_inv():
    """1/((x - a)(x - b)) over a power table, zero at the roots."""
    g = pow(7, (M - 1) // 256, M)
    xs = native.power_table(g, 256)
    a, b = 1, pow(g, 200, M)
    got = native.inv_vanishing2(xs, a, b)
    want = hf.multi_inv([(x - a) * (x - b) % M for x in fused.powers(g, 256)])
    assert tensor_to_ints(torch.from_numpy(got)) == want
    assert want[0] == want[200] == 0


def test_batch_inv_equals_multi_inv():
    r = random.Random(5)
    xs = [0, 1, M - 1, 2 ** 255] + [r.randrange(M) for _ in range(60)]
    assert native.batch_inv_ints(xs) == hf.multi_inv(xs)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_equals_host_ntt(inverse):
    r = random.Random(6)
    vals = [r.randrange(M) for _ in range(64)]
    root = pow(7, (M - 1) // 64, M)
    assert native.ntt_ints(vals, root, inverse) == hf.host_ntt(vals, root,
                                                               inverse)


def test_built_into_build_dir_keyed_on_source():
    native.load()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libstarkrt_")


def test_no_compiler_raises(monkeypatch, tmp_path):
    """No silent fallback to the bigint trace: without a compiler the
    runtime raises."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        mimc.trace_limbs(3, 64, CONSTS)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        stt.mk_mimc_proof(3, 64, CONSTS, device="cpu")


def test_trace_batch_device_equals_jax_and_native():
    """The MiMC traces of a claim batch (on the CPU, `mimc_trace`'s plain
    version) equal the JAX package's `trace_batch_device` ([steps, B, 16]
    limbs, transposed to the port's claim-major layout) and each claim's
    native trace, for 3 inputs at 64 steps (an input above p reduced)."""
    import jax.numpy as jnp
    from starks_tpu.models import mimc as jmimc
    from starks_tpu.utils.conversions import ints_to_limbs
    consts = [(i ** 7) ^ 42 for i in range(64)]
    inps = [3, M - 1, M + 5]
    got = mimc.trace_batch_device(inps, 64, consts, device="cpu")
    want = jmimc.trace_batch_device(
        jnp.asarray(ints_to_limbs([x % M for x in inps])), 64,
        jnp.asarray(ints_to_limbs(consts)))
    assert got.shape == (3, 64, 8) and got.dtype == torch.int32
    assert got.equal(fl.from_jax_limbs(np.asarray(want).transpose(1, 0, 2)))
    for c, x in enumerate(inps):
        assert got[c].equal(torch.from_numpy(mimc.trace_limbs(x, 64,
                                                              consts)))


def test_trace_batch_device_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mimc.trace_batch_device([3], 64, CONSTS)
