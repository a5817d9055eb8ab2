"""The port's kernels (starks_tpu_torch.ops.plimbs) and the blocks built
on them (ops/fused.py) against the XLA forms that tests/test_plimbs.py
holds the Pallas kernels to. Every comparison is exact equality.

On the CPU each wrapper runs its plain PyTorch version. The CUDA kernel
bodies (csrc/kernels.cu) also compile as C++ with g++, so they are held
against the plain versions here too; the launches themselves run only on
a card (chip_smoke.py)."""

import functools
import random
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starks_tpu.ops import fused as jfused
from starks_tpu.ops import limbs as jfl
from starks_tpu.utils.conversions import ints_to_limbs
from starks_tpu_torch.ops import _build, fused, plimbs
from starks_tpu_torch.ops import limbs as fl

M = fl.MODULUS
EDGE = [0, 1, 2, M - 1, M - 2, 2 ** 255, (1 << 240) - 1]
_add, _sub, _mul = jax.jit(jfl.add), jax.jit(jfl.sub), jax.jit(jfl.mul)


def _rand(n, seed, edge=False):
    """(JAX limbs [n, 16], port tensor [n, 8]) of the same seeded values."""
    r = random.Random(seed)
    vals = [r.randrange(M) for _ in range(n)]
    if edge:
        vals[:len(EDGE)] = EDGE
    limbs = ints_to_limbs(vals)
    return jnp.asarray(limbs), fl.from_jax_limbs(limbs)


def _same(port, jax_arr):
    return np.array_equal(fl.to_jax_limbs(port), np.asarray(jax_arr))


# -- A1-A6 plain versions against the XLA compositions --------------------

@pytest.mark.parametrize("t", [0, 3, 7])
def test_dif_stage_matches_xla(t):
    n = 256
    jx, x = _rand(n, 1, edge=True)
    jtab, tab = _rand(n, 2)
    tw = jfused._stage_twiddles(jtab, t, n // 2)
    a, b = jx[:n // 2], jx[n // 2:]
    want = jnp.stack([_add(a, b), _mul(_sub(a, b), tw)], axis=1)
    assert _same(plimbs.dif_stage_plain(x, tab, t), want.reshape(n, 16))


@pytest.mark.parametrize("t", [0, 3, 7])
def test_dit_stage_matches_xla(t):
    n = 256
    jx, x = _rand(n, 3, edge=True)
    jtab, tab = _rand(n, 4)
    tw = jfused._stage_twiddles(jtab, t, n // 2)
    pairs = jx.reshape(n // 2, 2, 16)
    wb = _mul(tw, pairs[:, 1])
    want = jnp.concatenate([_add(pairs[:, 0], wb), _sub(pairs[:, 0], wb)])
    assert _same(plimbs.dit_stage_plain(x, tab, t), want)


def test_scale_matches_xla():
    jx, x = _rand(256, 5, edge=True)
    js, s = _rand(1, 6)
    want = _mul(jx, jnp.broadcast_to(js, jx.shape))
    assert _same(plimbs.scale(x, s[0]), want)


def test_scale_with_acc_matches_xla():
    """scale(x, s, acc=a) = a + x * s, as JAX's AIR sums a scaled term
    into its running sum (add_t after scale_t)."""
    jx, x = _rand(256, 7, edge=True)
    ja, a = _rand(256, 8, edge=True)
    js, s = _rand(1, 9)
    want = _add(ja, _mul(jx, jnp.broadcast_to(js, jx.shape)))
    assert _same(plimbs.scale(x, s[0], acc=a), want)


def test_db_map_matches_xla():
    n, ext = 512, 8
    jp, p = _rand(n, 20, edge=True)
    jxs, xs = _rand(n, 21)
    jk, k = _rand(64, 22)
    jz, z = _rand(ext, 23)
    jiz2, iz2 = _rand(n, 24)
    (jlast, last), (jslope, slope), (jia, ia) = (_rand(1, s)
                                                 for s in (25, 26, 27))
    c = _sub(_sub(jnp.roll(jp, -ext, axis=0), jax.jit(jfl.cube)(jp)),
             jnp.tile(jk, (n // 64, 1)))
    want_d = _mul(_mul(c, _sub(jxs, jlast)), jnp.tile(jz, (n // ext, 1)))
    i_ev = _add(jnp.broadcast_to(jia, jxs.shape),
                _mul(jnp.broadcast_to(jslope, jxs.shape), jxs))
    want_b = _mul(_sub(jp, i_ev), jiz2)
    d, b = plimbs.db_map(p, xs, k, z, iz2, last[0], slope[0], ia[0], ext)
    assert _same(d, want_d) and _same(b, want_b)


def test_l_map_matches_xla():
    n, ext = 256, 8
    (jd, d), (jp, p), (jb, b) = (_rand(n, s, edge=True)
                                 for s in (30, 31, 32))
    (jcp, cp), (jcb, cb) = _rand(ext, 33), _rand(ext, 34)
    want = _add(jd, _add(_mul(jp, jnp.tile(jcp, (n // ext, 1))),
                         _mul(jb, jnp.tile(jcb, (n // ext, 1)))))
    assert _same(plimbs.l_map(d, p, b, cp, cb), want)


def _jax_fold(values, ip, sx, eta, inv4):
    """The fold of JAX `fri_commit_unrolled` (starks_tpu/ops/fused.py),
    on the XLA field ops: round r passes its own u-table row."""
    q = values.shape[0] // 4
    y0, y1, y2, y3 = (values[j * q:(j + 1) * q] for j in range(4))
    e0, d02, e1, d13 = _add(y0, y2), _sub(y0, y2), _add(y1, y3), _sub(y1, y3)
    a0, a2 = _add(e0, e1), _sub(e0, e1)
    h = _mul(d13, jnp.broadcast_to(eta, d13.shape))
    a1, a3 = _sub(d02, h), _add(d02, h)
    u = _mul(jnp.broadcast_to(sx, d13.shape), ip[:q])
    acc = _add(_mul(u, a3), a2)
    acc = _add(_mul(u, acc), a1)
    acc = _add(_mul(u, acc), a0)
    return _mul(acc, jnp.broadcast_to(inv4, d13.shape))


def test_fold4_shift_matches_jax_fold_every_round():
    """Round r of a small schedule: fold4 with shift 2r on the port's one
    u-table equals the JAX fold with the JAX plan's round-r table."""
    from starks_tpu.utils import hostfield as hf
    from starks_tpu.utils.conversions import int_to_limbs
    from starks_tpu_torch.utils.conversions import int_to_tensor
    args = _plan_args(32)
    precision, G2 = args[1], args[3]
    schedule = fused.fri_round_schedule(precision, 2 * args[0], 2)
    assert len(schedule) == 3
    jplan = jfused.FusedPlan.get(*args, len(schedule), pallas=True)
    plan = fused.FusedPlan(*args, "cpu")
    eta, inv4 = pow(G2, precision // 4, M), hf.inv(4)
    for r, (n_r, _) in enumerate(schedule):
        jv, v = _rand(n_r, 100 + r, edge=True)
        jsx, sx = _rand(1, 110 + r)
        want = _jax_fold(jv, jplan.fri_inv_pows[r], jsx,
                         jnp.asarray(int_to_limbs(eta))[None],
                         jnp.asarray(int_to_limbs(inv4))[None])
        got = plimbs.fold4(v, plan.fri_inv_pows, sx[0], int_to_tensor(eta),
                           2 * r)
        assert _same(got, want), r


def test_fold4_matches_fri_fold():
    from starks_tpu.ops import ntt as ntt_mod
    from starks_tpu.ops.fri_fold import fold4 as jfold4
    from starks_tpu.utils import hostfield as hf
    from starks_tpu.utils.conversions import int_to_limbs
    from starks_tpu_torch.utils.conversions import int_to_tensor
    n = 1024
    G2 = pow(7, (M - 1) // n, M)
    dom = ntt_mod.get_domain(n, G2)
    jv, v = _rand(n, 40, edge=True)
    (jsx, sx) = _rand(1, 41)
    eta, inv4 = pow(G2, n // 4, M), hf.inv(4)
    want = jax.jit(jfold4)(jv, dom.powers, jnp.asarray(int_to_limbs(eta)),
                           jsx[0], jnp.asarray(int_to_limbs(inv4)))
    inv_pows = fused._inverse_order(fused.power_table(G2, n))[:n // 4]
    got = plimbs.fold4(v, inv_pows, sx[0], int_to_tensor(eta))
    assert _same(got, want)


# -- A7/A8 plain versions, with periodic operands ---------------------------

def _operand(length, n, seed):
    """(JAX limbs tiled to [n, 16], port operand [length, 8]): a full array,
    a periodic table or a constant, as mul_tab_t and PallasOps.const
    present them to the JAX kernels."""
    ja, a = _rand(length, seed, edge=length >= len(EDGE))
    return jnp.tile(ja, (n // length, 1)), a


@pytest.mark.parametrize("la,lb", [(256, 256), (256, 8), (256, 1), (8, 256),
                                   (1, 256), (8, 1)])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_elementwise_matches_xla(op, la, lb):
    n = max(la, lb)
    ja, a = _operand(la, n, 90)
    jb, b = _operand(lb, n, 91)
    want = jax.jit(getattr(jfl, op))(ja, jb)
    assert _same(getattr(plimbs, op)(a, b), want)


def test_cube_matches_xla():
    ja, a = _rand(256, 92, edge=True)
    assert _same(plimbs.cube(a), jax.jit(jfl.cube)(ja))


# -- NTT, LDE and the plan tables ------------------------------------------

# (n, stages per pass): at least two passes, the last one short.
DIF_PASSES = [(2 ** 6, 4), (2 ** 7, 3), (2 ** 8, 3), (2 ** 9, 4),
              (2 ** 10, 4)]


def _power_like(tab):
    """tab with tab[0] = 1, as in every power table."""
    return torch.cat([fl.from_jax_limbs(ints_to_limbs([1])), tab[1:]])


@pytest.mark.parametrize("n,k", DIF_PASSES)
def test_dif_transform_plain_matches_stage_chain(n, k):
    """For a table with table[0] = 1 (the transform's domain: a power
    table) the transform is the whole stage chain."""
    _, x = _rand(n, 120, edge=True)
    tab = _power_like(_rand(n, 121)[1])
    want = x
    for t in range(n.bit_length() - 1):
        want = plimbs.dif_stage_plain(want, tab, t)
    assert plimbs.dif_transform(x, tab, k).equal(want)
    assert plimbs.dif_transform(x, tab).equal(want)


@functools.lru_cache(maxsize=None)
def _jax_dif_case(n):
    """(JAX input, input, power table, JAX ntt_dif output) at n points,
    seeded."""
    g = pow(7, (M - 1) // n, M)
    table = jfused._power_table_np(g, n)
    jx, x = _rand(n, 130, edge=True)
    want = jax.jit(jfused.ntt_dif)(jx, jnp.asarray(
        jfused._stacked_twiddles(table)))
    return jx, x, fl.from_jax_limbs(table), want


def test_dif_transform_scaled_matches_xla():
    """dif_transform(x, tab, scale=s) equals JAX ntt_dif followed by the
    XLA multiply by s (the LDE's iNTT and 1/n)."""
    n = 512
    _, x, tab, want = _jax_dif_case(n)
    js, s = _rand(1, 131)
    assert _same(plimbs.dif_transform(x, tab, scale=s[0]),
                 _mul(want, jnp.broadcast_to(js, want.shape)))


def test_dif_pass_stages():
    assert [plimbs.dif_pass_stages(2 ** L) for L in (1, 6, 10, 13, 16, 20,
                                                      21)] == [
        1, 6, 10, 7, 8, 10, 7]
    x = _rand(64, 122)[1]
    for k in (0, plimbs.DIF_PASS_MAX_STAGES + 1):
        with pytest.raises(ValueError):
            plimbs.dif_transform(x, x, k)


@functools.lru_cache(maxsize=None)
def _jax_dit_case(n):
    """(input, power table, JAX ntt_dit output) at n points, seeded."""
    g = pow(7, (M - 1) // n, M)
    table = jfused._power_table_np(g, n)
    jx, x = _rand(n, 140 + n.bit_length(), edge=True)
    want = jax.jit(jfused.ntt_dit)(jx, jnp.asarray(
        jfused._stacked_twiddles(table)))
    return x, fl.from_jax_limbs(table), want


@pytest.mark.parametrize("n", [2 ** L for L in range(6, 11)])
def test_dit_transform_plain_matches_jax(n):
    x, tab, want = _jax_dit_case(n)
    assert _same(plimbs.dit_transform_plain(x, tab), want)
    assert _same(plimbs.dit_transform(x, tab), want)


@pytest.mark.parametrize("ext", [2, 8])
def test_dit_transform_compact_matches_padded(ext):
    """The compact form (x at multiples of ext, zero elsewhere) equals
    the general transform of the zero-padded array."""
    n = 512
    _, c = _rand(n // ext, 150 + ext, edge=True)
    _, tab = _rand(n, 151)
    padded = torch.zeros((n // ext, ext, 8), dtype=torch.int32)
    padded[:, 0] = c
    want = plimbs.dit_transform_plain(padded.reshape(n, 8), tab)
    assert plimbs.dit_transform(c, tab, ext=ext).equal(want)


def test_dit_transform_rejects_bad_arguments():
    x = _rand(64, 152)[1]
    for k in (0, plimbs.DIF_PASS_MAX_STAGES + 1):
        with pytest.raises(ValueError):
            plimbs.dit_transform(x, x, k)
    with pytest.raises(ValueError):
        plimbs.dit_transform(x[:16], x, 5, ext=4)     # n = 64: passes 1, 5
    with pytest.raises(ValueError):
        plimbs.dit_transform(x[:16], x, ext=3)        # not a power of two
    with pytest.raises(ValueError):
        plimbs.dit_transform(x, x[:16], ext=2)        # table below n/2


def test_ntt_dif_dit_match_fused():
    n = 512
    g = pow(7, (M - 1) // n, M)
    table = jfused._power_table_np(g, n)
    tw_stack = jnp.asarray(jfused._stacked_twiddles(table))
    jx, x = _rand(n, 50)
    port_table = fl.from_jax_limbs(table)
    assert port_table.equal(fused.power_table(g, n))
    assert _same(fused.ntt_dif(x, port_table),
                 jax.jit(jfused.ntt_dif)(jx, tw_stack))
    assert _same(fused.ntt_dit(x, port_table),
                 jax.jit(jfused.ntt_dit)(jx, tw_stack))


def _plan_args(steps, ext=8):
    precision = steps * ext
    G2 = pow(7, (M - 1) // precision, M)
    return steps, precision, pow(G2, ext, M), G2


def test_plan_tables_match_jax():
    """One [N/4, 8] u-table; at stride 4^r it is row r of the JAX plan's
    stacked [R, N/4] tables (on the q_r = N/4^(r+1) entries round r
    reads)."""
    args, rounds = _plan_args(64), 3
    jplan = jfused.FusedPlan.get(*args, rounds, pallas=True)  # plain tables
    plan = fused.FusedPlan(*args, "cpu")
    assert _same(plan.xs_big, jplan.xs_big)
    assert _same(plan.inv_small, jplan.tw_inv_small)
    assert _same(plan.n_inv_small[None], jplan.n_inv_small[None])
    q = args[1] // 4
    assert plan.fri_inv_pows.shape == (q, 8)
    for r in range(rounds):
        q_r = q // 4 ** r
        assert _same(plan.fri_inv_pows[::4 ** r][:q_r],
                     jplan.fri_inv_pows[r][:q_r])


def test_lde_matches_lde_fused():
    args = _plan_args(64)
    jplan = jfused.FusedPlan.get(*args, 2)              # stacked twiddles
    plan = fused.FusedPlan(*args, "cpu")
    jtrace, trace = _rand(64, 51)
    want = jax.jit(jfused.lde_fused)(jtrace, jplan.tw_inv_small,
                                     jplan.n_inv_small, jplan.tw_fwd_big)
    got = fused.lde(trace, plan.inv_small, plan.n_inv_small, plan.xs_big)
    assert _same(got, want)


def test_fri_round_schedule_matches_jax():
    for precision, maxdeg in [(512, 128), (2 ** 19, 2 ** 17), (64, 16)]:
        assert (fused.fri_round_schedule(precision, maxdeg, 16)
                == jfused.fri_round_schedule(precision, maxdeg, 16))


# -- the CUDA kernel bodies, compiled for the host --------------------------

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


def _host_cases():
    n = 256
    x = _rand(n, 60, edge=True)[1]
    tab, p, xs, iz2 = (_rand(n, s)[1] for s in (61, 62, 63, 64))
    d, b = _rand(n, 65)[1], _rand(n, 66)[1]
    k, z, cp, cb = (_rand(ln, s)[1] for ln, s in
                    ((64, 67), (8, 68), (8, 69), (8, 70)))
    s1, s2, s3 = (_rand(1, s)[1][0] for s in (72, 73, 74))
    ptab = torch.cat([fl.from_jax_limbs(ints_to_limbs([1])), tab[1:]])
    q = n // 4
    return {
        "dif_pass": (plimbs.dif_transform_plain(x, ptab),  # passes 3, 3, 2
                     [x, ptab, None], [n, 3, 1], (n, 8), (n, 8)),
        "dit_pass": (plimbs.dit_transform_plain(x, tab),  # passes 2, 3, 3
                     [x, tab], [n, 3, 0, 1], (n, 8), (n, 8)),
        "scale": (plimbs.scale_plain(x, s1), [x, 0, s1, 0, None], [n, 1],
                  (n, 8)),
        "db_map": (plimbs.db_map_plain(p, xs, k, z, iz2, s1, s2, s3, 8),
                   [p, None, xs, k, 64, z, 8, iz2, s1, s2, s3], [n, 8, 1],
                   (n, 8), (n, 8)),
        "l_map": (plimbs.l_map_plain(d, p, b, cp, cb),
                  [d, p, b, cp, 8, cb, 8], [n, 1], (n, 8)),
        "fold4": (plimbs.fold4_plain(x[:q], tab, s1, s2, 4),  # round 2
                  [x[:q], tab, s1, s2], [q // 4, 4, 1], (q // 4, 8)),
        "mul": (plimbs.mul_plain(x, cp), [x, n, 0, cp, 8, 0], [n, 1],
                (n, 8)),
        "add": (plimbs.add_plain(s1[None], p), [s1, 1, 0, p, n, 0], [n, 1],
                (n, 8)),
        "sub": (plimbs.sub_plain(z, xs), [z, 8, 0, xs, n, 0], [n, 1],
                (n, 8)),
        "cube": (plimbs.cube_plain(x), [x], [n, 1], (n, 8)),
        "mimc_trace": (plimbs.mimc_trace_plain(x[:3], k[:5], 9),  # n_k odd
                       [x[:3], k[:5], 5], [9, 3], (3, 9, 8)),
        # zeros in x; blocks of 32 x 2, then 32 x 1: two levels, the
        # scan's scratch an output too
        "batch_inv": (plimbs.batch_inv_plain(x), [x],
                      [plimbs.batch_inv_scratch(n, 32, 2, 1), n, 32, 2, 1],
                      (n, 8), (plimbs.batch_inv_scratch(n, 32, 2, 1), 8)),
    }


def _host_call(lib, entry, ins, ints, out_shapes):
    """Call a g++-built entry point; returns its output tensors."""
    outs = [torch.empty(s, dtype=torch.int32) for s in out_shapes]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in ins + outs] + ints + [None]
    assert getattr(lib, entry)(*args) == 0
    return outs


ENTRY = {"dif_pass": "starks_ntt_dif", "dit_pass": "starks_ntt_dit"}


@pytest.mark.parametrize("name", sorted(plimbs.LAUNCHES))
def test_kernel_body_matches_plain(host_kernels, name):
    want, ins, ints, *out_shapes = _host_cases()[name]
    outs = _host_call(host_kernels, ENTRY.get(name, "starks_" + name), ins,
                      ints, out_shapes)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.parametrize("n,k", DIF_PASSES)
def test_host_ntt_dif_matches_stage_chain_and_jax(host_kernels, n, k):
    """The pass kernel's group and twiddle arithmetic (shared with the
    CUDA build) over several passes, the last one short, with no scale:
    its last stage takes no twiddle product."""
    _, x, tab, want = _jax_dif_case(n)
    out, _ = _host_call(host_kernels, "starks_ntt_dif", [x, tab, None],
                        [n, k, 1], [(n, 8), (n, 8)])
    assert out.equal(plimbs.dif_transform_plain(x, tab))
    assert _same(out, want)


@pytest.mark.parametrize("n,k", DIF_PASSES)
def test_host_ntt_dif_scaled_matches_stage_chain_and_jax(host_kernels, n,
                                                         k):
    """With a scale s, the last (short) pass multiplies both outputs of
    its last stage by s: the plain stage chain times s, and JAX ntt_dif
    followed by the XLA multiply, for edge values of s and 1/n."""
    _, x, tab, want = _jax_dif_case(n)
    for v in (1, M - 1, 2 ** 255, pow(n, M - 2, M)):
        limbs = ints_to_limbs([v])
        s = fl.from_jax_limbs(limbs)[0]
        out, _ = _host_call(host_kernels, "starks_ntt_dif", [x, tab, s],
                            [n, k, 1], [(n, 8), (n, 8)])
        assert out.equal(plimbs.dif_transform_plain(x, tab, s))
        assert _same(out, _mul(want, jnp.broadcast_to(jnp.asarray(limbs),
                                                      want.shape)))


@pytest.mark.parametrize("wider", [0, 1])
@pytest.mark.parametrize("n,k", DIF_PASSES)
def test_host_ntt_dit_matches_stage_chain_and_jax(host_kernels, n, k,
                                                  wider):
    """The DIT pass kernel's group, twiddle and store arithmetic (shared
    with the CUDA build) over several passes of k or k + 1 stages, the
    short one first."""
    x, tab, want = _jax_dit_case(n)
    out, _ = _host_call(host_kernels, "starks_ntt_dit", [x, tab],
                        [n, k + wider, 0, 1], [(n, 8), (n, 8)])
    assert out.equal(plimbs.dit_transform_plain(x, tab))
    assert _same(out, want)


@functools.lru_cache(maxsize=None)
def _jax_lde_case(steps):
    """(port plan, trace, JAX lde_fused output) at `steps`, seeded."""
    args = _plan_args(steps)
    jplan = jfused.FusedPlan.get(*args, 2)
    jtrace, trace = _rand(steps, 153, edge=True)
    want = jax.jit(jfused.lde_fused)(jtrace, jplan.tw_inv_small,
                                     jplan.n_inv_small, jplan.tw_fwd_big)
    return fused.FusedPlan(*args, "cpu"), trace, want


@pytest.mark.parametrize("k", [3, 5, 6, 9])
def test_host_lde_compact_first_pass_matches_lde_fused(host_kernels, k):
    """The g++ DIT passes reading the compact 1/n-scaled coefficients
    (log_ext = 3, the copy stages skipped) give JAX `lde_fused` over 512
    points: 3 + 3 + 3 and 3 + 6 stages (a first pass of copies only),
    4 + 5, and one pass of 9."""
    plan, trace, want = _jax_lde_case(64)
    coeffs = fused.ntt_dif(trace, plan.inv_small, scale=plan.n_inv_small)
    n = plan.xs_big.shape[0]
    out, _ = _host_call(host_kernels, "starks_ntt_dit",
                        [coeffs, plan.xs_big], [n, k, 3, 1],
                        [(n, 8), (n, 8)])
    assert _same(out, want)


def test_host_cube_matches_ints_on_edge_values(host_kernels):
    """field::cube = mul(sqr(a), a) as g++ builds it, on every operand of
    the modmul's edge pairs (chip_smoke.mul_edge_pairs), against Python
    ints."""
    from chip_smoke import mul_edge_pairs
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    va, vb = mul_edge_pairs(constructed=256)
    vals = sorted(set(va) | set(vb))
    a = ints_to_tensor(vals)
    (out,) = _host_call(host_kernels, "starks_cube", [a], [len(vals), 1],
                        [(len(vals), 8)])
    assert out.equal(plimbs.cube_plain(a))
    assert [int.from_bytes(out[i].numpy().tobytes(), "little")
            for i in range(len(vals))] == [v ** 3 % M for v in vals]


def test_host_mul_takes_any_value_below_2_256(host_kernels):
    """field::mul's folds bound any product below 2^512, so either
    operand may lie in [p, 2^256): the g++ build against Python ints,
    with such values on either side of structured and random ones."""
    from chip_smoke import structured_ints
    r = random.Random(160)
    big = [M, M + 1, 2 ** 256 - 1, 2 ** 256 - 2] + [
        r.randrange(M, 2 ** 256) for _ in range(28)]
    vals = structured_ints()[:32] + [r.randrange(M) for _ in range(32)]
    va = [x for x in big for _ in vals] + [y for _ in big for y in vals]
    vb = [y for _ in big for y in vals] + [x for x in big for _ in vals]

    def words(ints):
        return torch.from_numpy(np.frombuffer(b"".join(
            v.to_bytes(32, "little") for v in ints), dtype=np.int32)
            .reshape(-1, 8).copy())

    n = len(va)
    (out,) = _host_call(host_kernels, "starks_mul",
                        [words(va), n, 0, words(vb), n, 0], [n, 1],
                        [(n, 8)])
    assert out.equal(words([a * b % M for a, b in zip(va, vb)]))


@pytest.mark.parametrize("entry", ["starks_db_map"])
def test_host_db_map_matches_plain_on_structured_values(host_kernels,
                                                        entry):
    """The D/B map body as g++ builds it, with every array led by the
    structured values (chip_smoke.structured_ints) in shifted orders."""
    from chip_smoke import structured_ints
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    vals = structured_ints()
    n = 512
    rows = [ints_to_tensor((vals[j:] + vals[:j] + vals)[:n])
            for j in (0, 7, 31, 101)]
    p, xs, iz2 = rows[:3]
    k, z = rows[3][:64], rows[1][:8]
    s1, s2, s3 = (ints_to_tensor([v])[0] for v in (M - 1, 2 ** 255, 1))
    want = plimbs.db_map_plain(p, xs, k, z, iz2, s1, s2, s3, 8)
    outs = _host_call(host_kernels, entry,
                      [p, None, xs, k, 64, z, 8, iz2, s1, s2, s3],
                      [n, 8, 1], [(n, 8), (n, 8)])
    assert all(o.equal(w) for o, w in zip(outs, want))


def test_host_mul_matches_plain_on_edge_pairs(host_kernels):
    """field::mul as g++ builds it (the plain C++ branch of
    csrc/field.cuh) on the operand pairs that reach every carry path of
    the folds (chip_smoke.mul_edge_pairs), and on the field's edge
    values."""
    from chip_smoke import mul_edge_pairs
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    va, vb = mul_edge_pairs(constructed=256)
    a, b = ints_to_tensor(va), ints_to_tensor(vb)
    n = a.shape[0]
    (out,) = _host_call(host_kernels, "starks_mul", [a, n, 0, b, n, 0],
                        [n, 1], [(n, 8)])
    assert out.equal(plimbs.mul_plain(a, b))
    got = [int.from_bytes(out[i].numpy().tobytes(), "little")
           for i in range(0, n, 97)]
    assert got == [va[i] * vb[i] % M for i in range(0, n, 97)]


@pytest.mark.parametrize("n", [1, 3, 257])
@pytest.mark.parametrize("op", ["scale", "scale_acc", "cube"])
def test_host_stream_map_matches_plain(host_kernels, op, n):
    """scale (acc null and not) and cube, one kernel template, as g++
    builds them, at sizes that fill no whole warp or block, with every
    array led by the field's edge values."""
    m = max(n, len(EDGE))
    x, acc = (_rand(m, seed, edge=True)[1][:n] for seed in (170, 171))
    s = fl.from_jax_limbs(ints_to_limbs([M - 1]))[0]
    if op == "cube":
        want, entry, ins = plimbs.cube_plain(x), "starks_cube", [x]
    elif op == "scale":
        want, entry, ins = plimbs.scale_plain(x, s), "starks_scale", [
            x, 0, s, 0, None]
    else:
        want, entry, ins = plimbs.scale_plain(x, s, acc), "starks_scale", [
            x, 0, s, 0, acc]
    (out,) = _host_call(host_kernels, entry, ins, [n, 1], [(n, 8)])
    assert out.equal(want)


def test_host_ntt_dif_drops_table0_as_plain(host_kernels):
    """For a table with table[0] != 1 the card's last stage takes no
    twiddle product, and the plain version drops it the same way: the
    g++ build of the pass equals `dif_transform_plain`, which differs
    from the stage chain that multiplies by table[0]."""
    n, k = 256, 3
    _, x = _rand(n, 180, edge=True)
    _, tab = _rand(n, 181)
    s = _rand(1, 182)[1][0]
    assert not tab[0].equal(_power_like(tab)[0])
    chain = x
    for t in range(n.bit_length() - 1):
        chain = plimbs.dif_stage_plain(chain, tab, t)
    for scale in (None, s):
        want = plimbs.dif_transform_plain(x, tab, scale)
        out, _ = _host_call(host_kernels, "starks_ntt_dif", [x, tab, scale],
                            [n, k, 1], [(n, 8), (n, 8)])
        assert out.equal(want)
    assert not plimbs.dif_transform_plain(x, tab).equal(chain)


# -- the claim axis ---------------------------------------------------------

CLAIMS = 3
# Elementwise forms: "c" a per-claim operand [B, L, 8], "s" a shared one
# [L, 8]; L = n (full), 8 (a periodic table) or 1 (a constant).
ELEMENTWISE_FORMS = ["c,c", "c,s", "s,c", "c,c8", "s1,c"]
SCALE_FORMS = ["xs", "xc", "acc,xs", "acc,xc", "acc,xs1"]
CLAIM_CASES = (["db_map", "dif_pass", "dit_pass", "dit_pass_compact",
                "fold4", "l_map", "cube"]
               + [f"{op}[{f}]" for op in ("mul", "add", "sub")
                  for f in ELEMENTWISE_FORMS]
               + [f"scale[{f}]" for f in SCALE_FORMS])


def _claim_cases():
    """name -> (wrapper, args, claimed, C entry, C inputs, C ints, output
    shapes) for each kernel over CLAIMS claims with distinct inputs and
    per-claim operands (`claimed` marks the arguments with the claim
    axis; the rest are shared): the five kernels of the MiMC path, and
    the AIR's elementwise ops with each operand shared or per claim."""
    n, q, b = 256, 64, CLAIMS

    def per_claim(rows, seed):
        return torch.stack([_rand(rows, seed + c,
                                  edge=c == 0 and rows >= len(EDGE))[1]
                            for c in range(b)])

    x, p, d, bb, vals = (per_claim(n, s) for s in (200, 210, 220, 230, 240))
    coeffs = per_claim(n // 8, 250)
    slope, ia, sx = (per_claim(1, s)[:, 0] for s in (260, 270, 280))
    cp, cb = per_claim(8, 290), per_claim(8, 300)
    tab, xs, iz2 = (_rand(n, s)[1] for s in (310, 311, 312))
    ptab = _power_like(tab)
    k, z = _rand(64, 313)[1], _rand(8, 314)[1]
    s1, s2 = (_rand(1, s)[1][0] for s in (315, 316))
    full = (b, n, 8)
    cases = {}
    # (operand, per claim) by form, for the left and the right operand.
    sides = ({"c": (p, 1), "s": (xs, 0), "s1": (s1[None], 0)},
             {"c": (d, 1), "s": (iz2, 0), "c8": (cp, 1)})
    for op in ("mul", "add", "sub"):
        for form in ELEMENTWISE_FORMS:
            (ta, ca), (tb, cb_) = (side[f] for side, f in
                                   zip(sides, form.split(",")))
            la, lb = ta.shape[-2], tb.shape[-2]
            cases[f"{op}[{form}]"] = (
                getattr(plimbs, op), (ta, tb), (ca, cb_), "starks_" + op,
                [ta, la, la * ca, tb, lb, lb * cb_], [n, b], [full])
    ys = per_claim(1, 320)[:, 0]                 # each claim's scalar
    acc1 = per_claim(1, 330)
    for form in SCALE_FORMS:
        xv, lx, cx = {"xs": (xs, n, 0), "xc": (p, n, 1),
                      "xs1": (s1[None], 1, 0)}[form.split(",")[-1]]
        acc = (d if lx == n else acc1) if form.startswith("acc") else None
        cases[f"scale[{form}]"] = (
            plimbs.scale, (xv, ys) + ((acc,) if acc is not None else ()),
            (cx, 1, 1), "starks_scale", [xv, lx * cx, ys, 1, acc], [lx, b],
            [(b, lx, 8)])
    cases["cube"] = (plimbs.cube, (p,), (1,), "starks_cube", [p], [n, b],
                     [full])
    return cases | {
        "dif_pass": (plimbs.dif_transform, (x, ptab, 3, s1),
                     (1, 0, 0, 0), "starks_ntt_dif", [x, ptab, s1],
                     [n, 3, b], [full, full]),
        "dit_pass": (plimbs.dit_transform, (x, tab, 3, 1), (1, 0, 0, 0),
                     "starks_ntt_dit", [x, tab], [n, 3, 0, b],
                     [full, full]),
        "dit_pass_compact": (plimbs.dit_transform, (coeffs, tab, 5, 8),
                             (1, 0, 0, 0), "starks_ntt_dit",
                             [coeffs, tab], [n, 5, 3, b], [full, full]),
        "db_map": (plimbs.db_map,
                   (p, xs, k, z, iz2, s1, slope, ia, 8),
                   (1, 0, 0, 0, 0, 0, 1, 1, 0), "starks_db_map",
                   [p, None, xs, k, 64, z, 8, iz2, s1, slope, ia],
                   [n, 8, b],
                   [full, full]),
        "l_map": (plimbs.l_map, (d, p, bb, cp, cb), (1, 1, 1, 1, 1),
                  "starks_l_map", [d, p, bb, cp, 8, cb, 8], [n, b],
                  [full]),
        "fold4": (plimbs.fold4, (vals, tab, sx, s2, 2), (1, 0, 1, 0, 0),
                  "starks_fold4", [vals, tab, sx, s2], [q, 2, b],
                  [(b, q, 8)]),
    }


def _claim_args(args, claimed, c):
    return tuple(a[c] if cl else a for a, cl in zip(args, claimed))


def _stacked(outs):
    """Per-claim results (a tensor or a tuple each) stacked on a claim
    axis, as a tuple."""
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    return tuple(torch.stack(parts) for parts in zip(*outs))


@pytest.mark.parametrize("name", CLAIM_CASES)
def test_claim_axis_plain_equals_per_claim_calls(name):
    """Each batched plain version (the wrapper on CPU tensors) equals its
    unbatched plain version called claim by claim."""
    wrapper, args, claimed, *_ = _claim_cases()[name]
    got = wrapper(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = _stacked([wrapper(*_claim_args(args, claimed, c))
                     for c in range(CLAIMS)])
    assert len(got) == len(want)
    assert all(g.equal(w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", CLAIM_CASES)
def test_claim_axis_kernel_body_matches_plain(host_kernels, name):
    """The g++ build of each kernel body over CLAIMS claims in one call
    equals the batched plain version."""
    wrapper, args, _, entry, ins, ints, out_shapes = _claim_cases()[name]
    want = wrapper(*args)
    want = want if isinstance(want, tuple) else (want,)
    outs = _host_call(host_kernels, entry, ins, ints, out_shapes)
    assert all(o.equal(w) for o, w in zip(outs, want))


def test_elementwise_claim_axis_rejects_mismatched_operands():
    """Per-claim operands of mul, add, sub and scale must agree on the
    claims, and scale's accumulator must have the result's shape."""
    _, (p, d), *_ = _claim_cases()["mul[c,c]"]
    for op in (plimbs.mul, plimbs.add, plimbs.sub):
        with pytest.raises(ValueError, match="claims"):
            op(p, d[:2])
        with pytest.raises(ValueError):
            op(p[:, :24], d)                       # 24 does not divide 256
        with pytest.raises(ValueError):
            op(p[None], d)                         # two leading axes
    _, (x, ys, acc), *_ = _claim_cases()["scale[acc,xc]"]
    with pytest.raises(ValueError, match="claims"):
        plimbs.scale(x, ys[:2])
    with pytest.raises(ValueError, match="acc"):
        plimbs.scale(x[0], ys, acc[:, :8])
    with pytest.raises(ValueError):
        plimbs.scale(x, ys[None])
    with pytest.raises(ValueError):
        plimbs.cube(x[None])


def test_host_mimc_trace_matches_native(host_kernels):
    """mimc_trace_kernel's body as g++ builds it, over 3 claims at 64
    steps with 64 round constants, equals each claim's native trace
    (models.mimc.trace_limbs) and the plain version."""
    from starks_tpu_torch.models import mimc
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    consts = [(i ** 7) ^ 42 for i in range(64)]
    inps = [3, 4, M - 1]
    x0, k = ints_to_tensor(inps), ints_to_tensor(consts)
    (out,) = _host_call(host_kernels, "starks_mimc_trace", [x0, k, 64],
                        [64, 3], [(3, 64, 8)])
    assert out.equal(plimbs.mimc_trace_plain(x0, k, 64))
    for c, x in enumerate(inps):
        assert out[c].equal(torch.from_numpy(mimc.trace_limbs(x, 64,
                                                              consts)))


def test_host_mimc_trace_reads_many_constants_from_device_memory(
        host_kernels):
    """More constants than the kernel stages in shared memory (2048 over
    4096 steps, so every constant is read twice): the body of the
    device-memory variant as g++ builds it equals each claim's native
    trace."""
    from starks_tpu_torch.models import mimc
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    consts = [(i ** 7) ^ 42 for i in range(2048)]
    assert len(consts) > plimbs.SHARED_TRACE_CONSTS
    inps = [3, M - 1]
    x0, k = ints_to_tensor(inps), ints_to_tensor(consts)
    (out,) = _host_call(host_kernels, "starks_mimc_trace", [x0, k, 2048],
                        [4096, 2], [(2, 4096, 8)])
    for c, x in enumerate(inps):
        assert out[c].equal(torch.from_numpy(mimc.trace_limbs(x, 4096,
                                                              consts)))


# The trace's redundant form at its edges: inputs 1 (with the constant
# p - 1 its first step lands on p exactly), p - 2 (the second constant is
# solved on the host so that its second step lands on p), p - 1, 0 and
# 2^255; constant counts 1, 5, all of shared memory and one more.
TRACE_EDGE_INPUTS = [1, M - 2, M - 1, 0, 2 ** 255]


@functools.lru_cache(maxsize=None)
def _trace_edge_consts():
    r = random.Random(170)
    x1 = ((M - 2) ** 3 + (M - 1)) % M     # claim 1 after its first step
    solved = (M - x1 ** 3 % M) % M         # x1^3 + solved == p
    assert x1 ** 3 % M + solved == M
    return [M - 1, solved] + [r.randrange(M) for _ in range(
        plimbs.SHARED_TRACE_CONSTS - 1)]


@pytest.mark.parametrize("steps", [1, 2, 64])
@pytest.mark.parametrize("claims", [1, 3, 5])
@pytest.mark.parametrize("n_k", [1, 5, 1536, 1537])
@pytest.mark.parametrize("entry", ["starks_mimc_trace",
                                   "starks_mimc_trace_canonical"])
def test_host_mimc_trace_redundant_form_edges(host_kernels, entry, n_k,
                                              claims, steps):
    """mimc_trace_kernel's round (field::mimc_round: lazy folds, k in the
    product's first row, the stored row made canonical) and the design it
    replaced, as g++ builds them, against the plain version and the
    native trace at the redundant form's edges; 1537 constants take the
    device-memory variant."""
    from starks_tpu_torch.utils import native
    from starks_tpu_torch.utils.conversions import ints_to_tensor
    consts = _trace_edge_consts()[:n_k]
    inps = TRACE_EDGE_INPUTS[:claims]
    x0, k = ints_to_tensor(inps), ints_to_tensor(consts)
    (out,) = _host_call(host_kernels, entry, [x0, k, n_k], [steps, claims],
                        [(claims, steps, 8)])
    assert out.equal(plimbs.mimc_trace_plain(x0, k, steps))
    for c, x in enumerate(inps):
        assert out[c].equal(torch.from_numpy(native.mimc_trace(x, steps,
                                                               consts)))
    # The steps that land on p store 0.
    if steps > 1:
        assert not out[0, 1].any()
    if steps > 2 and claims > 1 and n_k > 1:
        assert not out[1, 2].any()


def test_mimc_trace_rejects_bad_arguments(host_kernels):
    x0, k = _rand(3, 90)[1], _rand(8, 91)[1]
    with pytest.raises(ValueError):
        plimbs.mimc_trace(x0[0], k, 8)                 # x0 not [B, 8]
    with pytest.raises(ValueError):
        plimbs.mimc_trace(x0, k[:0], 8)                # no constants
    with pytest.raises(ValueError):
        plimbs.mimc_trace(x0, k, 0)
    # The C entry refuses what the wrapper refuses: no constants.
    out = torch.empty((3, 8, 8), dtype=torch.int32)
    assert host_kernels.starks_mimc_trace(
        x0.data_ptr(), k.data_ptr(), 0, out.data_ptr(), 8, 3, None) != 0


@pytest.mark.parametrize("shards", [2, 4])
def test_db_map_halo_shards_equal_whole_domain(host_kernels, shards):
    """The D/B map over each of `shards` contiguous shards of a domain of
    CLAIMS claims, with the next shard's first `shift` rows as its halo
    (cyclically), equals the whole domain's map: the plain version, and
    the g++ build of the kernel body reading the halo past the shard's
    end. The K table's period (64) divides the shard."""
    _, args, *_ = _claim_cases()["db_map"]
    p, xs, k, z, iz2, last, slope, ia, shift = args
    n, b = p.shape[-2], p.shape[0]
    want = plimbs.db_map(p, xs, k, z, iz2, last, slope, ia, shift)
    rows = n // shards
    for r in range(shards):
        part = slice(r * rows, (r + 1) * rows)
        nxt = (r + 1) % shards * rows
        halo = p[:, nxt:nxt + shift].contiguous()
        pr = p[:, part].contiguous()
        got = plimbs.db_map(pr, xs[part], k, z, iz2[part], last, slope, ia,
                            shift, halo=halo)
        outs = _host_call(host_kernels, "starks_db_map",
                          [pr, halo, xs[part].contiguous(), k, 64, z, 8,
                           iz2[part].contiguous(), last, slope, ia],
                          [rows, shift, b], [(b, rows, 8), (b, rows, 8)])
        for g, o, w in zip(got, outs, want):
            assert g.equal(w[:, part]) and o.equal(w[:, part])
    with pytest.raises(ValueError, match="halo"):
        plimbs.db_map(p, xs, k, z, iz2, last, slope, ia, shift,
                      halo=p[:, :shift - 1])


def test_claim_axis_rejects_mismatched_operands():
    """A per-claim operand must carry the array's claim axis, a shared
    one must not."""
    _, args, *_ = _claim_cases()["db_map"]
    p, xs, k, z, iz2, last, slope, ia, shift = args
    with pytest.raises(ValueError):
        plimbs.db_map(p, xs, k, z, iz2, last, slope[0], ia, shift)
    with pytest.raises(ValueError):
        plimbs.db_map(p[0], xs, k, z, iz2, last, slope, ia, shift)
    with pytest.raises(ValueError):
        plimbs.db_map(p, xs[None].expand(CLAIMS, -1, -1), k, z, iz2, last,
                      slope, ia, shift)
    _, (d, pp, bb, cp, cb), *_ = _claim_cases()["l_map"]
    with pytest.raises(ValueError):
        plimbs.l_map(d, pp, bb, cp[0], cb)
    _, (vals, ip, sx, eta, shift), *_ = _claim_cases()["fold4"]
    with pytest.raises(ValueError):
        plimbs.fold4(vals, ip, sx[:2], eta, shift)
    with pytest.raises(ValueError):
        plimbs.dif_transform(torch.zeros((1, 1, 4, 8), dtype=torch.int32),
                             ip)


# -- dispatch ---------------------------------------------------------------

def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    plimbs.reset_launches()
    x = _rand(64, 80)[1]
    plimbs.scale(x, x[0])
    plimbs.scale(x, x[0], acc=x)
    plimbs.dif_transform(x, x, scale=x[0])
    assert set(plimbs.LAUNCHES.values()) == {0}


def test_wrappers_raise_on_other_devices():
    x = torch.empty((64, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        plimbs.scale(x, x[0])
    with pytest.raises(ValueError):
        plimbs.scale(_rand(64, 81)[1].to(torch.int64), x[0])


def test_wrappers_reject_bad_arguments():
    x = _rand(64, 82)[1]
    with pytest.raises(ValueError):
        plimbs.dif_transform(x[:48], x)           # not a power of two
    with pytest.raises(ValueError):
        plimbs.dit_transform(x[:48], x)           # not a power of two
    with pytest.raises(ValueError):
        plimbs.scale(x, x[0], acc=x[:32])         # acc shape differs
    with pytest.raises(ValueError):
        plimbs.l_map(x, x, x, x[:0], x[:8])       # empty periodic table
    with pytest.raises(ValueError):
        plimbs.db_map(x, x, x, x[:8], x, x[0], x[0], x[0], 64)   # shift
    with pytest.raises(ValueError):
        plimbs.mul(x, x[:24])                     # 24 does not divide 64
    with pytest.raises(ValueError):
        plimbs.add(x, x[0])                       # a scalar is [1, 8]
