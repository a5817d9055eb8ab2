"""General AIR (Algebraic Intermediate Representation) STARKs on PyTorch
and CUDA.

Port of `starks_tpu/air.py`: `prove_air_batch_fused` is the counterpart
of `_FusedAIRSetup.batch_core` (the vmap of the AIR core over a claim
axis) followed by one proof's assembly per claim, and `prove_air`, its
one-claim case, of both JAX `prove_air` and `prove_air_fused` (whose
proofs are byte-identical). Both follow the single-device core
`pallas_core_fn` without its pruning.

Protocol (w registers, m transition constraints, b bounded registers):
  - each register column is LDE'd over <G2> (8x blowup)
  - C_i = t_i(P(x), P(g1 x), K(x)) must vanish on trace rows except the
    last: D_i = C_i * (x - last) / (x^steps - 1)
  - for each register r with boundary points S_r: I_r interpolates them,
    Z_r = prod_{(xb,_) in S_r} (x - xb), B_r = (P_r - I_r) / Z_r
  - Merkle leaf = P_0..P_{w-1} || D_0..D_{m-1} || B_r... (32B each)
  - Fiat-Shamir weights k_j = blake2s(m_root || bytes([j])), j=1..:
    L = sum_i k_i D_i + sum_q (k' P/B_q + k'' P/B_q * x^steps)
  - 80 spot checks + FRI(L, deg < 2*steps), as in the MiMC proof.

Transition constraints are written against an `ops` namespace (add /
sub / mul / cube and constant embedding), so the same definition runs on
[B, n, 8] field tensors of B claims in the prover (`TorchOps`: one
launch of the mul, add, sub or cube kernel per op for all B claims) and
on Python ints in the verifier (`HostOps`).
"""

import torch

from . import prover
from .config import StarkConfig, REFERENCE
from .ops import blake2s as b2
from .ops import fused
from .ops import merkle
from .ops import plimbs
from .ops import transcript_dev as td
from .transcript import pseudorandom_indices, challenge_int, is_a_power_of_2
from .utils import hostfield as hf
from .utils.conversions import NUM_WORDS, int_to_tensor, ints_to_tensor
from .verifier import verify_branch, verify_low_degree_proof, _check

MODULUS = REFERENCE.modulus


class TorchOps:
    """Field ops on int32 tensors (prover side), each one kernel launch
    (ops/plimbs.py) on the card or its plain version on the CPU. The
    claims' columns are [B, n, 8]; constants and constant columns are
    [L, 8], shared by the claims. Operands are read periodically, so a
    constant is one [1, 8] element and a constant column its
    [8 * len(col), 8] extension: neither is tiled to the domain size.
    Counterpart of `PallasOps`."""

    add = staticmethod(plimbs.add)
    sub = staticmethod(plimbs.sub)
    mul = staticmethod(plimbs.mul)
    cube = staticmethod(plimbs.cube)

    def __init__(self, device):
        self.device = device
        self._consts = {}

    def const(self, c: int):
        c %= MODULUS
        if c not in self._consts:
            self._consts[c] = ints_to_tensor([c], self.device)
        return self._consts[c]


class HostOps:
    """Field ops on Python ints (verifier side)."""

    @staticmethod
    def add(a, b):
        return (a + b) % MODULUS

    @staticmethod
    def sub(a, b):
        return (a - b) % MODULUS

    @staticmethod
    def mul(a, b):
        return (a * b) % MODULUS

    @staticmethod
    def cube(a):
        return pow(a, 3, MODULUS)

    def const(self, c: int):
        return c % MODULUS


class AIR:
    """An algebraic intermediate representation.

    width:        number of registers
    step_fn(state, consts) -> next state   (host ints; trace generation)
    transition(cur, nxt, consts, ops) -> [constraint values]
                  cur/nxt: per-register values; consts: per-constant-
                  column values; must be polynomial of total degree <= 3
    constants:    list of periodic constant columns (each a power-of-2
                  length list of ints, cycling over trace rows)
    boundaries(steps) -> list of (step, register) pairs whose trace
                  values are pinned as public boundary constraints
    """

    def __init__(self, width, step_fn, transition, num_constraints,
                 constants, boundary_points):
        self.width = width
        self.step_fn = step_fn
        self.transition = transition
        self.num_constraints = num_constraints
        self.constants = constants
        self.boundary_points = boundary_points

    def trace(self, inputs, steps):
        state = [x % MODULUS for x in inputs]
        assert len(state) == self.width
        rows = [state]
        for i in range(steps - 1):
            consts = [col[i % len(col)] for col in self.constants]
            state = self.step_fn(state, consts)
            rows.append([x % MODULUS for x in state])
        return rows


def _eval_table(coeffs, xs, ops: TorchOps):
    """Evaluations of a polynomial (host-int coefficients) at every x of
    xs [n, 8], by Horner with the mul and add kernels, as JAX
    `_FusedAIRSetup` evaluates a boundary basis (starks_tpu/air.py:
    361-370); a constant is kept as one [1, 8] value, which the kernels
    read periodically."""
    ev = ops.const(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        ev = plimbs.add(plimbs.mul(ev, xs), ops.const(c))
    return ev


class _FusedAIRSetup:
    """Per-(air, steps, config, device) schedule and device tables: all
    that does not depend on the claim's inputs. Boundary points are part
    of the AIR; only boundary values come with each proof."""

    _cache = {}

    def __init__(self, air: AIR, steps: int, config: StarkConfig, device):
        m = config.modulus
        ext = config.extension_factor
        precision = steps * ext
        G2 = pow(config.generator, (m - 1) // precision, m)
        G1 = pow(G2, ext, m)
        self.air, self.config = air, config
        self.precision, self.ext = precision, ext
        self.schedule = fused.fri_round_schedule(
            precision, steps * 2, config.fri_base_cutoff)
        self.plan = fused.FusedPlan(steps, precision, G1, G2, device)
        self.ops = TorchOps(device)

        # The domain tables on the device, from the plan's power table,
        # as JAX builds them (starks_tpu/air.py:319-376).
        xs = self.plan.xs_big
        last = pow(G2, (steps - 1) * ext, m)
        h = pow(G2, steps, m)
        self.x_minus_last = plimbs.sub(xs, self.ops.const(last))
        # 1/(x^steps - 1) is 8-periodic over the domain (zero where it
        # vanishes, as the reference's inv(0) = 0).
        self.zni = ints_to_tensor(
            [hf.inv(pow(h, i, m) - 1) for i in range(ext)], device)
        self.h_pows = ints_to_tensor([pow(h, i, m) for i in range(ext)],
                                     device)
        self.eta_l = int_to_tensor(pow(G2, precision // 4, m), device)

        # Each constant column's extension at its own period 8*len(col).
        self.k_tabs = []
        for col in air.constants:
            skips2 = steps // len(col)
            mini = hf.host_ntt(list(col), pow(G1, skips2, m), inverse=True)
            k_ext = hf.host_ntt(mini, pow(G2, skips2, m))
            self.k_tabs.append(ints_to_tensor([x % m for x in k_ext],
                                              device))

        # Per bounded register: Lagrange basis evaluations and 1/Z_r,
        # Z_r the product of (x - x_b) over its boundary points, inverted
        # by one batch inverse (zeros map to zero, as the JAX package's
        # batch_inv_scan does).
        by_reg = {}
        for step, reg in air.boundary_points(steps):
            by_reg.setdefault(reg, []).append(step)
        self.b_regs = sorted(by_reg)
        self.b_steps = {reg: sorted(by_reg[reg]) for reg in self.b_regs}
        self.basis, self.inv_z = [], []
        for reg in self.b_regs:
            pts = [pow(G1, s, m) for s in self.b_steps[reg]]
            basis_r = []
            for j, xj in enumerate(pts):
                # L_j(x) = prod_{l != j} (x - x_l) / (x_j - x_l)
                num, denom = [1], 1
                for l, xl in enumerate(pts):
                    if l != j:
                        num = hf._mul_linear(num, xl, m)
                        denom = denom * (xj - xl) % m
                scale = hf.inv(denom, m)
                basis_r.append(_eval_table([c * scale % m for c in num],
                                           xs, self.ops))
            self.basis.append(basis_r)
            z = None
            for xb in pts:
                factor = plimbs.sub(xs, self.ops.const(xb))
                z = factor if z is None else plimbs.mul(z, factor)
            self.inv_z.append(plimbs.batch_inv(z))

        nb = len(self.b_regs)
        self.main_leaf_words = NUM_WORDS * (air.width + air.num_constraints
                                            + nb)
        self.n_weights = air.num_constraints + 2 * (air.width + nb)

    @classmethod
    def get(cls, air: AIR, steps: int, config: StarkConfig,
            device) -> "_FusedAIRSetup":
        # Keyed on the AIR's content, not the object: the tables bake in
        # the constant columns and boundary points. Callables are keyed by
        # identity (the cached setup keeps them alive); treat an AIR as
        # immutable, or call clear_cache().
        key = (id(air.step_fn), id(air.transition), air.width,
               air.num_constraints,
               tuple(tuple(col) for col in air.constants),
               tuple(air.boundary_points(steps)), steps, config,
               str(device))
        if key not in cls._cache:
            cls._cache[key] = cls(air, steps, config, device)
        return cls._cache[key]

    @classmethod
    def clear_cache(cls):
        cls._cache.clear()


def _prove_air_sections(air: AIR, su: _FusedAIRSetup, trace, ys, timer):
    """The device part of B AIR proofs (`pallas_core_fn` of
    starks_tpu/air.py without pruning, over a claim axis, as
    `batch_core` vmaps it): traces [B, w, steps, 8], boundary values
    ys [B, k, 8], each claim's in b_regs order, then sorted steps.
    Returns the named sections, as int64 word tensors [B, ...] on the
    device."""
    plan = su.plan
    claims, w, steps = trace.shape[:3]

    # One LDE of all B*w register columns (register-major, so that each
    # register's [B, n, 8] block is contiguous).
    p = fused.lde(trace.transpose(0, 1).reshape(w * claims, steps, NUM_WORDS),
                  plan.inv_small, plan.n_inv_small, plan.xs_big)
    p_cols = list(p.reshape(w, claims, -1, NUM_WORDS))
    timer.mark("lde")

    # Transition constraints -> quotients; boundary quotients. P(g1 x)
    # rolls each claim's own rows.
    nxt = [torch.roll(col, -su.ext, -2) for col in p_cols]
    c_list = air.transition(p_cols, nxt, su.k_tabs, su.ops)
    if len(c_list) != air.num_constraints:
        raise ValueError(f"transition gave {len(c_list)} constraints, the "
                         f"AIR declares {air.num_constraints}")
    d_cols = [plimbs.mul(plimbs.mul(c, su.x_minus_last), su.zni)
              for c in c_list]
    b_cols = []
    y_iter = iter(ys.transpose(0, 1).contiguous())   # [B, 8] per point
    for reg, basis_r, inv_z in zip(su.b_regs, su.basis, su.inv_z):
        i_ev = None
        for basis in basis_r:
            i_ev = plimbs.scale(basis, next(y_iter), acc=i_ev)
        b_cols.append(plimbs.mul(plimbs.sub(p_cols[reg], i_ev), inv_z))
    timer.mark("constraints/quotient/boundary")

    # Commit #1: leaf = P cols || D cols || B cols.
    m_leaf = torch.cat([b2.limbs_to_words(c)
                        for c in p_cols + d_cols + b_cols], dim=-1)
    m_tree = merkle.Tree(m_leaf)
    timer.mark("merkle #1 (P||D||B)")

    # Fiat-Shamir weights ([B, 8], each claim's own): D columns, then
    # (k', k'') per P and B column.
    ks = iter([td.challenge_limbs(m_tree.root, j + 1)
               for j in range(su.n_weights)])
    l_vals = None
    for d in d_cols:
        l_vals = plimbs.scale(d, next(ks), acc=l_vals)
    for col in p_cols + b_cols:
        coef = td.lincomb_coeffs(next(ks), next(ks), su.h_pows)
        term = plimbs.mul(col, coef)
        l_vals = term if l_vals is None else plimbs.add(l_vals, term)
    return prover._query_sections(su, m_tree, l_vals, timer)


def _prove_air_chunk(air: AIR, inputs_list, steps: int, config, device,
                     timer):
    """Queue the proofs of one chunk of claims and their one
    device-to-host copy. Returns the setup, the pending fetch and each
    claim's public boundary list."""
    rows = [air.trace(inputs, steps) for inputs in inputs_list]
    timer.mark("host trace")
    su = _FusedAIRSetup.get(air, steps, config, device)
    w, claims = air.width, len(rows)
    trace = prover._upload(ints_to_tensor(
        [row[r] for t in rows for r in range(w) for row in t]).reshape(
            claims, w, steps, NUM_WORDS), device)
    points = air.boundary_points(steps)
    values = [{(s, r): t[s][r] for (s, r) in points} for t in rows]
    order = [(s, reg) for reg in su.b_regs for s in su.b_steps[reg]]
    ys = prover._upload(ints_to_tensor(
        [v[key] for v in values for key in order]).reshape(
            claims, len(order), NUM_WORDS), device)
    timer.mark("setup + trace upload")
    sections = _prove_air_sections(air, su, trace, ys, timer)
    return su, prover._start_fetch(sections), [sorted(v.items())
                                               for v in values]


def _finish_air_chunk(pending, timer):
    su, fetch, boundaries = pending
    proofs = prover._finish_fetch(fetch, su.main_leaf_words,
                                  len(su.schedule), timer)
    return [proof + [b] for proof, b in zip(proofs, boundaries)]


def prove_air_batch_fused(air: AIR, inputs_list, steps: int,
                          config: StarkConfig = REFERENCE, chunk: int = None,
                          device=None, timings: dict = None):
    """Proofs of independent claims of one AIR, one per entry of
    `inputs_list` (each a list of `air.width` ints), each
    [m_root, l_root, main_branches, lc_branches, fri_proof,
    public_boundary] and byte-identical to `prove_air` for that claim.

    The counterpart of the JAX package's `_FusedAIRSetup.batch_core`
    (starks_tpu/air.py:685) followed by one proof's assembly per claim.
    Claims go in chunks of `chunk` (default prover.DEFAULT_CHUNK): each
    chunk is one pass of the prover over a claim axis (one launch of
    each kernel and blake2s tensor op for all its claims) and one
    device-to-host copy. Chunk i+1's traces (`air.trace`, Python ints)
    are built and its proofs queued before chunk i is assembled on the
    host. `device` as in `prove_air`; with `timings`, the stage seconds
    of the last chunk (each stage waits for the device)."""
    device = prover._resolve_device(device)
    assert is_a_power_of_2(steps)
    assert steps <= 2**32 // config.extension_factor
    chunk = prover.DEFAULT_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    timer = prover._StageTimer(timings, device)
    inputs_list = list(inputs_list)
    proofs, pending = [], None
    for lo in range(0, len(inputs_list), chunk):
        queued = _prove_air_chunk(air, inputs_list[lo:lo + chunk], steps,
                                  config, device, timer)
        if pending is not None:
            proofs += _finish_air_chunk(pending, timer)
        pending = queued
    if pending is not None:
        proofs += _finish_air_chunk(pending, timer)
    return proofs


def prove_air(air: AIR, inputs, steps: int,
              config: StarkConfig = REFERENCE, device=None,
              timings: dict = None):
    """[m_root, l_root, main_branches, lc_branches, fri_proof,
    public_boundary] for `air` on `inputs`: the one-claim case of
    `prove_air_batch_fused`.

    The counterpart of both `starks_tpu.air.prove_air` and
    `prove_air_fused`, which emit identical bytes; this proof equals
    them byte for byte. JAX `prove_air` takes no config, so a proof
    under a config other than REFERENCE has no reference: it is checked
    only by the port's own verifier (`verify_air`). `device` None means
    "cuda", and then a CUDA device must be present: the prover never
    falls back to the CPU on its own. `device="cpu"` runs the plain
    PyTorch versions of the kernels. Pass a dict as `timings` to receive
    per-stage seconds, with the stage names of `mk_mimc_proof`."""
    return prove_air_batch_fused(air, [inputs], steps, config, chunk=1,
                                 device=device, timings=timings)[0]


def verify_air(air: AIR, steps: int, proof,
               config: StarkConfig = REFERENCE) -> bool:
    """Verify an AIR proof against its public boundary values."""
    (m_root, l_root, main_branches, lc_branches, fri_proof,
     public_boundary) = proof
    m = config.modulus
    skips = config.extension_factor
    precision = steps * skips
    G2 = pow(config.generator, (m - 1) // precision, m)
    G1 = pow(G2, skips, m)

    _check(verify_low_degree_proof(l_root, G2, fri_proof, steps * 2,
                                   exclude_multiples_of=skips,
                                   config=config), "FRI failed")

    boundary_values = dict(public_boundary)
    _check(set((s, r) for s, r in air.boundary_points(steps))
           == set(boundary_values), "boundary points mismatch")

    # Reconstruct per-register boundary interpolants.
    by_reg = {}
    for (step, reg) in boundary_values:
        by_reg.setdefault(reg, []).append(step)
    i_polys, z_points = {}, {}
    for reg in sorted(by_reg):
        xs_pts = [pow(G1, s, m) for s in sorted(by_reg[reg])]
        ys_pts = [boundary_values[(s, reg)] for s in sorted(by_reg[reg])]
        i_polys[reg] = hf.interp_many(xs_pts, ys_pts)
        z_points[reg] = xs_pts
    b_regs = sorted(by_reg)

    # Constant mini-polynomials.
    minis = []
    for col in air.constants:
        skips2 = steps // len(col)
        minis.append((hf.host_ntt(list(col), pow(G1, skips2, m),
                                  inverse=True), skips2))

    n_weights = air.num_constraints + 2 * (air.width + len(b_regs))
    ks = [challenge_int(m_root, j + 1) for j in range(n_weights)]

    positions = pseudorandom_indices(l_root, precision, config.spot_checks,
                                     exclude_multiples_of=skips)
    last = pow(G2, (steps - 1) * skips, m)
    w, nc = air.width, air.num_constraints
    leaf_cols = w + nc + len(b_regs)
    ops = HostOps()

    for i, pos in enumerate(positions):
        x = pow(G2, pos, m)
        x_steps = pow(x, steps, m)
        leaf1 = verify_branch(m_root, pos, main_branches[2 * i])
        leaf2 = verify_branch(m_root, (pos + skips) % precision,
                              main_branches[2 * i + 1])
        _check(len(leaf1) == 32 * leaf_cols, "bad leaf width")
        vals1 = [int.from_bytes(leaf1[32 * j:32 * (j + 1)], 'big')
                 for j in range(leaf_cols)]
        vals2 = [int.from_bytes(leaf2[32 * j:32 * (j + 1)], 'big')
                 for j in range(leaf_cols)]
        p_vals, d_vals = vals1[:w], vals1[w:w + nc]
        b_vals = vals1[w + nc:]
        p_next = vals2[:w]
        l_of_x = verify_branch(l_root, pos, lc_branches[i], as_int=True)

        consts = [hf.eval_poly_at(mini, pow(x, skips2, m))
                  for (mini, skips2) in minis]
        c_vals = air.transition(p_vals, p_next, consts, ops)
        z = (x_steps - 1) * hf.inv(x - last) % m
        for c_val, d_val in zip(c_vals, d_vals):
            _check((c_val - z * d_val) % m == 0,
                   f"transition constraint fails at {pos}")

        for reg, b_val in zip(b_regs, b_vals):
            z2 = 1
            for xb in z_points[reg]:
                z2 = z2 * (x - xb) % m
            _check((p_vals[reg] - b_val * z2
                    - hf.eval_poly_at(i_polys[reg], x)) % m == 0,
                   f"boundary fails at {pos} reg {reg}")

        # Linear combination.
        acc = 0
        ki = iter(ks)
        for d_val in d_vals:
            acc = (acc + next(ki) * d_val) % m
        for q_val in p_vals + b_vals:
            acc = (acc + next(ki) * q_val + next(ki) * q_val * x_steps) % m
        _check((l_of_x - acc) % m == 0, f"linear combination fails at {pos}")
    return True
