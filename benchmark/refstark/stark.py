"""The MiMC STARK prover, plainly, over a claim axis.

The protocol of ethereum/research mimc_stark/ (stark.py, fri.py,
merkle_tree.py, utils.py) as packaged by computablelabs/starks: the
trace, its interpolant over the trace domain extended 8x by NTTs, the
transition quotient D and boundary quotient B, the P||D||B tree, the
Fiat-Shamir linear combination L and its tree, the spot-check branches,
and FRI on L with quartic folds. Every proof is the reference's nested
list [m_root, l_root, main_branches, lc_branches, fri_proof], byte for
byte. The field work runs on `device` (refstark.field, plain tensor
operations) for all claims at once; the trace, the challenges and the
query indices are computed on the host with Python ints and hashlib.
"""

import time

import torch

from . import field as F
from . import ntt as N
from .blake import blake
from .merkle import Tree

P = F.MODULUS


def mimc_trace(inp: int, steps: int, consts) -> list:
    out = [inp % P]
    for i in range(steps - 1):
        out.append((out[-1] ** 3 + consts[i % len(consts)]) % P)
    return out


def pseudorandom_indices(seed: bytes, modulus: int, count: int,
                         exclude_multiples_of: int = 0) -> list:
    assert modulus < 2 ** 24
    data = seed
    while len(data) < 4 * count:
        data += blake(data[-32:])
    if exclude_multiples_of == 0:
        return [int.from_bytes(data[i:i + 4], "big") % modulus
                for i in range(0, count * 4, 4)]
    ex = exclude_multiples_of
    real = modulus * (ex - 1) // ex
    return [x + 1 + x // (ex - 1) for x in
            (int.from_bytes(data[i:i + 4], "big") % real
             for i in range(0, count * 4, 4))]


def _host_ntt(vals, root: int, inverse: bool = False) -> list:
    """A small transform on Python ints (O(n^2)), natural order."""
    n = len(vals)
    if inverse:
        root = pow(root, P - 2, P)
    pw = [1]
    for _ in range(n - 1):
        pw.append(pw[-1] * root % P)
    out = [sum(v * pw[i * j % n] for j, v in enumerate(vals)) % P
           for i in range(n)]
    if inverse:
        inv_n = pow(n, P - 2, P)
        out = [x * inv_n % P for x in out]
    return out


class Setup:
    """The tables of one (steps, config, device): the domain's points,
    1/Z2 over them, and the round constants' extension."""

    def __init__(self, steps: int, config: dict, device):
        ext = config["extension_factor"]
        self.steps, self.ext, self.config = steps, ext, config
        self.n = n = steps * ext
        self.device = device
        self.g2 = pow(config["generator"], (P - 1) // n, P)
        self.g1 = pow(self.g2, ext, P)
        self.xs = F.powers(self.g2, n, device)                  # [16, n]
        self.last = pow(self.g2, (steps - 1) * ext, P)
        last = F.const(self.last, device)
        one = F.const(1, device)
        self.inv_z2 = F.batch_inv(F.mul(F.sub(self.xs, one),
                                        F.sub(self.xs, last)))
        self.x_minus_last = F.sub(self.xs, last)
        # x^steps = h^(i mod ext), h = g2^steps of order ext; 1/(x^steps
        # - 1), zero where x^steps = 1 (multi_inv's 1/0 = 0).
        h = pow(self.g2, steps, P)
        self.h_pows = [pow(h, i, P) for i in range(ext)]
        self.zni = [pow(v - 1, P - 2, P) if v != 1 else 0
                    for v in self.h_pows]
        self._k = {}

    def k_ext(self, consts) -> list:
        """The round constants' polynomial over the 8x domain, read
        cyclically (len(consts) * ext values)."""
        key = tuple(consts)
        if key not in self._k:
            skips2 = self.steps // len(consts)
            mini = _host_ntt(list(consts), pow(self.g1, skips2, P), True)
            mini += [0] * (len(consts) * self.ext - len(mini))
            self._k[key] = _host_ntt(mini, pow(self.g2, skips2, P))
        return self._k[key]


def _periodic(vals: list, period_shape, device) -> torch.Tensor:
    """[16, 1, ..., len(vals)] for a factor that repeats along the domain
    with period len(vals)."""
    return F.from_ints(vals, device).reshape(
        (F.LIMBS,) + (1,) * period_shape + (len(vals),))


def _per_claim(vals: list, device) -> torch.Tensor:
    """[16, claims, 1]: one element per claim."""
    return F.from_ints(vals, device).unsqueeze(-1)


class _Marks:
    """Seconds per step into `out` (when given), each after a wait for
    the device."""

    def __init__(self, out, device):
        self.out, self.device = out, torch.device(device)
        self.last = time.perf_counter()

    def __call__(self, name):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + now - self.last
        self.last = now


def prove(inps, steps: int, consts, config: dict, device="cpu",
          setup: Setup = None, timings: dict = None) -> list:
    """The proofs of mimc(inp) for each of `inps`, one per claim (with a
    dict as `timings`, the seconds of each step)."""
    cfg = config
    mark = _Marks(timings, device)
    ext = cfg["extension_factor"]
    assert steps <= 2 ** 32 // ext
    assert steps & (steps - 1) == 0 and len(consts) & (len(consts) - 1) == 0
    assert len(consts) < steps
    su = setup or Setup(steps, cfg, device)
    mark("set-up")
    n, claims = su.n, len(inps)
    traces = [mimc_trace(x, steps, consts) for x in inps]
    outputs = [t[-1] for t in traces]
    trace = F.from_ints([v for t in traces for v in t], device).reshape(
        F.LIMBS, claims, steps)
    mark("trace")

    # Interpolate over the trace domain, evaluate over the 8x domain.
    coeffs = N.ntt(trace, su.g1, inverse=True)
    padded = torch.zeros((F.LIMBS, claims, n), dtype=torch.int64,
                         device=device)
    padded[..., :steps] = coeffs
    p = N.ntt(padded, su.g2)
    del coeffs, padded, trace
    mark("LDE")

    # C = P(g1 x) - P(x)^3 - K(x); D = C (x - last) / (x^steps - 1).
    k = su.k_ext(consts)
    reps = n // len(k)
    k_t = F.from_ints(k, device).repeat(1, reps).unsqueeze(1)
    c = F.sub(F.sub(torch.roll(p, -ext, dims=-1),
                    F.mul(F.mul(p, p), p)), k_t)
    del k_t
    zni = _periodic(su.zni, 1, device).repeat(1, 1, n // ext)
    d = F.mul(F.mul(c, su.x_minus_last.unsqueeze(1)), zni)
    del c, zni

    # B = (P - I) / ((x - 1)(x - last)), I the line through (1, inp)
    # and (last, output): I(x) = a + s x.
    slopes = [(o - i) * pow(su.last - 1, P - 2, P) % P
              for i, o in zip(inps, outputs)]
    icepts = [(i - s) % P for i, s in zip(inps, slopes)]
    i_x = F.add(_per_claim(icepts, device),
                F.mul(_per_claim(slopes, device), su.xs.unsqueeze(1)))
    b = F.mul(F.sub(p, i_x), su.inv_z2.unsqueeze(1))
    del i_x
    mark("C, D, B")

    m_tree = Tree([p, d, b])
    mark("P||D||B tree")

    # L = D + k1 P + k2 P x^steps + k3 B + k4 B x^steps.
    ks = [[int.from_bytes(blake(r + bytes([j])), "big") % P
           for j in (1, 2, 3, 4)] for r in m_tree.roots]
    cp = [[(k1 + k2 * hp) % P for hp in su.h_pows] for k1, k2, _, _ in ks]
    cb = [[(k3 + k4 * hp) % P for hp in su.h_pows] for _, _, k3, k4 in ks]
    cp_t = F.from_ints([v for row in cp for v in row], device).reshape(
        F.LIMBS, claims, 1, ext)
    cb_t = F.from_ints([v for row in cb for v in row], device).reshape(
        F.LIMBS, claims, 1, ext)
    shape = (F.LIMBS, claims, n // ext, ext)
    l_vals = F.add(d, F.add(F.mul(p.reshape(shape), cp_t).reshape(p.shape),
                            F.mul(b.reshape(shape), cb_t).reshape(p.shape)))
    mark("L")
    l_tree = Tree([l_vals])
    mark("L tree")

    proofs = []
    for ci in range(claims):
        positions = pseudorandom_indices(l_tree.roots[ci], n,
                                         cfg["spot_checks"],
                                         exclude_multiples_of=ext)
        augmented = [q for x in positions for q in (x, (x + ext) % n)]
        proofs.append([m_tree.roots[ci], l_tree.roots[ci],
                       m_tree.branches(ci, augmented),
                       l_tree.branches(ci, positions)])
    del m_tree, p, d, b
    mark("spot-check branches")

    fri = prove_low_degree(l_vals, l_tree, su.g2, 2 * steps, cfg,
                           exclude_multiples_of=ext)
    mark("FRI")
    for proof, f in zip(proofs, fri):
        proof.append(f)
    return proofs


def prove_low_degree(values, tree, root: int, maxdeg_plus_1: int,
                     cfg: dict, exclude_multiples_of: int = 0) -> list:
    """FRI (ethereum/research mimc_stark/fri.py) on values [16, claims,
    n] over the powers of `root`, `tree` their tree: per claim, the
    rounds [column root, branches] then the base values."""
    claims = values.shape[1]
    rounds = [[] for _ in range(claims)]
    dev = values.device
    while maxdeg_plus_1 > cfg["fri_base_cutoff"]:
        n = values.shape[-1]
        q = n // 4
        # The cubic through each row's four points x eta^j (eta = root^q),
        # at the special point s: with r = s / x and the size-4 inverse
        # DFT g of the row, column = (g0 + g1 r + g2 r^2 + g3 r^3) / 4.
        sx = [int.from_bytes(r, "big") % P for r in tree.roots]
        inv_root = pow(root, P - 2, P)
        r = F.mul(_per_claim(sx, dev), F.powers(inv_root, q, dev).unsqueeze(1))
        y = [values[..., j * q:(j + 1) * q] for j in range(4)]
        e = F.const(pow(inv_root, q, P), dev, 2)          # eta^-1
        s02, d02 = F.add(y[0], y[2]), F.sub(y[0], y[2])
        s13, d13 = F.add(y[1], y[3]), F.sub(y[1], y[3])
        ed13 = F.mul(e, d13)
        g = [F.add(s02, s13), F.add(d02, ed13), F.sub(s02, s13),
             F.sub(d02, ed13)]
        acc = g[3]
        for j in (2, 1, 0):
            acc = F.add(F.mul(acc, r), g[j])
        column = F.mul(acc, F.const(pow(4, P - 2, P), dev, 2))
        del r, y, g, acc, s02, d02, s13, d13, ed13
        col_tree = Tree([column])
        for ci in range(claims):
            ys = pseudorandom_indices(col_tree.roots[ci], q,
                                      cfg["fri_queries"],
                                      exclude_multiples_of)
            cols = col_tree.branches(ci, ys)
            rows = [tree.branches(ci, [y + q * j for y in ys])
                    for j in range(4)]
            rounds[ci].append([col_tree.roots[ci],
                               [[cb] + [rows[j][i] for j in range(4)]
                                for i, cb in enumerate(cols)]])
        values, tree = column, col_tree
        root = pow(root, 4, P)
        maxdeg_plus_1 //= 4
    for ci in range(claims):
        rounds[ci].append(F.to_be_bytes(values[:, ci]))
    return rounds
