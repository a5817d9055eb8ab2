"""Prover building blocks over the field kernels: twiddle plans, NTT,
LDE and FRI.

Counterpart of the Pallas path of `starks_tpu/ops/fused.py`
(`FusedPlan`, `ntt_dif_pl`, `ntt_dit_pl`, `lde_pl`,
`fri_round_schedule`, `fri_commit_unrolled_pl`). Arrays are [n, 8]
int32 field tensors. The NTT kernels (ops/plimbs.py) read their stage
twiddles from the plain power table, so no [log n, n/2] stacked table
exists at any size.

- `ntt_dif` is the constant-geometry (Pease) decimation-in-frequency
  network: natural order in, bit-reversed out, run as a few launches of
  the DIF pass kernel, each several stages in shared memory. `ntt_dit`
  is its transpose (bit-reversed in, natural out), a few launches of the
  DIT pass kernel.
- `lde`: iNTT (DIF, whose last stage scales by 1/n) -> forward NTT
  (DIT) of the stride-8 zero interleave (for c < n, rev_{log 8n}(c) =
  8 * rev_{log n}(c), so zero-padding in the coefficient domain is a
  strided spread), which the first DIT pass reads from the compact
  coefficients.
- `fri_commit`: per round, fold by 4 at the Fiat-Shamir point (round r
  reads round 0's u-table at stride 4^r), then the column tree, the
  query indices and the column and row bundles.

`lde` and `fri_commit` take a leading claim axis (a [B, steps, 8] trace
gives B LDEs, and B FRI proofs in one launch of each kernel per round),
as the JAX batch prover's vmap does; the tables stay shared.

Bit-identical to the JAX package (tests/test_torch_kernels.py).
"""

import torch

from . import merkle
from . import plimbs
from . import transcript_dev as td
from . import blake2s as b2
from ..utils import native
from ..utils.conversions import int_to_tensor

MODULUS = 2**256 - 351 * 2**32 + 1


def powers(g: int, n: int) -> list:
    """[g^0, ..., g^(n-1)] as ints."""
    vals = [1] * n
    for i in range(1, n):
        vals[i] = vals[i - 1] * g % MODULUS
    return vals


def power_table(g: int, n: int, device=None) -> torch.Tensor:
    """[n, 8] table g^0 .. g^(n-1), built by the native host runtime."""
    return torch.from_numpy(native.power_table(g, n)).to(device)


def _inverse_order(table: torch.Tensor) -> torch.Tensor:
    """[g^0, g^-1, ..., g^-(n-1)] from [g^0, g^1, ..., g^(n-1)]."""
    return torch.cat([table[:1], table[1:].flip(0)])


class FusedPlan:
    """Device tables for one (steps, generator) configuration: the
    plain power tables and the FRI u-table."""

    def __init__(self, steps: int, precision: int, G1: int, G2: int,
                 device):
        self.steps = steps
        self.precision = precision
        fwd_big = power_table(G2, precision)
        # iNTT over the trace domain (DIF, inverse twiddles); forward
        # NTT over the evaluation domain (DIT, its own power table).
        self.inv_small = _inverse_order(power_table(G1, steps)).to(device)
        self.xs_big = fwd_big.to(device)
        self.n_inv_small = int_to_tensor(
            pow(steps, MODULUS - 2, MODULUS), device)
        # FRI u-table: G2^-i, i < N/4. Round r's g_r^-i, g_r = G2^(4^r),
        # is entry i * 4^r (fold4's shift 2r), so one table serves all.
        self.fri_inv_pows = _inverse_order(fwd_big)[:precision // 4].to(
            device)                                      # [N/4, 8]


def ntt_dif(x, table, scale=None):
    """Constant-geometry DIF over [n, 8]: natural order in, bit-reversed
    out. `table` is the plain power table of the transform's root. With
    `scale` ([8]) every output is multiplied by it, in the last stage."""
    return plimbs.dif_transform(x, table, scale=scale)


def ntt_dit(x, table, ext: int = 1):
    """Transpose network: bit-reversed in, natural out (the DIF stages'
    transposes in reverse twiddle order). With ext > 1, x holds only the
    inputs at multiples of ext, the others being zero (`dit_transform`)."""
    return plimbs.dit_transform(x, table, ext=ext)


def lde(trace, inv_small, n_inv_small, fwd_big):
    """Low-degree extension of trace [..., steps, 8] onto the
    precision-point domain of `fwd_big` (its plain power table). The
    coefficients are the stride-ext nonzero inputs of the forward NTT,
    which reads them compact (`ntt_dit`'s ext), so no zero-padded array
    is built; the 1/n is applied in the inverse NTT's last stage."""
    steps = trace.shape[-2]
    coeffs = ntt_dif(trace, inv_small, scale=n_inv_small)
    return ntt_dit(coeffs, fwd_big, ext=fwd_big.shape[0] // steps)


def fri_round_schedule(precision: int, maxdeg_plus_1: int, cutoff: int):
    """Per-round sizes: [(n_r, q_r), ...] while maxdeg+1 > cutoff."""
    out = []
    n = precision
    while maxdeg_plus_1 > cutoff:
        out.append((n, n // 4))
        n //= 4
        maxdeg_plus_1 //= 4
    return out


def fri_commit(values, leaf, lvl1, levels, root, fri_inv_pows, schedule,
               eta, queries: int, exclude: int):
    """FRI commit and query phases, one round after another at true
    shapes. Round 0's row tree is the L tree (leaf, lvl1, levels, root);
    `fri_inv_pows` is round 0's u-table. Returns (col_roots [R][..., 8],
    col_bundles [R][..., q, w_c], row_bundles [R][..., 4q, w_r], final
    values [..., n_final, 8]); the leading axes are the claims'."""
    col_roots, col_bundles, row_bundles = [], [], []
    for r, (_, q_r) in enumerate(schedule):
        sx = td.special_x_limbs(root)
        column = plimbs.fold4(values, fri_inv_pows, sx, eta, 2 * r)
        col_leaf = b2.limbs_to_words(column)
        c_lvl1, c_levels, c_root = merkle.tree_build(col_leaf)
        ys = td.pseudorandom_indices_dev(c_root, q_r, queries,
                                         exclude_multiples_of=exclude)
        col_bundles.append(merkle.tree_bundle(col_leaf, c_lvl1, c_levels,
                                              ys))
        row_idx = (ys[..., None] + q_r * torch.arange(
            4, device=ys.device)).reshape(*ys.shape[:-1], -1)
        row_bundles.append(merkle.tree_bundle(leaf, lvl1, levels, row_idx))
        col_roots.append(c_root)
        values, leaf, lvl1, levels, root = (column, col_leaf, c_lvl1,
                                            c_levels, c_root)
    return col_roots, col_bundles, row_bundles, values
