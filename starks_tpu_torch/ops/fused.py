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
  query indices and the column and row bundles. Over a mesh's row
  shards, one all_to_all_single before each round gives every shard
  the four quarter slices its columns read (fold4's column i reads rows
  i + j q, j < 4), so the fold kernel runs on [4 q/s, 8] unchanged,
  with this shard's slice of the u-table; a column too short to shard
  (q/s below a leaf pair) is gathered, and the rounds go on replicated.

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
                 device, mark=None):
        """`mark(stage)`, when given, is called once the host tables are
        built ("host power tables") and once they are on the device
        ("upload")."""
        self.steps = steps
        self.precision = precision
        fwd_big = power_table(G2, precision)
        # iNTT over the trace domain (DIF, inverse twiddles); forward
        # NTT over the evaluation domain (DIT, its own power table).
        inv_small = _inverse_order(power_table(G1, steps))
        # FRI u-table: G2^-i, i < N/4. Round r's g_r^-i, g_r = G2^(4^r),
        # is entry i * 4^r (fold4's shift 2r), so one table serves all.
        fri_inv_pows = _inverse_order(fwd_big)[:precision // 4]  # [N/4, 8]
        if mark:
            mark("host power tables")
        self.inv_small = inv_small.to(device)
        self.xs_big = fwd_big.to(device)
        self.fri_inv_pows = fri_inv_pows.to(device)
        self.n_inv_small = int_to_tensor(
            pow(steps, MODULUS - 2, MODULUS), device)
        if mark:
            mark("upload")


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


def _quarter_exchange(values, n: int, mesh):
    """This shard's rows j * q + [r w, (r + 1) w), j < 4 (q = n/4, w =
    q/s: the rows its fold4 columns read), in j order, from this
    shard's rows [n/s, 8] of every shard's: ONE all_to_all_single. Each
    slice lies in one shard (w divides the shard's 4w rows), shard
    floor((j s + d) / 4) for the slice j of shard d."""
    s, r = mesh.n_shard, mesh.shard_index
    q = n // 4
    w, rows = q // s, n // s

    def owner(j, d):
        return (j * q + d * w) // rows

    send, in_splits = [], []
    for d in range(s):
        mine = [j for j in range(4) if owner(j, d) == r]
        send += [values[j * q + d * w - r * rows:][:w] for j in mine]
        in_splits.append(w * len(mine))
    out_splits = [w * sum(owner(j, r) == src for j in range(4))
                  for src in range(s)]
    return mesh.all_to_all_single(torch.cat(send), in_splits, out_splits)


def fri_commit(values, tree, u_table, schedule, eta, queries: int,
               exclude: int, mesh=None, inv_root: int = None):
    """FRI commit and query phases, one round after another at true
    shapes, over `values` and their merkle.Tree `tree` (round 0's
    row tree: the prover's L tree); `u_table` is round 0's u-table.
    Returns (col_roots [R][..., 8], col_bundles [R][..., q, w_c],
    row_bundles [R][..., 4q, w_r], final values [..., n_final, 8]); the
    leading axes are the claims'.

    With `mesh`, `values` [n/s, 8] are this shard's rows (no claim axis),
    `u_table` this shard's rows [r q/s, (r+1) q/s) of round 0's u-table
    (round r's columns on this shard read them at stride 4^r), and
    `inv_root` the inverse of round 0's root of unity (for the rounds
    that go replicated); the results are the same on every shard."""
    s = 1 if mesh is None else mesh.n_shard
    col_roots, col_bundles, row_bundles = [], [], []
    sharded = True
    for r, (n_r, q_r) in enumerate(schedule):
        sx = td.special_x_limbs(tree.root)
        if sharded and q_r // s >= 2:
            local = (values if mesh is None
                     else _quarter_exchange(values, n_r, mesh))
            column = plimbs.fold4(local, u_table, sx, eta, 2 * r)
            ctree = merkle.Tree(b2.limbs_to_words(column), mesh)
        else:
            if sharded:
                values = mesh.all_gather(values).reshape(n_r, -1)
                sharded = False
            u_r = power_table(pow(inv_root, 4 ** r, MODULUS), q_r,
                              values.device)
            column = plimbs.fold4(values, u_r, sx, eta)
            ctree = merkle.Tree(b2.limbs_to_words(column))
        ys = td.pseudorandom_indices_dev(ctree.root, q_r, queries,
                                         exclude_multiples_of=exclude)
        col_bundles.append(ctree.bundle(ys))
        row_idx = (ys[..., None] + q_r * torch.arange(
            4, device=ys.device)).reshape(*ys.shape[:-1], -1)
        row_bundles.append(tree.bundle(row_idx))
        col_roots.append(ctree.root)
        values, tree = column, ctree
    if sharded and mesh is not None:
        values = mesh.all_gather(values).reshape(-1, values.shape[-1])
    return col_roots, col_bundles, row_bundles, values
