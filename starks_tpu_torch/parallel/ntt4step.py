"""The four-step NTT over a mesh's shards.

Counterpart of `starks_tpu/parallel/ntt4step.py` (`FourStepPlan`,
`get_plan`, `fourstep_ntt_shmap`). An n-point transform with n = n1 *
n2 becomes local transforms and three all-to-all transposes, with
natural order and contiguous row shards in and out (s shards):

    [n/s] viewed [n1/s, n2]
    all_to_all #1 -> [n1, n2/s]; transposed [n2/s, n1]: size-n1
                     transforms of the n2/s local columns
    twiddle w^(i2 * k1), this shard's rows of the grid (A7 `mul`)
    all_to_all #2 -> [n2, n1/s]; transposed [n1/s, n2]: size-n2
                     transforms of the n1/s local rows
    all_to_all #3 -> [n1, n2/s]; transposed [n2/s, n1] = the shard's
                     contiguous rows of X[k1 + n1 * k2]

Each local batch of transforms is one call of the DIF transform kernel
over a claim axis (A1, `plimbs.dif_transform` on [B, n1 or n2, 8], B
the local rows) and a gather from its bit-reversed order. An inverse
transform uses the inverse roots and puts 1/n1 and 1/n2 into the two
DIF transforms' last stages (`scale=`), as the JAX form scales each
inner transform. Every table (the inner power tables, the twiddle grid
rows of this shard) is built once per plan by the native runtime.
"""

import torch

from ..ops import plimbs
from ..ops.fused import MODULUS, power_table
from ..utils import native
from ..utils.conversions import NUM_WORDS, int_to_tensor


def bit_reverse(n: int, device=None) -> torch.Tensor:
    """Indices i -> rev_{log n}(i), as an int64 tensor."""
    bits = n.bit_length() - 1
    i = torch.arange(n, dtype=torch.int64)
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r.to(device)


class FourStepPlan:
    """The split n = n1 * n2 and the tables of one (n, g, mesh) triple:
    n1 = 2^floor(log n / 2), at least the shard count s, and both n1 and
    n2 divisible by s (`starks_tpu/parallel/ntt4step.py:61`)."""

    def __init__(self, n: int, g: int, mesh):
        s = mesh.n_shard
        n1 = max(1 << ((n.bit_length() - 1) // 2), s)
        n2 = n // n1
        if n & (n - 1) or n1 * n2 != n or n1 < 2 or n2 < 2 or n1 % s \
                or n2 % s:
            raise ValueError(f"no four-step split of {n} points as "
                             f"{n1} x {n2} over {s} shards")
        self.n, self.g, self.mesh = n, g, mesh
        self.n1, self.n2 = n1, n2
        self._tables = {}

    def tables(self, inverse: bool):
        """(size-n1 power table, size-n2 power table, bit reversals of
        n1 and n2, the two scales (None forward; 1/n1, 1/n2 inverse),
        twiddle grid [n2/s, n1, 8] of w^(+-i2 * k1) for this shard's
        columns i2), built on first use."""
        if inverse not in self._tables:
            m, dev = MODULUS, self.mesh.device
            n1, n2, s = self.n1, self.n2, self.mesh.n_shard
            w = pow(self.g, m - 2, m) if inverse else self.g
            cols = n2 // s
            self._tables[inverse] = (
                power_table(pow(w, n2, m), n1, dev),
                power_table(pow(w, n1, m), n2, dev),
                bit_reverse(n1, dev), bit_reverse(n2, dev),
                int_to_tensor(pow(n1, m - 2, m), dev) if inverse else None,
                int_to_tensor(pow(n2, m - 2, m), dev) if inverse else None,
                torch.from_numpy(native.power_grid(
                    w, self.mesh.shard_index * cols, cols, n1)).to(dev))
        return self._tables[inverse]


def get_plan(n: int, g: int, mesh) -> FourStepPlan:
    """The plan of (n, g) on `mesh`, cached on the mesh."""
    key = ("four-step", n, g)
    if key not in mesh.cache:
        mesh.cache[key] = FourStepPlan(n, g, mesh)
    return mesh.cache[key]


def _transpose_for(a, s: int):
    """[rows, cols, 8] -> [s, rows, cols / s, 8], contiguous: the column
    blocks in shard order, as all_to_all_single sends them."""
    rows, cols = a.shape[0], a.shape[1]
    return a.reshape(rows, s, cols // s, NUM_WORDS).transpose(0, 1) \
        .contiguous()


def _local_ntt(a, table, brev, scale):
    """Transforms along axis 1 of [B, m, 8] in natural order: one DIF
    transform over the claim axis, then its bit-reversed outputs
    gathered back."""
    return plimbs.dif_transform(a, table, scale=scale)[:, brev]


def fourstep_ntt(values, plan: FourStepPlan, inverse: bool = False):
    """The NTT (inverse NTT with `inverse`) of the n-point array whose
    contiguous rows [r n/s, (r+1) n/s) this shard holds as `values`
    [n/s, 8]; returns this shard's rows of the result. Exactly three
    `all_to_all_single` calls."""
    mesh, n1, n2 = plan.mesh, plan.n1, plan.n2
    s = mesh.n_shard
    if values.shape != (plan.n // s, NUM_WORDS):
        raise ValueError(f"expected this shard's [{plan.n // s}, 8] rows, "
                         f"got {tuple(values.shape)}")
    tab1, tab2, brev1, brev2, sc1, sc2, tw = plan.tables(inverse)
    # [n1/s, n2] -> all_to_all #1 -> [n1, n2/s] -> [n2/s, n1].
    a = mesh.all_to_all_single(_transpose_for(
        values.reshape(n1 // s, n2, NUM_WORDS), s).reshape(-1, NUM_WORDS))
    a = a.reshape(n1, n2 // s, NUM_WORDS).transpose(0, 1).contiguous()
    a = _local_ntt(a, tab1, brev1, sc1)                 # [n2/s, k1]
    a = plimbs.mul(a.reshape(-1, NUM_WORDS), tw.reshape(-1, NUM_WORDS))
    # [n2/s, n1] -> all_to_all #2 -> [n2, n1/s] -> [n1/s, n2].
    a = mesh.all_to_all_single(_transpose_for(
        a.reshape(n2 // s, n1, NUM_WORDS), s).reshape(-1, NUM_WORDS))
    a = a.reshape(n2, n1 // s, NUM_WORDS).transpose(0, 1).contiguous()
    a = _local_ntt(a, tab2, brev2, sc2)                 # [k1/s, k2]
    # [n1/s, n2] -> all_to_all #3 -> [n1, n2/s] -> [n2/s, n1].
    a = mesh.all_to_all_single(_transpose_for(a, s).reshape(-1, NUM_WORDS))
    return a.reshape(n1, n2 // s, NUM_WORDS).transpose(0, 1).reshape(
        -1, NUM_WORDS).contiguous()


def zero_pad(values, n: int, mesh):
    """This shard's rows of the n-point array that is the m-point array
    held as `values` (contiguous rows [m/s, 8] per shard) followed by
    zeros. With m <= n/s every nonzero row lies in shard 0, so ONE
    all_to_all_single brings them there and no shard holds more than
    its own n/s rows."""
    s, rows = mesh.n_shard, values.shape[0]
    if rows * s > n // s:
        raise ValueError(f"{rows * s} rows do not fit shard 0's {n // s}")
    first = mesh.shard_index == 0
    got = mesh.all_to_all_single(
        values, [rows] + [0] * (s - 1), [rows if first else 0] * s)
    out = torch.zeros((n // s, NUM_WORDS), dtype=values.dtype,
                      device=values.device)
    if first:
        out[:rows * s] = got
    return out
