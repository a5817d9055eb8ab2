"""Number-theoretic transforms over [16, *claims, n] (refstark.field).

Natural order in and out, as `fft` of the MiMC STARK's reference
(ethereum/research mimc_stark/fft.py): out[i] = sum_j x[j] root^(i j);
the inverse uses root^-1 and scales by 1/n. Each stage is one radix-2
Gentleman-Sande step over the whole array; the output's bit-reversed
order is undone by one gather at the end.
"""

import torch

from . import field as F


def _bit_reverse(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = torch.arange(n, device=device)
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def ntt(x: torch.Tensor, root: int, inverse: bool = False) -> torch.Tensor:
    """The transform of x [16, *claims, n] over the powers of `root`
    (order n, a power of two)."""
    n = x.shape[-1]
    dev = x.device
    if inverse:
        root = pow(root, F.MODULUS - 2, F.MODULUS)
    table = F.powers(root, max(n // 2, 1), dev)          # [16, n/2]
    lead = x.shape[1:-1]
    x = x.clone()
    h = n // 2
    while h >= 1:
        v = x.reshape((F.LIMBS,) + lead + (n // (2 * h), 2, h))
        u, w = v.select(-2, 0), v.select(-2, 1)
        tw = table[:, ::n // (2 * h)][:, :h]
        tw = tw.reshape((F.LIMBS,) + (1,) * (len(lead) + 1) + (h,))
        s, d = F.add(u, w), F.mul(F.sub(u, w), tw)
        x = torch.stack([s, d], dim=-2).reshape(x.shape)
        h //= 2
    x = x.index_select(-1, _bit_reverse(n, dev))
    if inverse:
        x = F.mul(x, F.const(pow(n, F.MODULUS - 2, F.MODULUS), dev,
                             x.dim() - 1))
    return x
