"""The field kernels of the MiMC and AIR proofs, each beside its plain
version.

Counterpart of the Pallas kernels of `starks_tpu/ops/plimbs.py`. Each
wrapper takes [n, 8] int32 field tensors (ops/limbs.py). Given CUDA
tensors it launches its hand-written kernel (csrc/kernels.cu, built by
ops/_build.py) on the current stream, or raises; given CPU tensors it
runs its plain PyTorch version, which repeats the kernel's arithmetic
and is what the CPU tests hold against the JAX package. `LAUNCHES`
counts each wrapper's kernel launches (`dif_transform` and
`dit_transform` make one per pass).

Every kernel also takes a claim axis, as the JAX batch provers' vmap
of them does: arrays [B, n, 8], and per-claim operands with the same
leading B, in one launch for all B claims (MAX_CLAIMS at most). Shared
tables keep their unbatched shape. The AIR's elementwise ops (`mul`,
`add`, `sub`, `scale`, `cube`) take either form for each operand: an
[L, 8] operand is shared by the claims, a [B, L, 8] one is per claim.
The plain versions take the same leading axis by broadcasting.
`mimc_trace` runs the MiMC recurrence over a claim batch, and
`batch_inv` inverts an [n, 8] array (the set-ups' 1/Z tables).

Bounds on the card (32-byte elements, n elements per array): bytes over
3.35 TB/s against 32-bit integer multiply-adds over the card's peak
rate, 148 per modmul (chip_smoke.py). Scale, the L map and the
elementwise ops (mul, add, sub, cube) are bound by their bytes; the D/B
map, fold4 and the whole DIF and DIT transforms (log n stages of
butterflies over a few passes of bytes) by their operations. PERF.md
gives each kernel's time beside its bound.
"""

import torch

from . import _build
from . import limbs as fl

NUM_WORDS = fl.NUM_WORDS
L16 = fl.to_limbs16

LAUNCHES = dict.fromkeys(
    ["dif_pass", "dit_pass", "scale", "db_map", "l_map", "fold4", "mul",
     "add", "sub", "cube", "mimc_trace", "batch_inv"], 0)

# Stages per DIF or DIT pass: at most DIF_PASS_MAX_STAGES (a tile of 2^k
# elements in shared memory), spread evenly over the fewest passes.
DIF_PASS_MAX_STAGES = 10
# Claims per launch: the kernels put the claim in the grid's y dimension.
MAX_CLAIMS = 65535


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*operands) -> bool:
    """True for CUDA operands the kernels take, False for CPU operands;
    raises for anything else. None operands (optional ones left out)
    are skipped."""
    tensors = [t for t in operands if t is not None]
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if t.dtype != torch.int32 or t.shape[-1] != NUM_WORDS:
            raise ValueError(f"expected [..., 8] int32 field elements, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
    return True


def _launch(name, device, *args, entry=None, launches=1):
    """Call the C entry point `entry` (default starks_<name>) on the
    current stream and count its `launches` kernel launches under
    `name`; tensors pass as pointers, None as a null pointer, ints as
    uint32."""
    entry = entry or "starks_" + name
    fn = getattr(_build.load(), entry)
    for a in args:
        if isinstance(a, int) and not 0 <= a < 2**31:
            raise ValueError(f"kernel {name}: size argument {a} out of "
                             f"range")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    rc = fn(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name}: CUDA error {rc}")
    LAUNCHES[name] += launches


def _check_size(n: int):
    if n < 2 or n & (n - 1) or n >= 2**31:
        raise ValueError(f"size {n} is not a power of two in [2, 2^31)")


def _claims(x) -> int:
    """Claims in a field array: B for [B, n, 8], 1 for [n, 8]."""
    if x.dim() == 2:
        return 1
    if x.dim() != 3 or not 1 <= x.shape[0] <= MAX_CLAIMS:
        raise ValueError(f"expected [n, 8] or [B, n, 8] with B <= "
                         f"{MAX_CLAIMS}, got {tuple(x.shape)}")
    return x.shape[0]


def _check_per_claim(x, what: str, *operands, rows: bool = False):
    """Per-claim operands of the array x: [8] each (or [L, 8] with
    `rows`) when x is [n, 8]; with a leading B when x is [B, n, 8]."""
    lead = tuple(x.shape[:-2])
    for t in operands:
        want = t.dim() == len(lead) + (2 if rows else 1)
        if not want or tuple(t.shape[:len(lead)]) != lead or (
                rows and t.shape[-2] == 0):
            raise ValueError(f"{what} must be {'[L, 8]' if rows else '[8]'}"
                             f" per claim, with the leading axes "
                             f"{lead} of the array")


def _batch_of(*operands) -> int:
    """The claims B that elementwise operands agree on, each [L, 8]
    (shared) or [B, L, 8] (per claim); 0 when all are shared."""
    claims = {_claims(t) for t in operands if t is not None and t.dim() == 3}
    if len(claims) > 1:
        raise ValueError(f"per-claim operands disagree on the claims: "
                         f"{sorted(claims)}")
    return claims.pop() if claims else 0


def _stride(t) -> int:
    """Elements between the claims' blocks of an elementwise operand:
    0 for a shared [L, 8], L for a per-claim [B, L, 8]."""
    return t.shape[-2] if t.dim() == 3 else 0


def _check_tables(*tables):
    if any(t.dim() != 2 or t.shape[0] == 0 for t in tables):
        raise ValueError("periodic tables must be non-empty [L, 8]")


def _stage_twiddles(table, t: int, half: int):
    """Stage-t Pease twiddles TW[j] = table[(j >> t) << t], j < half."""
    j = torch.arange(half, device=table.device)
    return table[(j >> t) << t]


# -- A1: DIF stage ------------------------------------------------------

def dif_stage_plain(x, table, t: int):
    n = x.shape[-2]
    half = n // 2
    a, b = L16(x[..., :half, :]), L16(x[..., half:, :])
    u = fl.add16(a, b)
    v = fl.mul16(fl.sub16(a, b), L16(_stage_twiddles(table, t, half)))
    return fl.from_limbs16(torch.stack([u, v], dim=-2).reshape(
        *x.shape[:-2], n, -1))


def dif_last_stage_plain(x, scale=None):
    """The transform's last stage as the kernel runs it
    (`dif_last_butterfly`): u = a + b, v = a - b with no twiddle product
    (table[0] of a power table is 1), times `scale` when given."""
    half = x.shape[-2] // 2
    a, b = x[..., :half, :], x[..., half:, :]
    y = torch.stack([fl.add(a, b), fl.sub(a, b)], dim=-2).reshape(x.shape)
    return y if scale is None else scale_plain(y, scale)


# -- A1, redesigned: the DIF transform in passes of several stages ------

def dif_pass_stages(n: int) -> int:
    """Stages per pass for an n-point transform: the fewest passes of
    at most DIF_PASS_MAX_STAGES, as even as they go."""
    logn = n.bit_length() - 1
    passes = -(-logn // DIF_PASS_MAX_STAGES)
    return -(-logn // passes)


def dif_transform_plain(x, table, scale=None):
    """`dif_stage_plain` for t = 0 .. log n - 2, then the last stage with
    no twiddle product (`dif_last_stage_plain`), as the kernel runs it.
    So the network is the transform of a power table (table[0] = 1), as
    every caller passes; for another table it drops table[0] exactly as
    the card does."""
    for t in range(x.shape[-2].bit_length() - 2):
        x = dif_stage_plain(x, table, t)
    return dif_last_stage_plain(x, scale)


def dif_transform(x, table, k: int | None = None, scale=None):
    """The whole Pease DIF network over x [n, 8] or [B, n, 8] (natural
    order in, bit-reversed out), the same as `dif_stage_plain` for
    t = 0 .. log n - 1, in ceil(log n / k) launches of `dif_pass_kernel`
    for all B claims, each running up to k consecutive stages on tiles
    of 2^k elements in shared memory (k defaults to
    `dif_pass_stages(n)`). `table` is the power table of the
    transform's root, so table[0] = 1 and the last stage has no twiddle
    product. With `scale` (an [8] element, shared by the claims) every
    output is multiplied by it, in the last stage: the LDE's 1/n costs
    no launch.

    Replaces the chain of `_dif_kernel` launches of `ntt_dif_pl`
    (starks_tpu/ops/plimbs.py:154 via `dif_stage_x`, :355), one per
    stage, and with `scale` the `_scale_kernel` launch after it (:175,
    via `scale_t`, :400). Bound: operations, log n stages of n/2
    butterflies (a modmul and two adds each), plus n/2 modmuls with
    `scale`; bytes 64n + 32 * n/2 per pass."""
    n, batch = x.shape[-2], _claims(x)
    _check_size(n)
    if table.shape[0] < n // 2:
        raise ValueError("twiddle table shorter than n/2")
    if scale is not None and scale.shape != (NUM_WORDS,):
        raise ValueError("scale must be one [8] element")
    logn = n.bit_length() - 1
    k = dif_pass_stages(n) if k is None else k
    if not 1 <= k <= DIF_PASS_MAX_STAGES:
        raise ValueError(f"stages per pass {k} not in [1, "
                         f"{DIF_PASS_MAX_STAGES}]")
    k = min(k, logn)
    if not _on_card(x, table, scale):
        return dif_transform_plain(x, table, scale)
    passes = -(-logn // k)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if passes > 1 else out
    _launch("dif_pass", x.device, x, table, scale, out, scratch, n, k,
            batch, entry="starks_ntt_dif", launches=passes)
    return out


# -- A3: DIT stage ------------------------------------------------------

def dit_stage_plain(x, table, t: int):
    n = x.shape[-2]
    half = n // 2
    pairs = L16(x).reshape(*x.shape[:-2], half, 2, -1)
    a = pairs[..., 0, :]
    wb = fl.mul16(L16(_stage_twiddles(table, t, half)), pairs[..., 1, :])
    return fl.from_limbs16(torch.cat([fl.add16(a, wb), fl.sub16(a, wb)],
                                     dim=-2))


# -- A3, redesigned: the DIT transform in passes of several stages ------

def dit_transform_plain(x, table, ext: int = 1):
    """The stage chain, t = log n - 1 down to 0, over the n = ext * len(x)
    inputs that are x at multiples of ext and zero elsewhere. Its first
    log2(ext) stages only copy (b is zero), so it starts from x tiled
    ext times."""
    y = torch.cat([x] * ext, dim=-2) if ext > 1 else x
    for t in range(y.shape[-2].bit_length() - 2 - (ext.bit_length() - 1),
                   -1, -1):
        y = dit_stage_plain(y, table, t)
    return y


def dit_transform(x, table, k: int | None = None, ext: int = 1):
    """The whole DIT network (bit-reversed in, natural out) over x [n, 8]
    or [B, n, 8], the same as `dit_stage_plain` for t = log n - 1 down
    to 0, in ceil(log n / k) launches of `dit_pass_kernel` for all B
    claims, each up to k stages on tiles of 2^k elements in shared
    memory (k defaults to `dif_pass_stages(n)`; the shorter pass comes
    first). With ext > 1, x [..., n / ext, 8] holds the nonzero inputs,
    at multiples of ext (the LDE's zero-interleaved coefficients): the
    first pass reads them and skips the log2(ext) stages that only
    copy, so no zero-padded array is built.

    Replaces the chain of `_dit_kernel` launches (starks_tpu/ops/
    plimbs.py:161, via `dit_stage_t`, :381) that `ntt_dit_pl`
    (starks_tpu/ops/fused.py:286) makes, one per stage. Bound:
    operations, log n - log2(ext) stages of n/2 butterflies (a modmul,
    an add and a sub each); bytes 64n + 32 * n/2 per pass."""
    n, batch = x.shape[-2] * ext, _claims(x)
    _check_size(n)
    if ext & (ext - 1) or ext > n // 2:
        raise ValueError(f"ext {ext} is not a power of two below n")
    if table.shape[0] < n // 2:
        raise ValueError("twiddle table shorter than n/2")
    logn, log_ext = n.bit_length() - 1, ext.bit_length() - 1
    k = dif_pass_stages(n) if k is None else k
    if not 1 <= k <= DIF_PASS_MAX_STAGES:
        raise ValueError(f"stages per pass {k} not in [1, "
                         f"{DIF_PASS_MAX_STAGES}]")
    k = min(k, logn)
    passes = -(-logn // k)
    first = logn - (passes - 1) * k
    if first < log_ext:
        raise ValueError(f"a first pass of {first} stages cannot read "
                         f"inputs spread {ext} apart")
    if not _on_card(x, table):
        return dit_transform_plain(x, table, ext)
    out = torch.empty((*x.shape[:-2], n, NUM_WORDS), dtype=torch.int32,
                      device=x.device)
    scratch = torch.empty_like(out) if passes > 1 else out
    _launch("dit_pass", x.device, x, table, out, scratch, n, k, log_ext,
            batch, entry="starks_ntt_dit", launches=passes)
    return out


# -- A2: scale ----------------------------------------------------------

def scale_plain(x, s, acc=None):
    y = fl.mul(x, s[..., None, :])
    return y if acc is None else add_plain(acc, y)


def scale(x, s, acc=None):
    """x * s for a scalar element s [8], or acc + x * s with an
    accumulator acc (an AIR's running sum of scaled terms, so no add
    launch follows). Over a claim axis, x is [L, 8] (shared) or
    [B, L, 8], s is [8] (shared) or [B, 8] (claim c's scalar), and acc
    and the result are [B, L, 8]: an AIR's boundary interpolant sums
    shared basis tables times each claim's boundary values, its L sum
    each claim's D columns times its own weights.

    Replaces `_scale_kernel` (starks_tpu/ops/plimbs.py:175, launched by
    `scale_t`, :400), and with acc the `_add_kernel` launch (`add_t`,
    :301) that adds its result into the sum. Runs `stream_map_kernel`
    (csrc/kernels.cu), as cube does. Bound: bytes, 64n, or 96n with
    acc (n output elements; a shared x is read once)."""
    if x.dim() not in (2, 3) or x.shape[-2] == 0:
        raise ValueError("x must be [L, 8] or [B, L, 8]")
    if s.shape[-1:] != (NUM_WORDS,) or s.dim() not in (1, 2):
        raise ValueError("s must be one [8] element, or [B, 8]")
    batch = _batch_of(x, s.unsqueeze(-2) if s.dim() == 2 else None, acc)
    shape = (batch, *x.shape[-2:]) if batch else x.shape
    if acc is not None and acc.shape != shape:
        raise ValueError(f"acc must be {tuple(shape)}")
    if not _on_card(x, s, acc):
        return scale_plain(x, s, acc)
    n = x.shape[-2]
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    _launch("scale", x.device, x, _stride(x), s,
            1 if s.dim() == 2 else 0, acc, out, n, max(batch, 1))
    return out


# -- A4: constraint / quotient / boundary map ---------------------------

def db_map_plain(p, xs, k_tab, zni_tab, iz2, last, slope, ia, shift: int,
                 halo=None):
    n = p.shape[-2]
    i = torch.arange(n, device=p.device)
    pl = L16(p)
    x = L16(xs)
    ahead = (torch.roll(p, -shift, -2) if halo is None else
             torch.cat([p[..., shift:, :], halo], dim=-2))
    c = fl.sub16(fl.sub16(L16(ahead), fl.cube16(pl)),
                 L16(k_tab)[i % k_tab.shape[0]])
    d = fl.mul16(fl.mul16(c, fl.sub16(x, L16(last))),
                 L16(zni_tab)[i % zni_tab.shape[0]])
    i_ev = fl.add16(L16(ia)[..., None, :],
                    fl.mul16(L16(slope)[..., None, :], x))
    b = fl.mul16(fl.sub16(pl, i_ev), L16(iz2))
    return fl.from_limbs16(d), fl.from_limbs16(b)


def db_map(p, xs, k_tab, zni_tab, iz2, last, slope, ia, shift: int,
           halo=None):
    """The fused D/B map over the evaluation domain:
      C = P(g1 x) - P^3 - K;  D = C * (x - last) * Znum^-1;
      B = (P - (ia + slope*x)) * Z2^-1,
    with P(g1 x) = p[(i + shift) % n], K and Znum^-1 periodic tables of
    power-of-two length (the MiMC setup's are ext * len(constants) and
    ext) read modulo it, and last, slope, ia scalars [8]. Returns (D, B).
    With a claim axis, P is [B, n, 8] and slope and ia are [B, 8] (each
    claim's boundary line); xs, the tables, 1/Z2 and last are shared.
    On one shard of a sharded domain, `halo` ([shift, 8], or [B, shift,
    8]) holds the next shard's first `shift` elements, which P(g1 x)
    reads past the end of p: p[i + shift] for i + shift < n, else
    halo[i + shift - n]. P is never copied or rolled.

    Replaces `_db_kernel` (starks_tpu/ops/plimbs.py:181, launched by
    `db_map_t`, :418). The kernel reads P(g1 x) by offset, so the rolled
    copy of P is never built, and the tables with a mask. Bound:
    operations, 6 modmuls per element (bytes 160n: P, x, 1/Z2 in; D, B
    out); P^2 is a dedicated square (`field::sqr`)."""
    n, batch = p.shape[-2], _claims(p)
    _check_size(n)
    for t in (xs, iz2):
        if t.shape != (n, NUM_WORDS):
            raise ValueError("xs and 1/Z2 must be [n, 8], n the length of P")
    if last.shape != (NUM_WORDS,):
        raise ValueError("last must be one [8] element")
    _check_per_claim(p, "slope and ia", slope, ia)
    if not 0 <= shift < n:
        raise ValueError("shift out of range")
    if halo is not None and halo.shape != (*p.shape[:-2], shift,
                                           NUM_WORDS):
        raise ValueError(f"halo must be [{shift}, 8] per claim")
    _check_tables(k_tab, zni_tab)
    for t in (k_tab, zni_tab):
        if t.shape[0] & (t.shape[0] - 1):
            raise ValueError("K and Znum^-1 tables must have power-of-two "
                             "length")
    if not _on_card(p, xs, k_tab, zni_tab, iz2, last, slope, ia, halo):
        return db_map_plain(p, xs, k_tab, zni_tab, iz2, last, slope, ia,
                            shift, halo)
    d, b = torch.empty_like(p), torch.empty_like(p)
    _launch("db_map", p.device, p, halo, xs, k_tab, k_tab.shape[0],
            zni_tab, zni_tab.shape[0], iz2, last, slope, ia, d, b, n, shift,
            batch)
    return d, b


# -- A5: linear combination ---------------------------------------------

def l_map_plain(d, p, b, cp, cb):
    i = torch.arange(d.shape[-2], device=d.device)
    t = fl.add16(fl.mul16(L16(p), L16(cp)[..., i % cp.shape[-2], :]),
                 fl.mul16(L16(b), L16(cb)[..., i % cb.shape[-2], :]))
    return fl.from_limbs16(fl.add16(L16(d), t))


def l_map(d, p, b, cp, cb):
    """L = D + cp(x)*P + cb(x)*B with periodic coefficient tables cp, cb
    ([L, 8]; with a claim axis D, P, B are [B, n, 8] and cp, cb
    [B, L, 8], each claim's Fiat-Shamir weights).

    Replaces `_l_kernel` (starks_tpu/ops/plimbs.py:203, launched by
    `l_map_t`, :451). Bound: bytes, 128n (D, P, B in; L out)."""
    n, batch = d.shape[-2], _claims(d)
    if p.shape != d.shape or b.shape != d.shape:
        raise ValueError("D, P and B must have equal shapes")
    _check_per_claim(d, "cp and cb", cp, cb, rows=True)
    if not _on_card(d, p, b, cp, cb):
        return l_map_plain(d, p, b, cp, cb)
    out = torch.empty_like(d)
    _launch("l_map", d.device, d, p, b, cp, cp.shape[-2], cb, cb.shape[-2],
            out, n, batch)
    return out


# -- A6: FRI fold by 4 --------------------------------------------------

def fold4_plain(values, ip, sx, eta, shift: int = 0):
    q = values.shape[-2] // 4
    y0, y1, y2, y3 = L16(values).reshape(
        *values.shape[:-2], 4, q, -1).unbind(-3)
    e0, d02 = fl.add16(y0, y2), fl.sub16(y0, y2)
    e1, d13 = fl.add16(y1, y3), fl.sub16(y1, y3)
    a0, a2 = fl.add16(e0, e1), fl.sub16(e0, e1)
    h = fl.mul16(d13, L16(eta))
    a1, a3 = fl.sub16(d02, h), fl.add16(d02, h)
    i = torch.arange(q, device=ip.device)
    u = fl.mul16(L16(sx)[..., None, :], L16(ip[i << shift]))
    acc = fl.add16(fl.mul16(u, a3), a2)
    acc = fl.add16(fl.mul16(u, acc), a1)
    acc = fl.add16(fl.mul16(u, acc), a0)
    return fl.from_limbs16(fl.div4_16(acc))


def fold4(values, ip, sx, eta, shift: int = 0):
    """FRI fold by 4: values [n, 8] -> column [n/4, 8]. With q = n/4 and
    y_j = values[j*q + i]: the 4-point DFT of (y0..y3) using eta, Horner
    at u = sx * ip[i << shift], divided by 4. ip holds g^-i of round 0's
    generator; round r reads it at stride 4^r (shift = 2r), where it
    holds that round's g_r^-i. With a claim axis, values are [B, n, 8]
    and sx [B, 8] (each claim's column point); ip and eta are shared.

    Replaces `_fold4_kernel` (starks_tpu/ops/plimbs.py:212, launched by
    `fold4_t`, :483 and :472), which multiplies by 1/4 at the end; here
    that is an exact division (`limbs.div4_16`), the same canonical
    value. The four quarters are read by offset. Bound: operations, 5
    modmuls per output (bytes 48n: values and ip in; the column out)."""
    n, batch = values.shape[-2], _claims(values)
    _check_size(n)
    q = n // 4
    if n < 4 or not 0 <= shift < 31 or ip.shape[0] <= (q - 1) << shift:
        raise ValueError("fold4 needs n >= 4 and ip[(q - 1) << shift]")
    if eta.shape != (NUM_WORDS,):
        raise ValueError("eta must be one [8] element")
    _check_per_claim(values, "sx", sx)
    if not _on_card(values, ip, sx, eta):
        return fold4_plain(values, ip, sx, eta, shift)
    out = torch.empty((*values.shape[:-2], q, NUM_WORDS), dtype=torch.int32,
                      device=values.device)
    _launch("fold4", values.device, values, ip, sx, eta, out, q, shift,
            batch)
    return out


# -- A7/A8: elementwise ops with periodic operands ----------------------

def _periodic16(x, n: int):
    """[..., L, 8] operand read as x[i % L] for i < n, as [..., n, 16]
    limbs."""
    limbs = L16(x)
    if x.shape[-2] == n:
        return limbs
    return limbs[..., torch.arange(n, device=x.device) % x.shape[-2], :]


def _binary_plain(op16, a, b):
    n = max(a.shape[-2], b.shape[-2])
    return fl.from_limbs16(op16(_periodic16(a, n), _periodic16(b, n)))


def mul_plain(a, b):
    return _binary_plain(fl.mul16, a, b)


def add_plain(a, b):
    return _binary_plain(fl.add16, a, b)


def sub_plain(a, b):
    return _binary_plain(fl.sub16, a, b)


def cube_plain(a):
    return fl.cube(a)


def _binary(name: str, plain, a, b):
    for t in (a, b):
        if t.dim() not in (2, 3) or t.shape[-2] == 0:
            raise ValueError("operands must be non-empty [L, 8] or "
                             "[B, L, 8]")
    batch = _batch_of(a, b)
    la, lb = a.shape[-2], b.shape[-2]
    n = max(la, lb)
    if n % la or n % lb:
        raise ValueError(f"operand lengths {la} and {lb} must divide the "
                         f"output length {n}")
    if not _on_card(a, b):
        return plain(a, b)
    shape = (batch, n, NUM_WORDS) if batch else (n, NUM_WORDS)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    _launch(name, a.device, a, la, _stride(a), b, lb, _stride(b), out, n,
            max(batch, 1))
    return out


def mul(a, b):
    """a * b over [n, 8], n = max(La, Lb), for operands a [La, 8] and
    b [Lb, 8] read periodically (a[i % La], b[i % Lb]); each length
    divides n. A full array, an 8-periodic table and a constant ([1, 8])
    all take this one path, so no tiled or broadcast copy is built.
    Over a claim axis, either operand may be [B, L, 8] (claim c reads
    its own block, x[c][i % L]: a column, or a claim's Fiat-Shamir
    table) or [L, 8] (shared by the claims), and the result is
    [B, n, 8].

    Replaces `_mul_kernel` (starks_tpu/ops/plimbs.py:149, launched by
    `mul_t`, :252, and by `mul_tab_t` for a periodic table, :436).
    Bound: bytes, 32 * (La + Lb + n) per claim, a shared operand read
    once: 96n for full operands, ~64n with a table (one modmul per
    element, 148 multiply-adds, is below it)."""
    return _binary("mul", mul_plain, a, b)


def add(a, b):
    """a + b with periodic operands, as in `mul`.

    Replaces `_add_kernel` (starks_tpu/ops/plimbs.py:279, launched by
    `add_t` through `_ew`, :301). Bound: bytes, 32 * (La + Lb + n)."""
    return _binary("add", add_plain, a, b)


def sub(a, b):
    """a - b with periodic operands, as in `mul`. Either operand may be
    the periodic one: a lowered constraint can put its constant first.

    Replaces `_sub_kernel` (starks_tpu/ops/plimbs.py:284, launched by
    `sub_t` through `_ew`, :301). Bound: bytes, 32 * (La + Lb + n)."""
    return _binary("sub", sub_plain, a, b)


def cube(a):
    """a^3 over [n, 8], or over the B claims of [B, n, 8].

    Replaces `_cube_kernel` (starks_tpu/ops/plimbs.py:289, launched by
    `cube_t` through `_ew`, :301). Runs `flat_map_kernel`
    (csrc/kernels.cu), scale's frame over the B claims as one flat
    array. Bound: bytes, 64n, narrowly over its modmul and square per
    element (240 multiply-adds)."""
    if a.dim() not in (2, 3) or a.shape[-2] == 0:
        raise ValueError("a must be non-empty [n, 8] or [B, n, 8]")
    batch = _claims(a)
    if a.numel() // NUM_WORDS >= 2**31:
        raise ValueError("cube maps fewer than 2^31 elements a launch")
    if not _on_card(a):
        return cube_plain(a)
    out = torch.empty_like(a)
    _launch("cube", a.device, a, out, a.shape[-2], batch)
    return out


# -- the MiMC trace over a claim batch (no Pallas counterpart) ------------

def mimc_trace_plain(x0, consts, steps: int):
    """The recurrence step by step, vectorised over the claims: plain
    cube and add on [B, 8]."""
    rows = [x0]
    for i in range(steps - 1):
        k = consts[i % consts.shape[0]]
        rows.append(fl.add(fl.cube(rows[-1]), k[None]))
    return torch.stack(rows, dim=1)


# Round constants the trace kernel stages in shared memory (48 KB); it
# reads more from device memory.
SHARED_TRACE_CONSTS = 1536


def mimc_trace(x0, consts, steps: int):
    """MiMC traces of B claims: x0 [B, 8] (reduced inputs) and the round
    constants [n_k, 8] give [B, steps, 8] with trace[c][0] = x0[c] and
    trace[c][i + 1] = trace[c][i]^3 + consts[i % n_k].

    The counterpart of the `lax.scan` in `trace_batch_device`
    (starks_tpu/models/mimc.py:65-80), which is no Pallas kernel; the
    all-device proof (`prover.mk_mimc_proof_fused(device_trace=True)`)
    runs it. Runs `mimc_trace_kernel` (csrc/kernels.cu): one thread per
    claim through every step, the state in redundant form
    (`field::mimc_round`: lazy folds, k in the product's first row,
    only the stored row made canonical), the constants in shared memory
    (up to SHARED_TRACE_CONSTS) or read from device memory a step ahead.
    Bound: the larger of its bytes (32 * B * steps written) and its
    operations (a cube and an add per claim and step). Each claim's
    steps are one dependent chain, so with few claims that chain holds
    it far above both; its floor, 4 dependent multiplies and 10
    dependent adds a step (two products, each a multiply and a 3-level
    add tree, each followed by a fold of a multiply and 2 levels), is
    timed beside it by chip_smoke.py."""
    if x0.dim() != 2 or x0.shape[0] == 0:
        raise ValueError("x0 must be [B, 8]")
    if consts.dim() != 2 or consts.shape[0] == 0:
        raise ValueError("consts must be [n_k, 8] with n_k >= 1")
    if steps < 1:
        raise ValueError("steps must be positive")
    if not _on_card(x0, consts):
        return mimc_trace_plain(x0, consts, steps)
    out = torch.empty((x0.shape[0], steps, NUM_WORDS), dtype=torch.int32,
                      device=x0.device)
    _launch("mimc_trace", x0.device, x0, consts, consts.shape[0], out, steps,
            x0.shape[0])
    return out


# -- batch inversion (no Pallas counterpart) ------------------------------

# The block scan of batch_inv: INV_THREADS threads a block, each holding
# k elements at level 0 (1, 2, 4, 8 or 16: the most that still leaves
# INV_MIN_BLOCKS blocks, about one an SM) and INV_GROUP_UP at every
# level above, so the top block holds few elements (it runs on one SM).
# Each block's tree costs the same whatever its k, so fewer, fuller
# blocks win until the card runs short of them (chip_smoke.py phase 2
# times the set-up sizes; PERF.md gives the shapes timed).
INV_THREADS = 256
INV_MAX_GROUP = 16
INV_MIN_BLOCKS = 128
INV_GROUP_UP = 2


def batch_inv_shape(n: int) -> tuple:
    """(threads, k, k_up): the block scan's tile shape over n elements."""
    k = INV_MAX_GROUP
    while k > 1 and n < INV_MIN_BLOCKS * INV_THREADS * k:
        k //= 2
    return INV_THREADS, k, INV_GROUP_UP


def batch_inv_levels(n: int, threads: int, k: int, k_up: int) -> list:
    """The element count of every level of the scan: n, then the block
    totals of each level until one block holds them (as csrc/kernels.cu's
    batch_inv_scan counts them)."""
    counts, tile = [n], threads * k
    while counts[-1] > tile:
        counts.append(-(-counts[-1] // tile))
        tile = threads * k_up
    return counts


def batch_inv_scratch(n: int, threads: int, k: int, k_up: int) -> int:
    """Scratch elements of the scan: each level above 0 and its
    inverses."""
    return 2 * sum(batch_inv_levels(n, threads, k, k_up)[1:])


def batch_inv_plain(x):
    """`limbs.batch_inv`: the same inverses as any tile shape gives."""
    return fl.batch_inv(x)


def batch_inv(x):
    """1 / x over x [n, 8], with 1 / 0 = 0.

    The counterpart of JAX `limbs.batch_inv` (starks_tpu/ops/limbs.py:213,
    jitted as `kernels.batch_inv`, starks_tpu/ops/kernels.py:24) and its
    scan form `fused.batch_inv_scan` (starks_tpu/ops/fused.py:706), which
    the JAX set-ups run on the device; they are XLA scans, no Pallas
    kernel. Runs the block scan of csrc/kernels.cu at the tile shape
    `batch_inv_shape(n)`: an up-sweep kernel per level below the top
    (each thread's coalesced group product, the block's total by a tree
    in shared memory), one block at the top that inverts the total with
    `field::inv_chain` (255 squarings, 17 products), and a down-sweep
    kernel per level (each thread's inverse from the tree, a backward
    pass over its group). A zero counts as 1 in the products and maps
    to 0. Counts one launch per call in LAUNCHES; the card runs 2L - 1
    kernels for L levels (`batch_inv_levels`). Bound of the function
    (Montgomery's trick: 3 modmuls per nonzero element and one inverse
    in all): operations, about 148 x (3n + 272) multiply-adds, or bytes,
    64n (x read and out written, each once), whichever takes longer.
    The kernels make 3 modmuls an element and move about 128n bytes
    (the prefixes stored through out and read back)."""
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError("x must be non-empty [n, 8]")
    n = x.shape[0]
    if n >= 2**31:
        raise ValueError(f"n {n} not below 2^31")
    if not _on_card(x):
        return batch_inv_plain(x)
    shape = batch_inv_shape(n)
    scratch_len = batch_inv_scratch(n, *shape)
    out = torch.empty_like(x)
    scratch = torch.empty((scratch_len, NUM_WORDS), dtype=torch.int32,
                          device=x.device)
    _launch("batch_inv", x.device, x, out, scratch, scratch_len, n, *shape)
    return out
