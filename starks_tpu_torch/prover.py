"""MiMC STARK prover on PyTorch and CUDA.

Port of `starks_tpu/prover.py`: the single-device paths (`mk_mimc_proof`
-> `_prove_from_trace_fused` -> `post_trace_pl`; `mk_mimc_proof_fused`,
whose `device_trace=True` builds the trace on the card; and the batch
prover `mk_mimc_proof_batch_fused`, which vmaps that core over a claim
axis), the mesh path (`mk_mimc_proof_with_trace(mesh=...)`) and
`prove_low_degree`. The pipeline is identical in math and transcript
bytes (SURVEY.md §4.1):

  host trace (native runtime; or the device trace kernel) -> LDE (DIF
  kernel, 1/n in its last stage; DIT kernel) -> D/B map kernel ->
  commit P||D||B -> Fiat-Shamir weights -> L map kernel -> commit L ->
  spot-check bundles -> FRI (fold4 kernel per round) -> one
  device-to-host copy -> host byte assembly.

Every device step runs over a claim axis: B proofs take one launch of
each kernel and each blake2s tensor op, and a single proof is the
B = 1 case of the same code. Challenges, query indices and branch
bundles are derived on the device (ops/transcript_dev.py,
ops/merkle.py), so nothing waits on the host until the final copy.
Proofs equal `oracle.stark.mk_mimc_proof` byte for byte
(tests/test_torch_prover.py, tests/test_torch_batch.py).

The sharded prover (`_prove_sharded`) runs the same steps over a mesh's
row shards: the LDE as two four-step NTTs, the D/B map with the next
shard's rows as its halo, and the trees and FRI rounds over the shards
(`merkle.Tree`, `fused.fri_commit`); each rank's set-up holds
only its rows of the domain tables (tests/test_torch_parallel.py).
"""

import math
import time

import numpy as np
import torch

from .config import StarkConfig, REFERENCE
from .models import mimc as mimc_model
from .ops import blake2s as b2
from .ops import fused
from .ops import merkle
from .ops import plimbs
from .ops import transcript_dev as td
from .parallel import ntt4step
from .parallel.mesh import Mesh
from .transcript import is_a_power_of_2
from .utils import hostfield as hf
from .utils import native
from .utils.conversions import (NUM_WORDS, digest_words_to_bytes,
                                int_to_tensor, ints_to_tensor)

# Claims per device pass of the batch prover: bounds the memory in
# flight (two chunks), as the JAX batch prover's default does.
DEFAULT_CHUNK = 16

MODULUS = REFERENCE.modulus


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run "
                               "the plain PyTorch versions of the kernels")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class _StageTimer:
    """Per-stage wall-clock seconds into `out` (when given). Each mark
    first waits for the device, so each stage's time is its own."""

    def __init__(self, out, device):
        self.out = out
        self.device = device
        self.t0 = self.last = time.perf_counter()

    def mark(self, stage: str):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[stage] = now - self.last
        self.last = now

    def finish(self):
        if self.out is not None:
            self.out["total"] = time.perf_counter() - self.t0


def _inv_vanishing2(xs, last: int, timer: _StageTimer):
    """1/Z2 over the points xs [n, 8], Z2(x) = (x - 1)(x - last), on xs's
    device (zeros map to zero): a constant of the config, built as the
    JAX set-up builds it (starks_tpu/prover.py:436-449), by the sub and
    mul kernels and one batch inverse. The JAX package cuts it in chunks
    of 2^20 points for its HBM temporaries; here it runs whole. Marks
    the stages "1/Z2 sub, sub, mul" and "batch inverse"."""
    one, last = (int_to_tensor(v, xs.device)[None] for v in (1, last))
    z2 = plimbs.mul(plimbs.sub(xs, one), plimbs.sub(xs, last))
    timer.mark("1/Z2 sub, sub, mul")
    inv_z2 = plimbs.batch_inv(z2)
    timer.mark("batch inverse")
    return inv_z2


class _FusedSetup:
    """Per-(steps, config, device) schedule and constants. With a dict as
    `timings`, the set-up's stage seconds go into it, each stage waiting
    for the device: "host power tables" (the native power tables, with
    the scalars before them), "upload", "1/Z2 sub, sub, mul", "batch
    inverse", "rest" (the small tables after them) and "total"."""

    _cache = {}

    def __init__(self, steps: int, config: StarkConfig, device,
                 timings: dict = None):
        timer = _StageTimer(timings, torch.device(device))
        ext = config.extension_factor
        precision = steps * ext
        G2 = pow(config.generator, (MODULUS - 1) // precision, MODULUS)
        G1 = pow(G2, ext, MODULUS)
        self.steps, self.config, self.device = steps, config, device
        self.precision, self.ext = precision, ext
        self.G1, self.G2 = G1, G2
        self.schedule = fused.fri_round_schedule(
            precision, steps * 2, config.fri_base_cutoff)
        last = pow(G2, (steps - 1) * ext, MODULUS)
        self._tables(last, timer)
        h = pow(G2, steps, MODULUS)
        self.islope = hf.inv(last - 1)
        self.last_l = int_to_tensor(last, device)
        self.zni8 = ints_to_tensor(
            [hf.inv(pow(h, i, MODULUS) - 1) for i in range(ext)], device)
        self.h_pows = ints_to_tensor(
            [pow(h, i, MODULUS) for i in range(ext)], device)
        self.eta_l = int_to_tensor(pow(G2, precision // 4, MODULUS), device)
        self._kext = {}
        timer.mark("rest")
        timer.finish()

    def _tables(self, last: int, timer: _StageTimer):
        self.plan = fused.FusedPlan(self.steps, self.precision, self.G1,
                                    self.G2, self.device, timer.mark)
        self.inv_z2 = _inv_vanishing2(self.plan.xs_big, last, timer)

    @classmethod
    def get(cls, steps: int, config: StarkConfig, device,
            timings: dict = None) -> "_FusedSetup":
        """The cached set-up; `timings` receives its stages when this
        call builds it."""
        key = (steps, config, str(device))
        if key not in cls._cache:
            cls._cache[key] = cls(steps, config, device, timings)
        return cls._cache[key]

    def k_ext(self, round_constants):
        """Round-constant mini-polynomial extension K over the 8x domain
        (SURVEY §4.1 step 4): a tiny host NTT, cached per constant list."""
        key = tuple(round_constants)
        if key not in self._kext:
            skips2 = self.steps // len(round_constants)
            mini = hf.host_ntt(list(round_constants),
                               pow(self.G1, skips2, MODULUS), inverse=True)
            k_ext = hf.host_ntt(mini, pow(self.G2, skips2, MODULUS))
            self._kext[key] = ints_to_tensor(
                [x % MODULUS for x in k_ext], self.device)
        return self._kext[key]


class _ShardedSetup(_FusedSetup):
    """One shard's set-up for a sharded proof over `mesh`: the scalars of
    `_FusedSetup`, the four-step plans of the trace and evaluation
    domains, and only this shard's rows of the domain tables (x and the
    FRI u-table from the native runtime, 1/Z2 on the device)."""

    def __init__(self, steps: int, config: StarkConfig, mesh,
                 timings: dict = None):
        self.mesh = mesh
        super().__init__(steps, config, mesh.device, timings)

    def _tables(self, last: int, timer: _StageTimer):
        mesh, dev = self.mesh, self.device
        s, r = mesh.n_shard, mesh.shard_index
        n, q = self.precision, self.precision // 4
        rows = n // s
        self.offset = r * rows
        xs = native.power_slice(self.G2, self.offset, rows)
        # Round 0's u-table rows [r q/s, (r+1) q/s): every round's
        # columns on this shard read them at stride 4^round.
        self.inv_g2 = hf.inv(self.G2)
        u_local = native.power_slice(self.inv_g2, r * (q // s), q // s)
        timer.mark("host power tables")
        self.xs = torch.from_numpy(xs).to(dev)
        self.u_local = torch.from_numpy(u_local).to(dev)
        timer.mark("upload")
        self.inv_z2 = _inv_vanishing2(self.xs, last, timer)
        self.plan_trace = ntt4step.get_plan(self.steps, self.G1, mesh)
        self.plan_lde = ntt4step.get_plan(n, self.G2, mesh)

    @classmethod
    def get(cls, steps: int, config: StarkConfig, mesh,
            timings: dict = None) -> "_ShardedSetup":
        """The set-up cached on the mesh; `timings` as in
        `_FusedSetup.get`. Its "rest" holds the four-step plans."""
        key = ("mimc set-up", steps, config)
        if key not in mesh.cache:
            mesh.cache[key] = cls(steps, config, mesh, timings)
        return mesh.cache[key]

    def k_ext(self, round_constants):
        """K from this shard's first row on: the table rolled by the
        shard's offset, so the kernel's local row i reads K at the
        domain's row offset + i."""
        k = super().k_ext(round_constants)
        return torch.roll(k, -(self.offset % k.shape[0]), 0)


def _prove_sections(su: _FusedSetup, trace, k_ext, inps, outputs,
                    timer: _StageTimer):
    """The device part of B proofs (post_trace_pl without pruning, over
    a claim axis): `trace` [B, steps, 8] on the device, `inps` and
    `outputs` B ints. Returns the named sections, each an int64 word
    tensor [B, ...] on the device."""
    plan = su.plan
    ext = su.ext

    # 2-3. LDE.
    p = fused.lde(trace, plan.inv_small, plan.n_inv_small, plan.xs_big)
    timer.mark("lde")

    # 5-7. Constraint, quotient and boundary as one kernel. Each claim's
    # boundary interpolant through (1, inp), (last, output) is built on
    # the host.
    slopes = [(o - i) * su.islope % MODULUS for i, o in zip(inps, outputs)]
    ias = [(i - s) % MODULUS for i, s in zip(inps, slopes)]
    d, b = plimbs.db_map(p, plan.xs_big, k_ext, su.zni8, su.inv_z2,
                         su.last_l, _upload(ints_to_tensor(slopes), su.device),
                         _upload(ints_to_tensor(ias), su.device), ext)
    timer.mark("constraints/quotient/boundary")

    # 8. Commit #1: 96-byte P||D||B leaves.
    m_tree = merkle.Tree(torch.cat(
        [b2.limbs_to_words(p), b2.limbs_to_words(d), b2.limbs_to_words(b)],
        dim=-1))
    timer.mark("merkle #1 (P||D||B)")

    # 9. Fiat-Shamir weights and the linear combination.
    return _query_sections(su, m_tree, _l_map(su, m_tree, d, p, b), timer)


def _l_map(su, m_tree, d, p, b):
    """Step 9: the Fiat-Shamir weights from the main root, and L."""
    k1, k2, k3, k4 = (td.challenge_limbs(m_tree.root, j)
                      for j in (1, 2, 3, 4))
    return plimbs.l_map(d, p, b, td.lincomb_coeffs(k1, k2, su.h_pows),
                        td.lincomb_coeffs(k3, k4, su.h_pows))


def _query_sections(su, m_tree, l_vals, timer: _StageTimer, mesh=None):
    """Steps 10-12, shared by the MiMC proof (on one device or over a
    mesh) and the AIR proof: commit L, the spot-check bundles (main tree
    at x and g1 x, L tree at x), and FRI on L. `su` is the proof's
    setup; on one device the arrays may carry a leading claim axis, over
    `mesh` they are this shard's rows. Returns the named sections, as
    int64 word tensors on the device."""
    cfg, precision, ext = su.config, su.precision, su.ext

    # 10. Commit #2.
    l_tree = merkle.Tree(b2.limbs_to_words(l_vals), mesh)
    timer.mark("linear combination + merkle #2")

    # 11. Spot checks.
    positions = td.pseudorandom_indices_dev(
        l_tree.root, precision, cfg.spot_checks, exclude_multiples_of=ext)
    aug = torch.stack([positions, (positions + ext) % precision],
                      dim=-1).reshape(*positions.shape[:-1], -1)
    main_bundle, lc_bundle = m_tree.bundle(aug), l_tree.bundle(positions)
    timer.mark("spot-check bundles")

    # 12. FRI on L (deg < 2*steps), reusing the L tree.
    if mesh is None:
        fri = fused.fri_commit(l_vals, l_tree, su.plan.fri_inv_pows,
                               su.schedule, su.eta_l, cfg.fri_queries, ext)
    else:
        fri = fused.fri_commit(l_vals, l_tree, su.u_local, su.schedule,
                               su.eta_l, cfg.fri_queries, ext, mesh,
                               su.inv_g2)
    timer.mark("fri")
    return [("m_root", m_tree.root), ("l_root", l_tree.root),
            ("main_bundle", main_bundle), ("lc_bundle", lc_bundle)] + \
        _fri_sections(*fri)


def _fri_sections(col_roots, col_bs, row_bs, final):
    sections = []
    for r, (cr, cbnd, rbnd) in enumerate(zip(col_roots, col_bs, row_bs)):
        sections += [(f"col_root{r}", cr), (f"col_b{r}", cbnd),
                     (f"row_b{r}", rbnd)]
    sections.append(("base_words", b2.limbs_to_words(final)))
    return sections


def _prove_sharded(su: _ShardedSetup, trace, k_ext, inp: int, output: int,
                   timer: _StageTimer):
    """The device part of one proof over `su.mesh` (the JAX package's
    mesh path, `starks_tpu/prover.py:206-379`): `trace` this shard's
    [steps/s, 8] rows on the device. Every array of the evaluation
    domain stays in contiguous row shards; the sections returned (no
    claim axis) are the same on every shard."""
    mesh, cfg, ext, n = su.mesh, su.config, su.ext, su.precision

    # 2-3. LDE: inverse four-step over the trace, zero-pad (all nonzero
    # coefficients come to shard 0), forward four-step.
    coeffs = ntt4step.fourstep_ntt(trace, su.plan_trace, inverse=True)
    p = ntt4step.fourstep_ntt(ntt4step.zero_pad(coeffs, n, mesh),
                              su.plan_lde)
    timer.mark("lde")

    # 5-7. The D/B map on this shard; P(g1 x) past its end reads the next
    # shard's first ext rows (the halo).
    slope = (output - inp) * su.islope % MODULUS
    d, b = plimbs.db_map(
        p, su.xs, k_ext, su.zni8, su.inv_z2, su.last_l,
        int_to_tensor(slope, su.device),
        int_to_tensor((inp - slope) % MODULUS, su.device), ext,
        halo=mesh.halo(p, ext))
    timer.mark("constraints/quotient/boundary")

    # 8-12. Commit P||D||B, the weights and L, then steps 10-12 over the
    # shards.
    m_tree = merkle.Tree(torch.cat(
        [b2.limbs_to_words(p), b2.limbs_to_words(d), b2.limbs_to_words(b)],
        dim=-1), mesh)
    timer.mark("merkle #1 (P||D||B)")
    return _query_sections(su, m_tree, _l_map(su, m_tree, d, p, b), timer,
                           mesh)


def _upload(host, device):
    """A host tensor on `device`. To the card it goes through pinned
    memory and is copied on the stream, so the host does not wait for
    the work queued before it."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _start_fetch(sections):
    """Queue ONE device-to-host copy of B claims' sections ([B, ...]
    each): on the card into pinned memory behind an event, so the host
    can queue more work before it waits. Returns the pending fetch."""
    claims = sections[0][1].shape[0]
    flat = torch.cat([t.reshape(claims, -1) for _, t in sections], dim=1)
    layout = [(name, tuple(t.shape[1:])) for name, t in sections]
    if flat.device.type != "cuda":
        return flat, None, layout
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done, layout


def _prep_section(name: str, arr: np.ndarray, main_leaf_words: int):
    """Host decode of one fetched section into proof fragments; a main
    tree leaf is `main_leaf_words` words (8 per committed column)."""
    if name in ("m_root", "l_root") or name.startswith("col_root"):
        return digest_words_to_bytes(arr)
    if name == "main_bundle":
        return merkle.bundle_to_branches(arr, main_leaf_words)
    if name == "base_words":
        return [digest_words_to_bytes(r) for r in arr]
    return merkle.bundle_to_branches(arr, 8)        # lc, col and row


def _assemble_fri(pre: dict, rounds: int):
    """Reference-shaped FRI proof (SURVEY §A.6) from prepped sections."""
    fri_proof = []
    for r in range(rounds):
        col, row = pre[f"col_b{r}"], pre[f"row_b{r}"]
        branches = [[col[i]] + row[4 * i:4 * i + 4] for i in range(len(col))]
        fri_proof.append([pre[f"col_root{r}"], branches])
    fri_proof.append(pre["base_words"])
    return fri_proof


def _assemble_prepped(pre: dict, rounds: int):
    """Reference-shaped proof object (SURVEY §A.8) from prepped sections."""
    return [pre["m_root"], pre["l_root"], pre["main_bundle"],
            pre["lc_bundle"], _assemble_fri(pre, rounds)]


def _finish_fetch(fetch, main_leaf_words: int, rounds: int,
                  timer: _StageTimer, assemble=_assemble_prepped):
    """Wait for a fetch, then assemble each claim's proof on the host,
    in claim order."""
    host, done, layout = fetch
    if done is not None:
        done.synchronize()
    flat = host.numpy().astype(np.uint32)
    timer.mark("proof transfer")
    proofs = []
    for row in flat:
        pre, off = {}, 0
        for name, shape in layout:
            size = math.prod(shape)
            pre[name] = _prep_section(name, row[off:off + size].reshape(shape),
                                      main_leaf_words)
            off += size
        proofs.append(assemble(pre, rounds))
    timer.mark("proof assembly")
    timer.finish()
    return proofs


def _finish_proof(sections, main_leaf_words: int, rounds: int,
                  timer: _StageTimer, assemble=_assemble_prepped):
    """One device-to-host copy of one proof's sections (no claim axis),
    then the host assembly of the reference-shaped proof."""
    fetch = _start_fetch([(name, t[None]) for name, t in sections])
    return _finish_fetch(fetch, main_leaf_words, rounds, timer,
                         assemble)[0]


def _check_claim(steps: int, round_constants, config: StarkConfig):
    assert steps <= 2**32 // config.extension_factor
    assert is_a_power_of_2(steps) and is_a_power_of_2(len(round_constants))
    assert len(round_constants) < steps


def _trace_array(trace, steps: int) -> np.ndarray:
    """A trace as a host [steps, 8] int32 array: from a list of ints
    (reduced mod p), or an array or tensor in the port's layout."""
    if isinstance(trace, (list, tuple)):
        trace = ints_to_tensor([x % MODULUS for x in trace])
    if isinstance(trace, torch.Tensor):
        trace = trace.detach().cpu().numpy()
    trace = np.ascontiguousarray(trace, dtype=np.int32)
    if trace.shape != (steps, NUM_WORDS):
        raise ValueError(f"trace of shape {trace.shape}, expected "
                         f"({steps}, {NUM_WORDS})")
    return trace


def _prove_chunk(su: _FusedSetup, k_ext, inps, traces, timer: _StageTimer):
    """Queue the proofs of one chunk of claims (`inps`, reduced, and
    their host traces as [steps, 8] int32 arrays) and their one
    device-to-host copy; returns the pending fetch."""
    trace = _upload(torch.from_numpy(np.stack(traces)), su.device)
    outputs = [int.from_bytes(t[-1].tobytes(), "little") for t in traces]
    timer.mark("setup + trace upload")
    sections = _prove_sections(su, trace, k_ext, inps, outputs, timer)
    return _start_fetch(sections)


def _check_mesh(mesh, device):
    """The mesh's device, after checking `mesh` is a Mesh and `device`
    (when given) is its device."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def _prove_one(inp: int, steps: int, round_constants, make_trace, mesh,
               config: StarkConfig, device, timings):
    """One proof from the host trace `make_trace()` returns: the B = 1
    case of the claim-axis prover, or with `mesh` the sharded prover."""
    device = (_resolve_device(device) if mesh is None
              else _check_mesh(mesh, device))
    _check_claim(steps, round_constants, config)
    timer = _StageTimer(timings, device)
    trace = make_trace()
    timer.mark("host trace")
    if mesh is not None:
        su = _ShardedSetup.get(steps, config, mesh)
        rows = steps // mesh.n_shard
        mine = trace[mesh.shard_index * rows:][:rows]
        local = _upload(torch.from_numpy(np.ascontiguousarray(mine)), device)
        timer.mark("setup + trace upload")
        sections = _prove_sharded(
            su, local, su.k_ext(round_constants), inp % MODULUS,
            int.from_bytes(trace[-1].tobytes(), "little"), timer)
        return _finish_proof(sections, 3 * NUM_WORDS, len(su.schedule),
                             timer)
    su = _FusedSetup.get(steps, config, device)
    fetch = _prove_chunk(su, su.k_ext(round_constants), [inp % MODULUS],
                         [trace], timer)
    return _finish_fetch(fetch, 3 * NUM_WORDS, len(su.schedule), timer)[0]


def mk_mimc_proof(inp: int, steps: int, round_constants, mesh=None,
                  config: StarkConfig = REFERENCE, device=None,
                  timings: dict = None):
    """Full proof [m_root, l_root, main_branches, lc_branches, fri_proof]
    (SURVEY §A.8), byte-identical to the reference transcript.

    `device` None means "cuda", and then a CUDA device must be present:
    the prover never falls back to the CPU on its own. `device="cpu"`
    runs the plain PyTorch versions of the kernels. Pass a dict as
    `timings` to receive per-stage seconds (each stage waits for the
    device).

    With `mesh` (a parallel.mesh.Mesh; every rank of its shard row calls
    this with the same claim), the proof runs sharded over the row's
    ranks, each on its mesh device with its contiguous rows of the
    evaluation domain (`_prove_sharded`), and every rank returns the
    same proof, byte-identical to the single-device one."""
    return _prove_one(
        inp, steps, round_constants,
        lambda: mimc_model.trace_limbs(inp, steps, round_constants), mesh,
        config, device, timings)


def mk_mimc_proof_with_trace(inp: int, steps: int, round_constants, trace,
                             mesh=None, config: StarkConfig = REFERENCE,
                             device=None, timings: dict = None):
    """Proof from a precomputed trace: a list of ints, or a [steps, 8]
    int32 array or tensor in the port's layout. The retry route of
    `parallel.batch.prove_batch`.

    The trace is proved VERBATIM, every row as given, as the reference's
    mesh path does (`starks_tpu/prover.py:231`); the output is its last
    row. A trace that breaks the MiMC recurrence therefore gives a proof
    the verifier rejects. (The reference's mesh=None path uploads every
    K-th row and regenerates the others from the recurrence, so it
    proves the consistent trace through those rows instead; that upload
    scheme works around its runtime and is not ported.) `mesh`,
    `device` and `timings` as in `mk_mimc_proof`."""
    return _prove_one(inp, steps, round_constants,
                      lambda: _trace_array(trace, steps), mesh, config,
                      device, timings)


def mk_mimc_proof_fused(inp: int, steps: int, round_constants,
                        config: StarkConfig = REFERENCE,
                        device_trace: bool = False, device=None,
                        timings: dict = None):
    """The counterpart of JAX `mk_mimc_proof_fused`
    (starks_tpu/prover.py:902): the proof of `mk_mimc_proof`, byte for
    byte. With `device_trace=False` it is `mk_mimc_proof` (the native
    host trace, uploaded).

    With `device_trace=True` nothing of the trace is computed on the
    host or uploaded (the JAX package's "no-host fallback"): one launch
    of `mimc_trace_kernel` (`models.mimc.trace_batch_device`) writes the
    [1, steps, 8] trace on the device, and the proof runs from it. The
    host reads back only the output, the trace's last row (32 bytes,
    one wait for the card), to build the boundary interpolant as the
    host path does. The trace is a chain of dependent steps on one
    thread, so this is slower than the host trace (PERF.md §5).
    `device` and `timings` as in `mk_mimc_proof`; the stages "setup"
    and "device trace" stand where the host path has "host trace" and
    "setup + trace upload"."""
    if not device_trace:
        return mk_mimc_proof(inp, steps, round_constants, config=config,
                             device=device, timings=timings)
    device = _resolve_device(device)
    _check_claim(steps, round_constants, config)
    timer = _StageTimer(timings, device)
    su = _FusedSetup.get(steps, config, device)
    k_ext = su.k_ext(round_constants)
    timer.mark("setup")
    inp = inp % MODULUS
    trace = mimc_model.trace_batch_device([inp], steps, round_constants,
                                          device)
    # .cpu() waits for the trace kernel on this stream.
    last = trace[0, -1].cpu().numpy()
    timer.mark("device trace")
    fetch = _start_fetch(_prove_sections(
        su, trace, k_ext, [inp], [int.from_bytes(last.tobytes(), "little")],
        timer))
    return _finish_fetch(fetch, 3 * NUM_WORDS, len(su.schedule), timer)[0]


def mk_mimc_proof_batch_fused(inps, steps: int, round_constants,
                              config: StarkConfig = REFERENCE,
                              chunk: int = None, traces=None, device=None):
    """Proofs of independent MiMC claims, one per input, each
    byte-identical to `mk_mimc_proof` for that claim.

    Claims go in chunks of `chunk` (default DEFAULT_CHUNK): each chunk
    is one pass of the prover over a claim axis (one launch of each
    kernel and blake2s tensor op for all of its claims) and one
    device-to-host copy. Chunk i+1 is queued before chunk i's proofs are
    assembled on the host, so the card works while the host decodes.
    Traces come from the native runtime unless given (`traces`, one per
    input, as `mk_mimc_proof_with_trace` takes them). `device` as in
    `mk_mimc_proof`."""
    device = _resolve_device(device)
    _check_claim(steps, round_constants, config)
    chunk = DEFAULT_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    su = _FusedSetup.get(steps, config, device)
    k_ext = su.k_ext(round_constants)
    timer = _StageTimer(None, device)
    inps = list(inps)
    proofs, pending = [], None
    for lo in range(0, len(inps), chunk):
        part = [x % MODULUS for x in inps[lo:lo + chunk]]
        part_traces = [
            mimc_model.trace_limbs(x, steps, round_constants)
            if traces is None else _trace_array(traces[lo + i], steps)
            for i, x in enumerate(part)]
        fetch = _prove_chunk(su, k_ext, part, part_traces, timer)
        if pending is not None:
            proofs += _finish_fetch(pending, 3 * NUM_WORDS,
                                    len(su.schedule), timer)
        pending = fetch
    if pending is not None:
        proofs += _finish_fetch(pending, 3 * NUM_WORDS, len(su.schedule),
                                timer)
    return proofs


def prove_low_degree(values, root_of_unity: int, maxdeg_plus_1: int,
                     exclude_multiples_of: int = 0,
                     config: StarkConfig = REFERENCE, mesh=None,
                     device=None):
    """FRI proof that `values` (a list of ints, or an [n, 8] int32 array
    or tensor in the port's layout: the evaluations over the powers of
    `root_of_unity`, of order n) have degree below `maxdeg_plus_1`: the
    reference-shaped proof of `oracle.fri.prove_low_degree`, byte for
    byte, checked by `verifier.verify_low_degree_proof` against the
    Merkle root of the values. The counterpart of JAX
    `prover.prove_low_degree` (`_fri_device` on one device).

    Runs on one device (`device` as in `mk_mimc_proof`), or with `mesh`
    over the mesh's shards, each holding its contiguous rows of the
    values (`fused.fri_commit`); every shard returns the proof.
    """
    if mesh is None:
        device = _resolve_device(device)
    else:
        device = _check_mesh(mesh, device)
    if isinstance(values, (list, tuple)):
        values = ints_to_tensor([x % MODULUS for x in values])
    values = torch.as_tensor(values).to(torch.int32)
    n = values.shape[0]
    if values.shape != (n, NUM_WORDS) or n & (n - 1):
        raise ValueError(f"values of shape {tuple(values.shape)}: expected "
                         f"[n, 8] with n a power of two")
    if maxdeg_plus_1 <= config.fri_base_cutoff:
        raw = values.cpu().numpy().astype("<u4").tobytes()
        return [[int.from_bytes(raw[i:i + 32], "little").to_bytes(32, "big")
                 for i in range(0, len(raw), 32)]]
    schedule = fused.fri_round_schedule(n, maxdeg_plus_1,
                                        config.fri_base_cutoff)
    eta = int_to_tensor(pow(root_of_unity, n // 4, MODULUS), device)
    inv_root = hf.inv(root_of_unity)
    s, r = (1, 0) if mesh is None else (mesh.n_shard, mesh.shard_index)
    rows, q = n // s, n // 4
    vals = _upload(values[r * rows:(r + 1) * rows].contiguous(), device)
    u_table = torch.from_numpy(native.power_slice(
        inv_root, r * (q // s), q // s)).to(device)
    fri = fused.fri_commit(
        vals, merkle.Tree(b2.limbs_to_words(vals), mesh), u_table,
        schedule, eta, config.fri_queries, exclude_multiples_of, mesh,
        inv_root)
    return _finish_proof(_fri_sections(*fri), NUM_WORDS, len(schedule),
                         _StageTimer(None, device), _assemble_fri)
