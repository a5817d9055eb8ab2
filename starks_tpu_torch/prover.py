"""MiMC STARK prover on PyTorch and CUDA.

Port of the single-device paths of `starks_tpu/prover.py`
(`mk_mimc_proof` -> `_prove_from_trace_fused` -> `post_trace_pl`, and
the batch prover `mk_mimc_proof_batch_fused`, which vmaps that core over
a claim axis). The pipeline is identical in math and transcript bytes
(SURVEY.md §4.1):

  host trace (native runtime) -> LDE (DIF kernel, 1/n in its last
  stage; DIT kernel) -> D/B map kernel -> commit P||D||B -> Fiat-Shamir
  weights -> L map kernel -> commit L -> spot-check bundles -> FRI
  (fold4 kernel per round) -> one device-to-host copy -> host byte
  assembly.

Every device step runs over a claim axis: B proofs take one launch of
each kernel and each blake2s tensor op, and a single proof is the
B = 1 case of the same code. Challenges, query indices and branch
bundles are derived on the device (ops/transcript_dev.py,
ops/merkle.py), so nothing waits on the host until the final copy.
Proofs equal `oracle.stark.mk_mimc_proof` byte for byte
(tests/test_torch_prover.py, tests/test_torch_batch.py).
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
from .transcript import is_a_power_of_2
from .utils import hostfield as hf
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


class _FusedSetup:
    """Per-(steps, config, device) schedule and constants."""

    _cache = {}

    def __init__(self, steps: int, config: StarkConfig, device):
        ext = config.extension_factor
        precision = steps * ext
        G2 = pow(config.generator, (MODULUS - 1) // precision, MODULUS)
        G1 = pow(G2, ext, MODULUS)
        self.steps, self.config, self.device = steps, config, device
        self.precision, self.ext = precision, ext
        self.G1, self.G2 = G1, G2
        self.schedule = fused.fri_round_schedule(
            precision, steps * 2, config.fri_base_cutoff)
        self.plan = fused.FusedPlan(steps, precision, G1, G2, device)

        last = pow(G2, (steps - 1) * ext, MODULUS)
        h = pow(G2, steps, MODULUS)
        self.islope = hf.inv(last - 1)
        self.last_l = int_to_tensor(last, device)
        self.zni8 = ints_to_tensor(
            [hf.inv(pow(h, i, MODULUS) - 1) for i in range(ext)], device)
        self.h_pows = ints_to_tensor(
            [pow(h, i, MODULUS) for i in range(ext)], device)
        self.eta_l = int_to_tensor(pow(G2, precision // 4, MODULUS), device)

        # 1/Z2 with Z2(x) = (x - 1)(x - last): a constant of the config,
        # inverted once on the host (zeros map to zero).
        self.inv_z2 = ints_to_tensor(
            hf.multi_inv([(x - 1) * (x - last) % MODULUS
                          for x in fused.powers(G2, precision)]), device)
        self._kext = {}

    @classmethod
    def get(cls, steps: int, config: StarkConfig, device) -> "_FusedSetup":
        key = (steps, config, str(device))
        if key not in cls._cache:
            cls._cache[key] = cls(steps, config, device)
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
    m_leaf = torch.cat([b2.limbs_to_words(p), b2.limbs_to_words(d),
                        b2.limbs_to_words(b)], dim=-1)
    m_lvl1, m_levels, m_root = merkle.tree_build(m_leaf)
    timer.mark("merkle #1 (P||D||B)")

    # 9. Fiat-Shamir weights and the linear combination.
    k1, k2, k3, k4 = (td.challenge_limbs(m_root, j) for j in (1, 2, 3, 4))
    cp = td.lincomb_coeffs(k1, k2, su.h_pows)
    cb = td.lincomb_coeffs(k3, k4, su.h_pows)
    l_vals = plimbs.l_map(d, p, b, cp, cb)
    return _query_sections(su, m_leaf, m_lvl1, m_levels, m_root, l_vals,
                           timer)


def _query_sections(su, m_leaf, m_lvl1, m_levels, m_root, l_vals,
                    timer: _StageTimer):
    """Steps 10-12, shared by the MiMC and the AIR proof: commit L, the
    spot-check bundles (main tree at x and g1 x, L tree at x), and FRI on
    L. `su` is either proof's setup; the arrays may carry a leading
    claim axis. Returns the named sections, as int64 word tensors on the
    device."""
    cfg, precision, ext = su.config, su.precision, su.ext

    # 10. Commit #2.
    l_leaf = b2.limbs_to_words(l_vals)
    l_lvl1, l_levels, l_root = merkle.tree_build(l_leaf)
    timer.mark("linear combination + merkle #2")

    # 11. Spot checks.
    positions = td.pseudorandom_indices_dev(
        l_root, precision, cfg.spot_checks, exclude_multiples_of=ext)
    aug = torch.stack([positions, (positions + ext) % precision],
                      dim=-1).reshape(*positions.shape[:-1], -1)
    main_bundle = merkle.tree_bundle(m_leaf, m_lvl1, m_levels, aug)
    lc_bundle = merkle.tree_bundle(l_leaf, l_lvl1, l_levels, positions)
    timer.mark("spot-check bundles")

    # 12. FRI on L (deg < 2*steps), reusing the L tree.
    col_roots, col_bs, row_bs, final = fused.fri_commit(
        l_vals, l_leaf, l_lvl1, l_levels, l_root, su.plan.fri_inv_pows,
        su.schedule, su.eta_l, cfg.fri_queries, ext)
    timer.mark("fri")

    sections = [("m_root", m_root), ("l_root", l_root),
                ("main_bundle", main_bundle), ("lc_bundle", lc_bundle)]
    for r, (cr, cbnd, rbnd) in enumerate(zip(col_roots, col_bs, row_bs)):
        sections += [(f"col_root{r}", cr), (f"col_b{r}", cbnd),
                     (f"row_b{r}", rbnd)]
    sections.append(("base_words", b2.limbs_to_words(final)))
    return sections


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


def _assemble_prepped(pre: dict, rounds: int):
    """Reference-shaped proof object (SURVEY §A.8) from prepped sections."""
    fri_proof = []
    for r in range(rounds):
        col, row = pre[f"col_b{r}"], pre[f"row_b{r}"]
        branches = [[col[i]] + row[4 * i:4 * i + 4] for i in range(len(col))]
        fri_proof.append([pre[f"col_root{r}"], branches])
    fri_proof.append(pre["base_words"])
    return [pre["m_root"], pre["l_root"], pre["main_bundle"],
            pre["lc_bundle"], fri_proof]


def _finish_fetch(fetch, main_leaf_words: int, rounds: int,
                  timer: _StageTimer):
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
        proofs.append(_assemble_prepped(pre, rounds))
    timer.mark("proof assembly")
    timer.finish()
    return proofs


def _finish_proof(sections, main_leaf_words: int, rounds: int,
                  timer: _StageTimer):
    """One device-to-host copy of one proof's sections (no claim axis),
    then the host assembly of the reference-shaped proof."""
    fetch = _start_fetch([(name, t[None]) for name, t in sections])
    return _finish_fetch(fetch, main_leaf_words, rounds, timer)[0]


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


def _prove_one(inp: int, steps: int, round_constants, make_trace, mesh,
               config: StarkConfig, device, timings):
    """One proof, the B = 1 case of the claim-axis prover, from the host
    trace `make_trace()` returns."""
    if mesh is not None:
        raise NotImplementedError("the sharded (mesh) path is not ported")
    device = _resolve_device(device)
    _check_claim(steps, round_constants, config)
    timer = _StageTimer(timings, device)
    trace = make_trace()
    timer.mark("host trace")
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
    device). `mesh` (the sharded path) is not ported yet."""
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
    scheme works around its runtime and is not ported.) `mesh` is not
    ported yet; `device` and `timings` as in `mk_mimc_proof`."""
    return _prove_one(inp, steps, round_constants,
                      lambda: _trace_array(trace, steps), mesh, config,
                      device, timings)


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
