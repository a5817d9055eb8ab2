"""Whether what the timed window produced is correct.

Once the window has closed, the device's peak has been read and the
program's state freed, a sample of the window's proofs, drawn from the
seed, is proved again by the plain reference (refstark) from the claims
alone, and each sampled proof is compared with the reference's section
by section: both roots, every main-tree and L-tree branch (leaf values,
sibling leaf, digests), every FRI round's column root and query
branches, and the FRI base values. That covers the trace, the LDE and
constraints, both trees, the spot checks, every FRI round and the
proof's bytes. Every number compared has a limit; the run is correct
when all hold.
"""

import itertools
import random
import sys
import time

SALT = 0x9E3779B9


def sections(proof) -> list:
    """A proof's sections in order: m_root, l_root, each main and L
    branch, each FRI round's root and query branch groups, the base."""
    m_root, l_root, main, lc, fri = proof
    out = [m_root, l_root, *main, *lc]
    for rnd in fri[:-1]:
        out += [rnd[0], *rnd[1]]
    out.append(fri[-1])
    return out


def differing(got, want) -> int:
    """Sections of `got` that differ from `want`'s (missing or extra
    ones count); a proof of another shape differs in every section."""
    w = sections(want)
    try:
        g = sections(got)
    except (TypeError, ValueError):
        return len(w)
    return sum(a != b for a, b in itertools.zip_longest(g, w))


def sample(seed: int, n: int, k: int) -> list:
    return sorted(random.Random(seed ^ SALT).sample(range(n), min(k, n)))


def check(rec: dict, cfg: dict, traffic: dict, seed: int, device) -> list:
    """(name, value, bound, "max" or "min") for each number compared."""
    import refstark
    idx = sample(seed, rec["completed"], traffic["check_claims"])
    t0 = time.perf_counter()
    setup = refstark.Setup(cfg["steps"], cfg, device)
    diff = proofs_diff = 0
    group = traffic["check_group"]
    steps_s = {}
    for lo in range(0, len(idx), group):
        part = [rec["proofs"][i] for i in idx[lo:lo + group]]
        want = refstark.prove([inp for inp, _ in part], cfg["steps"],
                              cfg["round_constants"], cfg, device, setup,
                              steps_s)
        for (_, got), w in zip(part, want):
            d = differing(got, w)
            diff += d
            proofs_diff += d > 0
    rec["check_s"] = time.perf_counter() - t0
    print(f"portbench: reference check of {len(idx)} of {rec['completed']} "
          f"proofs in {rec['check_s']:.3f} s; its steps (s): " + ", ".join(
              f"{k} {v:.3f}" for k, v in steps_s.items()),
          file=sys.stderr, flush=True)
    out = [("proofs_checked", len(idx), 1, "min"),
           ("sections_differing", diff, 0, "max"),
           ("proofs_differing", proofs_diff, 0, "max"),
           ("claims_failed", rec["failed"], 0, "max")]
    if "rank_proofs_differing" in rec:
        out.append(("rank_proofs_differing", rec["rank_proofs_differing"],
                    0, "max"))
    return out


def holds(value, bound, kind) -> bool:
    return value <= bound if kind == "max" else value >= bound
