"""Frozen protocol configuration (SURVEY.md §6 'Config / flag system').

The port's own copy of `starks_tpu/config.py`: the same dataclass and
the same `REFERENCE` values, so both packages derive identical
transcripts. The port imports nothing of `starks_tpu`.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class StarkConfig:
    # Field: p = 2^256 - 351*2^32 + 1; 2^32 | p-1 (radix-2 NTT to 2^32).
    modulus: int = 2**256 - 351 * 2**32 + 1
    # Multiplicative generator of F_p* used to derive domain roots.
    generator: int = 7
    # LDE blowup: evaluation domain = extension_factor * trace length.
    extension_factor: int = 8
    # STARK spot checks (soundness ~ extension_factor^-spot_checks/...).
    spot_checks: int = 80
    # FRI queries per fold round.
    fri_queries: int = 40
    # FRI fold arity (quartic fold; the fold kernel is specialized to 4).
    fri_fold_arity: int = 4
    # FRI recursion stops when maxdeg_plus_1 <= this; remaining values
    # are sent verbatim.
    fri_base_cutoff: int = 16

    def __post_init__(self):
        assert self.extension_factor & (self.extension_factor - 1) == 0, \
            "extension_factor must be a power of two"
        assert self.fri_fold_arity == 4, \
            "the fold kernel is specialized to arity 4 (ops/plimbs.py)"
        assert self.fri_base_cutoff >= self.fri_fold_arity

    def precision(self, steps: int) -> int:
        return steps * self.extension_factor

    def eval_generator(self, steps: int) -> int:
        """G2: generator of the size-precision evaluation domain."""
        return pow(self.generator,
                   (self.modulus - 1) // self.precision(steps), self.modulus)


REFERENCE = StarkConfig()
