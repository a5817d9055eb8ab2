"""The JAX reference digest that tests/test_torch_config.py holds the
port's custom-config proof to (JAX_SHA256, JAX_BYTES there).

    JAX_PLATFORMS=cpu python tests/_torch_config_digest.py

proves the test's claim with the JAX package, `starks_tpu.prover.
mk_mimc_proof` under the test's custom StarkConfig, and prints the byte
length and the SHA-256 of `starks_tpu.serialize.serialize_v1` of the
proof. It takes minutes to compile on the CPU, which is why the test
keeps the digest instead of calling JAX, and why pytest does not collect
this file.
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from starks_tpu.config import StarkConfig  # noqa: E402
from starks_tpu.prover import mk_mimc_proof  # noqa: E402
from starks_tpu.serialize import serialize_v1  # noqa: E402

# The claim and config of tests/test_torch_config.py.
STEPS = 64
CONSTANTS = [(i ** 7) ^ 42 for i in range(16)]
INP = 7
CUSTOM = StarkConfig(extension_factor=4, spot_checks=24, fri_queries=12)


def main():
    wire = serialize_v1(mk_mimc_proof(INP, STEPS, CONSTANTS, config=CUSTOM))
    print(f"JAX_BYTES = {len(wire)}")
    print(f"JAX_SHA256 = {hashlib.sha256(wire).hexdigest()}")


if __name__ == "__main__":
    main()
