"""Helpers of the port's tests (this module holds no tests).

- `JaxChild`: a JAX computation in a child process, started when a test
  module starts and running while its other tests do. The JAX compile
  is nearly all of its cost; integer results are exact at any XLA
  optimisation level, so the child compiles at the lowest. The child
  dies with its parent (PR_SET_PDEATHSIG), so a run cut short never
  leaves a compile running.
- `refusing_host_tables`: within it, the host functions that build a
  domain table one point at a time raise, so a set-up that calls one
  fails.
"""

import atexit
import contextlib
import os
import pickle
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

_PRELUDE = """
import ctypes, os, pickle, signal, sys
ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
if os.getppid() != int(sys.argv[1]):
    sys.exit(1)
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
inputs = dict(np.load(sys.argv[2] + "/inputs.npz"))
outputs = {}
"""
_EPILOGUE = """
with open(sys.argv[2] + "/outputs.pkl", "wb") as f:
    pickle.dump(outputs, f)
"""


class JaxChild:
    """Runs `code` in a child process with `devices` virtual CPU devices:
    it reads `inputs` (the numpy arrays given here, by name) and fills
    the dict `outputs`, which `result()` returns once the child is
    done."""

    def __init__(self, code: str, workdir: Path, devices: int = 1,
                 **inputs):
        self.workdir = Path(workdir)
        np.savez(self.workdir / "inputs.npz", **inputs)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if "host_platform_device_count" not in f]
        env["XLA_FLAGS"] = " ".join(flags + [
            f"--xla_force_host_platform_device_count={devices}",
            "--xla_backend_optimization_level=0",
            "--xla_llvm_disable_expensive_passes=true"])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _PRELUDE + code + _EPILOGUE,
             str(os.getpid()), str(self.workdir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        atexit.register(self.proc.kill)
        self._outputs = None

    def result(self, timeout: float) -> dict:
        if self._outputs is None:
            _, stderr = self.proc.communicate(timeout=timeout)
            assert self.proc.returncode == 0, \
                f"JAX child failed:\n{stderr[-4000:]}"
            with open(self.workdir / "outputs.pkl", "rb") as f:
                self._outputs = pickle.load(f)
        return self._outputs

    def stop(self):
        atexit.unregister(self.proc.kill)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


# (module, name) of each host function that builds a table from Python
# ints one point at a time, or on the host where JAX builds it on the
# device.
HOST_TABLE_FUNCTIONS = (
    ("starks_tpu_torch.utils.native", "inv_vanishing2"),
    ("starks_tpu_torch.ops.fused", "powers"),
    ("starks_tpu_torch.utils.hostfield", "multi_inv"),
    ("starks_tpu_torch.utils.hostfield", "eval_poly_at"),
)


@contextlib.contextmanager
def refusing_host_tables():
    def refuse(*args, **kwargs):
        raise AssertionError("a set-up built a table on the host")
    with contextlib.ExitStack() as stack:
        for module, name in HOST_TABLE_FUNCTIONS:
            stack.enter_context(mock.patch(f"{module}.{name}", refuse))
        yield
