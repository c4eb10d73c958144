"""Test config: force an 8-device CPU mesh before jax is imported.

This is the reference's single-box ``mpirun -np N`` trick
(ref: .github/workflows/cmake.yml) translated to JAX: multi-device code
paths run on virtual host devices, periodic wrap makes results
rank-count-invariant.

The CPU code is generated without FMA instructions: XLA contracts a
multiply-add into an FMA or not depending on how it fuses a program, so
with FMA two programs that compute the same sweep (``step`` and
``rollout``, fused and composed sweeps) could differ in the last bit,
and the tests that require them to agree exactly would test fusion
decisions instead of the sweep.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
if "xla_cpu_max_isa" not in _flags:
    _flags += " --xla_cpu_max_isa=SSE4_2"
os.environ["XLA_FLAGS"] = _flags.strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
