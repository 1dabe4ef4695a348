"""Worker process for the multi-host test: joins a 2-process distributed
runtime (4 virtual CPU devices each), accumulates its local streams'
spectra through MultiHostPsdStep, writes the combined result to a file.

Usage: python multihost_worker.py <process_id> <coordinator> <outfile>
       [N] [backend]
"""

import os
import sys

proc_id = int(sys.argv[1])
coordinator = sys.argv[2]
outfile = sys.argv[3]
N_arg = int(sys.argv[4]) if len(sys.argv) > 4 else 64
backend = sys.argv[5] if len(sys.argv) > 5 else "auto"

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rtl_power_fftw_tpu.parallel.multihost import (  # noqa: E402
    MultiHostPsdStep, initialize)

initialize(coordinator, num_processes=2, process_id=proc_id)

N, F = N_arg, 16

if backend == "bigfft":
    # Sequence parallelism across processes: ONE transform sharded over
    # the 8-device global mesh; the all_to_all transpose crosses the
    # process boundary (the DCN leg) for real.
    from rtl_power_fftw_tpu.parallel.bigfft import ShardedLargeFFTPsd
    from rtl_power_fftw_tpu.parallel.multihost import global_stream_mesh

    F = 4
    frames = np.random.default_rng(2000).integers(
        0, 256, (F, 2 * N), dtype=np.uint8)
    step = ShardedLargeFFTPsd(global_stream_mesh(), N, F)
    combined, used = step.call_global(frames)
    assert used == F
    np.save(outfile, combined)
    print(f"[p{proc_id}] bigfft combined[0:3] = {combined[:3]}")
    sys.exit(0)

step = MultiHostPsdStep(N, F, backend=backend)
assert step.streams_global == 8 and step.streams_local == 4

# Global stream s is owned by process s // 4; identical data generation
# everywhere keeps the test's golden comparison simple.
rng_frames = [
    np.random.default_rng(1000 + s).integers(0, 256, (step.F, 2 * N),
                                             dtype=np.uint8)
    for s in range(step.streams_global)
]
local = np.stack(rng_frames[proc_id * 4:(proc_id + 1) * 4])
n_valid = np.full((4,), step.F, dtype=np.int32)

per_stream, combined = step(local, n_valid)
np.save(outfile, combined)
print(f"[p{proc_id}] combined[0:3] = {combined[:3]}")
