"""Device timing, the GPU gate and the device peak table.

Timing protocol (mirroring the reference's 100-iteration averages,
test_double.cu:201-488):

  1. the step function threads a state through itself — a serial data
     dependency no caching or reordering layer can collapse;
  2. warm up the step once (compilation is not timed);
  3. run the iterations and end them with one block_until_ready.
"""

from __future__ import annotations

import time

# Published dense peaks per device, keyed by jax's `device_kind`.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part, without
# sparsity), at the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_tops": 1979.0,
        "fp64_tensor_tflops": 67.0,
        "tf32_tflops": 495.0,
        "hbm_tb_per_s": 3.35,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of `device_kind`. An unknown device is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; known: {sorted(PEAKS)}") from None


def require_gpu() -> None:
    """Exit the process unless JAX's default device is a GPU: the timing
    entry points measure a card and have nothing to say about any other
    backend."""
    import sys

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"[bench] no GPU: jax.devices()[0].platform={platform!r}",
              file=sys.stderr)
        sys.exit(1)


def chained_time(step, state, iters: int):
    """Time `step(state) -> state` (jitted, serially dependent through
    state). Returns (seconds_per_iteration, final_state)."""
    import jax

    state = jax.block_until_ready(step(state))   # warm-up / compile
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / iters, state


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`name, power.limit` of the first card), read in a child process that
    does not touch JAX. A card below its full power limit runs slower
    under load, so every time or rate is reported beside this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]
