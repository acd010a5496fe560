"""supersampler_tpu_torch — the PyTorch/CUDA port of supersampler_tpu.

Same layout and names as the JAX package; the scan, sweep and walk
kernels are hand-written CUDA for Hopper (``csrc/``), each with a plain
PyTorch twin that runs on CPU tensors. The port imports nothing of
supersampler_tpu: it keeps its own copies of the host layer it uses
(``core/scalar.py``, ``io/``, ``native.py``, which builds the repo's
shared ``csrc/spsp_*.c`` into a library of its own).
"""

from __future__ import annotations

import os

import torch

#: environment variable naming the device the CLI runs on (the role
#: JAX_PLATFORMS plays for the JAX package)
DEVICE_ENV = "TORCH_DEVICE"


def default_device() -> torch.device:
    """The device named by $TORCH_DEVICE (default ``cuda``). Raises when
    CUDA is asked for and absent: the port never drops to the CPU on
    its own."""
    dev = torch.device(os.environ.get(DEVICE_ENV, "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{DEVICE_ENV}={dev} but torch.cuda.is_available() is false; "
            f"set {DEVICE_ENV}=cpu to run the plain path on the CPU")
    return dev
