"""PyTorch/CUDA port of the openwebrx_tpu DSP path, for an NVIDIA H100.

The JAX package ``openwebrx_tpu`` is the reference and this package imports
nothing from it (not even its numpy-only modules: importing ``openwebrx_tpu``
configures and imports JAX).  Plain tensor code is PyTorch; the polyphase
fold, the ADPCM audio encoder, the exact ADPCM row encoder of the
waterfall, the first-order IIR, the AGC and the squelch are CUDA kernels
written by hand (``csrc/``).

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
card that default raises: the port never falls back to the CPU on its own.
``device="cpu"`` runs the plain PyTorch version of every kernel, which is
what the CPU tests compare against the JAX reference.

The host side (``core``, ``sources``, ``services``, ``digimodes``, ``aprs``,
``reporting``, ``web``, ``sdr``, ``native``) is the reference's, copied with
the package name changed; ``python -m openwebrx_tpu_torch`` serves browser
listeners from the port's ``DeviceRuntime``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# cuDNN runs float32 convolutions in TF32 by default, which keeps about three
# decimal digits: the FIR decimator's F.conv1d would then leave float32
# parity with the reference.  Matmuls are full float32 by default already;
# both switches are pinned here so every module of the port computes in
# float32.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """Validate an explicit device choice; raise when CUDA is asked for and
    there is no card (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device``."""
    for t in tensors:
        if t.device != device:
            raise ValueError(
                f"tensor on {t.device} but the call runs on {device}")
