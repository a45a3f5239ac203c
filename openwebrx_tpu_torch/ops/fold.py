"""Polyphase fold: the PFB branch filters, v[t, p] = Σ_{j<P} u[t+j, p]·B[j, p].

Counterpart of ``openwebrx_tpu/ops/pallas_fold.py`` (``polyphase_fold``).
On a CUDA tensor the sum runs in the hand-written kernel
``csrc/fold.cu``; on a CPU tensor it runs in :func:`polyphase_fold_plain`,
a loop over the P shifted slices that the CPU tests hold against the
reference and that ``chip_smoke.py`` holds the kernel against on the card.

The output has n_time − P + 1 rows (as the reference code computes; its
docstring's n_time − P is wrong).
"""

from __future__ import annotations

import torch

from openwebrx_tpu_torch import check_on, resolve_device
from openwebrx_tpu_torch.kernels import FOLD

MAX_TAPS = 25      # the reference kernel's limit (window pad 24 = P − 1)


def polyphase_fold_plain(u: torch.Tensor, bank_t: torch.Tensor,
                         p_taps: int) -> torch.Tensor:
    """Plain PyTorch version: u (n_time, M) complex64, bank_t (P, M)
    float32 → v (n_time − P + 1, M) complex64."""
    n_out = u.shape[0] - p_taps + 1
    ur = torch.view_as_real(u)                       # (n_time, M, 2)
    acc = ur[0:n_out] * bank_t[0][:, None]
    for j in range(1, p_taps):
        acc = acc + ur[j:j + n_out] * bank_t[j][:, None]
    return torch.view_as_complex(acc.contiguous())


def polyphase_fold(u: torch.Tensor, bank_t: torch.Tensor, p_taps: int,
                   device="cuda") -> torch.Tensor:
    """u (n_time, M) complex64, bank_t (P, M) float32 (tap-major, already
    time-reversed) → v (n_time − P + 1, M) complex64.

    Runs the CUDA kernel on a CUDA device and the plain version on the CPU;
    the tensors must lie on ``device``."""
    dev = resolve_device(device)
    check_on(dev, u, bank_t)
    if u.dtype != torch.complex64 or u.dim() != 2:
        raise ValueError(f"u must be (n_time, M) complex64, got "
                         f"{tuple(u.shape)} {u.dtype}")
    n_time, m = u.shape
    if bank_t.dtype != torch.float32 or tuple(bank_t.shape) != (p_taps, m):
        raise ValueError(f"bank_t must be ({p_taps}, {m}) float32, got "
                         f"{tuple(bank_t.shape)} {bank_t.dtype}")
    if not 1 <= p_taps <= MAX_TAPS:
        raise ValueError(f"p_taps must be in 1..{MAX_TAPS}, got {p_taps}")
    if n_time < p_taps:
        raise ValueError(f"n_time {n_time} < p_taps {p_taps}")
    if dev.type == "cpu":
        return polyphase_fold_plain(u, bank_t, p_taps)
    if not (u.is_contiguous() and bank_t.is_contiguous()):
        raise ValueError("polyphase_fold kernel needs contiguous u and bank_t")
    v = torch.empty((n_time - p_taps + 1, m), dtype=torch.complex64,
                    device=dev)
    FOLD.launch(dev, u.data_ptr(), bank_t.data_ptr(), v.data_ptr(), n_time, m,
                p_taps)
    return v
