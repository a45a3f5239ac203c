"""Carry a reference bank's streaming state over into the port.

The reference ``ChannelizedBank`` carries ``(tail, chain_state)``: the PFB
tail and one state tuple per stage, in chain order (a ``Program`` carries
the chain state alone).  The port keeps the same trees, so a reference
bank can run k blocks, hand its state over, and both continue on the same
input.  The leaves are complex64 (PFB, FIR, bandpass and resampler tails,
the FM discriminator's previous sample), float32 (AGC gain, NR tails and
floor, IIR state, the sync-AM phase and frequency), int32 (NCO phases
including the RDS tap's, AGC and squelch hang, ADPCM codec state) and bool
(squelch gate).  The reference keeps complex leaves packed as (..., 2)
float32 on its device; the caller unpacks them to complex64 while fetching
the tree to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from openwebrx_tpu_torch import resolve_device
from openwebrx_tpu_torch.runtime.chain import tree_map

_DTYPES = {np.dtype(np.complex64), np.dtype(np.float32), np.dtype(np.int32),
           np.dtype(np.bool_)}


def bank_state_from_numpy(tree, device="cuda"):
    """Tree of numpy arrays (complex64, float32, int32, bool) → the same
    tree of tensors on ``device``, ready to assign to ``bank.state``."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype not in _DTYPES:
            raise TypeError(f"state leaf of dtype {a.dtype} (shape {a.shape}) "
                            "has no counterpart in the port's state")
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return tree_map(leaf, tree)
