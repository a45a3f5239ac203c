"""The upload's host copy (``runtime/chain.py`` ``pinned_copy``) on the CPU,
in plain host memory (``pin=False``): for every packed form a source hands
the runtime, the staged copy holds the block's bytes, keeps them when the
source writes its buffer again, becomes the same input block, and is made
without ``Tensor.copy_``.  On a card, inside ``DeviceRuntime._upload``, it
is held by ``tests/test_torch_card.py`` ``TestStagingOnCard``."""

import numpy as np
import pytest
import torch

from openwebrx_tpu_torch.runtime.chain import as_input_block, host_pack_complex, pinned_copy

BLOCK = 1024
KINDS = ["uint8", "int16", "float32", "complex64"]


def _packed(kind, seed):
    """A packed (BLOCK, 2) block as ``DeviceRuntime._upload`` stages it."""
    rng = np.random.default_rng(seed)
    if kind == "complex64":
        return host_pack_complex((rng.standard_normal(BLOCK)
                                  + 1j * rng.standard_normal(BLOCK)).astype(np.complex64))
    if kind == "float32":
        return rng.standard_normal((BLOCK, 2)).astype(np.float32)
    info = np.iinfo(kind)
    return rng.integers(info.min, info.max, (BLOCK, 2), dtype=kind, endpoint=True)


@pytest.mark.parametrize("kind", KINDS)
def test_the_staged_copy_keeps_the_block_when_the_source_writes_its_buffer(kind):
    source = _packed(kind, 0)              # the source's one buffer
    want = source.copy()
    staged = pinned_copy(source, pin=False)
    source[...] = _packed(kind, 1)
    assert staged.shape == want.shape and staged.numpy().dtype == want.dtype
    assert staged.numpy().tobytes() == want.tobytes()
    got = as_input_block(staged, BLOCK, True, torch.device("cpu"))
    ref = as_input_block(torch.from_numpy(want).clone(), BLOCK, True, torch.device("cpu"))
    assert got.dtype == torch.complex64
    assert torch.view_as_real(got).numpy().tobytes() == torch.view_as_real(ref).numpy().tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_the_copy_does_not_go_through_tensor_copy_(monkeypatch, kind):
    def refused(*args, **kwargs):
        raise AssertionError("Tensor.copy_ splits a block over the OpenMP team")

    monkeypatch.setattr(torch.Tensor, "copy_", refused)
    source = _packed(kind, 2)
    assert pinned_copy(source, pin=False).numpy().tobytes() == source.tobytes()
