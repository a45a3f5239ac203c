"""The device fixture and the card report of the reference's cases carried
onto the port (tests/test_torch_ref_*.py).

Every carried case takes ``device``: ``"cpu"`` runs the port's plain
versions, ``"cuda"`` carries the ``cuda`` marker, skips without a card and
otherwise runs the port on the card, through the hand-written kernels
wherever the path has them.  On the card the fixture wraps every plain
version of a kernel so that a CUDA tensor reaching one fails the case
(at the call and again at teardown, should a runtime thread have caught
it).  The carried files import this module, no jax and nothing of
``openwebrx_tpu``, and need nothing of tests/conftest.py.

``card_report`` (module scope, autouse where imported) writes one line on
the terminal when a carried file finishes (not in an xdist worker, whose
output nobody reads)::

    [torch-ref] {"file": ..., "cuda_cases": N, "cuda_passed": N,
                 "launches": {"fold.cu": N, ...},
                 "cases_launching": {"fold.cu": N, ...}}

``cuda_cases`` are the file's selected cases on the card, ``cuda_passed``
those of them that passed, ``launches`` the kernel launches made while the
file ran (``kernels.CudaKernel.launches``, counted in this process) and
``cases_launching`` how many of the passed cases launched each kernel.
"""

import functools
import importlib
import json
from pathlib import Path

import pytest
import torch

from openwebrx_tpu_torch import kernels

REPORT_PREFIX = "[torch-ref] "
# every plain version of a hand-written kernel, by module of the port
PLAIN_VERSIONS = (
    ("ops.fold", "polyphase_fold_plain"),
    ("ops.adpcm", "encode_strides_plain"),
    ("ops.adpcm", "adpcm_encode_plain"),
    ("ops.adpcm", "adpcm_encode_seq_plain"),
    ("ops.iir", "first_order_apply_plain"),
    ("ops.agc", "agc_apply_plain"),
    ("ops.squelch", "squelch_apply_plain"),
)
# node id → the kernels a cuda case launched
_CASE_KERNELS: dict[str, set[str]] = {}


def _launches() -> dict[str, int]:
    return {k.source.name: k.launches for k in kernels.ALL}


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _refusing_cuda(name, fn, reached):
    @functools.wraps(fn)
    def plain(*args, **kwargs):
        if any(t.is_cuda for t in _tensors((args, kwargs))):
            reached.append(name)
            raise AssertionError(f"{name} reached on a CUDA tensor")
        return fn(*args, **kwargs)
    return plain


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request, monkeypatch):
    if request.param == "cpu":
        yield "cpu"
        return
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    reached = []
    for module, name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"openwebrx_tpu_torch.{module}")
        monkeypatch.setattr(mod, name,
                            _refusing_cuda(f"{module}.{name}", getattr(mod, name), reached))
    before = _launches()
    yield "cuda"
    torch.cuda.synchronize()
    _CASE_KERNELS[request.node.nodeid] = {
        n for n, v in _launches().items() if v > before[n]}
    assert not reached, f"plain versions reached on the card: {reached}"


def on_card(nodeid: str) -> bool:
    """Whether a carried case's node id is its ``cuda`` case."""
    return "[" in nodeid and "cuda" in nodeid.rsplit("[", 1)[1].rstrip("]").split("-")


@pytest.fixture(scope="module", autouse=True)
def card_report(request):
    before = _launches()
    yield
    reporter = request.config.pluginmanager.get_plugin("terminalreporter")
    if reporter is None or hasattr(request.config, "workerinput"):
        return
    path = Path(request.module.__file__)

    def mine(nodeid):
        return nodeid.split("::", 1)[0].rsplit("/", 1)[-1] == path.name and on_card(nodeid)

    cases = [it.nodeid for it in request.session.items if mine(it.nodeid)]
    passed = [r.nodeid for r in reporter.stats.get("passed", [])
              if r.when == "call" and mine(r.nodeid)]
    after = _launches()
    line = REPORT_PREFIX + json.dumps({
        "file": path.name, "cuda_cases": len(cases), "cuda_passed": len(passed),
        "launches": {n: after[n] - before[n] for n in after},
        "cases_launching": {n: sum(n in _CASE_KERNELS.get(c, ()) for c in passed)
                            for n in after}})
    capture = request.config.pluginmanager.get_plugin("capturemanager")
    if capture is None:
        reporter.write_line(line)
        return
    with capture.global_and_fixture_disabled():
        reporter.write_line(line)
