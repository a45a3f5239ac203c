"""The port's host modules are the reference's, held to it file by file.

``openwebrx_tpu_torch`` keeps its own copy of every host module the entry
point reaches, and of the golden-parity harness (``testing``: the seeded
capture and the numpy/scipy oracle), since it may not import the JAX
package, whose ``__init__`` imports jax.  Each copy equals the reference's
text with the package name changed (``openwebrx_tpu.`` → ``openwebrx_tpu_torch.``), except the
modules in ``DIVERGES``, each with the reason it differs; the shipped data
files are equal byte for byte.  The entry point imports and runs with jax
made unimportable, and so do the card-only tests.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "openwebrx_tpu"
PORT = REPO / "openwebrx_tpu_torch"
HOST_DIRS = ("core", "sources", "aprs", "digimodes", "reporting", "services", "web",
             "testing")
HOST_FILES = sorted(
    [str(f.relative_to(REF)) for d in HOST_DIRS for f in (REF / d).rglob("*.py")]
    + ["native.py", "sdr.py", "__main__.py"])
DATA_FILES = sorted(str(f.relative_to(REF)) for f in (REF / "data").rglob("*")
                    if f.is_file() and "__pycache__" not in f.parts)

DIVERGES = {
    "core/feature.py": "the 'core' probe checks that torch imports, not jax",
    "core/metrics.py": "the span metric (SpanMetric, SpanLog): the device runtime's log of "
                       "timed spans, shown as a summary of each span's count and seconds",
    "sdr.py": "get_device builds the port's DeviceRuntime on SdrService.device; "
              "warm runs the port's warm_up on a throwaway runtime a source",
    "web/settings.py": "the profile endpoint captures torch.profiler, not "
                       "jax.profiler; the log endpoint's default logger is "
                       "the port's package",
    "web/server.py": "--device (no CPU fallback; kernels built and, on a "
                     "card, every source's banks warmed up before the server "
                     "listens), the cluster join through the port's "
                     "torch.distributed init_cluster on that device, --config",
    "__main__.py": "every argument but 'admin ...' goes to the server: the "
                   "reference's parse_known_args takes an option's value "
                   "(--port 8073, --device cpu) for a subcommand",
}


def renamed(text: str) -> str:
    return text.replace("openwebrx_tpu.", "openwebrx_tpu_torch.").replace(
        "from openwebrx_tpu import", "from openwebrx_tpu_torch import")


@pytest.mark.parametrize("rel", HOST_FILES)
def test_copy_equals_reference(rel):
    port = PORT / rel
    assert port.is_file(), f"the port has no {rel}"
    same = port.read_text() == renamed((REF / rel).read_text())
    if rel in DIVERGES:
        assert not same, f"{rel} equals the reference: drop it from DIVERGES"
    else:
        assert same, f"{rel} differs from the reference after the rename"


def test_every_port_host_module_has_a_reference():
    port = sorted([str(f.relative_to(PORT)) for d in HOST_DIRS
                   for f in (PORT / d).rglob("*.py")]
                  + [f for f in ("native.py", "sdr.py", "__main__.py")
                     if (PORT / f).exists()])
    assert port == HOST_FILES
    assert set(DIVERGES) <= set(HOST_FILES)


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_file_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


def _run_without_jax(script: str, tmp_path):
    """Run ``script`` in a fresh interpreter where ``import jax`` fails and
    the port's data directory is ``tmp_path``."""
    prelude = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        from openwebrx_tpu_torch.core.config import CoreConfig
        CoreConfig.defaults["data_directory"] = {str(tmp_path)!r}
        CoreConfig.defaults["temporary_directory"] = {str(tmp_path)!r}
    """)
    return subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(script)], cwd=REPO,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
        capture_output=True, text=True, timeout=120)


def test_entry_point_runs_without_jax(tmp_path):
    """The entry point, the server, the settings API, the service engine and
    every digimode import with jax unimportable; ``--help`` and ``admin``
    run; nothing of the JAX package is loaded."""
    proc = _run_without_jax("""
        import importlib, pkgutil, runpy
        import openwebrx_tpu_torch.__main__ as entry
        import openwebrx_tpu_torch.web.server
        import openwebrx_tpu_torch.web.settings
        import openwebrx_tpu_torch.services.engine
        import openwebrx_tpu_torch.digimodes as dm
        for m in pkgutil.iter_modules(dm.__path__):
            importlib.import_module(f"openwebrx_tpu_torch.digimodes.{m.name}")
        assert entry.main(["admin", "adduser", "alice", "--password", "pw"]) == 0
        assert entry.main(["admin", "listusers"]) == 0
        sys.argv = ["openwebrx_tpu_torch", "--help"]
        try:
            runpy.run_module("openwebrx_tpu_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        leaked = sorted(k for k in sys.modules if k == "openwebrx_tpu"
                        or k.startswith("openwebrx_tpu."))
        print("LEAKED", leaked)
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "added user alice" in proc.stdout and "  alice" in proc.stdout
    assert "--device" in proc.stdout and "--signal-demo" in proc.stdout
    assert "LEAKED []" in proc.stdout
    assert (tmp_path / "users.json").is_file()


def _pytest_without_jax(args, tmp_path):
    """pytest ``args`` (without tests/conftest.py, which imports jax) in an
    interpreter where ``import jax`` fails → (process, its summary line)."""
    proc = _run_without_jax(f"""
        import pytest
        rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q",
                          "-p", "no:xdist", *{list(args)!r}])
        leaked = sorted(k for k in sys.modules if k == "openwebrx_tpu"
                        or k.startswith("openwebrx_tpu."))
        print("RC", int(rc))
        print("LEAKED", leaked)
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr
    summary = [line for line in proc.stdout.splitlines() if " in " in line
               and ("passed" in line or "skipped" in line or "error" in line)]
    return proc, summary[-1] if summary else ""


def test_card_tests_collect_without_jax(tmp_path):
    """The card's command (``pytest --noconftest -m cuda
    tests/test_torch_card.py tests/test_torch_golden.py``) on a machine
    without jax: both files collect, the golden design cases pass, the card
    cases skip without a card, and nothing of the JAX package is loaded."""
    import torch
    proc, summary = _pytest_without_jax(["tests/test_torch_card.py"], tmp_path)
    assert "RC 0" in proc.stdout and "LEAKED []" in proc.stdout, proc.stdout
    assert "error" not in summary and "failed" not in summary, proc.stdout
    if not torch.cuda.is_available():
        assert "skipped" in summary and "passed" not in summary, summary
    proc, summary = _pytest_without_jax(
        ["tests/test_torch_golden.py", "-k", "design"], tmp_path)
    assert "RC 0" in proc.stdout and "LEAKED []" in proc.stdout, proc.stdout
    assert summary.startswith("3 passed"), proc.stdout
