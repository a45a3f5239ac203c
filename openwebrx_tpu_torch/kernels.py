"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on first use by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``build/kernels/`` at
the root of the checkout, and loaded with ``ctypes``.  The library name
carries a hash of the source and the flags, so an edited kernel rebuilds and
an unchanged one is reused.  Nothing is compiled or loaded at import: the
CPU tests import every module of the port on machines without ``nvcc``.
The server builds every kernel before it listens (:func:`build_all`) and
loads every library in its warm-up (:func:`load_all`); anything else loads
a library at its first launch.

Every C entry point takes raw device pointers, sizes and a ``cudaStream_t``
and returns ``cudaGetLastError()`` after its launch.
:meth:`CudaKernel.launch` takes the device the tensors lie on, makes it the
current device for the call (a thread's current device is device 0 until
it is set, and a launch on another device's stream fails), passes that
device's current PyTorch stream, and raises when the return is not 0.

A launch made while a block step is captured into a CUDA graph
(``runtime/chain.py`` ``GraphStep``) is counted into the capture's record
(:func:`recording`), not into ``launches``: the capture runs nothing.
Every replay of the graph then adds the record to the counts
(:func:`count_replay`), so ``launches`` stays the number of times each
kernel ran.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc"))
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One ``csrc/*.cu`` source: its build (with optional preprocessor
    ``defines``, ``NAME=VALUE``), its C entry point and the number of times
    the port launched it (``launches``)."""

    def __init__(self, source: str, symbol: str, argtypes: list,
                 defines: tuple[str, ...] = ()):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{h}.so"

    def build(self) -> float:
        """Compile the source unless an up-to-date library exists; return
        the seconds spent compiling (0.0 when reused)."""
        with self._lock:
            lib = self.library_path()
            if lib.exists():
                return 0.0
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {self.source.name}:\n{self.build_log}")
            os.replace(tmp, lib)
            return time.perf_counter() - t0

    def _load(self):
        if self._fn is None:
            self.build()
            with self._lock:
                if self._fn is None:
                    self._lib = ctypes.CDLL(str(self.library_path()))
                    fn = getattr(self._lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    err = getattr(self._lib, "owrx_error_string")
                    err.argtypes = [ctypes.c_int]
                    err.restype = ctypes.c_char_p
                    self._fn = fn
        return self._fn

    @property
    def loaded(self) -> bool:
        """Whether the library is loaded and its entry point bound."""
        return self._fn is not None

    def function(self, symbol: str, argtypes: list, restype):
        """Another C function of the library, built and loaded first."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
        return fn

    def launch(self, device, *args) -> None:
        """Call the C entry point with ``args`` and the current stream of
        ``device``, under ``device`` as the current device; raise on a
        launch error, count on success."""
        import torch
        fn = self._load()
        with torch.cuda.device(device):
            rc = fn(*args, stream_handle(device))
        if rc != 0:
            msg = self._lib.owrx_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} ({msg})")
        record = getattr(_capture, "record", None)
        if record is None:
            self.launches += 1
        else:
            record[self] = record.get(self, 0) + 1


# the launch record of the capture this thread is making, if any
_capture = threading.local()


@contextlib.contextmanager
def recording():
    """Count the launches this thread makes inside the block into a dict
    (kernel → launches) instead of ``launches``: a CUDA graph capture
    records the launches without running them."""
    outer = getattr(_capture, "record", None)
    _capture.record = record = {}
    try:
        yield record
    finally:
        _capture.record = outer


def count_replay(record: dict) -> None:
    """One replay of a captured graph ran every launch of its ``record``."""
    for kernel, n in record.items():
        kernel.launches += n


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# fold_launch(u, bank, v, n_time, m, p_taps, stream)
FOLD = CudaKernel("fold.cu", "fold_launch", [_P, _P, _P, _I, _I, _I, _P])
# adpcm_launch(samples, pred0, idx0, prev, idxs, out, stride, pred, idx,
#              lanes, strides, stream)
ADPCM = CudaKernel("adpcm.cu", "adpcm_launch",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P])

# iir_launch(x, x_prev, y_prev, y, x_last, y_last, rows, n, b0, b1, a1, stream)
IIR = CudaKernel("iir.cu", "iir_launch",
                 [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P])
# agc_launch(x, gain0, hang0, y, gain, hang, rows, n, chunk, attack, decay,
#            hang_chunks, reference, max_gain, stream)
AGC = CudaKernel("agc.cu", "agc_launch",
                 [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _F, _P])

# squelch_launch(x, level, open0, hang0, y, power_db, open, hang, rows, n,
#                window, cplx, level_per_row, hang_windows, then the plan of
#                ops/squelch.py squelch_plan: cluster, warps, slice, chunk,
#                stages, vec; stream)
SQUELCH = CudaKernel("squelch.cu", "squelch_launch",
                     [_P, _P, _P, _P, _P, _P, _P, _P, *[_I] * 12, _P])
# adpcm_seq_launch(samples, pred0, idx0, out, stride, pred, idx, rows, ns,
#                  forced, diag, stream)
ADPCM_SEQ = CudaKernel("adpcm_seq.cu", "adpcm_seq_launch",
                       [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P])

ALL = (FOLD, ADPCM, IIR, AGC, SQUELCH, ADPCM_SEQ)


def build_all() -> float:
    """Build every kernel of ``ALL`` (one nvcc each, all at once; a library
    already built is reused); return the wall seconds it took."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(ALL)) as pool:
        list(pool.map(lambda k: k.build(), ALL))
    return time.perf_counter() - t0


def load_all() -> None:
    """Build (where needed) and load every library of ``ALL``."""
    for k in ALL:
        k._load()


def stream_handle(device) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
