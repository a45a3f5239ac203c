"""Subprocess decoder pipelines: stream audio/IQ bytes through external
binaries and collect their output.

Reference: ``csdr/module/__init__.py:173-231`` (PopenModule with pump
threads, LineBasedModule line splitting, JsonParser) and the ExecModule
restart semantics (``csdr/module/toolbox.py:78-91``).  This is the host
glue that keeps all the reference's external decoders working (direwolf,
rtl_433, multimon-ng, dump1090, dumphfdl, dumpvdl2, acarsdec, redsea,
lame, …): the TPU chains produce demodulated streams, these pipelines
parse the binaries' stdout back into events.
"""

from __future__ import annotations

import json
import logging
import os
import select
import subprocess
import threading

logger = logging.getLogger(__name__)


def _iter_chunks(fd: int):
    """Yield chunks from *fd* as soon as they arrive, until EOF.

    Uses a non-blocking fd + select so a partial line is delivered the
    moment the child flushes it: some environments (sandboxed pipes) do
    not return partial data from large blocking read() calls, which
    stalls buffered line iteration until 8 KiB accumulate.
    """
    os.set_blocking(fd, False)
    try:
        poller = select.poll()
        poller.register(fd, select.POLLIN | select.POLLHUP)
        while True:
            poller.poll()
            try:
                chunk = os.read(fd, 65536)
            except BlockingIOError:
                continue
            except (OSError, ValueError):
                return
            if not chunk:
                return
            yield chunk
    finally:
        # restore blocking mode so any later read through the buffered
        # Popen.stdout wrapper (same underlying fd) keeps normal semantics
        try:
            os.set_blocking(fd, True)
        except OSError:
            pass


def _iter_lines(fd: int):
    buf = b""
    for chunk in _iter_chunks(fd):
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            yield line
    if buf:
        yield buf


class SubprocessPipeline:
    """feed(bytes) → binary's stdin; stdout lines → on_line(bytes).

    Writer runs on the caller's thread (device runtime / pump); a reader
    thread drains stdout so the child never blocks.  restart() replaces
    the child process keeping the pipeline object (reference ExecModule
    setArgs/restart).
    """

    def __init__(self, commandline: list[str], on_line, line_based: bool = True,
                 on_exit=None, on_meta_line=None, on_stderr_line=None):
        self.commandline = commandline
        self.on_line = on_line
        self.line_based = line_based
        self.on_exit = on_exit
        self.on_meta_line = on_meta_line
        # decoders that report status on stderr (dablin ensemble info,
        # nrsc5 station lines) get a line-drain thread instead of DEVNULL
        self.on_stderr_line = on_stderr_line
        self._proc: subprocess.Popen | None = None
        self._reader: threading.Thread | None = None
        self._meta_read_fd: int | None = None
        self._lock = threading.RLock()
        self._closed = False
        self.start()

    def start(self):
        import os
        with self._lock:
            cmd = self.commandline
            pass_fds, meta_wfd = (), None
            if self.on_meta_line is not None:
                # decoders with a side metadata channel (digiham-style
                # --fifo/meta-fd): give the child a pipe write end and
                # substitute its fd number into the command line
                rfd, meta_wfd = os.pipe()
                os.set_inheritable(meta_wfd, True)
                self._meta_read_fd = rfd
                pass_fds = (meta_wfd,)
                cmd = [arg.format(meta_fd=meta_wfd) if "{meta_fd}" in arg
                       else arg for arg in cmd]
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=(subprocess.PIPE if self.on_stderr_line is not None
                        else subprocess.DEVNULL),
                pass_fds=pass_fds)
            if self.on_stderr_line is not None:
                threading.Thread(target=self._drain_stderr,
                                 args=(self._proc,), daemon=True,
                                 name=f"err-{self.commandline[0]}").start()
            if meta_wfd is not None:
                os.close(meta_wfd)  # child holds the only write end now
                threading.Thread(target=self._drain_meta, daemon=True,
                                 name=f"meta-{self.commandline[0]}").start()
            self._reader = threading.Thread(target=self._drain, daemon=True,
                                            name=f"pipe-{self.commandline[0]}")
            self._reader.start()

    def _drain_stderr(self, proc):
        try:
            for line in _iter_lines(proc.stderr.fileno()):
                self.on_stderr_line(line.rstrip(b"\r"))
        except (OSError, ValueError):
            pass
        except Exception:
            logger.exception("stderr handler failed")

    def _drain_meta(self):
        rfd = self._meta_read_fd
        try:
            # guard the callback too: on_meta_line may raise OSError/ValueError
            # (e.g. writing to a closed client socket) — that must not kill the
            # reader thread with an unhandled traceback mid-stream
            for line in _iter_lines(rfd):
                self.on_meta_line(line.rstrip(b"\r"))
        except (OSError, ValueError):
            pass
        finally:
            try:
                os.close(rfd)
            except OSError:
                pass

    def _drain(self):
        proc = self._proc
        try:
            fd = proc.stdout.fileno()
            if self.line_based:
                for line in _iter_lines(fd):
                    self.on_line(line.rstrip(b"\r"))
            else:
                for chunk in _iter_chunks(fd):
                    self.on_line(chunk)
        except (OSError, ValueError):
            pass
        finally:
            if self.on_exit is not None and not self._closed:
                try:
                    self.on_exit()
                except Exception:
                    logger.exception("pipeline exit handler failed")

    def feed(self, data: bytes):
        with self._lock:
            if self._proc is None or self._proc.poll() is not None:
                return
            try:
                self._proc.stdin.write(data)
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError):
                logger.warning("decoder %s pipe broken", self.commandline[0])

    def restart(self, commandline: list[str] | None = None):
        if commandline is not None:
            self.commandline = commandline
        self._terminate()
        self.start()

    def _terminate(self):
        with self._lock:
            proc, self._proc = self._proc, None
        if proc is not None:
            try:
                proc.stdin.close()
            except OSError:
                pass
            proc.terminate()
            try:
                proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def close(self):
        self._closed = True
        self._terminate()


class JsonLinePipeline(SubprocessPipeline):
    """Line-based pipeline parsing each stdout line as JSON → on_event(dict)
    (reference JsonParser; rtl_433/dumphfdl/dumpvdl2 style)."""

    def __init__(self, commandline, on_event, **kwargs):
        self.on_event = on_event
        super().__init__(commandline, self._parse, **kwargs)

    def _parse(self, line: bytes):
        try:
            self.on_event(json.loads(line))
        except json.JSONDecodeError:
            logger.debug("non-json decoder output: %r", line[:80])
