"""Decoder job queue: bounded queue + worker pool for batch decoders.

Reference: ``owrx/audio/queue.py:22-184`` — global bounded job queue,
QueueWorkers running `nice`d subprocesses, poison-pill shutdown, and
in/out/overflow/error metrics.
"""

from __future__ import annotations

import logging
import queue
import subprocess
import threading

from openwebrx_tpu_torch.core.metrics import Metrics

logger = logging.getLogger(__name__)

POISON = object()


class QueueJob:
    def __init__(self, commandline: list[str], file_path: str, on_line,
                 on_done=None, timeout: float = 300.0):
        self.commandline = commandline
        self.file_path = file_path
        self.on_line = on_line
        self.on_done = on_done
        self.timeout = timeout

    def run(self):
        cmd = ["nice", "-n", "10"] + self.commandline
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)
        try:
            for line in proc.stdout:
                try:
                    self.on_line(line)
                except Exception:
                    logger.exception("decoder line handler failed")
            proc.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            logger.warning("decoder timed out: %s", self.commandline[0])
            proc.kill()
            proc.wait()
        finally:
            if self.on_done is not None:
                try:
                    self.on_done()
                except Exception:
                    logger.exception("job completion handler failed")


class DecoderQueue:
    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def shared() -> "DecoderQueue":
        with DecoderQueue._lock:
            if DecoderQueue._instance is None:
                from openwebrx_tpu_torch.core.config import Config
                config = Config.get()
                DecoderQueue._instance = DecoderQueue(
                    maxsize=int(config.get("decoding_queue_length", 10)),
                    workers=int(config.get("decoding_queue_workers", 2)))
            return DecoderQueue._instance

    @staticmethod
    def reset():
        with DecoderQueue._lock:
            if DecoderQueue._instance is not None:
                DecoderQueue._instance.stop()
                DecoderQueue._instance = None

    def __init__(self, maxsize: int = 10, workers: int = 2):
        self.queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        metrics = Metrics.shared()
        self.in_counter = metrics.counter("decoding.queue.in")
        self.out_counter = metrics.counter("decoding.queue.out")
        self.overflow_counter = metrics.counter("decoding.queue.overflow")
        self.error_counter = metrics.counter("decoding.queue.error")
        self.workers = [self._start_worker(i) for i in range(workers)]

    def put(self, job: QueueJob) -> bool:
        try:
            self.queue.put_nowait(job)
            self.in_counter.inc()
            return True
        except queue.Full:
            self.overflow_counter.inc()
            logger.warning("decoding queue overflow; dropping %s", job.file_path)
            if job.on_done is not None:
                job.on_done()
            return False

    def _start_worker(self, i: int) -> threading.Thread:
        t = threading.Thread(target=self._work, name=f"decoder-{i}", daemon=True)
        t.start()
        return t

    def _work(self):
        while True:
            job = self.queue.get()
            if job is POISON:
                return
            try:
                job.run()
                self.out_counter.inc()
            except Exception:
                self.error_counter.inc()
                logger.exception("decoder job failed")
            finally:
                self.queue.task_done()

    def stop(self):
        for _ in self.workers:
            self.queue.put(POISON)
        for w in self.workers:
            w.join(timeout=2)
