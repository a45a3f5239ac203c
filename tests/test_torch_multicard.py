"""The reference's multi-device cases on two or more cards, over NCCL.

tests/test_cluster.py, tests/test_parallel.py and tests/test_pod.py carried
onto the port: each case keeps its reference name under an outer class
named after its file, carries the ``cuda`` marker and skips unless the
machine has two cards or more.  The port is SPMD, so a case runs its ranks
as processes started from this file (``python tests/test_torch_multicard.py
CASE RANK WORLD PORT DIR``), one card each (rank r on card r), joined over
NCCL; inputs and outputs cross as ``.npz`` files in the case's tmp_path.
The reference meshes 8 virtual CPU devices; here the mesh is every card
of the machine, up to 8, over the reference's own shapes (each divides
over 2, 4 or 8 ranks).  This file imports no jax, so what the reference
compares against the JAX package's single-device run is compared against
the port's single-card run here, at the reference's tolerances.  The same
cases run against the JAX package on gloo CPU ranks in
tests/test_torch_parallel.py.  On the card::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_multicard.py
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openwebrx_tpu_torch.ops import fir as tfir
from openwebrx_tpu_torch.ops import firdes
from openwebrx_tpu_torch.parallel import cluster as tcluster
from openwebrx_tpu_torch.parallel.halo import make_sharded_decimator
from openwebrx_tpu_torch.parallel.mesh import make_mesh
from openwebrx_tpu_torch.parallel.pod import (
    channel_slice, gather_channels, shard_channelized_bank)
from openwebrx_tpu_torch.runtime.bank import ChannelBank
from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 300
MAX_RANKS = 8                          # the reference's virtual devices
CLUSTER_M = 8                          # tests/test_cluster.py's M


def make_nfm_signal(fs, duration, offset_hz, f_audio=1000.0, deviation=3000.0,
                    amplitude=0.5):
    """tests/test_chains.py's NFM test signal."""
    n = np.arange(int(fs * duration))
    mod = np.sin(2 * np.pi * f_audio / fs * n)
    phase = 2 * np.pi * deviation / fs * np.cumsum(mod)
    return (amplitude * np.exp(1j * (2 * np.pi * offset_hz / fs * n + phase))
            ).astype(np.complex64)


def _cplx(t, dev):
    return torch.from_numpy(np.ascontiguousarray(t, np.complex64)).to(dev)


# ------------------------------------------------------------ rank workers --
def worker_halo(rank, world, inp, dev):
    """Each rank filters its time slice of every block through
    make_sharded_decimator over the "time" axis."""
    mesh = make_mesh(world, {"time": world}, device=dev)
    taps, decim = inp["taps"], int(inp["decim"])
    step = make_sharded_decimator(mesh, "time", taps, decim, device=dev)
    tail = tfir.fir_init(len(taps), device=dev)
    ys = []
    for blk in inp["blocks"]:
        sl = len(blk) // world
        tail, y = step(tail, _cplx(blk[rank * sl:(rank + 1) * sl], dev))
        ys.append(y.cpu().numpy())
    return {"y": np.stack(ys), "tail": tail.cpu().numpy()}


def worker_chansharding(rank, world, inp, dev):
    """The ChannelBank's chain on this rank's channels of state and
    params, the IQ replicated, every rank's audio gathered."""
    mesh = make_mesh(world, device=dev)
    bank = ChannelBank(2.4e6, mode="nfm", capacity=len(inp["offsets"]),
                       compression="none", target_seconds=0.05, device=dev)
    for off in inp["offsets"]:
        bank.add_channel(float(off))
    n, per = bank.capacity, bank.capacity // world
    lo, hi = rank * per, (rank + 1) * per
    chain = bank.chain
    params = channel_slice(bank.program._params(), n, lo, hi)
    state = channel_slice(chain.init_state((n,), dev), n, lo, hi)
    _, y, _ = chain.apply(state, params, _cplx(inp["x"], dev))
    return {"y": gather_channels(y, mesh).cpu().numpy()}


def worker_pod(rank, world, inp, dev):
    """shard_channelized_bank over "chan", the whole block fed to every
    rank; every rank's channels gathered."""
    mesh = make_mesh(world, device=dev)
    bank = ChannelizedBank(float(inp["fs"]), int(inp["m"]), mode="usb",
                           compression="none", target_seconds=0.04, device=dev)
    for o in inp["offsets"]:
        bank.assign(float(o))
    run, state = shard_channelized_bank(bank, mesh)
    ys = []
    for blk in inp["blocks"]:
        state, y, _ = run(state, blk)
        ys.append(gather_channels(y, mesh).cpu().numpy())
    return {"y": np.concatenate(ys, axis=-1)}


def worker_dryrun(rank, world, inp, dev):
    """The cluster's dry run (``parallel/cluster.py`` ``_dryrun``): a
    DistributedReceiver over every rank, each fed its slab."""
    check, nchan = tcluster._dryrun(tcluster.ClusterInfo(rank, world, 1, world),
                                    m=CLUSTER_M, device=dev)
    return {"check": np.float64(check), "nchan": np.int64(nchan)}


def _worker_main(case, rank, world, port, out_dir):
    rank, world = int(rank), int(world)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    inp = dict(np.load(Path(out_dir) / "in.npz"))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out = globals()[f"worker_{case}"](rank, world, inp, dev)
        np.savez(Path(out_dir) / f"out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- helpers --
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def _wait_all(procs, timeout=WORKER_TIMEOUT_S):
    """Wait for every process (within what is left of ``timeout``); kill
    all on a timeout or a failure → their stdouts."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran longer than {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_ranks(case, world, tmp_path, **inputs):
    """``worker_<case>`` on ``world`` NCCL ranks, a card each → each rank's
    outputs."""
    np.savez(tmp_path / "in.npz", **inputs)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(port),
         str(tmp_path)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    _wait_all(procs)
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


@pytest.fixture
def world():
    """Every card of the machine, up to the reference's 8 devices."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards or more (one rank a card over NCCL)")
    return min(MAX_RANKS, torch.cuda.device_count())


def _rand_iq(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _single_fir(taps, x, decim):
    """The port's FIR decimator on one card."""
    dev = torch.device("cuda", 0)
    tail, y = tfir.fir_apply(tfir.fir_init(len(taps), device=dev),
                             torch.as_tensor(taps, device=dev), _cplx(x, dev), decim)
    return y.cpu().numpy(), tail.cpu().numpy()


def _usb_bank_checksum():
    """tests/test_cluster.py's single-process reference on one card: the
    dry run's bank and input, three blocks, the sum of |audio|."""
    bank = ChannelizedBank(48000.0 * CLUSTER_M, CLUSTER_M, mode="usb",
                           compression="none", target_seconds=0.02,
                           device=torch.device("cuda", 0))
    for k in range(CLUSTER_M):
        bank.assign(float((k - CLUSTER_M // 2) * 48000.0))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(bank.block)
         + 1j * rng.standard_normal(bank.block)).astype(np.complex64) * 0.1
    for _ in range(3):
        y, _ = bank.process(x)
    return float(np.sum(np.abs(np.asarray(y, np.float32))))


# ------------------------------------------------------------------- tests --
class TestCluster:
    @pytest.mark.cuda
    def test_distributed_receiver_in_process(self, world, tmp_path):
        """The dry run's DistributedReceiver over every card: every rank
        owns its M / world channels and computes the checksum of the
        single-card bank."""
        outs = run_ranks("dryrun", world, tmp_path, ranks=world)
        ref = _usb_bank_checksum()
        for o in outs:
            assert int(o["nchan"]) == CLUSTER_M // world
            assert abs(float(o["check"]) - ref) <= 1e-3 * max(ref, 1.0), (o["check"], ref)

    @pytest.mark.cuda
    def test_two_process_virtual_cluster(self, world, tmp_path):
        """``python -m openwebrx_tpu_torch.parallel.cluster`` in two
        processes, a card each over NCCL: each owns half the channels, both
        print the same checksum, and it is the single-card bank's."""
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "openwebrx_tpu_torch.parallel.cluster",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(p), "--channels", str(CLUSTER_M), "--device", "cuda"],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for p in range(2)]
        outs = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
                for out in _wait_all(procs)]
        assert {o["process_id"] for o in outs} == {0, 1}
        for o in outs:
            assert o["global_devices"] == 2
            assert o["local_devices"] == 1
            assert o["owned_channels"] == CLUSTER_M // 2
        assert outs[0]["checksum"] == pytest.approx(outs[1]["checksum"], rel=1e-5)
        assert outs[0]["checksum"] == pytest.approx(_usb_bank_checksum(), rel=1e-3)


class TestParallel:
    class TestHaloFir:
        @pytest.mark.cuda
        def test_matches_single_chip(self, world, tmp_path):
            taps = firdes.lowpass_taps(0.04, 0.01)
            decim = 10
            b = 8 * decim * 100
            x = _rand_iq(np.random.default_rng(0), b)
            outs = run_ranks("halo", world, tmp_path, taps=taps, decim=decim, blocks=x[None])
            y = np.concatenate([o["y"][0] for o in outs])
            y_ref, tail_ref = _single_fir(taps, x, decim)
            np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
            for o in outs:
                np.testing.assert_allclose(o["tail"], tail_ref, rtol=1e-5, atol=1e-6)

        @pytest.mark.cuda
        def test_streaming_across_blocks(self, world, tmp_path):
            taps = firdes.lowpass_taps(0.1, 0.02)
            decim = 4
            b = 8 * decim * 50         # the reference's 4 ranks' block, over up to 8
            x = _rand_iq(np.random.default_rng(1), 3 * b)
            blocks = np.stack(np.split(x, 3))
            outs = run_ranks("halo", world, tmp_path, taps=taps, decim=decim, blocks=blocks)
            y = np.concatenate([np.concatenate([o["y"][k] for o in outs])
                                for k in range(3)])
            y_ref, _ = _single_fir(taps, x, decim)
            np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)

    class TestChannelSharding:
        @pytest.mark.cuda
        def test_bank_sharded_over_channels(self, world, tmp_path):
            """The ChannelBank's chain over a channel mesh of every card:
            per-channel state and params sharded, the IQ replicated; the
            signal-bearing channel matches the unsharded bank."""
            offsets = np.linspace(-1e6, 1e6, 8).astype(np.float32)
            offsets[0] = 145000.0     # channel 0 carries the test tone
            bank = ChannelBank(2.4e6, mode="nfm", capacity=8, compression="none",
                               target_seconds=0.05, device=torch.device("cuda", 0))
            for off in offsets:
                bank.add_channel(float(off))
            x = make_nfm_signal(2.4e6, bank.block / 2.4e6, 145000.0)[: bank.block]
            outs = run_ranks("chansharding", world, tmp_path, offsets=offsets, x=x)
            y_ref, _ = bank.process(x)
            for o in outs:
                assert o["y"].shape[0] == 8
                a = o["y"][0].astype(np.float32) / 32767
                b = np.asarray(y_ref)[0].astype(np.float32) / 32767
                n2 = len(a) // 2          # settled half
                np.testing.assert_allclose(a[n2:], b[n2:], atol=5e-3)


class TestPod:
    class TestPodSharding:
        @pytest.mark.cuda
        def test_sharded_matches_unsharded(self, world, tmp_path):
            fs, m = 1.536e6, 16
            offs = [150000.0, -400000.0]
            f_audio = [900.0, 1300.0]
            bank = ChannelizedBank(fs, m, mode="usb", compression="none",
                                   target_seconds=0.04, device=torch.device("cuda", 0))
            for o in offs:
                bank.assign(o)
            n = np.arange(bank.block * 3)
            x = sum(0.4 * np.exp(2j * np.pi * (o + fa) / fs * n)
                    for o, fa in zip(offs, f_audio)).astype(np.complex64)
            blocks = np.stack(np.split(x, 3))
            ref = np.concatenate([np.asarray(bank.process(blk)[0]) for blk in blocks],
                                 axis=-1)
            outs = run_ranks("pod", world, tmp_path, fs=fs, m=m, offsets=np.asarray(offs),
                             blocks=blocks)
            for o in outs:
                sharded = o["y"]
                assert sharded.shape == ref.shape
                for off in offs:
                    k, _ = bank.channel_for(off)
                    a = sharded[k].astype(np.float32) / 32767
                    b = ref[k].astype(np.float32) / 32767
                    n2 = len(a) // 3
                    np.testing.assert_allclose(a[n2:], b[n2:], atol=2e-2)


if __name__ == "__main__":
    _worker_main(*sys.argv[1:])
