"""The port's multi-device layer (openwebrx_tpu_torch.parallel) on gloo CPU
ranks, against the JAX package's on the conftest's 8 virtual CPU devices.

Mirrors tests/test_parallel.py, tests/test_pod.py and tests/test_cluster.py.
The port is SPMD (one process per rank), so each scene runs in ``world``
worker processes started from this file (``python tests/test_torch_parallel.py
CASE RANK WORLD PORT DIR``); inputs and outputs cross as ``.npz`` files in
the test's tmp_path.  The workers import torch and the port only: the JAX
side is computed here, in the test process.
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

from openwebrx_tpu_torch.ops import channelizer as tpfb
from openwebrx_tpu_torch.ops import fir as tfir
from openwebrx_tpu_torch.parallel import cluster as tcluster
from openwebrx_tpu_torch.parallel.halo import make_sharded_decimator
from openwebrx_tpu_torch.parallel.mesh import AxisComm, make_mesh
from openwebrx_tpu_torch.parallel.pfb import sharded_channelize, time_to_channels
from openwebrx_tpu_torch.parallel.pod import (
    channel_slice, gather_channels, shard_channelized_bank)
from openwebrx_tpu_torch.runtime.bank import ChannelBank
from openwebrx_tpu_torch.runtime.chain import tree_map
from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

if __name__ != "__main__":          # the test process; rank workers skip JAX
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from openwebrx_tpu.ops import channelizer as jpfb
    from openwebrx_tpu.runtime import chain as jchain
    from openwebrx_tpu.ops import fir as jfir
    from openwebrx_tpu.ops import firdes
    from openwebrx_tpu.parallel.halo import make_sharded_decimator as jax_decimator
    from openwebrx_tpu.parallel.mesh import make_mesh as jax_mesh
    from openwebrx_tpu.parallel.pfb import sharded_channelize as jax_channelize
    from openwebrx_tpu.parallel.pod import shard_channelized_bank as jax_shard_bank
    from openwebrx_tpu.runtime.bank import ChannelBank as JaxChannelBank
    from openwebrx_tpu.runtime.channelized import ChannelizedBank as JaxBank

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
WORKER_TIMEOUT_S = 120
# × max|y|: the fold and FFT sum P = 16 float32 terms in another order than
# XLA's conv (as chip_smoke.py's FOLD_RTOL)
FOLD_RTOL = 1e-5
CLUSTER_M = 8                        # tests/test_cluster.py's M


# ------------------------------------------------------------ rank workers --
def _cplx(t):
    return torch.from_numpy(np.ascontiguousarray(t, np.complex64))


def worker_halo(rank, world, inp):
    """Each rank filters its time slice of every block through
    make_sharded_decimator on the mesh ``axes``, along ``axis``."""
    axes = json.loads(str(inp["axes"]))
    axis = str(inp["axis"])
    mesh = make_mesh(world, axes, device=CPU)
    n = mesh.size(list(axes).index(axis))
    i = mesh.get_local_rank(axis)
    taps, decim = inp["taps"], int(inp["decim"])
    step = make_sharded_decimator(mesh, axis, taps, decim, device=CPU)
    tail = tfir.fir_init(len(taps), device=CPU)
    ys = []
    for blk in inp["blocks"]:
        sl = len(blk) // n
        tail, y = step(tail, _cplx(blk[i * sl:(i + 1) * sl]))
        ys.append(y.numpy())
    return {"y": np.stack(ys), "tail": tail.numpy(), "index": i}


def worker_channelize(rank, world, inp):
    """sharded_channelize over the "chan" axis, streaming the blocks."""
    mesh = make_mesh(world, device=CPU)
    m, p = int(inp["m"]), int(inp["p"])
    fold = sharded_channelize(mesh, "chan", inp["proto"], m, device=CPU)
    tail = tpfb.channelizer_init(m, p, device=CPU)
    ys = []
    for blk in inp["blocks"]:
        sl = len(blk) // world
        tail, y = fold(tail, _cplx(blk[rank * sl:(rank + 1) * sl]))
        ys.append(y.numpy())
    return {"y": np.stack(ys), "tail": tail.numpy()}


def worker_reshard(rank, world, inp):
    """time_to_channels on this rank's slice of ``y``."""
    mesh = make_mesh(world, device=CPU)
    y = _cplx(inp["y"][rank])
    return {"y": time_to_channels(y, AxisComm(mesh, "chan")).numpy()}


def worker_chansharding(rank, world, inp):
    """The ChannelBank's chain run on this rank's channel of state and
    params, the IQ replicated, every rank's audio gathered: block 0 from
    the initial state, block 1 from the state leaves ``state_*`` (the JAX
    bank's after block 0, in tree order)."""
    mesh = make_mesh(world, device=CPU)
    bank = ChannelBank(2.4e6, mode="nfm", capacity=world, compression="none",
                       target_seconds=0.05, device=CPU)
    for off in inp["offsets"]:
        bank.add_channel(float(off))
    chain = bank.chain
    params = channel_slice(bank.program._params(), world, rank, rank + 1)
    init = chain.init_state((world,), bank.device)
    leaves = iter(inp[k] for k in sorted(inp) if k.startswith("state_"))
    handed = tree_map(lambda _: torch.from_numpy(next(leaves)), init)
    out = {}
    for b, state in enumerate((init, handed)):
        _, y, _ = chain.apply(channel_slice(state, world, rank, rank + 1),
                              params, _cplx(inp["x"][b]))
        out[f"y{b}"] = gather_channels(y, mesh).numpy()
    return out


def worker_pod(rank, world, inp):
    """shard_channelized_bank over 'chan', the whole block fed to every
    rank; every rank's channels gathered."""
    mesh = make_mesh(world, device=CPU)
    bank = ChannelizedBank(float(inp["fs"]), int(inp["m"]), mode="usb",
                           compression="none", target_seconds=0.04, device=CPU)
    for o in inp["offsets"]:
        bank.assign(float(o))
    run, state = shard_channelized_bank(bank, mesh)
    ys = []
    for blk in inp["blocks"]:
        state, y, _ = run(state, blk)
        ys.append(gather_channels(y, mesh).numpy())
    return {"y": np.concatenate(ys, axis=-1), "local_rows": y.shape[0]}


def _worker_main(case, rank, world, port, out_dir):
    torch.set_num_threads(1)
    inp = dict(np.load(Path(out_dir) / "in.npz"))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        out = globals()[f"worker_{case}"](int(rank), int(world), inp)
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
    """Wait for every process (each within what is left of ``timeout``);
    kill all on a timeout or a failure → their stdouts."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank worker ran longer than {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_ranks(case, world, tmp_path, **inputs):
    """Run ``worker_<case>`` on ``world`` gloo ranks → each rank's outputs."""
    np.savez(tmp_path / "in.npz", **inputs)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(port),
         str(tmp_path)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    _wait_all(procs)
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


def _rand_iq(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _jax_halo(axes, axis, taps, decim, blocks):
    mesh = jax_mesh(int(np.prod(list(axes.values()))), axes)
    step = jax_decimator(mesh, axis, taps, decim)
    tail = jax.device_put(jfir.fir_init(len(taps)), NamedSharding(mesh, P()))
    ys = []
    for blk in blocks:
        tail, y = step(tail, jax.device_put(blk, NamedSharding(mesh, P(axis))))
        ys.append(np.asarray(y))
    return np.concatenate(ys), np.asarray(tail)


def _assembled(outs, n):
    """Per-rank (blocks, L) slices → the stream: block by block, the slices
    of time indices 0..n−1 in order (one rank per time index)."""
    by_index = {int(o["index"]): o["y"] for o in outs}
    return np.concatenate([np.concatenate([by_index[i][b] for i in range(n)])
                           for b in range(outs[0]["y"].shape[0])])


# ------------------------------------------------------------------- tests --
class TestHaloFir:
    def _port_single(self, taps, x, decim):
        tail, y = tfir.fir_apply(tfir.fir_init(len(taps), device=CPU),
                                 torch.as_tensor(taps), _cplx(x), decim)
        return y.numpy(), tail.numpy()

    def test_matches_single_chip(self, tmp_path):
        taps = firdes.lowpass_taps(0.04, 0.01)
        decim = 10
        b = 8 * decim * 100
        x = _rand_iq(np.random.default_rng(0), b)
        outs = run_ranks("halo", 8, tmp_path, axes=json.dumps({"time": 8}),
                         axis="time", taps=taps, decim=decim, blocks=x[None])
        y = _assembled(outs, 8)
        y_jax, tail_jax = _jax_halo({"time": 8}, "time", taps, decim, [x])
        ref_tail, y_ref = jfir.fir_apply(jfir.fir_init(len(taps)), taps, x, decim)
        y_single, tail_single = self._port_single(taps, x, decim)
        for want in (np.asarray(y_ref), y_jax, y_single):
            np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-5)
        for o in outs:
            for want in (np.asarray(ref_tail), tail_jax, tail_single):
                np.testing.assert_allclose(o["tail"], want, rtol=1e-5, atol=1e-6)

    def test_streaming_across_blocks(self, tmp_path):
        taps = firdes.lowpass_taps(0.1, 0.02)
        decim = 4
        b = 4 * decim * 50
        x = _rand_iq(np.random.default_rng(1), 3 * b)
        blocks = np.stack(np.split(x, 3))
        outs = run_ranks("halo", 4, tmp_path, axes=json.dumps({"time": 4}),
                         axis="time", taps=taps, decim=decim, blocks=blocks)
        y = _assembled(outs, 4)
        _, y_ref = jfir.fir_apply(jfir.fir_init(len(taps)), taps, x, decim)
        y_jax, _ = _jax_halo({"time": 4}, "time", taps, decim, blocks)
        np.testing.assert_allclose(y, np.asarray(y_ref), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(y, y_jax, rtol=1e-4, atol=1e-5)

    def test_time_axis_of_a_2d_mesh(self, tmp_path):
        """The halo rides the "time" axis of a {"time": 2, "chan": 2} mesh:
        its ring peers are the axis' subgroup, named by global rank; the two
        ranks of each time index compute the same slice."""
        axes = {"time": 2, "chan": 2}
        taps = firdes.lowpass_taps(0.1, 0.02)
        decim = 4
        x = _rand_iq(np.random.default_rng(2), 2 * 2 * decim * 60)
        blocks = np.stack(np.split(x, 2))
        outs = run_ranks("halo", 4, tmp_path, axes=json.dumps(axes),
                         axis="time", taps=taps, decim=decim, blocks=blocks)
        assert sorted(int(o["index"]) for o in outs) == [0, 0, 1, 1]
        for i in (0, 1):
            same = [o["y"] for o in outs if int(o["index"]) == i]
            np.testing.assert_array_equal(same[0], same[1])
        y = _assembled(outs, 2)
        _, y_ref = jfir.fir_apply(jfir.fir_init(len(taps)), taps, x, decim)
        y_jax, _ = _jax_halo(axes, "time", taps, decim, blocks)
        np.testing.assert_allclose(y, np.asarray(y_ref), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(y, y_jax, rtol=1e-4, atol=1e-5)


class TestShardedChannelize:
    def test_matches_jax_streaming(self, tmp_path):
        """4 ranks, M = 16, three blocks: the channel slices gathered equal
        the JAX sharded_channelize (4 virtual devices) within FOLD_RTOL of
        the output scale, and the port's single-device channelize; the new
        tail is the stream's last P·M samples on every rank."""
        m, p, n = 16, 16, 4
        proto = tpfb.design_prototype(m, p)
        x = _rand_iq(np.random.default_rng(3), 3 * m * 64 * n)
        blocks = np.stack(np.split(x, 3))
        outs = run_ranks("channelize", n, tmp_path, m=m, p=p, proto=proto,
                         blocks=blocks)
        got = np.concatenate([np.concatenate([o["y"][b] for o in outs])
                              for b in range(3)], axis=1)       # (M, 3·B/M)
        mesh = jax_mesh(n, {"chan": n})
        fold = jax.jit(jax_channelize(mesh, "chan", proto, m))
        jtail = jax.device_put(jpfb.channelizer_init(m, p), NamedSharding(mesh, P()))
        ttail = tpfb.channelizer_init(m, p, device=CPU)
        ref, single = [], []
        for blk in blocks:
            jtail, y = fold(jtail, jax.device_put(blk, NamedSharding(mesh, P("chan"))))
            ref.append(np.asarray(y))
            ttail, ys = tpfb.channelize(ttail, proto, _cplx(blk), m, device=CPU)
            single.append(ys.numpy())
        ref, single = np.concatenate(ref, axis=1), np.concatenate(single, axis=1)
        tol = FOLD_RTOL * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        np.testing.assert_allclose(got, single, rtol=0, atol=tol)
        for o in outs:
            np.testing.assert_array_equal(o["tail"], np.asarray(jtail))
            np.testing.assert_array_equal(o["tail"], x[-m * p:])

    def test_reshard_layout(self, tmp_path):
        """Distinct values on every rank: rank r gets rows [r·M/n, (r+1)·M/n)
        of every rank's slice, rank i's as time block i, exactly as JAX's
        all_to_all(split_axis=0, concat_axis=1, tiled=True)."""
        m, t, n = 8, 3, 4
        r, row, col = np.meshgrid(np.arange(n), np.arange(m), np.arange(t),
                                  indexing="ij")
        y = (r + 1j * (row * 100 + col)).astype(np.complex64)   # (n, M, T/n)
        outs = run_ranks("reshard", n, tmp_path, y=y)
        full = np.concatenate(list(y), axis=1)                    # (M, T)
        mesh = jax_mesh(n, {"chan": n})
        a2a = jax.shard_map(
            lambda v: jax.lax.all_to_all(v, "chan", split_axis=0, concat_axis=1,
                                         tiled=True),
            mesh=mesh, in_specs=P("chan"), out_specs=P("chan"), check_vma=False)
        jout = np.asarray(jax.jit(a2a)(np.concatenate(list(y))))  # (M, T)
        k = m // n
        for rank, o in enumerate(outs):
            np.testing.assert_array_equal(o["y"], full[rank * k:(rank + 1) * k])
            np.testing.assert_array_equal(o["y"], jout[rank * k:(rank + 1) * k])


class TestChannelSharding:
    def test_bank_sharded_over_channels(self, tmp_path):
        """ChannelBank(2.4e6, "nfm", capacity=8): each of 8 ranks runs the
        chain on its channel of state and params with the IQ replicated.
        Gathered, channel 0 (the tone) matches on the settled half, atol
        5e-3 (tests/test_parallel.py's tolerance): block 0 the unsharded
        port bank; block 1, from the JAX bank's state after block 0, the
        JAX bank (at stream start the FM discriminator sees ~1e-7 filter
        outputs whose rounding differs between any two float32
        implementations, so parity with JAX starts after a handover)."""
        from tests.test_chains import make_nfm_signal
        offsets = np.linspace(-1e6, 1e6, 8).astype(np.float32)
        offsets[0] = 145000.0
        bank = ChannelBank(2.4e6, mode="nfm", capacity=8, compression="none",
                           target_seconds=0.05, device=CPU)
        jbank = JaxChannelBank(2.4e6, mode="nfm", capacity=8, compression="none",
                               target_seconds=0.05)
        for off in offsets:
            bank.add_channel(float(off))
            jbank.add_channel(float(off))
        x = make_nfm_signal(2.4e6, 2 * bank.block / 2.4e6, 145000.0)
        x = np.stack(np.split(x[: 2 * bank.block], 2))
        y_ref, _ = bank.process(x[0])
        jbank.process(x[0])
        jstate = jax.tree.map(lambda v, c: np.asarray(jchain._unpack_leaf(v, c)),
                              jbank.program.state, jbank.program._s_mask)
        leaves = {f"state_{i:03d}": a for i, a in enumerate(jax.tree.leaves(jstate))}
        jy_ref, _ = jbank.process(x[1])
        outs = run_ranks("chansharding", 8, tmp_path, offsets=offsets, x=x, **leaves)
        for o in outs[1:]:
            np.testing.assert_array_equal(o["y0"], outs[0]["y0"])
            np.testing.assert_array_equal(o["y1"], outs[0]["y1"])
        for got, ref in ((outs[0]["y0"], y_ref), (outs[0]["y1"], np.asarray(jy_ref))):
            assert got.shape == ref.shape and got.shape[0] == 8
            a = got[0].astype(np.float32) / 32767
            b = ref[0].astype(np.float32) / 32767
            n2 = len(a) // 2  # settled half (AGC attack transient)
            np.testing.assert_allclose(a[n2:], b[n2:], atol=5e-3)


class TestPodSharding:
    def test_sharded_matches_unsharded(self, tmp_path):
        """shard_channelized_bank at 8 ranks (16 × 96 kHz USB channels)
        against the unsharded port bank and the JAX shard_channelized_bank
        (8 virtual devices): atol 2e-2 of full scale on the signal-bearing
        channels after the first third (tests/test_pod.py's tolerance)."""
        fs, m = 1.536e6, 16
        offs, f_audio = [150000.0, -400000.0], [900.0, 1300.0]

        def bank_of(cls, **kw):
            b = cls(fs, m, mode="usb", compression="none", target_seconds=0.04, **kw)
            for o in offs:
                b.assign(o)
            return b

        bank = bank_of(ChannelizedBank, device=CPU)
        n = np.arange(bank.block * 3)
        x = sum(0.4 * np.exp(2j * np.pi * (o + fa) / fs * n)
                for o, fa in zip(offs, f_audio)).astype(np.complex64)
        blocks = np.stack(np.split(x, 3))
        outs = run_ranks("pod", 8, tmp_path, fs=fs, m=m, offsets=np.array(offs),
                         blocks=blocks)
        sharded = outs[0]["y"]
        assert all(int(o["local_rows"]) == m // 8 for o in outs)
        ref = np.concatenate([bank.process(b)[0] for b in blocks], axis=-1)
        jbank = bank_of(JaxBank)
        run, state = jax_shard_bank(jbank, jax_mesh(8, {"chan": 8}))
        jref = []
        for b in blocks:
            state, y, _ = run(state, b)
            jref.append(np.asarray(y))
        jref = np.concatenate(jref, axis=-1)
        assert sharded.shape == ref.shape == jref.shape
        for o in offs:
            k, _ = bank.channel_for(o)
            a = sharded[k].astype(np.float32) / 32767
            n3 = len(a) // 3
            for want in (ref, jref):
                b = want[k].astype(np.float32) / 32767
                np.testing.assert_allclose(a[n3:], b[n3:], atol=2e-2)


def _port_checksum():
    """The port's single bank on _reference_checksum's input, 3 blocks."""
    bank = tcluster._usb_bank(CLUSTER_M, 0.02, CPU)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(bank.block)
         + 1j * rng.standard_normal(bank.block)).astype(np.complex64) * 0.1
    for _ in range(3):
        y, _ = bank.process(x)
    return float(np.sum(np.abs(y.astype(np.float64))))


class TestDistributedReceiver:
    def test_in_process(self):
        """World size 1 in this process: the dryrun's checksum equals the
        port's single bank's and JAX's _reference_checksum (rel 1e-3, as
        tests/test_cluster.py)."""
        from tests.test_cluster import _reference_checksum
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            check, nchan = tcluster._dryrun(tcluster.ClusterInfo(0, 1, 1, 1),
                                            m=CLUSTER_M, device=CPU)
        finally:
            dist.destroy_process_group()
        assert nchan == CLUSTER_M
        for ref in (_port_checksum(), _reference_checksum()):
            assert abs(check - ref) <= 1e-3 * max(ref, 1.0), (check, ref)

    def test_two_process_virtual_cluster(self):
        """Two ``python -m openwebrx_tpu_torch.parallel.cluster --device
        cpu`` workers: each owns M/2 channels, both report the same global
        checksum (rel 1e-5), which matches the single-process one (rel
        1e-3)."""
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "openwebrx_tpu_torch.parallel.cluster",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(p), "--channels", str(CLUSTER_M),
             "--device", "cpu"], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for p in range(2)]
        outs = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
                for out in _wait_all(procs)]
        assert {o["process_id"] for o in outs} == {0, 1}
        for o in outs:
            assert o["global_devices"] == 2
            assert o["local_devices"] == 1
            assert o["owned_channels"] == CLUSTER_M // 2
        assert outs[0]["checksum"] == pytest.approx(outs[1]["checksum"], rel=1e-5)
        from tests.test_cluster import _reference_checksum
        for ref in (_port_checksum(), _reference_checksum()):
            assert outs[0]["checksum"] == pytest.approx(ref, rel=1e-3)


    def test_one_process_worker(self):
        """``--num-processes 1``: the worker forms a group of one rank
        itself (init_cluster joins nothing) and owns every channel, with
        the two-process run's checksum."""
        proc = subprocess.run(
            [sys.executable, "-m", "openwebrx_tpu_torch.parallel.cluster",
             "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
             "--process-id", "0", "--channels", str(CLUSTER_M), "--device", "cpu"],
            env=_env(), capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        assert out["global_devices"] == 1 and out["owned_channels"] == CLUSTER_M
        assert out["checksum"] == pytest.approx(_port_checksum(), rel=1e-3)

    def test_bench_leg(self):
        """``--bench-blocks``: each of two workers times the one-deep
        pipelined step and the collectives alone on its slab."""
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "openwebrx_tpu_torch.parallel.cluster",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(p), "--channels", str(CLUSTER_M),
             "--bench-blocks", "3", "--block-seconds", "0.02", "--device", "cpu"],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for p in range(2)]
        outs = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
                for out in _wait_all(procs)]
        for o in outs:
            assert o["channels"] == CLUSTER_M and o["global_devices"] == 2
            assert o["samples_per_s"] > 0 and o["step_seconds"] > 0
            assert o["collective_seconds"] > 0


class TestInitCluster:
    @pytest.fixture(autouse=True)
    def _no_cluster_env(self, monkeypatch):
        for k in ("OWRX_COORDINATOR", "OWRX_NUM_PROCESSES", "OWRX_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)

    def test_one_process_is_a_no_op(self):
        info = tcluster.init_cluster(device=CPU)
        assert info == tcluster.ClusterInfo(0, 1, 1, 1)
        assert info.is_coordinator
        assert not dist.is_initialized()

    @pytest.mark.parametrize("from_env", [False, True])
    def test_several_processes_need_a_coordinator(self, from_env, monkeypatch):
        if from_env:
            monkeypatch.setenv("OWRX_NUM_PROCESSES", "2")
            call = dict(device=CPU)
        else:
            call = dict(num_processes=2, process_id=1, device=CPU)
        with pytest.raises(ValueError, match="coordinator"):
            tcluster.init_cluster(**call)
        assert not dist.is_initialized()


class TestMesh:
    def test_axes_must_cover_the_devices(self):
        with pytest.raises(ValueError, match="devices"):
            make_mesh(8, {"time": 2, "chan": 2}, device=CPU)

    def test_needs_a_process_group(self):
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh(1, device=CPU)

    def test_size_must_be_the_world(self):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            with pytest.raises(ValueError, match="ranks"):
                make_mesh(2, device=CPU)
            mesh = make_mesh(1, device=CPU)
            assert mesh.mesh_dim_names == ("chan",)
        finally:
            dist.destroy_process_group()

    @pytest.mark.parametrize("entry", ["make_mesh", "init_cluster",
                                       "make_sharded_decimator",
                                       "sharded_channelize"])
    def test_default_device_needs_a_card(self, entry):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        call = {"make_mesh": lambda: make_mesh(1),
                "init_cluster": lambda: tcluster.init_cluster(),
                "make_sharded_decimator": lambda: make_sharded_decimator(
                    None, "time", np.ones(3, np.float32), 1),
                "sharded_channelize": lambda: sharded_channelize(
                    None, "chan", tpfb.design_prototype(8, 4), 8)}[entry]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


if __name__ == "__main__":
    _worker_main(*sys.argv[1:])
