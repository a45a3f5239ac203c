#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``openwebrx_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, PyTorch's device name;
2. build the six CUDA kernels from ``openwebrx_tpu_torch/csrc`` and a
   second build of ``adpcm.cu`` with shorter strides, which phase 6 times
   (one ``nvcc`` per build, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the full-width paths give it: the polyphase fold (M = 1024, config #2's
   M = 64, configs #3 and #6's M = 256, the server's M = 128 and a rank's
   time slice of config #5 over POD_RANKS ranks) and the first-order IIR within stated tolerances; the ADPCM
   encoder (the fused ``adpcm_encode`` at every path's shape over four
   blocks with the state carried, strides built on every boundary of its
   index estimate, and ``encode_strides``) with bytes, stride states and
   carried state identical; the AGC at every path's shape, on all-zero
   rows, on a silence-to-full-scale step and on rows longer than one
   shared-memory tile, with gain, hang counters and audio identical; the
   squelch at every path's shape and on silent rows, NaN rows and a burst
   that arms the hang and runs it out, with power_db within
   SQUELCH_DB_TOL and gates, hang and output bit-identical wherever the
   power is not that close to the level, every case launched twice with
   the same bits, plus real rows (the 4-byte path), rows of 100 windows,
   a window straddling two CTAs of a cluster with a shorter last slice,
   rows long enough for the re-read branch, rows of more windows than
   shared memory holds and a row too long for slices (walked in chunks),
   rows of 2^31 floats and more in all, x at an unaligned address,
   config #1's 0-dim state with one level and the hang carried over three
   calls against the plain version's chain, and every plan's shared
   memory as the kernel's own layout gives it; the exact IMA row encoder
   (``adpcm_encode_seq``) bit-identical at the waterfall's shape, on 16
   rows, on full-scale square waves and from random start states; phase
   8's per-rank shapes (squelch and AGC at (M / POD_RANKS, 600), and the
   ADPCM encoder there too, though 8b runs int16 audio) among them;
4. small banks (M=64) on the card against the same banks on the CPU (plain
   versions), on the same input, in every mode: usb, nfm, am, rawam, sam
   and wfm (gathered, at 384 kHz slices); the waterfall (``FftChain``,
   float and compressed rows); every secondary and digital-voice chain on
   two channels; a ``Fanout`` against its branches run alone; the
   runtime's ``SecondaryBank`` fed device chunks, its FFT rows encoded on
   the card, against the same bank on the CPU;
5. the paths at full width, each fed seeded device-resident IQ with every
   result fetched to host numpy: the 1024-channel USB bank (BASELINE
   config #5), the 1024-channel NFM bank, the 2048-channel AM bank, the
   128-channel WFM bank (0.2 s blocks), BASELINE config #1 (2.4 MS/s NFM
   through ``Program``), config #2 (a compressed 4096-bin waterfall, a
   PFB listener and a full-rate edge dial on one 2.4 MS/s block), config
   #4 (a ``Fanout`` of 16 BPSK31 and 16 USB channels delivered in 6-block
   batches, its first batch checked against the CPU), the 4096-bin
   waterfall of the 49.152 MS/s input alone and beside the USB bank;
   then, through the port's ``DeviceRuntime`` fed uint8 wire blocks at
   8.192 MS/s from a looped seeded source, BASELINE config #3 (64
   background USB dials on one PFB bank, raw audio in 6-block batches,
   pipeline depth 2), config #6 (256 interactive ADPCM listeners with
   four retunes a block and an edge drag to the full-rate bank and back
   every 8th block, depth 3) and the threaded loop (``start()``, config
   #6's listeners and a compressed waterfall, ``stop()``), each failing on
   any ERROR record of the runtime's logger.  Each path runs twice on the
   same blocks: its graph and its eager step (``graph=False``, which
   DeviceRuntime never passes: tests/torch_graph_scenes.py
   ``runtime_graph`` patches it in), in rounds E G G E E G of ALT_BLOCKS
   blocks (config #6: twice over, after a warm-up in which both its banks
   capture).  Every round sets the kernels' launch counters to 0 just
   before it and holds them to the path's predicted launches just after;
   ALT_PROFILE_BLOCKS more blocks a side run under torch.profiler, whose
   trace must hold each hand-written kernel as often as the counters say
   (so the launches a replay adds to the counters are held to the kernels
   that ran).  The graph's outputs equal the eager step's bit for bit; the
   eager side captured nothing; each graph step captured once and
   replayed on every block after its first.  The graph side's outputs are
   checked for shapes and dtypes and their tones decoded (≥ 15 dB SNR; the
   waterfall's in their bins); each path logs ms/block (the graph side's,
   with MS/s, its real-time multiple and peak memory), the host split
   (churn, dispatch, wait, deliver) of each side and round, each graph's
   capture ms and pool, the profiled blocks' kernel events and idle share,
   and the device's own time a block (each graph replayed back to back)
   with the idle share it gives; config #6 also what a control change
   costs its interactive bank at the next block (params rebuilt, then
   copied into the graph's static params).  The shapes the paths hand the
   AGC, the ADPCM encoders and the squelch are recorded and must be the
   ones phase 3 checked;
6. kernel device times (CUDA events, launches queued ahead of the device)
   beside their bounds, the plain versions and, for the fold, one PyTorch
   call computing the same function; the fold and the IIR warm and cold;
   the AGC, the ADPCM encoder and the squelch at every path's shape (the
   squelch also on its real and 100-window inputs, beside its launch plan
   and a cold device copy of x), warm and cold (each launch on its own copy
   of the inputs, none of them in the L2 cache); the row encoder also on
   the two 8.192 MS/s rows; the recurrences beside the time of their serial chain,
   measured as a per-step slope: the AGC on one row of 48 and of 96
   chunks, the ADPCM recurrence in lanes of 104 and of 200 nibbles (the
   shorter build, first checked against the plain recurrence and for the
   same main loop in its SASS), the row encoder on one row of 2064 and of
   4112 nibbles.
7. the port's web server (run after phase 5, inside its record of the
   kernels' shapes, and before the timings of phase 6): (a) the CLI as a
   user starts it, ``python -m openwebrx_tpu_torch --signal-demo --port
   N`` (a settings file only turns the web agents' downloads off), which
   builds the kernels and warms up before it listens, in CLI_PROCESSES
   fresh processes; in each, three WebSocket listeners, a connection each,
   tune to banks new to the process (the demo's NFM, AM and USB carriers,
   each tone at ≥ 15 dB; the first also runs tests/test_server.py's
   checks: handshake messages, smeter, the demo's carriers in their
   waterfall bins); then, while a fourth plays NFM, a second connection
   opens a USB listener with a PSK31 secondary; and SIGTERM stops it
   cleanly; it logs each listener's first audio after dspcontrol and after
   connect, the PSK31 connection's first secondary-FFT frame after its
   dspcontrol and the playing listener's largest audio gap in the 2 s
   after, each process's ``ready_s`` and warm-up seconds; then the
   startup split, in a fresh process (``chip_smoke.py --startup-split
   ROOT``): each step from the CUDA context to each listener's first
   audio, then one program of every secondary, DV and IQ-tap signature
   opened, run and closed in turn, each block timed with synchronizes at
   its edges and split by op, the warm-up's kernel launches and
   row-encoder shapes counted apart, printed as a ``{"startup_split":
   ...}`` line before the last lines. ``python3 chip_smoke.py --first-audio ROOT ...`` runs 7a's
   processes and the split alone for each checkout given (the parent's
   from ``git archive`` beside this one);
   (b) ``HttpServer(build_router())`` in this process on a looped seeded
   cu8 recording at 8.192 MS/s (config #6's rate, 0.2 s blocks, a
   compressed 4096-bin waterfall) with 64 WebSocket listeners, 32 USB, 16
   NFM and 16 AM on carriers of their own, each with the waterfall: every
   listener routed to its filterbank, its tone at ≥ 15 dB, its audio
   bytes within 10 % of nominal over a 15 s window, every block of the
   window launching SRV_LAUNCHES_PER_BLOCK, ``realtime_factor`` ≥ 1 on
   /metrics, no ERROR record; it logs ms/block, the host split, the
   first-audio latency from ``dspcontrol`` (p50, p95) and peak memory;
   (c) ``/api/profile`` on the running server returns a trace with CUDA
   kernel events, in which every block the trace holds whole (the
   kernels grouped by the loop's idle gaps) ran the hand-written kernels
   SRV_LAUNCHES_PER_BLOCK times; then 7b's server again in short sessions,
   its runtime built with the eager step or the graph in ALT_ORDER, each
   with its launches a block from the counters and from its profile's
   trace (held alike), host split and (graph) replay time; the eager
   sessions captured no graph.
8. config #5's USB bank sharded over ranks through
   ``openwebrx_tpu_torch.parallel`` (run after phase 7, inside phase 5's
   record of the kernels' shapes): (a) one rank over NCCL in this process:
   ``DistributedReceiver`` (ADPCM) against the plain ``ChannelizedBank``
   on the same blocks, bytes and stride states identical, and
   ``shard_channelized_bank`` + ``gather_channels`` identical too; tones,
   launches, ms/block beside the plain bank's, the collectives and the
   re-shard timed alone (at world size 1 they cross no link); (b)
   POD_RANKS worker processes (``chip_smoke.py --pod-worker``; on one card
   both on it over gloo through host memory, since NCCL takes one rank per
   card; with more cards NCCL, a card each), each fed only its slab of
   every block (int16 audio): every channel owned once, the ranks'
   checksums equal, the gathered audio within POD_AUDIO_LSB of one bank
   here, tones, each rank's launches and kernel shapes, its ms/block and
   its collectives' time.  ``python3 chip_smoke.py --pod-ranks 2 4`` runs
   8b alone at those world sizes (on a machine with as many cards: NCCL).
9. golden parity and the card-only tests (run after phase 6): (a) every
   scene of tests/test_torch_golden.py (``SCENES``: the seeded 2.4 MS/s
   capture through the selector, NFM, AM, USB, WFM, the full NFM chain with
   squelch, NR and AGC, the remez oracle and four front-end impairments) on
   the CPU port and on the card, each held to that file's bounds against
   the independent numpy/scipy oracle, every card run launching exactly the
   scene's kernels (the IIR; the squelch, IIR and AGC on the full chain),
   and each kernel at the shapes the scenes handed it against its plain
   version; (b) ``pytest --noconftest -m cuda tests/test_torch_card.py
   tests/test_torch_golden.py tests/test_torch_ref_*.py`` (``CARD_TESTS_ARGS``)
   in a fresh interpreter where jax cannot be imported, its pass, skip and
   fail counts on a line of their own (with one card, TestSecondCard
   skips), and each carrying file's ``[torch-ref]`` report: the
   reference's own device-path cases, the PFB serving path, the secondary
   bank, ``Fanout`` and the server among them; a failure, an error, no
   pass, a carried card case that did not pass or a kernel no carried case
   launched fails.

The last lines are the ``{"startup_split": ...}`` line, a ``{"kernels":
[...]}`` JSON line, the ``nvidia-smi`` name/power-limit line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import concurrent.futures
import ctypes
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FS = 49.152e6          # BASELINE config #5: 49.152 MS/s wideband input
M = 1024               # 1024 PFB channels at 48 kHz
CFG1_FS = 2.4e6        # BASELINE config #1: 2.4 MS/s, one NFM listener
CFG1_OFFSET = 145000.0
WARMUP_BLOCKS = 3
# Phase 5: each path's eager step (graph=False) against its graph, rounds
# of ALT_BLOCKS blocks in this order (E eager, G graph) after ALT_WARM
# blocks each, then ALT_PROFILE_BLOCKS each under torch.profiler; a graph
# replayed ALT_DEVICE_REPLAYS times back to back gives its device time
ALT_ORDER = (False, True, True, False, False, True)
ALT_BLOCKS = 6
ALT_WARM = 2
ALT_PROFILE_BLOCKS = 2
ALT_DEVICE_REPLAYS = 10
TONE_CHANNELS = (100, 517, 900)     # dials i (of the 1024) given a tone
TONE_AUDIO_HZ = 1000.0
FM_DEVIATION = {"nfm": 3000.0, "wfm": 75000.0}
TONE_SNR_MIN_DB = 15.0              # as tests/test_channelized_bank.py
FOLD_RTOL = 1e-5       # × max|v|: fp32 sums of P=16 terms, FMA vs mul+add
IIR_RTOL = 1e-5        # × max|y|: warp-scan order vs the plain doubling scan
SMALL_BANK_LSB = 4     # int16 audio, card vs CPU: cuFFT/cuDNN sum orders
SAM_RMS_LSB = 0.5      # sync AM: rms over a carrier channel (see phase 4)
RDS_RTOL = 1e-4        # × max|rds|: WFM's RDS aux, card vs CPU
# NVIDIA H100 SXM data sheet (700 W): HBM rate and non-tensor fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# 32-bit integer instructions per clock per SM at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
INT32_PER_CLOCK_PER_SM = 64
SLEEP_CYCLES_PER_S = 2.0e9   # ≥ the H100's SM clock: sleeps err long
L2_FLUSH_BYTES = 256 << 20   # read before cold launches: 5x the 50 MB L2
COLD_COPIES = 20             # launches timed cold, each on its own inputs
STEP_ITERS = 200             # launches per time of a per-step slope
# A second build of adpcm.cu with 52-byte strides: its lanes run the
# kernel's main loop (4 words of 8 nibbles) 3 times in place of 6
SHORT_STRIDE = 52
ADPCM_LOOP_NIBBLES = 32

SQUELCH_DB_TOL = 1e-3  # power_db: window sums in another order, re²+im² vs hypot²
WF_DB_TOL = 1e-2       # waterfall rows card vs CPU, bins within 60 dB of the peak
NEAR_PEAK_DB = 60.0
CHAIN_RTOL = 1e-3      # × max|y|: secondary chains card vs CPU (cuFFT, cuDNN sums)
DIBIT_AGREE = 0.98     # DV dibits card vs CPU: slicer thresholds may flip
CFG2_FS = 2.4e6        # BASELINE config #2: 2.4 MS/s, waterfall + SSB
CFG2_LISTENER = -262000.0   # fits PFB channel 57 (centre −262.5 kHz)
CFG2_EDGE = 618000.0        # 18 kHz off its channel centre: served full rate
CFG4_CHANNELS = 16     # BASELINE config #4: BPSK31 ×16 + USB ×16
CFG4_BATCH = 6         # blocks per delivery batch
WF_SIZE = 4096
# rows of 2048 and 4096 bins (+10 pad, to a multiple of 8): the row
# encoder's time per nibble is the slope between them
SEQ_ROW = 4112
SEQ_SHORT_ROW = 2064

# Phase 8: config #5's USB bank (M = 1024 at 49.152 MS/s, 0.05 s blocks,
# every channel assigned) sharded over ranks through openwebrx_tpu_torch.
# parallel: 8a one rank over NCCL in this process (ADPCM); 8b POD_RANKS
# worker processes (int16 audio, as the cluster's dry run), each fed only
# its slab of every block
POD_RANKS = 2
POD_BLOCKS = WARMUP_BLOCKS + 21
POD_AUDIO_LSB = 4      # int16, the ranks' channels vs one bank: cuFFT batches of T/n rows
POD_TIMEOUT_S = 300    # the workers' whole run, start-up included

# The shapes the full-width paths give the AGC (profile, x, chunk), the
# ADPCM encoders (samples) and the squelch (x, window), as phases 5, 7 and
# 8 record them (the server's SSB and AM banks share config #3's AGC and
# squelch shapes)
AGC_PATH_CASES = {"usb": ("SLOW", (M, 600), 50), "nfm": ("FAST", (M, 2400), 50),
                  "am": ("SLOW", (2 * M, 600), 50), "cfg1": ("FAST", (4800,), 50),
                  "cfg2": ("SLOW", (64, 600), 50), "cfg2 edge": ("SLOW", (16, 600), 50),
                  "cfg4": ("SLOW", (16, 1536), 48), "cfg3": ("SLOW", (64, 2400), 50),
                  "cfg6": ("SLOW", (256, 2400), 50), "cfg6 edge": ("SLOW", (16, 2400), 50),
                  "server nfm": ("FAST", (64, 9600), 50),
                  "pod2": ("SLOW", (M // POD_RANKS, 600), 50)}
ADPCM_PATH_SHAPES = {"usb": (M, 600), "nfm": (M, 600), "am": (2 * M, 600),
                     "wfm": (128, 9600), "cfg1": (1200,), "cfg2": (64, 600),
                     "cfg2 edge": (16, 600), "cfg6": (256, 2400), "cfg6 edge": (16, 2400),
                     "server": (64, 2400)}
SQUELCH_PATH_CASES = {"usb": ((M, 600), 600), "nfm": ((M, 2400), 2400),
                      "am": ((2 * M, 600), 600), "wfm": ((128, 50000), 12500),
                      "cfg1": ((4800,), 2400), "cfg2": ((64, 600), 600),
                      "cfg2 edge": ((16, 600), 600), "cfg4": ((16, 1536), 768),
                      "cfg3": ((64, 2400), 800), "cfg6": ((256, 2400), 800),
                      "cfg6 edge": ((16, 2400), 800), "server nfm": ((64, 9600), 3200),
                      "pod2": ((M // POD_RANKS, 600), 600)}
# one waterfall row a block; two at 8.192 MS/s (the threaded run)
ADPCM_SEQ_PATH_SHAPES = {(1, SEQ_ROW), (2, SEQ_ROW)}
# the first-order IIR (x) on the paths that run one: the NFM and WFM
# de-emphasis, the AM DC blocker, config #1's de-emphasis
IIR_PATH_CASES = {"nfm": (M, 2400), "am": (2 * M, 600), "wfm": (128, 9600),
                  "cfg1": (4800,), "server nfm": (64, 9600), "server am": (64, 2400)}
# the row encoder's real rows: config #2's waterfall (29 averaged frames of
# a 2.4 MS/s block) and the 49.152 MS/s one (600 frames), as (rate, block,
# frames a second, carriers)
SEQ_REAL_ROWS = {"cfg2 row": (2.4e6, 120000, 20.0, (-262000.0, 618000.0)),
                 "wf row": (49.152e6, 2457600, 9.0,
                            tuple(float((i - 512) * 48000) for i in (100, 517, 900))),
                 "8.192 rows": (8.192e6, 1638400, 9.0, (-1758500.0, 2000500.0))}
# BASELINE configs #3 and #6 through the port's DeviceRuntime: 8.192 MS/s
# of uint8 wire IQ, 0.2 s device blocks, 256 PFB channels of 32 kHz
RT_FS = 8.192e6
RT_LOOP_BLOCKS = 2          # the source's loop: 0.4 s, every tone continuous
RT_NOISE, RT_TONE_AMP = 0.03, 0.05
CFG3_DIALS = 64
# config #6: its warm-up holds the first two edge drags (blocks 4 and 12),
# so the full-rate bank runs its eager block and its capture before round
# 1; its rounds are ALT_ORDER twice over
CFG6_LISTENERS, CFG6_WARM, CFG6_ORDER = 256, 13, ALT_ORDER * 2
CFG6_TONES = (248, 249, 250, 251)     # listeners the churn never moves
RT_DEADLINE_S = 120.0       # the threaded run waits at most this long
RT_THREADED_ROWS, RT_THREADED_FRAMES = 20, 10   # ... for this many rows and frames

# Phase 7a: CLI_PROCESSES fresh server processes (--signal-demo, 2.4 MS/s),
# each with one WebSocket listener, a connection of its own, on each of
# the demo's NFM, AM and USB carriers (mode, dial, tone Hz): three banks
# new to the process (pfbi:nfm; pfbi:am then the full-rate am bank, since
# a listener switches mode before it retunes; pfbi:ssb).  A chat message
# sent behind a listener's dspcontrol marks where its parameters took
# effect (the server handles a client's messages in order): its first
# audio is the first audio frame after the echo
CLI_PROCESSES = 3
CLI_LISTENERS = (("nfm", 145000.0, 1000.0), ("am", -200000.0, 800.0),
                 ("usb", 300000.0, 1500.0))
CLI_LISTEN_S = 2.0
CLI_MARK = {"type": "sendmessage", "text": "parameters sent", "name": "chip_smoke"}
# the runtime the server builds for a source with no settings of its own
# (sdr.py SdrService.get_device's defaults), as the startup split builds it
SERVER_RUNTIME_KW = {"fft_size": 4096, "fft_fps": 9.0, "compression": "adpcm",
                     "fft_compression": "adpcm", "capacity": 16,
                     "target_seconds": 0.1}
SPLIT_STEADY_BLOCKS = 2      # blocks after a listener's first audio
SPLIT_PROGRAM_BLOCKS = 12    # the most blocks the split runs a program for
# 7a's secondary step: while an NFM listener plays, a second connection
# opens a USB listener with a PSK31 secondary
CLI_SECONDARY = ("usb", -200000.0, "bpsk31")
CLI_PLAY_S = 1.0             # the NFM listener plays this long before it
CLI_GAP_WINDOW_S = 2.0       # its audio gaps are read over this long after

# Phase 7: the port's web server.  7a: the CLI's --signal-demo (2.4 MS/s);
# 7b: in process, a looped seeded cu8 file at config #6's 8.192 MS/s,
# 0.2 s blocks, a compressed 4096-bin waterfall and 64 WebSocket
# listeners (32 USB, 16 NFM, 16 AM) on carriers of their own
SRV_MODES = ("usb",) * 32 + ("nfm",) * 16 + ("am",) * 16
SRV_FILE_SECONDS = 0.4       # the file's loop: every carrier whole cycles
SRV_NOISE, SRV_CARRIER_AMP = 0.01, 0.03   # 64 carriers: ~5 sigma to clipping
# each block: the SSB, NFM and AM filterbanks' fold, squelch, AGC and ADPCM
# encode, the NFM de-emphasis and the AM DC blocker, and one row-encoder
# launch for the waterfall's two rows
SRV_LAUNCHES_PER_BLOCK = {"fold.cu": 3, "adpcm.cu": 3, "iir.cu": 2, "agc.cu": 3,
                          "squelch.cu": 3, "adpcm_seq.cu": 1}
# a trace of the server's loop: kernels further apart than this are in two
# blocks (a block's kernels run within ~50 ms, the loop's period is 200 ms)
SRV_BLOCK_GAP_MS = 60.0
SRV_WARM_S = 3.0             # after every listener heard its first audio
SRV_WINDOW_S = 15.0          # the timed window
SRV_RATE_TOL = 0.10          # audio bytes a second against nominal
SRV_PROFILE_S = 1.0          # 7c: /api/profile?seconds=
# 7b alternated (eager and graph sessions in ALT_ORDER): after every
# listener heard audio, a warm-up, the timed window and a profile
SRV_ALT_WARM_S, SRV_ALT_WINDOW_S, SRV_ALT_PROFILE_S = 1.0, 3.0, 1.0
SRV_DEADLINE_S = 120.0       # any wait of phase 7 (start-up, first audio)
# 12 kHz IMA ADPCM: 4 bits a sample plus an 8-byte SYNC header every 100
# bytes (ops/adpcm.py SyncFramer)
SRV_AUDIO_BYTES_PER_S = 12000 / 2 * 1.08
# Phase 9: the golden scenes (tests/test_torch_golden.py) on the card against
# the oracle, then the card-only tests through pytest with jax unimportable
# (tests/conftest.py imports jax, hence --noconftest): the kernels against
# their plain versions, the golden scenes' cuda cases and the reference's own
# device-path cases carried onto the port (tests/test_torch_ref_*.py), each
# carrying file reporting its card cases and kernel launches on a line of
# its own (tests/torch_ref_device.py card_report).  An import finder
# refuses jax, as where it is not installed: a None in sys.modules["jax"]
# would break scipy's array-API check, which reads sys.modules["jax"].Array
CARD_TESTS_ARGS = ("--noconftest", "-p", "no:cacheprovider", "-q", "-rs", "-m", "cuda",
                   "tests/test_torch_card.py", "tests/test_torch_golden.py",
                   "tests/test_torch_ref_ops.py", "tests/test_torch_ref_secondary.py",
                   "tests/test_torch_ref_voice.py", "tests/test_torch_ref_runtime.py",
                   "tests/test_torch_ref_serving.py", "tests/test_torch_ref_server.py")
CARD_TESTS_PRELUDE = """
import sys
class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, NoJax())
import pytest
sys.exit(pytest.main(sys.argv[1:]))
"""
CARD_TESTS_TIMEOUT_S = 600

ROOT = Path(__file__).resolve().parent


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_cuda(fn, iters: int, torch, flush=None) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls,
    from CUDA events.  The stream is first held busy for longer than the
    host takes to enqueue the calls, so the events time the device alone
    and not the Python wrappers' launch rate.  ``fn`` may be a list of
    calls, one per launch: cold timing gives each its own copy of the
    inputs and a ``flush`` tensor (larger than the L2 cache) that is read
    before the timed launches, so no launch finds its inputs in L2."""
    fns = fn if isinstance(fn, list) else [fn] * iters
    fns[0]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in fns:
        f()
    enqueue_s = time.perf_counter() - t0
    if flush is not None:
        flush.sum()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * enqueue_s + 0.01) * SLEEP_CYCLES_PER_S))
    start.record()
    for f in fns:
        f()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / len(fns)


def int16_audio(torch, gen, dev, rows, n):
    """(rows, n) int16 of tone + noise, with clipped channels and
    full-scale square waves mixed in."""
    t = torch.arange(n, device=dev, dtype=torch.float32)
    f = torch.linspace(200.0, 5800.0, rows, device=dev)[:, None]
    audio = (0.6 * torch.sin(2 * np.pi * f * t / 12000.0)
             + 0.3 * torch.randn(rows, n, generator=gen, device=dev))
    audio[::7] *= 4.0                                   # clipped channels
    audio[3::11] = torch.where(audio[3::11] > 0, 1.0, -1.0)   # ±full scale
    return torch.clamp(audio * 32767.0, -32768, 32767).to(torch.int16)


def iir_input(torch, gen, dev, shape):
    """Seeded first-order IIR input: x of ``shape`` and a random
    (x_prev, y_prev) state."""
    return ((torch.randn(shape[:-1], generator=gen, device=dev),
             torch.randn(shape[:-1], generator=gen, device=dev)),
            torch.randn(shape, generator=gen, device=dev) * 0.3)


def waterfall_row(torch, gen, dev, label):
    """The row encoder's input for one block's real waterfall rows, (rows,
    SEQ_ROW) int16: the float dB rows that ``FftChain`` makes on the card
    from the second of two seeded blocks of SEQ_REAL_ROWS[label], through
    ``fft_row_samples``."""
    from openwebrx_tpu_torch.models.receiver import FftChain
    from openwebrx_tpu_torch.ops import adpcm
    from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
    from openwebrx_tpu_torch.runtime.chain import Program
    fs, block, fps, carriers = SEQ_REAL_ROWS[label]
    prog = Program(FftChain(WF_SIZE, fps, compress=False),
                   StreamSpec(Format.COMPLEX_FLOAT, fs), block, device=dev)
    rows = [prog.process(b)[0] for b in
            seeded_blocks(torch, gen, dev, fs, block, 2, carriers, "usb", noise=0.05)]
    return adpcm.fft_row_samples(torch.from_numpy(rows[-1]).to(dev))


def agc_input(torch, gen, dev, shape):
    """Seeded AGC input: x of ``shape`` with channel levels spread over
    80 dB, and a random (gain, hang) start state."""
    rows = int(np.prod(shape[:-1]))
    x = (torch.randn(rows, shape[-1], generator=gen, device=dev)
         * 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 4 - 3)
         ).reshape(shape)
    state = (torch.rand(shape[:-1], generator=gen, device=dev) * 100 + 0.01,
             torch.randint(0, 31, shape[:-1], generator=gen, device=dev,
                           dtype=torch.int32))
    return state, x


def adpcm_input(torch, gen, dev, shape, blocks=1):
    """Seeded ADPCM encoder input: a random (predictor, index) start state
    and ``blocks`` int16 audio blocks of ``shape``."""
    rows = int(np.prod(shape[:-1]))
    state = (torch.randint(-32768, 32767, shape[:-1], generator=gen,
                           device=dev, dtype=torch.int32),
             torch.randint(0, 89, shape[:-1], generator=gen, device=dev,
                           dtype=torch.int32))
    return state, [int16_audio(torch, gen, dev, rows, shape[-1]).reshape(shape)
                   for _ in range(blocks)]


def sass_loop_instructions(lib) -> int:
    """Instructions in the widest loop of the built library ``lib``: from
    the target of its widest predicated backward branch to that branch, in
    ``cuobjdump -sass`` (next to ``nvcc``)."""
    from openwebrx_tpu_torch.kernels import _nvcc
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    addrs, loops = [], []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass):
        a = int(m.group(1), 16)
        addrs.append(a)
        b = re.search(r"@!?U?P\w+\s+BRA(?:\.\S+)?\s+(0x[0-9a-f]+)", m.group(2))
        if b and int(b.group(1), 16) < a:
            loops.append((a - int(b.group(1), 16), int(b.group(1), 16), a))
    check(loops, f"no loop in the SASS of {lib}")
    _, lo, hi = max(loops)
    return sum(lo <= a <= hi for a in addrs)


def boundary_strides(table, stride):
    """(89, 6·stride) int16: per table value k, three strides whose sums
    of |differences| are (2·stride − 1)·k − 1, ·k and ·k + 1 — mean |dx|
    just below, at and just above every step of the index estimate."""
    n1 = 2 * stride - 1
    rows = []
    for k in table:
        row = []
        for total in (n1 * int(k) - 1, n1 * int(k), n1 * int(k) + 1):
            q, r = divmod(total, n1)
            d = np.full(n1, q)
            d[:r] += 1                              # steps of q or q + 1
            sign = np.where(np.arange(n1) % 2 == 0, 1, -1)
            row.append(-((q + 1) // 2) + np.concatenate([[0], np.cumsum(sign * d)]))
        rows.append(np.concatenate(row))
    out = np.stack(rows)
    assert np.abs(out).max() <= 32767
    return out.astype(np.int16)


def bits(torch, t):
    """A tensor's bit pattern: NaN samples an open squelch passes on compare
    equal, and +0.0 differs from −0.0."""
    return (torch.view_as_real(t) if t.is_complex() else t).view(torch.int32)


def squelch_input(torch, gen, dev, shape, window, dtype=None):
    """Seeded squelch input: rows over 40 dB of level with per-row
    thresholds within ±6 dB of it, a random (open, hang) start state, and
    (with four rows or more) a silent row and a row half NaN."""
    dtype = dtype or torch.complex64
    rows, n = int(np.prod(shape[:-1])), shape[-1]
    scale = 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 4 - 4)
    x = torch.randn(rows, n, generator=gen, device=dev, dtype=dtype) * scale
    if rows >= 4:
        x[0] = 0
        x[1, : n // 2] = float("nan")
    level = (10 * torch.log10(scale[:, 0] ** 2)
             + torch.rand(rows, generator=gen, device=dev) * 12 - 6)
    lead = tuple(shape[:-1])
    state = ((torch.rand(rows, generator=gen, device=dev) > 0.5).reshape(lead),
             torch.randint(0, 3, (rows,), generator=gen, device=dev,
                           dtype=torch.int32).reshape(lead))
    return state, level.reshape(lead).contiguous(), x.reshape(shape).contiguous()


def squelch_bursts(torch, gen, dev, shape, window):
    """Seeded complex squelch input whose every window lies 10 dB above or
    below its row's level at random (three in ten above), so that the hang
    opens and runs out all along a row, however short its windows, and no
    window is near its level; a random (open, hang) start state."""
    rows, n = shape
    level = torch.rand(rows, generator=gen, device=dev) * 60 - 60
    above = torch.rand(rows, n // window, generator=gen, device=dev) < 0.3
    amp = 10.0 ** ((level[:, None] + torch.where(above, 10.0, -10.0)) / 20)
    phase = torch.rand(rows, n, generator=gen, device=dev) * (2 * np.pi)
    x = torch.polar(amp.repeat_interleave(window, dim=1), phase)
    state = (torch.rand(rows, generator=gen, device=dev) > 0.5,
             torch.randint(0, 3, (rows,), generator=gen, device=dev, dtype=torch.int32))
    return state, level, x.contiguous()


def squelch_plan_of(x, window):
    """The launch plan ops/squelch.py gives the squelch kernel for x."""
    from openwebrx_tpu_torch.ops import squelch
    rows = int(np.prod(x.shape[:-1]))
    return squelch.squelch_plan(rows, x.shape[-1], window, 2 if x.is_complex() else 1,
                                aligned=x.data_ptr() % 16 == 0,
                                sms=squelch._sms(x.device.index))


def squelch_bytes(shape, window, complex_=True):
    """x in, y out, power_db out, the level and (open, hang) in and out."""
    n = int(np.prod(shape))
    rows = n // shape[-1]
    return (n * (8 if complex_ else 4) * 2 + rows * (shape[-1] // window) * 4
            + rows * (4 + 2 * (1 + 4)))


def seq_bytes(rows, ns):
    """int16 samples and the start state in; bytes, stride states and the
    final state out."""
    return rows * (ns * 2 + ns // 2 + 4 * (ns // 200) + 4 * 4)


def near_peak_err(got, ref):
    """max |got − ref| (dB) over the bins within NEAR_PEAK_DB of each row's
    peak."""
    ref, got = np.atleast_2d(ref), np.atleast_2d(got)
    mask = ref >= ref.max(axis=-1, keepdims=True) - NEAR_PEAK_DB
    return float(np.abs(got - ref)[mask].max())


def decoded_row(raw, nbytes, adpcm):
    """One compressed waterfall row (its wire bytes) → dB."""
    dec, _ = adpcm.adpcm_decode_np(bytes(raw[:nbytes]))
    return dec[adpcm.COMPRESS_FFT_PAD_N:].astype(np.float64) / 100.0


def agc_bytes(shape):
    """x in, y out, (gain, hang) in and out."""
    n = int(np.prod(shape))
    return n * 8 + 4 * 4 * (n // shape[-1])


def adpcm_bytes(shape):
    """int16 samples and the (predictor, index) state in; bytes, stride
    states and the new state out."""
    n = int(np.prod(shape))
    channels = n // shape[-1]
    return n * 2 + n // 2 + 4 * (n // 200) + 4 * 4 * channels


def tone_snr(audio, f_tone, fs_audio):
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    freqs = np.fft.rfftfreq(len(audio), 1 / fs_audio)
    band = (freqs > f_tone * 0.9) & (freqs < f_tone * 1.1)
    rest = (freqs > 50) & ~band
    return 10 * np.log10(spec[band].sum() / spec[rest].sum())


def decode_channel(blocks, adpcm):
    """ADPCM bytes + stride reseeds of one channel over consecutive blocks
    → int16 audio, each stride decoded from its reseed state."""
    out = []
    state = (0, 0)
    for data, strides in blocks:
        for k in range(len(strides)):
            chunk = bytes(data[k * adpcm.STATE_STRIDE:(k + 1) * adpcm.STATE_STRIDE])
            d, _ = adpcm.adpcm_decode_np(chunk, state)
            out.append(d)
            state = adpcm.unpack_codec_state(int(strides[k]))
    return np.concatenate(out)


def modulated(torch, n, fs, fc, kind, amp):
    """A carrier at fc (Hz) with a TONE_AUDIO_HZ tone on it, complex64:
    ``usb`` a tone fc + f above the dial, ``am`` 60 % AM, ``nfm``/``wfm``
    FM at that mode's deviation.  n: float64 sample indices."""
    fa = TONE_AUDIO_HZ
    t = n / fs
    two_pi = 2 * np.pi
    amp_t = torch.full_like(t, amp)
    if kind == "usb":
        ph = torch.remainder(n * ((fc + fa) / fs), 1.0) * two_pi
    elif kind == "am":
        ph = torch.remainder(n * (fc / fs), 1.0) * two_pi
        amp_t = amp * (1 + 0.6 * torch.sin(two_pi * fa * t))
    else:
        dev = FM_DEVIATION[kind]
        ph = (torch.remainder(n * (fc / fs), 1.0) * two_pi
              + (dev / fa) * (1 - torch.cos(two_pi * fa * t)))
    return torch.polar(amp_t, ph).to(torch.complex64)


def seeded_blocks(torch, gen, dev, fs, block, n_blocks, carriers, kind,
                  noise=0.2, amp=0.4):
    """Seeded noise plus one modulated carrier at each frequency, made on
    the device before a run (set-up), phase-continuous across blocks."""
    out = []
    for b in range(n_blocks):
        n = torch.arange(block, device=dev, dtype=torch.float64) + b * block
        x = torch.complex(torch.randn(block, generator=gen, device=dev),
                          torch.randn(block, generator=gen, device=dev)) * noise
        for fc in carriers:
            x = x + modulated(torch, n, fs, fc, kind, amp)
        out.append(x.contiguous())
    torch.cuda.synchronize()
    return out


def drive(label, dispatch, fetch, blocks, kernels, torch, dev):
    """Run one path: every kernel count set to 0 just before it and read
    just after; the next block is dispatched before the previous one is
    fetched; blocks after WARMUP_BLOCKS are timed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.ALL:
        k.launches = 0
    results, pending, t_start = [], None, None
    for b, x in enumerate(blocks):
        if b == WARMUP_BLOCKS:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        nxt = dispatch(x)
        if pending is not None:
            results.append(fetch(*pending))
        pending = nxt
    results.append(fetch(*pending))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {k.source.name: k.launches for k in kernels.ALL}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"[{label}] launches: {launches} (blocks fed: {len(blocks)})")
    check(len(results) == len(blocks), f"{label}: missing results")
    return results, wall, launches, peak_mib


def report(label, smi, wall, n_timed, block, fs, peak_mib):
    msps = n_timed * block / wall / 1e6
    log(f"[{label}] {smi}: {n_timed} blocks of {block} samples in "
        f"{wall * 1e3:.3f} ms (results fetched to host every block): "
        f"{msps:.3f} MS/s = {msps / (fs / 1e6):.3f}x real time; "
        f"{wall / n_timed * 1e3:.3f} ms/block; peak device memory "
        f"{peak_mib:.1f} MiB")
    return {"ms_per_block": wall / n_timed * 1e3, "msps": msps,
            "realtime_x": msps / (fs / 1e6), "peak_mib": peak_mib}


def check_launches(label, launches, expected):
    for name, want in expected.items():
        check(launches[name] == want,
              f"{label}: {name} launched {launches[name]} times, expected {want}")


class LoopSource:
    """A duck-typed source for the port's DeviceRuntime (``id``,
    ``get_sample_rate``, ``block_size``, ``start``, ``read_block``): seeded
    complex noise plus a USB tone TONE_AUDIO_HZ above each dial, made once
    on the host when the runtime has set ``block_size``, as uint8 wire
    pairs (bias 127.4, ±128 full scale), RT_LOOP_BLOCKS blocks looped;
    ``read_block`` hands out the next block at once."""

    def __init__(self, label, fs, dials, seed):
        self.id, self.fs, self.dials, self.seed = label, fs, list(dials), seed
        self.block_size = 0
        self._wire, self._pos = None, 0

    def get_sample_rate(self):
        return self.fs

    def start(self):
        if self._wire is not None:
            return
        n = RT_LOOP_BLOCKS * self.block_size
        rng = np.random.default_rng(self.seed)
        x = RT_NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        t = np.arange(n, dtype=np.float64)
        for dial in self.dials:
            f = dial + TONE_AUDIO_HZ
            check(abs(f * n / self.fs - round(f * n / self.fs)) < 1e-6,
                  f"tone at {f} Hz is not continuous over the source's loop")
            x += RT_TONE_AMP * np.exp(2j * np.pi * np.remainder(t * (f / self.fs), 1.0))
        packed = np.stack([x.real, x.imag], axis=-1)
        self._wire = np.clip(packed * 128.0 + 127.4, 0, 255).astype(np.uint8)

    def read_block(self, timeout=1.0):
        blk = self._wire[self._pos:self._pos + self.block_size]
        self._pos = (self._pos + self.block_size) % len(self._wire)
        return blk


class ErrorRecords:
    """A logging handler that keeps every ERROR record (the runtime's loop
    logs a failed block and carries on)."""

    def __init__(self):
        import logging
        self.records = []
        self.handler = logging.Handler(logging.ERROR)
        self.handler.emit = self.records.append

    def check(self, label):
        check(not self.records, f"{label}: the runtime logged errors: "
              + "; ".join(r.getMessage() + (f" ({r.exc_info[1]!r})" if r.exc_info else "")
                          for r in self.records))


def decode_wire(frames, adpcm):
    """SYNC-framed IMA ADPCM wire bytes (a listener's audio) → int16."""
    data = b"".join(frames)
    out, pos, state = [], 0, (0, 0)
    while pos < len(data):
        if data[pos:pos + 4] == b"SYNC":
            idx, pred = np.frombuffer(data[pos + 4:pos + 8], "<i2")
            state = (int(pred), int(idx))
            pos += 8
        chunk = data[pos:pos + adpcm.SYNC_INTERVAL]
        pos += len(chunk)
        pcm, state = adpcm.adpcm_decode_np(chunk, state)
        out.append(pcm)
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def pfb_dial(k, fs, m):
    """Channel k's centre (negative above fs/2) + 500 Hz, as bench.py
    places configs #3 and #6."""
    freq = k * fs / m
    return (freq - fs if freq >= fs / 2 else freq) + 500.0


def launches_per_block(fold=0, adpcm_=0, iir_=0, agc_=0, squelch_=0, seq=0):
    return {"fold.cu": fold, "adpcm.cu": adpcm_, "iir.cu": iir_, "agc.cu": agc_,
            "squelch.cu": squelch_, "adpcm_seq.cu": seq}


def secondary_bank_check(torch, dev):
    """Phase 4: the runtime's SecondaryBank on the card (two BPSK31 slots
    fed device chunks of another size than its block, the FFT rows of one
    encoded on the card) against the same bank on the CPU fed the same
    samples; the card takes the CPU bank's state after the first bank
    block.  The host text decoder is a stub: only the device side is
    compared (symbols, and the wire rows' count, length and peak bin)."""
    import types
    from openwebrx_tpu_torch.ops import adpcm
    from openwebrx_tpu_torch.runtime import device as rtdev
    from openwebrx_tpu_torch.runtime.chain import tree_map
    stub = types.SimpleNamespace(
        VaricodeDecoder=lambda: types.SimpleNamespace(decode=lambda bits: ""),
        dbpsk_bits=lambda symbols: symbols)
    fs, offsets = 48000.0, (1200.0, -2500.0)
    banks, got = {}, {}
    for where in ("cpu", dev):
        ns = types.SimpleNamespace(in_rate=fs, device=where, host=stub)
        banks[where] = rtdev.SecondaryBank(ns, "bpsk31", capacity=2)
        got[where] = {"y": [], "rows": []}
        for off in offsets:
            h = rtdev.SecondaryHandle(ns, "bpsk31", off, banks[where])
            h.fft_cb = got[where]["rows"].append if off > 0 else None

            def deliver(y, payloads, h=h, out=got[where]):
                if h.fft_cb is not None:
                    out["y"].append(y)
                rtdev.SecondaryHandle._deliver(h, y, payloads)
            h._deliver = deliver
    block = banks["cpu"].block
    rng = np.random.default_rng(31)
    n = np.arange(4 * block)
    sym = np.repeat(np.cumprod(np.where(rng.integers(0, 2, len(n) // 1536 + 1), 1, -1)),
                    1536)[: len(n)]
    x = sum(0.4 * sym * np.exp(2j * np.pi * o / fs * n) for o in offsets)
    x = (x + 0.02 * (rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
         ).astype(np.complex64)
    xd = torch.from_numpy(x).to(dev)
    for where in ("cpu", dev):
        banks[where].feed(x[:block] if where == "cpu" else xd[:block])
    banks[dev].program.state = tree_map(lambda t: t.to(dev), banks["cpu"].program.state)
    step = block // 3 + 7
    for a in range(block, len(x), step):
        banks["cpu"].feed(x[a:a + step])
        banks[dev].feed(xd[a:a + step])
    yc, yd = got["cpu"]["y"], got[dev]["y"]
    check(len(yd) == len(yc) == 4, f"SecondaryBank: {len(yd)} card and {len(yc)} CPU blocks")
    err = max(float(np.abs(d - c).max() / np.abs(c).max()) for d, c in zip(yd[1:], yc[1:]))
    rc, rd = got["cpu"]["rows"], got[dev]["rows"]
    nb = adpcm.wire_bytes_per_row(2048)
    peaks = [(int(np.argmax(decoded_row(a, nb, adpcm))), int(np.argmax(decoded_row(b, nb, adpcm))))
             for a, b in zip(rd, rc)]
    log(f"[check] SecondaryBank bpsk31 (2 slots, device chunks of {step}) on the card vs "
        f"the CPU: symbols max diff {err:.2e} of max|y| from bank block 1 (tolerance "
        f"{CHAIN_RTOL}); {len(rd)} FFT rows encoded on the card, {len(rc)} on the CPU, "
        f"peak bins {peaks}")
    check(err <= CHAIN_RTOL and len(rd) == len(rc) > 0
          and all(len(r) == nb for r in rd + rc)
          and all(abs(a - b) <= 1 for a, b in peaks),
          "SecondaryBank on the card disagrees with the CPU")


def cfg3_runtime(dev, graph=True):
    """Config #3 (bench.py:347-402) through the port's DeviceRuntime: 64
    background USB dials on distinct PFB channels, raw audio in 6-block
    batches, pipeline depth 2, its banks built with ``graph`` → (runtime,
    source, dials, the dials given a tone, {dial: audio chunks})."""
    from openwebrx_tpu_torch.runtime import device as rtdev
    from torch_graph_scenes import runtime_graph
    m3 = 256
    dials = [pfb_dial((i * (m3 // 72) + 2) % m3, RT_FS, m3) for i in range(CFG3_DIALS)]
    tones = (0, 21, 42, 63)
    src = LoopSource("cfg3", RT_FS, [dials[i] for i in tones], seed=3)
    audio = {i: [] for i in range(CFG3_DIALS)}
    with runtime_graph(graph):
        rt = rtdev.DeviceRuntime(src, target_seconds=0.1, service_delivery_seconds=0.6,
                                 pipeline_depth=2, device=dev)
        check(rt._pfb_channels() == m3 and rt.block == 1638400,
              f"config #3 plan: {rt._pfb_channels()} channels, block {rt.block}")
        for i, dial in enumerate(dials):
            h = rt.open_channel("usb", dial, service=True)
            h.audio_cb = lambda wire, hd=False, i=i: audio[i].append(wire)
    return rt, src, dials, tones, audio


# config #6's churn: a dial that straddles a channel edge of its 256-channel
# filterbank (served full rate), and the dial a listener retunes to
CFG6_EDGE = RT_FS / 256 * 1.5 - 200.0


def cfg6_dial(j):
    return float(np.fft.fftfreq(256, 1 / RT_FS)[(j * 7 + 3) % 256] + 600.0)


def cfg6_runtime(dev, label, seed, graph=True):
    """Config #6 (bench.py:498-583) through the port's DeviceRuntime: 256
    interactive ADPCM listeners on a 256-channel filterbank, depth 3, the
    full-rate bank built once by a dial dragged to a channel edge and
    back, the banks built with ``graph`` → (runtime, source, handles,
    {listener: wire frames})."""
    from openwebrx_tpu_torch.runtime import device as rtdev
    from torch_graph_scenes import runtime_graph
    src = LoopSource(label, RT_FS, [], seed=seed)
    frames = {i: [] for i in range(CFG6_LISTENERS)}
    handles = []
    with runtime_graph(graph):
        rt = rtdev.DeviceRuntime(src, target_seconds=0.1, capacity=16, pfb_capacity=256,
                                 pipeline_depth=3, device=dev)
        m = rt._pfb_m_for("ssb")
        dials = [pfb_dial((i * (m // 256) + i // 128) % m, RT_FS, m)
                 for i in range(CFG6_LISTENERS)]
        src.dials = [dials[i] for i in CFG6_TONES]
        for i, dial in enumerate(dials):
            h = rt.open_channel("usb", dial)
            h.audio_cb = lambda wire, hd=False, i=i: frames[i].append(wire)
            handles.append(h)
        check(m == 256 and {h.bucket_key for h in handles} == {"pfbi:ssb"},
              f"{label}: {m} channels, listeners in {sorted({h.bucket_key for h in handles})}")
        handles[0].set_offset(CFG6_EDGE)           # the full-rate bank, built once
        check(handles[0].bucket_key == "ssb", f"{label}: the edge dial is not served full rate")
        handles[0].set_offset(cfg6_dial(0))
        check(handles[0].bucket_key == "pfbi:ssb", f"{label}: the edge dial did not come back")
    return rt, src, handles, frames


class Cfg6Churn:
    """Config #6's churn before block i: four retunes, and every 8th block
    a listener dragged across a channel edge (to the full-rate bank) and
    back the block after; ``counts`` tallies them."""

    def __init__(self, rt, handles):
        self.rt, self.handles = rt, handles
        self.counts = {"retunes": 0, "migrations": 0, "full_rate_blocks": 0,
                       "dragged": None}

    def __call__(self, i):
        churn, handles = self.counts, self.handles
        if churn["dragged"] is not None:       # back from the edge
            h = churn["dragged"]
            h.set_offset(cfg6_dial(i))
            check(h.bucket_key == "pfbi:ssb", f"cfg6: block {i}: the dragged dial "
                  f"is in {h.bucket_key}, not back in pfbi:ssb")
            churn["dragged"] = None
        for j in range(4):
            h = handles[(i * 4 + j) % len(handles)]
            h.set_offset(cfg6_dial(i * 4 + j))
            churn["retunes"] += 1
        if i % 8 == 4:
            h = handles[(i * 13) % len(handles)]
            h.set_offset(CFG6_EDGE)
            check(h.bucket_key == "ssb", f"cfg6: block {i}: the edge dial is in "
                  f"{h.bucket_key}, not served full rate")
            churn["dragged"] = h
            churn["migrations"] += 1
        churn["full_rate_blocks"] += int(self.rt.banks["ssb"].n_active > 0)


# -- phase 5: every path at full width, its eager step against its graph -----
def pendings_in(obj):
    """Every Pending in a dispatch's return (tuples, lists, dicts)."""
    from openwebrx_tpu_torch.runtime.chain import Pending
    if isinstance(obj, Pending):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from pendings_in(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from pendings_in(o)


def steps_of(*objs):
    """The block steps (``GraphStep``) of banks, programs and runtimes."""
    out = []
    for o in objs:
        if hasattr(o, "banks"):            # a DeviceRuntime
            out += steps_of(*o.banks.values(), o.fft_program)
        elif hasattr(o, "step"):
            out.append(o.step)
        else:
            out.append(o.program.step)
    return out


def host_split():
    return dict.fromkeys(("churn", "dispatch", "wait", "deliver"), 0.0)


def same_tree(a, b) -> bool:
    """Two trees of numpy arrays (and bytes) bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, bytes):
        return a == b
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


class PipeSide:
    """One side of a path fed device blocks: ``dispatch(x)`` returns what
    ``fetch(*it)`` takes; a block is dispatched before the one before it is
    fetched.  ``blocks`` counts the blocks run so far.  Host time:
    dispatch, the wait for the block's copies (its events), deliver (the
    fetch to numpy)."""

    def __init__(self, xs, dispatch, fetch, objs):
        self.xs, self.dispatch, self.fetch, self.objs = xs, dispatch, fetch, objs
        self.results, self.blocks = [], 0

    def run(self, n, spent):
        pending = None
        for x in self.xs[self.blocks:self.blocks + n]:
            t0 = time.perf_counter()
            nxt = self.dispatch(x)
            spent["dispatch"] += time.perf_counter() - t0
            if pending is not None:
                self._fetch(pending, spent)
            pending = nxt
        self._fetch(pending, spent)
        self.blocks += n
        return n

    def _fetch(self, pending, spent):
        t0 = time.perf_counter()
        for p in pendings_in(pending):
            if p.event is not None:
                p.event.synchronize()
        t1 = time.perf_counter()
        self.results.append(self.fetch(*pending))
        spent["wait"] += t1 - t0
        spent["deliver"] += time.perf_counter() - t1


class BatchSide(PipeSide):
    """Config #4's side: blocks dispatched without a fetch, a batch of
    CFG4_BATCH started behind one event and fetched after the next batch
    was joined."""

    def __init__(self, xs, prog):
        super().__init__(xs, None, None, [prog])
        self.prog = prog

    def run(self, n, spent):
        check(n % CFG4_BATCH == 0, f"cfg4: {n} blocks are not whole batches")
        batch, joined = [], []
        for x in self.xs[self.blocks:self.blocks + n]:
            t0 = time.perf_counter()
            batch.append(self.prog.dispatch_quiet(x))
            if len(batch) == CFG4_BATCH:
                joined.append(self.prog.join_pending(batch))
                batch = []
            spent["dispatch"] += time.perf_counter() - t0
            if len(joined) >= 2:
                self._batch(joined.pop(0), spent)
        while joined:
            self._batch(joined.pop(0), spent)
        self.blocks += n
        return n

    def _batch(self, joined, spent):
        t0 = time.perf_counter()
        for p in pendings_in(joined):
            if p.event is not None:
                p.event.synchronize()
        t1 = time.perf_counter()
        self.results += self.prog.fetch_many(*joined)
        spent["wait"] += t1 - t0
        spent["deliver"] += time.perf_counter() - t1


class RuntimeSide:
    """One side of a DeviceRuntime path: ``n`` blocks of its source
    through the runtime's own pipeline (dispatch, complete the oldest once
    ``pipeline_depth`` are in flight), ``churn(i)`` before block i, all in
    flight completed at the end of a run; ``results`` are the callbacks'
    deliveries.  The host clock splits a block into the churn, dispatch
    (upload, parameters, launches), the wait for its copies and delivery
    (numpy, framing, callbacks)."""

    def __init__(self, rt, src, results, churn=None):
        self.rt, self.src, self.results, self.churn = rt, src, results, churn
        self.objs, self.blocks, self.spent = [rt], 0, host_split()
        src.start()
        dispatch, complete = rt._dispatch_block, rt._complete_block

        def timed_dispatch(block):
            t0 = time.perf_counter()
            out = dispatch(block)
            self.spent["dispatch"] += time.perf_counter() - t0
            return out

        def timed_complete(pend):
            t0 = time.perf_counter()
            for p in pendings_in([pend["fft_pending"], pend["bank_pending"]]):
                if p.event is not None:
                    p.event.synchronize()
            t1 = time.perf_counter()
            complete(pend)
            self.spent["wait"] += t1 - t0
            self.spent["deliver"] += time.perf_counter() - t1

        rt._dispatch_block, rt._complete_block = timed_dispatch, timed_complete

    def run(self, n, spent):
        from collections import deque
        self.spent, pending = spent, deque()
        for _ in range(n):
            if self.churn is not None:
                t0 = time.perf_counter()
                self.churn(self.blocks)
                spent["churn"] += time.perf_counter() - t0
            self.blocks += 1
            self.rt._pump(self.src.read_block(), pending)
        while pending:
            self.rt._complete_block(pending.popleft())
        return n


class ThreadedSide(RuntimeSide):
    """The threaded path's side: the runtime's own loop thread started,
    stopped once ``n`` more blocks went through it (a block or two more
    may finish while it stops)."""

    built_at = None          # when the first start() had built the kernels

    def run(self, n, spent):
        self.spent = spent
        b0 = self.rt.gauges["blocks"]
        deadline = time.perf_counter() + RT_DEADLINE_S
        self.rt.start()
        if self.built_at is None:
            self.built_at = span_time(self.rt, "kernels", "end")
        try:
            while self.rt.gauges["blocks"] < b0 + n:
                check(time.perf_counter() < deadline, "threaded: the loop stalled")
                time.sleep(0.001)
        finally:
            self.rt.stop()
        ran = self.rt.gauges["blocks"] - b0
        self.blocks += ran
        return ran


def each_block(**per_block):
    """``expect`` of a path whose every block launches ``per_block``: a
    side → the launches of the blocks it ran."""
    want = launches_per_block(**per_block)
    return lambda side: {k: v * side.blocks for k, v in want.items()}


def traced_blocks(events, gap_ms=SRV_BLOCK_GAP_MS) -> list:
    """The hand-written kernels of a trace of the server's loop, grouped
    into its blocks (a kernel more than ``gap_ms`` after the one before it
    begins a block), the first and the last dropped (the trace may have
    cut them) → each whole block's launches by source file."""
    from torch_graph_scenes import KERNEL_MARKS
    ours = sorted((float(e["ts"]), src) for e in events
                  for src, mark in KERNEL_MARKS.items() if mark in e.get("name", ""))
    blocks, last = [], None
    for ts, src in ours:
        if last is None or ts - last > gap_ms * 1e3:       # trace times are µs
            blocks.append(dict.fromkeys(KERNEL_MARKS, 0))
        blocks[-1][src] += 1
        last = ts
    return blocks[1:-1]


def check_traced_blocks(label, events):
    """At least two whole blocks in a trace of the server's loop, each
    with the hand-written launches of SRV_LAUNCHES_PER_BLOCK → them."""
    whole = traced_blocks(events)
    check(len(whole) >= 2 and all(b == SRV_LAUNCHES_PER_BLOCK for b in whole),
          f"{label}: the trace's whole blocks ran the hand-written kernels {whole}, "
          f"expected {SRV_LAUNCHES_PER_BLOCK} each")
    return whole


def busy_ms(events) -> float:
    """The union of the kernels' intervals (ms)."""
    busy_us, end = 0.0, -np.inf
    for ts, dur in sorted((float(e["ts"]), float(e.get("dur", 0))) for e in events):
        busy_us += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return busy_us / 1e3


def profile_side(torch, label, side, n, expect) -> dict:
    """``n`` blocks of a side under torch.profiler, every kernel count set
    to 0 just before: the trace must hold each hand-written kernel exactly
    as often as the counts say and ``expect`` predicts, which holds the
    counts a replay adds to the kernels that ran.  → kernel events a block
    (all, and the hand-written ones), the device's busy time (the union of
    the kernels) and its idle share of the profiled wall (which the
    profiler's own host cost stretches)."""
    from torch_graph_scenes import launch_counts, traced, zero_launches
    want0 = expect(side)
    zero_launches()

    def run():
        t0 = time.perf_counter()
        ran = side.run(n, host_split())
        torch.cuda.synchronize()
        return ran, (time.perf_counter() - t0) * 1e3
    (ran, wall_ms), events, ours = traced(run)
    counted = launch_counts()
    want = {k: v - want0[k] for k, v in expect(side).items()}
    check(ours == counted == want, f"{label}: the trace of {ran} blocks holds the "
          f"hand-written kernels {ours}, the counts say {counted}, expected {want}")
    busy = busy_ms(events)
    return {"blocks": ran, "kernel_events_per_block": len(events) / ran,
            "hand_written": ours, "busy_ms_per_block": busy / ran,
            "wall_ms_per_block": wall_ms / ran, "idle_share": 1.0 - busy / wall_ms}


def capture_ms(step) -> float | None:
    """A step's last capture, read from its ``capture`` span."""
    if step.capture_span is None:
        return None
    metric, sid = step.capture_span
    seconds = metric.seconds(sid)
    return None if seconds is None else seconds * 1e3


def span_time(rt, name: str, at: str, rid: int | None = None) -> float | None:
    """``at`` ('start' or 'end') of the last span ``name`` in the runtime's
    log (of request ``rid``, if given), or None."""
    rec = rt.spans[name].records()
    if rid is not None:
        rec = rec[rec["id"] == rid]
    return float(rec[at][-1]) if len(rec) else None


def replay_ms(torch, step, iters=ALT_DEVICE_REPLAYS) -> float:
    """The device time of one replay of a step's graph: ``iters`` replays
    queued back to back between two CUDA events (the host keeps ahead, so
    this is the device's time for the block's work alone)."""
    graph = step._graph
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def output_clone_cost(torch, smi, step, iters=50) -> dict:
    """What a dispatch that hands its outputs out without fetching them
    (``to_host=False``) adds to a replay: a device copy of every output,
    host ms a dispatch and device ms (CUDA events, queued back to back)."""
    from openwebrx_tpu_torch.runtime.chain import tree_leaves
    outs = [t for t in tree_leaves(step._out) if torch.is_tensor(t)]

    def clone_all():
        return [t.clone() for t in outs]
    clone_all()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        clone_all()
    end.record()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    end.synchronize()
    rec = {"outputs": len(outs), "bytes": sum(t.numel() * t.element_size() for t in outs),
           "host_ms": host_ms, "device_ms": start.elapsed_time(end) / iters}
    log(f"[usb] {smi}: a dispatch without a fetch copies the replay's {rec['outputs']} "
        f"outputs ({rec['bytes']} bytes): host {host_ms:.4f} ms, device "
        f"{rec['device_ms']:.4f} ms")
    return rec


def params_copy_cost(torch, smi, bank, iters=20) -> dict:
    """What a control change costs config #6's interactive bank at its
    next dispatch: the params rebuilt from the controls and uploaded
    (``_params``), then copied into the graph's static params
    (``set_params``); host ms of each, device ms of the copy (CUDA
    events).  A squelch set to its own level marks the params changed as
    a retune does; the rebuild is the same whichever control moved."""
    from openwebrx_tpu_torch.runtime.chain import tree_leaves
    slot = int(np.flatnonzero(bank._active)[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    build = copy = device = 0.0
    for _ in range(iters):
        bank.set_squelch(slot, float(bank._squelch[slot]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = bank._params()
        t1 = time.perf_counter()
        start.record()
        bank.step.set_params(params)
        end.record()
        t2 = time.perf_counter()
        end.synchronize()
        build, copy = build + t1 - t0, copy + t2 - t1
        device += start.elapsed_time(end)
    leaves = [t for t in tree_leaves(params) if torch.is_tensor(t)]
    rec = {"leaves": len(leaves), "bytes": sum(t.numel() * t.element_size() for t in leaves),
           "build_host_ms": build / iters * 1e3, "copy_host_ms": copy / iters * 1e3,
           "copy_device_ms": device / iters}
    log(f"[cfg6] {smi}: a control change before a block: params rebuilt and uploaded "
        f"{rec['build_host_ms']:.4f} ms of host, copied into the graph's "
        f"{rec['leaves']} static tensors ({rec['bytes']} bytes) {rec['copy_host_ms']:.4f} "
        f"ms of host, {rec['copy_device_ms']:.4f} ms of device")
    return rec


def alternate(torch, dev, smi, label, sides, expect, warm=ALT_WARM, n=ALT_BLOCKS,
              order=ALT_ORDER, compare=None, profiled=ALT_PROFILE_BLOCKS,
              step_blocks=None) -> dict:
    """Phase 5 on one path: ``sides`` {False: the eager step, True: the
    graph} over the same block sequence.  ``warm`` blocks each (the graph
    side captures there); rounds of ``n`` blocks in ``order``, each with
    every kernel count set to 0 just before and read just after and held
    to ``expect`` (a side → the launches its blocks so far should have
    made); the sides' results bit for bit (``compare``, by default every
    block); ``profiled`` more blocks each under torch.profiler
    (``profile_side``: the trace holds the counts to the kernels that
    ran); the eager side captured nothing and each graph was captured once
    and replayed on every later block (``step_blocks``: the graph side →
    (step, blocks it ran) pairs; by default every step on every block);
    the device time of the replays a block.  → the path's record;
    ``launches`` sums the graph side's rounds, the main path's run."""
    from torch_graph_scenes import launch_counts, zero_launches
    t_path = time.perf_counter()
    for side in sides.values():
        side.run(warm, host_split())
    rec = {("graph" if g else "eager"): {"ms_per_block": [], "rounds": [], "blocks": 0,
                                         "host_ms": host_split(), "launches": {},
                                         "peak_mib": []}
           for g in sides}
    replays0 = {id(st): st.replays for st in steps_of(*sides[True].objs)}
    for graph in order:
        side, r = sides[graph], rec["graph" if graph else "eager"]
        want0 = expect(side)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        spent = host_split()
        t0 = time.perf_counter()
        ran = side.run(n, spent)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        want = {k: v - want0[k] for k, v in expect(side).items()}
        check(got == want, f"{label} ({'graph' if graph else 'eager'}): launches {got} "
              f"in a round of {ran} blocks, expected {want}")
        r["ms_per_block"].append(wall / ran * 1e3)
        r["rounds"].append({k: v / ran * 1e3 for k, v in spent.items()})
        r["blocks"] += ran
        for k, v in spent.items():
            r["host_ms"][k] += v * 1e3
        for k, v in got.items():
            r["launches"][k] = r["launches"].get(k, 0) + v
        r["peak_mib"].append(torch.cuda.max_memory_allocated(dev) / 2 ** 20)
    for r in rec.values():
        r["host_ms"] = {k: v / r["blocks"] for k, v in r["host_ms"].items()}
        r["launches_per_block"] = {k: v / r["blocks"] for k, v in r["launches"].items()}
    replays = {id(st): st.replays - replays0[id(st)] for st in steps_of(*sides[True].objs)
               if id(st) in replays0}
    same = (compare or (lambda a, b: [same_tree(x, y) for x, y in zip(a, b)]))(
        sides[False].results, sides[True].results)
    check(len(same) > 0 and all(same), f"{label}: the graph's results differ from the "
          f"eager step's at {[i for i, s in enumerate(same) if not s]} of {len(same)}")
    for graph, side in sides.items():
        rec["graph" if graph else "eager"]["profile"] = profile_side(
            torch, label, side, profiled, expect)
    eager_captures = [st.captures for st in steps_of(*sides[False].objs)]
    check(not any(eager_captures), f"{label}: the eager side captured {eager_captures}")
    pairs = (step_blocks or (lambda s: [(st, s.blocks) for st in steps_of(*s.objs)]))(
        sides[True])
    got = [(st.captures, st.replays) for st, _ in pairs]
    log(f"[{label}] graph captures and replays by step: {got} (blocks "
        f"{[b for _, b in pairs]})")
    check(all((st.captures, st.replays) == (1, b - 1) for st, b in pairs),
          f"{label}: captures and replays {got}, expected one capture and a replay on "
          f"every block after the first of {[b for _, b in pairs]}")
    # the device's own time a block: each graph's replays back to back,
    # weighted by its replays a block in the rounds (this replays the
    # graphs on their last state: the paths end here)
    steps = [st for st in steps_of(*sides[True].objs)
             if st._graph is not None and replays.get(id(st))]
    blocks = rec["graph"]["blocks"]
    device_ms = sum(replay_ms(torch, st) * replays[id(st)] / blocks for st in steps)
    rec["graph"]["captures"] = [{"captures": st.captures, "capture_ms": capture_ms(st),
                                 "pool_mib": st.pool_mib} for st in steps]
    rec["device_ms_per_block"] = device_ms
    for r in (rec["eager"], rec["graph"]):
        r["idle_share"] = 1.0 - device_ms / float(np.mean(r["ms_per_block"]))
    rec["identical"] = f"{sum(same)}/{len(same)}"
    rec["launches"] = rec["graph"]["launches"]
    e, g = rec["eager"], rec["graph"]
    fmt = lambda v: "[" + ", ".join(f"{x:.3f}" for x in v) + "]"
    log(f"[{label}] {smi}: ms/block eager {fmt(e['ms_per_block'])} graph "
        f"{fmt(g['ms_per_block'])} (rounds {''.join('G' if x else 'E' for x in order)} "
        f"of {n}); host ms a block eager " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                         e["host_ms"].items())
        + "; graph " + ", ".join(f"{k} {v:.3f}" for k, v in g["host_ms"].items())
        + f"; dispatch by round eager {fmt([x['dispatch'] for x in e['rounds']])} graph "
        f"{fmt([x['dispatch'] for x in g['rounds']])}")
    log(f"[{label}] launches a block {g['launches_per_block']} (both sides, every round "
        f"as predicted); the trace of {e['profile']['blocks']} blocks a side holds the "
        f"hand-written kernels as the counts say: eager {e['profile']['hand_written']} "
        f"graph {g['profile']['hand_written']}; profiler kernel events a block eager "
        f"{e['profile']['kernel_events_per_block']:.1f} graph "
        f"{g['profile']['kernel_events_per_block']:.1f}; idle share (profiler) eager "
        f"{e['profile']['idle_share']:.4f} graph {g['profile']['idle_share']:.4f}")
    log(f"[{label}] device ms a block (replays back to back) {device_ms:.4f}; idle "
        f"share eager {e['idle_share']:.4f} graph {g['idle_share']:.4f}; captures "
        + "; ".join(f"{c['captures']} in {c['capture_ms']:.1f} ms, pool {c['pool_mib']:.1f} MiB"
                    for c in g["captures"])
        + f"; peak MiB eager {max(e['peak_mib']):.1f} graph {max(g['peak_mib']):.1f}; "
        f"identical blocks {rec['identical']}; {time.perf_counter() - t_path:.1f} s")
    return rec


def path_report(label, smi, rec, block, fs) -> dict:
    """A path's rate from its graph side's rounds (every result fetched)."""
    g = rec["graph"]
    ms = float(np.mean(g["ms_per_block"]))
    msps = block / ms / 1e3
    log(f"[{label}] {smi}: {g['blocks']} blocks of {block} samples in the graph's "
        f"rounds (results fetched to host every block): {ms:.3f} ms/block, {msps:.3f} "
        f"MS/s = {msps / (fs / 1e6):.3f}x real time; peak device memory "
        f"{max(g['peak_mib']):.1f} MiB")
    return {"ms_per_block": ms, "msps": msps, "realtime_x": msps / (fs / 1e6),
            "peak_mib": max(g["peak_mib"]), "host_ms": g["host_ms"]}


def cfg4_fanout():
    """Config #4's Fanout: BPSK31 ×16 and USB audio ×16 → (psk, audio,
    fanout)."""
    from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain
    from openwebrx_tpu_torch.models.secondary import PskChain
    from openwebrx_tpu_torch.runtime.chain import Fanout
    psk = PskChain(CFG2_FS, baud=31.25)
    psk.selector.shift.set_rate(
        -(np.arange(CFG4_CHANNELS, dtype=np.float32) * 5e3 + 50e3) / CFG2_FS)
    aud = ClientDemodulatorChain(CFG2_FS, 12000.0, "usb", "none")
    aud.selector.shift.set_rate(
        -(np.arange(CFG4_CHANNELS, dtype=np.float32) * 5e3 + 60e3) / CFG2_FS)
    return psk, aud, Fanout([("psk", psk), ("audio", aud)], batch_shapes={
        "psk": (CFG4_CHANNELS,), "audio": (CFG4_CHANNELS,)})


def full_width_paths(torch, dev, smi, paths, launches_by_path, alt):
    """Phase 5: every path at full width, its eager step against its graph
    (``alternate``), on blocks of a generator of its own; the graph side's
    results held to the path's own checks (tone SNR, shapes).  Adds each
    path's report to ``paths``, the graph side's launches to
    ``launches_by_path`` and the alternation to ``alt``."""
    from openwebrx_tpu_torch.models.receiver import (MODE_BANDPASS, ClientDemodulatorChain,
                                                     FftChain)
    from openwebrx_tpu_torch.models.stages import block_requirement, plan_block_size
    from openwebrx_tpu_torch.ops import adpcm
    from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
    from openwebrx_tpu_torch.runtime import device as rtdev
    from openwebrx_tpu_torch.runtime.bank import ChannelBank
    from openwebrx_tpu_torch.runtime.chain import Program
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    total = ALT_WARM + len(ALT_ORDER) // 2 * ALT_BLOCKS + ALT_PROFILE_BLOCKS
    spec5 = StreamSpec(Format.COMPLEX_FLOAT, FS)
    spec24 = StreamSpec(Format.COMPLEX_FLOAT, CFG2_FS)

    def run(label, sides, expect, block, fs, **kw):
        rec = alternate(torch, dev, smi, label, sides, expect, **kw)
        alt[label] = rec
        launches_by_path[label] = rec["launches"]
        paths[label] = path_report(label, smi, rec, block, fs)
        return sides[True].results

    def full_bank(mode, m, rate, graph):
        bank = ChannelizedBank(FS, m, mode=mode, audio_rate=rate, compression="adpcm",
                               target_seconds=0.05, device=dev, graph=graph)
        for i in range(m):
            bank.assign(float((i - m // 2) * FS / m))
        return bank

    # config #5's banks, every channel assigned
    for label, mode, m, rate, per_block in (
            ("usb", "usb", 1024, 12000.0, dict(fold=1, adpcm_=1, agc_=1, squelch_=1)),
            ("nfm", "nfm", 1024, 12000.0, dict(fold=1, adpcm_=1, iir_=1, agc_=1, squelch_=1)),
            ("am", "am", 2048, 12000.0, dict(fold=1, adpcm_=1, iir_=1, agc_=1, squelch_=1)),
            ("wfm", "wfm", 128, 48000.0, dict(fold=1, adpcm_=1, iir_=1, squelch_=1))):
        banks = {g: full_bank(mode, m, rate, g) for g in (False, True)}
        bank = banks[True]
        carriers = [float((i * m // M - m // 2) * FS / m) for i in TONE_CHANNELS]
        tone_slots = [bank.channel_for(f)[0] for f in carriers]   # dense: slot k
        blocks = seeded_blocks(torch, gen, dev, FS, bank.block, total, carriers, mode)
        results = run(label, {g: PipeSide(blocks, b.dispatch, b.fetch, [b])
                              for g, b in banks.items()},
                      each_block(**per_block), bank.block, FS)
        if label == "usb":
            alt[label]["output_clone"] = output_clone_cost(torch, smi, bank.step)
        out_bytes = bank.channel_block * int(rate) // int(bank.channel_rate) // 2
        sq_stage = bank.chain.selector.squelch
        windows = sq_stage.block // sq_stage.window
        for y, aux in results:
            data, strides = y
            pdb = aux["selector.squelch.power_db"]
            check(data.shape == (m, out_bytes) and data.dtype == np.uint8,
                  f"{label}: bytes {data.shape} {data.dtype}")
            check(strides.shape == (m, out_bytes // adpcm.STATE_STRIDE)
                  and strides.dtype == np.int32, f"{label}: stride {strides.shape}")
            check(pdb.shape == (m, windows) and pdb.dtype == np.float32
                  and np.isfinite(pdb).all(), f"{label}: power_db {pdb.shape}")
            if mode == "wfm":
                rds = aux["wfm.rds_tap.rds"]
                check(rds.shape == (m, bank.channel_block * 250 // 384 // 16)
                      and rds.dtype == np.complex64 and np.isfinite(rds).all(),
                      f"wfm: rds aux {rds.shape} {rds.dtype}")
        for k in tone_slots:
            audio_k = decode_channel([(y[0][k], y[1][k]) for y, _ in results], adpcm)
            settled = audio_k[len(audio_k) // 2:].astype(np.float32) / 32767
            snr = tone_snr(settled, TONE_AUDIO_HZ, rate)
            log(f"[{label}] slot {k}: {mode} tone SNR {snr:.1f} dB "
                f"(minimum {TONE_SNR_MIN_DB})")
            check(snr > TONE_SNR_MIN_DB, f"{label}: channel {k} tone SNR {snr:.1f} dB")
        quiet = decode_channel([(y[0][5], y[1][5]) for y, _ in results], adpcm)
        check(np.isfinite(quiet).all(), f"{label}: quiet channel audio")
        del banks, bank, blocks, results
        torch.cuda.empty_cache()

    # BASELINE config #1: 2.4 MS/s → NFM → 12 kHz ADPCM through Program
    def cfg1(graph):
        chain = ClientDemodulatorChain(CFG1_FS, mode="nfm", compression="adpcm")
        chain.set_frequency_offset(CFG1_OFFSET)
        spec = StreamSpec(Format.COMPLEX_FLOAT, CFG1_FS)
        return Program(chain, spec, plan_block_size(chain, spec, 0.1), device=dev, graph=graph)
    progs = {g: cfg1(g) for g in (False, True)}
    prog = progs[True]
    blocks = seeded_blocks(torch, gen, dev, CFG1_FS, prog.block, total,
                           [CFG1_OFFSET], "nfm", noise=0.05)
    results = run("cfg1", {g: PipeSide(blocks, p.dispatch, p.fetch, [p])
                           for g, p in progs.items()},
                  each_block(adpcm_=1, iir_=1, agc_=1, squelch_=1), prog.block, CFG1_FS)
    for y, aux in results:
        data, strides = y
        check(data.shape == (prog.out_block,) and data.dtype == np.uint8,
              f"cfg1: bytes {data.shape} {data.dtype}")
        check(strides.shape == (prog.out_block // adpcm.STATE_STRIDE,)
              and strides.dtype == np.int32, f"cfg1: stride {strides.shape}")
        pdb = aux["selector.squelch.power_db"]
        check(pdb.dtype == np.float32 and np.isfinite(pdb).all(), "cfg1: power_db")
    audio1 = decode_channel([y for y, _ in results], adpcm)
    snr = tone_snr(audio1[len(audio1) // 2:].astype(np.float32) / 32767,
                   TONE_AUDIO_HZ, 12000.0)
    log(f"[cfg1] NFM tone at {CFG1_OFFSET:.0f} Hz: SNR {snr:.1f} dB "
        f"(minimum {TONE_SNR_MIN_DB})")
    check(snr > TONE_SNR_MIN_DB, f"cfg1: tone SNR {snr:.1f} dB")
    del progs, prog, blocks, results

    # BASELINE config #2: a 4096-bin compressed waterfall, one USB listener
    # on a 64-channel PFB bank and one edge dial on a full-rate ChannelBank,
    # all fed from one device-resident block per step
    def cfg2(graph):
        lbank = ChannelizedBank(CFG2_FS, 64, mode="usb", compression="adpcm",
                                target_seconds=0.04, device=dev, graph=graph)
        ebank = ChannelBank(CFG2_FS, "usb", capacity=16, block=lbank.block, device=dev,
                            graph=graph)
        check(lbank.block == 120000 and ebank.chunk_ratio == 1
              and not lbank.fits(CFG2_EDGE, *MODE_BANDPASS["usb"]),
              f"config #2 plan: block {lbank.block}, chunk ratio {ebank.chunk_ratio}")
        slots = (lbank.assign(CFG2_LISTENER), ebank.add_channel(CFG2_EDGE))
        wf = Program(FftChain(WF_SIZE, 20.0, compress=True), spec24, lbank.block,
                     device=dev, graph=graph)

        def dispatch(x):
            return wf.dispatch(x), lbank.dispatch(x), ebank.feed_dispatch(x)

        def fetch(w, lb, eb):
            return wf.fetch(*w), lbank.fetch(*lb), ebank.program.fetch(*eb)
        return PipeSide(blocks, dispatch, fetch, [wf, lbank, ebank]), wf, slots
    blocks = seeded_blocks(torch, gen, dev, CFG2_FS, 120000, total,
                           [CFG2_LISTENER, CFG2_EDGE], "usb", noise=0.05)
    parts = {g: cfg2(g) for g in (False, True)}
    _, wf2_prog, (lslot, eslot) = parts[True]
    wf2 = wf2_prog.chain
    nb = wf2.waterfall.wire_bytes_per_row
    check((wf2.waterfall.rows, wf2.waterfall.averages, nb) == (1, 29, 2053),
          f"config #2 waterfall plan {wf2.waterfall.rows} {wf2.waterfall.averages} {nb}")
    results = run("cfg2", {g: p[0] for g, p in parts.items()},
                  each_block(fold=1, adpcm_=2, agc_=2, squelch_=2, seq=1), 120000, CFG2_FS)
    bins = {f: WF_SIZE // 2 + int(round((f + TONE_AUDIO_HZ) / CFG2_FS * WF_SIZE))
            for f in (CFG2_LISTENER, CFG2_EDGE)}
    for (raw, _), (ly, la), (ey, ea) in results:
        check(raw.shape == (1, SEQ_ROW // 2) and raw.dtype == np.uint8,
              f"cfg2: waterfall rows {raw.shape} {raw.dtype}")
        check(ly[0].shape == (64, 300) and ey[0].shape == (16, 300)
              and la["selector.squelch.power_db"].shape == (64, 1)
              and ea["selector.squelch.power_db"].shape == (16, 1),
              "cfg2: listener outputs")
    row = decoded_row(results[-1][0][0][0], nb, adpcm)
    for f, k in bins.items():
        peak_bin = k - 4 + int(np.argmax(row[k - 4:k + 5]))
        rise = row[peak_bin] - np.median(row)
        log(f"[cfg2] waterfall: tone at {f + TONE_AUDIO_HZ:.0f} Hz peaks in bin "
            f"{peak_bin} (expected {k} ± 1), {rise:.1f} dB above the median")
        check(abs(peak_bin - k) <= 1 and rise > 20.0, f"cfg2: waterfall tone at {f}")
    for label, bank_out, slot in (("listener", 1, lslot), ("edge", 2, eslot)):
        audio = decode_channel([(r[bank_out][0][0][slot], r[bank_out][0][1][slot])
                                for r in results], adpcm)
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float32) / 32767,
                       TONE_AUDIO_HZ, 12000.0)
        log(f"[cfg2] {label} slot {slot}: USB tone SNR {snr:.1f} dB (minimum "
            f"{TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"cfg2: {label} tone SNR {snr:.1f} dB")
    del parts, wf2_prog, blocks, results

    # BASELINE config #4: BPSK31 ×16 and USB audio ×16 in one Fanout,
    # delivered in 6-block batches; the first batch is checked against the
    # same Fanout on the CPU
    psk4, aud4, _ = cfg4_fanout()
    ra, rb = block_requirement(psk4, spec24), block_requirement(aud4, spec24)
    req = ra * rb // int(np.gcd(ra, rb))
    block4 = (int(round(CFG2_FS * 0.1)) + req - 1) // req * req
    check(block4 == 307200, f"config #4 block {block4}")
    n4 = CFG4_BATCH + len(ALT_ORDER) // 2 * CFG4_BATCH + CFG4_BATCH
    blocks = seeded_blocks(torch, gen, dev, CFG2_FS, block4, n4, [60e3], "usb")
    progs = {g: Program(cfg4_fanout()[2], spec24, block4, device=dev, graph=g)
             for g in (False, True)}
    results4 = run("cfg4", {g: BatchSide(blocks, p) for g, p in progs.items()},
                   each_block(agc_=1, squelch_=1), block4, CFG2_FS,
                   warm=CFG4_BATCH, n=CFG4_BATCH, profiled=CFG4_BATCH)
    symbols = 0
    for y, aux in results4:
        check(y["psk"].shape == (CFG4_CHANNELS, int(block4 * 31.25 / CFG2_FS))
              and y["psk"].dtype == np.complex64
              and y["audio"].shape == (CFG4_CHANNELS, 1536)
              and y["audio"].dtype == np.int16
              and aux["psk.secondary_fft.rows"].shape == (CFG4_CHANNELS, 1, 2048)
              and aux["audio.selector.squelch.power_db"].shape == (CFG4_CHANNELS, 2),
              f"cfg4: output shapes {y['psk'].shape} {y['audio'].shape}")
        symbols += y["psk"].shape[-1]
    check(len(results4) == n4 and symbols == n4 * 4,
          f"cfg4: {len(results4)} results, {symbols} symbols a channel")
    prog4_cpu = Program(cfg4_fanout()[2], spec24, block4, device="cpu")
    psk_err, aud_err, pdb_err = 0.0, 0, 0.0
    for x, (y, aux) in zip(blocks[:CFG4_BATCH], results4):
        yc, ac = prog4_cpu.process(x.cpu())
        psk_err = max(psk_err, float(np.abs(y["psk"] - yc["psk"]).max()
                                     / np.abs(yc["psk"]).max()))
        aud_err = max(aud_err, int(np.abs(y["audio"].astype(np.int32)
                                          - yc["audio"].astype(np.int32)).max()))
        key = "audio.selector.squelch.power_db"
        pdb_err = max(pdb_err, float(np.abs(aux[key] - ac[key]).max()))
    log(f"[cfg4] first batch card vs CPU: psk symbols max diff {psk_err:.2e} of "
        f"max|y| (tolerance {CHAIN_RTOL}), audio {aud_err} LSB (tolerance "
        f"{SMALL_BANK_LSB}), squelch power {pdb_err:.2e} dB; {symbols} symbols "
        f"a channel over {n4} blocks")
    check(psk_err <= CHAIN_RTOL and aud_err <= SMALL_BANK_LSB
          and pdb_err <= SQUELCH_DB_TOL, "cfg4: card and CPU disagree")
    audio4 = np.concatenate([y["audio"][0] for y, _ in results4])
    snr = tone_snr(audio4[len(audio4) // 2:].astype(np.float32) / 32767,
                   TONE_AUDIO_HZ, 12000.0)
    log(f"[cfg4] audio channel 0: USB tone SNR {snr:.1f} dB (minimum {TONE_SNR_MIN_DB})")
    check(snr > TONE_SNR_MIN_DB, f"cfg4: tone SNR {snr:.1f} dB")
    del progs, prog4_cpu, blocks, results4

    # the waterfall a config #5 device runs for its subscribers:
    # FftChain(4096, 9) on the 49.152 MS/s block, 600 averaged frames a
    # 0.05 s row; alone, then beside the 1024-channel USB bank
    def wf5(graph):
        return Program(FftChain(WF_SIZE, 9.0, compress=True), spec5, 2400 * M, device=dev,
                       graph=graph)
    progs = {g: wf5(g) for g in (False, True)}
    wf5c = progs[True].chain
    check((wf5c.waterfall.rows, wf5c.waterfall.averages) == (1, 600),
          f"waterfall plan at 49.152 MS/s: {wf5c.waterfall.rows} rows of "
          f"{wf5c.waterfall.averages}")
    carriers = [float((i - M // 2) * FS / M) for i in TONE_CHANNELS]
    blocks = seeded_blocks(torch, gen, dev, FS, 2400 * M, total, carriers, "usb")
    results = run("wf", {g: PipeSide(blocks, p.dispatch, p.fetch, [p])
                         for g, p in progs.items()}, each_block(seq=1), 2400 * M, FS)
    # 600 averages leave a floor smooth to ±0.2 dB, so the codec's step is
    # small when a tone's 37 dB peak arrives and the decoded peak comes out
    # ~25 dB low and a bin late (the reference encoder does the same; the
    # bytes are bit-identical to it): the tone must be there, ±1 bin
    row = decoded_row(results[-1][0][0], wf5c.waterfall.wire_bytes_per_row, adpcm)
    for f in carriers:
        k = WF_SIZE // 2 + int(round((f + TONE_AUDIO_HZ) / FS * WF_SIZE))
        peak_bin = k - 4 + int(np.argmax(row[k - 4:k + 5]))
        rise = row[peak_bin] - np.median(row)
        log(f"[wf] waterfall: tone at {f + TONE_AUDIO_HZ:.0f} Hz peaks in bin "
            f"{peak_bin} (expected {k} ± 1), {rise:.1f} dB above the median "
            f"after decoding")
        check(abs(peak_bin - k) <= 1 and rise > 3.0,
              f"wf: tone at {f} peaks in bin {peak_bin}, expected {k}")
    both = {}
    for g in (False, True):
        w, b = wf5(g), full_bank("usb", M, 12000.0, g)
        both[g] = PipeSide(blocks, lambda x, w=w, b=b: (w.dispatch(x), b.dispatch(x)),
                           lambda wp, bp, w=w, b=b: (w.fetch(*wp), b.fetch(*bp)), [w, b])
    ubank = both[True].objs[1]
    results = run("usb+wf", both, each_block(fold=1, adpcm_=1, agc_=1, squelch_=1, seq=1),
                  2400 * M, FS)
    for k in [ubank.channel_for(f)[0] for f in carriers]:
        audio = decode_channel([(r[1][0][0][k], r[1][0][1][k]) for r in results], adpcm)
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float32) / 32767,
                       TONE_AUDIO_HZ, 12000.0)
        check(snr > TONE_SNR_MIN_DB, f"usb+wf: channel {k} tone SNR {snr:.1f} dB")
    log(f"[usb+wf] tones decoded in slots {[ubank.channel_for(f)[0] for f in carriers]}")
    del progs, both, ubank, blocks, results
    torch.cuda.empty_cache()

    # configs #3 and #6 and the threaded loop through the port's
    # DeviceRuntime on uint8 wire blocks at 8.192 MS/s (0.2 s blocks); the
    # runtime's logger is watched for ERROR records
    errors = ErrorRecords()
    logging.getLogger(rtdev.__name__).addHandler(errors.handler)

    def frames_same(a, b):
        return [b"".join(a[i]) == b"".join(b[i]) for i in sorted(a)]

    def service_snr(chunks):
        pcm = np.frombuffer(b"".join(chunks), np.int16)
        return tone_snr(pcm[len(pcm) // 2:].astype(np.float32) / 32767,
                        TONE_AUDIO_HZ, 12000.0)

    # config #3 (bench.py:347-402): 64 background USB dials on distinct
    # PFB channels, raw audio delivered in 6-block batches, depth 2
    sides, made = {}, {}
    for g in (False, True):
        made[g] = cfg3_runtime(dev, graph=g)
        rt, src, _, _, audio = made[g]
        sides[g] = RuntimeSide(rt, src, audio)
    rt3, _, dials3, tone3, audio3 = made[True]
    bank3 = rt3.banks["pfb:ssb"]
    check({h.bucket_key for h in rt3.handles} == {"pfb:ssb"} and bank3.n_active == 64
          and bank3.delivery_stride == 6 and bank3.chunk_ratio == 1,
          f"config #3: dials in {sorted({h.bucket_key for h in rt3.handles})}, "
          f"stride {bank3.delivery_stride}")
    run("cfg3", sides, each_block(fold=1, agc_=1, squelch_=1), rt3.block, RT_FS,
        compare=frames_same, step_blocks=lambda s: [(bank3.step, s.blocks)])
    errors.check("cfg3")
    check(all(audio3.values()), "cfg3: audio missing on some dials")
    for i in tone3:
        snr = service_snr(audio3[i])
        log(f"[cfg3] dial {i} ({dials3[i]:.0f} Hz): USB tone SNR {snr:.1f} dB "
            f"(minimum {TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"cfg3: dial {i} tone SNR {snr:.1f} dB")
    quiet = service_snr(audio3[10])
    log(f"[cfg3] all {CFG3_DIALS} dials in pfb:ssb, audio on all; a quiet dial's "
        f"1 kHz SNR {quiet:.1f} dB")
    check(quiet < TONE_SNR_MIN_DB, f"cfg3: a tone leaks into dial 10 ({quiet:.1f} dB)")
    del sides, made, rt3, bank3

    # config #6 (bench.py:498-583): 256 interactive listeners (ADPCM), four
    # retunes a block, every 8th block one listener dragged across a
    # channel edge (served full rate for a block) and back; depth 3.  Its
    # warm-up runs two drags, so both banks have captured before round 1
    cfg6_blocks = CFG6_WARM + len(CFG6_ORDER) // 2 * ALT_BLOCKS + ALT_PROFILE_BLOCKS
    check(not any((i * 4 + j) % CFG6_LISTENERS in CFG6_TONES
                  or (i % 8 == 4 and (i * 13) % CFG6_LISTENERS in CFG6_TONES)
                  for i in range(cfg6_blocks) for j in range(4)),
          "cfg6: the churn would move a tone listener")
    sides = {}
    for g in (False, True):
        rt, src, handles, frames = cfg6_runtime(dev, "cfg6", seed=6, graph=g)
        sides[g] = RuntimeSide(rt, src, frames, churn=Cfg6Churn(rt, handles))
    rt6, frames6 = sides[True].rt, sides[True].results

    def cfg6_expect(side):
        full = side.churn.counts["full_rate_blocks"]
        return launches_per_block(fold=side.blocks, adpcm_=side.blocks + full,
                                  agc_=side.blocks + full, squelch_=side.blocks + full)

    def cfg6_steps(side):
        return [(side.rt.banks["pfbi:ssb"].step, side.blocks),
                (side.rt.banks["ssb"].program.step, side.churn.counts["full_rate_blocks"])]
    run("cfg6", sides, cfg6_expect, rt6.block, RT_FS, warm=CFG6_WARM, order=CFG6_ORDER,
        compare=frames_same, step_blocks=cfg6_steps)
    errors.check("cfg6")
    churn = sides[True].churn.counts
    full = churn["full_rate_blocks"]
    check(full == sum(1 for i in range(cfg6_blocks) if i % 8 == 4),
          f"cfg6: {full} blocks with a full-rate dial in {cfg6_blocks}")
    heard = sum(1 for f in frames6.values() if f)
    check(heard >= 250, f"cfg6: audio on {heard} of {CFG6_LISTENERS} listeners")
    for i in CFG6_TONES:
        pcm = decode_wire(frames6[i], adpcm)
        snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float32) / 32767, TONE_AUDIO_HZ,
                       12000.0)
        log(f"[cfg6] listener {i}: ADPCM wire decoded, {len(pcm)} samples, USB tone "
            f"SNR {snr:.1f} dB (minimum {TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"cfg6: listener {i} tone SNR {snr:.1f} dB")
    log(f"[cfg6] {heard} of {CFG6_LISTENERS} listeners heard; {churn['retunes']} "
        f"retunes, {churn['migrations']} edge drags (pfbi:ssb -> ssb -> pfbi:ssb), "
        f"{full} blocks with the full-rate bank")
    alt["cfg6"]["params_copy"] = params_copy_cost(torch, smi, rt6.banks["pfbi:ssb"])
    paths["cfg6"].update(retunes=churn["retunes"], edge_drags=churn["migrations"])
    del sides, rt6, frames6

    # the threaded run: config #6's listeners and a waterfall subscriber
    # through start() and the loop thread
    sides, rows = {}, {}
    for g in (False, True):
        rt, src, _, frames = cfg6_runtime(dev, "threaded", seed=7, graph=g)
        rows[g] = []
        rt.subscribe_waterfall(rows[g].append)
        sides[g] = ThreadedSide(rt, src, frames)
    rtt, framest, rows_t = sides[True].rt, sides[True].results, rows[True]
    nb_row = rtt.fft_chain.waterfall.wire_bytes_per_row

    def prefix_same(a, b):
        """The threaded loop may run a block more in a round on one side:
        each listener's frames agree as far as both went."""
        out = []
        for i in sorted(a):
            x, y = b"".join(a[i]), b"".join(b[i])
            k = min(len(x), len(y))
            out.append(k > 0 and x[:k] == y[:k])
        return out
    run("threaded", sides, each_block(fold=1, adpcm_=1, agc_=1, squelch_=1, seq=1),
        rtt.block, RT_FS, compare=prefix_same,
        step_blocks=lambda s: [(s.rt.banks["pfbi:ssb"].step, s.blocks),
                               (s.rt.fft_program.step, s.blocks)])
    errors.check("threaded")
    blocks_t = sides[True].blocks
    built_at = sides[True].built_at
    first_block_at = span_time(rtt, "dispatch", "start", rid=0)
    built_first = (built_at is not None and first_block_at is not None
                   and built_at <= first_block_at)
    log(f"[threaded] {blocks_t} blocks through the loop thread; kernels.ALL built by "
        f"start() before the first block: {built_first}; gauges {rtt.gauges}")
    check(built_first, "threaded: kernels.ALL was not built before the first block")
    check(len(rows_t) >= RT_THREADED_ROWS
          and all(len(framest[i]) >= RT_THREADED_FRAMES for i in CFG6_TONES),
          f"threaded: {blocks_t} blocks, {len(rows_t)} rows, audio frames "
          f"{[len(framest[i]) for i in CFG6_TONES]}")
    check(all(len(r) == nb_row for r in rows_t) and len(rows_t) == 2 * blocks_t,
          f"threaded: waterfall rows of {sorted({len(r) for r in rows_t})} bytes "
          f"({len(rows_t)} for {blocks_t} blocks), expected {nb_row}")
    row = decoded_row(rows_t[-1], nb_row, adpcm)
    for f in sides[True].src.dials:
        f_t = f + TONE_AUDIO_HZ
        k = WF_SIZE // 2 + int(round(f_t / RT_FS * WF_SIZE))
        peak_bin = k - 4 + int(np.argmax(row[k - 4:k + 5]))
        rise = row[peak_bin] - np.median(row)
        log(f"[threaded] waterfall: tone at {f_t:.0f} Hz peaks in bin {peak_bin} "
            f"(expected {k} ± 1), {rise:.1f} dB above the median after decoding")
        check(abs(peak_bin - k) <= 1 and rise > 3.0,
              f"threaded: waterfall tone at {f_t} peaks in bin {peak_bin}, expected {k}")
    for i in CFG6_TONES:
        pcm = decode_wire(framest[i], adpcm)
        snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float32) / 32767, TONE_AUDIO_HZ,
                       12000.0)
        check(snr > TONE_SNR_MIN_DB, f"threaded: listener {i} tone SNR {snr:.1f} dB")
    paths["threaded"].update(gauges=dict(rtt.gauges),
                             kernels_built_before_first_block=built_first)
    logging.getLogger(rtdev.__name__).removeHandler(errors.handler)
    del sides, rows, rtt, framest, rows_t
    torch.cuda.empty_cache()
    log(f"[paths] phase 5 took {time.perf_counter() - t_phase:.1f} s")


class WsClient:
    """The browser's side of the receiver's WebSocket (RFC 6455: masked
    frames out, pings answered), for phase 7."""

    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer

    @classmethod
    async def connect(cls, port):
        import asyncio
        import base64
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((f"GET /ws/ HTTP/1.1\r\nHost: localhost\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        check(b" 101 " in head.split(b"\r\n")[0], f"websocket upgrade refused: {head[:80]!r}")
        return cls(reader, writer)

    async def _send(self, opcode, payload: bytes):
        import struct
        mask, n = os.urandom(4), len(payload)
        head = bytes([0x80 | opcode, 0x80 | min(n, 126)])
        if n >= 126:
            head += struct.pack(">H", n)
        body = (np.frombuffer(payload, np.uint8)
                ^ np.resize(np.frombuffer(mask, np.uint8), n)).tobytes()
        self.writer.write(head + mask + body)
        await self.writer.drain()

    async def send_json(self, msg):
        await self._send(0x1, json.dumps(msg).encode())

    async def receive(self):
        """The next data frame → (opcode, payload); pings are answered."""
        import struct
        while True:
            head = await self.reader.readexactly(2)
            opcode, n = head[0] & 0x0F, head[1] & 0x7F
            if n == 126:
                n, = struct.unpack(">H", await self.reader.readexactly(2))
            elif n == 127:
                n, = struct.unpack(">Q", await self.reader.readexactly(8))
            payload = await self.reader.readexactly(n) if n else b""
            if opcode == 0x9:
                await self._send(0xA, payload)
                continue
            return opcode, payload

    async def expect_json(self, msg_type):
        """The next text message of ``msg_type`` (others are skipped)."""
        import asyncio

        async def wait():
            while True:
                opcode, payload = await self.receive()
                if opcode == 0x1:
                    msg = json.loads(payload)
                    if msg.get("type") == msg_type:
                        return msg
        return await asyncio.wait_for(wait(), SRV_DEADLINE_S)

    async def handshake(self):
        opcode, payload = await self.receive()
        check(opcode == 0x1 and payload.startswith(b"CLIENT DE SERVER"),
              f"no server greeting: {payload[:60]!r}")
        await self._send(0x1, b"SERVER DE CLIENT client=chip_smoke type=receiver")

    def close(self):
        self.writer.close()


async def http_request(port, method, path, body=None, cookie=None):
    """One HTTP/1.1 request to the local server → (status, body, cookie)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    head = [f"{method} {path} HTTP/1.1", "Host: localhost",
            f"Content-Length: {len(payload)}", "Connection: close"]
    if cookie:
        head.append(f"Cookie: {cookie}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    top, _, out = raw.partition(b"\r\n\r\n")
    set_cookie = None
    for line in top.split(b"\r\n"):
        if line.lower().startswith(b"set-cookie:"):
            set_cookie = line.split(b":", 1)[1].split(b";")[0].strip().decode()
    return int(top.split(b" ")[1]), out, set_cookie


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def audio_snr(data: bytes, f_tone, adpcm, seconds=1.0):
    """Tone SNR of a listener's last ``seconds`` of audio → (dB, samples),
    decoded from the first SYNC header of the stream's tail on (the decoder
    is a Python loop)."""
    tail = bytes(data[-int(seconds * SRV_AUDIO_BYTES_PER_S) - 2 * (adpcm.SYNC_INTERVAL + 8):])
    pcm = decode_wire([tail[tail.find(b"SYNC"):]], adpcm)[-int(12000 * seconds):]
    return tone_snr(pcm.astype(np.float32) / 32767, f_tone, 12000.0), len(pcm)


def wf_bin(offset_hz, fs):
    return WF_SIZE // 2 + int(round(offset_hz / fs * WF_SIZE))


def cli_server(root, adpcm, full, tag):
    """One fresh ``python -m openwebrx_tpu_torch --signal-demo`` process of
    the checkout at ``root`` as a user starts it (the settings file only
    turns the web agents' downloads off): one listener on each of
    CLI_LISTENERS, each on a connection of its own, each tone at ≥ 15 dB;
    with ``full`` the first listener also runs tests/test_server.py's
    checks (handshake messages, smeter, the demo's carriers in their
    waterfall bins).  SIGTERM stops it cleanly → ready_s, the seconds its
    log gives for the kernels' build and the warm-up (None where it logs
    none) and, a listener, first audio after dspcontrol and after connect."""
    import asyncio
    import signal
    from openwebrx_tpu_torch.web.server import SIGNAL_DEMO_CONFIG
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    settings = work / "settings.json"
    settings.write_text(json.dumps({"version": 8, "web_agents_enabled": False}))
    port = free_port()
    fs = float(SIGNAL_DEMO_CONFIG["samp_rate"])
    out = {"listeners": []}

    async def listener(i, mode, dial, f_tone):
        t_conn = time.perf_counter()
        client = await WsClient.connect(port)
        await client.handshake()
        if full and i == 0:
            details = await client.expect_json("receiver_details")
            modes = await client.expect_json("modes")
            profiles = await client.expect_json("profiles")
            config = await client.expect_json("config")
            check("receiver_name" in details["value"]
                  and {"nfm", "am", "usb", "lsb", "cw", "sam", "wfm"}
                  <= {m["modulation"] for m in modes["value"]}
                  and profiles["value"][0]["id"] == "demo|default"
                  and config["value"]["samp_rate"] == int(fs),
                  f"7a {tag}: handshake messages")
        else:
            # the server sends its config once the source's runtime is
            # built and before it starts: the browser's cue to start
            await client.expect_json("config")
        t_dsp = time.perf_counter()
        await client.send_json({"type": "dspcontrol", "action": "start", "params": {
            "mod": mode, "offset_freq": int(dial), "squelch_level": -150}})
        await client.send_json(CLI_MARK)
        rows = 3 if full and i == 0 else 0
        audio, got, smeter, first, marked = bytearray(), [], [], None, False
        while len(audio) < CLI_LISTEN_S * SRV_AUDIO_BYTES_PER_S or len(got) < rows:
            check(time.perf_counter() - t_dsp < SRV_DEADLINE_S, f"7a {tag}: {mode} audio stalled")
            opcode, payload = await asyncio.wait_for(client.receive(), SRV_DEADLINE_S)
            if opcode == 0x1:
                msg = json.loads(payload)
                marked |= (msg.get("type") == "chat_message"
                           and msg.get("text") == CLI_MARK["text"])
                if marked and msg.get("type") == "smeter":
                    smeter.append(msg["value"])
            elif marked and opcode == 0x2 and payload[:1] == b"\x02":
                first = first or time.perf_counter()
                audio.extend(payload[1:])
            elif marked and opcode == 0x2 and payload[:1] == b"\x01":
                got.append(payload[1:])
        client.close()
        snr, n = audio_snr(audio, f_tone, adpcm)
        out["listeners"].append({
            "mode": mode, "dial_hz": dial, "dsp_to_audio_ms": (first - t_dsp) * 1e3,
            "connect_to_audio_ms": (first - t_conn) * 1e3, "snr_db": snr,
            "samples": n})
        if full and i == 0:
            out.update(rows=got, smeter=smeter)

    async def secondary_step():
        """While an NFM listener plays, a second connection opens a USB
        listener with a PSK31 secondary (CLI_SECONDARY) → the ms to that
        connection's first secondary-FFT frame (0x03) after its
        dspcontrol, and the largest gap between the playing listener's
        consecutive audio frames in the CLI_GAP_WINDOW_S after it."""
        mode, dial, _ = CLI_LISTENERS[0]
        player = await WsClient.connect(port)
        await player.handshake()
        await player.expect_json("config")
        await player.send_json({"type": "dspcontrol", "action": "start", "params": {
            "mod": mode, "offset_freq": int(dial), "squelch_level": -150}})
        await player.send_json(CLI_MARK)
        arrivals, tasks = [], []

        async def play():
            marked = False
            while True:
                opcode, payload = await player.receive()
                if opcode == 0x1:
                    msg = json.loads(payload)
                    marked |= (msg.get("type") == "chat_message"
                               and msg.get("text") == CLI_MARK["text"])
                elif marked and opcode == 0x2 and payload[:1] == b"\x02":
                    arrivals.append(time.perf_counter())

        async def drain(client):
            while True:
                await client.receive()

        async def wait_until(cond, what):
            t0 = time.perf_counter()
            while not cond():
                check(time.perf_counter() - t0 < SRV_DEADLINE_S, f"7a {tag}: {what}")
                for task in tasks:
                    if task.done():
                        task.result()
                await asyncio.sleep(0.01)

        tasks.append(asyncio.create_task(play()))
        second = None
        try:
            await wait_until(lambda: arrivals and arrivals[-1] - arrivals[0] >= CLI_PLAY_S,
                             f"{mode} never played")
            second = await WsClient.connect(port)
            await second.handshake()
            await second.expect_json("config")
            sec_mode, sec_dial, sec = CLI_SECONDARY
            t_sec = time.perf_counter()
            await second.send_json({"type": "dspcontrol", "action": "start", "params": {
                "mod": sec_mode, "offset_freq": int(sec_dial), "squelch_level": -150,
                "secondary_mod": sec}})
            while True:
                opcode, payload = await asyncio.wait_for(second.receive(), SRV_DEADLINE_S)
                if opcode == 0x2 and payload[:1] == b"\x03":
                    first_fft = time.perf_counter()
                    break
            tasks.append(asyncio.create_task(drain(second)))
            t_end = t_sec + CLI_GAP_WINDOW_S
            await wait_until(lambda: arrivals[-1] > t_end, f"{mode} stopped playing")
        finally:
            for task in tasks:
                task.cancel()
            player.close()
            if second is not None:
                second.close()
        gaps = [b - a for a, b in zip(arrivals, arrivals[1:]) if b > t_sec and a < t_end]
        frames = sum(t_sec < a <= t_end for a in arrivals)
        return {"mode": sec, "first_fft_ms": (first_fft - t_sec) * 1e3,
                "max_audio_gap_ms": max(gaps) * 1e3, "audio_frames": frames,
                "steady_gap_ms": float(np.median(np.diff(arrivals))) * 1e3}

    async def session(proc, t_launch):
        deadline = time.perf_counter() + SRV_DEADLINE_S
        while True:
            check(proc.poll() is None, f"7a {tag}: the server exited with {proc.returncode}")
            check(time.perf_counter() < deadline, f"7a {tag}: the server never answered")
            try:
                status, body, _ = await http_request(port, "GET", "/status.json")
                if status == 200:
                    break
            except OSError:
                await asyncio.sleep(0.2)
        out["ready_s"] = time.perf_counter() - t_launch
        for i, (mode, dial, f_tone) in enumerate(CLI_LISTENERS):
            await listener(i, mode, dial, f_tone)
        out["secondary"] = await secondary_step()

    log_path = work / f"cli_{tag}.log"
    cmd = [sys.executable, "-m", "openwebrx_tpu_torch", "--signal-demo",
           "--port", str(port), "--config", str(settings)]
    with open(log_path, "w") as logf:
        t_launch = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, stdout=logf, stderr=subprocess.STDOUT,
                                env={**os.environ, "PYTHONPATH": str(root)})
        try:
            try:
                asyncio.run(session(proc, t_launch))
            finally:
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
                    proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rc = proc.returncode
    text = log_path.read_text()
    check(rc == 0 and "ready on" in text and "shutting down" in text
          and " ERROR " not in text,
          f"7a {tag}: the server exited {rc}; its log ends: {text[-3000:]}")
    built = re.search(r"kernels built in ([0-9.]+) s", text)
    check(built is not None, f"7a {tag}: the server did not build the kernels before listening")
    warmed = re.search(r"warmed in ([0-9.]+) s", text)
    check(warmed is None or warmed.start() < text.index("ready on"),
          f"7a {tag}: the server warmed up after it listened")
    out.update(kernel_build_s=float(built.group(1)),
               warm_s=float(warmed.group(1)) if warmed else None)
    for lst in out["listeners"]:
        check(lst["snr_db"] >= TONE_SNR_MIN_DB,
              f"7a {tag}: {lst['mode']} tone SNR {lst['snr_db']:.1f} dB")
    if full:
        check(out["smeter"] and all(isinstance(v, float) for v in out["smeter"]),
              f"7a {tag}: no smeter readings")
        nb = len(out["rows"][-1])
        check(all(len(r) == nb for r in out["rows"]) and nb > 2000,
              f"7a {tag}: waterfall rows of {sorted({len(r) for r in out['rows']})} bytes")
        row = decoded_row(out["rows"][-1], nb, adpcm)
        floor = float(np.median(row[:WF_SIZE]))
        found = []
        for sig in SIGNAL_DEMO_CONFIG["signals"]:
            kind, off = sig["kind"], sig["offset_hz"]
            if kind == "usb":                     # one line, the tone
                k, span = wf_bin(off + sig["f_audio"], fs), 1
            elif kind == "am":                    # the carrier
                k, span = wf_bin(off, fs), 1
            else:   # FM: its lines spread ±(deviation + tone), 7 bins at 2.4 MS/s
                k, span = wf_bin(off, fs), int(np.ceil(4000.0 / (fs / WF_SIZE)))
            peak = k - 8 - span + int(np.argmax(row[k - 8 - span:k + 9 + span]))
            found.append(f"{kind} {off:+.0f} Hz: bin {peak} (expected {k} ± {span}), "
                         f"{row[peak] - floor:.1f} dB above the median")
            check(abs(peak - k) <= span and row[peak] - floor > 10.0,
                  f"7a {tag}: waterfall: {found[-1]}")
        log(f"[cli] {tag} waterfall: " + "; ".join(found))
        out.pop("rows")
        out["smeter"] = len(out["smeter"])
    warm = "no warm-up logged" if out["warm_s"] is None else f"warmed in {out['warm_s']} s"
    log(f"[cli] {tag}: answered after {out['ready_s']:.3f} s (kernels built in "
        f"{out['kernel_build_s']} s, {warm})")
    for lst in out["listeners"]:
        log(f"[cli] {tag}: {lst['mode']} at {lst['dial_hz']:+.0f} Hz, a bank new to the "
            f"process: first audio {lst['dsp_to_audio_ms']:.1f} ms after dspcontrol, "
            f"{lst['connect_to_audio_ms']:.1f} ms after connect; tone SNR "
            f"{lst['snr_db']:.1f} dB ({lst['samples']} samples)")
    sec = out["secondary"]
    log(f"[cli] {tag}: {sec['mode']} secondary on a second connection, new to the process: "
        f"first secondary-FFT frame {sec['first_fft_ms']:.1f} ms after dspcontrol; the "
        f"playing {CLI_LISTENERS[0][0]} listener's largest audio gap in the "
        f"{CLI_GAP_WINDOW_S:.0f} s after {sec['max_audio_gap_ms']:.1f} ms "
        f"({sec['audio_frames']} frames; median gap {sec['steady_gap_ms']:.1f} ms)")
    return out


def first_audio_summary(smi, runs, label):
    """p50 and max of first audio on banks new to the process over every
    listener of ``runs`` (cli_server results), logged on lines of their own."""
    dsp = [lst["dsp_to_audio_ms"] for r in runs for lst in r["listeners"]]
    conn = [lst["connect_to_audio_ms"] for r in runs for lst in r["listeners"]]
    ready = [r["ready_s"] for r in runs]
    warm = [r["warm_s"] for r in runs]
    fft = [r["secondary"]["first_fft_ms"] for r in runs]
    gap = [r["secondary"]["max_audio_gap_ms"] for r in runs]
    out = {"listeners": len(dsp), "processes": len(runs),
           "dsp_to_audio_ms": {"p50": float(np.median(dsp)), "max": max(dsp), "all": dsp},
           "connect_to_audio_ms": {"p50": float(np.median(conn)), "max": max(conn),
                                   "all": conn},
           "ready_s": ready, "warm_s": warm,
           "secondary_first_fft_ms": fft, "secondary_max_audio_gap_ms": gap}
    log(f"[cli] {label} {smi}: first audio on a bank new to the process, {len(dsp)} "
        f"listeners in {len(runs)} fresh processes: after dspcontrol p50 "
        f"{out['dsp_to_audio_ms']['p50']:.1f} ms, max {max(dsp):.1f} ms")
    log(f"[cli] {label} {smi}: first audio after connect p50 "
        f"{out['connect_to_audio_ms']['p50']:.1f} ms, max {max(conn):.1f} ms")
    log(f"[cli] {label} {smi}: ready_s {', '.join(f'{v:.3f}' for v in ready)}")
    log(f"[cli] {label} {smi}: warm-up s {', '.join(str(v) for v in warm)}")
    log(f"[cli] {label} {smi}: {CLI_SECONDARY[2]} secondary new to the process: first "
        f"secondary-FFT frame ms {', '.join(f'{v:.1f}' for v in fft)}; the playing "
        f"listener's largest audio gap ms {', '.join(f'{v:.1f}' for v in gap)}")
    return out


def run_split(root):
    """The startup split of the server at ``root`` (``chip_smoke.py
    --startup-split``) in a fresh process → its dict."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--startup-split",
                           str(root)], cwd=root, capture_output=True, text=True,
                          timeout=SRV_DEADLINE_S * 3)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"startup_split"')]
    check(proc.returncode == 0 and lines,
          f"startup split of {root}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[-1])["startup_split"]


def log_split(smi, split, label):
    """The split's lines: each step, then each listener's blocks."""
    log(f"[split] {label} {smi}: import {split['import_ms']:.1f} ms, CUDA context "
        f"{split['cuda_context_ms']:.1f} ms, kernels build {split['kernels_build_ms']:.1f} ms, "
        f"warm-up {split['warm_up_ms']} ms ({split['warm_up_launches']} launches), runtime "
        f"{split['runtime_ms']:.1f} ms, start {split['start_ms']:.1f} ms")
    for lst in split["listeners"]:
        log(f"[split] {label}: {lst['mode']} -> {lst['bucket_key']}: open_channel "
            f"{lst['open_ms']:.1f} ms {json.dumps(lst['open_split'])}; first audio at block "
            f"{lst['audio_block']}; graph captures by block (ms) "
            f"{[round(v, 1) for v in lst.get('capture_ms', [])]}")
        for b, blk in enumerate(lst["blocks"]):
            top = sorted(blk["ops"].items(), key=lambda kv: -kv[1])[:8]
            log(f"[split] {label}: {lst['mode']} block {b}: dispatch {blk['dispatch_ms']:.1f} "
                f"ms, complete {blk['complete_ms']:.1f} ms; " + ", ".join(
                    f"{k} {v:.2f}" for k, v in top) + (
                    f"; loads {json.dumps(blk['loads'])}" if blk["loads"] else ""))
    if "warm_up_row_encoder_shapes" in split:
        log(f"[split] {label}: the warm-up's row-encoder shapes "
            f"{split['warm_up_row_encoder_shapes']}")
    for rec in split.get("programs", []):
        first = next(b for b in rec["blocks"] if b["delivered"])
        top = sorted(first["ops"].items(), key=lambda kv: -kv[1])[:6]
        log(f"[split] {label}: {rec['kind']} {','.join(rec['modes'])}: open "
            f"{rec['open_ms']:.1f} ms; first block {rec['first_ms']:.1f} ms (feed "
            f"{rec['first_feed_ms']:.1f}), capture {rec.get('capture_ms', 0.0):.1f} ms, "
            f"steady {rec['steady_ms']:.1f} ms (feed "
            f"{rec['steady_feed_ms']:.1f}); first: " + ", ".join(
                f"{k} {v:.2f}" for k, v in top) + (
                f"; loads {json.dumps(first['loads'])}" if first["loads"] else ""))


def cli_session(smi, paths, adpcm):
    """Phase 7a: CLI_PROCESSES fresh servers of this checkout (cli_server,
    the first with the full checks), each of which must warm up before it
    listens, then the startup split in a fresh process."""
    t_phase = time.perf_counter()
    runs = [cli_server(ROOT, adpcm, full=i == 0, tag=f"process {i}")
            for i in range(CLI_PROCESSES)]
    check(all(r["warm_s"] is not None for r in runs), "7a: a server did not warm up")
    # printed, not checked against PERF.md §2's 1 s: with the warm-up a new
    # bank's first audio is the block cadence, which a slower host has
    # pushed past 0.5 s (PERF.md §6), too close to 1 s to hold
    summary = first_audio_summary(smi, runs, "this tree")
    split = run_split(ROOT)
    log_split(smi, split, "this tree")
    log(f"[cli] phase 7a took {time.perf_counter() - t_phase:.1f} s")
    paths["cli"] = {**summary, "runs": runs,
                    "snr_db": {lst["mode"]: lst["snr_db"] for lst in runs[0]["listeners"]}}
    return split


def first_audio_alone(roots) -> int:
    """``chip_smoke.py --first-audio ROOT ...``: phase 7a's fresh servers
    and the startup split for each checkout in the order given (list
    ``build/parent . . build/parent`` to alternate two), each checkout's
    kernels built first in a process of its own."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from openwebrx_tpu_torch.ops import adpcm
    smi = nvidia_smi()
    log(f"[card] nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    results = []
    for n, root in enumerate(roots):
        root = Path(root).resolve()
        built = subprocess.run(
            [sys.executable, "-c", "from openwebrx_tpu_torch import kernels; "
             "print(kernels.build_all())"], cwd=root, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(root)}, timeout=900)
        check(built.returncode == 0, f"build of {root}: {built.stderr[-3000:]}")
        label = f"{root.name or root} #{n}"
        log(f"[first-audio] {label}: kernels built in {float(built.stdout):.1f} s")
        runs = [cli_server(root, adpcm, full=False, tag=f"{label} process {i}")
                for i in range(CLI_PROCESSES)]
        summary = first_audio_summary(smi, runs, label)
        split = run_split(root)
        log_split(smi, split, label)
        results.append({"root": str(root), **summary, "runs": runs, "split": split})
    print(json.dumps({"card": smi, "first_audio": results}), flush=True)
    return 0


def split_programs(rt):
    """One of each program signature that a listener or a service can open
    on ``rt`` besides a channel and the waterfall → [(kind, modes, key)]:
    a secondary of every SECONDARY_FACTORY mode, the program of every
    DV_FACTORY mode, an IQ tap at every (IF rate, wire) of
    ExecAudioHandle.MODES and IQ_EXEC_MODES at most the source's rate, and
    the M17 metadata tap.  A signature is the chain's class, block and
    structure, computed on the host from the chain as its handle builds it
    (the split runs the parent's package too)."""
    from openwebrx_tpu_torch.models.digital_voice import DV_FACTORY
    from openwebrx_tpu_torch.models.secondary import SECONDARY_FACTORY
    from openwebrx_tpu_torch.models.stages import plan_block_size
    from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
    from openwebrx_tpu_torch.runtime.device import ExecAudioHandle
    from openwebrx_tpu_torch.services.exec_modes import IQ_EXEC_MODES
    spec = StreamSpec(Format.COMPLEX_FLOAT, rt.in_rate)

    def signature(kind, chain):
        block = plan_block_size(chain, spec, 0.1)
        chain.plan(spec, block)
        return (kind, type(chain).__name__, block, chain.signature())
    groups = {}
    for kind, factory in (("secondary", SECONDARY_FACTORY), ("dv", DV_FACTORY)):
        for mode, make in factory.items():
            groups.setdefault(signature(kind, make(rt.in_rate)), []).append(mode)
    taps = {}
    for mode, (if_rate, wire, *_) in ExecAudioHandle.MODES.items():
        taps.setdefault(("iq", float(if_rate), wire), []).append(mode)
    for mode, iq in IQ_EXEC_MODES.items():
        taps.setdefault(("iq", float(iq["if_rate"]), iq["wire"]), []).append(mode)
    groups.update({key: modes for key, modes in sorted(taps.items())
                   if key[1] <= rt.in_rate})
    groups[("m17meta",)] = ["m17 metadata"]
    return [(key[0], modes, key) for key, modes in groups.items()]


class SplitFeed:
    """A program fed by the runtime's block path as a handle feeds one:
    the device block cut into the program's blocks, each processed;
    ``delivered`` lists one entry a block run."""

    def __init__(self, mode, program, chunks, delivered):
        self.mode, self.program, self.chunks = mode, program, chunks
        self.delivered = delivered

    def feed(self, x):
        for chunk in self.chunks.push(x):
            self.program.process(chunk)
            self.delivered.append(1)


def open_split_program(rt, device_mod, kind, modes, key, dev):
    """Open the program of ``kind`` for ``modes[0]`` on ``rt`` as its
    handle does, starting no subprocess → (the object the runtime's block
    path feeds, the list its deliveries go to, close)."""
    delivered = []
    if kind == "secondary":
        handle = rt.open_secondary(modes[0], 0.0)
        deliver = handle._deliver
        handle._deliver = lambda y, fft: (delivered.append(1), deliver(y, fft))
        handle.text_cb = lambda text: None
        handle.fft_cb = lambda payload: None
        return handle.bank, delivered, lambda: rt.release_secondary(handle)
    if kind == "iq":
        tap = rt.open_iq_channel(key[1], 0.0, key[2])
        tap.iq_cb = lambda data: delivered.append(1)
        return tap, delivered, lambda: rt.release_secondary(tap)
    if kind == "dv":
        make = getattr(device_mod, "dv_program", None)
        if make is not None:
            _, block, program = make(modes[0], rt.in_rate, 0.0, dev)
        else:                       # as a DigitalVoiceHandle builds it
            from openwebrx_tpu_torch.models.stages import plan_block_size
            from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
            chain = device_mod.DV_FACTORY[modes[0]](rt.in_rate)
            chain.set_frequency_offset(0.0)
            spec = StreamSpec(Format.COMPLEX_FLOAT, rt.in_rate)
            block = plan_block_size(chain, spec, 0.1)
            program = device_mod.Program(chain, spec, block, device=dev)
        fed = SplitFeed(modes[0], program, device_mod._Chunks(block, dev), delivered)
    else:                           # the M17 metadata tap, a tap block a block
        tap = device_mod.M17MetaTap(lambda meta: None, rt.host, dev)
        decode = tap.decoder.feed
        tap.decoder.feed = lambda dibits: (delivered.append(1), decode(dibits))
        cs16 = bytes(4 * tap.block)
        fed = SplitFeed("m17meta", tap.program, None, delivered)
        fed.feed = lambda x: tap.feed_cs16(cs16)
    with rt._lock:
        rt.secondary_handles.append(fed)
    return fed, delivered, lambda: rt.release_secondary(fed)


def split_summary(rec):
    """A program's split → its first delivering block's and its steady
    delivering blocks' ms (the loop's whole block, and the program's own
    feed)."""
    ran = [b for b in rec["blocks"] if b["delivered"]]
    whole = [b["dispatch_ms"] + b["complete_ms"] for b in ran]
    return {"first_ms": whole[0], "steady_ms": float(np.median(whole[1:] or whole)),
            "capture_ms": sum(b["ops"].get("capture", 0.0) for b in rec["blocks"]),
            "first_feed_ms": ran[0]["feed_ms"],
            "steady_feed_ms": float(np.median([b["feed_ms"] for b in ran[1:]]
                                              or [ran[0]["feed_ms"]]))}


def startup_split(root) -> int:
    """``chip_smoke.py --startup-split ROOT``, in a fresh process: the
    steps of the server at ``ROOT`` from its start to first audio on each
    of CLI_LISTENERS' banks new to the process (opened straight at their
    dials), each timed with ``torch.cuda.synchronize()`` at its edges: the
    CUDA context, the kernels' build, the warm-up where ROOT's runtime has
    one (its launches counted apart), the runtime, its start, the
    waterfall subscribed, then a listener at a time: ``open_channel`` (the
    bank's build, its prototype and chain design within) and blocks on a
    thread of their own, as the runtime's loop runs them, until its first
    audio and SPLIT_STEADY_BLOCKS more, each split into dispatch
    (``F.conv1d``, each ``torch.fft`` size, ``torch.quantile``, each
    kernel's launch with its library's load, the upload and the fetches'
    start within) and completion (fetch and delivery); then, beside those
    listeners, one program of every ``split_programs`` signature at a
    time, opened, run through the same blocks to SPLIT_STEADY_BLOCKS
    deliveries past its first (its own feed timed too) and closed.  The
    warm-up's row-encoder shapes are recorded.  Prints one
    ``{"startup_split": ...}`` line."""
    t_start = time.perf_counter()
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.core.property import PropertyLayer
    from openwebrx_tpu_torch.models import receiver
    from openwebrx_tpu_torch.ops import adpcm as adpcm_mod
    from openwebrx_tpu_torch.ops import channelizer
    from openwebrx_tpu_torch.runtime import bank as bank_mod
    from openwebrx_tpu_torch.runtime import chain as chain_mod
    from openwebrx_tpu_torch.runtime import channelized
    from openwebrx_tpu_torch.runtime import device as device_mod
    from openwebrx_tpu_torch.sources.file import SignalSource
    from openwebrx_tpu_torch.web.server import SIGNAL_DEMO_CONFIG
    check(Path(kernels.__file__).resolve().is_relative_to(root),
          f"the split imported {kernels.__file__}, not {root}'s package")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    out = {"root": str(root), "import_ms": (time.perf_counter() - t_start) * 1e3,
           "cuda_module_loading": os.environ.get("CUDA_MODULE_LOADING")}
    sync = torch.cuda.synchronize
    acc, loads = {}, {}

    def add(key, t0):
        acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t0) * 1e3

    def timer(obj, name, key_of):
        orig = getattr(obj, name)

        def timed(*a, **k):
            if torch.cuda.is_current_stream_capturing():
                return orig(*a, **k)        # recorded, not run: the capture is timed
            key = key_of(*a, **k)
            sync()
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                sync()
                add(key, t0)
        setattr(obj, name, timed)

    def step(key, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        out[key] = (time.perf_counter() - t0) * 1e3
        return r

    def source():
        return SignalSource("demo", PropertyLayer(**{**SIGNAL_DEMO_CONFIG, "throttle": False}))

    dev = torch.device("cuda", 0)
    step("cuda_context_ms", lambda: torch.zeros(1, device=dev))
    step("kernels_build_ms", kernels.build_all)
    warm_up = getattr(device_mod, "warm_up", None)
    for k in kernels.ALL:
        k.launches = 0
    seq_shapes = set()
    encode_seq = adpcm_mod.encode_seq_kernel

    def recording_seq(state, samples, *a, **k):
        seq_shapes.add(tuple(samples.shape))
        return encode_seq(state, samples, *a, **k)
    adpcm_mod.encode_seq_kernel = recording_seq
    if warm_up is None:
        out["warm_up_ms"] = None
    else:
        step("warm_up_ms", lambda: warm_up(device_mod.DeviceRuntime(
            source(), device=dev, **SERVER_RUNTIME_KW)))
    adpcm_mod.encode_seq_kernel = encode_seq
    out["warm_up_launches"] = {k.source.name: k.launches for k in kernels.ALL}
    out["warm_up_row_encoder_shapes"] = sorted(seq_shapes)
    src = source()
    rt = step("runtime_ms", lambda: device_mod.DeviceRuntime(src, device=dev,
                                                             **SERVER_RUNTIME_KW))
    step("start_ms", rt.build_kernels)
    src.start()
    block = src.read_block(timeout=SRV_DEADLINE_S)
    src.shutdown()
    check(block is not None, "startup split: the demo source gave no block")

    # the timed pieces, each with a synchronize at its edges
    def shape_key(name):
        return lambda x, *a, **k: f"{name} {tuple(x.shape)} n={k.get('n')}"
    timer(torch.nn.functional, "conv1d",
          lambda x, w, *a, **k: f"conv1d {tuple(x.shape)}*{tuple(w.shape)}")
    for name in ("fft", "ifft", "rfft", "irfft"):
        timer(torch.fft, name, shape_key(name))
    timer(torch, "quantile", lambda x, *a, **k: f"quantile {tuple(x.shape)}")
    timer(kernels.CudaKernel, "launch", lambda self, *a: f"kernel {self.source.name}")
    orig_load = kernels.CudaKernel._load

    def load(self):
        if self._fn is not None:
            return orig_load(self)
        t0 = time.perf_counter()
        try:
            return orig_load(self)
        finally:
            loads[self.source.name] = (time.perf_counter() - t0) * 1e3
    kernels.CudaKernel._load = load
    timer(device_mod.DeviceRuntime, "_upload", lambda *a: "upload")
    timer(device_mod, "start_fetches", lambda *a: "start_fetches")
    timer(device_mod, "finish_fetch", lambda *a: "finish_fetch")
    timer(channelized.ChannelizedBank, "__init__", lambda *a, **k: "bank build")
    timer(bank_mod.ChannelBank, "__init__", lambda *a, **k: "bank build")
    timer(channelizer, "design_prototype", lambda *a, **k: "prototype design")
    graph_step = getattr(chain_mod, "GraphStep", None)   # a checkout with graphs
    if graph_step is not None:
        timer(graph_step, "_capture", lambda *a: "capture")
    timer(receiver.ClientDemodulatorChain, "__init__", lambda *a, **k: "chain design")

    rows = []
    rt.subscribe_waterfall(rows.append)
    for k in kernels.ALL:
        k.launches = 0

    def run_block():
        sync()
        t0 = time.perf_counter()
        pending = rt._dispatch_block(block)
        sync()
        t1 = time.perf_counter()
        rt._complete_block(pending)
        sync()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    listeners = []
    with concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="loop") as loop:
        loop.submit(torch.cuda.set_device, dev).result()
        for mode, dial, _ in CLI_LISTENERS:
            acc.clear()
            loads.clear()
            t0 = time.perf_counter()
            handle = rt.open_channel(mode, dial)
            sync()
            lst = {"mode": mode, "bucket_key": handle.bucket_key,
                   "open_ms": (time.perf_counter() - t0) * 1e3, "open_split": dict(acc),
                   "blocks": [], "audio_block": None}
            heard = []
            handle.audio_cb = lambda wire, hd: heard.append(len(wire))
            while len(lst["blocks"]) < 8 and (
                    lst["audio_block"] is None
                    or len(lst["blocks"]) <= lst["audio_block"] + SPLIT_STEADY_BLOCKS):
                acc.clear()
                loads.clear()
                d_ms, c_ms = loop.submit(run_block).result()
                lst["blocks"].append({"dispatch_ms": d_ms, "complete_ms": c_ms,
                                      "ops": dict(acc), "loads": dict(loads)})
                if heard and lst["audio_block"] is None:
                    lst["audio_block"] = len(lst["blocks"]) - 1
            check(lst["audio_block"] is not None, f"startup split: {mode} never heard audio")
            lst["capture_ms"] = [b["ops"].get("capture", 0.0) for b in lst["blocks"]]
            listeners.append(lst)
        # then, beside those listeners, one program of every other
        # signature, each opened, run to SPLIT_STEADY_BLOCKS deliveries
        # past its first and closed before the next
        programs = []
        for kind, modes, key in split_programs(rt):
            acc.clear()
            loads.clear()
            t0 = time.perf_counter()
            fed, delivered, close = open_split_program(rt, device_mod, kind, modes, key, dev)
            sync()
            rec = {"kind": kind, "modes": modes, "open_ms": (time.perf_counter() - t0) * 1e3,
                   "open_split": dict(acc), "blocks": []}
            feed_ms = []
            feed = fed.feed

            def timed_feed(x, feed=feed, feed_ms=feed_ms):
                sync()
                t0 = time.perf_counter()
                try:
                    return feed(x)
                finally:
                    sync()
                    feed_ms.append((time.perf_counter() - t0) * 1e3)
            fed.feed = timed_feed
            while (len(rec["blocks"]) < SPLIT_PROGRAM_BLOCKS
                   and len(delivered) <= SPLIT_STEADY_BLOCKS):
                acc.clear()
                loads.clear()
                feed_ms.clear()
                before = len(delivered)
                d_ms, c_ms = loop.submit(run_block).result()
                rec["blocks"].append({"dispatch_ms": d_ms, "complete_ms": c_ms,
                                      "feed_ms": sum(feed_ms),
                                      "delivered": len(delivered) - before,
                                      "ops": dict(acc), "loads": dict(loads)})
            close()
            check(len(delivered) > SPLIT_STEADY_BLOCKS,
                  f"startup split: {kind} {modes} delivered {len(delivered)} blocks in "
                  f"{len(rec['blocks'])}")
            rec.update(split_summary(rec))
            programs.append(rec)
    check(rows, "startup split: no waterfall row")
    out["listeners"] = listeners
    out["programs"] = programs
    out["launches"] = {k.source.name: k.launches for k in kernels.ALL}
    print(json.dumps({"startup_split": out}), flush=True)
    return 0


def server_plan(rt):
    """Phase 7b's 64 dials, one per listener: centres of a grid every
    bucket's filterbank shares (the coarsest of their channel spacings),
    spread over ±45 % of the band, +500 Hz; modes interleaved."""
    spacing = RT_FS / min(rt._pfb_m_for(b) for b in ("ssb", "nfm", "am"))
    top = int(0.45 * RT_FS / spacing)
    grid = [j for j in range(-top, top + 1) if j]
    picks = np.linspace(0, len(grid) - 1, len(SRV_MODES)).round().astype(int)
    check(len(set(picks)) == len(SRV_MODES), "7b: not enough distinct channels")
    modes = [SRV_MODES[i] for i in np.random.default_rng(7).permutation(len(SRV_MODES))]
    return [(mode, grid[p] * spacing + 500.0) for mode, p in zip(modes, picks)]


def write_server_file(torch, dev, path, plan):
    """The 7b recording: seeded noise plus each listener's carrier (USB: a
    tone TONE_AUDIO_HZ above the dial; NFM: FM at 3 kHz deviation; AM: 60 %)
    at a seeded random phase (carriers on a regular grid in phase would add
    up to periodic peaks that clip) over SRV_FILE_SECONDS, as cu8 pairs
    (bias 127.4, ±128 full scale, as ops/convert.py reads them).  Every
    carrier completes whole cycles over the file, so the looped source is
    seamless."""
    n = int(SRV_FILE_SECONDS * RT_FS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    t = torch.arange(n, device=dev, dtype=torch.float64)
    x = torch.complex(torch.randn(n, generator=gen, device=dev),
                      torch.randn(n, generator=gen, device=dev)) * SRV_NOISE
    phases = torch.rand(len(plan), generator=gen, device=dev, dtype=torch.float64)
    for (mode, dial), phase in zip(plan, phases):
        cycles = (dial + TONE_AUDIO_HZ) * SRV_FILE_SECONDS
        check(abs(cycles - round(cycles)) < 1e-6, f"7b: {dial} Hz does not loop")
        rot = torch.polar(torch.ones((), device=dev, dtype=torch.float64),
                          2 * np.pi * phase).to(torch.complex64)
        x = x + modulated(torch, t, RT_FS, dial, mode, SRV_CARRIER_AMP) * rot
    packed = torch.view_as_real(x.to(torch.complex64)).cpu().numpy()
    clipped = float(np.mean(np.abs(packed) > 127.4 / 128))
    np.clip(np.rint(packed * 128.0 + 127.4), 0, 255).astype(np.uint8).tofile(path)
    return clipped


def server_paths(torch, dev, smi, paths, launches_by_path):
    """Phase 7b and 7c: the port's server in this process on a looped cu8
    recording at 8.192 MS/s, 64 WebSocket listeners with the waterfall,
    then /api/profile on the card."""
    import asyncio
    from collections import deque
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.core.config import Config, CoreConfig
    from openwebrx_tpu_torch.core.users import SessionStorage, UserList
    from openwebrx_tpu_torch.ops import adpcm
    from openwebrx_tpu_torch.sdr import SdrService
    from openwebrx_tpu_torch.web.http import HttpServer
    from openwebrx_tpu_torch.web.server import build_router

    from torch_graph_scenes import trace_kernels
    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke"
    data_dir = work / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    CoreConfig.defaults.update(data_directory=str(data_dir),
                               temporary_directory=str(data_dir))
    users = UserList(str(data_dir / "users.json"))
    if "smoke" not in users:
        users.add_user("smoke", "smoke")
    UserList.shared = staticmethod(lambda: users)
    SessionStorage._instance = None
    errors = ErrorRecords()
    logging.getLogger("openwebrx_tpu_torch").addHandler(errors.handler)

    path = work / "srv_8192k.cu8"
    center = 100_000_000
    Config.reset()
    cfg = Config.get()
    cfg["tpu_block_seconds"] = 0.2
    cfg["fft_size"] = WF_SIZE
    cfg["max_clients"] = cfg["max_clients_per_ip"] = 2 * len(SRV_MODES)
    cfg["sdrs"] = {"srv": {
        "name": "8.192 MS/s recording", "type": "file", "file_path": str(path),
        "file_format": "cu8", "samp_rate": int(RT_FS), "center_freq": center,
        "throttle": True,
        "profiles": {"default": {"name": "8.192 MS/s", "center_freq": center,
                                 "samp_rate": int(RT_FS), "start_freq": center,
                                 "start_mod": "usb"}}}}
    SdrService.device = dev
    SdrService.load()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.ALL:
        k.launches = 0
    rt = SdrService.get_device("srv")
    check(rt is not None and rt.block == 1638400, "7b: the runtime's plan")
    plan = server_plan(rt)
    clipped = write_server_file(torch, dev, path, plan)
    nb_row = rt.fft_chain.waterfall.wire_bytes_per_row

    def session(rt, warm_s, window_s, profile_s):
        """One session of the server on ``rt``: the 64 listeners connect
        and start, every one hears audio, ``warm_s`` later a window of
        ``window_s`` is timed, /metrics read and /api/profile run for
        ``profile_s``; the server and every runtime stop → (out, host
        seconds by part in the window, each block's launches in it, the
        listeners' buckets)."""
        # the loop's blocks: host time by part and each block's kernel launches
        spent = {"dispatch": 0.0, "wait": 0.0, "deliver": 0.0}
        per_block, window = [], {"on": False}
        dispatch, complete = rt._dispatch_block, rt._complete_block

        def timed_dispatch(block):
            before = [k.launches for k in kernels.ALL]
            t0 = time.perf_counter()
            pend = dispatch(block)
            if window["on"]:
                spent["dispatch"] += time.perf_counter() - t0
                per_block.append(tuple(k.launches - b for k, b in zip(kernels.ALL, before)))
            return pend

        def timed_complete(pend):
            t0 = time.perf_counter()
            for p in [*pend["fft_pending"], *(q for ps in pend["bank_pending"].values()
                                                for q in ps)][:1]:
                if p.event is not None:       # one event for all of them
                    p.event.synchronize()
            t1 = time.perf_counter()
            complete(pend)
            if window["on"]:
                spent["wait"] += t1 - t0
                spent["deliver"] += time.perf_counter() - t1

        rt._dispatch_block, rt._complete_block = timed_dispatch, timed_complete
        out, buckets = {}, {}

        async def reader(client, st):
            try:
                while True:
                    opcode, payload = await client.receive()
                    if opcode == 0x2 and payload[:1] == b"\x02":
                        if st["first"] is None:
                            st["first"] = time.perf_counter() - st["t0"]
                            st["first_blocks"] = rt.gauges["blocks"] - st["block0"]
                        st["audio"].extend(payload[1:])
                    elif opcode == 0x2 and payload[:1] == b"\x01":
                        st["rows"] += 1
                        st["row"] = payload[1:]
            except (asyncio.IncompleteReadError, ConnectionError):
                pass

        async def run():
            server = HttpServer(build_router(), port=0, host="127.0.0.1")
            await server.start()
            port = server._server.sockets[0].getsockname()[1]
            clients, states, tasks = [], [], []
            t_connect = time.perf_counter()
            try:
                for mode, dial in plan:
                    client = await WsClient.connect(port)
                    await client.handshake()
                    await client.expect_json("config")
                    st = {"mode": mode, "dial": dial, "audio": bytearray(), "rows": 0,
                          "row": None, "first": None, "t0": time.perf_counter(),
                          "block0": rt.gauges["blocks"]}
                    await client.send_json({"type": "dspcontrol", "action": "start"})
                    await client.send_json({"type": "dspcontrol", "params": {
                        "mod": mode, "offset_freq": dial, "squelch_level": -150}})
                    clients.append(client)
                    states.append(st)
                    tasks.append(asyncio.create_task(reader(client, st)))
                out["connect_s"] = time.perf_counter() - t_connect
                deadline = time.perf_counter() + SRV_DEADLINE_S
                while any(st["first"] is None for st in states):
                    check(time.perf_counter() < deadline, "7b: a listener never heard audio")
                    await asyncio.sleep(0.05)
                with rt._lock:
                    for h in rt.handles:
                        buckets[h.bucket_key] = buckets.get(h.bucket_key, 0) + 1
                await asyncio.sleep(warm_s)
                marks = [len(st["audio"]) for st in states]
                rows0 = [st["rows"] for st in states]
                window["on"] = True
                t0 = time.perf_counter()
                await asyncio.sleep(window_s)
                window["on"] = False
                out["window_s"] = time.perf_counter() - t0
                out["rates"] = [(len(st["audio"]) - m) / out["window_s"]
                                for st, m in zip(states, marks)]
                out["rows"] = [st["rows"] - r for st, r in zip(states, rows0)]
                status, body, _ = await http_request(port, "GET", "/metrics")
                out["metrics"] = body.decode()
                # 7c: a profile of the running server on the card
                status, _, cookie = await http_request(
                    port, "POST", "/login", {"username": "smoke", "password": "smoke"})
                check(status == 200 and cookie, f"7c: login answered {status}")
                blocks0 = rt.gauges["blocks"]
                status, body, _ = await http_request(
                    port, "POST", f"/api/profile?seconds={profile_s}", cookie=cookie)
                check(status == 200, f"7c: /api/profile answered {status}: {body[:200]!r}")
                out["profile"] = json.loads(body)
                out["profile_blocks"] = rt.gauges["blocks"] - blocks0
            finally:
                for client in clients:
                    client.close()
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                await server.stop()
                SdrService.stop_all()
            out["states"] = states
        try:
            asyncio.run(run())
        finally:
            SdrService.stop_all()
            del rt._dispatch_block, rt._complete_block
        return out, spent, per_block, buckets

    out, spent, per_block, buckets = session(rt, SRV_WARM_S, SRV_WINDOW_S, SRV_PROFILE_S)
    graphs = [(k, st.captures, st.replays) for k, st in zip([*rt.banks, "waterfall"],
                                                            steps_of(rt))]
    log(f"[server] graph captures and replays by bank: {graphs}")
    check(len(graphs) == 4 and all(c == 1 and r > 0 for _, c, r in graphs),
          f"server: captures and replays {graphs}, expected one capture each")
    torch.cuda.synchronize()
    launches = {k.source.name: k.launches for k in kernels.ALL}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    launches_by_path["server"] = launches
    states = out["states"]
    errors.check("server")

    gauges = dict(rt.gauges)
    n_win = len(per_block)
    names = [k.source.name for k in kernels.ALL]
    shapes = sorted(set(per_block))
    log(f"[server] {len(states)} listeners ({', '.join(f'{m} {SRV_MODES.count(m)}' for m in dict.fromkeys(SRV_MODES))}) "
        f"routed {buckets}; {n_win} blocks in {out['window_s']:.2f} s; launches a block "
        f"in the window: {[dict(zip(names, s)) for s in shapes]}; whole run {launches} "
        f"({gauges['blocks']} blocks); cu8 samples clipped {clipped:.2e}")
    expected = tuple(SRV_LAUNCHES_PER_BLOCK[n] for n in names)
    check(shapes == [expected], f"server: launches a block {shapes}, expected {expected}")
    check(all(v > 0 for v in launches.values()), f"server: a kernel never launched: {launches}")
    check(n_win >= 0.9 * SRV_WINDOW_S / 0.2, f"server: {n_win} blocks in the window")
    check(buckets == {"pfbi:ssb": 32, "pfbi:nfm": 16, "pfbi:am": 16},
          f"server: listeners routed to {buckets}")
    rates = np.asarray(out["rates"]) / SRV_AUDIO_BYTES_PER_S
    first = np.asarray([st["first"] for st in states]) * 1e3
    first_blocks = [st["first_blocks"] for st in states]
    log(f"[server] {len(states)} listeners connected and started in {out['connect_s']:.2f} s; "
        f"first audio after dspcontrol (ms, in connection order): "
        f"{[round(v) for v in first]}; loop blocks in between: {first_blocks}")
    snrs = []
    for st in states:
        snr, n = audio_snr(st["audio"], TONE_AUDIO_HZ, adpcm)
        snrs.append(snr)
        st["snr"] = snr
        check(snr >= TONE_SNR_MIN_DB and n == 12000,
              f"server: {st['mode']} listener at {st['dial']:.0f} Hz: tone SNR {snr:.1f} dB")
    check(np.all(np.abs(rates - 1) <= SRV_RATE_TOL),
          f"server: audio byte rates {rates.min():.3f}..{rates.max():.3f} of nominal")
    check(min(out["rows"]) >= 2 * 0.9 * n_win, f"server: waterfall rows {min(out['rows'])}")
    rt_factor = re.search(r"^device_srv_realtime_factor ([0-9.]+)$", out["metrics"], re.M)
    proc_ms = re.search(r"^device_srv_proc_block_ms ([0-9.]+)$", out["metrics"], re.M)
    check(rt_factor is not None and float(rt_factor.group(1)) >= 1.0,
          f"server: realtime_factor on /metrics: {rt_factor and rt_factor.group(1)}")
    check(len(states[0]["row"]) == nb_row, f"server: waterfall rows of "
          f"{len(states[0]['row'])} bytes, expected {nb_row}")
    row = decoded_row(states[0]["row"], nb_row, adpcm)
    floor = float(np.median(row))
    for mode, dial in plan:
        if mode != "usb":
            continue
        k = wf_bin(dial + TONE_AUDIO_HZ, RT_FS)
        peak = k - 4 + int(np.argmax(row[k - 4:k + 5]))
        check(abs(peak - k) <= 1 and row[peak] - floor > 3.0,
              f"server: waterfall tone at {dial + TONE_AUDIO_HZ:.0f} Hz peaks in bin "
              f"{peak}, expected {k}")
    parts = {k: v / n_win * 1e3 for k, v in spent.items()}
    log(f"[server] {smi}: proc_block_ms {proc_ms.group(1)} (the loop's average), "
        f"realtime_factor {rt_factor.group(1)} (/metrics); host ms a block in the "
        f"window: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; audio bytes/s {rates.min():.4f}..{rates.max():.4f} of nominal; tone SNR "
        + ", ".join(f"{m} {min(st['snr'] for st in states if st['mode'] == m):.1f}.."
                    f"{max(st['snr'] for st in states if st['mode'] == m):.1f}"
                    for m in dict.fromkeys(SRV_MODES))
        + f" dB; first audio after dspcontrol p50 "
        f"{np.percentile(first, 50):.1f} ms, p95 {np.percentile(first, 95):.1f} ms; "
        f"waterfall rows a listener in the window {min(out['rows'])}..{max(out['rows'])} "
        f"(the USB tones in their bins ± 1); peak device memory {peak_mib:.1f} MiB")

    trace_dir = Path(out["profile"]["trace_dir"])
    try:
        events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    kernels_seen, ours = trace_kernels(events)
    busy = busy_ms(kernels_seen)
    log(f"[profile] /api/profile?seconds={SRV_PROFILE_S}: {len(events)} trace events, "
        f"{len(kernels_seen)} CUDA kernel events, hand-written kernels among them "
        f"{ours}; device busy {busy:.3f} ms of the {SRV_PROFILE_S * 1e3:.0f} ms "
        f"traced (idle share {1 - busy / (SRV_PROFILE_S * 1e3):.4f})")
    check(kernels_seen, "7c: the profile holds no CUDA kernel events")
    whole = check_traced_blocks("7c", kernels_seen)
    log(f"[profile] {len(whole)} whole blocks in the trace, each with the hand-written "
        f"launches {SRV_LAUNCHES_PER_BLOCK}")
    log(f"[server] phases 7b and 7c took {time.perf_counter() - t_phase:.1f} s")
    paths["server"] = {
        "ms_per_block": float(proc_ms.group(1)), "realtime_factor": float(rt_factor.group(1)),
        "blocks_in_window": n_win, "host_ms": parts, "peak_mib": peak_mib,
        "first_audio_ms": {"p50": float(np.percentile(first, 50)),
                           "p95": float(np.percentile(first, 95))},
        "audio_rate_of_nominal": [float(rates.min()), float(rates.max())],
        "tone_snr_db": [min(snrs), max(snrs)], "profile_kernel_events": len(kernels_seen),
        "profile_device_busy_ms": busy, "profile_hand_kernel_events": ours}
    del rt
    torch.cuda.empty_cache()

    # 7b alternated: sessions of the same server, its runtime's banks and
    # programs built with the eager step (E) or the graph (G), in ALT_ORDER
    from torch_graph_scenes import runtime_graph
    t_alt = time.perf_counter()
    alt = {"eager": [], "graph": []}
    for graph in ALT_ORDER:
        with runtime_graph(graph):
            rt = SdrService.get_device("srv")
            out, spent, per_block, _ = session(rt, SRV_ALT_WARM_S, SRV_ALT_WINDOW_S,
                                               SRV_ALT_PROFILE_S)
        n_win = len(per_block)
        check(n_win > 0 and set(per_block) == {expected},
              f"server ({'graph' if graph else 'eager'}): launches a block {set(per_block)}")
        trace_dir = Path(out["profile"]["trace_dir"])
        try:
            events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        seen, hand = trace_kernels(events)
        side = "graph" if graph else "eager"
        whole = check_traced_blocks(f"server ({side})", seen)
        blocks_traced = max(1, out["profile_blocks"])
        captured = [st.captures for st in steps_of(rt)]
        check(all(captured) if graph else not any(captured),
              f"server ({side}): captures by step {captured}")
        steps = [st for st in steps_of(rt) if st._graph is not None]
        device_ms = sum(replay_ms(torch, st) for st in steps)
        proc_ms = re.search(r"^device_srv_proc_block_ms ([0-9.]+)$", out["metrics"], re.M)
        first = np.asarray([st["first"] for st in out["states"]]) * 1e3
        alt["graph" if graph else "eager"].append({
            "first_audio_ms": {"p50": float(np.percentile(first, 50)),
                               "p95": float(np.percentile(first, 95))},
            "host_ms": {k: v / n_win * 1e3 for k, v in spent.items()},
            "proc_block_ms": float(proc_ms.group(1)), "blocks": n_win,
            "profile_whole_blocks": len(whole),
            "profile_kernel_events_per_block": len(seen) / blocks_traced,
            "profile_hand_written_per_block": {k: v / blocks_traced for k, v in hand.items()},
            "profile_idle_share": 1 - busy_ms(seen) / (SRV_ALT_PROFILE_S * 1e3),
            "device_ms_per_block": device_ms,
            "captures": [{"captures": st.captures, "capture_ms": capture_ms(st),
                          "pool_mib": st.pool_mib} for st in steps]})
        r = alt["graph" if graph else "eager"][-1]
        log(f"[server alt] {'G' if graph else 'E'} {smi}: {n_win} blocks; host ms a block "
            + ", ".join(f"{k} {v:.3f}" for k, v in r["host_ms"].items())
            + f"; proc_block_ms {r['proc_block_ms']}; first audio after dspcontrol p50 "
            f"{r['first_audio_ms']['p50']:.1f} ms, p95 {r['first_audio_ms']['p95']:.1f} ms "
            f"(banks new to the session); launches a block {SRV_LAUNCHES_PER_BLOCK} (counters), "
            f"the trace's {len(whole)} whole blocks the same; profiler kernel events a "
            f"block {r['profile_kernel_events_per_block']:.1f} (hand-written "
            f"{r['profile_hand_written_per_block']}), idle share {r['profile_idle_share']:.4f}"
            + (f"; device ms a block (replays) {device_ms:.4f}; captures "
               + "; ".join(f"{c['captures']} in {c['capture_ms']:.1f} ms, pool "
                           f"{c['pool_mib']:.1f} MiB" for c in r["captures"])
               if graph else ""))
        del rt
    errors.check("server alternation")
    logging.getLogger("openwebrx_tpu_torch").removeHandler(errors.handler)
    log(f"[server] 7b alternated took {time.perf_counter() - t_alt:.1f} s")
    paths["server"]["alternation"] = alt
    torch.cuda.empty_cache()


def pod_blocks(torch, dev, block):
    """Phase 8's input: POD_BLOCKS seeded blocks of config #5 (noise plus a
    USB tone on each of TONE_CHANNELS), made on the card from a generator of
    their own: every process of the phase makes the same blocks."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(80)
    return seeded_blocks(torch, gen, dev, FS, block, POD_BLOCKS, pod_carriers(), "usb")


def pod_carriers():
    return [float((i - M // 2) * FS / M) for i in TONE_CHANNELS]


def pod_tone_channels():
    """The channels of ``pod_carriers`` (a dense bank's slots)."""
    return [(i - M // 2) % M for i in TONE_CHANNELS]


def pod_bank(dev, compression):
    """Config #5's USB bank: M channels, every one assigned."""
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank
    bank = ChannelizedBank(FS, M, mode="usb", compression=compression,
                           target_seconds=0.05, device=dev)
    for i in range(M):
        bank.assign(float((i - M // 2) * FS / M))
    return bank


def record_shapes(seen):
    """Wrap the kernels' wrappers where the stages call them (through their
    modules), each adding the shapes it is handed to its set in ``seen``
    (keys agc, squelch, adpcm, seq, iir and fold; the AGC's profile by
    name) → a function that unwraps them."""
    from openwebrx_tpu_torch.ops import adpcm, agc, channelizer, iir, squelch
    saved = (agc.agc_apply, squelch.squelch_apply, adpcm.adpcm_encode,
             adpcm.adpcm_encode_seq, iir.first_order_apply, channelizer.polyphase_fold)
    agc_apply, squelch_apply, adpcm_encode, adpcm_encode_seq, first_order_apply, fold = saved
    names = {id(agc.SLOW): "SLOW", id(agc.FAST): "FAST"}

    def agc_recorded(state, profile, x, chunk=agc.CHUNK, device="cuda"):
        seen["agc"].add((names[id(profile)], tuple(x.shape), chunk))
        return agc_apply(state, profile, x, chunk, device=device)

    def squelch_recorded(state, level_db, x, window, hang_windows=2):
        seen["squelch"].add((tuple(x.shape), window))
        return squelch_apply(state, level_db, x, window, hang_windows)

    def adpcm_recorded(state, x):
        seen["adpcm"].add(tuple(x.shape))
        return adpcm_encode(state, x)

    def seq_recorded(state, x):
        seen["seq"].add(tuple(x.shape))
        return adpcm_encode_seq(state, x)

    def iir_recorded(state, b0, b1, a1, x, device="cuda"):
        seen["iir"].add(tuple(x.shape))
        return first_order_apply(state, b0, b1, a1, x, device=device)

    def fold_recorded(u, bank_t, p_taps, device="cuda"):
        seen["fold"].add(tuple(u.shape))
        return fold(u, bank_t, p_taps, device=device)

    (agc.agc_apply, squelch.squelch_apply, adpcm.adpcm_encode, adpcm.adpcm_encode_seq,
     iir.first_order_apply, channelizer.polyphase_fold) = (
        agc_recorded, squelch_recorded, adpcm_recorded, seq_recorded, iir_recorded,
        fold_recorded)

    def restore():
        (agc.agc_apply, squelch.squelch_apply, adpcm.adpcm_encode, adpcm.adpcm_encode_seq,
         iir.first_order_apply, channelizer.polyphase_fold) = saved
    return restore


def shape_record():
    return {k: set() for k in ("agc", "squelch", "adpcm", "seq", "iir", "fold")}


def pod_worker(rank, world, port, out_dir, backend) -> int:
    """Phase 8b's rank ``rank`` of ``world`` (``chip_smoke.py --pod-worker
    RANK WORLD PORT DIR BACKEND``): joins the cluster, feeds its slab of
    every block to a ``DistributedReceiver`` over config #5's bank (int16
    audio), times the collectives, writes its channels' audio to
    DIR/rank<R>.npy and prints one JSON line for the parent."""
    import torch
    import torch.distributed as dist
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.parallel import cluster as pcluster

    rank, world = int(rank), int(world)
    dev = pcluster.rank_device("cuda", rank)        # card rank % cards
    cluster = pcluster.init_cluster(f"127.0.0.1:{port}", world, rank,
                                    timeout=POD_TIMEOUT_S, device=dev, backend=backend)
    try:
        seen = shape_record()
        restore = record_shapes(seen)
        rx = pcluster.DistributedReceiver(pod_bank(dev, "none"), cluster, device=dev)
        slabs = [b[rank * rx.slab:(rank + 1) * rx.slab].contiguous()
                 for b in pod_blocks(torch, dev, rx.bank.block)]
        results, wall, launches, peak = drive(
            f"pod{world} rank {rank}", lambda x: (rx.dispatch_local(x),),
            rx.complete_local, slabs, kernels, torch, dev)
        restore()
        rep = report(f"pod{world} rank {rank}", nvidia_smi(), wall,
                     POD_BLOCKS - WARMUP_BLOCKS, rx.bank.block, FS, peak)
        coll_ms = rx.time_collectives() * 1e3
        reshard_ms = rx.time_reshard() * 1e3
        np.save(Path(out_dir) / f"rank{rank}.npy",
                np.concatenate([y for _, y, _ in results], axis=-1))
        print(json.dumps({
            "pod_rank": rank, "channels": [int(rx.channels[0]), int(rx.channels[-1]) + 1],
            "checksums": [c for _, _, c in results], "launches": launches,
            "device": str(dev), "backend": dist.get_backend(), "collective_ms": coll_ms,
            "reshard_ms": reshard_ms, **rep,
            "shapes": {k: sorted(map(repr, v)) for k, v in seen.items()}}),
            flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def pod_one_rank(torch, dev, smi, paths, launches_by_path):
    """Phase 8a: config #5's bank at world size 1 over NCCL in this process,
    through ``DistributedReceiver`` (ADPCM) against the plain bank, bytes
    and stride states identical, and through ``shard_channelized_bank``;
    adds the path's report and launches."""
    from datetime import timedelta

    import torch.distributed as dist
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.ops import adpcm
    from openwebrx_tpu_torch.parallel.cluster import DistributedReceiver, init_cluster
    from openwebrx_tpu_torch.parallel.pod import gather_channels, shard_channelized_bank

    n_timed = POD_BLOCKS - WARMUP_BLOCKS
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=POD_TIMEOUT_S))
    try:
        cluster = init_cluster(num_processes=1, device=dev)
        check(cluster == type(cluster)(0, 1, 1, 1), f"pod1: cluster {cluster}")
        rx = DistributedReceiver(pod_bank(dev, "adpcm"), cluster, device=dev)
        blocks = pod_blocks(torch, dev, rx.bank.block)
        check(rx.slab == rx.bank.block and list(rx.channels) == list(range(M)),
              f"pod1: slab {rx.slab}, channels {rx.channels[:3]}..")
        results, wall, launches, peak = drive(
            "pod1", lambda x: (rx.dispatch_local(x),), rx.complete_local, blocks,
            kernels, torch, dev)
        launches_by_path["pod1"] = launches
        check_launches("pod1", launches, {k: v * POD_BLOCKS for k, v in launches_per_block(
            fold=1, adpcm_=1, agc_=1, squelch_=1).items()})
        paths["pod1"] = report("pod1", smi, wall, n_timed, rx.bank.block, FS, peak)
        plain = pod_bank(dev, "adpcm")
        plain_out, plain_wall, _, _ = drive("pod1 plain bank", plain.dispatch,
                                            plain.fetch, blocks, kernels, torch, dev)
        paths["pod1"]["plain_ms_per_block"] = plain_wall / n_timed * 1e3
        same = all(np.array_equal(r[1][0], p[0][0]) and np.array_equal(r[1][1], p[0][1])
                   for r, p in zip(results, plain_out))
        log(f"[pod1] DistributedReceiver vs the plain ChannelizedBank, "
            f"{POD_BLOCKS} blocks: ADPCM bytes and stride states identical = {same}")
        check(same, "pod1: DistributedReceiver differs from the plain bank")
        sbank = pod_bank(dev, "adpcm")
        run, state = shard_channelized_bank(sbank, rx.mesh)
        same = True
        for x, (py, _) in zip(blocks, plain_out):
            state, y, _ = run(state, x)
            g = [t.cpu().numpy() for t in gather_channels(y, rx.mesh)]
            same = same and np.array_equal(g[0], py[0]) and np.array_equal(g[1], py[1])
        log(f"[pod1] shard_channelized_bank + gather_channels vs the plain bank: "
            f"identical = {same}")
        check(same, "pod1: shard_channelized_bank differs from the plain bank")
        for k in pod_tone_channels():
            audio = decode_channel([(y[0][k], y[1][k]) for _, y, _ in results], adpcm)
            snr = tone_snr(audio[len(audio) // 2:].astype(np.float32) / 32767,
                           TONE_AUDIO_HZ, 12000.0)
            log(f"[pod1] slot {k}: USB tone SNR {snr:.1f} dB (minimum {TONE_SNR_MIN_DB})")
            check(snr > TONE_SNR_MIN_DB, f"pod1: channel {k} tone SNR {snr:.1f} dB")
        coll_ms, reshard_ms = rx.time_collectives() * 1e3, rx.time_reshard() * 1e3
        paths["pod1"].update(collective_ms=coll_ms, reshard_ms=reshard_ms,
                             transport="nccl, world size 1")
        log(f"[pod1] {smi}: {paths['pod1']['ms_per_block']:.3f} ms/block through "
            f"DistributedReceiver, {paths['pod1']['plain_ms_per_block']:.3f} through "
            f"the plain bank; collectives alone {coll_ms:.5f} ms a step, the "
            f"re-shard alone {reshard_ms:.5f} ms (NCCL at world size 1: no link, "
            f"the collectives copy within the card)")
        del rx, plain, sbank, run, state, results, plain_out, blocks
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def pod_ranks(torch, dev, smi, paths, launches_by_path, seen, world=POD_RANKS):
    """Phase 8b: ``world`` worker processes (``chip_smoke.py --pod-worker``;
    on fewer cards than ranks all on this card over gloo through host
    memory, else NCCL, a card each), each fed only its slab of config #5's
    blocks, against one bank here: every channel owned once, the ranks'
    checksums equal, the gathered audio within POD_AUDIO_LSB, tones, each
    rank's launches and shapes.  Adds the path's report and launches (summed
    over the ranks), and the workers' AGC and squelch shapes to ``seen``."""
    from openwebrx_tpu_torch import kernels

    n_timed = POD_BLOCKS - WARMUP_BLOCKS
    single = pod_bank(dev, "none")
    blocks = pod_blocks(torch, dev, single.block)
    single_out, single_wall, _, _ = drive("pod single bank", single.dispatch,
                                          single.fetch, blocks, kernels, torch, dev)
    ref = np.concatenate([y for y, _ in single_out], axis=-1)
    ref_checks = [float(np.abs(y.astype(np.float64)).sum()) for y, _ in single_out]
    del single, single_out, blocks
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    nccl = cards >= world
    backend = "nccl" if nccl else "gloo"
    transport = ("NCCL, one rank per card" if nccl else
                 f"gloo through host memory: {cards} card(s) for {world} ranks; "
                 "NCCL takes one rank per card")
    out_dir = ROOT / "build" / "pod"
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--pod-worker", str(r),
         str(world), str(port), str(out_dir), backend], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(1.0, POD_TIMEOUT_S - (time.perf_counter() - t0)))
            for line in out.splitlines():
                if not line.startswith("{"):
                    log(f"[pod{world} worker {r}] {line}")
            check(p.returncode == 0, f"pod{world}: worker {r} exited "
                  f"{p.returncode}: {err[-3000:]}")
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith('{"pod_rank"')][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    label = f"pod{world}"
    owned = sorted(c for o in outs for c in range(*o["channels"]))
    check(owned == list(range(M)), f"{label}: channels owned {owned[:4]}.. of {M}")
    check(all(o["checksums"] == outs[0]["checksums"] for o in outs),
          f"{label}: the ranks' checksums differ")
    rel = max(abs(a - b) / b for a, b in zip(outs[0]["checksums"], ref_checks))
    check(rel <= 1e-3, f"{label}: checksum {rel:.2e} off the single bank's")
    got = np.concatenate([np.load(out_dir / f"rank{o['pod_rank']}.npy")
                          for o in sorted(outs, key=lambda o: o["channels"][0])])
    check(got.shape == ref.shape and got.dtype == np.int16,
          f"{label}: audio {got.shape} {got.dtype}, single bank {ref.shape}")
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    log(f"[{label}] gathered int16 audio vs the single bank on the card: max diff "
        f"{int(diff.max())} LSB (tolerance {POD_AUDIO_LSB}), mean {diff.mean():.5f}; "
        f"checksums equal on every rank, {rel:.2e} off the single bank's")
    check(diff.max() <= POD_AUDIO_LSB, f"{label}: audio differs from the single bank")
    for k in pod_tone_channels():
        snr = tone_snr(got[k, got.shape[1] // 2:].astype(np.float32) / 32767,
                       TONE_AUDIO_HZ, 12000.0)
        log(f"[{label}] channel {k}: USB tone SNR {snr:.1f} dB (minimum {TONE_SNR_MIN_DB})")
        check(snr > TONE_SNR_MIN_DB, f"{label}: channel {k} tone SNR {snr:.1f} dB")
    for o in outs:
        check_launches(f"{label} rank {o['pod_rank']}", o["launches"],
                       {k: v * POD_BLOCKS for k, v in launches_per_block(
                           fold=1, agc_=1, squelch_=1).items()})
        sh = {k: {ast.literal_eval(v) for v in vs} for k, vs in o["shapes"].items()}
        check(sh["fold"] == {(2400 // world + 15, M)}
              and not (sh["adpcm"] or sh["seq"] or sh["iir"]),
              f"{label}: shapes {sh}")
        seen["agc"] |= sh["agc"]
        seen["squelch"] |= sh["squelch"]
    launches_by_path[label] = {k: sum(o["launches"][k] for o in outs)
                               for k in outs[0]["launches"]}
    paths[label] = {"ms_per_block_by_rank": [o["ms_per_block"] for o in outs],
                    "single_ms_per_block": single_wall / n_timed * 1e3,
                    "collective_ms_by_rank": [o["collective_ms"] for o in outs],
                    "reshard_ms_by_rank": [o["reshard_ms"] for o in outs],
                    "peak_mib_by_rank": [o["peak_mib"] for o in outs],
                    "transport": transport, "backend": backend}
    log(f"[{label}] {smi}: {world} ranks ({transport}) on "
        f"{sorted({o['device'] for o in outs})}: ms/block "
        f"{[round(o['ms_per_block'], 3) for o in outs]} against "
        f"{paths[label]['single_ms_per_block']:.3f} for the single bank here; "
        f"collectives alone {[round(o['collective_ms'], 5) for o in outs]} ms a step, "
        f"the re-shard alone {[round(o['reshard_ms'], 5) for o in outs]} ms "
        f"({'NCCL over the cards link' if nccl else 'gloo: host copies and TCP on one machine, not NCCL'})")
    log(f"[{label}] took {time.perf_counter() - t0:.1f} s with its workers' start-up")


def main() -> int:
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "tests"))      # torch_graph_scenes, the golden scenes
    from openwebrx_tpu_torch import kernels
    from openwebrx_tpu_torch.models.digital_voice import DV_FACTORY
    from openwebrx_tpu_torch.models.receiver import ClientDemodulatorChain, FftChain
    from openwebrx_tpu_torch.models.secondary import SECONDARY_FACTORY
    from openwebrx_tpu_torch.models.stages import plan_block_size
    from openwebrx_tpu_torch.ops import adpcm, agc, channelizer, iir, squelch
    from openwebrx_tpu_torch.ops.fold import polyphase_fold, polyphase_fold_plain
    from openwebrx_tpu_torch.ops.formats import Format, StreamSpec
    from openwebrx_tpu_torch.runtime.chain import Fanout, Program, tree_map
    from openwebrx_tpu_torch.runtime.channelized import ChannelizedBank

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    device_kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {device_kind} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    # adpcm_short: the ADPCM kernel with shorter strides, timed in phase 6
    adpcm_short = kernels.CudaKernel("adpcm.cu", kernels.ADPCM.symbol,
                                     kernels.ADPCM.argtypes,
                                     defines=(f"ADPCM_STRIDE={SHORT_STRIDE}",))
    # seq_serial: the row encoder with one segment (one lane walks the row),
    # whose slope phase 6 times as the serial nibble step
    seq_serial = kernels.CudaKernel("adpcm_seq.cu", kernels.ADPCM_SEQ.symbol,
                                    kernels.ADPCM_SEQ.argtypes,
                                    defines=("ADPCM_SEQ_SEGMENTS=1", "ADPCM_SEQ_SPAN=1"))
    builds = (*kernels.ALL, adpcm_short, seq_serial)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        secs = list(pool.map(lambda k: k.build(), builds))
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; " + ", ".join(
        f"{k.library_path().name} {s:.1f} s" for k, s in zip(builds, secs)))
    for k in builds:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", k.build_log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", k.build_log))
        log(f"[build] {k.library_path().name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, spill bytes {spills}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # phase 7's shapes draw their inputs from a generator of their own, so
    # every earlier case keeps the inputs it had
    gen_srv = torch.Generator(device=dev)
    gen_srv.manual_seed(7)
    # ... and so do phase 8's
    gen_pod = torch.Generator(device=dev)
    gen_pod.manual_seed(8)

    def gen_for(label):
        return (gen_srv if label.startswith("server")
                else gen_pod if label.startswith("pod") else gen)

    # -- 3. kernels against their plain versions, main-path shapes -----------
    p_taps = 16
    block = 2400 * M                       # channel block 2400 at 48 kHz
    n_time = block // M + p_taps - 1       # rows of u the bank folds
    proto = torch.as_tensor(channelizer.design_prototype(M, p_taps), device=dev)
    bank2 = torch.flip(proto.reshape(p_taps, M), dims=(0, 1)).contiguous()
    u = torch.complex(torch.randn(n_time, M, generator=gen, device=dev),
                      torch.randn(n_time, M, generator=gen, device=dev)) * 0.2
    v_kernel = polyphase_fold(u, bank2, p_taps, device=dev)
    v_plain = polyphase_fold_plain(u, bank2, p_taps)
    torch.cuda.synchronize()
    fold_err = float((v_kernel - v_plain).abs().max())
    fold_tol = FOLD_RTOL * float(v_plain.abs().max())
    log(f"[check] fold u{tuple(u.shape)} -> v{tuple(v_kernel.shape)}: "
        f"max_abs_err {fold_err:.3e} (tolerance {fold_tol:.3e})")
    check(tuple(v_kernel.shape) == (block // M, M), "fold output shape")
    check(fold_err <= fold_tol, f"fold kernel disagrees: {fold_err} > {fold_tol}")

    # ADPCM.  encode_strides (the recurrence on explicit start states) at
    # the bank's 3072 lanes; then the fused adpcm_encode (one launch)
    # against its plain composition on the card at every path's shape, four
    # blocks with the state carried; strides on every boundary of the index
    # estimate; and the card against the all-plain CPU encode
    samples = int16_audio(torch, gen, dev, M, 600)
    lanes_in = samples.reshape(-1, 2 * adpcm.STATE_STRIDE).contiguous()
    prev = torch.randint(-32768, 32767, (lanes_in.shape[0],), generator=gen,
                         device=dev, dtype=torch.int32)
    idxs = torch.randint(0, 89, (lanes_in.shape[0],), generator=gen,
                         device=dev, dtype=torch.int32)
    b_kernel = adpcm.encode_strides(lanes_in, prev, idxs, device=dev)
    b_plain = adpcm.encode_strides_plain(lanes_in, prev, idxs)
    torch.cuda.synchronize()
    adpcm_mismatch = int((b_kernel != b_plain).sum())
    adpcm_err = int((b_kernel.to(torch.int32) - b_plain.to(torch.int32)).abs().max())
    log(f"[check] adpcm encode_strides lanes {tuple(lanes_in.shape)} -> bytes "
        f"{tuple(b_kernel.shape)}: {adpcm_mismatch} bytes differ (must be 0)")
    check(adpcm_mismatch == 0, "ADPCM kernel bytes differ from the plain version")

    adpcm_in = {}                  # label: (state, samples) timed in phase 6

    def adpcm_case(label, state, blocks):
        nonlocal adpcm_err
        kst = pst = state
        for x in blocks:
            kst, (kb, ks) = adpcm.adpcm_encode(kst, x)
            pst, (pb, ps) = adpcm.adpcm_encode_plain(pst, x)
            torch.cuda.synchronize()
            n_bytes = int((kb != pb).sum())
            adpcm_err = max(adpcm_err, int((kb.to(torch.int32)
                                            - pb.to(torch.int32)).abs().max()))
            same = (n_bytes == 0 and torch.equal(ks, ps)
                    and all(torch.equal(a, b) for a, b in zip(kst, pst)))
            check(same, f"adpcm_encode {label} {tuple(x.shape)}: kernel differs "
                  f"from the plain composition ({n_bytes} bytes differ)")
        log(f"[check] adpcm_encode {label} {tuple(blocks[0].shape)} "
            f"({blocks[0].numel() // 200} lanes), {len(blocks)} blocks carried: "
            f"bytes, stride states and state identical")

    for label, shape in ADPCM_PATH_SHAPES.items():
        if label == "nfm":           # the same shape as usb
            adpcm_in[label] = adpcm_in["usb"]
            continue
        state, blocks = adpcm_input(torch, gen_for(label), dev, shape, blocks=4)
        adpcm_case(label, state, blocks)
        adpcm_in[label] = (state, blocks[0])
    # a rank's channels over POD_RANKS ranks (phase 8b runs int16 audio,
    # so no path launches the encoder at this shape)
    state, blocks = adpcm_input(torch, gen_pod, dev, (M // POD_RANKS, 600), blocks=4)
    adpcm_case("pod2 rank", state, blocks)
    edge = torch.as_tensor(boundary_strides(adpcm.IMA_STEP_TABLE,
                                            adpcm.STATE_STRIDE), device=dev)
    adpcm_case("boundary strides", adpcm.adpcm_init((edge.shape[0],), device=dev),
               [edge, torch.flip(edge, dims=(0,)).contiguous()])
    state = adpcm_in["usb"][0]
    st_c, (by_c, sd_c) = adpcm.adpcm_encode(state, samples)
    st_h, (by_h, sd_h) = adpcm.adpcm_encode(tuple(s.cpu() for s in state),
                                            samples.cpu())
    same = (torch.equal(by_c.cpu(), by_h) and torch.equal(sd_c.cpu(), sd_h)
            and all(torch.equal(a.cpu(), b) for a, b in zip(st_c, st_h)))
    log(f"[check] adpcm_encode (1024, 600) card vs CPU: bytes, stride and "
        f"new_state identical = {same}")
    check(same, "adpcm_encode on the card differs from the CPU plain path")

    # the first-order IIR at every path's shape, each with the DC blocker's
    # coefficient (a1 near 1) and the de-emphasis' (a path uses one of
    # them), from random start states: y and y_last within IIR_RTOL of the
    # output scale, x_last identical
    iir_coeffs = {"dc block": iir.dc_block_coeffs(12000.0),
                  "de-emphasis": iir.deemphasis_coeffs(48000.0, 150e-6)}
    iir_in = {}                    # label: (state, x, coefficients) timed in phase 6
    iir_err = 0.0

    def iir_case(label, st, x):
        nonlocal iir_err
        for co_name, co in iir_coeffs.items():
            (ix_k, iy_k), y_k = iir.first_order_apply(st, *co, x, device=dev)
            (ix_p, iy_p), y_p = iir.first_order_apply_plain(st, *co, x)
            torch.cuda.synchronize()
            err = max(float((y_k - y_p).abs().max()), float((iy_k - iy_p).abs().max()))
            tol = IIR_RTOL * float(y_p.abs().max())
            iir_err = max(iir_err, err)
            log(f"[check] iir {label} x{tuple(x.shape)} {co_name} (a1 {co[2]:.6f}): "
                f"max_abs_err {err:.3e} (tolerance {tol:.3e}); x state identical = "
                f"{torch.equal(ix_k, ix_p)}")
            check(err <= tol and torch.equal(ix_k, ix_p),
                  f"IIR kernel disagrees ({label}, {co_name}): {err} > {tol}")

    for label, shape in IIR_PATH_CASES.items():
        st, x = iir_input(torch, gen_for(label), dev, shape)
        iir_case(label, st, x)
        iir_in[label] = (st, x, iir_coeffs["dc block" if label.endswith("am")
                                           else "de-emphasis"])

    # AGC at every path's shape, channel levels spread over 80 dB and random
    # start states; then all-zero rows and silence-to-full-scale steps from
    # the initial state, and rows longer than one shared-memory tile
    agc_cases = {**AGC_PATH_CASES, "long rows": ("FAST", (4, 20000), 50)}
    agc_in = {}                    # label: (profile, state, x, chunk)
    agc_err = 0.0
    for label, (pname, shape, chunk) in agc_cases.items():
        st, x = agc_input(torch, gen_for(label), dev, shape)
        agc_in[label] = (getattr(agc, pname), st, x, chunk)
    step = torch.zeros(8, 2400, device=dev)
    step[2:4, 2200:] = 1.0                         # silence, then full scale
    step[4:6, 600:650] = -1.0                      # a pulse: hang runs out
    step[6:] = torch.randn(2, 2400, generator=gen, device=dev) * 0.01
    agc_in["zeros and steps"] = (agc.FAST, agc.agc_init(agc.FAST, (8,), device=dev),
                                 step, 50)

    def agc_case(label, prof, st, x, chunk):
        nonlocal agc_err
        (g_k, h_k), a_k = agc.agc_apply(st, prof, x, chunk, device=dev)
        (g_p, h_p), a_p = agc.agc_apply_plain(st, prof, x, chunk)
        torch.cuda.synchronize()
        state_same = torch.equal(g_k, g_p) and torch.equal(h_k, h_p)
        err = float((a_k - a_p).abs().max())
        agc_err = max(agc_err, err)
        log(f"[check] agc {label} x{tuple(x.shape)} chunk {chunk}: gain and hang "
            f"identical = {state_same}; audio identical = {torch.equal(a_k, a_p)} "
            f"(max_abs_err {err:.3e})")
        check(state_same, f"AGC kernel gain or hang differs ({label})")
        check(torch.equal(a_k, a_p), f"AGC kernel audio differs ({label})")

    for label, case in agc_in.items():
        agc_case(label, *case)
    (g_s, h_s), _ = agc.agc_apply(agc_in["zeros and steps"][1], agc.FAST, step, 50,
                                  device=dev)
    check(bool((g_s[:2] == agc.FAST.max_gain).all()) and bool((h_s[2:4] > 0).all())
          and bool((h_s[4:6] == 0).all()),
          f"AGC scene: zero rows at max gain, steps armed, pulses run out: "
          f"{g_s.tolist()} {h_s.tolist()}")

    def fold_case(label, m, rows, g):
        """The fold at a path's shape, M = ``m`` channels and ``rows`` output
        rows (the channel block), its input from generator ``g``: the kernel
        against the plain version → (u, bank, plain v)."""
        nonlocal fold_err
        proto_m = torch.as_tensor(channelizer.design_prototype(m, p_taps), device=dev)
        bank_m = torch.flip(proto_m.reshape(p_taps, m), dims=(0, 1)).contiguous()
        u_m = torch.complex(torch.randn(rows + p_taps - 1, m, generator=g, device=dev),
                            torch.randn(rows + p_taps - 1, m, generator=g, device=dev))
        v_m = polyphase_fold(u_m, bank_m, p_taps, device=dev)
        v_m_plain = polyphase_fold_plain(u_m, bank_m, p_taps)
        torch.cuda.synchronize()
        err = float((v_m - v_m_plain).abs().max())
        tol = FOLD_RTOL * float(v_m_plain.abs().max())
        log(f"[check] fold u{tuple(u_m.shape)} ({label}, M={m}): max_abs_err "
            f"{err:.3e} (tolerance {tol:.3e})")
        check(tuple(v_m.shape) == (rows, m) and err <= tol,
              f"fold kernel disagrees at M={m}: {err} > {tol}")
        fold_err = max(fold_err, err)
        return u_m, bank_m, v_m_plain

    # config #2's listener bank: M = 64, a 1875-sample channel block;
    # configs #3 and #6: M = 256 at 8.192 MS/s, 6400; the server's NFM bank
    # (phase 7): M = 128, 12800; a rank's time slice of config #5's block
    # over POD_RANKS ranks (phase 8b): M = 1024, 2400 / POD_RANKS
    u64, bank64, v64_plain = fold_case("config #2", 64, 1875, gen)
    u256, bank256, v256_plain = fold_case("configs #3 and #6", 256, 6400, gen)
    u128, bank128, v128_plain = fold_case("the server's NFM bank", 128, 12800, gen_srv)
    upod, bankpod, vpod_plain = fold_case(
        f"a rank's slice over {POD_RANKS} ranks", M, 2400 // POD_RANKS, gen_pod)

    # squelch at every path's shape (rows over 40 dB, thresholds near them,
    # random start states, a silent and a half-NaN row), on real input, on
    # a row walked in tiles of many windows, and a burst scene from the
    # initial state: power_db within SQUELCH_DB_TOL, NaN where the plain
    # version has NaN; gates, hang and output bit-identical on the rows
    # whose every window lies farther than that from its level
    squelch_in = {}                  # label: (state, level, x, window)
    squelch_err = 0.0

    smem_c = kernels.SQUELCH.function("squelch_smem_bytes", [ctypes.c_int] * 7,
                                      ctypes.c_longlong)

    def squelch_case(label, st, level, x, window, expect=None, rows=None):
        """``rows``: the rows held against the plain version (all of them
        by default)."""
        nonlocal squelch_err
        plan, shape = squelch_plan_of(x, window), tuple(x.shape)
        sk, yk, pk = squelch.squelch_apply(st, level, x, window)
        # a second launch on the same input: the same bits
        sk2, yk2, pk2 = squelch.squelch_apply(st, level, x, window)
        if rows is not None:
            st, level, x = (st[0][rows], st[1][rows]), level[rows], x[rows]
            sk, yk, pk, sk2, yk2, pk2 = (
                (s[0][rows], s[1][rows]) if isinstance(s, tuple) else s[rows]
                for s in (sk, yk, pk, sk2, yk2, pk2))
        sp, yp, pp = squelch.squelch_apply_plain(st, level, x, window)
        torch.cuda.synchronize()
        check(torch.equal(bits(torch, yk), bits(torch, yk2))
              and torch.equal(pk.view(torch.int32), pk2.view(torch.int32))
              and torch.equal(sk[0], sk2[0]) and torch.equal(sk[1], sk2[1]),
              f"squelch kernel: two launches on one input differ ({label})")
        nan_same = torch.equal(pk.isnan(), pp.isnan())
        fin = ~pp.isnan()
        err = float((pk[fin] - pp[fin]).abs().max()) if bool(fin.any()) else 0.0
        squelch_err = max(squelch_err, err)
        lvl = level.expand(pp.shape[:-1])[..., None]
        clear = (((pp - lvl).abs() > SQUELCH_DB_TOL) | pp.isnan()).all(dim=-1)
        same = (torch.equal(bits(torch, yk)[clear], bits(torch, yp)[clear])
                and torch.equal(sk[0][clear], sp[0][clear])
                and torch.equal(sk[1][clear], sp[1][clear]))
        share = float(clear.float().mean())
        cplx = 2 if x.is_complex() else 1
        check(plan.smem == smem_c(x.shape[-1], window, cplx, plan.warps, plan.slice,
                                  plan.chunk, plan.stages),
              f"squelch {label}: ops/squelch.py squelch_smem disagrees with the kernel's "
              f"layout for plan {tuple(plan)}")
        log(f"[check] squelch {label} x{shape} {str(x.dtype)[6:]} window "
            f"{window}, plan {tuple(plan)}: power_db max_abs_err {err:.3e} dB (tolerance "
            f"{SQUELCH_DB_TOL}), NaN where the plain has NaN = {nan_same}; "
            f"{share:.3f} of rows clear of the level, identical there = {same}; "
            f"a second launch bit-identical")
        check(nan_same and err <= SQUELCH_DB_TOL and same and share >= 0.9,
              f"squelch kernel disagrees ({label})")
        if expect is not None:
            check(sk[0].tolist() == expect[0] and sk[1].tolist() == expect[1],
                  f"squelch scene: {sk[0].tolist()} {sk[1].tolist()}")

    for label, (shape, window) in SQUELCH_PATH_CASES.items():
        squelch_in[label] = (*squelch_input(torch, gen_for(label), dev, shape, window),
                             window)
        squelch_case(label, *squelch_in[label])
    squelch_more = {"real": (*squelch_input(torch, gen, dev, (5, 4801), 4801,
                                            torch.float32), 4801),
                    "tiled": (*squelch_input(torch, gen, dev, (3, 40000), 400), 400)}
    for label, case in squelch_more.items():
        squelch_case(label, *case)
    check(not squelch_plan_of(squelch_more["real"][2], 4801).vec,
          "squelch: real (5, 4801) rows must take the 4-byte path")
    # a window straddling two CTAs of a cluster, the last slice shorter
    # than the others; a row past eight CTAs' shared memory (the re-read
    # branch, streamed in chunks, the last one shorter); x at an address
    # 8 bytes off 16 (the 4-byte path on an even row); config #1's 0-dim
    # state with one level (from a generator of their own: the draws of
    # `gen` that later checks see stay as they were)
    gen_sq = torch.Generator(device=dev)
    gen_sq.manual_seed(9)
    st, lv, x = squelch_input(torch, gen_sq, dev, (12, 15000), 5000)
    plan = squelch_plan_of(x, 5000)
    wf = 2 * 5000
    check(plan.cluster > 1 and 15000 * 2 - (plan.cluster - 1) * plan.slice < plan.slice
          and any((c * wf) // plan.slice != ((c + 1) * wf - 1) // plan.slice
                  for c in range(3)), f"squelch straddle case: plan {tuple(plan)}")
    squelch_case("straddle", st, lv, x, 5000)
    st, lv, x = squelch_input(torch, gen_sq, dev, (2, 300000), 30000)
    plan = squelch_plan_of(x, 30000)
    check(plan.reread(300000, 2) and plan.slice % plan.chunk != 0,
          f"squelch re-read case: plan {tuple(plan)}")
    squelch_case("re-read", st, lv, x, 30000)
    st, lv, x = squelch_input(torch, gen_sq, dev, (64, 2400), 800)
    xo = torch.empty(x.numel() * 2 + 2, device=dev)[2:].view(torch.complex64).view(x.shape)
    xo.copy_(x)
    check(not squelch_plan_of(xo, 800).vec, "squelch: unaligned x must take the 4-byte path")
    squelch_case("unaligned x", st, lv, xo, 800)
    st, lv, x = squelch_input(torch, gen_sq, dev, (4800,), 2400)
    check(st[0].dim() == 0, "config #1's squelch state is 0-dim")
    squelch_case("cfg1 one level", st, lv.reshape(()), x, 2400)
    # rows walked in chunks of whole windows, the hang carried from chunk
    # to chunk: one-sample windows (more than shared memory holds); 100000
    # windows a row, which no slices fit; a row too long for slices, in
    # chunks of one 17000-sample window
    for shape, window in (((16, 4800), 1), ((1, 100000), 1), ((1, 17_000_000), 17000)):
        st, lv, x = squelch_bursts(torch, gen_sq, dev, shape, window)
        plan = squelch_plan_of(x, window)
        check(plan.walks(shape[-1], 2), f"squelch {shape}: plan {tuple(plan)} must walk")
        squelch_case(f"walked {shape}", st, lv, x, window)
    del st, lv, x
    # 65540 rows of 32768 floats, 2^31 floats and more in all (64-bit
    # offsets): the first and last four rows against the plain version
    st, lv, x = squelch_input(torch, gen_sq, dev, (65540, 16384), 16384)
    squelch_case("past 2^31 floats", st, lv, x, 16384,
                 rows=torch.tensor([0, 1, 2, 3, 65536, 65537, 65538, 65539], device=dev))
    del st, lv, x
    torch.cuda.empty_cache()
    # the hang carried over three calls, the state fed back, against the
    # plain version's chain: a burst arms it, silence runs it out
    chain_x = torch.zeros(8, 2400, dtype=torch.complex64, device=dev)
    chain_x[4:6, 600:1200] = 1.0
    chain_x[6:8, 1800:2400] = 1.0
    sk = sp = squelch.squelch_init((8,), device=dev)
    lvl = torch.tensor(-20.0, device=dev)
    for i in range(3):
        xi = chain_x if i == 0 else torch.zeros_like(chain_x)
        sk, yk, pk = squelch.squelch_apply(sk, lvl, xi, 600)
        sp, yp, pp = squelch.squelch_apply_plain(sp, lvl, xi, 600)
        check(torch.equal(sk[0], sp[0]) and torch.equal(sk[1], sp[1])
              and torch.equal(bits(torch, yk), bits(torch, yp)),
              f"squelch hang chain, call {i}: {sk[1].tolist()} vs {sp[1].tolist()}")
    log(f"[check] squelch hang over three calls, state fed back: open/hang "
        f"{sk[0].tolist()} {sk[1].tolist()} after the last, as the plain chain")
    # the scene: 4 windows from the initial state, one threshold for all
    # rows; silence and NaN never open, a burst in window 1 holds the gate
    # two windows and runs out, one in window 2 is still held at the end
    scene = torch.zeros(8, 2400, dtype=torch.complex64, device=dev)
    scene[2:4] = float("nan")
    scene[4:6, 600:1200] = 1.0
    scene[6:8, 1200:1800] = 1.0
    squelch_case("scene", squelch.squelch_init((8,), device=dev),
                 torch.tensor(-20.0, device=dev), scene, 600,
                 expect=([False] * 6 + [True] * 2, [0] * 6 + [1] * 2))

    # the exact IMA row encoder: real waterfall rows (config #2's and the
    # 49.152 MS/s one, made by FftChain on the card), a random dB row, audio,
    # 16 rows from random states, full-scale square waves, rows with a tail
    # and short rows; each also with the adversarial test inputs (forced 1:
    # every guess at (-32768, 88); forced 2: no guessed run taken, the sweep
    # encodes the row itself); bytes, stride states and final state identical
    seq_err = 0
    seq_plain = {}

    def seq_case(label, st, x, forced=0):
        nonlocal seq_err
        diag = torch.zeros(x.shape[0], adpcm.SEQ_DIAG_WORDS, dtype=torch.int32,
                           device=dev)
        ks, (kb, kst) = adpcm.encode_seq_kernel(st, x, forced=forced, diag=diag)
        if label not in seq_plain:
            seq_plain[label] = adpcm.adpcm_encode_seq_plain(st, x)
        ps, (pb, pst) = seq_plain[label]
        torch.cuda.synchronize()
        n_bytes = int((kb != pb).sum())
        seq_err = max(seq_err, int((kb.to(torch.int32) - pb.to(torch.int32)).abs().max()))
        same = (n_bytes == 0 and torch.equal(kst, pst)
                and all(torch.equal(a, b) for a, b in zip(ks, ps)))
        d = diag.max(dim=0).values.tolist()
        log(f"[check] adpcm_encode_seq {label} {tuple(x.shape)} forced {forced}: "
            f"bytes, stride states {tuple(kst.shape)} and final state identical = "
            f"{same} ({n_bytes} bytes differ); most in a row: {d[0]} run ends "
            f"looked up, {d[1]} nibbles encoded by the sweep, first-pass run "
            f"{d[2]} nibbles")
        check(same, f"adpcm_encode_seq kernel differs ({label}, forced {forced})")
        return {"run_ends": d[0], "sweep_nibbles": d[1], "first_pass_nibbles": d[2],
                "cycles_total_setup_pass1_sweep_output": d[3:]}

    def random_seq_state(rows):
        return (torch.randint(-32768, 32767, (rows,), generator=gen, device=dev,
                              dtype=torch.int32),
                torch.randint(0, 89, (rows,), generator=gen, device=dev,
                              dtype=torch.int32))

    seq_in = {}
    for label in SEQ_REAL_ROWS:
        x = waterfall_row(torch, gen, dev, label)
        seq_in[label] = (adpcm.adpcm_init(tuple(x.shape[:-1]), device=dev), x)
    wf_rows_db = (torch.randn(1, WF_SIZE, generator=gen, device=dev) * 8 - 80)
    wf_rows_db[0, 1000:1004] = -10.0
    wf_samples = adpcm.fft_row_samples(wf_rows_db)
    check(all(tuple(x.shape) == (1, SEQ_ROW) for x in
              (wf_samples, seq_in["cfg2 row"][1], seq_in["wf row"][1]))
          and tuple(seq_in["8.192 rows"][1].shape) == (2, SEQ_ROW),
          f"waterfall rows {wf_samples.shape}")
    seq_in["random dB row"] = (adpcm.adpcm_init((1,), device=dev), wf_samples)
    seq_in["audio"] = (random_seq_state(1), int16_audio(torch, gen, dev, 1, SEQ_ROW))
    seq_in["16 rows"] = (random_seq_state(16), int16_audio(torch, gen, dev, 16, SEQ_ROW))
    t = torch.arange(SEQ_ROW, device=dev)
    square = torch.stack([torch.where((t // per) % 2 == 0, 32767, -32768)
                          for per in (1, 2, 7, 64)]).to(torch.int16)
    seq_in["square"] = (random_seq_state(4), square)
    seq_in["short row"] = (random_seq_state(1), int16_audio(torch, gen, dev, 1, SEQ_SHORT_ROW))
    seq_in["tail"] = (random_seq_state(3), int16_audio(torch, gen, dev, 3, 2058))
    seq_in["400 x 40"] = (random_seq_state(40), int16_audio(torch, gen, dev, 40, 400))
    seq_in["6"] = (random_seq_state(2), int16_audio(torch, gen, dev, 2, 6))
    seq_diag = {}
    for forced in (0, 1, 2):
        for label, (st, x) in seq_in.items():
            seq_diag[(label, forced)] = seq_case(label, st, x, forced)
    rows_host = wf_rows_db.cpu().numpy()
    card_wire = adpcm.compress_fft_rows(wf_rows_db, device=dev)
    check(card_wire == adpcm.compress_fft_rows(rows_host, device="cpu")
          and len(card_wire[0]) == adpcm.wire_bytes_per_row(WF_SIZE),
          "compress_fft_rows on the card differs from the CPU")
    log("[check] compress_fft_rows (1, 4096) card vs CPU: wire bytes identical")

    # -- 4. small banks on the card against the CPU plain path ---------------
    # Every mode; usb and am are compared from block 0 on.  In the other
    # modes the card bank takes the CPU bank's state after block 0, whose
    # difference is only logged: at stream start the FFT bandpass's outputs
    # are ~1e-7 with ~1e-8 of absolute rounding noise, so the FM
    # discriminator's first samples are noise in any two float32
    # implementations, and an AGC without a DC blocker (rawam) or a carrier
    # estimate (sam) turns that noise into different startup gains
    small_modes = {                  # mode: (fs, m, capacity, audio_rate)
        "usb": (3.072e6, 64, None, 12000.0), "nfm": (3.072e6, 64, None, 12000.0),
        "am": (3.072e6, 64, None, 12000.0), "rawam": (3.072e6, 64, None, 12000.0),
        "sam": (3.072e6, 64, None, 12000.0), "wfm": (24.576e6, 64, 2, 48000.0)}
    carrier_slots = (5, 20, 40)
    for mode, (sfs, sm, scap, srate) in small_modes.items():
        dial_idx = range(sm) if scap is None else (20, 40)
        banks = {}
        for where in ("cpu", "cuda"):
            sb = ChannelizedBank(sfs, sm, mode=mode, compression="none",
                                 target_seconds=0.05, capacity=scap,
                                 audio_rate=srate, device=where)
            for i in dial_idx:
                sb.assign(float((i - sm // 2) * sfs / sm))
            banks[where] = sb
        carriers = [float((i - sm // 2) * sfs / sm)
                    for i in (carrier_slots if scap is None else (20, 40))]
        if mode == "usb":            # as in earlier runs: noise only
            carriers = []
        kind_of = {"usb": "usb", "nfm": "nfm", "wfm": "wfm"}.get(mode, "am")
        blocks = seeded_blocks(torch, gen, dev, sfs, banks["cpu"].block, 4,
                               carriers, kind_of, noise=0.1)
        handover = mode not in ("usb", "am")
        outs = {"cpu": [], "cuda": []}
        rds_out = {"cpu": [], "cuda": []}
        for b, x in enumerate(blocks):
            if b == 1 and handover:
                banks["cuda"].state = tree_map(lambda s: s.to(dev),
                                               banks["cpu"].state)
            ys = {}
            for where in ("cpu", "cuda"):
                y, aux = banks[where].process(x if where == "cuda" else x.cpu())
                ys[where] = y
                if b >= (1 if handover else 0):
                    outs[where].append(y)
                if mode == "wfm":
                    rds = aux["wfm.rds_tap.rds"]
                    check(rds.dtype == np.complex64 and np.isfinite(rds).all()
                          and rds.shape == (2, banks[where].channel_block * 250 // 384 // 16),
                          f"small wfm rds aux {rds.shape} {rds.dtype}")
                    if b >= 1:
                        rds_out[where].append(rds)
            if b == 0 and handover:
                d0 = np.abs(ys["cuda"].astype(np.int32) - ys["cpu"].astype(np.int32))
                log(f"[check] small bank {mode}: block 0 (before the state "
                    f"handover) card vs CPU max diff {int(d0.max())} LSB, not checked")
        a = np.concatenate(outs["cuda"], axis=-1).astype(np.float64)
        c = np.concatenate(outs["cpu"], axis=-1).astype(np.float64)
        diff = np.abs(a - c)
        if mode == "sam":
            # the block-wise carrier estimate (atan2 of a sum of rotations)
            # rounds differently at a few samples: rms over carrier channels
            rows = [banks["cpu"].channel_for(f)[0] for f in carriers]
            rms = np.sqrt(np.mean(diff[rows] ** 2, axis=-1))
            log(f"[check] small bank {mode} M={sm}: card vs CPU rms diff on "
                f"carrier channels {np.round(rms, 4).tolist()} LSB (tolerance "
                f"{SAM_RMS_LSB}); max {int(diff.max())} LSB")
            check(rms.max() <= SAM_RMS_LSB, f"small {mode} bank: card and CPU disagree")
        else:
            log(f"[check] small bank {mode} M={sm}{'' if scap is None else f' capacity {scap}'}"
                f": int16 audio card vs CPU max diff {int(diff.max())} LSB "
                f"(tolerance {SMALL_BANK_LSB}), mean {diff.mean():.4f}")
            check(diff.max() <= SMALL_BANK_LSB, f"small {mode} bank: card and CPU disagree")
        if mode == "wfm":
            # the RDS baseband (57 kHz mix, 16-fold FIR decimation) on the
            # card against the CPU, as the CPU tests hold it against JAX
            rc = np.concatenate(rds_out["cpu"], axis=-1)
            rds_err = float(np.abs(np.concatenate(rds_out["cuda"], axis=-1) - rc).max())
            rds_tol = RDS_RTOL * float(np.abs(rc).max())
            log(f"[check] small bank wfm rds aux card vs CPU: max_abs_err "
                f"{rds_err:.3e} (tolerance {rds_tol:.3e})")
            check(rds_err <= rds_tol, "small wfm bank: card and CPU rds disagree")

    # the waterfall at config #2's shapes (2.4 MS/s, 0.05 s blocks, 4096
    # bins): float rows card vs CPU near the peak; the card's compressed
    # rows are the CPU encoding of the card's own float rows (identical
    # int16 input is the only fair bit-for-bit comparison)
    spec24 = StreamSpec(Format.COMPLEX_FLOAT, CFG2_FS)
    wf_blocks = seeded_blocks(torch, gen, dev, CFG2_FS, 120000, 2,
                              [CFG2_LISTENER, CFG2_EDGE], "usb", noise=0.05)
    wf_progs = {(where, comp): Program(FftChain(WF_SIZE, 20.0, compress=comp),
                                       spec24, 120000, device=where)
                for where in ("cpu", dev) for comp in (False, True)}
    wf_err = 0.0
    for x in wf_blocks:
        out = {k: p.process(x if k[0] == dev else x.cpu())[0]
               for k, p in wf_progs.items()}
        wf_err = max(wf_err, near_peak_err(out[(dev, False)], out[("cpu", False)]))
        raw = out[(dev, True)]
        nb = adpcm.wire_bytes_per_row(WF_SIZE)
        check(raw.shape == (1, SEQ_ROW // 2) and raw.dtype == np.uint8,
              f"compressed waterfall rows {raw.shape} {raw.dtype}")
        check([raw[0, :nb].tobytes()]
              == adpcm.compress_fft_rows(out[(dev, False)], device="cpu"),
              "compressed waterfall rows are not the encoding of the float rows")
    log(f"[check] FftChain(4096, 20) at 2.4 MS/s, 2 blocks: float rows card vs "
        f"CPU max diff {wf_err:.2e} dB within {NEAR_PEAK_DB:.0f} dB of the peak "
        f"(tolerance {WF_DB_TOL}); compressed rows = the encoding of the "
        f"card's float rows")
    check(wf_err <= WF_DB_TOL, "waterfall rows card vs CPU disagree")

    # every secondary and digital-voice chain, two channels, the card
    # against the CPU on the same blocks: an FM-wobbled carrier in each
    # channel's passband plus noise.  The card takes the CPU's state after
    # block 0 (FM discriminators see the filters' start-up ramp there,
    # whose rounding differs), block 1 is compared
    centre = {"fax": 1900.0, "sstv": 1900.0, "cwskimmer": 2000.0}
    wobble = {"fax": 300.0, "sstv": 300.0, "rtty450": 150.0}
    chain_cases = ([(k, 48000.0, f) for k, f in SECONDARY_FACTORY.items()]
                   + [(k, 240000.0, f) for k, f in DV_FACTORY.items()])
    chain_err = {}
    for name, cfs, make in chain_cases:
        offsets = np.array([-3000.0, 5000.0])
        progs = {}
        for where in ("cpu", dev):
            c = make(cfs)
            c.selector.shift.set_rate(-offsets / cfs)
            cspec = StreamSpec(Format.COMPLEX_FLOAT, cfs)
            progs[where] = Program(c, cspec, plan_block_size(c, cspec, 0.1),
                                   batch_shape=(2,), device=where)
        blk = progs["cpu"].block
        n = np.arange(2 * blk) / cfs
        dev_hz = wobble.get(name, 1500.0 if cfs > 48000.0 else 10.0)
        rng = np.random.default_rng(len(name))
        sig = sum(0.4 * np.exp(2j * np.pi * (o + centre.get(name, 0.0)) * n
                               + 1j * (dev_hz / 7.0) * np.sin(2 * np.pi * 7.0 * n))
                  for o in offsets)
        sig = (sig + 0.02 * (rng.standard_normal(len(n))
                             + 1j * rng.standard_normal(len(n)))).astype(np.complex64)
        for b in range(2):
            if b == 1:
                progs[dev].state = tree_map(lambda t: t.to(dev), progs["cpu"].state)
            x = sig[b * blk:(b + 1) * blk]
            (yc, ac), (yd, ad) = progs["cpu"].process(x), progs[dev].process(x)
        check(yd.shape == yc.shape and yd.dtype == yc.dtype,
              f"{name}: card y {yd.shape} {yd.dtype}, CPU {yc.shape} {yc.dtype}")
        if yc.dtype == np.uint8:
            agree = float(np.mean(yd == yc))
            chain_err[name] = 1.0 - agree
            ok = agree >= DIBIT_AGREE
        else:
            chain_err[name] = float(np.abs(yd - yc).max() / np.abs(yc).max())
            ok = chain_err[name] <= CHAIN_RTOL
        rows_err = near_peak_err(ad["secondary_fft.rows"], ac["secondary_fft.rows"])
        log(f"[check] {name} chain (2 channels, {blk}-sample blocks at {cfs:.0f} "
            f"S/s), card vs CPU on block 1: y {yd.shape} {yd.dtype}, "
            + (f"dibits differ {chain_err[name]:.4f} (at most {1 - DIBIT_AGREE:.2f})"
               if yc.dtype == np.uint8 else
               f"max diff {chain_err[name]:.2e} of max|y| (tolerance {CHAIN_RTOL})")
            + f"; secondary waterfall {rows_err:.2e} dB near the peak")
        check(ok and rows_err <= WF_DB_TOL, f"{name} chain: card and CPU disagree")

    # a Fanout on the card against its branches run alone on the card
    def fan_parts():
        a = ClientDemodulatorChain(240000.0, 12000.0, "usb", compression="none")
        b = ClientDemodulatorChain(240000.0, 12000.0, "am", compression="none")
        for c in (a, b):
            c.set_frequency_offset(30000.0)
        return {"usb": (a, (4,)), "am": (b, (2,)),
                "fft": (FftChain(1024, fps=1000.0), ())}

    spec240 = StreamSpec(Format.COMPLEX_FLOAT, 240000.0)
    parts = fan_parts()
    fan_prog = Program(Fanout([(k, c) for k, (c, _) in parts.items()],
                              batch_shapes={k: b for k, (_, b) in parts.items()}),
                       spec240, 24000, device=dev)
    solo = {k: Program(c, spec240, 24000, batch_shape=b, device=dev)
            for k, (c, b) in fan_parts().items()}
    fan_blocks = seeded_blocks(torch, gen, dev, 240000.0, 24000, 3, [30000.0], "am")
    fan_audio, fan_rows = 0, 0.0
    for x in fan_blocks:
        yf, af = fan_prog.process(x)
        for k, prog in solo.items():
            ys, as_ = prog.process(x)
            if k == "fft":
                fan_rows = max(fan_rows, near_peak_err(yf[k], ys))
            else:
                fan_audio = max(fan_audio, int(np.abs(yf[k].astype(np.int32)
                                                      - ys.astype(np.int32)).max()))
                check(np.abs(af[f"{k}.selector.squelch.power_db"]
                             - as_["selector.squelch.power_db"]).max() <= SQUELCH_DB_TOL,
                      f"fanout {k}: squelch powers differ from the branch alone")
    log(f"[check] Fanout(usb (4,), am (2,), fft ()) on the card vs each branch "
        f"alone: audio max diff {fan_audio} LSB (tolerance 2), rows "
        f"{fan_rows:.2e} dB")
    check(fan_audio <= 2 and fan_rows <= WF_DB_TOL, "Fanout differs from its branches")

    secondary_bank_check(torch, dev)

    # -- 5. the paths at full width ------------------------------------------
    # record the shapes the paths hand the kernels (the stages call them
    # through their modules)
    seen = shape_record()
    stop_recording = record_shapes(seen)
    paths = {}
    launches_by_path = {}
    alt = {}
    full_width_paths(torch, dev, smi, paths, launches_by_path, alt)
    split = cli_session(smi, paths, adpcm)
    server_paths(torch, dev, smi, paths, launches_by_path)
    pod_one_rank(torch, dev, smi, paths, launches_by_path)
    pod_ranks(torch, dev, smi, paths, launches_by_path, seen)

    stop_recording()
    log("[shapes] on the paths: " + "; ".join(f"{k} {sorted(v)}" for k, v in seen.items()))
    # phase 3 checked exactly these (the fold's path shapes are logged
    # only); an empty record fails here too
    for name, want in (("agc", set(AGC_PATH_CASES.values())),
                       ("adpcm", set(ADPCM_PATH_SHAPES.values())),
                       ("squelch", set(SQUELCH_PATH_CASES.values())),
                       ("seq", ADPCM_SEQ_PATH_SHAPES),
                       ("iir", set(IIR_PATH_CASES.values()))):
        check(seen[name] == want, f"{name} shapes on the paths {seen[name]} are "
              f"not the expected {want}")
    print(json.dumps({"card": smi, "paths": paths}), flush=True)
    print(json.dumps({"card": smi, "graph_alternation": alt}), flush=True)

    # -- 6. kernel timings at the main-path shapes ------------------------------
    iters = 50
    fold_ms = time_cuda(lambda: polyphase_fold(u, bank2, p_taps, device=dev), iters, torch)
    fold_plain_ms = time_cuda(lambda: polyphase_fold_plain(u, bank2, p_taps), iters, torch)
    # yardstick only, never on the port's path: depthwise conv1d over
    # (2, M, T) re/im planes computing the same v
    lhs = torch.view_as_real(u).permute(2, 1, 0).contiguous()     # (2, M, T)
    wconv = bank2.T.contiguous()[:, None, :]                       # (M, 1, P)
    import torch.nn.functional as F
    v_conv = F.conv1d(lhs, wconv, groups=M)
    conv_err = float((torch.complex(v_conv[0], v_conv[1]).T - v_plain).abs().max())
    fold_lib_ms = time_cuda(lambda: F.conv1d(lhs, wconv, groups=M), iters, torch)

    def conv_fold(u_, bank_, v_):
        """The same yardstick at another path's shape → (ms, max diff)."""
        lhs_ = torch.view_as_real(u_).permute(2, 1, 0).contiguous()
        w_ = bank_.T.contiguous()[:, None, :]
        m_ = u_.shape[1]
        err = float((torch.complex(*F.conv1d(lhs_, w_, groups=m_)).T - v_).abs().max())
        return time_cuda(lambda: F.conv1d(lhs_, w_, groups=m_), iters, torch), err

    fold_lib = {"cfg2 (1890, 64)": conv_fold(u64, bank64, v64_plain),
                "cfg3/cfg6 (6415, 256)": conv_fold(u256, bank256, v256_plain),
                "server nfm (12815, 128)": conv_fold(u128, bank128, v128_plain),
                f"pod{POD_RANKS} rank {tuple(upod.shape)}": conv_fold(upod, bankpod,
                                                                  vpod_plain)}
    iir_st, iir_x, deemph = iir_in["nfm"]
    iir_ms = time_cuda(lambda: iir.first_order_apply(iir_st, *deemph, iir_x, device=dev),
                       iters, torch)
    iir_plain_ms = time_cuda(lambda: iir.first_order_apply_plain(iir_st, *deemph, iir_x),
                             iters, torch)
    fold_bytes = u.numel() * 8 + bank2.numel() * 4 + v_plain.numel() * 8
    fold_ops = 4 * p_taps * v_plain.numel()        # re+im: P mul-adds each

    def iir_bytes_ops(x):
        """x in, y out, four (rows,) state vectors; per sample 2 mul + 1 add
        for c[n] and one multiply-add for y[n]"""
        return x.numel() * 8 + 4 * 4 * (x.numel() // x.shape[-1]), 5 * x.numel()

    iir_bytes, iir_ops = iir_bytes_ops(iir_x)

    def bound(nbytes, nops, ops_per_s=FP32_OPS_PER_S):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    fold_bound, fold_by = bound(fold_bytes, fold_ops)
    iir_bound, iir_by = bound(iir_bytes, iir_ops)
    log(f"[time] {smi}: fold kernel {fold_ms:.5f} ms, bound {fold_bound:.5f} ms "
        f"({fold_by}: {fold_bytes} B, {fold_ops} flop), plain {fold_plain_ms:.5f} ms, "
        f"depthwise F.conv1d {fold_lib_ms:.5f} ms (max diff {conv_err:.2e}); "
        + "; ".join(f"at {k} depthwise F.conv1d {ms:.5f} ms (max diff {e:.2e})"
                    for k, (ms, e) in fold_lib.items()))
    log(f"[time] {smi}: iir kernel {iir_ms:.5f} ms, bound {iir_bound:.5f} ms "
        f"({iir_by}: {iir_bytes} B, {iir_ops} flop), plain {iir_plain_ms:.5f} ms")

    # the two recurrences at every path's shape, warm and cold, beside the
    # roofline bound (bytes or operations) and the time of their serial
    # chain: its time per step, measured below as a slope, times the steps
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_per_s = INT32_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    flush = torch.ones(L2_FLUSH_BYTES // 4, device=dev)

    def timed(label, name, fn, args, nbytes, nops, ops_per_s, chain=None):
        """fn(*args) timed warm, then cold: one copy of args per launch."""
        warm = time_cuda(lambda: fn(*args), iters, torch)
        copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                  for _ in range(COLD_COPIES)]
        cold = time_cuda([lambda c=c: fn(*c) for c in copies], COLD_COPIES,
                         torch, flush)
        del copies
        b, by = bound(nbytes, nops, ops_per_s)
        chain_txt = ("" if chain is None else
                     f", chain {chain:.5f} ms, cold share of the chain {chain / cold:.3f}")
        log(f"[time] {smi}: {name} {label}: warm {warm:.5f} ms, cold {cold:.5f} "
            f"ms; bound {b:.5f} ms ({by}: {nbytes} B, {nops} ops at "
            f"{ops_per_s:.4g}/s); cold share of the bound {b / cold:.3f}{chain_txt}")
        return {"ms": warm, "cold_ms": cold, "bound_ms": b, "bound_by": by,
                "chain_bound_ms": chain}

    # the fold and the IIR cold too: their warm inputs stay in the L2
    fold_row = timed("(2415, 1024)", "fold kernel",
                     lambda u_, b_: polyphase_fold(u_, b_, p_taps, device=dev),
                     (u, bank2), fold_bytes, fold_ops, FP32_OPS_PER_S)
    fold_rows = {}
    for label, (u_, b_, v_) in {
            "cfg2 (1890, 64)": (u64, bank64, v64_plain),
            "cfg3/cfg6 (6415, 256)": (u256, bank256, v256_plain),
            "server nfm (12815, 128)": (u128, bank128, v128_plain),
            f"pod{POD_RANKS} rank {tuple(upod.shape)}": (upod, bankpod, vpod_plain)}.items():
        fold_rows[label] = dict(library_ms=fold_lib[label][0], **timed(
            label, "fold kernel",
            lambda u_, b_: polyphase_fold(u_, b_, p_taps, device=dev), (u_, b_),
            u_.numel() * 8 + b_.numel() * 4 + v_.numel() * 8,
            4 * p_taps * v_.numel(), FP32_OPS_PER_S))
    # the IIR at every path's shape, with that path's coefficients
    iir_rows = {}
    for label, (st, x, co) in iir_in.items():
        iir_rows[label] = dict(shape=list(x.shape), a1=co[2], **timed(
            label, "iir kernel",
            lambda x0, y0, x, co=co: iir.first_order_apply((x0, y0), *co, x, device=dev),
            (*st, x), *iir_bytes_ops(x), FP32_OPS_PER_S))
    iir_row = iir_rows["nfm"]

    # the squelch at every path's shape and on the real and tiled inputs,
    # warm and cold; bound by bytes (x in, y out); no chain to speak of (a
    # few windows a row).  Beside it the yardstick of a plain device copy
    # of x (copy_, cold: each on its own copy after the flush), the least a
    # kernel that reads x and writes y can hope for at these sizes
    squelch_rows = {}
    for label, (st, level, x, window) in {**squelch_in, **squelch_more}.items():
        srcs = [x.clone() for _ in range(COLD_COPIES)]
        dsts = [torch.empty_like(x) for _ in range(COLD_COPIES)]
        copy_ms = time_cuda([lambda i=i: dsts[i].copy_(srcs[i]) for i in range(COLD_COPIES)],
                            COLD_COPIES, torch, flush)
        del srcs, dsts
        squelch_rows[label] = dict(
            shape=list(x.shape), window=window, plan=list(squelch_plan_of(x, window)),
            copy_cold_ms=copy_ms, **timed(
                label, "squelch kernel",
                lambda o, h, lv, x, window=window: squelch.squelch_apply(
                    (o, h), lv, x, window), (*st, level, x),
                squelch_bytes(tuple(x.shape), window, x.is_complex()), 4 * x.numel(),
                FP32_OPS_PER_S))
        log(f"[time] {smi}: squelch {label}: plan {tuple(squelch_plan_of(x, window))}, "
            f"copy_ of x cold {copy_ms:.5f} ms, kernel cold / copy_ "
            f"{squelch_rows[label]['cold_ms'] / copy_ms:.3f}")
    # device kernels a call launches (torch.profiler's kernel records, the
    # hand-written ones included): the plain version against the kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels_launched(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())

    for label, (st, level, x, window) in {**squelch_in, **squelch_more}.items():
        squelch_rows[label]["plain_kernels"] = kernels_launched(
            lambda: squelch.squelch_apply_plain(st, level, x, window))
        before = kernels.SQUELCH.launches
        squelch_rows[label]["kernels"] = kernels_launched(
            lambda: squelch.squelch_apply(st, level, x, window))
        squelch_rows[label]["wrapper_launches"] = kernels.SQUELCH.launches - before
    log(f"[launches] squelch kernels per call, plain -> kernel (profiler kernel events; "
        f"the wrapper's count in brackets): " + ", ".join(
            f"{k} {v['plain_kernels']} -> {v['kernels']} ({v['wrapper_launches']})"
            for k, v in squelch_rows.items()))
    st, level, x, window = squelch_in["nfm"]
    squelch_plain_ms = time_cuda(
        lambda: squelch.squelch_apply_plain(st, level, x, window), 10, torch)
    log(f"[time] {smi}: squelch plain nfm {squelch_plain_ms:.5f} ms")

    # the row encoder.  Its serial nibble step, the one the sweep runs where
    # no candidate holds the truth: a build with one segment walks a row
    # with one lane, checked against the plain version, and the slope
    # between rows of SEQ_SHORT_ROW and SEQ_ROW samples is its time a
    # nibble (a runtime length: one build).  The operations bound counts the
    # SASS instructions a nibble of csrc/adpcm.cu's main loop (the same
    # nibble step) at the int32 issue rate
    def seq_serial_launch(st, x):
        rows_, ns = x.shape
        out = torch.empty(rows_, ns // 2, dtype=torch.uint8, device=dev)
        stride = torch.empty(rows_, ns // 200, dtype=torch.int32, device=dev)
        po, io = (torch.empty(rows_, dtype=torch.int32, device=dev) for _ in range(2))
        seq_serial.launch(dev, x.data_ptr(), st[0].data_ptr(), st[1].data_ptr(),
                          out.data_ptr(), stride.data_ptr(), po.data_ptr(),
                          io.data_ptr(), rows_, ns, 0, None)
        return (po, io), (out, stride)

    st, x = seq_in["audio"]
    ks, (kb, kst) = seq_serial_launch(st, x)
    ps, (pb, pst) = seq_plain["audio"]
    torch.cuda.synchronize()
    check(torch.equal(kb, pb) and torch.equal(kst, pst)
          and all(torch.equal(a, b) for a, b in zip(ks, ps)),
          "the one-segment build of adpcm_seq.cu differs from the plain version")
    seq_one = {}
    for ns in (SEQ_SHORT_ROW, SEQ_ROW):
        st1 = random_seq_state(1)
        x1 = int16_audio(torch, gen, dev, 1, ns)
        seq_one[ns] = time_cuda(lambda: seq_serial_launch(st1, x1), STEP_ITERS, torch)
    seq_step_ms = (seq_one[SEQ_ROW] - seq_one[SEQ_SHORT_ROW]) / (SEQ_ROW - SEQ_SHORT_ROW)
    seq_nibble_instrs = (sass_loop_instructions(kernels.ADPCM.library_path())
                         / ADPCM_LOOP_NIBBLES)
    log(f"[time] {smi}: adpcm_encode_seq serial step (one-segment build, bytes "
        f"identical to the plain version), one row: {SEQ_SHORT_ROW} nibbles "
        f"{seq_one[SEQ_SHORT_ROW]:.5f} ms, {SEQ_ROW} nibbles {seq_one[SEQ_ROW]:.5f} "
        f"ms: {seq_step_ms * 1e6:.3f} ns = {seq_step_ms * clock_mhz * 1e3:.1f} "
        f"cycles a nibble at {clock_mhz:.0f} MHz, {SEQ_ROW} x {seq_step_ms * 1e3:.5f} "
        f"us = {SEQ_ROW * seq_step_ms:.5f} ms serial; {seq_nibble_instrs:.2f} SASS "
        f"instructions a nibble")
    seq_rows = {}
    for label, forced in (("cfg2 row", 0), ("wf row", 0), ("8.192 rows", 0), ("audio", 0),
                          ("16 rows", 0), ("wf row", 1), ("wf row", 2)):
        st, x = seq_in[label]
        rows_, ns = x.shape
        key = f"{label}, forced {forced}" if forced else label
        seq_rows[key] = dict(shape=list(x.shape), forced=forced,
                             **seq_diag[(label, forced)], **timed(
            key, "adpcm_encode_seq kernel",
            lambda p0, i0, x, forced=forced: adpcm.encode_seq_kernel((p0, i0), x, forced),
            (*st, x), seq_bytes(rows_, ns), round(seq_nibble_instrs * x.numel()),
            int32_per_s, seq_step_ms * ns))
    log(f"[time] {smi}: adpcm_encode_seq SM cycles (most in a row, the check's "
        f"launch): total, set-up, first pass, sweep, output: " + "; ".join(
            f"{k} {v['cycles_total_setup_pass1_sweep_output']}" for k, v in seq_rows.items()))
    seq_main = seq_rows["cfg2 row"]
    st, x = seq_in["cfg2 row"]
    seq_plain_ms = time_cuda(lambda: adpcm.adpcm_encode_seq_plain(st, x), 2, torch)
    log(f"[time] {smi}: adpcm_encode_seq plain (1, {SEQ_ROW}) {seq_plain_ms:.5f} ms")

    # the floor of any launch: an empty kernel, back to back
    launch_ms = time_cuda(lambda: torch.cuda._sleep(0), iters, torch)
    log(f"[time] {smi}: empty kernel (torch.cuda._sleep(0)) back to back "
        f"{launch_ms:.5f} ms")

    # AGC chain per chunk: one-row launches of 48 and 96 chunks.  One row's
    # parallel passes spread over a CTA, so the difference is 48 steps of
    # the recurrence plus those passes' small share: an upper estimate
    one_row = {}
    for n in (2400, 4800):
        st1, x1 = agc_input(torch, gen, dev, (n,))
        one_row[n] = time_cuda(lambda: agc.agc_apply(st1, agc.FAST, x1, 50, device=dev),
                               STEP_ITERS, torch)
    agc_step_ms = (one_row[4800] - one_row[2400]) / ((4800 - 2400) // 50)
    log(f"[time] {smi}: agc one row, FAST: 48 chunks {one_row[2400]:.5f} ms, "
        f"96 chunks {one_row[4800]:.5f} ms: {agc_step_ms * 1e3:.5f} us = "
        f"{agc_step_ms * clock_mhz * 1e3:.1f} cycles a chunk at {clock_mhz:.0f} MHz")

    agc_rows = {}
    for label in AGC_PATH_CASES:
        prof, st, x, chunk = agc_in[label]
        agc_rows[label] = dict(shape=list(x.shape), chunk=chunk, **timed(
            label, "agc kernel",
            lambda g, h, x, prof=prof, chunk=chunk: agc.agc_apply(
                (g, h), prof, x, chunk, device=dev), (*st, x),
            agc_bytes(tuple(x.shape)), 6 * x.numel(), FP32_OPS_PER_S,
            agc_step_ms * (x.shape[-1] // chunk)))
    prof, st, x, chunk = agc_in["nfm"]
    agc_plain_ms = time_cuda(lambda: agc.agc_apply_plain(st, prof, x, chunk), 5, torch)
    log(f"[time] {smi}: agc plain nfm {agc_plain_ms:.5f} ms")

    # ADPCM chain per nibble: the recurrence alone (explicit start states)
    # at the bank's 3072 lanes, in lanes of 200 nibbles and, in the short
    # build, of 104.  The slope holds only if both builds compiled the main
    # loop alike, and the short build must compute the plain recurrence
    lanes = lanes_in.shape[0]
    short_in = int16_audio(torch, gen, dev, lanes, 2 * SHORT_STRIDE)
    short_out = torch.empty((lanes, SHORT_STRIDE), dtype=torch.uint8, device=dev)

    def launch_short():
        adpcm_short.launch(dev, short_in.data_ptr(), None, None, prev.data_ptr(),
                           idxs.data_ptr(), short_out.data_ptr(), None, None,
                           None, lanes, 1)

    launch_short()
    check(torch.equal(short_out, adpcm.encode_strides_plain(short_in, prev, idxs)),
          f"ADPCM kernel with {SHORT_STRIDE}-byte strides differs from the plain "
          f"recurrence")
    loop_instrs = sass_loop_instructions(kernels.ADPCM.library_path())
    short_loop = sass_loop_instructions(adpcm_short.library_path())
    check(loop_instrs == short_loop, f"ADPCM builds differ in their main loop: "
          f"{loop_instrs} and {short_loop} instructions")
    short_ms = time_cuda(launch_short, iters, torch)
    strides_ms = time_cuda(
        lambda: adpcm.encode_strides(lanes_in, prev, idxs, device=dev), iters, torch)
    adpcm_step_ms = strides_ms - short_ms
    adpcm_step_ms /= 2 * (adpcm.STATE_STRIDE - SHORT_STRIDE)
    # operations: the instructions the build issues a nibble, counted in its
    # SASS, over the int32 issue rate, and 3 a sample in the estimate
    nibble_instrs = loop_instrs / ADPCM_LOOP_NIBBLES
    log(f"[time] {smi}: adpcm recurrence alone, {lanes} lanes: {2 * SHORT_STRIDE} "
        f"nibbles {short_ms:.5f} ms, 200 nibbles {strides_ms:.5f} ms (bytes "
        f"identical to the plain recurrence; main loop {loop_instrs} SASS "
        f"instructions in both builds, {nibble_instrs:.2f} a nibble): "
        f"{adpcm_step_ms * 1e6:.3f} ns = {adpcm_step_ms * clock_mhz * 1e3:.1f} "
        f"cycles a nibble at {clock_mhz:.0f} MHz")

    adpcm_rows = {}
    for label, shape in ADPCM_PATH_SHAPES.items():
        st, x = adpcm_in[label]
        if label == "nfm":                  # the same shape as usb
            adpcm_rows[label] = adpcm_rows["usb"]
            continue
        nibbles = x.numel()                 # a nibble per sample
        adpcm_rows[label] = dict(shape=list(shape), lanes=nibbles // (2 * adpcm.STATE_STRIDE), **timed(
            label, "adpcm_encode kernel",
            lambda p0, i0, x: adpcm.adpcm_encode((p0, i0), x), (*st, x),
            adpcm_bytes(shape), round(nibble_instrs * nibbles) + 3 * x.numel(),
            int32_per_s, adpcm_step_ms * 2 * adpcm.STATE_STRIDE))
    st, x = adpcm_in["usb"]
    adpcm_plain_ms = time_cuda(lambda: adpcm.adpcm_encode_plain(st, x), 3, torch)
    log(f"[time] {smi}: adpcm_encode plain (1024, 600) {adpcm_plain_ms:.5f} ms")
    agc_main, adpcm_main = agc_rows["nfm"], adpcm_rows["nfm"]

    # -- 9. golden parity on the card, then the card-only tests ----------------
    golden_seen, golden_table = golden_scenes(torch, smi, kernels, launches_by_path)
    # each kernel at the shapes the golden scenes handed it, against its plain
    # version on inputs of its own (outside the counted runs)
    gen_gold = torch.Generator(device=dev)
    gen_gold.manual_seed(9)
    log("[golden] kernel shapes: " + "; ".join(f"{k} {sorted(v)}"
                                               for k, v in golden_seen.items() if v))
    for shape, window in sorted(golden_seen["squelch"]):
        squelch_case("golden", *squelch_input(torch, gen_gold, dev, shape, window), window)
    for pname, shape, chunk in sorted(golden_seen["agc"]):
        agc_case("golden", getattr(agc, pname), *agc_input(torch, gen_gold, dev, shape),
                 chunk)
    for shape in sorted(golden_seen["iir"]):
        iir_case("golden", *iir_input(torch, gen_gold, dev, shape))
    card_counts = card_tests(smi)
    print(json.dumps({"card": smi, "golden": golden_table, "card_tests": card_counts}),
          flush=True)

    def total(name):
        return sum(v[name] for v in launches_by_path.values())

    def by_path(name):
        return {p: v[name] for p, v in launches_by_path.items()}

    line = {"kernels": [
        {"name": "polyphase_fold", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/fold.cu",
         "replaces": "openwebrx_tpu/ops/pallas_fold.py:39",
         "launches": total("fold.cu"), "launches_by_path": by_path("fold.cu"),
         "max_abs_err": fold_err, "ms": fold_ms, "cold_ms": fold_row["cold_ms"],
         "plain_ms": fold_plain_ms, "bound_ms": fold_bound, "bound_by": fold_by,
         "library_ms": fold_lib_ms, "by_shape": fold_rows},
        {"name": "adpcm_encode", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/adpcm.cu",
         "replaces": "openwebrx_tpu/ops/adpcm.py:131",
         "launches": total("adpcm.cu"), "launches_by_path": by_path("adpcm.cu"),
         "max_abs_err": float(adpcm_err), "ms": adpcm_main["ms"],
         "cold_ms": adpcm_main["cold_ms"], "plain_ms": adpcm_plain_ms,
         "bound_ms": adpcm_main["bound_ms"], "bound_by": adpcm_main["bound_by"],
         "chain_bound_ms": adpcm_main["chain_bound_ms"], "library_ms": None,
         "encode_strides_ms": strides_ms, "by_shape": adpcm_rows},
        {"name": "first_order_iir", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/iir.cu",
         "replaces": "openwebrx_tpu/ops/iir.py:18",
         "launches": total("iir.cu"), "launches_by_path": by_path("iir.cu"),
         "max_abs_err": iir_err, "ms": iir_ms, "cold_ms": iir_row["cold_ms"],
         "plain_ms": iir_plain_ms, "bound_ms": iir_bound, "bound_by": iir_by,
         "library_ms": None, "by_shape": iir_rows},
        {"name": "agc_chunked", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/agc.cu",
         "replaces": "openwebrx_tpu/ops/agc.py:58",
         "launches": total("agc.cu"), "launches_by_path": by_path("agc.cu"),
         "max_abs_err": agc_err, "ms": agc_main["ms"],
         "cold_ms": agc_main["cold_ms"], "plain_ms": agc_plain_ms,
         "bound_ms": agc_main["bound_ms"], "bound_by": agc_main["bound_by"],
         "chain_bound_ms": agc_main["chain_bound_ms"], "library_ms": None,
         "by_shape": agc_rows},
        {"name": "squelch_apply", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/squelch.cu",
         "replaces": "openwebrx_tpu/ops/squelch.py:25",
         "launches": total("squelch.cu"), "launches_by_path": by_path("squelch.cu"),
         "max_abs_err": squelch_err, "ms": squelch_rows["nfm"]["ms"],
         "cold_ms": squelch_rows["nfm"]["cold_ms"], "plain_ms": squelch_plain_ms,
         "bound_ms": squelch_rows["nfm"]["bound_ms"],
         "bound_by": squelch_rows["nfm"]["bound_by"], "library_ms": None,
         "by_shape": squelch_rows},
        {"name": "adpcm_encode_seq", "route": "cuda",
         "source": "openwebrx_tpu_torch/csrc/adpcm_seq.cu",
         "replaces": "openwebrx_tpu/ops/adpcm.py:98",
         "launches": total("adpcm_seq.cu"), "launches_by_path": by_path("adpcm_seq.cu"),
         "max_abs_err": float(seq_err), "ms": seq_main["ms"],
         "cold_ms": seq_main["cold_ms"], "plain_ms": seq_plain_ms,
         "bound_ms": seq_main["bound_ms"], "bound_by": seq_main["bound_by"],
         "chain_bound_ms": seq_main["chain_bound_ms"],
         "cycles_per_nibble": seq_step_ms * clock_mhz * 1e3, "library_ms": None,
         "by_shape": seq_rows},
    ]}
    log(f"[smoke] every phase passed in {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"startup_split": split}), flush=True)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def golden_scenes(torch, smi, kernels, launches_by_path):
    """Phase 9a: every scene of tests/test_torch_golden.py (``SCENES``) on
    the CPU port and on the card, each held to its bounds against the
    oracle (host numpy, computed once a scene); every card run with the
    kernel counts set to 0 just before it and read just after must launch
    exactly the scene's kernels → (the shapes the card runs handed the
    kernels, the table of measures)."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_golden as golden
    refs = golden.golden_oracle()
    seen, table = shape_record(), {}
    for name, scene in golden.SCENES.items():
        cpu = {m.what: m for m in scene.run(refs, "cpu")}
        torch.cuda.synchronize()
        for k in kernels.ALL:
            k.launches = 0
        restore = record_shapes(seen)
        try:
            card = scene.run(refs, "cuda")
        finally:
            restore()
        torch.cuda.synchronize()
        launches = {k.source.name: k.launches for k in kernels.ALL}
        launches_by_path[f"golden {name}"] = launches
        for m in card:
            c = cpu.get(m.what)
            log(f"[golden] {smi}: {name}: {m.what}: card {m.value:.4f}, cpu port "
                f"{'n/a' if c is None else f'{c.value:.4f}'}, bound {m.op} {m.bound}")
            table[f"{name}: {m.what}"] = {"card": m.value, "cpu": c and c.value,
                                          "op": m.op, "bound": m.bound}
        log(f"[golden] {name} launches: {launches}")
        missed = [m.what for m in [*card, *cpu.values()] if not m.passed]
        check(not missed, f"golden {name}: bounds missed: {missed}")
        launched = {n for n, v in launches.items() if v}
        check(launched == scene.kernels, f"golden {name}: launched {sorted(launched)}, "
              f"expected {sorted(scene.kernels)}")
    log(f"[golden] phase 9a took {time.perf_counter() - t_phase:.1f} s")
    return seen, table


def card_tests(smi):
    """Phase 9b: the card-only tests (tests/test_torch_card.py, the golden
    scenes' cuda cases and the reference's carried cases) through pytest in
    a fresh interpreter where jax cannot be imported, as on a machine
    without it → the counts, with each carrying file's report under
    ``"reference"``.  Every carrying file must report, every one of its
    card cases must pass, and the carried cases together must launch every
    kernel.  Every line of pytest's output goes to build/card_tests.log."""
    from openwebrx_tpu_torch import kernels
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_ref_device import REPORT_PREFIX
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CARD_TESTS_PRELUDE, *CARD_TESTS_ARGS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=CARD_TESTS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "card_tests.log").write_text(out)
    lines = out.strip().splitlines()
    counts = dict.fromkeys(("passed", "skipped", "failed", "errors", "deselected"), 0)
    for n, word in re.findall(r"(\d+) (passed|skipped|failed|errors?|deselected)",
                              proc.stdout.strip().splitlines()[-1] if proc.stdout.strip()
                              else ""):
        counts["errors" if word.startswith("error") else word] = int(n)
    for line in lines:
        if line.startswith("SKIPPED"):
            log(f"[card tests] {line}")
    refs = [json.loads(line[line.index(REPORT_PREFIX) + len(REPORT_PREFIX):])
            for line in proc.stdout.splitlines() if REPORT_PREFIX in line]
    for r in refs:
        log(f"[card tests] {smi}: reference cases {r['file']}: {r['cuda_passed']} of "
            f"{r['cuda_cases']} passed on the card; launches {r['launches']}; cases "
            f"launching each kernel {r['cases_launching']}")
    ref_files = {a.rsplit("/", 1)[-1] for a in CARD_TESTS_ARGS if "test_torch_ref_" in a}
    launched = {k for r in refs for k, v in r["launches"].items() if v}
    ref_passed = sum(r["cuda_passed"] for r in refs)
    log(f"[card tests] {smi}: passed {counts['passed']} skipped {counts['skipped']} failed "
        f"{counts['failed']} errors {counts['errors']} deselected {counts['deselected']}"
        f" (exit {proc.returncode}, {wall:.1f} s); reference cases {ref_passed} of "
        f"{sum(r['cuda_cases'] for r in refs)} passed, launching {sorted(launched)}")
    ok = (proc.returncode == 0 and counts["passed"] > 0 and not counts["failed"]
          and not counts["errors"])
    if not ok:
        log("\n".join(lines[-80:]))
    check(ok, f"card tests: exit {proc.returncode}, {counts}")
    check({r["file"] for r in refs} == ref_files,
          f"card tests: reference reports from {sorted(r['file'] for r in refs)}, "
          f"expected {sorted(ref_files)}")
    check(all(r["cuda_passed"] == r["cuda_cases"] > 0 for r in refs),
          f"card tests: reference cases not all passed: {refs}")
    check(launched == {k.source.name for k in kernels.ALL},
          f"card tests: the reference cases launched {sorted(launched)} only")
    return {**counts, "seconds": wall, "reference": refs}


def pod_ranks_alone(worlds) -> int:
    """Phase 8b alone at each world size of ``worlds`` (``chip_smoke.py
    --pod-ranks 2 4``), after building the kernels: on a machine with that
    many cards, NCCL over the cards' link."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from openwebrx_tpu_torch import kernels
    smi = nvidia_smi()
    log(f"[card] nvidia-smi: {smi} | {torch.cuda.device_count()} cards | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"[build] {kernels.build_all():.1f} s wall")
    paths, launches = {}, {}
    for world in worlds:
        pod_ranks(torch, torch.device("cuda", 0), smi, paths, launches,
                  shape_record(), world=int(world))
    print(json.dumps({"card": smi, "paths": paths, "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--startup-split"]:
        sys.exit(startup_split(sys.argv[2]))
    if sys.argv[1:2] == ["--first-audio"]:
        sys.exit(first_audio_alone(sys.argv[2:]))
    if sys.argv[1:2] == ["--pod-worker"]:
        sys.exit(pod_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--pod-ranks"]:
        sys.exit(pod_ranks_alone(sys.argv[2:]))
    sys.exit(main())
