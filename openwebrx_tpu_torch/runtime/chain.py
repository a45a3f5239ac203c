"""Stage/Chain/Program: the block-processing chain graph and its runner.

Counterpart of ``digest``, ``Stage``, ``Chain``, ``Fanout``, ``Program``,
the host packing helpers and ``choose_block_size`` in
``openwebrx_tpu/runtime/chain.py``.  A chain is a
description; planning it against an input StreamSpec and block size fixes
every stage's shapes, and ``apply`` runs the stages eagerly on tensors.  A
``Program`` owns one planned chain's streaming state on a device.  All stages act on the last
(time) axis and broadcast over leading channel axes, so one chain serves a
whole bank of channels.

Stage lifecycle:
  plan(in_spec, block)       → (out_spec, out_block)   host-side
  init_state(batch, device)  → tuple of tensors        fresh streaming state
  params(device)             → tuple of tensors        current live controls
  apply(state, params, x)    → (state, y, aux)

State trees have the same structure as the reference's, so a reference
bank's state can be carried over (``openwebrx_tpu_torch/from_jax.py``).
Params are versioned: every live setter bumps its stage's version, and a
Program (so every bank, each of which steps through one) rebuilds (and
uploads) its params only when the chain's aggregate version changed.

The reference compiles a Program's block step once (``jax.jit`` with the
state donated); here ``GraphStep`` is its counterpart.  The step is a
function of buffers that live as long as the program: a static input
block, static params (rewritten in place when a setter moved the params
version) and static state (the step writes the new state into it, as the
donation does).  On a card it is captured once per layout as a CUDA graph
and every later block is one replay; on the CPU, or with ``graph=False``,
the same step runs eagerly over the same buffers.

The reference's tunnel plumbing (complex packing at jit boundaries, the
fused int32 output buffer, the transport keepalive) is not ported: results
come back as the same host objects through pinned asynchronous copies, and
a batch of blocks (``Program.join_pending``) is a list of pending results
behind one event.
"""

from __future__ import annotations

import abc
import contextlib
import gc
import hashlib
import threading
from math import gcd

import numpy as np
import torch

from openwebrx_tpu_torch import kernels, resolve_device
from openwebrx_tpu_torch.core.metrics import SpanLog


def digest(arr) -> str:
    """Short content hash of a numpy array for signatures."""
    a = np.ascontiguousarray(arr)
    return hashlib.sha1(a.tobytes() + str(a.shape).encode()).hexdigest()[:12]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class Stage(abc.ABC):
    """A block-processing stage."""

    name: str = ""
    _pver: int = 0      # params version, bumped by live setters

    @abc.abstractmethod
    def plan(self, in_spec, block: int):
        """Compute static config; return (out_spec, out_block)."""

    def init_state(self, batch_shape, device: torch.device):
        return ()

    def params(self, device: torch.device):
        return ()

    def _bump(self):
        """Mark params dirty (call from every live setter)."""
        self._pver += 1

    def params_version(self) -> int:
        return self._pver

    @abc.abstractmethod
    def apply(self, state, params, x):
        """Returns (new_state, y, aux_dict)."""

    @abc.abstractmethod
    def signature(self) -> tuple:
        """Hashable static identity (post-plan)."""

    @property
    def label(self) -> str:
        return self.name or type(self).__name__


class Chain(Stage):
    """Sequential composite of stages."""

    def __init__(self, workers: list[Stage], name: str = ""):
        self.workers = list(workers)
        self.name = name
        self._planned = False

    # -- graph surgery ----------------------------------------------------
    def replace(self, index: int, stage: Stage):
        self.workers[index] = stage
        self._planned = False
        self._bump()

    def insert(self, index: int, stage: Stage):
        self.workers.insert(index, stage)
        self._planned = False
        self._bump()

    def remove(self, index: int):
        del self.workers[index]
        self._planned = False
        self._bump()

    def append(self, stage: Stage):
        self.workers.append(stage)
        self._planned = False
        self._bump()

    def index_of(self, pred) -> int:
        for i, w in enumerate(self.workers):
            if pred(w):
                return i
        return -1

    # -- Stage interface --------------------------------------------------
    def plan(self, in_spec, block: int):
        spec, blk = in_spec, block
        for w in self.workers:
            spec, blk = w.plan(spec, blk)
        self._planned = True
        return spec, blk

    def init_state(self, batch_shape, device):
        return tuple(w.init_state(batch_shape, device) for w in self.workers)

    def params(self, device):
        return tuple(w.params(device) for w in self.workers)

    def params_version(self) -> int:
        return self._pver + sum(w.params_version() for w in self.workers)

    def apply(self, state, params, x):
        new_state = []
        aux = {}
        for i, w in enumerate(self.workers):
            s, x, a = w.apply(state[i], params[i], x)
            new_state.append(s)
            for k, v in a.items():
                aux[f"{w.label}.{k}"] = v
        return tuple(new_state), x, aux

    def signature(self):
        return ("chain",) + tuple(w.signature() for w in self.workers)


class Fanout(Stage):
    """Parallel branches over the same input block: y = {name: y_branch},
    aux = {"name.key": value}.  Branches may carry different batch shapes
    (e.g. a () waterfall next to a (16,) channel batch) via
    ``batch_shapes``."""

    def __init__(self, branches: list[tuple[str, Stage]],
                 batch_shapes: dict[str, tuple] | None = None,
                 name: str = "fanout"):
        self.branches = list(branches)
        self.batch_shapes = dict(batch_shapes or {})
        self.name = name

    def plan(self, in_spec, block: int):
        for _, b in self.branches:
            b.plan(in_spec, block)
        return in_spec, block

    def init_state(self, batch_shape, device):
        return tuple(b.init_state(self.batch_shapes.get(k, batch_shape), device)
                     for k, b in self.branches)

    def params(self, device):
        return tuple(b.params(device) for _, b in self.branches)

    def params_version(self) -> int:
        return self._pver + sum(b.params_version() for _, b in self.branches)

    def apply(self, state, params, x):
        new_state = []
        ys = {}
        aux = {}
        for i, (k, b) in enumerate(self.branches):
            s, y, a = b.apply(state[i], params[i], x)
            new_state.append(s)
            ys[k] = y
            for kk, vv in a.items():
                aux[f"{k}.{kk}"] = vv
        return tuple(new_state), ys, aux

    def signature(self):
        return ("fanout",) + tuple(
            (k, b.signature(), self.batch_shapes.get(k))
            for k, b in self.branches)


# ------------------------------------------------------------ streaming --
class Pending:
    """One dispatched block's outputs: device tensors, or pinned host
    copies in flight behind ``event``."""

    __slots__ = ("y", "aux", "event")

    def __init__(self, y, aux, event=None):
        self.y, self.aux, self.event = y, aux, event


def pinned_copy(host: np.ndarray, pin: bool = True) -> torch.Tensor:
    """``host`` copied into page-locked memory for a copy to the card: a
    block of PyTorch's caching host allocator (which hands it out again
    only once the copies enqueued from it are done), filled by one thread
    with ``np.copyto``, the interpreter lock released.  ``Tensor.copy_``
    would split a block of millions of elements over the whole intra-op
    OpenMP team, which at real time has slept a block's length between two
    copies, and wait for its last worker.  ``pin=False``: ordinary memory
    (the CPU tests)."""
    staged = torch.empty(host.shape, dtype=torch.from_numpy(host).dtype, pin_memory=pin)
    np.copyto(staged.numpy(), host, casting="no")
    return staged


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def start_fetches(pendings, device: torch.device) -> list[Pending]:
    """On a card, start the copies of several device-side results into
    pinned host memory behind ONE event, without waiting; elsewhere return
    them as they are."""
    if device.type != "cuda":
        return list(pendings)
    event = torch.cuda.Event()
    out = [Pending(*tree_map(_to_host_async, (p.y, p.aux)), event)
           for p in pendings]
    event.record(torch.cuda.current_stream(device))
    return out


def start_fetch(y, aux, device: torch.device, to_host: bool = True) -> Pending:
    """Wrap a step's outputs; with ``to_host`` start their copies into
    pinned host memory now (start_fetches)."""
    pending = Pending(y, aux)
    return start_fetches([pending], device)[0] if to_host else pending


def finish_fetch(pending: Pending):
    """Wait for a dispatched block and return (y, aux) as numpy."""
    if pending.event is not None:
        pending.event.synchronize()
    return tree_map(lambda t: t.cpu().numpy(), (pending.y, pending.aux))


def as_input_block(x, block: int, complex_input: bool,
                   device: torch.device) -> torch.Tensor:
    """A host or device block → a tensor on ``device``: (block,) complex64
    (from complex samples, or packed (block, 2) float32 / int16 / uint8
    pairs) for complex input, (block,) float32 for real input."""
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    if not complex_input:
        if tuple(t.shape) != (block,) or t.is_complex():
            raise ValueError(f"expected {block} real samples, got "
                             f"{tuple(t.shape)} {t.dtype}")
        return t.to(device, torch.float32)
    if t.is_complex():
        if tuple(t.shape) != (block,):
            raise ValueError(f"expected {block} samples, got {tuple(t.shape)}")
        return t.to(device, torch.complex64)
    if tuple(t.shape) != (block, 2):
        raise ValueError(f"expected {block} complex samples (or packed "
                         f"({block}, 2)), got {tuple(t.shape)}")
    t = t.to(device)
    if t.dtype == torch.int16:
        t = t.to(torch.float32) * (1.0 / 32768.0)
    elif t.dtype == torch.uint8:
        t = (t.to(torch.float32) - 127.4) * (1.0 / 128.0)
    elif t.dtype != torch.float32:
        raise ValueError(f"unsupported packed sample dtype {t.dtype}")
    return torch.view_as_complex(t.contiguous())


def host_pack_complex(x: np.ndarray) -> np.ndarray:
    """Host side: complex64 → zero-copy (..., 2) float32 view."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(x.shape + (2,))


def host_as_complex64(block: np.ndarray) -> np.ndarray:
    """Host side: any source block form → complex64 samples: complex64,
    packed (n, 2) float32, or packed (n, 2) int16 (±32768 ↔ ±1.0) or uint8
    (rtl-sdr bias 127.4, ±128) wire samples."""
    if np.iscomplexobj(block):
        return np.ascontiguousarray(block, np.complex64)
    if block.dtype == np.int16:
        f = block.astype(np.float32) * (1.0 / 32768.0)
        return f.view(np.complex64)[..., 0]
    if block.dtype == np.uint8:
        f = (block.astype(np.float32) - 127.4) * (1.0 / 128.0)
        return np.ascontiguousarray(f).view(np.complex64)[..., 0]
    return np.ascontiguousarray(block, np.float32).view(np.complex64)[..., 0]


def host_unpack_complex(v) -> np.ndarray:
    """Host side: (..., 2) float32 → complex64 (zero copy)."""
    a = np.ascontiguousarray(np.asarray(v, dtype=np.float32))
    return a.view(np.complex64)[..., 0]


def tree_leaves(tree) -> list:
    """The leaves of a tree of tuples, lists and dicts, in tree_map order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_layout(tree):
    """What a CUDA graph of a step is specialised to: the tree's structure,
    every tensor leaf's shape, dtype and device, every other leaf's value."""
    if isinstance(tree, (tuple, list)):
        return ("seq",) + tuple(tree_layout(t) for t in tree)
    if isinstance(tree, dict):
        return ("map",) + tuple((k, tree_layout(v)) for k, v in tree.items())
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype, tree.device)
    return ("value", tree)


_gc_lock = threading.Lock()
_gc_pauses = [0, False]          # captures under way, whether gc was on


@contextlib.contextmanager
def _gc_paused():
    """Python's cyclic garbage collector off while any thread captures: a
    collection inside a capture may free another program's CUDA graph,
    whose destruction on the capturing thread invalidates the capture."""
    with _gc_lock:
        if _gc_pauses[0] == 0:
            _gc_pauses[1] = gc.isenabled()
            gc.disable()
        _gc_pauses[0] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pauses[0] -= 1
            if _gc_pauses[0] == 0 and _gc_pauses[1]:
                gc.enable()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _copy_into(static, tree) -> bool:
    """Copy ``tree`` into the static tensors of ``static`` leaf by leaf →
    False, copying nothing, when their layouts differ."""
    if static is None or tree_layout(tree) != tree_layout(static):
        return False
    for dst, src in zip(tree_leaves(static), tree_leaves(tree)):
        if torch.is_tensor(dst) and not _same_view(dst, src):
            dst.copy_(src)
    return True


class GraphStep:
    """A block step ``fn(state, params, x) -> (state, y, aux)`` over
    buffers that live as long as it does: the counterpart of the
    reference's ``jax.jit(step, donate_argnums=(0,))``.

    ``x`` (the input block), ``params`` and ``state`` are static tensors:
    each call copies the block into ``x``, ``set_params`` copies changed
    params into ``params`` and the step writes the new state into
    ``state`` in place.  A leaf whose layout (shape, dtype, the value of a
    non-tensor leaf) changes is replaced instead, which drops the graph.

    With ``capture`` on a card, the first block at a layout runs eagerly on
    a side stream (paying every lazy cost: cuFFT plans, cuDNN algorithms,
    the kernels' shared-memory attributes), the next is captured as a CUDA
    graph in its own memory pool and every block from then on is one
    ``replay()`` on the current stream.  The capture records each kernel's
    launches (``kernels.recording``) and every replay adds them to the
    counts.  A capture or replay failure raises; nothing falls back to the
    eager step, and a step that gives its state a new layout on two blocks
    in a row (which no graph could hold) raises too.  Without ``capture``,
    or on the CPU, the same step runs eagerly over the same buffers.  ``captures`` counts the graphs
    captured and ``replays`` the blocks replayed; the eager first block
    and the capture are ``eager`` and ``capture`` spans in the log of the
    span open on the calling thread (``SpanLog.current``: a runtime's
    dispatch), ``capture_span`` the last capture's (span metric, span
    id); ``pool_mib`` is the device memory its pool reserved."""

    def __init__(self, fn, state, device: torch.device, capture: bool = True):
        self.fn = fn
        self.device = device
        self.capture = bool(capture) and device.type == "cuda"
        self.state = state
        self.params = None
        self.x = None
        self.captures = self.replays = 0
        self.capture_span = None
        self.pool_mib = None
        self._params_src = None
        self._unsettled = False          # the last block changed the state's layout
        # the eager first block and the capture run on a stream of their own
        self._side = torch.cuda.Stream(device) if self.capture else None
        self._drop()

    def _drop(self):
        """Forget the graph: the next block runs eagerly, the one after it
        is captured."""
        self._graph = self._out = None
        self._record = {}
        self._ready = False

    def set_state(self, state):
        """Set the state: copied into the static tensors, or adopted when
        its layout differs."""
        if not _copy_into(self.state, state):
            self.state = state
            self._drop()

    def set_params(self, params):
        """Set the params: nothing when ``params`` is the tree set last,
        else copied into the static tensors, or adopted when the layout
        differs (the first tree is adopted as the static params)."""
        if params is self._params_src:
            return
        if not _copy_into(self.params, params):
            self.params = params
            self._drop()
        self._params_src = params

    def _body(self):
        """One step over the static buffers → (y, aux); the new state is
        written into ``state``; an output that aliases a static buffer is
        copied out first.  Returns whether the state's layout held."""
        new_state, y, aux = self.fn(self.state, self.params, self.x)
        static = {_storage(t) for t in tree_leaves((self.state, self.params, self.x))
                  if torch.is_tensor(t)}
        y, aux = tree_map(lambda t: t.clone() if torch.is_tensor(t)
                          and _storage(t) in static else t, (y, aux))
        if tree_layout(new_state) != tree_layout(self.state):
            self.state = tree_map(
                lambda t: t.clone() if torch.is_tensor(t) else t, new_state)
            return y, aux, False
        held = {_storage(t) for t in tree_leaves(self.state) if torch.is_tensor(t)}
        pairs = [(d, s.clone() if _storage(s) in held else s)
                 for d, s in zip(tree_leaves(self.state), tree_leaves(new_state))
                 if torch.is_tensor(d) and not _same_view(d, s)]
        for dst, src in pairs:
            dst.copy_(src)
        return y, aux, True

    def __call__(self, x: torch.Tensor, own: bool = True):
        """Run one block → (y, aux) on the device.  With ``own`` the
        outputs are the caller's; else a replay's outputs are the graph's
        own tensors, valid until the next call (a copy queued behind the
        replay on the current stream reads them first)."""
        if self.x is None or tree_layout(x) != tree_layout(self.x):
            self.x = torch.empty_like(x)
            self._drop()
        self.x.copy_(x)
        if not self.capture:
            y, aux, same = self._body()
            self._settle(same)
            if not same:
                self._drop()
            return y, aux
        if self._graph is None:
            if not self._ready:
                with SpanLog.current()["eager"]():
                    return self._eager()
            self._capture()
        self._graph.replay()
        self.replays += 1
        kernels.count_replay(self._record)
        if own:
            return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t,
                            self._out)
        return self._out

    def _eager(self):
        """The first block at a layout: eagerly, on the side stream."""
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            y, aux, same = self._body()
        current.wait_stream(self._side)
        # tensors made on the side stream and used on this one
        for t in tree_leaves((y, aux, self.state)):
            if torch.is_tensor(t):
                t.record_stream(current)
        self._settle(same)
        self._ready = same
        return y, aux

    def _settle(self, same: bool):
        """Raise when the step changed its state's layout on this block and
        on the one before: such a step would run eagerly on every block."""
        if not same and self._unsettled:
            raise RuntimeError("the block step gives its state a new layout on "
                               "every block: it cannot be captured")
        self._unsettled = not same

    def _capture(self):
        """Capture the step as a CUDA graph in a pool of its own.  The
        capture is thread-local: other threads may use the card meanwhile;
        the cyclic garbage collector waits until it ends.
        (``torch.cuda.graph`` would also synchronise the device, collect
        garbage and empty the allocator's cache first.)"""
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(self.device)
        with (SpanLog.current()["capture"]() as span, torch.cuda.stream(self._side),
              kernels.recording() as record, _gc_paused()):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                y, aux, same = self._body()
            except BaseException:
                with contextlib.suppress(Exception):   # the step's error is the one to see
                    graph.capture_end()
                raise
            graph.capture_end()
        if not same:
            raise RuntimeError("the step's state layout changed during capture")
        self.capture_span = (span.metric, span.sid)
        self.pool_mib = (torch.cuda.memory_reserved(self.device) - reserved) / 2 ** 20
        self.captures += 1
        self._graph, self._out, self._record = graph, (y, aux), record


class Program:
    """A chain planned against (in_spec, block, batch_shape) on one device:
    owns the streaming state and runs one block per dispatch through its
    ``GraphStep`` (``step``): on a card a CUDA graph replay from the second
    block on; ``graph=False`` keeps the step eager there (to hold the
    replay against it).

    ``params_lock`` is held while a dispatch rebuilds the params; a caller
    that changes several of the chain's parameters from another thread
    holds it across the change, so that no block sees half of it."""

    def __init__(self, chain: Stage, in_spec, block: int, batch_shape=(),
                 device="cuda", graph: bool = True):
        self.device = resolve_device(device)
        self.chain = chain
        self.in_spec = in_spec
        self.block = block
        self.batch_shape = tuple(batch_shape)
        self.graph = graph
        self.out_spec, self.out_block = chain.plan(in_spec, block)
        self._in_complex = bool(in_spec.format.is_complex)
        self.params_lock = threading.RLock()
        self._params_cache = chain.params(self.device)
        self._params_ver = chain.params_version()
        self.params_rebuilds = 0
        self.step = GraphStep(chain.apply,
                              chain.init_state(self.batch_shape, self.device),
                              self.device, capture=graph)
        # structural keys at build time: rebuild() matches the OLD states
        # to the new workers through these, never through post-surgery
        # worker objects (whose states they are not)
        self._state_keys = (
            [(w.label, w.signature()) for w in chain.workers]
            if isinstance(chain, Chain) else [])

    @property
    def state(self):
        """The streaming state (the step's static tensors)."""
        return self.step.state

    @state.setter
    def state(self, state):
        self.step.set_state(state)

    def current_params(self):
        """Current params, rebuilt only when a setter bumped the chain's
        params version."""
        with self.params_lock:
            v = self.chain.params_version()
            if v != self._params_ver:
                self._params_cache = self.chain.params(self.device)
                self._params_ver = v
                self.params_rebuilds += 1
            return self._params_cache

    def params_epoch(self) -> tuple[int, bool]:
        """(params rebuilds so far, whether a change waits for the next)."""
        with self.params_lock:
            return self.params_rebuilds, self.chain.params_version() != self._params_ver

    def pack_input(self, x):
        """Host block → what one upload carries, validated: complex samples
        as packed (block, 2) float32 (a zero-copy view); packed float32,
        int16 or uint8 (block, 2) pairs as they are (they become float on
        the device, ``as_input_block``); real samples as they are."""
        if self._in_complex:
            if (getattr(x, "ndim", 0) >= 2 and x.shape[-1] == 2
                    and x.shape[-2] == self.block
                    and getattr(x, "dtype", None) in (np.float32, np.int16,
                                                      np.uint8)):
                return x
            if x.shape[-1] != self.block:
                raise ValueError(f"Program expects blocks of {self.block} "
                                 f"samples, got {x.shape[-1]}")
            return host_pack_complex(np.asarray(x))
        if x.shape[-1] != self.block:
            raise ValueError(f"Program expects blocks of {self.block} "
                             f"samples, got {x.shape[-1]}")
        return x

    def dispatch(self, x, to_host: bool = True):
        """Enqueue one block → (Pending, None).  With ``to_host`` the
        results' copies into pinned host memory start at once; fetch()
        waits for them."""
        xt = as_input_block(x, self.block, self._in_complex, self.device)
        with self.params_lock:
            self.step.set_params(self.current_params())
        y, aux = self.step(xt, own=not to_host)
        return start_fetch(y, aux, self.device, to_host), None

    def fetch(self, pending: Pending, _unused=None):
        """Wait for a dispatched block and return (y, aux) as numpy."""
        return finish_fetch(pending)

    def process(self, x):
        """One block, synchronous: → (y, aux) as numpy."""
        return self.fetch(*self.dispatch(x))

    def dispatch_quiet(self, x):
        """Enqueue one block without starting its copies to the host → (Pending,
        None), for callers that deliver several blocks at once
        (join_pending)."""
        return self.dispatch(x, to_host=False)

    def join_pending(self, pends):
        """Start the host copies of several dispatch_quiet results behind one
        event → (list of Pending, n) for fetch_many."""
        return start_fetches([p for p, _ in pends], self.device), len(pends)

    def fetch_many(self, joined, n: int):
        """Wait for a join_pending batch → list of n (y, aux), in order."""
        return [finish_fetch(p) for p in joined[:n]]

    def rebuild(self, keep_state: bool = True):
        """Re-plan after graph surgery (e.g. a mode switch), carrying over
        the state of top-level stages whose label and signature still
        match."""
        old = {}
        if keep_state and isinstance(self.chain, Chain):
            old = dict(zip(self._state_keys, self.state))
        rebuilds = self.params_rebuilds
        self.__init__(self.chain, self.in_spec, self.block, self.batch_shape,
                      device=self.device, graph=self.graph)
        self.params_rebuilds = rebuilds + 1
        if old and isinstance(self.chain, Chain):
            self.state = tuple(
                old.get((w.label, w.signature()), s)
                for w, s in zip(self.chain.workers, self.state))


def choose_block_size(in_rate: float, target_seconds: float,
                      *divisors: int) -> int:
    """A block size ≈ target_seconds·in_rate divisible by all divisors."""
    base = 1
    for d in divisors:
        if d > 0:
            base = base * d // gcd(base, d)
    want = max(1, int(round(in_rate * target_seconds / base)))
    return want * base
