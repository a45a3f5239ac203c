"""Stage/Chain: the block-processing chain graph.

Counterpart of ``digest``, ``Stage`` and ``Chain`` in
``openwebrx_tpu/runtime/chain.py``.  A chain is a description; planning it
against an input StreamSpec and block size fixes every stage's shapes, and
``apply`` runs the stages eagerly on tensors.  All stages act on the last
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
bank rebuilds (and uploads) its params only when the chain's aggregate
version changed.
"""

from __future__ import annotations

import abc
import hashlib

import numpy as np
import torch


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
