"""Reactive layered key-value properties.

Behavioral port (not a code port) of the reference's property substrate
(reference ``owrx/property/__init__.py:39-421``): observable dict layers,
priority-resolved stacks with event diffing on layer add/remove/replace,
profile carousels, name filters, validators and read-only views.  This is
the framework's reactive backbone: UI writes → validated layers → wires
fire → live DSP parameter updates.

Semantics preserved exactly (verified by tests/test_property.py, modeled on
the reference's own suite, reference ``test/property/``):

- setting an equal value does not fire
- deletion fires the ``DELETED`` sentinel
- a stack resolves each key through the highest-priority (lowest number)
  layer containing it; writes go to that layer (or the top layer if absent)
- layer add/remove/replace fire only NET visible changes
- a carousel switch fires the diff between the outgoing and incoming layers
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Iterable

logger = logging.getLogger(__name__)


class PropertyError(Exception):
    pass


class _Deleted:
    """Sentinel sent in change events when a key disappears."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __bool__(self):
        return False

    def __repr__(self):
        return "<deleted>"


DELETED = _Deleted()


class Subscription:
    def __init__(self, owner: "Properties", key: str | None, fn: Callable):
        self._owner = owner
        self.key = key
        self.fn = fn

    def cancel(self):
        self._owner.unsubscribe(self)


class Properties:
    """Base observable mapping interface."""

    def __init__(self):
        self._subs: list[Subscription] = []

    # -- mapping protocol (implemented by subclasses) ---------------------
    def get(self, key, default=None):
        return self[key] if key in self else default

    def to_dict(self) -> dict:
        return {k: self[k] for k in self.keys()}

    def keys(self) -> Iterable[str]:
        raise NotImplementedError

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(list(self.keys()))

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return self.to_dict().items()

    # -- events -----------------------------------------------------------
    def subscribe(self, fn: Callable, key: str | None = None) -> Subscription:
        """fn(changes_dict) for key=None; fn(value) for a specific key.
        A keyed subscription fires immediately if the key is present
        (reference wireProperty semantics)."""
        sub = Subscription(self, key, fn)
        self._subs.append(sub)
        if key is not None and key in self:
            try:
                fn(self[key])
            except Exception:
                logger.exception("property subscriber failed on initial fire")
        return sub

    def unsubscribe(self, sub: Subscription):
        if sub in self._subs:
            self._subs.remove(sub)

    def _emit(self, changes: dict):
        if not changes:
            return
        for sub in list(self._subs):
            try:
                if sub.key is None:
                    sub.fn(changes)
                elif sub.key in changes:
                    sub.fn(changes[sub.key])
            except Exception:
                logger.exception("property subscriber failed")

    # -- views ------------------------------------------------------------
    def filtered(self, *names: str) -> "PropertyFilter":
        return PropertyFilter(self, lambda k: k in names)

    def filtered_by(self, predicate: Callable[[str], bool]) -> "PropertyFilter":
        return PropertyFilter(self, predicate)

    def readonly(self) -> "ReadOnlyProperties":
        return ReadOnlyProperties(self)


class PropertyLayer(Properties):
    """A plain observable dict."""

    def __init__(self, **values):
        super().__init__()
        self._data = dict(values)

    def __contains__(self, key):
        return key in self._data

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        if key in self._data and self._data[key] == value:
            return
        self._data[key] = value
        self._emit({key: value})

    def __delitem__(self, key):
        del self._data[key]
        self._emit({key: DELETED})

    def keys(self):
        return self._data.keys()

    def to_dict(self):
        return dict(self._data)


class _View(Properties):
    """Delegating base for filter/readonly/validator views."""

    def __init__(self, source: Properties):
        super().__init__()
        self.source = source
        self._upstream = source.subscribe(self._on_change)

    def _on_change(self, changes: dict):
        self._emit(changes)

    def __contains__(self, key):
        return key in self.source

    def __getitem__(self, key):
        return self.source[key]

    def __setitem__(self, key, value):
        self.source[key] = value

    def __delitem__(self, key):
        del self.source[key]

    def keys(self):
        return self.source.keys()


class PropertyFilter(_View):
    """Exposes only keys passing the predicate (reference PropertyFilter +
    ByPropertyName/ByLambda, ``owrx/property/filter.py``)."""

    def __init__(self, source: Properties, predicate: Callable[[str], bool]):
        self.predicate = predicate  # set before super() wires the upstream
        super().__init__(source)

    def _on_change(self, changes):
        passed = {k: v for k, v in changes.items() if self.predicate(k)}
        self._emit(passed)

    def __contains__(self, key):
        return self.predicate(key) and key in self.source

    def __getitem__(self, key):
        if not self.predicate(key):
            raise KeyError(key)
        return self.source[key]

    def __setitem__(self, key, value):
        if not self.predicate(key):
            raise KeyError(key)
        self.source[key] = value

    def __delitem__(self, key):
        if not self.predicate(key):
            raise KeyError(key)
        del self.source[key]

    def keys(self):
        return [k for k in self.source.keys() if self.predicate(k)]


class ReadOnlyProperties(_View):
    def __setitem__(self, key, value):
        raise PropertyError(f"property {key!r} is read-only")

    def __delitem__(self, key):
        raise PropertyError(f"property {key!r} is read-only")


class ValidationError(PropertyError):
    def __init__(self, key, value):
        super().__init__(f"invalid value for property {key!r}: {value!r}")


def _make_validator(spec) -> Callable[[Any], bool]:
    """Accepts a callable, a type, a regex string prefixed 'regex:', or one
    of the named types the reference supports (owrx/property/validators.py)."""
    if callable(spec) and not isinstance(spec, type):
        return spec
    if isinstance(spec, type):
        return lambda v: isinstance(v, spec)
    named = {
        "str": str, "string": str,
        "int": int, "integer": int,
        "bool": bool,
    }
    if spec in named:
        t = named[spec]
        return lambda v: isinstance(v, t)
    if spec in ("num", "number"):
        return lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
    if isinstance(spec, str) and spec.startswith("regex:"):
        rx = re.compile(spec[len("regex:"):])
        return lambda v: isinstance(v, str) and rx.match(v) is not None
    raise PropertyError(f"cannot build validator from {spec!r}")


class ValidatingProperties(_View):
    """Writes are validated before reaching the source (reference
    PropertyValidator)."""

    def __init__(self, source: Properties, validators: dict | None = None):
        super().__init__(source)
        self._validators = {k: _make_validator(v) for k, v in (validators or {}).items()}

    def set_validator(self, key, spec):
        self._validators[key] = _make_validator(spec)

    def __setitem__(self, key, value):
        fn = self._validators.get(key)
        if fn is not None and not fn(value):
            raise ValidationError(key, value)
        self.source[key] = value


class PropertyStack(Properties):
    """Priority-resolved stack of layers (highest priority = lowest number).

    Event diffing semantics per reference PropertyStack
    (owrx/property/__init__.py:268-385): only NET visible changes fire.
    """

    def __init__(self):
        super().__init__()
        self._layers: list[tuple[int, Properties, Subscription]] = []

    # -- resolution -------------------------------------------------------
    def _ordered(self):
        return sorted(self._layers, key=lambda e: e[0])

    def _resolving_layer(self, key, fallback=True) -> Properties | None:
        ordered = self._ordered()
        for _, props, _ in ordered:
            if key in props:
                return props
        return ordered[0][1] if (fallback and ordered) else None

    def __contains__(self, key):
        return any(key in props for _, props, _ in self._layers)

    def __getitem__(self, key):
        layer = self._resolving_layer(key)
        if layer is None:
            raise KeyError(key)
        return layer[key]

    def __setitem__(self, key, value):
        layer = self._resolving_layer(key)
        if layer is None:
            raise PropertyError("stack has no layers")
        layer[key] = value

    def __delitem__(self, key):
        for _, props, _ in self._layers:
            if key in props:
                del props[key]

    def keys(self):
        return {k for _, props, _ in self._layers for k in props.keys()}

    # -- layer management -------------------------------------------------
    def add_layer(self, priority: int, props: Properties):
        self._emit(self._splice_in(priority, props))

    def _splice_in(self, priority: int, props: Properties) -> dict:
        before = {k: self[k] for k in props.keys() if k in self}
        sub = props.subscribe(lambda ch, p=props: self._layer_event(p, ch))
        self._layers.append((priority, props, sub))
        # fire only NET visible changes: the new layer must actually resolve
        # the key, and the visible value must differ from before
        return {k: props[k] for k in props.keys()
                if self._resolving_layer(k) is props
                and (k not in before or before[k] != props[k])}

    def remove_layer(self, props: Properties):
        for entry in self._layers:
            if entry[1] is props:
                self._emit(self._splice_out(entry))
                return

    def remove_layer_by_priority(self, priority: int):
        for entry in list(self._layers):
            if entry[0] == priority:
                self._emit(self._splice_out(entry))
                return

    def _splice_out(self, entry) -> dict:
        _, props, sub = entry
        sub.cancel()
        self._layers.remove(entry)
        changes = {}
        for key in props.keys():
            if key in self:
                if self[key] != props[key]:
                    changes[key] = self[key]
            else:
                changes[key] = DELETED
        return changes

    def replace_layer(self, priority: int, props: Properties):
        """Remove + add in one step, firing only the net diff
        (reference replaceLayer, owrx/property/__init__.py:322-331)."""
        before = self.to_dict()
        existing = [e for e in self._layers if e[0] == priority]
        changes = self._splice_out(existing[0]) if existing else {}
        changes.update(self._splice_in(priority, props))
        net = {k: v for k, v in changes.items()
               if k not in before or before[k] != v}
        self._emit(net)

    def _layer_event(self, layer: Properties, changes: dict):
        forward = {k: v for k, v in changes.items()
                   if layer is self._resolving_layer(k)}
        # deletions: forward DELETED only if gone from every layer, else
        # surface the newly-revealed lower value
        for k, v in changes.items():
            if v is DELETED:
                lower = self._resolving_layer(k, fallback=False)
                forward[k] = DELETED if lower is None else self[k]
        self._emit(forward)


class PropertyCarousel(Properties):
    """Holds named layers, exactly one active; switching fires the diff
    (reference PropertyCarousel, owrx/property/__init__.py:388-421 — how
    SDR profile switching works)."""

    def __init__(self):
        super().__init__()
        self._default = PropertyLayer().readonly()
        self._active: Properties = self._default
        self._active_sub = self._active.subscribe(self._emit)
        self._layers: dict[str, Properties] = {}

    def add_layer(self, key: str, props: Properties):
        if key in self._layers and self._layers[key] is self._active:
            self._layers[key] = props
            self.switch(key)
        else:
            self._layers[key] = props

    def remove_layer(self, key: str):
        if key in self._layers and self._layers[key] is self._active:
            self.switch()
        del self._layers[key]

    def has_layer(self, key: str) -> bool:
        return key in self._layers

    @property
    def current_id(self) -> str | None:
        """Key of the active layer (None if the default is active)."""
        for k, layer in self._layers.items():
            if layer is self._active:
                return k
        return None

    def switch(self, key: str | None = None):
        before = self._active
        self._active_sub.cancel()
        self._active = self._default if key is None else self._layers[key]
        self._active_sub = self._active.subscribe(self._emit)
        changes = {}
        for k in set(before.keys()) | set(self._active.keys()):
            if k not in self._active:
                changes[k] = DELETED
            elif k not in before or before[k] != self._active[k]:
                changes[k] = self._active[k]
        self._emit(changes)

    def __contains__(self, key):
        return key in self._active

    def __getitem__(self, key):
        return self._active[key]

    def __setitem__(self, key, value):
        self._active[key] = value

    def __delitem__(self, key):
        del self._active[key]

    def keys(self):
        return self._active.keys()
