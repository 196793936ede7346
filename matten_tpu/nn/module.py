"""A minimal functional module system for the model's layers.

Modules are dataclasses. Their ``__call__`` creates parameters, state
variables and sub-modules inline; ``init`` and ``apply`` run a module
against an explicit ``{collection: nested dict}`` variables tree, so the
model stays a pure function of its parameters under ``jit``/``grad``.

Parameter paths and the initialisation stream follow the flax.linen
conventions that saved checkpoints and ``tests/goldens`` pin:

  * a sub-module created inside ``__call__`` is named by its ``name=`` or,
    without one, ``<ClassName>_<n>`` (n counts per class and parent);
  * a module held in a dataclass field is named after the field
    (``backbone``), or ``<field>_<i>`` inside a tuple (``layers_3``),
    whatever name it was constructed with;
  * the key for the k-th parameter created in the scope at path p is
    ``fold_in(root, uint32(sha1(p..., k)[:4]))`` with the strings and
    integers of ``(*p, k)`` hashed in order.

``tests/nn/test_module_core.py`` checks these rules against flax itself
where flax is installed.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["Module", "Dense", "Variable"]

_MISSING = object()
_LOCAL = threading.local()


def _module_stack() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


def _fold_in_static(key, data: Tuple) -> jax.Array:
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str in an rng path, got {x!r}")
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class _Run:
    """State of one ``init`` or ``apply`` call."""

    def __init__(self, variables, rng, mutable, initializing: bool, capture):
        self.variables = variables
        self.rng = rng
        self.mutable = mutable  # True (every collection) or a set of names
        self.initializing = initializing
        self.capture = capture
        self.out: Dict[str, dict] = {}
        for col, tree in variables.items():
            if self.is_mutable(col):
                self.out[col] = _copy_tree(tree)
        self.counters: Dict[Tuple[str, ...], int] = {}
        self.autonames: Dict[Tuple, int] = {}
        self.intermediates: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def get(self, col: str, path: Tuple[str, ...], name: str):
        node = self.out.get(col) if self.is_mutable(col) else self.variables.get(col)
        for p in path + (name,):
            if not isinstance(node, dict) or p not in node:
                return _MISSING
            node = node[p]
        return node

    def put(self, col: str, path: Tuple[str, ...], name: str, value) -> None:
        if not self.is_mutable(col):
            raise ValueError(
                f"cannot write {'/'.join(path + (name,))} into the immutable "
                f"collection {col!r} (pass mutable=[{col!r}] to apply)"
            )
        node = self.out.setdefault(col, {})
        for p in path:
            node = node.setdefault(p, {})
        node[name] = value

    def next_rng(self, path: Tuple[str, ...]):
        if self.rng is None:
            raise ValueError(
                f"parameter at {'/'.join(path)} is missing and no rng was given "
                f"(call init, or pass the full params tree to apply)"
            )
        k = self.counters.get(path, 0) + 1
        self.counters[path] = k
        return _fold_in_static(self.rng, path + (k,))

    def sow(self, path: Tuple[str, ...], value) -> None:
        node = self.intermediates
        for p in path:
            node = node.setdefault(p, {})
        node["__call__"] = node.get("__call__", ()) + (value,)


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


class Variable:
    """A mutable state slot (e.g. batch-norm running statistics)."""

    def __init__(self, run: _Run, col: str, path: Tuple[str, ...], name: str):
        self._run, self._col, self._path, self._name = run, col, path, name

    @property
    def value(self):
        return self._run.get(self._col, self._path, self._name)

    @value.setter
    def value(self, v) -> None:
        self._run.put(self._col, self._path, self._name, v)


def _wrap_call(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        run = self._run
        if run is None:
            return fn(self, *args, **kwargs)
        stack = _module_stack()
        stack.append(self)
        try:
            out = fn(self, *args, **kwargs)
        finally:
            stack.pop()
        if run.capture is not None and run.capture(self, "__call__"):
            run.sow(self._path, out)
        return out

    return call


@dataclasses.dataclass(eq=True, unsafe_hash=True)
class Module:
    """Base class: subclasses declare their settings as annotated fields."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "__call__" in cls.__dict__:
            cls.__call__ = _wrap_call(cls.__dict__["__call__"])
        dataclasses.dataclass(cls, eq=True, unsafe_hash=True)

    def __post_init__(self):
        self._run: Optional[_Run] = None
        self._path: Tuple[str, ...] = ()
        stack = _module_stack()
        parent = stack[-1] if stack else None
        if parent is None or parent._run is None:
            return
        name = self.name
        if name is None:
            prefix = type(self).__name__
            key = (parent._path, prefix)
            i = parent._run.autonames.get(key, 0)
            parent._run.autonames[key] = i + 1
            name = f"{prefix}_{i}"
        self._bind(parent._run, parent._path + (name,))

    def _bind(self, run: _Run, path: Tuple[str, ...]) -> None:
        self._run, self._path = run, path
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Module):
                setattr(self, f.name, _bound_copy(v, run, path + (f.name,)))
            elif isinstance(v, (tuple, list)) and any(isinstance(x, Module) for x in v):
                setattr(
                    self,
                    f.name,
                    type(v)(
                        _bound_copy(x, run, path + (f"{f.name}_{i}",))
                        if isinstance(x, Module)
                        else x
                        for i, x in enumerate(v)
                    ),
                )

    def _require_run(self) -> _Run:
        if self._run is None:
            raise ValueError(
                f"{type(self).__name__} is not bound: use init/apply, or create "
                f"it inside another module's __call__"
            )
        return self._run

    # ---- inside __call__ -------------------------------------------------
    def param(self, name: str, init_fn: Callable, *init_args) -> Any:
        run = self._require_run()
        value = run.get("params", self._path, name)
        if value is _MISSING:
            value = init_fn(run.next_rng(self._path), *init_args)
            run.put("params", self._path, name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args) -> Variable:
        run = self._require_run()
        if run.get(col, self._path, name) is _MISSING:
            run.put(col, self._path, name, init_fn(*init_args))
        return Variable(run, col, self._path, name)

    def is_initializing(self) -> bool:
        return self._require_run().initializing

    # ---- entry points ------------------------------------------------------
    def init(self, rng, *args, **kwargs) -> Dict[str, dict]:
        """Run ``__call__`` once and return every variable it created."""
        run = _Run({}, rng, True, True, None)
        _bound_copy(self, run, ())(*args, **kwargs)
        return run.out

    def apply(
        self,
        variables: Dict[str, dict],
        *args,
        mutable=False,
        capture_intermediates=False,
        **kwargs,
    ):
        """Run ``__call__`` with ``variables``.

        Returns the output, or ``(output, collections)`` when `mutable`
        names collections to update or `capture_intermediates` is set (True
        or a ``filter(module, method_name)``); captured ``__call__`` outputs
        go under ``collections["intermediates"][<path>]["__call__"]``.
        """
        if mutable is False:
            mut = set()
        elif mutable is True:
            mut = True
        elif isinstance(mutable, str):
            mut = {mutable}
        else:
            mut = set(mutable)
        capture = None
        if capture_intermediates is True:
            capture = lambda mdl, method: method == "__call__"  # noqa: E731
        elif capture_intermediates:
            capture = capture_intermediates
        run = _Run(dict(variables), None, mut, False, capture)
        out = _bound_copy(self, run, ())(*args, **kwargs)
        if not mut and capture is None:
            return out
        cols = {c: t for c, t in run.out.items() if run.is_mutable(c)}
        if capture is not None:
            cols["intermediates"] = run.intermediates
        return out, cols


def _bound_copy(module: Module, run: _Run, path: Tuple[str, ...]) -> Module:
    bound = copy.copy(module)
    bound._bind(run, path)
    return bound


class Dense(Module):
    """``x @ kernel + bias``; kernel ~ LeCun normal, bias = 0."""

    features: int

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        kernel = self.param(
            "kernel", jax.nn.initializers.lecun_normal(), (x.shape[-1], self.features)
        )
        bias = self.param("bias", jax.nn.initializers.zeros, (self.features,))
        return jnp.dot(x, kernel) + bias
