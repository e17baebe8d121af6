"""A small module layer: dataclass modules with external parameter trees.

Modules are dataclasses whose parameters live outside them, in a nested
dict of collections (``params``, ``batch_stats``). ``init`` builds that
dict; ``apply`` runs a method against it. Inside a method a module reads
or creates its parameters with ``param``, its mutable state with
``variable``, and its random keys with ``make_rng``.

Submodules get stable names, so parameter trees (and checkpoints) keep
their layout: a submodule built inside a ``@compact``
method is ``<ClassName>_<i>`` (or its explicit ``name=``), one assigned in
``setup`` takes its attribute's name (``<attr>_<i>`` for a list). A
compact method called twice reuses the same names, so the second call
shares the first call's parameters.

Random keys: ``make_rng(c)`` folds the module's path and a per-module
counter into the key passed for collection ``c``.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
gelu = jax.nn.gelu
sigmoid = jax.nn.sigmoid
softmax = jax.nn.softmax

_UNSET = object()
_local = threading.local()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Frame:
    """State shared by every module of one ``init``/``apply`` call."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counters = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def compact(fn):
    """Marks a method that may create submodules inline."""
    fn._compact = True
    return fn


def _wrap(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._frame is None:  # unbound: a plain method call
            return fn(self, *args, **kwargs)
        self._run_setup()
        stack = _stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            if getattr(fn, "_compact", False):
                self._autonames.clear()  # the next call reuses the names

    return wrapped


class _Variable:
    def __init__(self, module: "Module", col: str, name: str):
        self._module, self._col, self._name = module, col, name

    @property
    def value(self):
        return self._module._collection(self._col, False)[self._name]

    @value.setter
    def value(self, v):
        if not self._module._frame.is_mutable(self._col):
            raise ValueError(f"collection {self._col!r} is not mutable here "
                             "(pass mutable=[...] to apply)")
        self._module._collection(self._col, True)[self._name] = v


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    parent: Any = dataclasses.field(default=_UNSET, kw_only=True)
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        dataclasses.dataclass(cls, eq=False, repr=False)
        for attr, fn in list(vars(cls).items()):
            public = not attr.startswith("_") or attr == "__call__"
            if public and attr != "setup" and inspect.isfunction(fn):
                setattr(cls, attr, _wrap(fn))

    def __post_init__(self):
        for k, v in (("_frame", None), ("_path", ()), ("_autonames", {}),
                     ("_setup_done", False), ("_in_setup", False)):
            object.__setattr__(self, k, v)
        parent = self.parent
        if parent is _UNSET:
            stack = _stack()
            parent = stack[-1] if stack else None
        object.__setattr__(self, "parent", parent)
        if parent is None or parent._in_setup:
            return  # top level, or named by the setup attribute it lands in
        if self.name is None:
            cls_name = type(self).__name__
            i = parent._autonames.get(cls_name, 0)
            parent._autonames[cls_name] = i + 1
            object.__setattr__(self, "name", f"{cls_name}_{i}")
        self._bind(parent._frame, parent._path + (self.name,))

    def __setattr__(self, attr, value):
        if getattr(self, "_in_setup", False):
            if isinstance(value, Module):
                self._adopt(value, attr)
            elif isinstance(value, (list, tuple)):
                for i, m in enumerate(value):
                    if isinstance(m, Module):
                        self._adopt(m, f"{attr}_{i}")
        object.__setattr__(self, attr, value)

    def _adopt(self, child: "Module", name: str):
        object.__setattr__(child, "parent", self)
        object.__setattr__(child, "name", name)
        child._bind(self._frame, self._path + (name,))

    def _bind(self, frame: _Frame, path: tuple):
        object.__setattr__(self, "_frame", frame)
        object.__setattr__(self, "_path", path)

    def _run_setup(self):
        if self._setup_done:
            return
        object.__setattr__(self, "_setup_done", True)
        if type(self).setup is Module.setup:
            return
        stack = _stack()
        stack.append(self)
        object.__setattr__(self, "_in_setup", True)
        try:
            self.setup()
        finally:
            object.__setattr__(self, "_in_setup", False)
            stack.pop()

    def setup(self):
        pass

    # -- variables ---------------------------------------------------------

    def _collection(self, col: str, create: bool) -> dict:
        f = self._frame
        if f is None:
            raise ValueError(f"{type(self).__name__} is not bound: call it "
                             "through init/apply")
        node = f.variables.get(col)
        if node is None:
            if not create:
                raise KeyError(f"no {col!r} collection in the variables")
            node = f.variables[col] = {}
        for p in self._path:
            nxt = node.get(p)
            if nxt is None:
                if not create:
                    raise KeyError(f"no {col!r} entry at {'/'.join(self._path)}")
                nxt = node[p] = {}
            node = nxt
        return node

    def param(self, name: str, init_fn: Callable, *init_args):
        d = self._collection("params", self._frame is not None
                             and self._frame.initializing)
        if name not in d:
            if not self._frame.initializing:
                raise KeyError(f"missing param {'/'.join(self._path + (name,))}")
            d[name] = init_fn(self.make_rng("params"), *init_args)
        return d[name]

    def variable(self, col: str, name: str, init_fn: Callable, *init_args):
        f = self._frame
        d = self._collection(col, f.initializing or f.is_mutable(col))
        if name not in d:
            if not (f.initializing or f.is_mutable(col)):
                raise KeyError(f"missing {col} {'/'.join(self._path + (name,))}")
            d[name] = init_fn(*init_args)
        return _Variable(self, col, name)

    def is_initializing(self) -> bool:
        return self._frame is not None and self._frame.initializing

    def make_rng(self, name: str):
        f = self._frame
        if f is None or name not in f.rngs:
            raise ValueError(f"no {name!r} random key was passed to "
                             "init/apply")
        key = (self._path, name)
        count = f.rng_counters.get(key, 0)
        f.rng_counters[key] = count + 1
        k = f.rngs[name]
        for p in self._path:
            k = jax.random.fold_in(k, zlib.crc32(p.encode()))
        return jax.random.fold_in(k, count)

    # -- entry points --------------------------------------------------------

    def _run(self, frame: _Frame, method, args, kwargs):
        if method is None:
            fn = type(self).__call__
        elif inspect.ismethod(method):
            fn = method.__func__
        else:
            fn = method
        bound = dataclasses.replace(self, parent=None)
        bound._bind(frame, ())
        return fn(bound, *args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        """Variables (every collection the call created) for ``method``
        (default ``__call__``) run on ``args``."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, rngs, True, True)
        self._run(frame, method, args, kwargs)
        return frame.variables

    def apply(self, variables: dict, *args, rngs=None, method=None,
              mutable=False, **kwargs):
        """``method`` (default ``__call__``) run against ``variables``.
        With ``mutable`` (a list of collections, or True) returns
        ``(out, updated collections)``."""
        mut = mutable if mutable is True else frozenset(mutable or ())
        frame = _Frame(_copy_dicts(dict(variables)), dict(rngs or {}), mut,
                       False)
        out = self._run(frame, method, args, kwargs)
        if mutable is False:
            return out
        return out, {c: v for c, v in frame.variables.items()
                     if frame.is_mutable(c)}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class Dense(Module):
    """``y = x @ kernel + bias``; lecun-normal kernel, zero bias, float32
    parameters; ``dtype`` sets the operand dtype of the product."""

    features: int
    use_bias: bool = True
    dtype: Any = None

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", initializers.lecun_normal(),
                            (x.shape[-1], self.features), jnp.float32)
        bias = (self.param("bias", initializers.zeros, (self.features,),
                           jnp.float32) if self.use_bias else None)
        dtype = self.dtype or jnp.result_type(x, kernel)
        y = lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + bias.astype(dtype)
        return y


class Dropout(Module):
    """Inverted dropout: keep with probability ``1 - rate``, scale by its
    inverse. Draws from the ``rng_collection`` key."""

    rate: float
    deterministic: Optional[bool] = None
    rng_collection: str = "dropout"

    @compact
    def __call__(self, x, deterministic: Optional[bool] = None):
        det = self.deterministic if deterministic is None else deterministic
        if det or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng(self.rng_collection),
                                    p=keep, shape=x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))


def _stats(x, axes, keepdims):
    """Mean and variance in at least float32, as E[x^2] - E[x]^2 clipped
    at zero (one fused pass)."""
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(x, axes, keepdims=keepdims)
    var = jnp.maximum(0.0, jnp.mean(x * x, axes, keepdims=keepdims)
                      - mean * mean)
    return mean, var


def _scale_shift(mdl: Module, x, mean, var, epsilon: float):
    feat = (x.shape[-1],)
    y = x - mean
    mul = lax.rsqrt(var + epsilon) * mdl.param("scale", initializers.ones,
                                              feat, jnp.float32)
    return y * mul + mdl.param("bias", initializers.zeros, feat, jnp.float32)


class BatchNorm(Module):
    """Batch norm over every axis but the last. Running statistics live in
    the ``batch_stats`` collection and move by ``momentum`` per train call
    (not during ``init``)."""

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5

    @compact
    def __call__(self, x):
        feat = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda s: jnp.zeros(s, jnp.float32), feat)
        ra_var = self.variable("batch_stats", "var",
                               lambda s: jnp.ones(s, jnp.float32), feat)
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            mean, var = _stats(x, tuple(range(x.ndim - 1)), False)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        return _scale_shift(self, x, mean, var, self.epsilon)


class LayerNorm(Module):
    """Normalizes the last axis (epsilon 1e-6); learned scale and bias."""

    @compact
    def __call__(self, x):
        mean, var = _stats(x, -1, True)
        return _scale_shift(self, x, mean, var, 1e-6)
