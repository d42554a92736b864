"""Runtime contracts for the TCIM hot path.

Port of ``src/repro/runtime/contracts.py``. The speed-up rests on three
invariants:

* one host sync per count (the ``CountFuture.result()`` close),
* a single explicit host->device transfer in the device build,
* nothing rebuilt or rebound on a steady dispatch.

Each is a contract enforced *at the call site* whenever the environment
variable ``TCIM_CONTRACTS`` is truthy. With the variable unset every
contract is a pass-through: the decorator form calls the wrapped function
after one dict lookup, and the context-manager form enters and exits
without touching torch.

Three contracts are provided, each usable as a decorator or context manager:

``no_host_sync``
    The guarded region must not read a tensor back to the host. While it
    runs, the Python-level readbacks of ``torch.Tensor`` raise on the
    entering thread: ``item``, ``tolist``, ``numpy``, ``cpu``, ``to`` a CPU
    device, ``__int__``, ``__float__``, ``__bool__``, ``__index__`` and
    ``__array__`` (so ``np.asarray``), and so do ``torch.cuda.synchronize``
    and ``Stream``/``Event.synchronize``. The stubs trip on CPU tensors too,
    as the reference's trip on CPU jax arrays: that is what lets the tests
    on the host exercise the contract. They are installed on the shared
    classes while any region is open (a reference count across nested and
    concurrent regions; the originals come back when the last one exits)
    and armed by a thread-local depth, so another thread's legitimate
    readback at its own future close passes through. Syncs inside C++ ops
    (``nonzero``, boolean-mask indexing, ``unique``, ``repeat_interleave``
    without ``output_size``) are invisible here: the lint
    (``tools.tclint_torch``, TCL001) and, on the card, a run under
    ``torch.cuda.set_sync_debug_mode("error")`` cover those. That debug mode
    is process-global and misses some syncs, so it is a second net for
    single-threaded checks, not the contract. Staging
    (``runtime.staging.stage``) stays legal.

``max_transfers(n)``
    The guarded region may make at most ``n`` explicit staging calls: calls
    of ``runtime.staging.stage``, the port's one host->device copy, which
    charges this hook on every device (the CPU included, where the copy is
    a view or a no-op), as ``jax.device_put`` counts on the CPU backend.
    Only calls from the entering thread charge the budget.

``max_retrace(n)``
    Eager torch compiles nothing, so the events that take a compile's place
    are counted: each build or load of a kernel library
    (``kernels._build.compile_sources`` per source compiled,
    ``load_library`` per library loaded) and each binding of resident
    stores (``Executor._make_launcher``, the sharded executors' shards).
    They are counted on every device, so a pool miss, ``adopt_stores`` or a
    grown store counts on the host too, while a pool hit or a repeated
    stream signature on the same stores counts 0. The count is scoped to
    the *entering thread*: a stream warming up on another thread does not
    trip a steady stream's ``max_retrace(0)`` window.

Contract breaches raise :class:`ContractViolation` (a ``RuntimeError``).
"""
from __future__ import annotations

import functools
import os
import threading
from contextlib import ExitStack
from typing import Callable, Optional

import torch

__all__ = [
    "ContractViolation",
    "contracts_enabled",
    "no_host_sync",
    "max_transfers",
    "max_retrace",
]

_ENV_VAR = "TCIM_CONTRACTS"
_FALSY = ("", "0", "false", "off", "no")

# Per-thread contract state: ``sync_depth`` (open no_host_sync regions),
# ``transfers`` (open max_transfers regions) and ``retraces`` (this
# thread's retrace events since the process started).
_TLS = threading.local()


class ContractViolation(RuntimeError):
    """A runtime contract on the TCIM hot path was breached."""


def contracts_enabled() -> bool:
    """True when ``TCIM_CONTRACTS`` is set to a truthy value.

    Read from the environment on every call (one dict lookup) so tests can
    flip enforcement with ``monkeypatch.setenv`` without reloading modules.
    """
    return os.environ.get(_ENV_VAR, "").strip().lower() not in _FALSY


class _Contract:
    """Decorator + context-manager base with the enabled() short-circuit."""

    _what = "contract"

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not contracts_enabled():
                return fn(*args, **kwargs)
            with self._fresh():
                return fn(*args, **kwargs)

        wrapper.__tcim_contract__ = self  # introspectable by tests/tooling
        return wrapper

    def _fresh(self) -> "_Contract":
        # Context-manager state must not be shared across concurrent or
        # recursive activations of one decorated function; clone per entry.
        return type(self)(**self._init_kwargs())

    def _init_kwargs(self) -> dict:
        return {}

    def __enter__(self):
        self._stack: Optional[ExitStack] = None
        if not contracts_enabled():
            return self
        self._stack = ExitStack()
        try:
            self._enter(self._stack)
        except BaseException:
            self._stack.close()
            raise
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._stack is None:
            return False
        self._stack.close()
        if exc is None:
            self._check()
        return False

    # hooks ---------------------------------------------------------------
    def _enter(self, stack: ExitStack) -> None:  # pragma: no cover
        raise NotImplementedError

    def _check(self) -> None:
        pass


# ------------------------------------------------------------ no_host_sync

# (owner, attribute) of every Python-level readback the stubs replace.
_SYNC_TENSOR_ATTRS = (
    "item", "tolist", "numpy", "cpu", "to",
    "__int__", "__float__", "__bool__", "__index__", "__array__",
)
_MISSING = object()
_STUB_LOCK = threading.Lock()
_STUB_REFS = 0
_STUB_SAVED: list = []  # (owner, name, value in owner.__dict__ or _MISSING)


def _sync_targets() -> list:
    targets = [(torch.Tensor, name) for name in _SYNC_TENSOR_ATTRS]
    targets.append((torch.cuda, "synchronize"))
    targets += [(torch.cuda.Stream, "synchronize"), (torch.cuda.Event, "synchronize")]
    return targets


def _to_cpu(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call names a CPU target (a readback)."""
    dev = kwargs.get("device")
    if dev is None and args:
        first = args[0]
        if isinstance(first, torch.Tensor):
            dev = first.device
        elif isinstance(first, (str, torch.device)):
            dev = first
    return dev is not None and torch.device(dev).type == "cpu"


def _armed() -> bool:
    return getattr(_TLS, "sync_depth", 0) > 0


def _violation(what: str) -> ContractViolation:
    return ContractViolation(
        f"no_host_sync: implicit host sync via {what} inside a guarded "
        f"dispatch region (route the readback through the CountFuture close "
        f"instead)"
    )


def _make_stub(owner, name: str, orig):
    label = f"{getattr(owner, '__name__', owner)}.{name}"
    if name == "to":
        def stub(self, *args, **kwargs):
            if _armed() and _to_cpu(args, kwargs):
                raise _violation(f"{label} a CPU device")
            return orig(self, *args, **kwargs)
    elif owner is torch.cuda:
        def stub(*args, **kwargs):
            if _armed():
                raise _violation(f"torch.cuda.{name}")
            return orig(*args, **kwargs)
    else:
        def stub(self, *args, **kwargs):
            if _armed():
                raise _violation(label)
            # Another thread's readback while this region is open: pass
            # through to the saved implementation.
            return orig(self, *args, **kwargs)
    return stub


def _install_stubs() -> None:
    global _STUB_REFS
    with _STUB_LOCK:
        if _STUB_REFS == 0:
            for owner, name in _sync_targets():
                _STUB_SAVED.append((owner, name, owner.__dict__.get(name, _MISSING)))
                setattr(owner, name, _make_stub(owner, name, getattr(owner, name)))
        _STUB_REFS += 1


def _remove_stubs() -> None:
    global _STUB_REFS
    with _STUB_LOCK:
        _STUB_REFS -= 1
        if _STUB_REFS == 0:
            for owner, name, value in reversed(_STUB_SAVED):
                if value is _MISSING:
                    delattr(owner, name)  # the inherited C++ method shows again
                else:
                    setattr(owner, name, value)
            _STUB_SAVED.clear()


class no_host_sync(_Contract):
    """Forbid reading a tensor back to the host inside the guarded region."""

    _what = "no_host_sync"

    def _enter(self, stack: ExitStack) -> None:
        _install_stubs()
        stack.callback(_remove_stubs)
        _TLS.sync_depth = getattr(_TLS, "sync_depth", 0) + 1
        stack.callback(lambda: setattr(_TLS, "sync_depth", _TLS.sync_depth - 1))


# ----------------------------------------------------------- max_transfers


def note_transfer() -> None:
    """Charge one explicit staging call to the entering thread's open
    ``max_transfers`` regions (``runtime.staging.stage`` calls this)."""
    regions = getattr(_TLS, "transfers", None)
    if regions:
        for region in regions:
            region.count += 1


class max_transfers(_Contract):
    """Allow at most ``n`` explicit staging calls."""

    def __init__(self, n: int):
        self.n = int(n)
        self.count = 0
        self._what = f"max_transfers({self.n})"

    def _init_kwargs(self) -> dict:
        return {"n": self.n}

    def _enter(self, stack: ExitStack) -> None:
        self.count = 0
        regions = getattr(_TLS, "transfers", None)
        if regions is None:
            regions = _TLS.transfers = []
        regions.append(self)
        stack.callback(regions.remove, self)

    def _check(self) -> None:
        if self.count > self.n:
            raise ContractViolation(
                f"max_transfers({self.n}): {self.count} explicit staging "
                f"calls (runtime.staging.stage) in the guarded region"
            )


# ------------------------------------------------------------- max_retrace


class _RetraceEvents:
    """Retrace events counted globally and per emitting thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0
        self.by_thread: dict[int, int] = {}

    def note(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            self.total += 1
            self.by_thread[tid] = self.by_thread.get(tid, 0) + 1

    def thread_total(self) -> int:
        """Events emitted by the calling thread."""
        return self.by_thread.get(threading.get_ident(), 0)


_EVENTS = _RetraceEvents()


def note_retrace() -> None:
    """Count one retrace event (a kernel library built or loaded, resident
    stores bound) on the calling thread, whether or not a region is open."""
    _EVENTS.note()


class max_retrace(_Contract):
    """Allow at most ``n`` retrace events inside the guarded region."""

    def __init__(self, n: int = 0):
        self.n = int(n)
        self.compiles = 0
        self._start = 0
        self._what = f"max_retrace({self.n})"

    def _init_kwargs(self) -> dict:
        return {"n": self.n}

    def _enter(self, stack: ExitStack) -> None:
        self._start = _EVENTS.thread_total()

        def snapshot():
            self.compiles = _EVENTS.thread_total() - self._start

        stack.callback(snapshot)

    def _check(self) -> None:
        if self.compiles > self.n:
            raise ContractViolation(
                f"max_retrace({self.n}): {self.compiles} kernel library builds "
                f"or store bindings in the guarded region (expected built "
                f"kernels and bound stores; check for a pool miss, an "
                f"adopt_stores or a grown store)"
            )
