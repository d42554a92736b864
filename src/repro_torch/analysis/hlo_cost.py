"""Cost model of one call of the port: FLOPs, device-memory bytes and the
collective bytes a device would move.

Port of ``src/repro/analysis/hlo_cost.py`` (the same file name, so that a
reader finds the counterpart). The reference walks XLA's optimized HLO with
loop trip counts multiplied through. The port has no HLO: PyTorch runs op by
op, so ``step_cost(fn, *args)`` runs ``fn`` under one
``TorchDispatchMode`` and counts every aten op the call dispatches, forward,
backward and remat's recomputation alike. It works on meta tensors (nothing
is allocated or computed: a full-width step is counted in seconds) and on
real ones.

Conventions (the reference's where they carry over):
  - matmul-class ops (``mm``, ``bmm``, ``addmm``, convolutions, ...) count
    the formulas registered in ``torch.utils.flop_counter``; they are
    ``matmul_flops``. Elementwise ops count 1 FLOP per output element and
    reductions 1 per input element; softmax and log-softmax count the steps
    XLA's HLO shows for them (``_STEPS``). ``flops`` is the sum.
  - every op counts its operands' and outputs' bytes once each. Alias and
    view ops count 0, and so do allocations (``empty``); fills count their
    output; ``copy_`` counts source and destination (twice the slab where it
    writes into a slice, as ``dynamic-update-slice`` does in the reference);
    the in-place index updates (``index_put_``, ``scatter_``,
    ``index_copy_``, ``index_add_``) twice their update and their indices.
  - this is eager PyTorch's real, unfused traffic: every intermediate goes
    to memory and back, and nothing is credited to the 50 MB L2, so it is an
    upper bound on the step's device-memory traffic. XLA's count is after
    fusion (a fusion's internals stay in registers); the two are different
    quantities and must not be read as the same thing.
  - Python loops (layers, microbatches, attention chunks) run unrolled, so
    trip counts are counted by construction: ``unknown_trip_whiles`` is 0.
  - custom calls: the port's CUDA kernels launch through ctypes, which the
    dispatch mode cannot see. Each wrapper in ``kernels/`` reports its
    launch's analytic FLOPs and bytes through ``kernels.common.report_cost``
    (on meta tensors the flash wrapper reports and returns an empty output
    in place of the launch); ``custom_calls`` counts the reports.
  - tags: ``cost_scope(name)`` is the counterpart of ``jax.named_scope``.
    With ``tags={"attn": "attn_core"}`` the bytes of the leaf ops run inside
    a scope whose path contains ``attn_core`` add up in
    ``bytes_by_tag["attn"]``, backward included: a backward op is charged to
    the scope that created its autograd node, a recomputed one to the scope
    it runs in (``forward_ops`` marks remat's recomputation, whose custom
    Functions' forwards run with autograd off inside a backward node). ``skip=name`` leaves out the ops (and custom calls) run
    inside a scope whose path contains ``name``: the tensor-parallel path
    runs its other model shards' work in such a scope, so that one call
    counts its home shard's step alone. ``only=name`` leaves out every op
    run outside a scope named ``name`` (one of the path's names): one
    model shard's own work alone.
  - collective bytes are not seen by the dispatch mode: they are what the
    port's sharded paths move between distinct devices, computed from the
    placed specs by the caller (``split_bytes``: a leaf of S bytes split k
    ways moves S (k - 1) / k into a device when gathered) and added as
    ``collectives({"all-gather": ..., "reduce-scatter": ...})``. On one card
    they are 0.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.common import COST_SINKS

__all__ = ["StepCost", "CostCounter", "step_cost", "cost_scope", "forward_ops", "collectives",
           "split_bytes"]

_COMPOSITE_KEY = torch._C.DispatchKey.CompositeImplicitAutograd
# Alias and metadata ops: no memory traffic (besides every op whose schema
# says its output is a view of an input).
_FREE = {
    "view", "_unsafe_view", "expand", "expand_as", "t", "transpose", "permute",
    "as_strided", "detach", "alias", "slice", "select", "unsqueeze", "squeeze", "split",
    "split_with_sizes", "unbind", "narrow", "view_as", "lift_fresh", "_reshape_alias",
    "unfold", "diagonal", "_local_scalar_dense", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "set_", "resize_", "sym_size", "sym_stride",
    "sym_numel", "is_same_size", "_has_compatible_shallow_copy_type",
}
# Ops that only write their output.
_FILLS = {"fill_", "zero_", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor"}
# In-place index updates: twice the update (and the indices read once).
_SLAB_UPDATES = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_", "index_copy_",
                 "index_add_", "masked_scatter_"}
# Reductions: 1 FLOP per input element.
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std", "var_mean",
           "std_mean", "logsumexp", "norm", "linalg_vector_norm", "argmax", "argmin", "all",
           "any", "cumsum", "cumprod", "nansum", "count_nonzero", "embedding_dense_backward"}
# Ops that stand for several steps: FLOPs per element of the first operand,
# the steps the reference's HLO shows (softmax: reduce-max, subtract, exp,
# reduce-sum, divide; its backward: multiply, reduce-sum, subtract, multiply).
_STEPS = {"_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 4,
              "_log_softmax_backward_data": 4, "native_layer_norm": 7,
              "native_layer_norm_backward": 10}


_KINDS: dict = {}  # OpOverload -> how it is counted (``_classify``)


def _classify(func) -> str:
    name = func._overloadpacket.__name__
    if func._overloadpacket in flop_registry:
        kind = "matmul"
    elif torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _COMPOSITE_KEY):
        kind = "composite"
    elif name in _FREE or func.is_view:
        kind = "free"
    elif name in _FILLS:
        kind = "fill"
    elif name == "copy_":
        kind = "copy"
    elif name in _SLAB_UPDATES:
        kind = "slab"
    elif name in _STEPS:
        kind = name
    elif torch.Tag.pointwise in func.tags and name not in ("clone", "_to_copy"):
        kind = "pointwise"
    elif name in _REDUCE:
        kind = "reduce"
    else:
        kind = "move"  # bytes only: casts, copies, gathers, concatenations
    _KINDS[func] = kind
    return kind


@dataclasses.dataclass
class StepCost:
    """The reference's ``HloCost`` fields, and the matmul share of ``flops``."""

    flops: float
    bytes: float
    collective_bytes: float
    collective_by_op: dict
    unknown_trip_whiles: int
    custom_calls: int
    bytes_by_tag: dict | None = None
    matmul_flops: float = 0.0

    def __add__(self, other: "StepCost") -> "StepCost":
        def merged(a, b):
            out = dict(a or {})
            for k, v in (b or {}).items():
                out[k] = out.get(k, 0.0) + v
            return out

        return StepCost(self.flops + other.flops, self.bytes + other.bytes,
                        self.collective_bytes + other.collective_bytes,
                        merged(self.collective_by_op, other.collective_by_op),
                        self.unknown_trip_whiles + other.unknown_trip_whiles,
                        self.custom_calls + other.custom_calls,
                        merged(self.bytes_by_tag, other.bytes_by_tag),
                        self.matmul_flops + other.matmul_flops)

    def __mul__(self, k: int) -> "StepCost":
        """``k`` runs of the same call (identical microbatches)."""
        return StepCost(k * self.flops, k * self.bytes, k * self.collective_bytes,
                        {op: k * v for op, v in self.collective_by_op.items()},
                        self.unknown_trip_whiles, k * self.custom_calls,
                        {t: k * v for t, v in (self.bytes_by_tag or {}).items()},
                        k * self.matmul_flops)

    __rmul__ = __mul__


# ------------------------------------------------------------------ scopes

_TLS = threading.local()
_ACTIVE: list = []  # running counters, innermost last


def _scopes() -> list:
    stack = getattr(_TLS, "scopes", None)
    if stack is None:
        stack = _TLS.scopes = []
    return stack


class cost_scope:
    """``with cost_scope("attn_core"):`` names the ops run inside for the
    counters' ``tags`` (``jax.named_scope``'s counterpart). Thread-local;
    with no counter running it does nothing but one list test."""

    __slots__ = ("name", "_lo")

    def __init__(self, name: str):
        self.name = name
        self._lo = None

    def __enter__(self):
        if _ACTIVE:
            _scopes().append(self.name)
            self._lo = torch._C._autograd._get_sequence_nr()
        return self

    def __exit__(self, *exc):
        if self._lo is not None:
            stack = _scopes()
            path = "/".join(stack)
            stack.pop()
            if torch.is_grad_enabled():  # the autograd nodes made inside belong here
                span = (self._lo, torch._C._autograd._get_sequence_nr(), path)
                for counter in _ACTIVE:
                    counter._spans.append(span)
            self._lo = None
        return False


class forward_ops:
    """``with forward_ops():`` marks the ops inside as a forward's: each is
    charged to the scope it runs in, also where autograd is off inside a
    backward node (remat's recomputation runs a layer's forward, and its
    custom Functions' forwards, within the backward node that needs it).
    Thread-local; with no counter running it does nothing but one list
    test."""

    __slots__ = ("_on",)

    def __enter__(self):
        self._on = bool(_ACTIVE)
        if self._on:
            _TLS.forward = getattr(_TLS, "forward", 0) + 1
        return self

    def __exit__(self, *exc):
        if self._on:
            _TLS.forward -= 1
        return False


# ------------------------------------------------------------------ counting


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(items) -> list:
    """The tensors among ``items`` and the lists inside them (an op's args)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += [t for t in x if isinstance(t, torch.Tensor)]
    return out


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (``with CostCounter()
    as c: ...; c.result()``); see the module docstring."""

    def __init__(self, tags: dict | None = None, skip: str | None = None,
                 only: str | None = None):
        super().__init__()
        self.tags = dict(tags or {})
        self.skip = skip
        self.only = only
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.custom_calls = 0
        self.by_tag: dict = {}
        self._depth = 0
        self._spans: list = []  # (first, end) autograd sequence numbers of a scope, its path
        self._node_paths: dict = {}

    def __enter__(self):
        self._depth += 1
        if self._depth == 1:  # not when a decomposition re-enters the mode
            _ACTIVE.append(self)
            COST_SINKS.append(self._custom_call)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                COST_SINKS.remove(self._custom_call)
                _ACTIVE.remove(self)

    # -- attribution

    def _path(self) -> str:
        if not torch.is_grad_enabled() and not getattr(_TLS, "forward", 0):
            node = torch._C._current_autograd_node()
            if node is not None:  # a backward op: the scope that made its node
                seq = node._sequence_nr()
                path = self._node_paths.get(seq)
                if path is None:
                    path = next((p for lo, hi, p in reversed(self._spans) if lo <= seq < hi), "")
                    self._node_paths[seq] = path
                return path
        return "/".join(_scopes())

    def _charge(self, nbytes: float) -> None:
        self.bytes += nbytes
        if self.tags and nbytes:
            path = self._path()
            if path:
                for name, sub in self.tags.items():
                    if sub in path:
                        self.by_tag[name] = self.by_tag.get(name, 0.0) + nbytes
                        break

    def _skipped(self) -> bool:
        if self.skip is None and self.only is None:
            return False
        path = self._path()
        return ((self.skip is not None and self.skip in path)
                or (self.only is not None and self.only not in path.split("/")))

    def _custom_call(self, flops: float, nbytes: float, matmul: bool) -> None:
        if self._skipped():
            return
        self.custom_calls += 1
        self.flops += flops
        if matmul:
            self.matmul_flops += flops
        self._charge(nbytes)

    # -- the dispatch mode

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._skipped():
            return func(*args, **kwargs)
        kind = _KINDS.get(func) or _classify(func)
        if kind == "composite":
            # A composite op (``matmul``, ``einsum`` under inference mode)
            # reaches the mode whole: count the ops it decomposes into.
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if kind != "free":
            self._count(kind, func, args, kwargs, out)
        return out

    def _count(self, kind: str, func, args, kwargs, out) -> None:
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if kind == "fill":
            self._charge(sum(_nbytes(t) for t in outs))
            return
        if kind == "copy":
            self._charge(_nbytes(args[0]) + _nbytes(args[1]))
            return
        operands = _tensors(args) + _tensors(v for k, v in kwargs.items() if k != "out")
        if kind == "slab":
            update = operands[-1]  # the index itself where a scalar value is scattered
            index = sum(_nbytes(t) for t in operands[1:-1] if not t.is_floating_point())
            self._charge(2 * _nbytes(update) + index)
            if func._overloadpacket.__name__ in ("scatter_add_", "index_add_"):
                self.flops += update.numel()
            return
        nbytes = sum(_nbytes(t) for t in operands) + sum(_nbytes(t) for t in outs)
        if kind == "matmul":
            # A product's ``out_dtype`` overload (``mm.dtype``, ``bmm.dtype``)
            # counts as the product: its formula takes the operands alone.
            margs = tuple(a for a in args if not isinstance(a, torch.dtype))
            f = float(flop_registry[func._overloadpacket](*margs, **kwargs, out_val=out))
            self.flops += f
            self.matmul_flops += f
        elif kind == "pointwise":
            self.flops += outs[0].numel() if outs else 0
        elif kind == "reduce":
            self.flops += operands[0].numel() if operands else 0
        elif kind != "move":  # an op of several steps
            self.flops += _STEPS[kind] * operands[0].numel()
        self._charge(nbytes)

    def result(self) -> StepCost:
        return StepCost(flops=self.flops, bytes=self.bytes, collective_bytes=0.0,
                        collective_by_op={}, unknown_trip_whiles=0,
                        custom_calls=self.custom_calls, bytes_by_tag=dict(self.by_tag),
                        matmul_flops=self.matmul_flops)


def step_cost(fn, *args, tags: dict | None = None, skip: str | None = None,
              only: str | None = None, **kwargs) -> StepCost:
    """The cost of ``fn(*args, **kwargs)`` (run once, under ``CostCounter``);
    ``tags``: {tag: scope substring}, the reference's ``{"attn": "attn_core"}``;
    ``skip``: a scope substring whose ops are left out; ``only``: the scope
    name outside which every op is left out.
    Its collective bytes are 0: a caller on a mesh adds ``collectives``."""
    with CostCounter(tags, skip, only) as counter:
        fn(*args, **kwargs)
    return counter.result()


def collectives(by_op: dict) -> StepCost:
    """A cost of collective bytes alone ({op: bytes into a device}, from
    ``split_bytes``), to add to a counted one."""
    return StepCost(0.0, 0.0, float(sum(by_op.values())), dict(by_op), 0, 0, {}, 0.0)


def split_bytes(leaves, shardings) -> float:
    """Bytes a gather of every leaf moves into one device: a leaf of S bytes
    split k ways by its sharding (``NamedSharding``, or anything with
    ``blocks_per_dim``) brings S (k - 1) / k from the devices holding the
    other blocks. The same bytes leave a device when a reduce-scatter sums
    a gradient leaf into those blocks. Leaves: tensors (meta or real) or
    ``(shape, dtype)`` pairs, matched in order with ``shardings``."""
    total = 0.0
    for leaf, sh in zip(leaves, shardings):
        shape, dtype = (leaf.shape, leaf.dtype) if isinstance(leaf, torch.Tensor) else leaf
        k = math.prod(sh.blocks_per_dim(len(shape)))
        nbytes = math.prod(shape) * dtype.itemsize
        total += nbytes * (k - 1) / k
    return total
