"""Per-device cost of one call, counted over the aten ops it dispatches —
counterpart of ``repro/roofline/hlo_cost.py``.

The reference walks the optimized HLO of a compiled program and multiplies
each loop body by its trip count, because XLA's own ``cost_analysis``
counts a body once.  The port runs eagerly, so there is no HLO to parse and
no loop to scale: :func:`analyze` runs the function once under a
``TorchDispatchMode`` and counts every aten op it dispatches, each loop
iteration as it runs (``unknown_trip_loops`` is always 0).  On fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``) nothing is
allocated and the counts are those of the same call on the card.

The reference's rules, on aten ops:

  * ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution`` (and the other
    products ``torch.utils.flop_counter`` knows) count their exact product
    FLOPs; elementwise and transcendental ops (the ``pointwise`` tag,
    ``_foreach_*``) 1 flop per output element; reductions (the
    ``reduction`` tag, softmax, norms) their operand bytes / 4, as the
    reference's ``reduce``
  * views, reshapes, ``detach`` and allocations (``empty*``) are free
  * copies, transposes made contiguous, ``cat`` and the other moves count
    operands plus result
  * gather, scatter, ``index_select`` and ``embedding`` count 2x the result
    plus the indices (random-access reads); a scatter adds 1 flop per
    result element
  * an in-place ``copy_`` (a cache write into a slice) counts 2x the
    source, as the reference's ``dynamic-update-slice``
  * ``bytes`` is operands plus results of every counted op; ``bytes_fused``
    leaves out standalone elementwise, reduction and move ops, as the
    reference's ``FREE``/``ELEMENTWISE``/``MOVE`` sets do there (TPU
    fusion granularity)
  * functional collectives (``_c10d_functional.*``) add their local
    operand bytes to ``coll_bytes`` and ``coll_by_kind``.

Counts are per device.  Under DTensor a dispatch mode sees the global op
on DTensors *and* the local ops it decomposes into, so only ops whose
tensor arguments are plain (local) tensors are counted — the post-SPMD
program, as the reference's HLO is.

Where the reference takes the larger branch of a conditional, eager
execution counts the branch it takes.

Each counted op is also recorded (:class:`OpRecord`: its name, its
arguments' local shapes and dtypes, its results', the ``nn.Module`` path it
ran under), so that :func:`count` recounts a saved record
(``launch/dryrun.py --reanalyze``) and :func:`attribute` groups the counts
by module.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline import hw

_DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16,
}
_INDEX_DTYPES = {"bool", "uint8", "int8", "int16", "int32", "int64"}

FREE = {
    "detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "_local_scalar_dense", "set_",
    "resize_", "sym_size", "sym_stride", "sym_numel", "is_same_size",
    "wait_tensor", "_assert_tensor_metadata", "_has_compatible_shallow_copy_type",
    "is_contiguous", "is_strides_like_format", "is_non_overlapping_and_dense",
    "size", "stride", "storage_offset", "numel", "dim", "sym_storage_offset",
    "sym_is_contiguous",
}
REDUCE = {"_softmax", "_log_softmax", "_softmax_backward_data",
          "_log_softmax_backward_data", "logsumexp", "native_layer_norm",
          "native_layer_norm_backward", "linalg_vector_norm", "topk", "sort",
          "cumsum", "cumprod"}
GATHER = {"embedding", "index_select", "gather", "index", "take",
          "_unsafe_index"}
SCATTER = {"scatter", "scatter_", "scatter_add", "scatter_add_",
           "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
           "index_put", "index_put_", "_index_put_impl_", "index_copy",
           "index_copy_", "masked_scatter", "masked_scatter_",
           "embedding_dense_backward", "_unsafe_index_put"}
COLL_NAMESPACES = ("_c10d_functional", "c10d", "_c10d_functional_autograd")
# (a substring of a collective's name, its kind); other ops of those
# namespaces (waits, autograd wrappers) are free
COLL_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
              ("reduce_scatter", "reduce-scatter"),
              ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
              ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
              ("broadcast", "collective-permute"),
              ("permute", "collective-permute"),
              ("send", "collective-permute"), ("recv", "collective-permute"))
MOVE = {"clone", "_to_copy", "copy", "contiguous", "cat", "stack", "fill",
        "fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like", "full",
        "full_like", "arange", "new_zeros", "new_ones", "new_full",
        "constant_pad_nd", "flip", "roll", "repeat", "tril", "triu"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0          # conservative: op-boundary traffic
    coll_bytes: float = 0.0
    bytes_fused: float = 0.0    # optimistic: standalone elementwise/move ops
    #                             assumed fused away (TPU fusion granularity)
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    unknown_trip_loops: int = 0

    def __iadd__(self, o):
        self.flops += o.flops
        self.bytes += o.bytes
        self.coll_bytes += o.coll_bytes
        self.bytes_fused += o.bytes_fused
        for k, v in o.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0) + v
        self.unknown_trip_loops += o.unknown_trip_loops
        return self


@dataclasses.dataclass
class OpRecord:
    """One counted op: ``name`` as ``str(OpOverload)`` (``aten.mm.default``),
    ``args``/``kwargs`` with every tensor as ``["T", shape, dtype]`` and
    other values as JSON scalars or strings, ``outs`` the result tensors'
    ``[shape, dtype]``, ``module`` the ``nn.Module`` path."""

    name: str
    args: list
    kwargs: dict
    outs: list
    module: str

    def as_list(self) -> list:
        return [self.name, self.args, self.kwargs, self.outs, self.module]

    @classmethod
    def from_list(cls, x) -> "OpRecord":
        return cls(*x)


@dataclasses.dataclass
class Memory:
    """Live bytes of one call, per device (local tensors): its arguments,
    its results and the most that ops of the call held alive beyond the
    arguments at once (``peak_new_bytes``)."""

    argument_bytes: int = 0
    output_bytes: int = 0
    peak_new_bytes: int = 0
    output_new_bytes: int = 0

    def as_dict(self) -> dict:
        """The reference's ``memory_analysis`` keys.  ``temp_bytes`` is the
        peak of storages the call made less those it returned: live
        storages under the dispatch mode, where XLA reports its buffer
        assignment's temporaries."""
        temp = max(self.peak_new_bytes - self.output_new_bytes, 0)
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": temp,
                "generated_code_bytes": 0,
                "peak_bytes_estimate": (self.argument_bytes
                                        + self.output_bytes + temp)}


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:             # a build without torch.distributed
        return None
    return DTensor


def _local(t):
    """The local tensor of a DTensor, else ``t``."""
    return getattr(t, "_local_tensor", t)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _meta(t) -> list:
    return [list(t.shape), _dtype_name(t.dtype)]


def _encode(x):
    if isinstance(x, torch.Tensor):
        return ["T", list(x.shape), _dtype_name(x.dtype)]
    if isinstance(x, (list, tuple)):
        return [_encode(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.SymInt):
        return int(x)
    return str(x)


def _is_tensor_meta(x) -> bool:
    return isinstance(x, list) and len(x) == 3 and x[0] == "T"


def _tensor_metas(x):
    """Every ``["T", shape, dtype]`` in an encoded argument tree."""
    if _is_tensor_meta(x):
        yield x
    elif isinstance(x, list):
        for v in x:
            yield from _tensor_metas(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensor_metas(v)


def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _nbytes(shape, dtype) -> int:
    return _elems(shape) * _DTYPE_BYTES.get(dtype, 0)


def _shapes_only(x):
    """Encoded arguments with each tensor replaced by its ``torch.Size``
    (what ``torch.utils.flop_counter``'s functions read)."""
    if _is_tensor_meta(x):
        return torch.Size(x[1])
    if isinstance(x, list):
        return [_shapes_only(v) for v in x]
    if isinstance(x, dict):
        return {k: _shapes_only(v) for k, v in x.items()}
    return x


_KIND_CACHE: dict = {}


def _resolve(name: str):
    """The OpOverload of ``str(OpOverload)``, or None."""
    ns, _, rest = name.partition(".")
    op, _, overload = rest.rpartition(".")
    try:
        packet = getattr(getattr(torch.ops, ns), op)
        return getattr(packet, overload)
    except (AttributeError, RuntimeError):
        return None


def op_kind(name: str) -> str:
    """``free``, ``dot``, ``coll:<kind>``, ``gather``, ``scatter``,
    ``update``, ``elementwise``, ``reduce`` or ``move`` for an op name."""
    kind = _KIND_CACHE.get(name)
    if kind is not None:
        return kind
    from torch.utils.flop_counter import flop_registry

    ns, _, rest = name.partition(".")
    base = rest.rpartition(".")[0] or rest
    func = _resolve(name)
    tags = set(getattr(func, "tags", ()) or ())
    if ns == "prim":
        kind = "free"
    elif ns in COLL_NAMESPACES:
        kind = next(("coll:" + k for key, k in COLL_KINDS if key in base),
                    "free")
    elif base in FREE or (func is not None and func.is_view):
        kind = "free"
    elif func is not None and func.overloadpacket in flop_registry:
        kind = "dot"
    elif base == "copy_":
        kind = "update"
    elif base in GATHER:
        kind = "gather"
    elif base in SCATTER:
        kind = "scatter"
    elif base in MOVE:
        kind = "move"
    elif torch.Tag.pointwise in tags or base.startswith("_foreach_"):
        kind = "elementwise"
    elif torch.Tag.reduction in tags or base in REDUCE:
        kind = "reduce"
    else:
        kind = "move"
    _KIND_CACHE[name] = kind
    return kind


def _dot_flops(rec: OpRecord) -> float:
    from torch.utils.flop_counter import flop_registry

    func = _resolve(rec.name)
    outs = [torch.Size(s) for s, _ in rec.outs]
    out = outs[0] if len(outs) == 1 else tuple(outs)
    return float(flop_registry[func.overloadpacket](
        *_shapes_only(rec.args), **_shapes_only(rec.kwargs), out_val=out))


def op_cost(rec: OpRecord) -> Cost:
    """One op's cost by the module docstring's rules."""
    kind = op_kind(rec.name)
    c = Cost()
    if kind == "free":
        return c
    metas = list(_tensor_metas(rec.args)) + list(_tensor_metas(rec.kwargs))
    opb = sum(_nbytes(s, d) for _, s, d in metas)
    out_e = sum(_elems(s) for s, _ in rec.outs)
    outb = sum(_nbytes(s, d) for s, d in rec.outs)
    if kind.startswith("coll:"):
        c.coll_bytes = opb
        c.coll_by_kind = {kind[5:]: opb}
        c.bytes = c.bytes_fused = opb + outb
    elif kind == "dot":
        c.flops = _dot_flops(rec)
        c.bytes = c.bytes_fused = opb + outb
    elif kind == "update":
        src = metas[1] if len(metas) > 1 else metas[0]
        c.bytes = c.bytes_fused = 2 * _nbytes(src[1], src[2])
    elif kind in ("gather", "scatter"):
        idx = sum(_nbytes(s, d) for _, s, d in metas if d in _INDEX_DTYPES)
        c.bytes = c.bytes_fused = 2 * outb + idx
        if kind == "scatter":
            c.flops = out_e
    elif kind == "elementwise":
        c.flops = out_e
        c.bytes = opb + outb
    elif kind == "reduce":
        c.flops = opb / 4.0
        c.bytes = opb + outb
    else:
        c.bytes = opb + outb
    return c


def count(records) -> Cost:
    """The summed cost of a record (:class:`OpRecord` or its list form)."""
    total = Cost()
    for r in records:
        total += op_cost(r if isinstance(r, OpRecord)
                         else OpRecord.from_list(r))
    return total


def dot_flops(records) -> float:
    """The FLOPs of a record's products (the ``dot`` ops: ``mm``, ``bmm``
    and the others the flop counter knows), per device: over a mesh each
    rank's share, which times the ranks is a one-rank step's when no
    product is replicated (ROADMAP C.4)."""
    total = 0.0
    for r in records:
        r = r if isinstance(r, OpRecord) else OpRecord.from_list(r)
        if op_kind(r.name) == "dot":
            total += _dot_flops(r)
    return total


def collectives(records) -> list:
    """``(kind, operand bytes)`` of every collective in a record."""
    out = []
    for r in records:
        r = r if isinstance(r, OpRecord) else OpRecord.from_list(r)
        kind = op_kind(r.name)
        if kind.startswith("coll:"):
            out.append((kind[5:], sum(
                _nbytes(s, d) for _, s, d in
                list(_tensor_metas(r.args)) + list(_tensor_metas(r.kwargs)))))
    return out


class ModulePath:
    """The dotted path of the ``nn.Module`` whose forward is running (a
    root by its class name, a child by its attribute), from global
    forward hooks: ``torch.utils.module_tracker``'s hooks on tensors hold
    them in reference cycles, which the live bytes would count until a
    collection.  Ops of the backward outside every forward (a
    rematerialised forward runs its modules' hooks again) are
    ``(backward)``."""

    def __init__(self):
        self.stack: list = []
        self.names = weakref.WeakKeyDictionary()

    def _pre(self, mod, args):
        name = self.names.get(mod)
        if name is None:
            parent = self.stack[-1] if self.stack else None
            attr = None if parent is None else next(
                (k for k, m in parent[0]._modules.items() if m is mod), None)
            name = type(mod).__name__ if attr is None \
                else f"{parent[1]}.{attr}"
            self.names[mod] = name
        self.stack.append((mod, name))

    def _post(self, mod, args, out):
        if self.stack and self.stack[-1][0] is mod:
            self.stack.pop()

    def __enter__(self):
        from torch.nn.modules import module as nn_module

        self.handles = (
            nn_module.register_module_forward_pre_hook(self._pre),
            nn_module.register_module_forward_hook(self._post,
                                                   always_call=True))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.stack.clear()

    def path(self) -> str:
        if self.stack:
            return self.stack[-1][1]
        if torch._C._current_graph_task_id() != -1:
            return "(backward)"
        return ""


def _module_path(tracker) -> str:
    return "" if tracker is None else tracker.path()


class _Storages:
    """Live bytes of the storages ops return, by storage (weak references
    on the tensors that hold one)."""

    def __init__(self, args):
        self.refs: dict = {}
        self.nbytes: dict = {}
        self.args = set()
        self.live = self.peak = 0
        for t in args:
            key = self.key(t)
            if key is not None and key not in self.args:
                self.args.add(key)
                self.nbytes[key] = self.size(t)

    @staticmethod
    def key(t):
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError, AttributeError):
            return None

    @staticmethod
    def size(t) -> int:
        try:
            return int(t.untyped_storage().nbytes())
        except (RuntimeError, NotImplementedError):
            return t.numel() * t.element_size()

    def add(self, t) -> None:
        key = self.key(t)
        if key is None or key in self.args:
            return
        if key not in self.refs:
            self.refs[key] = 0
            self.nbytes[key] = self.size(t)
            self.live += self.nbytes[key]
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self.drop, key)

    def drop(self, key) -> None:
        n = self.refs.get(key)
        if n is None:
            return
        if n > 1:
            self.refs[key] = n - 1
            return
        del self.refs[key]
        self.live -= self.nbytes[key]

    def bytes_of(self, tensors, new_only: bool) -> int:
        seen, total = set(), 0
        for t in tensors:
            key = self.key(t)
            if key is None or key in seen:
                continue
            seen.add(key)
            if new_only and key in self.args:
                continue
            total += self.nbytes.get(key, self.size(t))
        return total


def _tensors(tree):
    """Every tensor in a tree of dicts, lists, tuples and modules (a
    module's parameters and buffers), local tensors of DTensors."""
    if isinstance(tree, torch.nn.Module):
        yield from (_local(t) for t in tree.parameters())
        yield from (_local(t) for t in tree.buffers())
    elif isinstance(tree, torch.Tensor):
        yield _local(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class CountingMode(TorchDispatchMode):
    """Records every op on plain tensors (module docstring) with the
    module ``tracker`` names; tracks in ``storages`` the live storages
    those ops return."""

    def __init__(self, storages: _Storages, tracker: ModulePath):
        super().__init__()
        self.records: list = []
        self.names: dict = {}       # OpOverload -> str(OpOverload)
        self.paused = 0
        self.storages = storages
        self.tracker = tracker
        self.dtensor = _dtensor_type()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.dtensor is not None and self.dtensor in types:
            # the global op: DTensor's own dispatch runs next, with this
            # mode still on the stack, and the local ops it runs come here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        name = self.names.get(func)
        if name is None:
            name = self.names[func] = str(func)
        if op_kind(name) != "free":
            self.records.append(OpRecord(
                name, _encode(list(args)),
                {k: _encode(v) for k, v in kwargs.items()},
                [_meta(t) for t in outs], self.tracker.path()))
        for t in outs:              # views too: they hold their storage
            self.storages.add(t)
        return out


# DTensor's bookkeeping on plain tensors, which runs on no device: the
# global op's output shapes (sharding propagation, on fake tensors) — not
# counted — and a strided shard's local size from an arange, which reads
# the values (``.tolist()``) and so runs outside every mode, the fake one
# too.  Each (module, class, method) is wrapped where it exists.
_UNCOUNTED = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta"),
)
_NO_MODES = (
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
)


def _wrapped(table, wrap):
    """[(class, name, original)] for every entry of ``table`` that exists,
    each replaced by ``wrap(original)``."""
    import importlib

    done = []
    for mod, cls, name in table:
        try:
            owner = getattr(importlib.import_module(mod), cls)
        except (ImportError, AttributeError):
            continue
        orig = owner.__dict__.get(name)
        if orig is None:
            continue
        fn = orig.__func__ if isinstance(orig, (staticmethod, classmethod)) \
            else orig
        new = wrap(fn)
        if isinstance(orig, staticmethod):
            new = staticmethod(new)
        elif isinstance(orig, classmethod):
            new = classmethod(new)
        setattr(owner, name, new)
        done.append((owner, name, orig))
    return done


@contextlib.contextmanager
def _dtensor_internals(mode: "CountingMode"):
    """DTensor's bookkeeping (:data:`_UNCOUNTED`, :data:`_NO_MODES`) kept out
    of ``mode``'s record while it is active."""
    from torch.utils._python_dispatch import _disable_current_modes

    def pause(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            mode.paused += 1
            try:
                return fn(*a, **k)
            finally:
                mode.paused -= 1
        return inner

    def no_modes(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with _disable_current_modes():
                return fn(*a, **k)
        return inner

    done = _wrapped(_UNCOUNTED, pause) + _wrapped(_NO_MODES, no_modes)
    try:
        yield
    finally:
        for owner, name, orig in reversed(done):
            setattr(owner, name, orig)


@dataclasses.dataclass
class Counted:
    """What :func:`run` returns: the call's result, its :class:`Cost`, its
    op record and its :class:`Memory`."""

    result: object
    cost: Cost
    records: list
    memory: Memory


def run(fn, *args, **kwargs) -> Counted:
    """Runs ``fn(*args, **kwargs)`` once under :class:`CountingMode`."""
    arg_tensors = list(_tensors((args, kwargs)))
    storages = _Storages(arg_tensors)
    tracker = ModulePath()
    mode = CountingMode(storages, tracker)
    with tracker, _dtensor_internals(mode), mode:
        result = fn(*args, **kwargs)
    outs = list(_tensors(result))
    memory = Memory(
        argument_bytes=storages.bytes_of(arg_tensors, new_only=False),
        output_bytes=storages.bytes_of(outs, new_only=False),
        peak_new_bytes=storages.peak,
        output_new_bytes=storages.bytes_of(outs, new_only=True))
    return Counted(result, count(mode.records), mode.records, memory)


def analyze(fn, *args, **kwargs) -> Cost:
    """The per-device :class:`Cost` of ``fn(*args, **kwargs)``, run once."""
    return run(fn, *args, **kwargs).cost


# ---------------------------------------------------------------------------
# attribution: where do the flops/bytes go? (the dry-run "profile")
# ---------------------------------------------------------------------------

def attribute(records, *args, depth: int = 4, top_k: int = 20,
              **kwargs) -> list:
    """Group a record's flops/bytes by ``nn.Module`` path prefix (``depth``
    dotted components).  ``records`` is an op record, or a function that
    :func:`run` calls with ``args`` and ``kwargs`` to make one.

    Returns [(tag, flops, bytes)] sorted by the seconds they would take at
    the card's figures (``flops / PEAK_FLOPS_BF16 + bytes / HBM_BW``).
    Backward ops are ``(backward)`` (:class:`ModulePath`); ops outside
    every module are ``(no-module)``."""
    if callable(records):
        records = run(records, *args, **kwargs).records
    buckets: dict[str, list] = {}
    for r in records:
        r = r if isinstance(r, OpRecord) else OpRecord.from_list(r)
        if op_kind(r.name) == "free":
            continue
        tag = ".".join(r.module.split(".")[:depth]) if r.module \
            else "(no-module)"
        c = op_cost(r)
        b = buckets.setdefault(tag, [0.0, 0.0])
        b[0] += c.flops
        b[1] += c.bytes
    rows = [(k, v[0], v[1]) for k, v in buckets.items()]
    rows.sort(key=lambda r: -(r[1] / hw.PEAK_FLOPS_BF16 + r[2] / hw.HBM_BW))
    return rows[:top_k]
