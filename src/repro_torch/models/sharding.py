"""Sharding rules: logical -> mesh axis mapping for parameters, optimizer
state and activations — counterpart of ``repro/models/sharding.py``.

The reference hands its ``PartitionSpec`` trees to GSPMD.  Here a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
(``launch/mesh.py``), a spec :class:`P` becomes a DTensor placement list
(:func:`placements`: a mesh dim gets ``Shard(i)`` where the spec names its
axis at tensor dim i, ``Replicate()`` elsewhere; a tuple entry such as
``("pod", "data")`` shards dim i over both mesh dims, major first, as jax
does), and every ``nn.Parameter`` of a distributed model holds a DTensor
with those placements (:func:`distribute_model_`).  Activations are
DTensors too: the ops between them follow DTensor's sharding rules, and
:func:`cns` — the reference's ``with_sharding_constraint`` — redistributes
one to the spec's placements.  The work GSPMD partitions runs on each
rank's local shard instead, so that no rank computes what another does
(ROADMAP C.4): the products (:func:`linear`: data, column and row
parallel, the gradients placed by hand), attention and the RWKV loop
(each rank's batch rows and heads, :func:`batch_heads`) and the loss's
:func:`logsumexp` and :func:`gather_last` (each rank's vocab shard).  A
contextvar carries ``(mesh, rules)`` so layer code can call :func:`cns`
plainly; without a mesh, or on a plain tensor, it returns its input.

Heads that do not divide the model axis keep their shards, as GSPMD's
padding keeps the reference's: an attention weight whose spec splits its
heads' dim (``wq``/``wk``/``wv``'s columns, ``wo``'s rows) over the model
axis, which ``n`` heads do not divide, holds on each rank the whole heads
of ``head_chunk`` — ``ceil(n / ranks)``, the last ranks fewer or none —
where DTensor's own split of the flat ``n·d`` dim would cut a head
(:func:`head_split`).  Such a tensor (the parameter, its moments, its
gradient) keeps its placements, with a local shard of whole heads; it is
tagged (:func:`heads_of`), made (:func:`distribute_as`, :func:`own_shard`,
:func:`zeros`, :func:`parameter`) and gathered (:func:`full`) by that
split, and its products (:func:`heads_in`, :func:`heads_out`) give and
take activations split on their heads dim, which DTensor splits the same
way.  A new tensor computed from a tagged one carries no tag: where it
is kept (a top-k residual) :func:`keep_heads` tags it again, and
:func:`shard_box` and :func:`full` raise on a DTensor whose local shard
is not the one its placements (and tag) say, rather than gather or cut
it by the wrong split.

Rules:
  dp axes  = ("pod", "data") when present — batch parallel
  tp axis  = "model"          — heads / ffn / vocab / experts
  fsdp     = params (and optimizer state) additionally sharded over "data"

The reference stacks each ``cycles`` leaf (and an encoder-decoder's
``encoder``/``decoder`` leaves) as ``[n_stack, ...]``; the port keeps one
tensor a cycle (``model_zoo``), so a member's spec is the reference
leaf's spec without its leading stack entry (:func:`member_spec`).  The
rules leave that entry None, except at the experts of a stacked MoE leaf,
whose reference spec is written for ``[E, D, F]`` and lands on the stack
axis: a member takes the intended ``P(tp, f, None)`` (``wo``: ``P(tp,
None, f)``) — ROADMAP.md C, known defects of the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from contextvars import ContextVar
from typing import Optional

import torch


class P(tuple):
    """A partition spec: one entry a tensor dim, each None (replicated), a
    mesh axis name, or a tuple of names (sharded over all of them, major
    first).  Trailing dims past the spec are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    fsdp: bool = True                 # shard params over dp_axes[-1]
    zero1: bool = True                # shard optimizer state over dp

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def fsdp_axis(self) -> Optional[str]:
        return self.dp_axes[-1] if self.fsdp else None


_CTX: ContextVar[Optional[tuple]] = ContextVar("mesh_rules", default=None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Rules):
    """Set ``(mesh, rules)`` for :func:`cns`.  With a mesh, plain tensors
    that meet DTensors inside count as replicated (DTensor's
    ``implicit_replication``): positions, masks and index tensors, which
    every rank builds alike."""
    tok = _CTX.set((mesh, rules) if mesh is not None else None)
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _CTX.reset(tok)


def current() -> Optional[tuple]:
    return _CTX.get()


def remat(fn, *args):
    """``torch.utils.checkpoint.checkpoint(fn, *args)`` (non-reentrant)
    with its recompute under the forward's :func:`use_mesh` context:
    autograd runs a CUDA backward on a thread of its own, where the
    context variable is unset, so that the recompute's :func:`cns` would
    do nothing and its tensors would not be placed as the forward's."""
    from torch.utils.checkpoint import checkpoint

    ctx = _CTX.get()

    @contextlib.contextmanager
    def recompute():
        # the context variable only: implicit replication is a global flag
        # that the backward's caller holds, and use_mesh would clear it
        tok = _CTX.set(ctx)
        try:
            yield
        finally:
            _CTX.reset(tok)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recompute()))


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh, or of any object whose
    ``.shape`` is such a dict (jax's meshes, abstract ones included)."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        return dict(_device_mesh_shape(mesh))
    return dict(mesh.shape)


@functools.lru_cache(maxsize=64)
def _device_mesh_shape(mesh) -> tuple:
    # a DeviceMesh computes its shape anew at every call
    return tuple(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axes, str):
        return shape[axes]
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sanitize_spec(spec, shape, mesh) -> P:
    """Make a spec legal for this mesh: drop axes the mesh doesn't have and
    axes whose size doesn't divide the dim (such a dim is replicated, never
    sharded unevenly, as the reference does)."""
    names = mesh_shape(mesh)
    out = []
    for i, s in enumerate(spec):
        if s is None or i >= len(shape):
            out.append(None if i >= len(shape) else s)
            continue
        axes = tuple(a for a in _names(s) if a in names)
        if not axes:
            out.append(None)
            continue
        s2 = axes[0] if len(axes) == 1 else axes
        out.append(None if shape[i] % axis_size(mesh, s2) != 0 else s2)
    return P(*out)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that entry i names, ``Replicate()`` on the others and on a
    mesh dim of size 1 (one shard is the whole tensor; DTensor refuses
    some views of a dim sharded even one way).  A tuple entry must list
    its axes in the mesh's order (major first)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    out = [Replicate() for _ in dims]
    named = set()
    for i, s in enumerate(spec):
        idx = [dims.index(a) for a in _names(s)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {s!r} is not in the mesh's axis "
                             f"order {tuple(dims)}")
        for d in idx:
            if d in named:
                raise ValueError(f"mesh axis {dims[d]!r} named twice in "
                                 f"{spec!r}")
            named.add(d)
            if sizes[dims[d]] > 1:
                out[d] = Shard(i)
    return out


@functools.lru_cache(maxsize=4096)
def _placements_of(spec: P, shape: tuple, mesh) -> tuple:
    # cns's placements, computed once for each (spec, shape, mesh)
    return tuple(placements(sanitize_spec(spec, shape, mesh), mesh))


def moved(x, pl, mesh=None):
    """The DTensor ``x`` redistributed to the placements ``pl`` on
    ``mesh`` (its own when None); ``x`` itself when it is placed so
    already (a redistribute costs the host even when it moves nothing)."""
    mesh = x.device_mesh if mesh is None else mesh
    if tuple(x.placements) == tuple(pl) and (x.device_mesh is mesh
                                             or x.device_mesh == mesh):
        return x
    return x.redistribute(mesh, pl)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def cns(x, *spec):
    """Constrain an activation's sharding: redistribute a DTensor to the
    spec's placements, divisibility-sanitized against the current mesh,
    except on the heads dim of a ``[B, S, H, dh]`` activation (dim 2 of a
    4-d tensor): a split of the heads that the spec asks for and ``x``
    already has stays where the sanitizer would replicate it (heads that
    do not divide the axis, split as DTensor splits them: GSPMD pads
    them).  On every other dim an uneven split is replicated, as before.
    A no-op without a mesh context or on a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, _ = ctx
    spec = P(*spec)
    pl = list(_placements_of(spec, tuple(x.shape), mesh))
    if x.dim() == 4 and len(spec) > 2:
        names = mesh.mesh_dim_names
        for d, (want, have) in enumerate(zip(pl, x.placements)):
            if (want.is_replicate() and have.is_shard(2)
                    and names[d] in _names(spec[2])):
                pl[d] = have
    return moved(x, pl, mesh)


def distribute(x: torch.Tensor, spec, mesh=None, heads=None):
    """A plain tensor, the same on every rank, as a DTensor on ``mesh``
    (the context's when None) placed by ``spec`` (sanitized): each rank
    keeps its own shard, no data moves; split by whole heads where
    ``heads`` says so (:func:`distribute_as`)."""
    mesh = mesh if mesh is not None else _CTX.get()[0]
    sp = sanitize_spec(spec, x.shape, mesh)
    return distribute_as(x, placements(sp, mesh), mesh, heads)


def contiguous_stride(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()


def heads_of(x) -> Optional[tuple[int, int]]:
    """``(tensor dim, heads)`` of a DTensor whose shard on the model axis
    holds whole heads (module docstring; :func:`head_split`), else
    None."""
    return getattr(x, "_heads_split", None)


def _tagged(x, heads):
    if heads is not None:
        x._heads_split = heads
    return x


def keep_heads(x, ref):
    """``x``, a tensor computed from ``ref`` and laid out as it is, tagged
    with ``ref``'s split by whole heads (:func:`heads_of`) if it has one:
    a new tensor carries no tag, and one that is kept and later gathered
    must (a top-k residual, a cast weight)."""
    return _tagged(x, heads_of(ref))


def parameter(x, requires_grad: bool = True):
    """``nn.Parameter(x)`` that keeps ``x``'s split by whole heads."""
    return keep_heads(torch.nn.Parameter(x, requires_grad=requires_grad), x)


def head_split(pl, mesh, rules: "Rules", dim: int,
               n: int) -> Optional[tuple[int, int]]:
    """``(dim, n)`` when the placements ``pl`` split tensor dim ``dim``,
    the flat dim of ``n`` heads, over the model axis alone and ``n`` is
    not a multiple of its ranks: such a tensor is split by whole heads
    (module docstring).  None otherwise: an even split already falls on
    whole heads."""
    names = list(mesh.mesh_dim_names)
    if rules.tp_axis not in names:
        return None
    md = names.index(rules.tp_axis)
    m = mesh.size(md)
    if (m == 1 or not pl[md].is_shard(dim) or n % m == 0
            or any(p.is_shard(dim) for i, p in enumerate(pl) if i != md)):
        return None
    return dim, n


def _head_dim(pl, heads) -> int:
    """The mesh dim that splits a head-split tensor's heads."""
    return next(i for i, p in enumerate(pl) if p.is_shard(heads[0]))


def _head_span(heads, size: int, mesh, md: int) -> tuple[int, int]:
    """This rank's ``(offset, size)`` along a dim of ``size`` holding
    ``heads[1]`` heads, split by whole heads over mesh dim ``md``."""
    n = heads[1]
    unit = size // n
    first, count = head_chunk(n, mesh, md)
    return first * unit, count * unit


def _chunk_span(size: int, ranks: int, i: int) -> tuple[int, int]:
    """Rank ``i``'s ``(offset, size)`` of ``size`` split ``ranks`` ways as
    DTensor splits it (``torch.chunk``: ``ceil(size / ranks)`` a rank,
    the last ranks fewer or none)."""
    c = -(-size // ranks)
    off = min(i * c, size)
    return off, min(c, size - off)


def distribute_as(x: torch.Tensor, pl, mesh, heads=None):
    """:func:`distribute` by a placement list; with ``heads`` (``(dim,
    n)``, :func:`head_split`) the model axis's split of ``dim`` gives each
    rank its whole heads."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    if heads is None:
        return distribute_tensor(x, mesh, pl, src_data_rank=None)
    md = _head_dim(pl, heads)
    pl0 = list(pl)
    pl0[md] = Replicate()
    local = distribute_tensor(x, mesh, pl0, src_data_rank=None).to_local()
    off, size = _head_span(heads, x.shape[heads[0]], mesh, md)
    local = local.narrow(heads[0], off, size).contiguous()
    return _tagged(DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=x.shape,
                                      stride=contiguous_stride(x.shape)),
                   heads)


def own_shard(x: torch.Tensor, pl, mesh, heads=None):
    """:func:`distribute_as`, the local shard a tensor of its own: a split
    shard that is a view of ``x`` is copied, so that freeing ``x`` frees
    its memory."""
    from torch.distributed.tensor import DTensor

    d = distribute_as(x, pl, mesh, heads)
    local = d.to_local()
    if local.numel() == x.numel():
        return d
    return _tagged(DTensor.from_local(local.clone(), mesh, d.placements,
                                      run_check=False, shape=d.shape,
                                      stride=d.stride()), heads)


def zeros(shape, pl, mesh, device, heads=None) -> torch.Tensor:
    """A float32 DTensor of zeros of ``shape`` placed ``pl`` on ``mesh``:
    each rank makes its own shard on ``device`` and nothing else (the
    splits must be even, as :func:`sanitize_spec` makes them, or by whole
    heads where ``heads`` says so)."""
    from torch.distributed.tensor import DTensor

    local = list(shape)
    for d, p in enumerate(pl):
        if heads is not None and p.is_shard(heads[0]):
            local[p.dim] = _head_span(heads, shape[p.dim], mesh, d)[1]
        elif p.is_shard():
            local[p.dim] //= mesh.size(d)
    return _tagged(DTensor.from_local(
        torch.zeros(local, dtype=torch.float32, device=device), mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape)),
        heads)


def gathered(x):
    """A DTensor replicated on every mesh dim (differentiable: the gradient
    goes back to the shards, reduced where it is partial); a plain tensor
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return moved(x, [Replicate()] * x.device_mesh.ndim)


def batch_heads(x) -> list:
    """The placements of ``x [B, S, H, Dh]`` with every split replicated
    but those of the batch and the heads: the split that attention and
    the RWKV loop run on, each rank on its own rows and heads."""
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in x.placements]


def linear(x: torch.Tensor, w: torch.Tensor,
           unflatten=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``, or for stacked experts ``x [E, ..., K] @
    w [E, K, N]``, over a mesh on each rank's own share.  On each mesh
    dim: where ``w``'s or ``x``'s expert dim E is split, both are split
    alike and each rank runs its experts; where ``x`` is split on a batch
    dim, ``w`` is gathered there (data parallel; FSDP's all-gather, its
    gradient reduce-scattered); else where ``w`` splits its columns, the
    output is split on its last dim (column parallel); where ``x`` or
    ``w`` splits the contraction, each rank takes its slice of the other
    and the output is a partial sum (row parallel).  The product runs on
    the local tensors (:func:`matmul`) with the gradients' placements
    given by hand (``to_local(grad_placements=...)``), so that neither
    the forward nor the backward runs a product on a gathered operand, as
    DTensor's own propagation did (ROADMAP C.4).  With ``unflatten`` ``(n,
    d)`` the output's last dim is unflattened to ``[n, d]`` shard by shard
    (:func:`heads_in`).  Plain tensors: :func:`matmul`."""
    if not is_dtensor(x) and not is_dtensor(w):
        return matmul(x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = x if is_dtensor(x) else like(x, w)
    w = w if is_dtensor(w) else like(w, x)
    mesh, last, wk = x.device_mesh, x.dim() - 1, w.dim() - 2
    xpl = [Replicate() if p.is_partial() else p for p in x.placements]
    expert = [w.dim() == 3 and (a.is_shard(0) or b.is_shard(0))
              for a, b in zip(xpl, w.placements)]
    xpl = [Shard(0) if e else p for e, p in zip(expert, xpl)]
    batch = [not e and p.is_shard() and p.dim != last
             for e, p in zip(expert, xpl)]
    sx = {i for i, p in enumerate(xpl) if p.is_shard(last)}
    sw = {i for i, p in enumerate(w.placements)
          if p.is_shard(wk) and not batch[i] and not expert[i]}
    if sx and sw and sx != sw:
        # the two split the contraction differently: x whole there
        xpl = [Replicate() if i in sx else p for i, p in enumerate(xpl)]
        sx = set()
    wpl, out, xg, wg = [], [], [], []
    for i, (a, b) in enumerate(zip(xpl, w.placements)):
        if expert[i]:                     # each rank its own experts
            wpl.append(Shard(0))
            out.append(a)
            xg.append(a)
            wg.append(Shard(0))
        elif batch[i]:                    # data parallel: w whole here
            wpl.append(Replicate())
            out.append(a)
            xg.append(a)
            wg.append(Partial())
        elif i in sx or i in sw:          # the contraction split
            wpl.append(b if i in sw else Replicate())
            out.append(Partial())
            xg.append(a if i in sx else Partial())
            wg.append(b if i in sw else Partial())
        elif b.is_shard(wk + 1):          # column parallel
            wpl.append(b)
            out.append(Shard(last))
            xg.append(Partial())
            wg.append(b)
        else:
            wpl.append(Replicate())
            out.append(Replicate())
            xg.append(Replicate())
            wg.append(Replicate())
    x, w = moved(x, xpl, mesh), moved(w, wpl, mesh)
    xl = x.to_local(grad_placements=xg)
    wl = w.to_local(grad_placements=wg)
    if sx and not sw:                     # w's rows to x's columns
        wl = wl.narrow(wk, shard_box(x)[0][last], xl.shape[-1])
    elif sw and not sx:                   # x's columns to w's rows
        xl = xl.narrow(last, shard_box(w)[0][wk], wl.shape[wk])
    if unflatten is None:
        return DTensor.from_local(matmul(xl, wl), mesh, out, run_check=False)
    n, d = unflatten
    y = matmul(xl, wl)
    y = y.reshape(*y.shape[:-1], y.shape[-1] // d, d)
    shape = (*x.shape[:-1], n, d)
    return DTensor.from_local(y, mesh, out, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def heads_in(x: torch.Tensor, w: torch.Tensor, n: int,
             d: int) -> torch.Tensor:
    """``x [..., K] @ w [K, n·d]`` as ``[..., n, d]``, in ``x``'s dtype
    (``w`` a parameter: a float32 master).  Where ``w`` is split by whole
    heads over the model axis (:func:`heads_of`) the product is column
    parallel on each rank's heads and its result a DTensor split on the
    heads dim, as DTensor splits ``n`` heads; else
    :func:`split_heads` of :func:`linear`."""
    wc = keep_heads(w.to(x.dtype), w)
    if heads_of(w) is None or not is_dtensor(w):
        return split_heads(linear(x, wc), n, d)
    return linear(x, wc, unflatten=(n, d))


def heads_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``o [..., n, d]`` merged ``@ w [n·d, N]``, in ``o``'s dtype.  Where
    ``w``'s rows are split by whole heads, ``o`` is split on its heads as
    they are (a free narrow where ``o`` is whole there) and the product is
    row parallel on each rank's heads: a partial sum, reduced where the
    next op needs it whole.  Else :func:`linear` of :func:`merge_heads`."""
    wc = keep_heads(w.to(o.dtype), w)
    heads = heads_of(w)
    if heads is None:
        return linear(merge_heads(o), wc)
    from torch.distributed.tensor import DTensor, Shard

    o = o if is_dtensor(o) else like(o, w)
    hd = o.dim() - 2
    pl = list(o.placements)
    pl[_head_dim(w.placements, heads)] = Shard(hd)
    local = moved(o, pl).to_local()
    shape = (*o.shape[:-2], o.shape[-2] * o.shape[-1])
    of = DTensor.from_local(local.reshape(*local.shape[:-2], -1),
                            o.device_mesh, pl, run_check=False,
                            shape=torch.Size(shape),
                            stride=contiguous_stride(shape))
    return linear(_tagged(of, (len(shape) - 1, heads[1])), wc)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``.  On a DTensor split along its last dim
    (a vocab's logits) each rank reduces its own shard: a detached local
    max, its MAX over the mesh dims that split the dim, then the local
    sum of ``exp(x - m)`` as a partial sum reduced over those dims, and
    ``m + log(sum)``; the gradient is the local softmax.  Elsewhere
    ``torch.logsumexp`` itself, so that a one-rank mesh computes the
    mesh-free loss bit for bit."""
    last = x.dim() - 1
    if not is_dtensor(x) or not any(p.is_shard(last) for p in x.placements):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = moved(x, pl, mesh)
    split = [p.is_shard(last) for p in pl]
    out_pl = [Replicate() if s else p for s, p in zip(split, pl)]

    def reduced(t, op):
        t = DTensor.from_local(t, mesh, [Partial(op) if s else p for s, p
                                         in zip(split, out_pl)],
                               run_check=False)
        return moved(t, out_pl, mesh).to_local()

    xl = x.to_local()
    m = reduced(xl.detach().amax(dim=-1), "max")
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    s = reduced(torch.exp(xl - m[..., None]).sum(dim=-1), "sum")
    return DTensor.from_local(m + torch.log(s), mesh, out_pl,
                              run_check=False)


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`linear` of compute-dtype operands with a float32 result, for
    the products whose result the reference casts to float32 at once (the
    router's logits, the RG-LRU gates, RWKV6's decay LoRA, the loss's
    logits).  Jitted into its train step, XLA folds such a cast into the
    product, which then sums its exact partial products in float32 and is
    never rounded to the compute dtype (ROADMAP C.9: rounding the RG-LRU
    gates first moved recurrentgemma's bfloat16 train state 0.15 of a
    second moment's scale from the reference's).  Float32 copies of the
    operands do the same here (a product of two bfloat16 values is exact
    in float32).  In float32 this is :func:`linear` itself."""
    return linear(x.float(), w.float())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as ``mm`` or ``bmm`` on the batch dims broadcast and
    flattened: over a mesh DTensor (torch 2.11) propagates
    ``aten.matmul``'s sharding afresh at every call, an ``mm``'s or
    ``bmm``'s once.  Without a mesh too, so that a mesh of one rank runs
    the same GEMMs as none."""
    if b.dim() == 2:                      # a's rows counted: K may be 0
        return torch.mm(a.reshape(a.shape[:-1].numel(), a.shape[-1]),
                        b).reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    n = batch.numel()                     # 0 too (a rank without heads)
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(n, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(n, *b.shape[-2:])
    return torch.bmm(a3, b3).reshape(*batch, a.shape[-2], b.shape[-1])


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``x [..., n·d]`` as ``[..., n, d]``.  DTensor cannot unflatten a
    dim sharded over more ranks than ``n`` divides into, so such a
    DTensor is replicated on that dim first.  The projections of heads
    that do not divide the model axis keep their shards instead
    (:func:`heads_in`); this replication is left where a head split does
    not apply: the kv heads of grouped attention (their query heads'
    ranks share them: attention slices its own, ``layers._local_heads``),
    RWKV's r, k, v and decay (its loop splits them itself: a head's value
    columns, or ``head_chunk``'s heads, ``rwkv6.wkv``), and a projection
    that the rules replicate on that axis (its flat width not divisible):
    attention and the RWKV loop then split the heads there themselves
    (:func:`whole_heads_dim`, :func:`head_chunk`), as GSPMD pads them,
    and return a partial sum of zero-padded blocks (:func:`spread`)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        last, mesh = x.dim() - 1, x.device_mesh
        ways = 1
        for i, pl in enumerate(x.placements):
            ways *= mesh.size(i) if pl.is_shard(last) else 1
        if n % ways:
            x = x.redistribute(mesh, [Replicate() if pl.is_shard(last)
                                      else pl for pl in x.placements])
    return x.reshape(*x.shape[:-1], n, d)


def whole_heads_dim(x) -> Optional[int]:
    """The mesh dim of the context's model axis (``Rules.tp_axis``) when
    it has more than one rank and the DTensor ``x`` is whole there, else
    None: the heads of such an ``x`` did not divide the axis
    (:func:`split_heads`), and its consumer splits them there by
    :func:`head_chunk`."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return None
    names = x.device_mesh.mesh_dim_names
    if ctx[1].tp_axis not in names:
        return None
    d = names.index(ctx[1].tp_axis)
    if x.device_mesh.size(d) == 1 or not x.placements[d].is_replicate():
        return None
    return d


def head_chunk(n: int, mesh, dim: int) -> tuple[int, int]:
    """This rank's share ``(first, count)`` of ``n`` heads over mesh dim
    ``dim``, as ``torch.chunk`` splits them: ``ceil(n / ranks)`` a rank,
    the last ranks fewer or none.  GSPMD pads the heads to that count;
    here a rank computes only the real heads of its chunk."""
    ranks = mesh.size(dim)
    c = -(-n // ranks)
    first = min(mesh.get_coordinate()[dim] * c, n)
    return first, min(c, n - first)


def spread(local: torch.Tensor, box: dict, mesh, pl, dim: int):
    """The DTensor of which ``local`` is one rank's block: ``box`` maps a
    tensor dim to ``(offset, size)`` of the block in a tensor of that
    size there; the block is zero-padded to it and taken as a partial sum
    over mesh dim ``dim`` (each rank's block in its place, zeros
    elsewhere), placed ``pl`` on the other mesh dims."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial

    pad = []
    for i in reversed(range(local.dim())):
        off, size = box.get(i, (0, local.shape[i]))
        pad += [off, size - off - local.shape[i]]
    pl = list(pl)
    pl[dim] = Partial()
    return DTensor.from_local(F.pad(local, pad), mesh, pl, run_check=False)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n, d]`` as ``[..., n·d]``, the inverse of
    :func:`split_heads`.  A DTensor is reshaped shard by shard (a split of
    the heads is the same split of the merged dim; a split of ``d`` is
    gathered first), with no view for DTensor to propagate."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], -1)
    from torch.distributed.tensor import DTensor, Replicate

    last = x.dim() - 1
    pl = [Replicate() if p.is_shard(last) or p.is_partial() else p
          for p in x.placements]
    local = moved(x, pl).to_local()
    return DTensor.from_local(local.reshape(*local.shape[:-2], -1),
                              x.device_mesh, pl, run_check=False)


def like(x: torch.Tensor, ref):
    """A plain tensor ``x``, equal on every rank, as a replicated DTensor
    on ``ref``'s mesh when ``ref`` is a DTensor; else ``x``."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def full(x: torch.Tensor, heads=None) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on every rank (gathered;
    differentiable: the gradient goes back to the shards); a plain tensor
    as it is.  A tensor split by whole heads (``heads``, else its tag:
    :func:`heads_of`) is gathered as the split DTensor makes of its
    shards padded to ``ceil(n / ranks)`` heads each, then cut to its
    size."""
    if not is_dtensor(x):
        return x
    heads = heads if heads is not None else heads_of(x)
    if heads is None:
        shard_box(x)                      # raises on a lost tag
        return x.full_tensor()
    from torch.distributed.tensor import DTensor

    dim, n = heads
    mesh = x.device_mesh
    ranks = mesh.size(_head_dim(x.placements, heads))
    unit = x.shape[dim] // n
    local = x.to_local()
    pad = list(local.shape)
    pad[dim] = -(-n // ranks) * unit - local.shape[dim]
    local = torch.cat([local, local.new_zeros(pad)], dim=dim)
    shape = list(x.shape)
    shape[dim] = -(-n // ranks) * unit * ranks
    whole = DTensor.from_local(local, mesh, x.placements, run_check=False,
                               shape=torch.Size(shape),
                               stride=contiguous_stride(shape)).full_tensor()
    return whole.narrow(dim, 0, x.shape[dim])


def placed_as(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` in ``ref``'s placements when both are DTensors."""
    if is_dtensor(x) and is_dtensor(ref):
        return moved(x, ref.placements, ref.device_mesh)
    return x


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx[..., None])[..., 0]``.  On a DTensor ``x``
    each rank reads the ids that fall in its slice of the last dim and the
    hits are summed over the mesh dims that shard that dim (one term a
    position is not zero: exact).  A gather on the DTensor would read the
    last dim whole on every rank, and its backward zero a tensor of the
    global shape there (a vocab's logits: ROADMAP C.2)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    last, mesh = x.dim() - 1, x.device_mesh
    idx_pl = [p if p.is_shard() and p.dim != last else Replicate()
              for p in x.placements]
    idx = (moved(idx, idx_pl, mesh) if is_dtensor(idx)
           else distribute_as(idx, idx_pl, mesh))
    off, size = shard_box(x)
    lo, n = off[last], size[last]
    rel = idx.to_local() - lo
    hit = torch.gather(x.to_local(), -1,
                       rel.clamp(0, n - 1)[..., None])[..., 0]
    hit = torch.where((rel >= 0) & (rel < n), hit,
                      torch.zeros((), dtype=hit.dtype, device=hit.device))
    out_pl = [Partial() if p.is_shard() and p.dim == last else q
              for p, q in zip(x.placements, idx_pl)]
    return DTensor.from_local(hit, mesh, out_pl, run_check=False)


def shard_box(x) -> tuple[list, list]:
    """This rank's shard of the DTensor ``x``: its offset and its size
    along each tensor dim, split as DTensor splits it (``torch.chunk``:
    an uneven split gives the last ranks less or nothing), or by whole
    heads where ``x`` is so split (:func:`heads_of`); a tensor dim
    sharded over several mesh dims is split in the mesh's order, major
    first.  Raises ValueError where ``x``'s local shard has another
    shape: a tensor split by whole heads that lost its tag."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    heads = heads_of(x)
    off, size = [0] * x.dim(), list(x.shape)
    for md, pl in enumerate(x.placements):
        if not pl.is_shard():
            continue
        if heads is not None and pl.dim == heads[0]:
            o, n = _head_span(heads, x.shape[pl.dim], mesh, md)
        else:
            o, n = _chunk_span(size[pl.dim], mesh.size(md), coord[md])
        off[pl.dim] += o
        size[pl.dim] = n
    if list(x._local_tensor.shape) != size:
        raise ValueError(
            f"a local shard of {list(x._local_tensor.shape)} where "
            f"{list(x.placements)} (heads {heads}) of {list(x.shape)} give "
            f"{size}: a tensor split by whole heads lost its tag")
    return off, size


def _local_value(buf, value, dims):
    """This rank's part of ``value`` for a write into the DTensor ``buf``:
    ``value``'s dim j is ``buf``'s dim ``dims[j]``; ``value`` is placed as
    ``buf`` on those dims, except ``buf``'s sequence dim 1, which it keeps
    whole (a rank picks the positions it holds)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [Shard(dims.index(p.dim)) if p.is_shard() and p.dim != 1
          else Replicate() for p in buf.placements]
    if not is_dtensor(value):
        value = like(value, buf)
    return moved(value, pl, buf.device_mesh).to_local()


def write_span_(buf: torch.Tensor, start: int, value) -> torch.Tensor:
    """``buf[:, start:start + n] = value`` in place, ``value [B, n, ...]``
    (a cache's prefill write).  A DTensor ``buf`` is written shard by
    shard: each rank copies the positions of its own sequence slice into
    its local tensor, and no rank gathers the cache.  Returns ``buf``."""
    n = value.shape[1]
    if not is_dtensor(buf):
        buf[:, start:start + n] = value
        return buf
    local = _local_value(buf, value, tuple(range(buf.dim())))
    off, size = shard_box(buf)
    lo, hi = max(start, off[1]), min(start + n, off[1] + size[1])
    if lo < hi:
        buf.to_local()[:, lo - off[1]:hi - off[1]] = \
            local[:, lo - start:hi - start]
    return buf


def write_slots_(buf: torch.Tensor, slot: torch.Tensor,
                 value) -> torch.Tensor:
    """``buf[b, slot[b]] = value[b]`` in place for every row b, ``slot
    [B]`` (a cache's decode write).  A DTensor ``buf`` is written shard by
    shard: each rank writes its own rows, and under a sequence split only
    the slots it holds (a masked write: no host sync).  Returns ``buf``."""
    if not is_dtensor(buf):
        buf[torch.arange(buf.shape[0], device=slot.device), slot] = value
        return buf
    local = _local_value(buf, value, (0,) + tuple(range(2, buf.dim())))
    off, size = shard_box(buf)
    lbuf = buf.to_local()
    rows = torch.arange(size[0], device=slot.device)
    idx = slot[off[0]:off[0] + size[0]] - off[1]
    if size[1] == buf.shape[1]:
        lbuf[rows, idx] = local
        return buf
    held = ((idx >= 0) & (idx < size[1])).reshape(-1, *[1] * (local.dim()
                                                               - 1))
    idx = idx.clamp(0, size[1] - 1)
    lbuf[rows, idx] = torch.where(held, local, lbuf[rows, idx])
    return buf


def assign_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``, a DTensor ``src`` first redistributed to
    ``dst``'s placements (an in-place op keeps its output's)."""
    if is_dtensor(dst):
        if not is_dtensor(src):
            src = like(src, dst)
        src = moved(src, dst.placements, dst.device_mesh)
    return dst.copy_(src)


# ---------------------------------------------------------------------------
# Parameter shardings by path-name heuristics
# ---------------------------------------------------------------------------

_COL_PARALLEL = ("wq", "wk", "wv", "wi", "wg", "w_rkvg", "wx",
                 "wy")                                  # [.., D, F*]
_ROW_PARALLEL = ("wo",)                                 # [.., F*, D]
_REPLICATED = ("scale", "bias", "router", "conv", "a_param", "u", "decay_lora",
               "mix", "pos", "w_decay", "ln")


def _leaf_spec(path: str, ndim: int, rules: Rules) -> P:
    f = rules.fsdp_axis
    tp = rules.tp_axis
    last = path.split("/")[-1]
    if last in ("tok", "lm_head"):                 # [V, D] / [D, V]
        if last == "tok":
            return P(tp, f)
        return P(f, tp)
    if is_expert(path):                             # [E, D, F] / [E, F, D]
        if last == "wo":
            return P(tp, None, f)
        return P(tp, f, None)
    if any(last == n or last.startswith(n) for n in _REPLICATED):
        return P(*([None] * ndim))
    if last in _COL_PARALLEL:                       # [..., D, F] col-parallel
        spec = [None] * ndim
        spec[-1] = tp
        if ndim >= 2:
            spec[-2] = f
        return P(*spec)
    if last in _ROW_PARALLEL:                       # [..., F, D] row-parallel
        spec = [None] * ndim
        if ndim >= 2:
            spec[-2] = tp
        spec[-1] = f
        return P(*spec)
    return P(*([None] * ndim))


def is_expert(path: str) -> bool:
    return "/moe/" in path and path.split("/")[-1] in ("wi", "wg", "wo")


def member_spec(path: str, ndim: int, stacked: bool, rules: Rules) -> P:
    """The spec of one port tensor of ``ndim`` dims at the reference path
    ``path``; ``stacked`` when the reference stacks it with the other
    cycles' (or layers') members.  A stacked member takes the leaf's spec
    without its stack entry; an expert member takes its ``[E, ...]`` spec
    (module docstring)."""
    if not stacked or is_expert(path):
        return _leaf_spec(path, ndim, rules)
    return P(*_leaf_spec(path, ndim + 1, rules)[1:])


def param_specs(model, rules: Rules, mesh=None) -> dict:
    """The spec of every parameter of ``model``, in the reference's tree
    (``model_zoo.param_tree``: a stacked leaf is a list of its members'
    specs).  With a mesh, specs are divisibility-sanitized against the
    members' shapes."""
    from repro_torch.models import model_zoo

    def value(path, p, idx):
        sp = member_spec("/".join(path), p.dim(), idx is not None, rules)
        return sanitize_spec(sp, p.shape, mesh) if mesh is not None else sp
    return model_zoo._tree_of(model, value)


def param_shardings(model, mesh, rules: Rules) -> dict:
    """The DTensor placements of every parameter, in :func:`param_specs`'s
    tree."""
    from repro_torch.train.optimizer import member_map

    return member_map(lambda sp: placements(sp, mesh),
                      param_specs(model, rules, mesh))


def opt_state_spec_from_param(spec, rules: Rules, shape=None,
                              mesh=None) -> P:
    """ZeRO-1: give optimizer-state copies an extra shard over the dp axis
    on the first unsharded dim that divides (falls back to the param spec)."""
    if not rules.zero1:
        return P(*spec)
    dp = rules.dp_axes[-1]
    used = {a for s in spec for a in _names(s)}
    if dp in used:
        return P(*spec)
    new = list(spec)
    for i, s in enumerate(new):
        if s is None:
            if shape is not None and mesh is not None and \
                    shape[i] % axis_size(mesh, dp) != 0:
                continue
            new[i] = dp
            return P(*new)
    return P(*spec)


def param_placements(model, mesh, rules: Rules) -> dict:
    """``{id(parameter): placements}`` of every parameter of ``model`` by
    :func:`param_specs` (sanitized against its shape)."""
    from repro_torch.models import model_zoo

    return {id(p): placements(sanitize_spec(
        member_spec("/".join(path), p.dim(), idx is not None, rules),
        p.shape, mesh), mesh) for path, p, idx in model_zoo._layout(model)}


def leaf_heads(module, name: str, pl, mesh, rules: Rules):
    """:func:`head_split` of ``module``'s parameter ``name`` placed ``pl``:
    a module whose weights hold heads names them in ``head_leaves()``
    (``{name: (flat dim, heads)}``)."""
    at = getattr(module, "head_leaves", None)
    at = at() if at is not None else {}
    return head_split(pl, mesh, rules, *at[name]) if name in at else None


def distribute_model_(model, mesh, rules: Rules):
    """Replace every parameter of ``model`` in place by a DTensor placed by
    :func:`param_specs` on ``mesh`` (each rank keeps its shard of the
    values it holds, which must be equal on every rank; by whole heads
    where :func:`leaf_heads` says so).  Returns the model."""
    pl = param_placements(model, mesh, rules)
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is None or is_dtensor(p):
                continue
            heads = leaf_heads(mod, name, pl[id(p)], mesh, rules)
            mod._parameters[name] = parameter(
                distribute_as(p.detach(), pl[id(p)], mesh, heads),
                p.requires_grad)
    return model


def undistribute_model_(model):
    """The inverse of :func:`distribute_model_`: every DTensor parameter
    back to a plain tensor holding its whole value.  Returns the model."""
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and is_dtensor(p):
                mod._parameters[name] = torch.nn.Parameter(
                    full(p.detach(), heads_of(p)),
                    requires_grad=p.requires_grad)
    return model
