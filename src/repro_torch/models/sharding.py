"""Sharding rules and the sharded forward's collectives, as the
reference's ``src/repro/models/sharding.py``.

Conventions (the reference's):
  * ``model`` axis: tensor parallel — attention head / ff / expert dims.
  * ``data`` axis: batch parallel; optionally FSDP (weights' d_model dim).
  * ``pod`` axis (multi-pod): extra batch parallelism for train/serve, or
    the prefill/decode disaggregation axis of ``core/disagg.py``.

Every rule degrades to replication when a dim is not divisible by the
mesh axis size (qwen2's 2 KV heads on a 16-way model axis: the cache
shards its sequence instead; its 4,864-wide FFN and 151,936 vocab still
shard).

**Specs become placements.**  The reference's ``PartitionSpec`` maps
tensor dims to mesh axes; a ``torch.distributed`` ``DTensor``'s
placements map mesh dims to tensor dims.  ``param_dims`` / ``cache_dims``
give the reference's spec (one entry a tensor dim: None, an axis name or
a tuple of them) and ``param_spec`` / ``cache_spec`` the placements, one
``Shard(d)`` / ``Replicate()`` a mesh dim.  The port has no stacked
``body``: its ``params["layers"]`` and dense caches are per-layer lists,
so no leaf carries the reference's leading repeats dim.

**The sharded forward runs on local shards.**  Under
``activation_sharding`` the model's entry points take parameters and
caches as DTensors (``shard``), run every layer on each rank's
``to_local()`` shards and insert the collectives that GSPMD inserts in
the reference, explicitly, through ``torch.distributed``'s functional
collectives (``all_reduce``, ``all_gather``, ``split``,
``fsdp_gather``): a column-parallel projection gives local heads or
ff columns, a row-parallel ``wo`` / ``down`` ends in an all-reduce, the
embedding and the head are vocab-parallel, FSDP-sharded weights are
gathered before use.  The flop and byte counts of ``launch/op_cost.py``
are therefore per device, as the reference's post-SPMD HLO is.  Outside
the context every helper is the plain operation and ``data_axis_size()``
is 1, so the unsharded paths are unchanged.
"""
from __future__ import annotations

import contextlib as _contextlib
import sys
from typing import Callable, Optional, Sequence, Tuple

import torch

# param-name classes (the reference's) ---------------------------------------
_COLUMN = {"wq", "wk", "wv", "wi", "wx", "wy", "w_up", "w_a", "w_i", "wq_a",
           "wq_b", "wkv_a", "wkv_b", "up", "w", "shared_wi", "lm_head",
           "cls_head"}
_ROW = {"wo", "w_out", "down", "w_down", "shared_wo"}
_VEC_SHARD = {"bq", "bk", "bv", "b"}           # 1-D, shard if divisible
_REPLICATE = {"norm1", "norm2", "norm", "norm_c", "final_norm", "q_norm",
              "kv_norm", "b_a", "b_i", "b_if", "a_param", "router",
              "pos_embed", "conv_w", "w_if"}


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; the
    path is the tuple of dict keys and list indices (as strings)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves(tree) -> list:
    out: list = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
def param_dims(path, shape, *, model_size: int, data_size: int = 0,
               fsdp: bool = False, serve2d: bool = False) -> tuple:
    """The reference's ``param_spec`` for one param leaf of ``shape``,
    as a tuple with one entry a tensor dim (None or a mesh axis name).

    ``fsdp``: additionally shard a second dim over ``data`` — weights are
    all-gathered per layer (training).  ``serve2d``: expert weights shard
    BOTH the expert dim (model) and the expert-ff dim (data).
    """
    name = path[-1]
    spec: list = [None] * len(shape)

    def try_shard(dim_idx: int, axis: str, size: int) -> bool:
        if spec[dim_idx] is None and _div(shape[dim_idx], size):
            spec[dim_idx] = axis
            return True
        return False

    if name == "embed":
        try_shard(0, "model", model_size)          # vocab
        if fsdp:
            try_shard(1, "data", data_size)
    elif name in ("wi", "wo", "shared_wi", "shared_wo") and len(shape) == 3:
        # MoE expert weights (E, in, out): expert-parallel if E divides,
        # else fall back to ff-dim tensor parallel
        if not try_shard(0, "model", model_size):
            ff_dim = 2 if name in ("wi", "shared_wi") else 1
            try_shard(ff_dim, "model", model_size)
        if serve2d:
            ff_dim = 2 if name in ("wi", "shared_wi") else 1
            try_shard(ff_dim, "data", data_size)
        elif fsdp:
            d_dim = 1 if name in ("wi", "shared_wi") else 2
            try_shard(d_dim, "data", data_size)
    elif name == "r" and len(shape) == 3:          # sLSTM recurrent (nh,dh,4dh)
        try_shard(2, "model", model_size)
    elif name in _COLUMN and len(shape) >= 2:
        try_shard(len(shape) - 1, "model", model_size)
        if fsdp:
            try_shard(len(shape) - 2, "data", data_size)
    elif name in _ROW and len(shape) >= 2:
        try_shard(len(shape) - 2, "model", model_size)
        if fsdp:
            try_shard(len(shape) - 1, "data", data_size)
    elif name in _VEC_SHARD and len(shape) == 1:
        try_shard(0, "model", model_size)
    # _REPLICATE and anything unmatched: fully replicated
    return tuple(spec)


def cache_dims(path, shape, *, model_size: int,
               batch_axes: Tuple[str, ...]) -> tuple:
    """The reference's ``cache_spec`` for one dense-cache leaf, as a
    tuple with one entry a tensor dim.

    KV caches shard heads over ``model`` when divisible, otherwise the
    *sequence* dim shards over ``model`` (sequence-parallel attention:
    the softmax reductions become all-reduces).  Recurrent states shard
    their feature dim."""
    name = path[-1]
    ba = tuple(batch_axes) if batch_axes else None
    spec: list = [None] * len(shape)
    if len(shape) >= 1:
        spec[0] = ba                               # batch dim
    if name in ("k", "v", "ck", "cv") and len(shape) == 4:
        b, s, kvh, hd = shape
        if _div(kvh, model_size):
            spec[2] = "model"
        elif _div(s, model_size):
            spec[1] = "model"
    elif name in ("ckv", "krope") and len(shape) == 3:
        if _div(shape[1], model_size):
            spec[1] = "model"                      # seq-sharded latent
    elif name in ("h", "c", "n", "m") and len(shape) == 2:
        if _div(shape[1], model_size):
            spec[1] = "model"
    elif name == "conv" and len(shape) == 3:
        if _div(shape[2], model_size):
            spec[2] = "model"
    elif name == "C" and len(shape) == 4:
        if _div(shape[2], model_size):
            spec[2] = "model"
    elif name == "n" and len(shape) == 3:
        if _div(shape[2], model_size):
            spec[2] = "model"
    return tuple(spec)


def placements(dims: Sequence, axes: Sequence[str]) -> tuple:
    """The DTensor placements (one a mesh dim of ``axes``) of a spec
    with one entry a tensor dim.  A tensor dim over several mesh axes
    (a batch over ("pod", "data")) is ``Shard`` of that dim on each."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in axes:
        where = [d for d, e in enumerate(dims)
                 if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(Shard(where[0]) if where else Replicate())
    return tuple(out)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def param_spec(path, leaf, *, model_size: int, data_size: int = 0,
               fsdp: bool = False, serve2d: bool = False,
               axes: Sequence[str] = ("data", "model")) -> tuple:
    """Placements of one param leaf over the mesh axes ``axes``."""
    return placements(param_dims(path, tuple(leaf.shape),
                                 model_size=model_size, data_size=data_size,
                                 fsdp=fsdp, serve2d=serve2d), axes)


def cache_spec(path, leaf, *, model_size: int,
               batch_axes: Tuple[str, ...],
               axes: Sequence[str] = ("data", "model")) -> tuple:
    """Placements of one dense-cache leaf over the mesh axes ``axes``."""
    return placements(cache_dims(path, tuple(leaf.shape),
                                 model_size=model_size,
                                 batch_axes=batch_axes), axes)


def param_shardings(params, mesh, *, fsdp: bool = False,
                    serve2d: bool = False):
    """A tree of placements matching a params tree (real or meta)."""
    sz = _sizes(mesh)
    return tree_map_with_path(
        lambda path, leaf: param_spec(
            path, leaf, model_size=sz.get("model", 1),
            data_size=sz.get("data", 1), fsdp=fsdp, serve2d=serve2d,
            axes=mesh.mesh_dim_names), params)


def cache_shardings(cache, mesh, batch_axes: Tuple[str, ...] = ("data",)):
    """A tree of placements matching a dense cache."""
    model_size = _sizes(mesh).get("model", 1)
    return tree_map_with_path(
        lambda path, leaf: cache_spec(path, leaf, model_size=model_size,
                                      batch_axes=batch_axes,
                                      axes=mesh.mesh_dim_names), cache)


def data_sharding(mesh, batch_axes: Tuple[str, ...] = ("data",),
                  extra_dims: int = 1) -> tuple:
    """Placements of a (batch, ...) input: batch over ``batch_axes``."""
    return placements((tuple(batch_axes) or None,) + (None,) * extra_dims,
                      mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_chunk(x: torch.Tensor, mesh, pl: Sequence) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under placements
    ``pl``: mesh dims in order, each ``Shard(d)`` an even split of dim d
    (the DTensor layout).  No communication."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.mesh.shape[i]
            size = x.shape[p.dim] // n
            x = x.narrow(p.dim, coord[i] * size, size)
    return x


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def shard(tree, mesh, shardings):
    """DTensors over ``mesh`` from a tree of full tensors that every rank
    holds alike (weights from one seed, zero caches, meta tensors): each
    leaf keeps only this rank's shard (a copy, so the full tensor can be
    freed), with no communication.  ``shardings`` is the matching tree
    of placement tuples (``param_shardings``, ``cache_shardings``)."""
    from torch.distributed.tensor import DTensor

    def one(path, x):
        pl = _at(shardings, path)
        loc = local_chunk(x, mesh, pl)
        if x.device.type != "meta":
            loc = loc.clone()
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return tree_map_with_path(one, tree)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  Before DTensor's module is loaded
    none can exist, so a plain tensor never pays for its import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local(x):
    """The local shard of a DTensor, anything else as it is.  Shares
    storage with the DTensor, so an in-place write lands in it."""
    return x.to_local() if is_dtensor(x) else x


def localize(tree):
    """``tree`` with every DTensor leaf that is replicated on every mesh
    dim replaced by its local tensor; sharded leaves stay DTensors for
    the helpers below."""
    from torch.distributed.tensor import Replicate

    def one(_, x):
        if is_dtensor(x) and all(isinstance(p, Replicate)
                                 for p in x.placements):
            return x.to_local()
        return x
    return tree_map_with_path(one, tree)


# ---------------------------------------------------------------------------
# Activation sharding (the reference's constraint context)
# ---------------------------------------------------------------------------
_ACT_CTX: dict = {"batch_axes": None, "model_axis": None, "mesh": None,
                  "opts": frozenset(), "sizes": {}, "ranks": {},
                  "groups": {}}

# §Perf optimization toggles (the reference's):
#   "seqkv"  — prefill attention computes masked partial softmax directly
#              over the sequence-sharded KV cache (all-reduces of the
#              softmax statistics) instead of all-gathering the cache per
#              chunk.  Sequence-parallel attention.
#   "attn2d" — train-mode attention splits the batch over (data x model)
#              when heads cannot shard over the model axis (qwen2's 14
#              heads on 16): pure 2D batch parallelism.
#   "seqact" — residual-stream activations shard their seq dim over the
#              model axis between layers (Megatron-style sequence
#              parallelism): checkpointed carries shrink by the
#              model-axis size.


@_contextlib.contextmanager
def activation_sharding(mesh, batch_axes=("data",),
                        model_axis: str = "model", opts=()):
    """Run the model's entry points sharded over ``mesh`` (a
    ``DeviceMesh`` with named dims): batch over ``batch_axes``, tensor
    parallelism over ``model_axis``."""
    prev = dict(_ACT_CTX)
    # the mesh's sizes, this rank's coordinates and the groups' names,
    # read once: DeviceMesh recomputes them on every access
    names = mesh.mesh_dim_names
    _ACT_CTX.update(mesh=mesh, batch_axes=tuple(batch_axes),
                    model_axis=model_axis, opts=frozenset(opts),
                    sizes=dict(zip(names, mesh.mesh.shape)),
                    ranks=dict(zip(names, mesh.get_coordinate())),
                    groups={})
    try:
        yield
    finally:
        _ACT_CTX.update(prev)


def active() -> bool:
    return _ACT_CTX["mesh"] is not None


def axis_size(axis: str) -> int:
    return _ACT_CTX["sizes"].get(axis, 1)


def axis_rank(axis: str) -> int:
    return _ACT_CTX["ranks"].get(axis, 0)


def model_size() -> int:
    return axis_size(_ACT_CTX["model_axis"] or "model")


def model_rank() -> int:
    return axis_rank(_ACT_CTX["model_axis"] or "model")


def data_axis_size() -> int:
    """Product of the active batch axes' sizes (1 outside a context)."""
    total = 1
    for ax in _ACT_CTX["batch_axes"] or ():
        total *= axis_size(ax)
    return total


def batch_axes() -> Tuple[str, ...]:
    return tuple(_ACT_CTX["batch_axes"] or ())


def opt_on(name: str) -> bool:
    return _ACT_CTX["mesh"] is not None and name in _ACT_CTX["opts"]


# ---------------------------------------------------------------------------
# functional collectives on local shards (autograd-aware)
# ---------------------------------------------------------------------------
def _ops():
    return torch.ops._c10d_functional


def _group_name(axis: str) -> str:
    names = _ACT_CTX["groups"]
    if axis not in names:
        names[axis] = _ACT_CTX["mesh"].get_group(axis).group_name
    return names[axis]


def _raw_all_reduce(x, axis: str, op: str = "sum"):
    f = _ops()
    return f.wait_tensor(f.all_reduce(x.contiguous(), op, _group_name(axis)))


def _raw_all_gather(x, dim: int, axis: str):
    f = _ops()
    n = axis_size(axis)
    x = x.movedim(dim, 0).contiguous()
    y = f.wait_tensor(f.all_gather_into_tensor(x, n, _group_name(axis)))
    return y.movedim(0, dim)


def _raw_reduce_scatter(x, dim: int, axis: str):
    f = _ops()
    n = axis_size(axis)
    x = x.movedim(dim, 0).contiguous()
    y = f.wait_tensor(f.reduce_scatter_tensor(x, "sum", n,
                                              _group_name(axis)))
    return y.movedim(0, dim)


def _slice(x, dim: int, axis: str):
    n = axis_size(axis)
    size = x.shape[dim] // n
    return x.narrow(dim, axis_rank(axis) * size, size)


class _AllReduce(torch.autograd.Function):
    """Sum over the axis; the backward is the identity (the consumers
    are replicated over the axis: Megatron's g)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _raw_all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity; the backward sums the gradient over the axis (a
    replicated input to a column-parallel product: Megatron's f)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's slice
    (the consumers are replicated over the axis)."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _raw_all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.axis).contiguous(), None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor replicated over the
    axis; the backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.dim, ctx.axis), None, None


class _FsdpGather(torch.autograd.Function):
    """All-gather of a weight sharded over a batch axis (FSDP); the
    backward reduce-scatters the gradient, whose ranks saw different
    tokens."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _raw_all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _raw_reduce_scatter(g, ctx.dim, ctx.axis), None, None


def _model_axis() -> str:
    return _ACT_CTX["model_axis"] or "model"


def all_reduce(x, axis: Optional[str] = None, op: str = "sum"):
    """Sum (or max) over a mesh axis (model by default); the identity
    outside a context or on an axis of size 1."""
    axis = axis or _model_axis()
    if axis_size(axis) == 1:
        return x
    if op != "sum":
        return _raw_all_reduce(x.detach(), axis, op)
    return _AllReduce.apply(x, axis)


def enter(x, axis: Optional[str] = None):
    axis = axis or _model_axis()
    if axis_size(axis) == 1 or not torch.is_grad_enabled():
        return x
    return _Enter.apply(x, axis)


def all_gather(x, dim: int, axis: Optional[str] = None):
    axis = axis or _model_axis()
    if axis_size(axis) == 1:
        return x
    return _Gather.apply(x, dim % x.ndim, axis)


def split(x, dim: int, axis: Optional[str] = None):
    axis = axis or _model_axis()
    if axis_size(axis) == 1:
        return x
    return _Split.apply(x, dim % x.ndim, axis)


def fsdp_gather(x, dim: int, axis: str):
    if axis_size(axis) == 1:
        return x
    return _FsdpGather.apply(x, dim, axis)


# ---------------------------------------------------------------------------
# sharded weights on local shards
# ---------------------------------------------------------------------------
def _shard_dims(x) -> dict:
    """{mesh axis: tensor dim} of a DTensor's Shard placements."""
    if not is_dtensor(x):
        return {}
    from torch.distributed.tensor import Shard
    names = x.device_mesh.mesh_dim_names
    return {names[i]: p.dim for i, p in enumerate(x.placements)
            if isinstance(p, Shard)}


def weight(w):
    """(the local weight with every batch-axis shard gathered (FSDP /
    serve2d), the tensor dim sharded over the model axis or None).
    Outside a context: (w, None), with no other work (the served
    paths call it once a step)."""
    if not active() or not is_dtensor(w):
        return w, None
    dims = _shard_dims(w)
    x = w.to_local()
    model_dim = None
    for ax, d in dims.items():
        if ax == _model_axis():
            model_dim = d
        else:
            x = fsdp_gather(x, d, ax)
    if model_dim is not None and axis_size(_model_axis()) == 1:
        model_dim = None
    return x, model_dim


def full(w):
    """The whole of a (possibly sharded) weight on this rank."""
    x, dim = weight(w)
    return x if dim is None else all_gather(x, dim)


def full_tree(tree):
    """``full`` of every leaf (the fallback of a layer with no
    tensor-parallel form: its weights all-gathered, its compute
    replicated over the model axis)."""
    return tree_map_with_path(lambda _, x: full(x), tree)


def col(x, w, bias=None):
    """``x @ w (+ bias)`` for an ``x`` replicated over the model axis.
    Returns (y, sharded): this rank's output columns when w's last dim
    is sharded over the model axis, else all of them."""
    wl, dim = weight(w)
    bl = None if bias is None else weight(bias)[0]
    if dim is None or dim != wl.ndim - 1:
        if dim is not None:          # a row shard used as a column op
            wl = all_gather(wl, dim)
        y = x @ wl
        return (y if bl is None else y + bl), False
    y = enter(x) @ wl
    return (y if bl is None else y + bl), True


def col_full(x, w, bias=None):
    """``x @ w (+ bias)`` with every output column on every rank."""
    y, sharded = col(x, w, bias)
    return all_gather(y, -1) if sharded else y


def row(x, w):
    """``x @ w`` for a w whose input dim (rows) may be sharded over the
    model axis; x holds either every input column or this rank's slice
    of them.  Returns the full product on every rank (an all-reduce of
    the partial sums)."""
    wl, dim = weight(w)
    if dim is None:
        return x @ wl
    if dim != wl.ndim - 2:                 # sharded on the output dim
        return x @ all_gather(wl, dim)
    if x.shape[-1] != wl.shape[-2]:
        x = split(x, -1)
    return all_reduce(x @ wl)


def heads_local(n_heads: int) -> bool:
    """Whether a layer with ``n_heads`` (KV) heads runs on this rank's
    heads only: inside a context with a model axis that divides them."""
    m = model_size()
    return m > 1 and n_heads % m == 0


def col_heads(x, w, bias, n: int, hd: int, local_heads: bool):
    """``x @ w (+ bias)`` as (..., heads, hd): this rank's n/m heads
    when ``local_heads`` (w's columns shard whole heads), else all n."""
    y, sharded = col(x, w, bias)
    if sharded and not local_heads:
        y = all_gather(y, -1)
    return y.reshape(*y.shape[:-1], -1, hd)


def embed_lookup(table, tokens):
    """``table[tokens]``, vocab-parallel when the table's rows shard over
    the model axis: each rank looks up the tokens in its rows, zeros the
    others, and the ranks' results are summed (exact: one nonzero)."""
    tl, dim = weight(table)
    if dim is None:
        return tl[tokens]
    if dim != 0:
        return all_gather(tl, dim)[tokens]
    n = tl.shape[0]
    t = tokens - model_rank() * n
    ok = (t >= 0) & (t < n)
    h = tl[t.clamp(0, n - 1)] * ok[..., None].to(tl.dtype)
    return all_reduce(h)


def head_sharded(table, transposed: bool) -> bool:
    """Whether ``head_logits`` gives this rank's vocab columns only: the
    table's vocab dim (0 of a tied embedding, 1 of an LM head) shards
    over the model axis."""
    return model_dim(table) == (0 if transposed else 1)


def head_logits(h, table, transposed: bool):
    """``h @ table.T`` (tied embedding) or ``h @ table``: (logits,
    vocab_sharded): this rank's vocab columns when ``head_sharded``."""
    tl, dim = weight(table)
    if transposed:
        tl = tl.T
    if head_sharded(table, transposed):
        return enter(h) @ tl, True
    if dim is not None:
        tl = all_gather(tl, 1 - dim if transposed else dim)
    return h @ tl, False


# ---------------------------------------------------------------------------
# sharded caches on local shards
# ---------------------------------------------------------------------------
def seq_shard(c, seq_dim: int = 1):
    """(local tensor, first global position it holds, global length,
    sharded) of a cache leaf whose ``seq_dim`` may shard over the model
    axis."""
    if not active() or not is_dtensor(c):
        return c, 0, c.shape[seq_dim], False
    loc = c.to_local()
    if _shard_dims(c).get(_model_axis()) == seq_dim and model_size() > 1:
        n = loc.shape[seq_dim]
        return loc, model_rank() * n, n * model_size(), True
    return loc, 0, loc.shape[seq_dim], False


def write_seq(c, new, start: int, seq_dim: int = 1) -> None:
    """Write ``new`` at positions [start, start + len) of the cache leaf
    in place; on a sequence shard only the positions it holds."""
    loc, lo, _, _ = seq_shard(c, seq_dim)
    n_new = new.shape[seq_dim]
    a, b = max(start, lo), min(start + n_new, lo + loc.shape[seq_dim])
    if a >= b:
        return
    dst = loc.narrow(seq_dim, a - lo, b - a)
    dst.copy_(new.narrow(seq_dim, a - start, b - a))


def scatter_slots(c, new, slots) -> None:
    """Write one token a request (new: (b, 1, ...)) at per-request
    positions ``slots`` (b,) in place; on a sequence shard only the rows
    whose position it holds."""
    loc, lo, _, sharded = seq_shard(c)
    rows = torch.arange(loc.shape[0], device=loc.device)
    val = new[:, 0].to(loc.dtype)
    if not sharded:
        loc[rows, slots.long()] = val
        return
    rel = slots.long() - lo
    mine = (rel >= 0) & (rel < loc.shape[1])
    # a row whose position another shard holds rewrites its own value
    # at position 0 of this shard
    keep = loc[rows, 0]
    loc[rows, torch.where(mine, rel, 0)] = torch.where(
        mine.view(-1, *([1] * (val.ndim - 1))), val, keep)


def assign(c, v) -> None:
    """Write ``v``, the whole of a cache leaf over the model axis, into
    the leaf in place: on a shard only this rank's part of it."""
    loc = local(c)
    dim = _shard_dims(c).get(_model_axis())
    if dim is not None and model_size() > 1:
        v = _slice(v, dim, _model_axis())
    loc.copy_(v)


def model_dim(w) -> Optional[int]:
    """The tensor dim of ``w`` sharded over the model axis, or None."""
    if model_size() == 1:
        return None
    return _shard_dims(w).get(_model_axis())


def gather_seq(c, seq_dim: int = 1):
    """The whole sequence of a cache leaf on this rank (an all-gather
    over the model axis when it is sequence-sharded)."""
    loc, _, _, sharded = seq_shard(c, seq_dim)
    return all_gather(loc, seq_dim) if sharded else loc


def full_cache(c: dict) -> dict:
    """Every model-axis shard of a layer's cache gathered (the batch
    stays local): the fallback's input."""
    out = {}
    for k, x in c.items():
        loc = local(x)
        dim = _shard_dims(x).get(_model_axis())
        out[k] = (loc if dim is None or model_size() == 1
                  else _raw_all_gather(loc, dim, _model_axis()))
    return out


def store_cache(c: dict, new: dict) -> dict:
    """A layer's cache whose leaves carry ``new``'s values (gathered over
    the model axis, as ``full_cache`` gives them), each keeping this
    rank's model-axis shard in the old leaf's placements."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, x in c.items():
        v = new[k]
        if not is_dtensor(x):
            out[k] = v
            continue
        dim = _shard_dims(x).get(_model_axis())
        loc = v if dim is None or model_size() == 1 else _slice(
            v, dim, _model_axis())
        out[k] = DTensor.from_local(loc.to(x.dtype).contiguous(),
                                    x.device_mesh, x.placements,
                                    run_check=False, shape=x.shape,
                                    stride=x.stride())
    return out


# ---------------------------------------------------------------------------
# the reference's constraint hooks, on local shards
# ---------------------------------------------------------------------------
def seq_constrain(x, seq_dim: int = 1):
    """The reference's name for pinning a tensor's sequence dim to the
    model axis.  A sequence-sharded cache is read where it lies
    (``seq_shard``), so nothing in the port calls this: the identity,
    kept for the reference's API."""
    del seq_dim
    return x


def batch2d_constrain(x):
    """Dim 0 over (batch axes + model): the 2D batch-parallel attention
    of heads that cannot shard over the model axis ("attn2d").  x is
    replicated over the model axis; this rank keeps its slice of the
    (already data-local) batch.  ``batch2d_release`` undoes it."""
    m = model_size()
    if m == 1 or x.shape[0] % m:
        return x
    return split(x, 0)


def batch2d_release(x, batch: int):
    """The whole data-local batch again (all-gather over the model axis)
    of a tensor that ``batch2d_constrain`` split from ``batch`` rows; the
    reference's ``act_constrain`` after its "attn2d" attention."""
    if model_size() == 1 or x.shape[0] == batch:
        return x
    return all_gather(x, 0)


def seqact_applies(x) -> bool:
    """Whether "seqact" shards this residual-stream tensor's seq dim."""
    m = model_size()
    return (opt_on("seqact") and m > 1 and x.ndim == 3
            and x.shape[1] % m == 0)


def act_constrain(x, *, vocab_dim: bool = False):
    """The residual stream between layers: with "seqact" (and a seq dim
    the model axis divides) this rank's seq shard of a tensor replicated
    over the model axis, else the identity.  Logits (``vocab_dim``) come
    out of ``head_logits`` already vocab-sharded, so they pass."""
    if vocab_dim or not seqact_applies(x):
        return x
    return split(x, 1)


def moe_constrain(x, expert_dim: Optional[int] = None,
                  ff_dim: Optional[int] = None):
    """The reference's name for constraining MoE intermediates.  Here the
    groups are already this rank's tokens and ``moe_forward`` computes
    this rank's experts only, so nothing calls this: the identity, kept
    for the reference's API."""
    del expert_dim, ff_dim
    return x


# ---------------------------------------------------------------------------
# training on local shards
# ---------------------------------------------------------------------------
def grad_leaves(params):
    """(this rank's local tensor of every leaf, detached and requiring
    grad: the tensors to differentiate and update; ``params`` with each
    DTensor leaf re-wrapped around its local tensor in the same
    placements, through which gradients flow back to it).  The local
    tensors share the DTensors' storage, so an in-place update lands in
    them.  A plain leaf's tensor is its own alias, so an unsharded tree
    never loads DTensor's module."""
    flat = leaves(params)
    loc = [local(p).detach().requires_grad_(True) for p in flat]
    it = iter(zip(loc, flat))

    def one(_, p):
        x, p = next(it)
        if not is_dtensor(p):
            return x
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(x, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    return loc, tree_map_with_path(one, params)


def reduce_grads(grads, params):
    """Data-parallel gradients: each leaf's local gradient summed over
    every batch axis the weight does not shard over (an FSDP leaf's came
    reduce-scattered out of its gather over that axis).  With the loss a
    mean over every rank's tokens (``vocab_parallel_nll``) the sums are
    the gradients of the global loss.  The identity outside a context."""
    axes = [ax for ax in batch_axes() if axis_size(ax) > 1]
    if not axes:
        return grads
    out = leaves(grads)
    for i, p in enumerate(leaves(params)):
        dims = _shard_dims(p)
        for ax in axes:
            if ax not in dims:
                out[i] = _raw_all_reduce(out[i], ax)
    it = iter(out)
    return tree_map_with_path(lambda *_: next(it), grads)


def shard_sum(values, like) -> torch.Tensor:
    """The sum over the whole mesh of per-leaf partial sums ``values``
    (0-d tensors, one a leaf of ``like``, each over this rank's shard):
    a leaf's sum is all-reduced over each mesh axis it shards over, and
    counted once over the axes it is replicated on.  Outside a context
    the plain sum.  A global norm of gradients sharded like ``like``."""
    if not active():
        return torch.stack(values).sum()
    groups: dict = {}
    for v, p in zip(values, like):
        key = tuple(ax for ax in _shard_dims(p) if axis_size(ax) > 1)
        groups.setdefault(key, []).append(v)
    total = None
    for key in sorted(groups):       # the same order on every rank
        part = torch.stack(groups[key]).sum()
        for ax in key:
            part = _raw_all_reduce(part, ax)
        total = part if total is None else total + part
    return total


def vocab_parallel_nll(logits, labels, vocab: int):
    """Mean next-token cross entropy of logits (b, s, V or this rank's
    vocab shard) against labels (b, s) (-100 masked), in f32.  On a
    vocab shard the log-sum-exp and the target logit are all-reduced
    over the model axis (Megatron's vocab-parallel cross entropy), so no
    rank holds the whole vocab.  Inside a context the batch is this
    rank's shard over the batch axes and the mean is the global one
    (the sum and the count all-reduced over them); outside, the plain
    masked mean."""
    lf = logits.float()
    labels = labels.long()
    mask = (labels >= 0).float()
    lab = labels.clamp(min=0)
    if lf.shape[-1] == vocab:
        nll = -torch.log_softmax(lf, -1).gather(-1, lab[..., None])[..., 0]
    else:
        n = lf.shape[-1]
        m = all_reduce(lf.amax(-1, keepdim=True), op="max")
        se = all_reduce(torch.exp(lf - m).sum(-1))
        t = lab - model_rank() * n
        ok = ((t >= 0) & (t < n)).float()
        tgt = all_reduce(lf.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
                         * ok)
        nll = torch.log(se) + m[..., 0] - tgt
    num, den = (nll * mask).sum(), mask.sum()
    for ax in batch_axes():       # the mean over every rank's tokens
        num, den = all_reduce(num, ax), all_reduce(den, ax)
    return num / torch.clamp(den, min=1.0)


def wrap(x, batch_sharded: bool, model_dim: Optional[int] = None):
    """A local result as a DTensor over the active mesh: batch (dim 0)
    over the batch axes when ``batch_sharded``, ``model_dim`` over the
    model axis (vocab-sharded logits), replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = _ACT_CTX["mesh"]
    pl = []
    shape = list(x.shape)
    for i, ax in enumerate(mesh.mesh_dim_names):
        n = mesh.mesh.shape[i]
        if batch_sharded and ax in (_ACT_CTX["batch_axes"] or ()):
            pl.append(Shard(0))
            shape[0] *= n
        elif ax == _model_axis() and model_dim is not None:
            pl.append(Shard(model_dim))
            shape[model_dim] *= n
        else:
            pl.append(Replicate())
    return DTensor.from_local(x.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def batch_sharded(x) -> bool:
    """Whether an entry point's input (tokens / positions) is a DTensor
    whose batch shards over the batch axes."""
    d = _shard_dims(x)
    return any(d.get(ax) == 0 for ax in (_ACT_CTX["batch_axes"] or ()))


def entry(params, *inputs):
    """(params localized, inputs as local tensors, batch sharded) at a
    model entry point inside a context."""
    sharded = any(batch_sharded(x) for x in inputs if x is not None)
    return (localize(params),
            tuple(None if x is None else local(x) for x in inputs),
            sharded)

