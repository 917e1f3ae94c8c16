"""Logical-axis sharding rules on a torch ``DeviceMesh`` (PyTorch port of
``repro.distributed.sharding``).

The model code names the axes of its activations with *logical* names
(``annotate(x, "batch", None, "heads", None)``).  A context installed by
the launcher (``use_mesh``) maps logical names onto mesh axes; outside any
context ``annotate`` returns its input after one check, so the same model
code runs on one card and on a 512-rank mesh in the dry run unchanged.  A
resolved entry becomes ``Shard(dim)`` on each mesh axis it names and
``Replicate()`` on every other axis; ``annotate`` redistributes a
``DTensor`` to those placements (all-gather, all-reduce or reduce-scatter
as the change asks) and leaves a plain tensor as it is.

Divisibility guard, as the reference's: ``resolve`` drops a mesh axis whose
size does not divide the dim (a greedy prefix of the axes whose product
divides it is kept), e.g. llama3.2's 24 heads over a 16-way ``model`` axis.
Parameters keep the reference's specs exactly: the projection stays sharded
on its flat ``heads*head_dim`` dim, which divides for every config.

Where DTensor cannot follow XLA: XLA lets a flat dim sharded 16 ways be
reshaped into 24 heads (an uneven internal sharding); DTensor refuses to
unflatten an unevenly sharded dim.  ``split_heads`` therefore gathers the
flat dim first when the head count does not divide the axis: q of
llama3.2-3b (24), recurrentgemma-2b (10) and whisper-small (12) on the
16-way axis, and the kv heads of llama3.2-3b, qwen3-32b and kimi-k2 (8),
qwen2.5-3b (2), recurrentgemma-2b (1) and whisper-small (12).  The weights
and their gradients and optimizer state stay sharded as the reference's
rule has them; only that activation is replicated over ``model``, and
attention runs on whole heads there, as the reference's annotation (which
drops the non-dividing axis) asks.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# Logical axis name -> mesh axis (or tuple of mesh axes).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),          # FSDP within a pod; pure DP across pods
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": "model",          # sequence/context parallel KV caches
    "seq_sp": "model",          # sequence parallelism for B=1 long-context
    "d_model": None,
    "rnn": "model",             # recurrent state channels / rwkv heads
}


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object whose
    ``shape`` is already such a dict, as the tests' shape tables are)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


@dataclass
class ShardingCtx:
    mesh: Any
    rules: dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))

    @property
    def sizes(self) -> dict[str, int]:
        return mesh_axes(self.mesh)

    def axis_size(self, mesh_axes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        sizes = self.sizes
        n = 1
        for a in mesh_axes:
            n *= sizes.get(a, 1)
        return n

    def resolve(self, name, dim_size):
        """Logical name -> mesh axes for one dim, dropping non-dividing axes."""
        if name is None:
            return None
        axes = self.rules.get(name)
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        sizes = self.sizes
        axes = tuple(a for a in axes if a in sizes)
        # greedily keep a prefix of axes whose product divides the dim
        kept = []
        prod = 1
        for a in axes:
            if dim_size % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else tuple(kept)

    def spec(self, names, shape) -> tuple:
        """The reference's ``PartitionSpec`` entries: one per dim, None, a
        mesh axis name or a tuple of them."""
        assert len(names) == len(shape), (names, shape)
        return tuple(self.resolve(n, d) for n, d in zip(names, shape))

    def placements(self, spec) -> tuple:
        """DTensor placements of a spec: ``Shard(dim)`` on every mesh axis
        an entry names, ``Replicate()`` on the others."""
        order = list(self.sizes)
        out = [Replicate()] * len(order)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for a in (entry,) if isinstance(entry, str) else entry:
                out[order.index(a)] = Shard(dim)
        return tuple(out)

    def sharding(self, names, shape) -> tuple:
        return self.placements(self.spec(names, shape))


_ACTIVE: list[ShardingCtx] = []


@contextmanager
def use_mesh(mesh, rules: dict | None = None):
    ctx = ShardingCtx(mesh, {**DEFAULT_RULES, **(rules or {})})
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def current_ctx() -> ShardingCtx | None:
    return _ACTIVE[-1] if _ACTIVE else None


class _Constrain(torch.autograd.Function):
    """Redistribute to ``want``, and hold the gradient to ``want`` too, as
    XLA's sharding constraint binds the cotangent (with ``grad_only`` the
    forward leaves ``x`` as it is)."""

    @staticmethod
    def forward(ctx, x, want, grad_only=False):
        ctx.want = want
        if grad_only or tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None, None


def annotate(x, *names):
    """Redistribute a ``DTensor`` to the placements its logical axis names
    resolve to, its gradient likewise (no-op without a mesh or for a plain
    tensor)."""
    if not _ACTIVE:
        return x
    if not isinstance(x, DTensor):
        return x
    want = _ACTIVE[-1].sharding(names, x.shape)
    if not (torch.is_grad_enabled() and x.requires_grad):
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)
    return _Constrain.apply(x, want, False)


def annotate_grad(x, *names):
    """Hold ``x``'s gradient to the placements its logical axis names
    resolve to, and leave ``x`` itself as it is (no-op without a mesh, for
    a plain tensor or without grad)."""
    if not (_ACTIVE and isinstance(x, DTensor) and torch.is_grad_enabled()
            and x.requires_grad):
        return x
    return _Constrain.apply(x, _ACTIVE[-1].sharding(names, x.shape), True)


def _heads_axis(name: str, counts) -> str | None:
    """``name`` where the mesh divides every head count in ``counts`` (a
    rank must hold the kv heads its query heads read), else None."""
    ctx = _ACTIVE[-1]
    return name if all(ctx.resolve(name, m) for m in counts) else None


def split_heads(x, n: int, head_dim: int, name: str, *also: int):
    """(..., S, n*head_dim) -> (..., S, n, head_dim), annotated
    ``("batch", None, name, None)``.  The head dim stays sharded only where
    the axis divides ``n`` and every count in ``also`` (q's heads give
    ``also=(n_kv,)``); otherwise a DTensor is gathered on its flat dim
    before the reshape (DTensor cannot unflatten an uneven shard; see the
    module docstring)."""
    if not (_ACTIVE and isinstance(x, DTensor)):
        return x.reshape(*x.shape[:-1], n, head_dim)
    keep = _heads_axis(name, (n, *also))
    x = annotate(x, "batch", None, keep)
    x = x.reshape(*x.shape[:-1], n, head_dim)
    return annotate(x, "batch", None, keep, None)


def merged_heads(x, n: int, *also: int):
    """Annotate attention's (B, S, n*head_dim) output as ``split_heads``
    placed its heads, so the gradient reaches the merge (an unflatten in
    the backward) placed as the heads were."""
    if not (_ACTIVE and isinstance(x, DTensor)):
        return x
    return annotate(x, "batch", None, _heads_axis("heads", (n, *also)))


def local_einsum(eq: str, *operands):
    """``torch.einsum(eq, *operands)``, on a mesh run on each rank's shards.

    DTensor contracts an einsum by a ``bmm`` whose batch dim flattens every
    batch letter; torch refuses to flatten a dim sharded behind another
    (e.g. ``bhk,bhkn->bhn`` with b on ``data`` and h on ``model``).  Where
    every operand that holds a letter sharded on a mesh axis is sharded on
    it there, each rank's einsum of its shards is its shard of the result:
    a ``Shard`` of that letter in the output, or a ``Partial`` sum where
    the letter is summed over.  Otherwise, and for plain tensors, this is
    ``torch.einsum``."""
    dts = [o for o in operands if isinstance(o, DTensor)]
    if not dts:
        return torch.einsum(eq, *operands)
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = dts[0].device_mesh
    placements = []
    for axis in range(mesh.ndim):
        letters = set()
        for spec, o in zip(ins, operands):
            p = o.placements[axis] if isinstance(o, DTensor) else Replicate()
            if isinstance(p, Shard):
                letters.add(spec[p.dim])
            elif not isinstance(p, Replicate):
                return torch.einsum(eq, *operands)
        if not letters:
            placements.append(Replicate())
            continue
        if len(letters) > 1:
            return torch.einsum(eq, *operands)
        (letter,) = letters
        for spec, o in zip(ins, operands):
            p = o.placements[axis] if isinstance(o, DTensor) else Replicate()
            if letter in spec and not (isinstance(p, Shard)
                                       and spec[p.dim] == letter):
                return torch.einsum(eq, *operands)
        placements.append(Shard(out.index(letter)) if letter in out
                          else Partial())
    size = {c: n for spec, o in zip(ins, operands)
            for c, n in zip(spec, o.shape)}
    shape = tuple(size[c] for c in out)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    local = torch.einsum(eq, *[o.to_local() if isinstance(o, DTensor) else o
                               for o in operands])
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def cache_zeros(like, n: int, length: int, dtype):
    """Zeros of (n, B, length, ...) to write ``n`` layers' (B, S, ...)
    ``like`` into, at ``[i, :, :S]``: for a DTensor ``like`` a DTensor on
    its mesh placed as it is, one dim further in, so that each rank writes
    its own shard (an in-place write into a plain tensor is not a DTensor
    op); else a plain tensor on ``like``'s device."""
    shape = (n, like.shape[0], length, *like.shape[2:])
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros
    placements = [Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
                  for p in like.placements]
    return zeros(shape, dtype=dtype, device_mesh=like.device_mesh,
                 placements=placements)


def _offset(x: DTensor, dim: int) -> int:
    """Where this rank's slice of ``x`` starts along ``dim`` (DTensor's
    ``torch.chunk`` split, mesh axes in order), in plain integers: DTensor's
    own helper builds tensors, which a fake-tensor dry run cannot read."""
    coord = x.device_mesh.get_coordinate()
    length, off = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-length // x.device_mesh.size(i))
            start = min(coord[i] * chunk, length)
            off += start
            length = min(chunk, length - start)
    return off


def _to(x, mesh, placements):
    """``x`` as a DTensor on ``mesh`` with ``placements`` (a plain tensor is
    taken as replicated)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh, placements)
    return x


def _take(x, dim: int, idx, plan):
    """The masked local take along ``x``'s ``dim``: ``plan`` gives, for
    each mesh axis, the placements of x, of idx and of the result.  Each
    rank picks the indices that fall in its slice of ``dim`` (zeros for the
    rest); where x is sharded on ``dim`` the result is ``Partial``, a sum
    over that axis."""
    mesh = x.device_mesh
    xp, ip, op = zip(*plan)
    x, idx = _to(x, mesh, xp), _to(idx, mesh, ip)
    # on an axis where a replicated x is read at sharded indices, each
    # rank's gradient is its indices' share: a sum over that axis
    grad = tuple(Partial() if isinstance(p, Replicate) and
                 isinstance(q, Shard) else p for p, q in zip(xp, ip))
    xl = x.to_local(grad_placements=grad)
    il = idx.to_local().long() - _offset(x, dim)
    inside = (il >= 0) & (il < xl.shape[dim])
    return xl, torch.clamp(il, 0, max(xl.shape[dim] - 1, 0)), inside, op


def _follow(p, q):
    """The plan of a mesh axis on which x is not sharded on the taken dim:
    x keeps its shard of another dim (idx sharded alike), or follows idx's
    shard."""
    if isinstance(p, Shard):
        return p, Shard(p.dim), Shard(p.dim)
    if isinstance(q, Shard):
        return Shard(q.dim), q, q
    return Replicate(), Replicate(), Replicate()


def take_rows(table, ids):
    """``table[ids]``; for a ``DTensor`` table sharded on its rows (the
    vocab), each rank takes the ids inside its slice (zeros elsewhere) and
    the result is a sum over that axis (``Partial``), which the next
    ``annotate`` reduces.  A table sharded on its columns (FSDP) gives
    rows sharded alike."""
    if not isinstance(table, DTensor):
        return table[ids]
    ipl = (ids.placements if isinstance(ids, DTensor)
           else (Replicate(),) * table.device_mesh.ndim)
    plan = []
    for p, q in zip(table.placements, ipl):
        if isinstance(p, Shard) and p.dim == 0:
            plan.append((p, Replicate(), Partial()))
        elif isinstance(p, Shard):
            plan.append((p, Replicate(), Shard(ids.ndim)))
        elif isinstance(q, Shard):
            plan.append((Replicate(), q, q))
        else:
            plan.append((Replicate(),) * 3)
    tl, il, inside, out = _take(table, 0, ids, plan)
    rows = torch.where(inside[..., None], tl[il], 0)
    return DTensor.from_local(rows, table.device_mesh, out, run_check=False)


def take_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])[..., 0]``; for a ``DTensor``
    sharded on its last dim (the vocab of the logits), a masked local
    gather summed over that axis, as ``take_rows``; on its other dims the
    indices are placed as x is."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx[..., None].long())[..., 0]
    last = x.ndim - 1
    ipl = (idx.placements if isinstance(idx, DTensor)
           else (Replicate(),) * x.device_mesh.ndim)
    plan = [(p, Replicate(), Partial())
            if isinstance(p, Shard) and p.dim == last else _follow(p, q)
            for p, q in zip(x.placements, ipl)]
    xl, il, inside, out = _take(x, last, idx, plan)
    picked = torch.where(inside, torch.gather(xl, -1, il[..., None])[..., 0],
                         0)
    return DTensor.from_local(picked, x.device_mesh, out, run_check=False)


# ---------------------------------------------------------------------------
# Parameter partition specs (name-based rules)
# ---------------------------------------------------------------------------

def _path_names(path) -> list[str]:
    """A parameter's path as names: a dotted name (``blocks.0.attn.wq``) or
    a sequence of keys."""
    if isinstance(path, str):
        return path.split(".")
    return [str(p) for p in path]


def param_logical_axes(path, shape, *, fsdp: bool = False) -> tuple:
    """Return logical axis names for a parameter leaf, keyed on its name.

    Leading stack dims (layers / experts) are inferred from rank: rules below
    describe the trailing matrix dims.  The port's parameters are per layer
    (no leading layer dim), so an expert leaf ``(E, D, F)`` gets
    ``"experts"`` on E; the optimizer's stacked state ``(L, ...)`` takes the
    same rule.
    """
    names = _path_names(path)
    leaf = names[-1]
    moe_expert = any(n in ("experts", "moe") for n in names) and leaf in (
        "w_gate", "w_up", "w_down", "wi", "wo_e")
    rank = len(shape)

    def pad(trailing):
        lead: list = [None] * (rank - len(trailing))
        # expert-stacked params: shard the expert dim (dim -4 or -3)
        if moe_expert and rank >= 3:
            lead[-1] = "experts"
        return tuple(lead) + tuple(trailing)

    if moe_expert:
        # EP: shard the expert dim only; inner matrix dims get FSDP at most
        # (sharding them on `model` too would duplicate the mesh axis)
        return pad(("fsdp" if fsdp else None, None))
    if leaf in ("wq", "wk", "wv", "w_gate", "w_up", "wi", "w_in", "w_gate_in",
                "w_r", "w_k", "w_v", "w_g", "w_rec_x", "w_rec_gate"):
        return pad(("fsdp" if fsdp else None, "heads" if leaf in ("wq",) else
                    ("kv_heads" if leaf in ("wk", "wv") else "ff")))
    if leaf in ("wo", "w_down", "wo_e", "w_out", "w_o"):
        return pad(("heads" if leaf in ("wo", "w_o") else "ff",
                    "fsdp" if fsdp else None))
    if leaf == "embed":
        return pad(("vocab", "fsdp" if fsdp else None))
    if leaf == "unembed":
        return pad(("fsdp" if fsdp else None, "vocab"))
    if leaf == "router":
        return pad(("fsdp" if fsdp else None, None))
    # norms / biases / small vectors: replicated
    return tuple([None] * rank)


def param_specs(named, ctx: ShardingCtx, *, fsdp: bool = False) -> dict:
    """{name: spec} for ``named``, a module (its ``named_parameters``) or a
    ``{dotted name: tensor}`` dict."""
    if hasattr(named, "named_parameters"):
        named = dict(named.named_parameters())
    return {n: ctx.spec(param_logical_axes(n, t.shape, fsdp=fsdp), t.shape)
            for n, t in named.items()}


def batch_axes(ctx: ShardingCtx) -> tuple:
    return tuple(a for a in ("pod", "data") if a in ctx.sizes)
