"""The cost of one step from the ops it dispatches (the port's counterpart
of ``repro.launch.hlo_cost``).

``hlo_cost`` exists because XLA's ``cost_analysis()`` counts a ``while``
body once, so it re-derives FLOPs, bytes and collectives from the optimized
HLO text.  The port runs eagerly: every op of a step is dispatched, layer
loops and microbatches included, so its cost comes from counting the ops
of one step as they run (on fake tensors in the dry run: shapes, no data).
There is no HLO, hence no HLO parser and no ``parse_collectives``.
``OpCounter`` is a ``TorchDispatchMode`` that counts, per rank:

  * flops       -- each op's FLOPs by ``torch.utils.flop_counter``'s
                   formulas (matmuls, convolutions, SDPA, and the K4/K5
                   dry-run ops, which register their own); elementwise
                   work is not counted, as ``hlo_cost`` counts dots only.
                   A ``DTensor`` op is not counted itself: the ops it runs
                   on the local shards are, so replicated work counts on
                   every rank that does it (``FlopCounterMode`` alone
                   counts the logical op once).
  * hbm_bytes   -- operands plus outputs of every op that moves data, the
                   traffic model of ``hlo_cost`` at fusion boundaries (an
                   eager op is one): views, allocation and metadata ops
                   are free.
  * peak_bytes  -- the most bytes held at once by live storages (each
                   storage once, however many views it has), starting from
                   the tensors handed to ``track`` (parameters, optimizer
                   state, batch).  A storage is freed when its last
                   reference goes, as the card's caching allocator sees it.
  * collectives -- each functional collective (``_c10d_functional``) by
                   kind, count and the bytes of its result, as the
                   reference reads the result type of each collective in
                   the HLO; those the backward runs (the gradients') are
                   also counted apart.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# functional collectives -> the reference's HLO kinds
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_COLL_NS = ("_c10d_functional", "_c10d_functional_autograd")

# ops that move no data: allocation, metadata and waits
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "lift_fresh_copy", "detach",
         "alias", "wait_tensor", "_local_scalar_dense", "device", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
         "set_"}


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    peak_bytes: float = 0.0
    start_bytes: float = 0.0          # held when counting began
    coll_bytes: dict = field(default_factory=dict)
    coll_count: dict = field(default_factory=dict)
    coll_count_backward: dict = field(default_factory=dict)
    flops_by_op: dict = field(default_factory=dict)
    n_ops: int = 0

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _held(tree) -> list:
    """The tensors of a tree whose leaves may also be modules (their
    parameters and buffers)."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            out += list(leaf.parameters()) + list(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, (list, tuple)):     # a Stacked leaf
            out += _held(list(leaf))
    return out


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (see the module
    docstring).  ``track(tree)`` first adds tensors that already exist to
    the live bytes."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live: dict[int, int] = {}       # storage key -> bytes
        self._held = 0
        self._quiet = [0]     # inside DTensor's shape propagation

    # -- live storages -------------------------------------------------
    def _free(self, key: int) -> None:
        self._held -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._held += n
        weakref.finalize(st, self._free, key)
        if self._held > self.cost.peak_bytes:
            self.cost.peak_bytes = self._held

    def track(self, tree) -> None:
        for t in _held(tree):
            self._hold(t)
        self.cost.start_bytes = self._held

    @property
    def held_bytes(self) -> int:
        return self._held

    # -- dispatch --------------------------------------------------------
    def __enter__(self):
        # DTensor works out an op's output shape by running it once on
        # global-shaped fake tensors (cached per signature): not the step's
        # work, so not counted
        cls = ShardingPropagator
        self._meta = cls._propagate_tensor_meta_non_cached
        quiet, meta = self._quiet, self._meta

        def propagate(prop, *args, **kwargs):
            quiet[0] += 1
            try:
                return meta(prop, *args, **kwargs)
            finally:
                quiet[0] -= 1
        cls._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._meta
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # the logical op: DTensor runs it on the local shards, which
            # come through here and are counted
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet[0]:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        c = self.cost
        c.n_ops += 1
        for t in outs:
            self._hold(t)
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in _COLL_NS and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            c.coll_count[kind] = c.coll_count.get(kind, 0) + 1
            c.coll_bytes[kind] = (c.coll_bytes.get(kind, 0)
                                  + sum(_bytes(t) for t in outs))
            if torch._C._current_autograd_node() is not None:
                # inside the backward: the gradients' collectives
                c.coll_count_backward[kind] = \
                    c.coll_count_backward.get(kind, 0) + 1
            return out
        if func.is_view or name in _FREE:
            return out
        c.hbm_bytes += sum(_bytes(t) for t in ins) + sum(_bytes(t)
                                                         for t in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out)
            c.flops += f
            c.flops_by_op[name] = c.flops_by_op.get(name, 0) + f
        return out
