"""Trees of tensors: the layout that parameters, gradients, optimizer
state and checkpoints share.

A tree is a dict or list of tensors, as the GNN parameters are; a leaf may
also be a ``Stacked``, the slices of one of the reference's layer-stacked
leaves, which the port's LM keeps as one tensor per layer
(``lm.param_tree`` gives the LM's parameters in the reference's layout).
"""
from __future__ import annotations

import torch


class Stacked(tuple):
    """The slices of one stacked leaf of the reference's tree (its leading
    layer or repeat axis), held as separate tensors.  Tree functions treat
    it as one leaf of ``shape`` (len, *slice shape); ``x[i]`` is slice i,
    as it is for a stacked tensor."""

    @property
    def shape(self):
        return (len(self), *self[0].shape)

    @property
    def device(self):
        return self[0].device


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each
    tree in ``rest``), keeping the dict/list structure; a ``Stacked`` is
    one leaf."""
    if isinstance(tree, Stacked):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, Stacked):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_clone(tree):
    """A copy of every tensor of ``tree``, detached, in the same layout."""
    return tree_map(lambda x: Stacked(s.detach().clone() for s in x)
                    if isinstance(x, Stacked) else x.detach().clone(), tree)


def slices(x) -> list:
    """The tensors a leaf holds: a ``Stacked``'s slices, else itself."""
    return list(x) if isinstance(x, Stacked) else [x]


def full(x) -> torch.Tensor:
    """A leaf as one tensor (a ``Stacked`` stacked)."""
    return torch.stack(list(x)) if isinstance(x, Stacked) else x
