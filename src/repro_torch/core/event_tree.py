"""Sum-tree (binary indexed tree) event selection for the exact CTMC.

The port of `repro.core.event_tree`. The Gillespie step draws the next flip
site with probability proportional to its rate lambda_i; the sum tree does
it with ONE uniform and an O(log n) root-to-leaf descent instead of one
Gumbel per site.

Layout: one flat float32 tensor of length 2*m along the last dim, m the
next power of two >= n; leading dims are chains (a (B, 2m) tensor holds
one tree per row).

    tree[..., 0]        unused (keeps 1-based heap indexing: children of k
                        are 2k and 2k+1)
    tree[..., 1]        root = total rate
    tree[..., m : 2m]   leaves: rates, zero-padded beyond n

Ops (pure, each returning a new tensor as the JAX ones do, but repair_):

    build(rates)              O(n) full rebuild (level-by-level pair sums)
    update(tree, i, rate)     O(log n) single-leaf path update
    update_many(tree, idx, d) O(k log n) leaf deltas at k sites
    repair_(tree, idx, r)     O(k log n) leaves set to r at k sites, their
                              root paths recomputed from the children, in
                              place (the port's sparse-CTMC repair)
    descend(tree, u)          O(log n) draw: leaf index with P(i) = rate_i/total
    total(tree)               root sum
    leaves(tree, n)           the first n leaf rates back

Rounding follows the JAX package: `build` sums each pair of children at
every level and packs the levels root first, so it is bit-exact against
`repro.core.event_tree.build` on identical rates; `descend` compares and
subtracts as the reference does. `update_many` adds the k root paths one
after another, so a shared ancestor receives its deltas in index order, the
order of the reference's single scatter-add; each path's nodes are distinct,
so on a CUDA device no two atomic adds of one call meet at an address and
the result does not depend on their order.

`repair_` has no counterpart in the JAX package: the sparse CTMC repairs
its carried tree with it instead of `update_many` (see `repair_` and
`sampler_api.CTMC`), so the tree holds exactly the build of the current
rates after any number of events.
"""
from __future__ import annotations

import torch

# Total-rate floor of the CTMC: below this a chain is treated as frozen (the
# dwell time is clamped to ~1e30 and no flip is performed). Shared by the
# denominator clamp and the aliveness test; above it the dwell time and the
# site draw are both unclamped and exact.
RATE_FLOOR = 1e-30


def leaf_count(n: int) -> int:
    """Next power of two >= n."""
    if n < 1:
        raise ValueError(f"need at least one site, got n={n}")
    return 1 << (n - 1).bit_length()


def tree_size(n: int) -> int:
    """Length of the flat tree for n sites."""
    return 2 * leaf_count(n)


def depth(tree: torch.Tensor) -> int:
    """Number of descent levels, log2(m), from the tree's last dim."""
    m = tree.shape[-1] // 2
    return m.bit_length() - 1


def build(rates: torch.Tensor) -> torch.Tensor:
    """Full O(n) rebuild from (..., n) rates -> (..., 2m) trees.

    Levels are pairwise sums computed bottom-up and packed root first;
    index 0 carries a zero placeholder."""
    n = rates.shape[-1]
    m = leaf_count(n)
    lead = rates.shape[:-1]
    level = rates if m == n else torch.cat(
        [rates, torch.zeros(lead + (m - n,), dtype=rates.dtype, device=rates.device)], dim=-1)
    levels = [level]
    while levels[-1].shape[-1] > 1:
        levels.append(levels[-1].unflatten(-1, (-1, 2)).sum(dim=-1))
    zero = torch.zeros(lead + (1,), dtype=rates.dtype, device=rates.device)
    return torch.cat([zero] + levels[::-1], dim=-1)


def total(tree: torch.Tensor) -> torch.Tensor:
    """Total rate (the root) of each tree."""
    return tree[..., 1]


def leaves(tree: torch.Tensor, n: int) -> torch.Tensor:
    """The (..., n) leaf rates."""
    m = tree.shape[-1] // 2
    return tree[..., m:m + n]


def leaves_at(tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Leaf rates at site indices `idx` (..., k) of each tree (repeats allowed)."""
    m = tree.shape[-1] // 2
    return tree.gather(-1, m + idx.long())


def _path(leaf: torch.Tensor, tree: torch.Tensor) -> torch.Tensor:
    """(..., depth + 1) node indices from each leaf up to the root."""
    shifts = torch.arange(depth(tree) + 1, device=tree.device)
    return leaf[..., None] >> shifts


def update(tree: torch.Tensor, i: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Set leaf i of each tree to `rate` and repair its root path: O(log n).

    `i` and `rate` have the trees' leading shape; the repair is one
    scatter-add of the leaf delta over the path `(m + i) >> level`."""
    m = tree.shape[-1] // 2
    leaf = m + i.long()
    delta = rate - tree.gather(-1, leaf[..., None])[..., 0]
    path = _path(leaf, tree)
    return tree.scatter_add(-1, path, delta[..., None].expand(path.shape))


def update_many(tree: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Add delta[..., k] to leaf idx[..., k] of each tree and repair all root
    paths: O(k log n).

    Takes leaf DELTAS, so repeated indices compose additively: padded
    neighbour slots pass delta = 0 instead of a masked index. The paths are
    added in k order, one scatter-add each (see the module docstring)."""
    m = tree.shape[-1] // 2
    paths = _path(m + idx.long(), tree)  # (..., k, depth + 1)
    tree = tree.clone()
    for j in range(idx.shape[-1]):
        path = paths[..., j, :]
        tree.scatter_add_(-1, path, delta[..., j, None].expand(path.shape))
    return tree


def repair_(tree: torch.Tensor, idx: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """Set leaf idx[..., k] of each tree to rates[..., k] and recompute every
    node on their root paths from its two children, bottom-up, in place:
    O(k log n). Repeated indices must carry equal rates (a padded neighbour
    slot aliasing site i carries i's own new rate), so no mask is needed.

    Every node is a pair sum of its children, as `build` makes it, so a
    tree that equalled `build` of its leaves still does, bit for bit, and
    repairs never drift. `update_many`'s leaf deltas do: each adds to the
    running sums of every ancestor, and as a root falls from thousands to
    tens the rounding of those adds becomes a relative error of the root."""
    m = tree.shape[-1] // 2
    leaf = m + idx.long()
    tree.scatter_(-1, leaf, rates)
    L, k = depth(tree), idx.shape[-1]
    if L == 0:
        return tree
    nodes = leaf[..., None] >> torch.arange(1, L + 1, device=tree.device)  # (..., k, L)
    kids = (2 * nodes[..., None] + torch.arange(2, device=tree.device))  # (..., k, L, 2)
    kids = kids.movedim(-2, 0).flatten(-2).contiguous()  # (L, ..., 2k): each level's children
    for level in range(L):
        pairs = tree.gather(-1, kids[level]).unflatten(-1, (k, 2)).sum(dim=-1)
        tree.scatter_(-1, nodes[..., level], pairs)
    return tree


def descend(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Draw a leaf of each tree with P(i) = rate_i / total from ONE uniform
    u in [0, 1) per tree; returns int64 site indices of u's shape.

    Inverse-CDF descent: log2(m) steps, each comparing the remaining target
    mass with the left child's sum. At subtree boundaries float rounding
    can land one leaf off, so callers that must never see a padded leaf
    clamp the result to n-1; a zero-total tree degenerates to the last
    leaf (the CTMC's RATE_FLOOR aliveness test discards that draw)."""
    target = u * tree[..., 1]
    idx = torch.ones(u.shape, dtype=torch.int64, device=tree.device)
    m = tree.shape[-1] // 2
    for _ in range(depth(tree)):
        idx = 2 * idx
        left = tree.gather(-1, idx[..., None])[..., 0]
        go_right = target >= left
        target = torch.where(go_right, target - left, target)
        idx = idx + go_right
    return idx - m
