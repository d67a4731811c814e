"""The port's CTMC sum tree against `repro.core.event_tree`.

The seven tests of tests/test_event_tree.py, on the port, each also holding
the port bit for bit against the JAX function on the same float32 inputs:
`build` sums each pair of children level by level as the reference does,
`descend` compares and subtracts as it does, and `update` / `update_many`
add their deltas along the root paths in the reference's order. Trees are
batched as the rows of a (B, 2m) tensor; a 1-D tree is one row. `repair_`,
the port's sparse-CTMC repair, is held to `build` bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import event_tree as jet
from repro_torch.core import event_tree

torch.set_num_threads(1)


def _rand_rates(n, seed=0, zero_frac=0.0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.05, 1.0, n)
    if zero_frac:
        r[rng.random(n) < zero_frac] = 0.0
    return r.astype(np.float32)


def _jax(a):
    return np.asarray(a)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 13, 64, 100])
def test_build_layout_and_sums(n):
    rates = _rand_rates(n, seed=n)
    tree = event_tree.build(torch.tensor(rates)).numpy()
    m = event_tree.leaf_count(n)
    assert tree.shape == (2 * m,) == (event_tree.tree_size(n),)
    np.testing.assert_array_equal(tree, _jax(jet.build(jnp.asarray(rates))))
    np.testing.assert_array_equal(tree[m:m + n], rates)
    np.testing.assert_array_equal(tree[m + n:], 0.0)
    np.testing.assert_array_equal(
        event_tree.leaves(event_tree.build(torch.tensor(rates)), n).numpy(), rates)
    for k in range(1, m):
        assert tree[k] == np.float32(tree[2 * k] + tree[2 * k + 1])
    np.testing.assert_allclose(float(event_tree.total(torch.tensor(tree))), rates.sum(),
                               rtol=1e-6)
    # rows: every chain's tree equals its own 1-D build
    rows = np.stack([_rand_rates(n, seed=n + r) for r in range(3)])
    batched = event_tree.build(torch.tensor(rows)).numpy()
    for r in range(3):
        np.testing.assert_array_equal(batched[r], _jax(jet.build(jnp.asarray(rows[r]))))


@pytest.mark.parametrize("n", [5, 8, 33])
def test_update_matches_rebuild(n):
    """A chain of point updates equals the JAX chain bit for bit and the
    rebuild within the reference test's tolerance."""
    rates = _rand_rates(n, seed=2 * n + 1)
    tree = event_tree.build(torch.tensor(rates))
    jtree = jet.build(jnp.asarray(rates))
    rng = np.random.default_rng(7)
    for _ in range(12):
        i = int(rng.integers(0, n))
        new = np.float32(rng.uniform(0.0, 2.0))
        rates[i] = new
        tree = event_tree.update(tree, torch.tensor(i), torch.tensor(new))
        jtree = jet.update(jtree, jnp.asarray(i), jnp.asarray(new, jnp.float32))
        np.testing.assert_array_equal(tree.numpy(), _jax(jtree))
        np.testing.assert_allclose(tree.numpy(), _jax(jet.build(jnp.asarray(rates))),
                                   rtol=2e-6, atol=1e-6)


def test_update_per_row_index():
    """Batched rows, one leaf index and rate per row (the JAX test's jit and
    traced index, here a tensor index per chain)."""
    rows = np.stack([_rand_rates(10, seed=3 + r) for r in range(4)])
    idx = np.array([4, 0, 9, 4])
    new = np.array([0.25, 1.5, 0.0, 0.75], np.float32)
    got = event_tree.update(event_tree.build(torch.tensor(rows)), torch.tensor(idx),
                            torch.tensor(new)).numpy()
    for r in range(4):
        want = jax.jit(jet.update)(jet.build(jnp.asarray(rows[r])), jnp.asarray(idx[r]),
                                   jnp.asarray(new[r]))
        np.testing.assert_array_equal(got[r], _jax(want))
        rates = rows[r].copy()
        rates[idx[r]] = new[r]
        np.testing.assert_allclose(got[r], _jax(jet.build(jnp.asarray(rates))),
                                   rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("dyadic", [True, False])
def test_update_many_matches_jax(dyadic):
    """Leaf deltas at repeated and padded (zero-delta) indices, per row:
    bit-equal to the JAX scatter-add, exactly the rebuild for dyadic rates
    (where no order of adds rounds)."""
    rng = np.random.default_rng(11)
    n, k, B = 13, 5, 4
    if dyadic:
        rows = rng.integers(1, 64, (B, n)).astype(np.float32) / 64
        delta = rng.integers(-8, 9, (B, k)).astype(np.float32) / 64
    else:
        rows = rng.uniform(0.05, 1.0, (B, n)).astype(np.float32)
        delta = rng.uniform(-0.05, 0.05, (B, k)).astype(np.float32)
    idx = rng.integers(0, n, (B, k))
    idx[:, -1] = idx[:, 0]  # a repeated index, as a padded slot aliases site i
    delta[:, -1] = 0.0
    got = event_tree.update_many(event_tree.build(torch.tensor(rows)), torch.tensor(idx),
                                 torch.tensor(delta)).numpy()
    for r in range(B):
        want = jet.update_many(jet.build(jnp.asarray(rows[r])), jnp.asarray(idx[r]),
                               jnp.asarray(delta[r]))
        np.testing.assert_array_equal(got[r], _jax(want))
        if dyadic:
            rates = rows[r].copy()
            np.add.at(rates, idx[r], delta[r])
            np.testing.assert_array_equal(got[r], _jax(jet.build(jnp.asarray(rates))))
    np.testing.assert_array_equal(
        event_tree.leaves_at(torch.tensor(got), torch.tensor(idx)).numpy(),
        np.take_along_axis(got[:, got.shape[1] // 2:], idx, 1))


@pytest.mark.parametrize("n", [2, 6, 8, 17])
def test_descend_is_exact_inverse_cdf(n):
    """descend(u) returns the leaf whose CDF interval holds u * total (the
    reference test's check) and the JAX descent's leaf at every u."""
    rates = _rand_rates(n, seed=n + 100, zero_frac=0.3 if n > 4 else 0.0)
    rates[0] = 0.4
    tree = event_tree.build(torch.tensor(rates))
    us = np.linspace(0.0, 0.999999, 301).astype(np.float32)
    got = event_tree.descend(tree.expand(len(us), -1), torch.tensor(us)).numpy()
    jtree = jet.build(jnp.asarray(rates))
    want_jax = _jax(jax.vmap(lambda u: jet.descend(jtree, u))(jnp.asarray(us)))
    np.testing.assert_array_equal(got, want_jax)
    total = float(tree[1])
    cdf = np.cumsum(rates.astype(np.float64))
    want = np.searchsorted(cdf, us * total, side="right")
    boundary = np.min(np.abs(cdf[None, :] - (us * total)[:, None]), axis=1) < 1e-5
    ok = (got == np.minimum(want, n - 1)) | boundary
    assert ok.all(), np.nonzero(~ok)
    drawn = got[~boundary]
    assert not (rates == 0.0)[drawn[drawn < n]].any()
    # a 1-D tree and a () uniform give a () index
    assert int(event_tree.descend(tree, torch.tensor(us[150]))) == got[150]


def test_descend_distribution_is_proportional():
    rates = torch.tensor([0.5, 0.0, 0.125, 0.25, 0.125])
    tree = event_tree.build(rates)
    us = torch.rand(20_000, generator=torch.Generator().manual_seed(0))
    idx = event_tree.descend(tree.expand(len(us), -1), us).numpy()
    freq = np.bincount(idx, minlength=8) / len(idx)
    p = rates.numpy() / float(rates.sum())
    np.testing.assert_allclose(freq[:5], p, atol=0.01)
    assert freq[5:].sum() == 0.0  # padded leaves unreachable


def test_zero_total_degenerates_without_nan():
    tree = event_tree.build(torch.zeros(6))
    i = int(event_tree.descend(tree, torch.tensor(0.3)))
    assert 0 <= i < event_tree.leaf_count(6)
    assert i == int(jet.descend(jet.build(jnp.zeros((6,), jnp.float32)), jnp.float32(0.3)))
    assert float(event_tree.total(tree)) == 0.0


def test_static_helpers():
    assert event_tree.leaf_count(1) == 1
    assert event_tree.leaf_count(8) == 8
    assert event_tree.leaf_count(9) == 16
    assert event_tree.tree_size(5) == 16
    assert event_tree.depth(event_tree.build(torch.ones(5))) == 3
    assert event_tree.depth(event_tree.build(torch.ones((3, 5)))) == 3
    for n in (1, 5, 9, 100):
        assert event_tree.tree_size(n) == jet.tree_size(n)
    with pytest.raises(ValueError):
        event_tree.leaf_count(0)


@pytest.mark.parametrize("n", [1, 2, 5, 13, 64])
def test_repair_equals_rebuild_bit_for_bit(n):
    """repair_ (the port's sparse-CTMC repair; no JAX counterpart) sets the
    leaves and recomputes their paths: the result is `build` of the new
    rates bit for bit, repeated indices carrying equal rates included, and
    within rounding of the JAX delta repair of the same change."""
    rng = np.random.default_rng(n)
    B = 3
    rows = rng.uniform(0.05, 1.0, (B, n)).astype(np.float32)
    idx = np.stack([rng.permutation(n)[:min(3, n)] for _ in range(B)])
    idx = np.concatenate([idx, idx[:, :1]], 1)  # distinct sites, then i again
    k = idx.shape[1]
    new = rng.uniform(0.0, 1.0, (B, k)).astype(np.float32)
    new[:, -1] = new[:, 0]
    tree = event_tree.build(torch.tensor(rows))
    got = event_tree.repair_(tree.clone(), torch.tensor(idx), torch.tensor(new)).numpy()
    rates = rows.copy()
    np.put_along_axis(rates, idx, new, 1)
    np.testing.assert_array_equal(got, event_tree.build(torch.tensor(rates)).numpy())
    for r in range(B):
        first = np.unique(idx[r], return_index=True)[1]
        delta = np.zeros(k, np.float32)
        delta[first] = new[r, first] - rows[r, idx[r, first]]
        want = jet.update_many(jet.build(jnp.asarray(rows[r])), jnp.asarray(idx[r]),
                               jnp.asarray(delta))
        np.testing.assert_allclose(got[r], _jax(want), rtol=1e-6, atol=1e-6)
