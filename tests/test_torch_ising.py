"""The PyTorch port's problems and Glauber primitives against the JAX package.

Inputs are made with numpy from a seed and go through both packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import glauber as jglauber
from repro.core import ising as jising
from repro.core import problems as jproblems
from repro_torch.core import glauber, ising, problems
from repro_torch.core.sampler_api import random_init
from repro_torch.core.sparse import SparseIsing

torch.set_num_threads(1)

# XLA's CPU exp is its own polynomial and torch's is SLEEF's; each is within
# 2 ulp of the correctly rounded value, so the two sigmoids differ by up to
# 2 ulp (measured: 2 ulp on ~0.4% of N(0, 6) inputs).
SIGMOID_ULP = 2


def _dense(n, seed, scale=0.6):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, scale, (n, n))
    J = np.triu(A, 1)
    J = J + J.T
    return J.astype(np.float32), rng.normal(0, scale / 2, n).astype(np.float32)


def _both(J, b):
    return (
        jising.DenseIsing(J=jnp.asarray(J), b=jnp.asarray(b)),
        ising.DenseIsing.from_numpy(J, b, device="cpu"),
    )


@pytest.mark.parametrize("n", [12, 37])
def test_energy_and_local_fields_match_jax(n):
    J, b = _dense(n, seed=n)
    jp, tp = _both(J, b)
    s = np.random.default_rng(1).choice([-1.0, 1.0], (6, n)).astype(np.float32)
    # float32 sums of n terms of size ~1 in another order: atol covers
    # energies that land near zero, where rtol alone is meaningless
    np.testing.assert_allclose(
        tp.energy(torch.as_tensor(s)).numpy(), np.asarray(jp.energy(jnp.asarray(s))),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        tp.local_fields(torch.as_tensor(s)).numpy(),
        np.asarray(jp.local_fields(jnp.asarray(s))),
        rtol=1e-5, atol=1e-5,
    )
    # unbatched state
    np.testing.assert_allclose(
        float(tp.energy(torch.as_tensor(s[0]))), float(jp.energy(jnp.asarray(s[0]))),
        rtol=1e-5, atol=1e-5,
    )


def test_enumerate_boltzmann_matches_jax():
    J, b = _dense(5, seed=0, scale=0.7)
    jp, tp = _both(J, b)
    states_j, p_j = jising.enumerate_boltzmann(jp)
    states_t, p_t = ising.enumerate_boltzmann(tp)
    np.testing.assert_array_equal(states_t, states_j)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-6)
    assert p_t.sum() == pytest.approx(1.0)
    with pytest.raises(ValueError, match="20 spins"):
        ising.enumerate_boltzmann(ising.DenseIsing.from_numpy(
            np.zeros((21, 21)), np.zeros(21), device="cpu"))


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))))


def test_glauber_functions_match_jax():
    rng = np.random.default_rng(2)
    h = rng.normal(0, 3, 4096).astype(np.float32)
    s = rng.choice([-1.0, 1.0], 4096).astype(np.float32)
    frozen = rng.random(4096) < 0.2
    a = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    off = rng.normal(0, 0.3, 4096).astype(np.float32)
    th, ts = torch.as_tensor(h), torch.as_tensor(s)
    jh, js = jnp.asarray(h), jnp.asarray(s)
    assert _ulp_diff(glauber.prob_up(th), jglauber.prob_up(jh)) <= SIGMOID_ULP
    assert _ulp_diff(glauber.flip_prob(th, ts), jglauber.flip_prob(jh, js)) <= SIGMOID_ULP
    assert _ulp_diff(
        glauber.flip_rates(th, ts, 2.5, frozen=torch.as_tensor(frozen)),
        jglauber.flip_rates(jh, js, 2.5, frozen=jnp.asarray(frozen)),
    ) <= SIGMOID_ULP
    trim = glauber.SigmoidTrim(a=torch.as_tensor(a), b=torch.as_tensor(off))
    jtrim = jglauber.SigmoidTrim(a=jnp.asarray(a), b=jnp.asarray(off))
    assert _ulp_diff(glauber.activation(th, trim), jglauber.activation(jh, jtrim)) <= SIGMOID_ULP
    assert _ulp_diff(
        ising.conditional_prob_up(th), jising.conditional_prob_up(jh)
    ) <= SIGMOID_ULP
    assert np.all(glauber.flip_rates(th, ts, frozen=torch.as_tensor(frozen)).numpy()[frozen] == 0)
    assert glauber.LAMBDA0_CHIP_HZ == jglauber.LAMBDA0_CHIP_HZ


@pytest.mark.parametrize("n,seed", [(5, 0), (16, 7), (33, 3)])
def test_generators_equal_jax(n, seed):
    sk_j, sk_t = jproblems.sk_instance(n, seed), problems.sk_instance(n, seed, device="cpu")
    np.testing.assert_array_equal(sk_t.J.numpy(), np.asarray(sk_j.J))
    np.testing.assert_array_equal(sk_t.b.numpy(), np.asarray(sk_j.b))
    for kw in (dict(), dict(density=0.5, weights="uniform"), dict(density=0.1, sparse=False)):
        mc_j = jproblems.random_maxcut(n, seed, **kw)
        mc_t = problems.random_maxcut(n, seed, device="cpu", **kw)
        np.testing.assert_array_equal(mc_t.J.numpy(), np.asarray(mc_j.J))
        np.testing.assert_array_equal(mc_t.b.numpy(), np.asarray(mc_j.b))
    s = np.random.default_rng(seed).choice([-1.0, 1.0], (3, n)).astype(np.float32)
    np.testing.assert_allclose(
        problems.cut_value(mc_t, torch.as_tensor(s)).numpy(),
        np.asarray(jproblems.cut_value(mc_j, jnp.asarray(s))),
        rtol=1e-5,
    )
    sk_t.validate()


def test_sparse_maxcut_names_the_sparse_slice():
    """The sparse MaxCut layout is ported: low densities (and sparse=True)
    give the SparseIsing of the same instance, as in the JAX package."""
    for kw in (dict(density=0.1), dict(sparse=True)):
        sp = problems.random_maxcut(16, 0, device="cpu", **kw)
        jsp = jproblems.random_maxcut(16, 0, **kw)
        assert isinstance(sp, SparseIsing)
        for f in ("nbr_idx", "nbr_w", "deg", "b", "color_masks"):
            np.testing.assert_array_equal(getattr(sp, f).numpy(), np.asarray(getattr(jsp, f)))
        dense = problems.random_maxcut(16, 0, device="cpu", **dict(kw, sparse=False))
        np.testing.assert_array_equal(sp.to_dense().J.numpy(), dense.J.numpy())


def test_from_numpy_round_trips_a_jax_problem():
    jp = jproblems.sk_instance(12, 4)
    tp = ising.DenseIsing.from_numpy(np.asarray(jp.J), np.asarray(jp.b), device="cpu")
    assert tp.J.dtype == torch.float32 and tp.b.dtype == torch.float32
    assert tp.device == torch.device("cpu") and tp.n == 12
    np.testing.assert_array_equal(tp.J.numpy(), np.asarray(jp.J))
    np.testing.assert_array_equal(tp.b.numpy(), np.asarray(jp.b))
    back = jising.DenseIsing(J=jnp.asarray(tp.J.numpy()), b=jnp.asarray(tp.b.numpy()))
    np.testing.assert_array_equal(np.asarray(back.J), np.asarray(jp.J))


def test_validate_rejects_malformed_problems():
    J, b = _dense(6, seed=3)
    ising.DenseIsing.from_numpy(J, b, device="cpu").validate()
    bad = J.copy()
    bad[0, 1] += 1.0
    with pytest.raises(ValueError, match="symmetric"):
        ising.DenseIsing.from_numpy(bad, b, device="cpu").validate()
    diag = J + np.eye(6, dtype=np.float32)
    with pytest.raises(ValueError, match="diagonal"):
        ising.DenseIsing.from_numpy(diag, b, device="cpu").validate()
    with pytest.raises(ValueError, match="does not match"):
        ising.DenseIsing.from_numpy(J, b[:5], device="cpu").validate()
    nan = J.copy()
    nan[0, 1] = nan[1, 0] = np.nan
    with pytest.raises(ValueError, match="finite"):
        ising.DenseIsing.from_numpy(nan, b, device="cpu").validate()


def test_default_device_is_cuda_and_never_the_cpu():
    """With no device= the constructors target the CUDA device; without one
    they raise instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    J, b = _dense(4, seed=0)
    gen = torch.Generator()
    for make in (
        lambda: ising.DenseIsing.from_numpy(J, b),
        lambda: problems.sk_instance(8, 0),
        lambda: problems.random_maxcut(8, 0),
        lambda: random_init(gen, (2, 4)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
