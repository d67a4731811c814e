"""The port's problem zoo against `repro.core.problems`.

Every ported generator, at the same (name, size, seed), gives arrays equal
element for element to the JAX zoo's, the same instance id, reference
energy and kind, and the same meta (the planted factorization's energy,
a float32 sum, within 4 ulp); the numpy reference machinery
(`exact_ground_energy`, `greedy_descent_dense`, `estimate_reference`) gives
the JAX numbers. `boltzmann_ml` is built (its construction from the JAX
zoo's batch is held against JAX in tests/test_torch_apps.py)."""
import numpy as np
import pytest
import torch

from repro.core import problems as jproblems
from repro_torch.core import problems, sampler_api
from repro_torch.core.ising import DenseIsing, LatticeIsing
from repro_torch.core.sparse import SparseIsing

torch.set_num_threads(1)

CPU = "cpu"
CASES = [("maxcut", 12, 0), ("maxcut", 20, 3), ("sk", 10, 1), ("sk", 24, 2),
         ("maxcut3r", 12, 0), ("maxcut3r", 30, 4), ("king", 4, 0), ("king", 5, 7),
         ("factorization", 35, 0), ("factorization", 143, 0), ("ferromagnet", 5, 0),
         ("cal", 16, 0)]
FIELDS = {DenseIsing: ("J", "b"), SparseIsing: ("nbr_idx", "nbr_w", "deg", "b", "color_masks"),
          LatticeIsing: ("w", "b", "clamp_mask", "clamp_value", "dead_mask")}


@pytest.mark.parametrize("name,size,seed", CASES, ids=lambda x: str(x))
def test_zoo_equals_jax_zoo(name, size, seed):
    got = problems.get_problem(name, size, seed, device=CPU)
    want = jproblems.get_problem(name, size, seed)
    assert (got.name, got.instance, got.ref_kind, got.kind, got.n) == (
        want.name, want.instance, want.ref_kind, want.kind, want.n)
    if got.ref_kind == "planted":
        # the planted state's float32 energy through each package's own
        # energy: the matvec and the sums round in another order (1 ulp at
        # N = 143); the port's own energy is the one its runs are held to
        np.testing.assert_array_max_ulp(np.float32(got.ref_energy), np.float32(want.ref_energy),
                                        maxulp=4)
        _, planted, _ = problems.factorization_ising(size, device=CPU)
        assert got.ref_energy == float(got.problem.energy(torch.as_tensor(planted).float()))
    else:
        assert got.ref_energy == want.ref_energy
        for rel in (0.0, 0.05):
            assert got.target_energy(rel) == want.target_energy(rel)
    assert got.meta == want.meta
    assert type(got.problem).__name__ == type(want.problem).__name__
    for f in FIELDS[type(got.problem)]:
        a, b = getattr(got.problem, f), getattr(want.problem, f)
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert problems.problem_kind(name) == jproblems.problem_kind(name)


def test_maxcut3r_dense_layout_equals_jax():
    got = problems.get_problem("maxcut3r", 16, 1, dense=True, device=CPU)
    want = jproblems.get_problem("maxcut3r", 16, 1, dense=True)
    assert got.instance == want.instance and got.ref_energy == want.ref_energy
    np.testing.assert_array_equal(got.problem.J.numpy(), np.asarray(want.problem.J))


def test_registry_and_boltzmann_ml():
    names = problems.problem_names()
    assert names == jproblems.problem_names()
    for name in names:
        assert problems.problem_kind(name) == jproblems.problem_kind(name)
    with pytest.raises(KeyError, match="unknown zoo problem"):
        problems.get_problem("tsp", 8)
    with pytest.raises(KeyError, match="unknown zoo problem"):
        problems.problem_kind("tsp")
    ml = problems.get_problem("boltzmann_ml", 8, 0, device=CPU)
    assert (ml.name, ml.kind, ml.instance, ml.n) == ("boltzmann_ml", "lattice",
                                                     "boltzmann_ml-L8-s0", 64)
    with pytest.raises(ValueError, match="kind"):
        problems.register_problem("x", kind="hypergraph")
    with pytest.raises(ValueError, match="16x16"):
        problems.get_problem("cal", 8, device=CPU)
    for bad in (8, 13, 23):  # even, prime, prime
        with pytest.raises(ValueError):
            problems.factorization_ising(bad, device=CPU)


def test_reference_machinery_equals_jax():
    assert problems.EXACT_ENUM_MAX == jproblems.EXACT_ENUM_MAX
    rng = np.random.default_rng(5)
    A = rng.normal(0, 1, (14, 14))
    J = np.triu(A, 1) + np.triu(A, 1).T
    b = rng.normal(0, 0.5, 14)
    dense = DenseIsing.from_numpy(J, b, device=CPU)
    jdense = jproblems.DenseIsing(J=np.asarray(J, np.float32), b=np.asarray(b, np.float32))
    assert problems.exact_ground_energy(dense) == jproblems.exact_ground_energy(jdense)
    s0 = rng.choice([-1.0, 1.0], 14)
    s_got, e_got = problems.greedy_descent_dense(J, b, s0)
    s_want, e_want = jproblems.greedy_descent_dense(J, b, s0)
    np.testing.assert_array_equal(s_got, s_want)
    assert e_got == e_want
    for p, jp in ((dense, jdense),
                  (problems.random_3regular_maxcut(30, 2, device=CPU),
                   jproblems.random_3regular_maxcut(30, 2)),
                  (problems.cal_problem(device=CPU), jproblems.cal_problem())):
        assert problems.estimate_reference(p, 3) == jproblems.estimate_reference(jp, 3)
    starts = [np.ones(14)]
    assert (problems.estimate_reference(dense, 1, n_restarts=2, starts=starts)
            == jproblems.estimate_reference(jdense, 1, n_restarts=2, starts=starts))


def test_zoo_problems_run_through_sampler_api():
    """Each kind through a kernel that takes it (tests/test_problem_zoo.py:138)."""
    for name, size, kernel in (("sk", 10, "ctmc"), ("maxcut", 10, "random_scan_gibbs"),
                               ("maxcut3r", 12, "colored_gibbs"), ("king", 4, "ctmc"),
                               ("cal", 16, "chromatic_gibbs"), ("ferromagnet", 4, "tau_leap")):
        z = problems.get_problem(name, size, device=CPU)
        res = sampler_api.run(z.problem, kernel, 0, n_steps=20, n_chains=2,
                              first_hit=z.target_energy(0.5))
        assert res.hit.shape == (2,)
        assert torch.all(z.problem.energy(res.s) >= z.ref_energy - 1e-4)
