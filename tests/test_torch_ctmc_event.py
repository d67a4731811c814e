"""The CTMC's event kernel (`csrc/ctmc_event.cu`): one Gillespie event of
every chain of a dense problem, `run(..., CTMC(), backend="cuda")`.

The kernel runs only on the card, so here: its plain version
(`ref.ctmc_event_ref`, which `ops.ctmc_event` runs on CPU tensors) against
`CTMC.update`'s rebuilding tree path, bit for bit in s, h, e and t; `run()`
on the cuda backend against the plain one on CPU tensors, a kept run's
second call included; the routes the kernel does not take, each raising
with its reason; and the wrapper with its launcher replaced (one
`launch.ctmc_event` an event). On the card (marked `cuda`) the kernel itself
against the plain version and the graphed `run()` against the plain
backend, bit for bit. This file imports no JAX, so it runs there."""
import dataclasses
import types

import pytest
import torch

from repro_torch import tracing
from repro_torch.core import problems, sampler_api
from repro_torch.core.faults import FaultModel
from repro_torch.core.ising import DenseIsing
from repro_torch.core.sampler_api import CTMC, run
from repro_torch.kernels import _build, ctmc_event, ops, ref

CPU = "cpu"
FIELDS = ("s", "t", "samples", "times", "energies")

torch.set_num_threads(1)


def _sk(n, seed, dev=CPU, bias=0.0):
    """An SK instance, J ~ N(0, 1/n), with b = bias * a random sign."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((n, n), generator=g, device=dev) / n ** 0.5
    J = torch.triu(a, 1)
    b = bias * torch.where(torch.rand((n,), generator=g, device=dev) < 0.5, 1.0, -1.0)
    return DenseIsing(J=J + J.T, b=b)


def _start(problem, B, seed, frozen=False):
    """B random states; with `frozen`, chain 0 set against the bias, whose
    rates at beta 100 all lie below RATE_FLOOR (the bias outweighs J)."""
    g = torch.Generator(device=problem.device).manual_seed(seed)
    s = torch.where(torch.rand((B, problem.n), generator=g, device=problem.device) < 0.5, 1.0, -1.0)
    if frozen:
        s[0] = -torch.sign(problem.b)
    return s


def _events(problem, kernel, s0, beta, events, seed):
    """`events` events from s0 through CTMC.update and through the plain
    version from the same draws; returns the first event whose (s, h, e, t)
    differ (None: none) and the last state."""
    dev = problem.device
    g = torch.Generator(device=dev).manual_seed(seed)
    state = kernel.init(problem, g, s0=s0, n_chains=s0.shape[0])
    plain = (state.s, state.aux.h, state.e, state.t)
    for k in range(events):
        site, expo, _, _ = kernel.draw(problem, state, g, beta)
        state = kernel.update(problem, state, beta, site, expo)
        plain = ops.ctmc_event(*plain, problem.J, beta, expo, site, kernel.lambda0)
        got = (state.s, state.aux.h, state.e, state.t)
        if not all(torch.equal(a, b) for a, b in zip(got, plain)):
            return k, state
    return None, state


@pytest.mark.parametrize("n", [64, 100, 2000])
def test_the_plain_version_is_the_tree_path_bit_for_bit(n):
    """200 events at per-row betas and lambda0 = 0.5, chain 0 frozen below
    RATE_FLOOR: the plain version equals CTMC.update's tree path in s, h, e
    and t after every event."""
    problem = _sk(n, n, bias=5.0)
    kernel = CTMC(lambda0=0.5, site_draw="tree")
    s0 = _start(problem, 5, 1, frozen=True)
    beta = torch.tensor([100.0, 0.3, 0.9, 2.0, 3.0])
    rates = kernel.rates(problem, s0, problem.local_fields(s0), beta)
    assert float(rates[0].sum()) < sampler_api.RATE_FLOOR < float(rates[1:].sum(1).min())
    first_differ, last = _events(problem, kernel, s0, beta, 200, n + 1)
    assert first_differ is None
    assert torch.equal(last.s[0], s0[0])  # the frozen chain never flipped
    assert bool((last.s[1:] != s0[1:]).any())


def test_the_plain_version_takes_lambda0_and_the_clamped_descent():
    """lambda0 = 1 skips the multiply on both; n = 5 pads the tree to 8
    leaves, whose descent the clamp keeps off the padding."""
    problem = _sk(5, 3)
    for lambda0 in (1.0, 2.5):
        kernel = CTMC(lambda0=lambda0, site_draw="tree")
        first_differ, _ = _events(problem, kernel, _start(problem, 4, 2), torch.ones(4), 100, 4)
        assert first_differ is None
    # uniforms next to 1 descend to the last leaves: the flip stays on a site
    s = _start(problem, 3, 5)
    zero = torch.zeros(3)
    top = torch.full((3,), 1.0 - 2.0**-24)
    new, _, _, _ = ref.ctmc_event_ref(s, problem.local_fields(s), zero, zero, problem.J,
                                      torch.ones(3), torch.ones(3), top)
    assert ((new != s).sum(1) == 1).all()


def _kw(n_steps=120):
    return dict(n_steps=n_steps, n_chains=6, sample_every=30,
                schedule=sampler_api.geometric(0.3, 3.0))


@pytest.mark.parametrize("first_hit", [None, -40.0])
def test_a_cuda_run_on_cpu_tensors_equals_the_plain_backend(first_hit):
    problem = _sk(100, 9, bias=0.2)
    kernel = CTMC(lambda0=0.5)
    for seed in (3, 2**31 + 7):
        got = run(problem, kernel, seed, backend="cuda", first_hit=first_hit, **_kw())
        want = run(problem, kernel, seed, backend="ref", first_hit=first_hit, **_kw())
        for field in FIELDS + (("hit", "t_hit") if first_hit is not None else ()):
            assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_a_kept_cuda_run_equals_the_plain_backend_on_its_second_call():
    sampler_api.drop_kept_runs()
    problem = _sk(64, 2)
    before = tracing.counts()
    first = run(problem, CTMC(), 5, backend="cuda", **_kw())
    second = run(problem, CTMC(), 6, backend="cuda", **_kw())
    assert tracing.counts()["sampler.reuses"] - before["sampler.reuses"] == 1
    other = _sk(64, 3)  # another problem of the same shape: the kept run renewed
    third = run(other, CTMC(), 7, backend="cuda", **_kw())
    assert tracing.counts()["sampler.renewals"] - before["sampler.renewals"] == 1
    for got, (p, seed) in ((first, (problem, 5)), (second, (problem, 6)), (third, (other, 7))):
        want = run(p, CTMC(), seed, backend="ref", **_kw())
        for field in FIELDS:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    sampler_api.drop_kept_runs()


def test_the_cuda_path_keeps_no_tree_and_the_ref_path_does():
    problem = _sk(100, 4)
    for backend, tree in (("cuda", False), ("ref", True)):
        made = sampler_api._make_run(problem, CTMC(), 1, n_steps=5, n_chains=2, backend=backend)
        made()
        assert (made.final_state.aux.tree is not None) is tree


def test_backends_for_offers_cuda_on_float32_dense_tree_problems_alone():
    dense = _sk(100, 1)
    assert sampler_api.kernel_backends(CTMC(), dense) == ("ref", "cuda")
    assert sampler_api.kernel_backends(CTMC(), None) == ("ref", "cuda")
    assert sampler_api.kernel_backends(CTMC(site_draw="scan"), dense) == ("ref",)
    assert sampler_api.kernel_backends(CTMC(), _sk(32, 1)) == ("ref",)  # auto: scan below 64
    assert sampler_api.kernel_backends(CTMC(site_draw="tree"), _sk(32, 1)) == ("ref", "cuda")
    half = DenseIsing(J=dense.J.double(), b=dense.b.double())
    assert sampler_api.kernel_backends(CTMC(), half) == ("ref",)
    sparse = problems.random_3regular_maxcut(64, 0, device=CPU)
    assert sampler_api.kernel_backends(CTMC(), sparse) == ("ref",)
    assert sampler_api._resolve_backend("auto", CTMC(), dense) == "ref"  # a CPU problem


def _huge():
    """A dense problem one site past the kernel's tree (no memory: J is a
    broadcast zero)."""
    n = ctmc_event.MAX_LEAVES + 1
    return DenseIsing(J=torch.zeros(()).expand(n, n), b=torch.zeros(()).expand(n))


@pytest.mark.parametrize("route,match", [
    ("sparse", "takes dense couplings"),
    ("scan", "site_draw='scan'"),
    ("float64", "takes float32 couplings"),
    ("too_large", f"at most {ctmc_event.MAX_LEAVES} leaves"),
])
def test_each_route_the_kernel_does_not_take_raises_with_its_reason(route, match):
    problem = {"sparse": lambda: problems.random_3regular_maxcut(64, 0, device=CPU),
               "scan": lambda: _sk(100, 0), "float64": lambda: DenseIsing(
                   J=_sk(100, 0).J.double(), b=torch.zeros(100, dtype=torch.float64)),
               "too_large": _huge}[route]()
    kernel = CTMC(site_draw="scan") if route == "scan" else CTMC()
    with pytest.raises(ValueError, match="ctmc_event") as err:
        run(problem, kernel, 0, n_steps=2, n_chains=2, backend="cuda")
    assert "does not support backend 'cuda' here" in str(err.value)
    assert match in str(err.value)
    if route != "too_large":  # a kernel told its backend raises at init
        with pytest.raises(ValueError, match=match):
            run(problem, dataclasses.replace(kernel, backend="cuda"), 0, n_steps=2, n_chains=2)


def test_faults_on_the_cuda_path_raise():
    problem = _sk(100, 0)
    faults = FaultModel(field_noise_std=0.1)
    with pytest.raises(NotImplementedError, match="ctmc_event takes no fault operands"):
        run(problem, CTMC(), 0, n_steps=2, n_chains=2, backend="cuda", faults=faults)
    state = CTMC(backend="cuda").init(problem, torch.Generator().manual_seed(0), n_chains=2)
    ones = torch.ones(2)
    with pytest.raises(NotImplementedError, match="no fault operands"):
        CTMC(backend="cuda").update(problem, state, ones, ones / 2, ones, keep=ones > 0)
    # a fault model with nothing dynamic left binds away: the kernel runs
    assert run(problem, CTMC(), 0, n_steps=3, n_chains=2, backend="cuda",
               faults=FaultModel()).s.shape == (2, 100)


def test_auto_leaves_the_kernel_out_under_a_fault_model(monkeypatch):
    problem = _sk(100, 0)
    noisy = FaultModel(field_noise_std=0.1)
    seen = []
    resolve = sampler_api._resolve_backend

    def spy(backend, kernel=None, problem=None, faults=None):
        seen.append(faults)
        return resolve(backend, kernel, problem, faults)

    monkeypatch.setattr(sampler_api, "_resolve_backend", spy)
    # run() resolves against the fault model bind() leaves: none, or a noisy one
    for faults, left in ((FaultModel(), False), (noisy, True)):
        call = sampler_api._prepare(problem, CTMC(), n_steps=2, n_chains=2, backend="auto",
                                    faults=faults)
        assert call.kernel.backend == "ref"
        assert (seen.pop() is not None) is left
    # on a problem on the card, "auto" takes the kernel, but not with faults
    monkeypatch.setattr(DenseIsing, "device", property(lambda self: torch.device("cuda")))
    assert resolve("auto", CTMC(), problem) == "cuda"
    assert resolve("auto", CTMC(), problem, noisy) == "ref"
    with pytest.raises(ValueError, match="site_draw='scan'"):
        resolve("cuda", CTMC(site_draw="scan"), problem, noisy)
    assert resolve("cuda", CTMC(), problem, noisy) == "cuda"  # init raises, as above


def test_the_wrapper_refuses_a_tree_past_shared_memory_and_bad_operands(monkeypatch):
    monkeypatch.setattr(ctmc_event, "check_cuda", lambda t: t.device)
    B, n = 2, ctmc_event.MAX_LEAVES + 1
    s = torch.zeros(()).expand(B, n)
    with pytest.raises(ValueError, match="at most 16384 leaves"):
        ctmc_event.ctmc_event(s, s, torch.zeros(B), torch.zeros(B), torch.zeros(()).expand(n, n),
                              *(torch.zeros(B),) * 3)
    assert ctmc_event.leaves_refusal(ctmc_event.MAX_LEAVES) is None
    assert ctmc_event.MAX_LEAVES * ctmc_event.TREE_BYTES_PER_LEAF <= 232448
    s = torch.ones(B, 8)
    with pytest.raises(ValueError, match="J must have shape"):
        ctmc_event.ctmc_event(s, s, torch.zeros(B), torch.zeros(B), torch.zeros(7, 7),
                              *(torch.zeros(B),) * 3)


@pytest.fixture
def fake_kernel(monkeypatch):
    """The wrapper's launches on CPU tensors: its checks pass, its launcher
    does nothing, and `ops` sends every call to it. Returns the launches."""
    launches = []
    monkeypatch.setattr(ctmc_event, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(ops, "_use_kernel", lambda t, mode: True)
    monkeypatch.setattr(_build, "launcher",
                        lambda name: lambda *args: launches.append((name, args[-5:-1])) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return launches


def test_a_cuda_run_counts_one_launch_an_event(fake_kernel, launched):
    sampler_api.drop_kept_runs()
    problem = _sk(100, 6)
    run(problem, CTMC(lambda0=0.5), 1, backend="cuda", n_steps=7, n_chains=3, sample_every=7)
    assert launched() == {"ctmc_event": 7}
    assert {name for name, _ in fake_kernel} == {"ctmc_event"}
    # (B, n, m, lambda0) as the launcher takes them
    assert fake_kernel[0][1] == (3, 100, 128, 0.5)
    run(problem, CTMC(), 1, backend="ref", n_steps=7, n_chains=3)
    assert launched() == {"ctmc_event": 7}  # the plain backend launches nothing
    sampler_api.drop_kept_runs()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,events,lambda0", [(256, 2000, 1000, 1.0), (7, 100, 1000, 0.5),
                                                 (3, 2001, 200, 1.0)])
def test_the_kernel_equals_the_plain_version_on_the_card(B, n, events, lambda0):
    dev = _card()
    problem = _sk(n, 1, dev, bias=0.1)
    s = _start(problem, B, 2)
    h = problem.local_fields(s)
    state = (s, h, problem.energy(s), torch.zeros(B, device=dev))
    g = torch.Generator(device=dev).manual_seed(3)
    beta = 0.3 + 2.7 * torch.rand(B, generator=g, device=dev)
    before = tracing.counts()["launch.ctmc_event"]
    for k in range(events):
        expo = torch.empty(B, device=dev).exponential_(generator=g)
        u = torch.rand(B, generator=g, device=dev)
        got = ops.ctmc_event(*state, problem.J, beta, expo, u, lambda0)
        want = ref.ctmc_event_ref(*state, problem.J, beta, expo, u, lambda0)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), k
        state = got
    assert tracing.counts()["launch.ctmc_event"] - before == events


@pytest.mark.cuda
def test_a_graphed_cuda_run_equals_the_plain_backend_on_the_card():
    dev = _card()
    problem = _sk(2000, 5, dev)
    kw = dict(n_steps=600, n_chains=256, sample_every=100,
              schedule=sampler_api.geometric(0.3, 3.0))
    before = tracing.counts()["launch.ctmc_event"]
    got = run(problem, CTMC(), 2147483931, backend="cuda", **kw)
    torch.cuda.synchronize()
    assert tracing.counts()["launch.ctmc_event"] - before == 600
    want = run(problem, CTMC(), 2147483931, backend="ref", **kw)
    for field in FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
