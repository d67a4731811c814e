"""The port's int8 field kernels (plain versions and dispatch) against the
JAX package's oracles and its Pallas kernels in interpret mode.

Inputs are made with numpy from a seed. The int32 accumulators must be
exact; tau-leap spins must be equal except where the uniform lies within
P_BAND of the flip probability (the two frameworks' exp and sigmoid may
round the last ulp differently)."""
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import dense_field as jdf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tau_leap as jtl
from repro_torch.kernels import ops, ref, tau_leap

torch.set_num_threads(1)

P_BAND = 1e-6
REPO = Path(__file__).resolve().parents[1]


def _check_shapes():
    """chip_smoke.py's CHECK_SHAPES: the (B, N) the card checks the kernels at."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.CHECK_SHAPES


def _inputs(B, N, seed):
    rng = np.random.default_rng(seed)
    s = rng.choice([-1.0, 1.0], (B, N)).astype(np.float32)
    J = rng.integers(-127, 128, (N, N)).astype(np.int8)  # asymmetric codes
    b = (rng.normal(0, 1, N) * 0.2).astype(np.float32)
    u = rng.random((B, N)).astype(np.float32)
    return s, J, b, u


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize(
    "B,N,blocks",
    [(8, 64, (8, 64, 64)), (128, 128, (128, 128, 128)), (64, 300, (64, 128, 128)),
     (130, 256, (128, 128, 128))],
)
def test_dense_field_ref_matches_jax(B, N, blocks):
    s, J, b, _ = _inputs(B, N, seed=B + N)
    s_i8 = s.astype(np.int8)
    scale = np.float32(0.0173)
    ts, tJ, tb = _t(s_i8, J, b)
    tscale = torch.tensor(scale)
    # accumulators: exact against numpy's int64 product
    acc = ref.dense_acc_ref(ts, tJ)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), s_i8.astype(np.int64) @ J.T.astype(np.int64))
    got = ops.dense_field(ts, tJ, tb, tscale).numpy()
    want = np.asarray(jref.dense_field_ref(jnp.asarray(s_i8), jnp.asarray(J), jnp.asarray(b), scale))
    np.testing.assert_array_equal(got, want)
    bb, bn, bk = blocks
    pallas = jdf.dense_field(
        jnp.asarray(s_i8), jnp.asarray(J), jnp.asarray(b), jnp.asarray(scale),
        block_b=bb, block_n=bn, block_k=bk, interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,N", [(8, 64), (32, 200), (128, 128), (3, 5)])
def test_tau_leap_step_ref_matches_jax(B, N):
    s, J, b, u = _inputs(B, N, seed=7 * N + B)
    scale, dt = np.float32(1.0 / 127.0), np.float32(0.3)
    ts, tJ, tb, tu = _t(s, J, b, u)
    tscale, tdt = torch.tensor(scale), torch.tensor(dt)
    got = ops.tau_leap_step(ts, tJ, tb, tscale, tu, tdt).numpy()
    p = ref.tau_leap_flip_prob_ref(ts, tJ, tb, tscale, tdt).numpy()
    in_band = np.abs(u - p) <= P_BAND
    args = [jnp.asarray(x) for x in (s, J, b, scale, u, dt)]
    want = np.asarray(jref.tau_leap_step_ref(*args))
    pallas = np.asarray(
        jtl.tau_leap_step(*args, block_b=64, block_n=64, block_k=64, interpret=True)
    )
    for other in (want, pallas):
        differ = got != other
        assert not np.any(differ & ~in_band), np.argwhere(differ & ~in_band)[:5]
    assert set(np.unique(got)) <= {-1.0, 1.0}
    assert np.any(got != s)  # the step flipped something


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_dense_matches_jax(seed):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 0.5, (40, 40)).astype(np.float32)
    # ties: entries exactly half-way between codes round half to even
    J[0, :4] = np.float32(np.abs(J).max()) * np.array([0.5, 1.5, 2.5, -2.5], np.float32) / 127
    for M in (J, np.zeros((6, 6), np.float32)):
        codes, scale = ops.quantize_dense(torch.as_tensor(M))
        jcodes, jscale = jops.quantize_dense(jnp.asarray(M))
        assert codes.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        assert scale.item() == float(jscale)
    assert ops.quantize_dense(torch.zeros((3, 3)))[1].item() == 1.0


def test_per_row_beta_folds_like_one_jax_call_per_row():
    """ops.tau_leap_step with a (B,) beta == the JAX kernel called once per
    row with that row's beta*scale and beta*b (how the JAX driver folds beta
    into its vmapped B = 1 calls)."""
    B, N = 6, 96
    s, J, b, u = _inputs(B, N, seed=11)
    beta = np.random.default_rng(12).uniform(0.2, 3.0, B).astype(np.float32)
    scale, dt = np.float32(0.0123), np.float32(0.4)
    ts, tJ, tb, tu, tbeta = _t(s, J, b, u, beta)
    got = ops.tau_leap_step(ts, tJ, tb, torch.tensor(scale), tu, float(dt), beta=tbeta).numpy()
    p = ref.tau_leap_flip_prob_ref(
        ts, tJ, tbeta[:, None] * tb, (tbeta * torch.tensor(scale))[:, None], torch.tensor(dt)
    ).numpy()
    for r in range(B):
        jb = jnp.asarray(beta[r]) * jnp.asarray(b)
        jscale = jnp.asarray(beta[r]) * jnp.asarray(scale)
        want = np.asarray(jops.tau_leap_step(
            jnp.asarray(s[r:r + 1]), jnp.asarray(J), jb, jscale, jnp.asarray(u[r:r + 1]),
            jnp.asarray(dt), mode="kernel", block_b=8, block_n=32, block_k=32,
        ))[0]
        differ = got[r] != want
        assert not np.any(differ & (np.abs(u[r] - p[r]) > P_BAND)), r
    # beta = 1 everywhere is the plain signature
    ones = ops.tau_leap_step(ts, tJ, tb, torch.tensor(scale), tu, float(dt),
                             beta=torch.ones(B))
    plain = ops.tau_leap_step(ts, tJ, tb, torch.tensor(scale), tu, float(dt))
    np.testing.assert_array_equal(ones.numpy(), plain.numpy())


def test_kernel_mode_on_cpu_raises_and_counts_nothing(launched):
    s, J, b, u = _inputs(4, 16, seed=5)
    ts, tJ, tb, tu = _t(s, J, b, u)
    scale, dt = torch.tensor(0.01), torch.tensor(0.3)
    ops.dense_field(ts.to(torch.int8), tJ, tb, scale)
    ops.dense_field(ts.to(torch.int8), tJ, tb, scale, mode="reference")
    ops.tau_leap_step(ts, tJ, tb, scale, tu, dt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dense_field(ts.to(torch.int8), tJ, tb, scale, mode="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.tau_leap_step(ts, tJ, tb, scale, tu, dt, mode="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tau_leap.tau_leap_step(ts, tJ, tb, scale, tu, dt, torch.ones(4))
    with pytest.raises(ValueError, match="mode"):
        ops.dense_field(ts.to(torch.int8), tJ, tb, scale, mode="pallas")
    assert launched()["tau_leap_step"] == 0 and launched()["dense_field"] == 0


@pytest.mark.parametrize("B,N", _check_shapes())
def test_packed_spins_are_int8_spins_in_16_byte_rows_zero_padded(B, N):
    """tau_leap_step's packing launch writes s as int8 into (B, ld) rows,
    ld = N rounded up to 16 bytes: s.to(int8) on the live columns, 0 in the
    padding (the plain version of that layout)."""
    s, _, _, _ = _inputs(B, N, seed=B * N)
    ld = tau_leap.padded_cols(N)
    assert ld % 16 == 0 and N <= ld < N + 16
    packed = ref.pack_spins_ref(torch.as_tensor(s), ld)
    assert packed.dtype == torch.int8 and packed.shape == (B, ld) and packed.is_contiguous()
    np.testing.assert_array_equal(packed[:, :N].numpy(), s.astype(np.int8))
    assert not packed[:, N:].any()
    # astype(int8) truncates toward zero, as the kernel's __float2int_rz
    odd = torch.tensor([[0.7, -0.7, 1.9, -1.0]])
    np.testing.assert_array_equal(ref.pack_spins_ref(odd, 16)[0, :4].numpy(), [0, 0, 1, -1])


def test_tau_leap_wrapper_passes_a_padded_int8_scratch(monkeypatch, launched):
    """The wrapper allocates the packed spins as a (B, padded_cols(N)) int8
    tensor on s's device and launches once per call; no card: the device
    check and the launch are replaced."""
    seen = []
    monkeypatch.setattr(tau_leap, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(tau_leap, "_launch", lambda *args: seen.append(args))
    B, N = 3, 130
    s, J, b, u = _t(*_inputs(B, N, seed=1))
    out = tau_leap.tau_leap_step(s, J, b, torch.tensor(0.01), u, torch.tensor(0.3), torch.ones(B))
    assert out.shape == (B, N) and out.dtype == torch.float32 and out.data_ptr() != s.data_ptr()
    (args,) = seen
    s8 = args[1]
    assert s8.dtype == torch.int8 and s8.shape == (B, 144) and s8.is_contiguous()
    assert s8.data_ptr() % 16 == 0 and launched()["tau_leap_step"] == 1
