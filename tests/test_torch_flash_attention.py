"""The port's flash attention (plain version and dispatch) against the JAX
package's oracle and its Pallas kernel in interpret mode, the sliding-window
band against the JAX package's `causal_mask` attention, the key-length bound
against JAX attention under a key mask, the kernel wrapper's argument checks,
and, on a card, the CUDA kernel against its plain version.

Inputs are made with numpy from a seed and go through both packages. The
tolerances are the JAX test's (tests/test_kernels.py): 2e-5 in float32 and
2e-2 in bfloat16, absolute and relative; the softmax sums run in another
order in each implementation; in bfloat16 the port's oracle is held to
one ulp of JAX's, since both round f32 results of the same sums."""
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import flash_attention, ops, ref

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (BH, Sq, Sk, d, causal, dtype): the JAX test's grid, then causal Sq != Sk
CASES = [
    (2, 256, 256, 64, True, "float32"),
    (4, 128, 384, 32, False, "float32"),
    (1, 512, 512, 128, True, "bfloat16"),
    (2, 256, 256, 64, True, "bfloat16"),
    (2, 256, 128, 64, True, "float32"),
    (2, 128, 384, 64, True, "bfloat16"),
]


def _qkv(BH, Sq, Sk, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 0.5, (BH, S, d))).astype(np.float32) for S in (Sq, Sk, Sk)]


def _torch(arrays, dtype, device="cpu"):
    return [torch.as_tensor(a, device=device).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _f32(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("BH,Sq,Sk,d,causal,dtype", CASES)
def test_plain_version_matches_jax_oracle_and_pallas(BH, Sq, Sk, d, causal, dtype):
    arrays = _qkv(BH, Sq, Sk, d, seed=BH * Sq + Sk + d)
    tq, tk, tv = _torch(arrays, dtype)
    jq, jk, jv = _jax(arrays, dtype)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (BH, Sq, d)
    via_ops = ops.flash_attention(tq, tk, tv, causal=causal)  # mode="auto" on CPU tensors
    np.testing.assert_array_equal(_f32(via_ops), _f32(got))
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    pallas = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                                 interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    # both oracles round f32 results of the same sums: in bf16, one ulp apart at most
    to_oracle = dict(atol=tol, rtol=tol) if dtype == "float32" else dict(atol=1e-6, rtol=2**-7)
    np.testing.assert_allclose(_f32(got), _f32(want), **to_oracle)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(5, 7), (9, 3), (1, 1)])
def test_plain_version_takes_any_sequence_length(Sq, Sk, causal):
    arrays = _qkv(3, Sq, Sk, 8, seed=Sq * 10 + Sk)
    got = ref.flash_attention_ref(*_torch(arrays, "float32"), causal=causal)
    want = jref.flash_attention_ref(*_jax(arrays, "float32"), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)
    if causal:  # query 0 sees key 0 only
        np.testing.assert_allclose(_f32(got)[:, 0], arrays[2][:, 0], atol=2e-5, rtol=2e-5)


# (S, window): a band inside one 128-row tile, across tiles, not a multiple
# of 128, of one key, and as wide as the sequence
WINDOWS = [(40, 7), (256, 64), (300, 200), (128, 1), (130, 130)]


@pytest.mark.parametrize("S,window", WINDOWS)
def test_windowed_plain_version_matches_jax_banded_attention(S, window):
    """The band i - window < j <= i is the JAX package's
    `causal_mask(S, S, window)` (models/attention.py), held here against
    dense JAX attention under that mask, f32 scores and softmax."""
    arrays = _qkv(2, S, S, 16, seed=S + window)
    got = ops.flash_attention(*_torch(arrays, "float32"), causal=True, window=window)
    q, k, v = _jax(arrays, "float32")
    s = jnp.einsum("bqd,bkd->bqk", q, k) / jnp.sqrt(jnp.float32(16))
    s = jnp.where(jattention.causal_mask(S, S, window)[None], s, -1e30)
    want = jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(s, axis=-1), v)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)
    if window == 1:  # each query sees itself only
        np.testing.assert_allclose(_f32(got), arrays[2], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_window_as_wide_as_the_keys_is_the_causal_call(dtype):
    tq, tk, tv = _torch(_qkv(2, 256, 256, 32, seed=5), dtype)
    causal = ops.flash_attention(tq, tk, tv, causal=True)
    for window in (256, 1000):
        assert torch.equal(ops.flash_attention(tq, tk, tv, causal=True, window=window), causal)
    assert not torch.equal(ops.flash_attention(tq, tk, tv, causal=True, window=255), causal)


def test_window_checks_and_the_windowed_launch_count(monkeypatch, launched):
    """A window needs causal (ops, the plain version and the wrapper raise)
    and, on the kernel, Sq <= Sk; a banded launch counts as
    launch.flash_attention and launch.flash_attention_window, with the
    window passed to the launcher."""
    tq, tk, tv = _torch(_qkv(2, 128, 256, 64, seed=3), "float32")
    for fn in (ops.flash_attention, ref.flash_attention_ref, flash_attention.flash_attention):
        with pytest.raises(ValueError, match="needs causal"):
            fn(tq, tk, tv, False, window=4)
        with pytest.raises(ValueError, match="needs causal"):
            fn(tq, tk, tv, True, window=-1)
    calls = []
    monkeypatch.setattr(flash_attention, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(flash_attention, "_launch",
                        lambda q, k, v, out, causal, window, kv_len, bf16, device:
                        calls.append(window))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention.flash_attention(tk, tq, tq, True, window=64)
    flash_attention.flash_attention(tq, tk, tv, True, window=64)
    flash_attention.flash_attention(tq, tk, tv, True)
    assert calls == [64, 0]
    assert launched()["flash_attention"] == 2 and launched()["flash_attention_window"] == 1


# (BH, Sq, Sk, d, kv_len): whisper's 1500 frames padded to 1536 keys (the
# encoder's square call, narrowed, and the cross-attention's 128 queries), a
# bound mid-tile, and one at Sk (no key masked)
KV_LENS = [(2, 1536, 1536, 16, 1500), (2, 128, 1536, 64, 1500), (4, 128, 384, 32, 200),
           (2, 256, 384, 16, 384)]


@pytest.mark.parametrize("BH,Sq,Sk,d,kv_len", KV_LENS)
def test_kv_len_plain_version_matches_jax_key_masked_attention(BH, Sq, Sk, d, kv_len):
    """Keys j >= kv_len get no weight: held against dense JAX attention
    under that key mask (f32 scores and softmax); kv_len = Sk is the
    unbounded call bit for bit, and the keys past kv_len do not matter."""
    arrays = _qkv(BH, Sq, Sk, d, seed=Sk + kv_len)
    tq, tk, tv = _torch(arrays, "float32")
    got = ops.flash_attention(tq, tk, tv, causal=False, kv_len=kv_len)
    q, k, v = _jax(arrays, "float32")
    s = jnp.einsum("bqd,bkd->bqk", q, k) / jnp.sqrt(jnp.float32(d))
    s = jnp.where((jnp.arange(Sk) < kv_len)[None, None], s, -1e30)
    want = jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(s, axis=-1), v)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)
    if kv_len == Sk:
        assert torch.equal(got, ops.flash_attention(tq, tk, tv, causal=False))
    else:
        moved = [tk.clone(), tv.clone()]
        for t in moved:
            t[:, kv_len:] = 7.0
        assert torch.equal(ops.flash_attention(tq, *moved, causal=False, kv_len=kv_len), got)


def test_kv_len_checks_and_the_bounded_launch_count(monkeypatch, launched):
    """kv_len must lie in [1, Sk], and below Sk it needs causal=False (ops,
    the plain version and the wrapper raise); a bounded launch counts as
    launch.flash_attention and launch.flash_attention_kv_len, kv_len = Sk
    (or None) as launch.flash_attention alone, and the bound reaches the
    launcher; nothing launches for a refusal."""
    tq, tk, tv = _torch(_qkv(2, 128, 256, 64, seed=3), "float32")
    calls = []
    monkeypatch.setattr(flash_attention, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(flash_attention, "_launch",
                        lambda q, k, v, out, causal, window, kv_len, bf16, device:
                        calls.append((causal, kv_len)))
    for fn in (ops.flash_attention, ref.flash_attention_ref, flash_attention.flash_attention):
        for kv_len in (0, -3, 257):
            with pytest.raises(ValueError, match="must lie in"):
                fn(tq, tk, tv, False, kv_len=kv_len)
        with pytest.raises(ValueError, match="needs causal=False"):
            fn(tq, tk, tv, True, kv_len=200)
    assert calls == [] and launched()["flash_attention"] == 0
    flash_attention.flash_attention(tq, tk, tv, False, kv_len=200)
    flash_attention.flash_attention(tq, tk, tv, False, kv_len=256)
    flash_attention.flash_attention(tq, tk, tv, True, kv_len=256)
    flash_attention.flash_attention(tq, tk, tv, False)
    assert calls == [(False, 200), (False, 256), (True, 256), (False, 256)]
    assert launched()["flash_attention"] == 4 and launched()["flash_attention_kv_len"] == 1


def test_ops_modes_on_cpu_and_the_kernel_wrapper_checks(launched):
    tq, tk, tv = _torch(_qkv(2, 128, 256, 64, seed=3), "float32")
    np.testing.assert_array_equal(
        ops.flash_attention(tq, tk, tv).numpy(),
        ops.flash_attention(tq, tk, tv, mode="reference").numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(tq, tk, tv, mode="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention(tq, tk, tv)
    with pytest.raises(ValueError, match="mode"):
        ops.flash_attention(tq, tk, tv, mode="pallas")
    # shapes and dtypes the kernel does not take raise, whatever the device
    with pytest.raises(ValueError, match="multiples of 128"):
        flash_attention.flash_attention(tq[:, :100], tk, tv)
    with pytest.raises(ValueError, match="multiples of 128"):
        flash_attention.flash_attention(tq, tk[:, :200], tv[:, :200])
    for d in (12, 264):
        q, k, v = _torch(_qkv(1, 128, 128, d, seed=d), "float32")
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            flash_attention.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        flash_attention.flash_attention(tq, tk.bfloat16(), tv)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        flash_attention.flash_attention(tq.half(), tk.half(), tv.half())
    assert launched()["flash_attention"] == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _emulate_bf16_kernel(q, k, v, causal, parts, block_n=128):
    """The bf16 CUDA kernel's arithmetic in torch: scores from bf16 q and k
    summed in f32, the online softmax in f32 over key tiles of block_n, p
    split into `parts` bf16 parts (1: p rounded to bf16), each part times
    bf16 v summed in f32, the row sum from the unrounded p; out in bf16."""
    BH, Sq, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((BH, Sq, 1), -1e30)
    l = torch.zeros((BH, Sq, 1))
    o = torch.zeros((BH, Sq, d))
    rows = torch.arange(Sq)[:, None]
    sl2 = 1.4426950408889634 / d**0.5
    for k0 in range(0, k.shape[1], block_n):
        s = qf @ kf[:, k0:k0 + block_n].transpose(1, 2)
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + block_n)[None, :] > rows, -1e30)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s * sl2 - mn * sl2)
        alpha = torch.exp2(m * sl2 - mn * sl2)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv, rest = torch.zeros_like(o), p
        for _ in range(parts):
            part = rest.bfloat16().float()
            pv = pv + part @ vf[:, k0:k0 + block_n]
            rest = rest - part
        o = alpha * o + pv
        m = mn
    return (o / l.clamp_min(1e-30)).bfloat16()


def test_bf16_kernel_scheme_passes_the_chip_check_where_one_bf16_p_fails():
    """The bf16 kernel splits p into three bf16 parts for p v. Emulated at
    BH = 2, S = 2048, d = 64, causal, it holds chip_smoke.py's check (one
    bf16 ulp of the f32 plain version); p rounded to one bf16, the usual
    flash-attention recipe, does not."""
    chip_smoke = _chip_smoke()
    q, k, v = _torch(_qkv(2, 2048, 2048, 64, seed=7), "bfloat16")
    _, ulps = chip_smoke.check_attention(torch, ops, "three parts",
                                         _emulate_bf16_kernel(q, k, v, True, parts=3),
                                         q, k, v, True)
    assert ulps <= 0.5 + 1e-3  # the output rounding only
    with pytest.raises(AssertionError, match="bf16 ulps"):
        chip_smoke.check_attention(torch, ops, "one part",
                                   _emulate_bf16_kernel(q, k, v, True, parts=1), q, k, v, True)


def test_two_bf16_parts_of_p_fail_the_chip_check_at_the_first_rows():
    """Two bf16 parts hold p to 2^-18 of itself. At the first rows of a
    head a few terms of ~0.1 can cancel to an output of ~1e-5, where the
    check's bound is ~1e-6, and 2^-18 of the terms exceeds it: over 512
    heads of 128 rows the two-part scheme fails, the three-part one holds
    (both emulated)."""
    chip_smoke = _chip_smoke()
    q, k, v = _torch(_qkv(512, 128, 128, 128, seed=11), "bfloat16")
    with pytest.raises(AssertionError, match="bf16 ulps"):
        chip_smoke.check_attention(torch, ops, "two parts",
                                   _emulate_bf16_kernel(q, k, v, True, parts=2), q, k, v, True)
    _, ulps = chip_smoke.check_attention(torch, ops, "three parts",
                                         _emulate_bf16_kernel(q, k, v, True, parts=3),
                                         q, k, v, True)
    assert ulps <= 0.5 + 1e-3


def test_the_wrapper_routes_by_dtype_and_counts_each(monkeypatch, launched):
    """bf16 goes to the wgmma kernel and f32 to the CUDA-core one (the
    launcher's bf16 flag), counted as launch.flash_attention_bf16 and
    launch.flash_attention_f32 beside launch.flash_attention; no card: the
    device check and the launch are replaced."""
    calls = []
    monkeypatch.setattr(flash_attention, "check_cuda", lambda t: t.device)
    monkeypatch.setattr(flash_attention, "_launch",
                        lambda q, k, v, out, causal, window, kv_len, bf16, device:
                        calls.append(bf16))
    for dtype, n in (("bfloat16", 2), ("float32", 1)):
        q, k, v = _torch(_qkv(2, 128, 256, 64, seed=3), dtype)
        for _ in range(n):
            out = flash_attention.flash_attention(q, k, v, True)
            assert out.dtype == q.dtype and out.shape == q.shape
    assert calls == [True, True, False]
    assert launched() == {"flash_attention_f32": 1, "flash_attention_bf16": 2,
                          "flash_attention": 3}


def test_chip_check_catches_a_dropped_key_tile():
    """chip_smoke.py's bf16 attention check holds outputs to one bf16 ulp of
    the f32 plain version. At long S the causal outputs are small (the
    softmax is near uniform), so a kernel that drops a key tile for the
    late rows stays within 2e-2 but not within that bound."""
    chip_smoke = _chip_smoke()
    BH, S, d = 2, 2048, 64
    q, k, v = _torch(_qkv(BH, S, S, d, seed=7), "bfloat16")
    exact = ops.flash_attention(q, k, v, mode="reference")
    _, ulps = chip_smoke.check_attention(torch, ops, "exact", exact, q, k, v, True)
    assert 0.0 < ulps <= 0.5 + 1e-3  # the bf16 rounding only
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    keep[S // 2:, 64:128] = False  # key tile 1 dropped for the late rows
    scores = (q.float() @ k.float().transpose(1, 2) / d**0.5).masked_fill(~keep, -1e30)
    dropped = (scores.softmax(-1) @ v.float()).bfloat16()
    np.testing.assert_allclose(_f32(dropped), _f32(exact), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])
    with pytest.raises(AssertionError, match="bf16 ulps"):
        chip_smoke.check_attention(torch, ops, "dropped", dropped, q, k, v, True)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Sq,Sk,d,causal,dtype", CASES + [
    (1, 256, 256, 256, True, "float32"), (2, 256, 256, 8, False, "bfloat16"),
    (4, 128, 384, 32, False, "bfloat16"), (3, 128, 256, 8, True, "bfloat16")])
def test_kernel_matches_plain_version_on_the_card(BH, Sq, Sk, d, causal, dtype, launched):
    """The CUDA kernel against its plain version at chip_smoke.py's check
    shapes, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _torch(_qkv(BH, Sq, Sk, d, seed=BH * Sq + Sk + d), dtype, device="cuda")
    got = ops.flash_attention(q, k, v, causal=causal)
    assert launched()["flash_attention"] == 1 and got.dtype == q.dtype
    assert launched()["flash_attention_" + {"float32": "f32", "bfloat16": "bf16"}[dtype]] == 1
    plain = ops.flash_attention(q, k, v, causal=causal, mode="reference")
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,d,window", [(4, 512, 64, 200), (2, 1024, 128, 128),
                                           (1, 2176, 256, 2048)])
def test_banded_kernel_matches_plain_version_on_the_card(BH, S, d, window, dtype):
    """The band on both kernels against the plain version; a window as wide
    as the keys equals the causal launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    q, k, v = _torch(_qkv(BH, S, S, d, seed=S + window), dtype, device="cuda")
    got = flash_attention.flash_attention(q, k, v, True, window)
    plain = ops.flash_attention(q, k, v, True, mode="reference", window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain.float(), atol=tol, rtol=tol)
    causal = flash_attention.flash_attention(q, k, v, True)
    assert torch.equal(flash_attention.flash_attention(q, k, v, True, S), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,Sq,Sk,d,kv_len", [(16, 1536, 1536, 64, 1500),
                                               (16, 128, 1536, 64, 1500),
                                               (4, 128, 384, 32, 200), (2, 256, 512, 64, 384)])
def test_bounded_kernel_matches_plain_version_on_the_card(BH, Sq, Sk, d, kv_len, dtype):
    """The key-length bound on both kernels against the plain version; a
    bound of Sk equals the unbounded launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an sm_90 card); chip_smoke.py checks it there")
    q, k, v = _torch(_qkv(BH, Sq, Sk, d, seed=Sk + kv_len), dtype, device="cuda")
    got = flash_attention.flash_attention(q, k, v, False, kv_len=kv_len)
    plain = ops.flash_attention(q, k, v, False, mode="reference", kv_len=kv_len)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain.float(), atol=tol, rtol=tol)
    assert torch.equal(flash_attention.flash_attention(q, k, v, False, kv_len=Sk),
                       flash_attention.flash_attention(q, k, v, False))
