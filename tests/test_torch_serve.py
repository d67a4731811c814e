"""The port's serving engine and `launch.serve` against the JAX package.

Greedy completions are held token for token, in the same finish order, to
the JAX `Engine`'s at the reduced configs, with the weights carried across
by `params_from_jax`: 2 slots and 5 requests of unequal prompt lengths and
token budgets, so slots are evicted and refilled at different steps and
decode on the shared position clock. Temperature sampling draws from the
engine's own generator (torch cannot replay JAX's threefry stream): it is
held by determinism under a seed and by a chi-square test of one logits row
at p > 1e-3."""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert, model
from repro_torch.serve import engine

torch.set_num_threads(1)

# (prompt length, max new tokens) of each request
REQUESTS = [(5, 6), (11, 3), (3, 7), (8, 4), (6, 5)]


def _pair(arch):
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    params, _ = jmodel.init_params(jcfg, jax.random.key(0))
    m = model.init_params(cfg, 0, device="cpu")
    m.load_state_dict(convert.params_from_jax(cfg, jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, m


def _requests(cfg, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, cfg.vocab_size, S).astype(np.int32), n)
            for uid, (S, n) in enumerate(shapes)]


def _serve(make_engine, request_type, requests, temperature=0.0):
    eng = make_engine()
    for uid, prompt, n in requests:
        eng.submit(request_type(uid=uid, prompt=prompt, max_new_tokens=n,
                                temperature=temperature))
    return [(c.uid, [int(t) for t in c.tokens]) for c in eng.run()]


def _both(arch, shapes, n_slots):
    jcfg, cfg, params, m = _pair(arch)
    reqs = _requests(cfg, shapes)
    want = _serve(lambda: jengine.Engine(jcfg, params, n_slots=n_slots, max_len=32, seed=0),
                  jengine.Request, reqs)
    got = _serve(lambda: engine.Engine(cfg, m, n_slots=n_slots, max_len=32, seed=0,
                                       device="cpu"), engine.Request, reqs)
    return got, want


@pytest.mark.parametrize("arch", ["gemma-2b", "phi4-mini-3p8b", "olmoe-1b-7b"])
def test_greedy_engine_equals_jax(arch):
    got, want = _both(arch, REQUESTS, n_slots=2)
    assert got == want
    budgets = dict(enumerate(n for _, n in REQUESTS))
    assert sorted(uid for uid, _ in got) == list(budgets)
    assert all(len(tokens) == budgets[uid] for uid, tokens in got)
    assert [uid for uid, _ in got] != sorted(uid for uid, _ in got), "refill reorders finishes"


def test_shared_position_clock_is_the_jax_quirk():
    """A short prompt batched beside a long one decodes at the long one's
    position over zero-filled cache rows the mask counts valid: the port
    reproduces the JAX engine there, and the short request's completion
    differs from what it gets alone."""
    shapes = [(3, 6), (12, 6)]
    got, want = _both("phi4-mini-3p8b", shapes, n_slots=2)
    alone, alone_jax = _both("phi4-mini-3p8b", shapes[:1], n_slots=1)
    assert got == want and alone == alone_jax
    assert dict(got)[0] != dict(alone)[0]


def test_temperature_sampling_is_deterministic_under_a_seed():
    _, cfg, _, m = _pair("phi4-mini-3p8b")
    reqs = _requests(cfg, REQUESTS)

    def run(seed):
        return _serve(lambda: engine.Engine(cfg, m, n_slots=2, max_len=32, seed=seed,
                                            device="cpu"), engine.Request, reqs, 0.7)

    first = run(3)
    assert first == run(3)
    assert first != run(4)


def test_temperature_sample_follows_the_softmax():
    _, cfg, _, m = _pair("phi4-mini-3p8b")
    eng = engine.Engine(cfg, m, n_slots=1, max_len=8, seed=5, device="cpu")
    logits = torch.tensor([1.0, -0.5, 0.3, 2.0, 0.0, -2.0])
    temperature, n = 0.7, 20000
    req = engine.Request(uid=0, prompt=np.zeros(1, np.int32), temperature=temperature)
    counts = np.bincount([eng._sample(logits, req) for _ in range(n)], minlength=6)
    expected = n * torch.softmax(logits / temperature, -1).numpy()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert stats.chi2.sf(chi2, df=5) > 1e-3, (counts, expected)
    assert eng._sample(logits, engine.Request(uid=1, prompt=req.prompt)) == 3


def test_kept_logits_are_the_rows_each_token_was_sampled_from():
    _, cfg, _, m = _pair("phi4-mini-3p8b")
    reqs = _requests(cfg, REQUESTS)
    eng = engine.Engine(cfg, m, n_slots=2, max_len=32, seed=0, device="cpu", keep_logits=True)
    for uid, prompt, n in reqs:
        eng.submit(engine.Request(uid=uid, prompt=prompt, max_new_tokens=n))
    done = eng.run()
    assert sorted(eng.sampled_logits) == [uid for uid, _, _ in reqs]
    for c in done:
        rows = eng.sampled_logits[c.uid]
        assert [int(r.argmax()) for r in rows] == c.tokens
        assert all(r.shape == (cfg.vocab_size,) and r.dtype == torch.float32 for r in rows)
    # the first row is the prompt's own last-position prefill logits
    uid, prompt, _ = reqs[1]
    alone, _ = m.prefill(torch.as_tensor(prompt[None], dtype=torch.int64),
                         model.init_caches(cfg, 1, 32, device="cpu"))
    torch.testing.assert_close(eng.sampled_logits[uid][0], alone[0], rtol=0, atol=0)


def test_launch_serve_main_on_the_cpu():
    out = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert out["arch"] == "phi4-mini-3p8b" and out["reduced"] and out["device"] == "cpu"
    assert sorted(c["uid"] for c in out["completions"]) == [0, 1, 2]
    assert all(len(c["tokens"]) == 4 for c in out["completions"]) and out["tokens"] == 12
    assert len(out["prefill_ms"]) == 3 and len(out["decode_ms"]) >= 3
    assert out["nonfinite_logits"] == 0 and out["weight_bytes"] > 0


def test_launch_serve_rejects_a_checkpoint():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--ckpt-dir", "ckpt"])


def test_unported_family_raises_through_main():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        serve.main(["--device", "cpu", "--arch", "xlstm-125m"])


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("phi4-mini-3p8b", reduced=True)
    m = model.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.Engine(cfg, m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg)


def test_engine_rejects_a_request_past_max_len():
    cfg = get_config("phi4-mini-3p8b", reduced=True)
    eng = engine.Engine(cfg, model.init_params(cfg, 0, device="cpu"), n_slots=1, max_len=8,
                        device="cpu")
    eng.submit(engine.Request(uid=0, prompt=np.zeros(6, np.int32), max_new_tokens=4))
    with pytest.raises(ValueError, match="exceed"):
        eng.run()
