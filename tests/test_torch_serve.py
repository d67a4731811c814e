"""The port's serving engine and `launch.serve` against the JAX package.

Greedy completions are held token for token, in the same finish order, to
the JAX `Engine`'s at the reduced configs of every decoder-only family, with
the weights carried across by `params_from_jax`: 2 slots and 5 requests of
unequal prompt lengths and token budgets, so slots are evicted and refilled
at different steps and decode on the shared position clock; a vlm's
requests with and without image patches; a prompt longer than
recurrentgemma's window (32 at the reduced width), through the ring branch;
whisper-medium's requests, each with its frames.
At one slot the port departs from the JAX engine, whose slot insert loses
an unstacked recurrent state (ROADMAP, deliberate differences): there the
port is held to a direct prefill and decode. Temperature sampling draws from the
engine's own generator (torch cannot replay JAX's threefry stream): it is
held by determinism under a seed and by a chi-square test of one logits row
at p > 1e-3."""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import convert, model, transformer
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


def _requests(cfg, shapes, seed=0, patches=False):
    """(uid, prompt, max new tokens, extras) of each (prompt length, max new
    tokens); with `patches` a vlm's N(0, 0.02) image embeddings; an
    encoder-decoder's always with N(0, 0.02) frames."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid, (S, n) in enumerate(shapes):
        prompt = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
        extras = ({"patch_embeds": rng.normal(0.0, 0.02, (cfg.n_patches, cfg.d_model)).astype(
            np.float32)} if patches else None)
        if cfg.family == "audio":
            extras = {"frames": rng.normal(0.0, 0.02, (cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)}
        reqs.append((uid, prompt, n, extras))
    return reqs


def _serve(make_engine, request_type, requests, temperature=0.0):
    eng = make_engine()
    for uid, prompt, n, extras in requests:
        eng.submit(request_type(uid=uid, prompt=prompt, max_new_tokens=n,
                                temperature=temperature, extras=extras))
    return [(c.uid, [int(t) for t in c.tokens]) for c in eng.run()]


def _both(arch, shapes, n_slots, max_len=32, patches=False):
    jcfg, cfg, params, m = _pair(arch)
    reqs = _requests(cfg, shapes, patches=patches)
    want = _serve(lambda: jengine.Engine(jcfg, params, n_slots=n_slots, max_len=max_len,
                                         seed=0), jengine.Request, reqs)
    got = _serve(lambda: engine.Engine(cfg, m, n_slots=n_slots, max_len=max_len, seed=0,
                                       device="cpu"), engine.Request, reqs)
    return got, want


@pytest.mark.parametrize("arch", ["gemma-2b", "phi4-mini-3p8b", "olmoe-1b-7b", "internvl2-2b",
                                  "recurrentgemma-9b", "xlstm-125m", "whisper-medium"])
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


def test_vlm_requests_with_patches_equal_jax():
    """Image patches before each prompt, in a max_len that holds them."""
    got, want = _both("internvl2-2b", REQUESTS, n_slots=2, max_len=40, patches=True)
    assert got == want and len(got) == len(REQUESTS)
    plain, _ = _both("internvl2-2b", REQUESTS, n_slots=2, max_len=40)
    assert got != plain, "the patches reach the logits"


def test_a_prompt_past_the_window_through_the_ring_equals_jax():
    """recurrentgemma at the reduced width (window 32): a 45-token prompt
    beside short ones takes block_prefill's ring branch and the band, and
    the slots decode over 32-slot rings past their end."""
    got, want = _both("recurrentgemma-9b", [(45, 6), (5, 8), (9, 4)], n_slots=2, max_len=64)
    assert got == want and len(got) == 3


def _direct_greedy(cfg, m, prompt, n, max_len):
    """Greedy tokens from one prefill and decode steps, batch 1, no engine."""
    caches = model.init_caches(cfg, 1, max_len, device="cpu")
    logits, caches = m.prefill(torch.as_tensor(prompt[None], dtype=torch.int64), caches)
    tokens = [int(logits[0].argmax())]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, caches = m.decode_step(torch.tensor([tokens[-1]]), pos, caches)
        tokens.append(int(logits[0].argmax()))
    return tokens


def test_one_slot_inserts_every_channel_where_the_jax_engine_does_not():
    """The JAX engine tells a layer-stacked cache leaf from an unstacked one
    by their first axes; at one slot an unstacked (1, R) state (the tail
    rglru layer) looks stacked, and only its channel 0 is inserted. The port
    inserts along each state's batch axis: its one-slot engine equals a
    direct prefill and decode, and JAX's does not."""
    np.testing.assert_array_equal(
        np.asarray(jengine._insert_slot(jnp.zeros((1, 5)), jnp.arange(1.0, 6.0)[None], 0)),
        [[1.0, 0.0, 0.0, 0.0, 0.0]])
    full = [transformer.block_cache_init("rglru", get_config("recurrentgemma-9b", reduced=True),
                                         1, 8, "cpu")]
    one = [type(full[0])(*(torch.rand_like(t) for t in full[0]))]
    engine._insert_slot(full, one, 0)
    assert all(torch.equal(f, o) for f, o in zip(full[0], one[0]))

    jcfg, cfg, params, m = _pair("recurrentgemma-9b")
    reqs = _requests(cfg, [(6, 8), (9, 8)])
    got = _serve(lambda: engine.Engine(cfg, m, n_slots=1, max_len=32, seed=0, device="cpu"),
                 engine.Request, reqs)
    want = _serve(lambda: jengine.Engine(jcfg, params, n_slots=1, max_len=32, seed=0),
                  jengine.Request, reqs)
    direct = [(uid, _direct_greedy(cfg, m, prompt, n, 32)) for uid, prompt, n, _ in reqs]
    assert got == direct
    assert want != direct


def test_vlm_driver_quirk_decode_positions_past_the_cache_equal_jax():
    """The JAX driver submits no patches, yet decode_step adds n_patches to
    every text position: with 8 patches, a 12-token prompt and 8 new tokens
    at max_len 20, positions 20..27 write at the last slot (the write
    clamps) and see every slot valid. The port reproduces it."""
    got, want = _both("internvl2-2b", [(12, 8), (6, 8)], n_slots=2, max_len=20)
    assert got == want and [len(t) for _, t in got] == [8, 8]


def test_vlm_length_check_counts_the_prompt_alone_as_jax_does():
    """8 patches + 10 tokens + 6 new exceed max_len 20, but the check counts
    10 + 6: both engines take the request, the prefill fills 18 slots and the
    decode writes clamp at the last; the completions equal JAX's."""
    got, want = _both("internvl2-2b", [(10, 6)], n_slots=2, max_len=20, patches=True)
    assert got == want and len(got[0][1]) == 6


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
    for uid, prompt, n, _ in reqs:
        eng.submit(engine.Request(uid=uid, prompt=prompt, max_new_tokens=n))
    done = eng.run()
    assert sorted(eng.sampled_logits) == [uid for uid, *_ in reqs]
    for c in done:
        rows = eng.sampled_logits[c.uid]
        assert [int(r.argmax()) for r in rows] == c.tokens
        assert all(r.shape == (cfg.vocab_size,) and r.dtype == torch.float32 for r in rows)
    # the first row is the prompt's own last-position prefill logits
    uid, prompt, _, _ = reqs[1]
    alone, _ = m.prefill(torch.as_tensor(prompt[None], dtype=torch.int64),
                         model.init_caches(cfg, 1, 32, device="cpu"))
    torch.testing.assert_close(eng.sampled_logits[uid][0], alone[0], rtol=0, atol=0)


def test_launch_serve_main_on_the_cpu():
    """The JAX driver's default arch, xlstm-125m."""
    out = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert out["arch"] == "xlstm-125m" and out["reduced"] and out["device"] == "cpu"
    assert sorted(c["uid"] for c in out["completions"]) == [0, 1, 2]
    assert all(len(c["tokens"]) == 4 for c in out["completions"]) and out["tokens"] == 12
    assert len(out["prefill_ms"]) == 3 and len(out["decode_ms"]) >= 3
    assert out["nonfinite_logits"] == 0 and out["weight_bytes"] > 0


@pytest.mark.parametrize("arch", ["internvl2-2b", "recurrentgemma-9b", "phi4-mini-3p8b"])
def test_launch_serve_main_serves_every_decoder_family(arch):
    out = serve.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--max-new", "4"])
    assert out["arch"] == arch and out["tokens"] == 12 and out["nonfinite_logits"] == 0


def test_launch_serve_rejects_a_checkpoint(tmp_path):
    """`--ckpt-dir` restores a training checkpoint's params: one of another
    arch (here gemma-2b's, served as xlstm-125m) is refused by name."""
    train.main(["--device", "cpu", "--reduced", "--steps", "1", "--batch", "2", "--seq", "8",
                "--ckpt-dir", str(tmp_path)])
    with pytest.raises(KeyError):
        serve.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_unported_family_raises_through_main():
    """whisper-medium through the driver (a reference quirk): `main` submits
    no extras, as the JAX driver does, and the prefill reads the frames, so
    both raise a KeyError; `serve` with frames serves it."""
    with pytest.raises(KeyError, match="frames"):
        serve.main(["--device", "cpu", "--arch", "whisper-medium"])
    jcfg, cfg, params, m = _pair("whisper-medium")
    jeng = jengine.Engine(jcfg, params, n_slots=2, max_len=32, seed=0)
    jeng.submit(jengine.Request(uid=0, prompt=np.zeros(4, np.int32), max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        jeng.run()
    reqs = [engine.Request(uid=uid, prompt=prompt, max_new_tokens=n, temperature=0.7,
                           extras=extras)
            for uid, prompt, n, extras in _requests(cfg, REQUESTS[:3])]
    out = serve.serve(cfg, m, reqs, slots=2, max_len=32)
    assert out["tokens"] == sum(n for _, n in REQUESTS[:3]) and out["nonfinite_logits"] == 0


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
