"""The port's serving path (styletts2_tpu_torch.infer, device="cpu")
against the JAX engine on the tiny config of tests/test_torch_engine.py:
the on-device duration glue, the batch partition and frame-bucket merge
rule, the fused single-dispatch `generate` (on the CPU the fused function
runs eagerly; a CUDA graph replays the same function on the card), the
batched two-phase plan, generate_batch and serve (stabilize=True, per-text
noise streams and chains), and the port's own generate_stream /
generate_batch / serve against its generate.

Bounds: integer durations and totals equal; waveforms rel-l2 < 5e-4, the
bound of test_torch_engine.py (int16 PCM steps plus f32 ulps amplified by
random weights, measured ~8e-5 there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu import infer as JI
from styletts2_tpu.config import load_config as jax_load_config
from styletts2_tpu.models import build_model
from styletts2_tpu_torch import infer as TI
from styletts2_tpu_torch.config import load_config
from test_torch_engine import CFG

torch.set_num_threads(1)
REL_L2 = 5e-4
# the JAX engine's merge costs (TPU times, styletts2_tpu/infer.py
# _plan_finish): arguments of the port's rule here, nowhere else
JAX_CALL_MS, JAX_ROW_MS_PER_FRAME = 32.0, 0.028


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_load_config(CFG)
    params = jax.tree.map(np.asarray,
                          build_model(jax.random.PRNGKey(0), jcfg.model_params))
    jax_engine = JI.StyleTTS2(jcfg, params=params, seed=0)
    port = TI.StyleTTS2(load_config(CFG), params=params, seed=0, device="cpu")
    return jax_engine, port


@pytest.fixture(scope="module")
def style():
    return {"style": (np.random.default_rng(5).standard_normal((1, 32))
                      * 0.3).astype(np.float32), "speed": 1.0}


def _sync(jax_engine, port, seed):
    """Same engine RNG and speaking-rate state on both sides."""
    jax_engine._rng = np.random.default_rng(seed)
    port._rng = np.random.default_rng(seed)
    port._fpt_ema = jax_engine._fpt_ema


def test_device_postprocess_durations_matches_jax():
    """Seeded ragged rows (lengths 24, 13, 5, 2): fixed, scaled, the
    stabilisation blend with noise, a chained prev_mean and a speed:
    equal integer durations and totals."""
    rng = np.random.default_rng(3)
    b, tb = 4, 24
    mask = np.arange(tb)[None, :] < np.array([24, 13, 5, 2])[:, None]
    dur = (rng.uniform(0.5, 9.0, (b, tb)) * mask).astype(np.float32)
    dur[0, 7] = 40.0  # an outlier the z-score clamp replaces
    noise = (rng.standard_normal((b, tb)) * mask).astype(np.float32)
    cases = [  # speed, fixed_flag, fixed_value, dur_scale, t, prev_mean
        (1.0, 1.0, 7.0, 1.0, 0.0, 0.0),
        (1.0, 0.0, 0.0, 2.5, 0.0, 0.0),
        (1.0, 0.0, 0.0, 1.0, 0.2, 0.0),
        (1.3, 0.0, 0.0, 1.0, 0.2, 4.5),
        (0.7, 0.0, 0.0, 0.6, 0.0, 3.0)]
    jax_fn = jax.jit(JI._device_postprocess_durations)  # one compile
    for scal in cases:
        sc = np.asarray(scal, np.float32)
        want_p, want_t = jax_fn(
            jnp.asarray(dur), jnp.asarray(mask), *map(jnp.asarray, sc),
            jnp.asarray(noise))
        got_p, got_t = TI._device_postprocess_durations(
            torch.from_numpy(dur), torch.from_numpy(mask),
            *torch.from_numpy(sc), torch.from_numpy(noise))
        assert got_p.dtype == torch.int32 and got_t.dtype == torch.int32
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_partition_and_merge_match_jax_grouping(engines, monkeypatch):
    """The port's _partition_exact against the JAX function, and its merge
    rule with the JAX costs as arguments against the phase-2 groups the
    JAX engine's _plan_finish issues on 21 pinned-duration chunks over the
    default config's frame buckets. Only its host grouping runs: its
    phases are stubbed and its array calls go to numpy."""
    for n in range(1, 40):
        idxs = list(range(100, 100 + n))
        assert (TI._partition_exact(idxs, (1, 2, 4, 8, 16))
                == JI._partition_exact(idxs, (1, 2, 4, 8, 16)))
    jax_engine, _ = engines
    fbs = (104, 128, 152, 176, 200, 224, 256, 304, 352, 400, 456, 512)
    monkeypatch.setattr(jax_engine.cfg.tpu, "frame_buckets", fbs)
    monkeypatch.setattr(jax_engine, "fixed_duration", 9)
    monkeypatch.setattr(jax_engine, "_phase1", lambda p, tok, m, s: (
        np.zeros(tok.shape + (64,), np.float32),
        np.zeros(tok.shape + (96,), np.float32),
        np.zeros(tok.shape, np.float32)))
    calls = []

    def phase2(p, t_en, d, s, durs, n_frames):
        calls.append((n_frames, np.asarray(durs).sum(axis=1).tolist()))
        return np.zeros((t_en.shape[0], 2 * n_frames * 60), np.int16)

    monkeypatch.setattr(jax_engine, "_phase2", phase2)
    monkeypatch.setattr(JI, "jnp", np)
    rng = np.random.default_rng(4)
    texts = [" ".join(["ab"] * n) for n in rng.integers(4, 8, size=21)]
    jax_engine._plan_finish(jax_engine._plan_phase1(texts, np.zeros((1, 32)),
                                                    1.0, 0.0, 0.0))
    from styletts2_tpu_torch.text import tokens_for_sentence

    totals = [9 * len(tokens_for_sentence(t, jax_engine.cleaner))
              for t in texts]
    by_f = {}
    for p, total in enumerate(totals):
        by_f.setdefault(TI._bucket(fbs, total), []).append(p)
    merged = TI.merge_frame_buckets(by_f, 16, JAX_CALL_MS,
                                    JAX_ROW_MS_PER_FRAME)
    got = [(fb, [totals[p] for p in group]) for fb, idxs in merged.items()
           for group in TI._partition_exact(idxs, (1, 2, 4, 8, 16))]
    assert len(merged) < len(by_f)  # the rule merged something
    assert got == calls


@pytest.mark.parametrize("stabilize", [True, False])
def test_fused_generate_matches_jax(engines, style, stabilize):
    """generate on one chunk through the fused path on both sides (a
    speaking-rate estimate of 5 frames per token picks frame bucket 120):
    equal totals, rel-l2 < 5e-4, the same learned speaking rate."""
    jax_engine, port = engines
    _sync(jax_engine, port, 11)
    jax_engine._fpt_ema = port._fpt_ema = 5.0
    calls = port.phase2_calls
    want = jax_engine.generate("hello there you", style, stabilize=stabilize)
    got = port.generate("hello there you", style, stabilize=stabilize)
    assert port.phase2_calls == calls + 1  # one fused call, no fallback
    assert got.shape == want.shape
    assert _rel_l2(got, want) < REL_L2
    assert port._fpt_ema == pytest.approx(jax_engine._fpt_ema, rel=1e-6)


def test_synthesize_chunks_batched_matches_jax(engines, style):
    """Three sentences through the batched two-phase plan with the same
    base_seed, the first on rate chain 0 and the other two on chain 2
    (each chain's noise stream default_rng([base_seed, chain]) and its
    chained means): the same grouping (one frame bucket, groups of 2 and
    1), means (which follow every noise draw) to rel 1e-5, each chunk the
    same length. Each chunk's interior (what generate keeps: all but 4000
    samples at each end) within rel-l2 5e-4; the whole chunk within 5e-3:
    its first and last ~100 samples differ more, measured 1.3e-3 to
    2.8e-3 rel-l2 over the chunk, because these random-weight stages drive
    the activations at the bucket's edges to ~30 (a generator block there
    agrees to 4e-6 relative, then the snakes amplify it)."""
    jax_engine, port = engines
    sentences = ["one two three four", "five six seven", "eight nine ten"]
    want, want_m, want_o = jax_engine._synthesize_chunks(
        sentences, style["style"], 1.0, 0.0, 0.2, [0, 2, 2], base_seed=123)
    got, got_m, got_o = port._synthesize_chunks(
        sentences, style["style"], 1.0, 0.0, 0.2, [0, 2, 2], base_seed=123)
    assert got_o == want_o == [0, 1, 2]
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 8000
        assert _rel_l2(g[4000:-4000], w[4000:-4000]) < REL_L2
        assert _rel_l2(g, w) < 5e-3


# one single-chunk text (chain 0), an empty one, and a two-chunk text
# whose chain (2) and chained mean are its own
BATCH_TEXTS = ["eight nine ten", "", "one two three four. five six seven."]


@pytest.fixture(scope="module")
def batch_style(style):
    """The style at speed 1.14: the tiny config's durations are nearly
    uniform (std ~0.05 frames), so at speed 1 the stabilisation noise
    rounds to the same frames whatever its stream; at 1.14 it moves the
    rounded durations of the two-chunk text's second chunk by a few
    frames, so each text's noise stream and chained mean show in the
    audio."""
    return dict(style, speed=1.14)


@pytest.fixture(scope="module")
def batch_runs(engines, batch_style):
    """generate_batch on BATCH_TEXTS, then serve over [BATCH_TEXTS,
    BATCH_TEXTS[2:]], on both engines from the same RNG state and with
    stabilize=True: each text's noise stream default_rng([base_seed,
    text]), its chained means and the assembly of its chunks."""
    jax_engine, port = engines
    out = {}
    for name, engine in (("jax", jax_engine), ("port", port)):
        engine._rng = np.random.default_rng(31)
        batch = engine.generate_batch(BATCH_TEXTS, batch_style, n_merge=1)
        engine._rng = np.random.default_rng(31)
        served = list(engine.serve([BATCH_TEXTS, BATCH_TEXTS[2:]],
                                   batch_style, n_merge=1))
        out[name] = batch, served
    return out


def _assert_texts_close(got, want):
    """Equal lengths; the empty text silent; the rest within rel-l2 5e-4
    (each text is its chunks' interiors between zero edges, what
    test_synthesize_chunks_batched_matches_jax holds to 5e-4)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.any():
            assert _rel_l2(g, w) < REL_L2
        else:
            assert not g.any()


def test_generate_batch_and_serve_match_jax(batch_runs):
    """The port's generate_batch and serve against the JAX engine's, with
    stabilize=True on the same seeds: equal lengths, rel-l2 < 5e-4."""
    got_batch, got_served = batch_runs["port"]
    want_batch, want_served = batch_runs["jax"]
    _assert_texts_close(got_batch, want_batch)
    assert [len(b) for b in got_served] == [3, 1]
    assert all(np.abs(w).max() > 0 for w in got_served[1])
    for got, want in zip(got_served, want_served):
        _assert_texts_close(got, want)


def test_generate_batch_and_serve(engines, batch_style, batch_runs):
    """The port against itself: serve's first batch, drawn from the same
    RNG state, equals generate_batch exactly; the single-chunk text's own
    generate from that state (the fused path, whose noise is chain 0 of
    the same seed) within rel-l2 5e-4 of its row of the batch, which ran
    at another batch size and frame bucket."""
    _, port = engines
    batch, served = batch_runs["port"]
    for got, want in zip(served[0], batch):
        np.testing.assert_array_equal(got, want)
    port._rng = np.random.default_rng(31)
    port._fpt_ema = 5.0
    calls = port.phase2_calls
    single = port.generate(BATCH_TEXTS[0], batch_style)
    assert port.phase2_calls == calls + 1  # one fused call
    assert single.shape == batch[0].shape
    assert _rel_l2(single, batch[0]) < REL_L2


def test_fused_overflow_falls_back_like_jax(engines, style):
    """A speaking-rate estimate far too low picks a frame bucket the
    utterance overflows: both sides fall back to the two-phase path with
    the same seed and agree; the estimate snaps to the observed rate."""
    jax_engine, port = engines
    _sync(jax_engine, port, 12)
    jax_engine._fpt_ema = port._fpt_ema = 1.0
    calls = port.phase2_calls
    want = jax_engine.generate("hello there you", style)
    got = port.generate("hello there you", style)
    assert port.phase2_calls == calls + 2  # the fused try, then phase 2
    assert got.shape == want.shape
    assert _rel_l2(got, want) < REL_L2
    assert port._fpt_ema == pytest.approx(jax_engine._fpt_ema, rel=1e-6)
    assert port._fpt_ema > 1.25


def test_generate_stream_equals_generate(engines, batch_style, batch_runs):
    """The two-chunk text through the two-phase plan (a single chunk takes
    the fused path through the same _try_fused as generate), from the RNG
    state serve's second batch started from: np.concatenate of
    generate_stream == generate == that batch's output (the same seed,
    chain 0, the same calls), exactly."""
    _, port = engines
    text = BATCH_TEXTS[2]

    def rng():
        r = np.random.default_rng(31)
        r.integers(2 ** 63)  # the seed serve's first batch drew
        return r

    port._rng = rng()
    full = port.generate(text, batch_style, n_merge=1)
    port._rng = rng()
    segs = list(port.generate_stream(text, batch_style, n_merge=1))
    assert len(segs) == 2 and all(np.abs(g).max() > 0 for g in segs)
    np.testing.assert_array_equal(np.concatenate(segs), full)
    np.testing.assert_array_equal(full, batch_runs["port"][1][1][0])


def test_warmup_runs_both_phases(engines):
    """warmup on one (batch, token bucket, frame bucket): the style path and
    one eager phase-2 call; on the CPU no graph is captured."""
    _, port = engines
    calls = port.phase2_calls
    port.warmup(token_buckets=(24,), frame_buckets=(60,), style_seconds=(1,))
    assert port.phase2_calls == calls + 1
    assert port.graphs == {}
