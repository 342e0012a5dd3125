"""The port's sequence-parallel (frame-sharded) vocoder decode over two
CPU ranks (gloo, subprocesses: tests/torch_parallel_worker.py) against
the JAX package's single-device `decoder_apply` on the same converted
weights, for HiFi-GAN, iSTFTNet and Vocos, unpadded and with a padded
prefix (styletts2_tpu/parallel/seqpar.py's contract; atol 2e-4, the JAX
package's own seq-par tolerance: only the all-reduced statistics' f32
association differs from one device). The workers run while this process
computes the JAX references.

Both sides take JAX's harmonic source (HiFi-GAN's NSF source, iSTFTNet's
source STFT), as the port's other parity tests do: the sine phase is an
f32 cumsum over the whole waveform whose last-ulp difference between
XLA and torch (1.3e-5 in the source here) the HiFi-GAN generator
amplifies ~100x, and iSTFTNet's source STFT phase flips by 2 pi in quiet
bins under any rounding change (nn/istftnet.py). The source's own parity
is tests/test_torch_decoder.py's.

Also: the receptive-field bound equals JAX's for the three default
decoders, sp_decoder_apply's three ValueErrors, and seq_parallel without
a mesh."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styletts2_tpu.config import load_config as jax_config
from styletts2_tpu.nn import decoder as JDE
from styletts2_tpu.ops import stft as JOPS
from styletts2_tpu.parallel import seqpar as JSP
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.parallel import seqpar as SP
from torch_parallel_worker import (collect, decoder_tree, engine_params,
                                   launch)

torch.set_num_threads(1)

HIFIGAN = {"upsample_initial_channel": 512, "upsample_rates": [10, 6],
           "upsample_kernel_sizes": [20, 12], "resblock_kernel_sizes": [3, 7],
           "resblock_dilation_sizes": [[1, 3], [1, 3, 5]]}
# tests/test_seqpar.py's configurations and input seeds
DECODERS = {
    "hifigan": (dict(HIFIGAN, type="hifigan"), 1),
    "istftnet": (dict(HIFIGAN, type="istftnet"), 8),
    "vocos": ({"type": "vocos", "num_layers": 3, "intermediate_dim": 256,
               "gen_istft_n_fft": 240, "gen_istft_hop_size": 60}, 6),
}
N_RANKS = 2


# tests/test_seqpar.py's engine config: one frame bucket sized for the
# seq-par gate (256 % 2 == 0, 256 / 2 >= max(32, the receptive field))
SP_ENGINE = {
    "preprocess_params": {"spect_params": {"n_fft": 512, "win_length": 240,
                                           "hop_length": 60}},
    "model_params": {
        "hidden_dim": 64, "max_conv_dim": 64, "dim_in": 16,
        "style_dim": 32, "max_dur": 10,
        "decoder": {"type": "hifigan", "upsample_initial_channel": 512,
                    "upsample_rates": [10, 6],
                    "upsample_kernel_sizes": [20, 12],
                    "resblock_kernel_sizes": [3],
                    "resblock_dilation_sizes": [[1, 3]]}},
    "tpu": {"token_buckets": [32], "frame_buckets": [256],
            "decoder_dtype": "float32"},
    "debug": False,
}


def _cfg(dec):
    return {"model_params": {"style_dim": 32, "decoder": dec}}


def _source(tree, dcfg, f0):
    """JAX's harmonic source for the generator (one jit): HiFi-GAN's
    (B, L, 1) NSF source, iSTFTNet's (magnitude, phase) of its STFT."""
    up = int(np.prod(dcfg.upsample_rates))
    if dcfg.type == "istftnet":
        up *= dcfg.gen_istft_hop_size
    n_fft = dcfg.gen_istft_n_fft

    def fn(p, f0):
        f0_up = jnp.swapaxes(JOPS.interpolate_nearest(f0[:, None, :], up),
                             1, 2)
        har, _ = JDE.source_module_apply(p, f0_up, None, up)
        if dcfg.type == "hifigan":
            return har
        return JOPS.stft_mag_phase(har[..., 0], n_fft,
                                   dcfg.gen_istft_hop_size, n_fft,
                                   center=True, pad_mode="replicate")

    return jax.jit(fn)(tree["generator"]["m_source"], f0)


def _cases():
    """Per decoder: its config, seeded random weights drawn by the port in
    the JAX layout, inputs of F = 2 x
    max(16, margin + 2) asr frames, the valid prefixes (one ending inside
    rank 1's core, one full row) and JAX's source for both (the padded
    case's from F0 zeroed past the prefix, as decoder_apply's mel mask
    does)."""
    cases = {}
    for name, (dec, seed) in DECODERS.items():
        mp = jax_config(_cfg(dec)).model_params
        margin = JSP.decoder_receptive_field(mp.decoder)
        f_total = N_RANKS * max(16, margin + 2)
        rng = np.random.default_rng(seed)
        tree = decoder_tree(_cfg(dec), seed)
        c = dict(
            cfg=_cfg(dec), seed=seed, tree=tree, margin=margin,
            asr=rng.standard_normal((2, f_total, 512)).astype(np.float32),
            f0=(100.0 + 50.0 * rng.standard_normal((2, 2 * f_total))
                ).astype(np.float32),
            n=(rng.standard_normal((2, 2 * f_total)) * 0.3).astype(
                np.float32),
            s=rng.standard_normal((2, mp.style_dim)).astype(np.float32),
            nv=np.array([f_total - f_total // 3, f_total], np.int32))
        if dec["type"] != "vocos":
            mel = np.arange(2 * f_total)[None, :] < 2 * c["nv"][:, None]
            for suffix, f0 in (("", c["f0"]),
                               ("_padded", np.where(mel, c["f0"], 0.0))):
                src = _source(tree, mp.decoder, jnp.asarray(f0, jnp.float32))
                c["jax_src" + suffix] = src
                c["har" + suffix] = (
                    np.asarray(src) if dec["type"] == "hifigan" else
                    np.asarray(jnp.swapaxes(jnp.concatenate(src, axis=1),
                                            1, 2)))
        cases[name] = c
    return cases


def _jax_reference(c, suffix, monkeypatch):
    """jit(decoder_apply) on the case, unpadded (no mask) or with the
    padded prefix's frame_mask, taking the case's JAX source."""
    dcfg = jax_config(c["cfg"]).model_params.decoder
    f_total = c["asr"].shape[1]
    mask = (None if not suffix else
            jnp.arange(f_total)[None, :] < jnp.asarray(c["nv"])[:, None])
    src = c.get("jax_src" + suffix)
    kw = {}
    if dcfg.type == "hifigan":
        kw["har_source"] = src
    elif dcfg.type == "istftnet":
        monkeypatch.setattr(JOPS, "stft_mag_phase", lambda *a, **k: src)
    fn = jax.jit(lambda p, a, f, n, s: JDE.decoder_apply(
        p, dcfg, a, f, n, s, rng=None, train=False, frame_mask=mask, **kw))
    return np.asarray(fn(c["tree"], *(jnp.asarray(c[k])
                                      for k in ("asr", "f0", "n", "s"))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker group started at once (each test then computes its
    JAX references while the ranks run): the decoder cases, the
    seq-parallel engine and its single-device reference."""
    io = tmp_path_factory.mktemp("torch_seqpar")
    cases = _cases()
    # the ranks draw the weights from the seeds themselves
    sent = {n: {k: v for k, v in c.items()
                if not k.startswith("jax_") and k != "tree"}
            for n, c in cases.items()}
    engine = {"cfg": SP_ENGINE, "seeded": True,
              "ref_wav": (np.random.default_rng(0).standard_normal(48000)
                          * 0.1).astype(np.float32),
              "sp": {"text": "one two three four five", "fixed": 10}}
    procs = {"seqpar": launch("seqpar", sent, io, N_RANKS),
             "engine": launch("engine", engine, io, N_RANKS),
             "single_engine": launch("single_engine", engine, io, 1)}
    yield io, procs, cases, engine
    for group in procs.values():
        for p in group:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_sp_decoder_matches_jax_decoder(runs, monkeypatch):
    """2-rank sp_decoder_apply == JAX decoder_apply (no mask / the padded
    prefix's frame_mask), every decoder, atol 2e-4; both ranks return the
    whole waveform."""
    io, procs, cases, _ = runs
    want = {name + suffix: _jax_reference(c, suffix, monkeypatch)
            for name, c in cases.items() for suffix in ("", "_padded")}
    got0, got1 = collect(procs["seqpar"], "seqpar", io)
    for key, ref in want.items():
        np.testing.assert_array_equal(got0[key], got1[key])
        assert got0[key].shape == ref.shape, key
        print(f"{key}: max abs {float(np.abs(got0[key] - ref).max()):.2e}")
        np.testing.assert_allclose(got0[key], ref, rtol=0, atol=2e-4,
                                   err_msg=key)


def test_receptive_field_and_validation():
    """The bound equals JAX's for the default decoders; the three
    ValueErrors (no collective is reached before them); seq_parallel
    without a mesh."""
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.nn.decoder import Decoder
    from styletts2_tpu_torch.parallel import Mesh

    for t in ("hifigan", "istftnet", "vocos"):
        raw = {"model_params": {"decoder": {"type": t}}}
        assert (SP.decoder_receptive_field(load_config(raw).model_params
                                           .decoder)
                == JSP.decoder_receptive_field(jax_config(raw).model_params
                                               .decoder)), t
    mp = load_config(_cfg(DECODERS["hifigan"][0])).model_params
    dec = Decoder(mp.decoder, dim_in=512, style_dim=32)
    mesh = Mesh(None, 0, 8, "cpu", axis="sp")
    f_total = 8 * 32
    asr = torch.zeros(1, f_total, 512)
    f0 = n = torch.zeros(1, 2 * f_total)
    s = torch.zeros(1, 32)
    with pytest.raises(ValueError, match="not divisible"):
        SP.sp_decoder_apply(mesh, dec, asr[:, :100], f0[:, :200],
                            n[:, :200], s)
    with pytest.raises(ValueError, match="receptive field"):
        SP.sp_decoder_apply(mesh, dec, asr, f0, n, s, margin=2)
    with pytest.raises(ValueError, match="per-device frames"):
        SP.sp_decoder_apply(mesh, dec, asr, f0, n, s, margin=40)
    with pytest.raises(ValueError, match="requires a mesh"):
        StyleTTS2(load_config({"tpu": {"decoder_dtype": "float32"}}),
                  seed=0, device="cpu", seq_parallel=True)


def test_sp_engine_matches_single_device_and_jax(runs):
    """StyleTTS2(mesh=..., seq_parallel=True) over 2 ranks: the decode
    takes the frame-sharded path, every rank returns the same audio, and
    it equals the single-device engine's within one int16 step (1.01 /
    32767, tests/test_seqpar.py's gate). Against the JAX engine it holds
    the port engine's own JAX gate (rel-l2 < 5e-4,
    tests/test_torch_engine.py): the single-device port engine is itself
    ~3 int16 steps from JAX's here (the sine source's f32 phase, see the
    module docstring), so one step cannot hold there."""
    from styletts2_tpu.infer import StyleTTS2 as JaxStyleTTS2

    io, procs, _, engine = runs
    je = JaxStyleTTS2(jax_config(SP_ENGINE), params=engine_params(SP_ENGINE),
                      seed=0)
    je.fused_enabled = False
    je.fixed_duration = 10  # ~170 frames -> the 256 bucket, sp active
    style = {"style": je.compute_style(engine["ref_wav"], denoise=0.0),
             "speed": 1.0}
    want = je.generate(engine["sp"]["text"], style, stabilize=False,
                       n_merge=1)
    (single,) = collect(procs["single_engine"], "single_engine", io)
    r0, r1 = collect(procs["engine"], "engine", io)
    assert r0["sp_calls"] and r1["sp_calls"], "no frame-sharded decode"
    got = r0["wav"]
    np.testing.assert_array_equal(got, r1["wav"])
    assert got.shape == single["wav"].shape == want.shape
    assert np.abs(got - single["wav"]).max() <= 1.01 / 32767
    for a in (got, single["wav"]):
        rel = np.linalg.norm(a - want) / np.linalg.norm(want)
        print(f"vs JAX: rel-l2 {rel:.2e}, max abs "
              f"{float(np.abs(a - want).max()):.2e}")
        assert rel < 5e-4
