"""The parts of the port's SLM stage against the JAX package on the CPU:
the WavLM backbone, its discriminator head and the WavLM losses at
tests/test_wavlm.py's small WavLM (hidden 96, 3 layers, conv 48), the soft
alignment, the masked plain route the round's decoder takes, with the same
seeded numpy inputs and the JAX package's parameter trees carried into the
port (weights.load_param_tree); and where `train_loop`'s SLM stage takes
its WavLM weights from. The round itself: tests/test_torch_slm.py.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from styletts2_tpu import losses as JLO
from styletts2_tpu.config import DecoderConfig as JDecoderConfig
from styletts2_tpu.nn import blocks as JB
from styletts2_tpu.nn import decoder as JDE
from styletts2_tpu.nn import istftnet as JINET
from styletts2_tpu.nn import wavlm as JWL
from styletts2_tpu.nn.discriminators import wavlm_d_apply, wavlm_d_init
from styletts2_tpu_torch import losses as LO
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import DecoderConfig, load_config
from styletts2_tpu_torch.models import build_inference_modules
from styletts2_tpu_torch.nn import blocks as B
from styletts2_tpu_torch.nn import slm as SLM
from styletts2_tpu_torch.nn import wavlm as WL
from styletts2_tpu_torch.nn.decoder import HiFiGANGenerator
from styletts2_tpu_torch.nn.discriminators import WavLMDiscriminator
from styletts2_tpu_torch.nn.istftnet import ISTFTNetGenerator
from styletts2_tpu_torch.optim import MultiOptimizer

from test_torch_train_cli import workspace  # noqa: F401  (the fixture)
from test_torch_train_parity import TINY

torch.set_num_threads(1)
SMALL = dict(hidden_size=96, num_hidden_layers=3, num_attention_heads=4,
             intermediate_size=128, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, num_buckets=64,
             max_bucket_distance=100)


ISTFT_TINY = {"type": "istftnet", "upsample_initial_channel": 512,
              "upsample_rates": [2, 6], "upsample_kernel_sizes": [4, 12],
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]],
              "gen_istft_n_fft": 20, "gen_istft_hop_size": 5}


def small_cfgs():
    return (JWL.WavLMConfig(conv_dim=(48,) * 7, **SMALL),
            WL.WavLMConfig(conv_dim=(48,) * 7, **SMALL))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def carried(jax_tree, module):
    """`module` holding the JAX tree (numpy), strictly."""
    W.load_param_tree({"m": module},
                      {"m": jax.tree.map(np.asarray, jax_tree)}, fuse=False)
    return module


def split(module):
    """`module` with its weight norm split (weights.split_weight_norm)."""
    W.split_weight_norm(module)
    return module


@pytest.fixture(scope="module")
def wavlm_pair():
    jcfg, cfg = small_cfgs()
    params = JWL.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, carried(params, WL.WavLM(cfg)).eval()


def test_hidden_states_and_input_gradient_match_jax(wavlm_pair):
    """Every hidden state within atol 2e-4 + rtol 1e-3 (the JAX-vs-HF gate
    of tests/test_wavlm.py); the gradient of a seeded projection of all
    hidden states to the waveform, rel-l2 < 1e-3. The frame count is
    feature_lengths in both packages."""
    jcfg, params, model = wavlm_pair
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, 3200)) * 0.1).astype(np.float32)
    n_frames = JWL.feature_lengths(jcfg, 3200)
    assert WL.feature_lengths(model.cfg, 3200) == n_frames
    cots = [rng.standard_normal((2, n_frames, 96)).astype(np.float32)
            for _ in range(jcfg.num_hidden_layers + 1)]

    def proj(p, w):
        hs = JWL.apply(p, w, jcfg)
        return sum(jnp.sum(h * c) for h, c in zip(hs, cots)), hs

    (_, want), want_g = jax.jit(jax.value_and_grad(
        proj, argnums=1, has_aux=True))(params, jnp.asarray(wav))
    x = torch.from_numpy(wav).requires_grad_(True)
    got = model(x)
    sum((h * torch.from_numpy(c)).sum() for h, c in zip(got, cots)).backward()
    assert len(got) == len(want) == jcfg.num_hidden_layers + 1
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=2e-4, rtol=1e-3,
                                   err_msg=f"hidden state {i}")
    assert rel_l2(x.grad.numpy(), want_g) < 1e-3


def test_load_hf_state_dict_equals_convert(wavlm_pair):
    """An HF-layout state dict (torch tensors; the positional conv weight
    normed, in the legacy and in the parametrized key naming;
    masked_spec_embed present) loads into the port equal to what JAX's
    convert_torch_state_dict makes of it, bit for bit, and the port's
    hidden states follow (atol 2e-4 + rtol 1e-3)."""
    jcfg, params, _ = wavlm_pair
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.standard_normal((96, 24, 16)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 2.0, (1, 1, 16)).astype(np.float32))
    key = "encoder.pos_conv_embed.conv."
    wav = np.random.default_rng(2).standard_normal((1, 2000)).astype(
        np.float32) * 0.1
    last = jax.jit(lambda p, w: JWL.apply(p, w, jcfg)[-1])
    for names in (("weight_g", "weight_v"),
                  ("parametrizations.weight.original0",
                   "parametrizations.weight.original1")):
        flat = W.tree_to_state_dict(jax.tree.map(np.asarray, params),
                                    fuse=False)
        del flat[key + "weight"]
        flat[key + names[0]], flat[key + names[1]] = g, v
        flat["masked_spec_embed"] = torch.zeros(96)
        tree = JWL.convert_torch_state_dict(flat, jcfg)
        want = W.tree_to_state_dict(tree, fuse=False)
        model = WL.WavLM(small_cfgs()[1])
        model.load_hf_state_dict(flat)
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (names, k)
        with torch.no_grad():
            np.testing.assert_allclose(
                model(torch.from_numpy(wav))[-1].numpy(),
                np.asarray(last(tree, jnp.asarray(wav))), atol=2e-4,
                rtol=1e-3)


def test_wavlm_d_matches_jax():
    """The head (weight norm split, as trained) on stacked hidden states:
    rel-l2 < 1e-5."""
    tree = wavlm_d_init(jax.random.PRNGKey(8), slm_hidden=96, slm_layers=4)
    wd = carried(tree, split(WavLMDiscriminator(96, 4)))
    x = np.random.default_rng(3).standard_normal((2, 9, 384)).astype(
        np.float32)
    want = np.asarray(jax.jit(wavlm_d_apply)(tree, jnp.asarray(x)))
    got = wd(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 9)
    assert rel_l2(got.detach().numpy(), want) < 1e-5


def test_wavlm_loss_matches_jax(wavlm_pair):
    """forward (the feature loss), generator and discriminator: rel <
    1e-4, on 24 kHz waves resampled to 16 kHz (the non-integer ratio)."""
    jcfg, params, model = wavlm_pair
    tree = wavlm_d_init(jax.random.PRNGKey(8), slm_hidden=96, slm_layers=4)
    wd = carried(tree, split(WavLMDiscriminator(96, 4)))
    rng = np.random.default_rng(4)
    wav, y = ((rng.standard_normal((2, 4800)) * 0.1).astype(np.float32)
              for _ in range(2))
    jl = JLO.WavLMLoss(JWL.make_embedder(params, jcfg), tree)
    pl = LO.WavLMLoss(model.requires_grad_(False), wd)
    want = jax.jit(lambda w, y: (jl.forward(w, y), jl.generator(y),
                                 jl.discriminator(w, y)))(
        jnp.asarray(wav), jnp.asarray(y))
    tw, ty = torch.from_numpy(wav), torch.from_numpy(y)
    with torch.no_grad():
        got = (pl.forward(tw, ty), pl.generator(ty), pl.discriminator(tw, ty))
    for name, a, b in zip(("forward", "generator", "discriminator"), got,
                          want):
        assert abs(a.item() - float(b)) < 1e-4 * abs(float(b)), \
            (name, float(b), a.item())


def port_tree(module, seed):
    """Seeded port weights, weight norm split, as a JAX-layout tree."""
    W.init_random(module, torch.Generator().manual_seed(seed))
    W.split_weight_norm(module)
    return W.module_tree(module)


def _masked_case(kind, rng):
    """(port module, its apply(inputs), JAX's apply(tree, inputs), the
    tree, inputs {name: array}, the differentiated input's name, the
    source STFT both sides share (iSTFTNet) or None) for one case."""
    if kind == "resblock":
        blk = B.AdaINResBlock1(64, 7, (1, 3, 5), 32)
        mask = np.arange(60)[None, :] < np.array([[60], [41]])
        x = dict(x=rng.standard_normal((2, 60, 64)).astype(np.float32),
                 s=rng.standard_normal((2, 32)).astype(np.float32))
        tree = port_tree(blk, 1)
        nv = jnp.asarray(mask.sum(1), jnp.int32)

        def jax_apply(p, v):
            return JB.adain_res_block1_apply(p, v["x"], v["s"], 7, (1, 3, 5),
                                             jnp.asarray(mask), n_valid=nv)

        def port_apply(v):
            return blk(v["x"], v["s"], torch.from_numpy(mask),
                       torch.from_numpy(mask.sum(1)).int())
        return blk, port_apply, jax_apply, tree, x, "x", None
    dc = dict(TINY["model_params"]["decoder"]) if kind == "hifigan" \
        else dict(ISTFT_TINY)
    dc["upsample_initial_channel"] = 64  # narrow stages: C 32 and 16
    pcfg, jcfg = DecoderConfig(**dc), JDecoderConfig(**dc)
    gen = (HiFiGANGenerator(pcfg, 32) if kind == "hifigan"
           else ISTFTNetGenerator(pcfg, 32))
    tree = port_tree(gen, 2)
    t = 24
    mask = np.arange(t)[None, :] < np.array([[t], [18]])
    x = dict(x=rng.standard_normal((2, t, 64)).astype(np.float32) * 0.3,
             f0=np.where(mask, rng.uniform(90, 220, (2, t)), 0.0)
             .astype(np.float32),
             s=rng.standard_normal((2, 32)).astype(np.float32) * 0.3)
    japply = (JDE.hifigan_generator_apply if kind == "hifigan"
              else JINET.istftnet_generator_apply)

    def jax_apply(p, v):
        return japply(p, v["x"], v["s"], v["f0"], None, jcfg,
                      frame_mask=jnp.asarray(mask))

    def port_apply(v):
        return gen(v["x"], v["s"], v["f0"], torch.from_numpy(mask))
    feats = None
    if kind == "istftnet":
        with torch.no_grad():
            feats = gen.source_features(torch.from_numpy(x["f0"]))
    return gen, port_apply, jax_apply, tree, x, "x", feats


def test_masked_plain_route_matches_jax(monkeypatch):
    """A training build (weight norm split) given a valid prefix, as the
    SLM round's decoder is: an AdaINResBlock1, and the HiFi-GAN and
    iSTFTNet generators with every resblock on it (narrow stages; the
    shell's blocks had their masked route before), take the plain route
    with masked AdaIN statistics under autograd (kernel B1's wrapper
    would raise), against JAX's masked XLA branch. The output, rel-l2 <
    1e-4 (row 1 over its valid prefix: the padded rows hold bias and
    spill); the gradient to the input features, rel-l2 < 1e-4 for the
    block and < 5e-4 for a generator: a generator's input gradient
    differs by ~1.4e-4 between the packages on the unmasked route too
    (the D/G step's, unchanged here; f32 rounding through the instance
    norms' backward), so 1e-4 would hold that route to less than it
    meets."""
    for kind, bound in (("resblock", 1e-4), ("hifigan", 5e-4),
                        ("istftnet", 5e-4)):
        rng = np.random.default_rng(3)
        mod, port_apply, jax_apply, tree, x, wrt, feats = _masked_case(kind,
                                                                       rng)
        with monkeypatch.context() as mp:
            if feats is not None:  # one source STFT (test_torch_istftnet)
                mag, phase = (jnp.asarray(a.transpose(1, 2).numpy())
                              for a in feats.split(11, dim=2))
                mp.setattr(JINET.OPS, "stft_mag_phase",
                           lambda *a, **k: (mag, phase))
                mp.setattr(ISTFTNetGenerator, "source_features",
                           lambda self, f0, source=None: feats)
            tx = {k: torch.from_numpy(v) for k, v in x.items()}
            tx[wrt].requires_grad_(True)
            got = port_apply(tx)
            cot = rng.standard_normal(tuple(got.shape)).astype(np.float32)
            (got * torch.from_numpy(cot)).sum().backward()

            def jax_side(t, v, c):
                y, vjp = jax.vjp(lambda a: jax_apply(t, {**v, wrt: a}),
                                 v[wrt])
                return y, vjp(c)[0]

            want, want_g = jax.jit(jax_side)(
                tree, {k: jnp.asarray(v) for k, v in x.items()},
                jnp.asarray(cot))
        n = 41 if kind == "resblock" else got.shape[1] * 18 // 24
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert rel_l2(got[1, :n], want[1, :n]) < 1e-4, kind
        assert rel_l2(got[0], want[0]) < 1e-4, kind
        assert rel_l2(tx[wrt].grad.numpy(), want_g) < bound, kind


def slm_config(root, config_path, tag, slm):
    """The train CLI workspace's config (tests/test_torch_train_cli.py) with
    four training clips (two steps per epoch at batch 2), 8-frame crops,
    its own log dir, no epoch checkpoint (the decoder shell is big) and
    `slm` as slmadv_params."""
    base = yaml.safe_load(open(config_path))
    lines = [f"wavs/clip{i}.wav|word{i} and more\n" for i in range(4)]
    (root / f"{tag}_train.txt").write_text("".join(lines))
    base["data_params"]["train_data"] = str(root / f"{tag}_train.txt")
    base["log_dir"] = str(root / f"runs_{tag}")
    base["slmadv_params"] = slm
    base["save_freq"] = 100
    base["max_len"] = 16
    path = root / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(base))
    return str(path)


def test_wavlm_weights_source(workspace, monkeypatch, tmp_path):
    """Enabled with neither wavlm_path nor allow_random_wavlm, train_loop
    raises the JAX package's message; with wavlm_path (an HF-layout state
    dict with the parametrized positional-conv keys, saved by torch.save)
    the stage's WavLM holds exactly those weights (weight norm fused)."""
    from styletts2_tpu_torch import train_loop as TL

    root, config_path, _, _ = workspace
    small = small_cfgs()[1]
    monkeypatch.setattr(WL, "WavLMConfig", lambda: small)
    cfg_path = slm_config(root, config_path, "slm_refused", {"enabled": True})
    with pytest.raises(RuntimeError, match="requires slmadv_params."
                       "wavlm_path"):
        TL.main(["-p", cfg_path], device="cpu")

    src = WL.WavLM(small).init_random(torch.Generator().manual_seed(1))
    sd = dict(src.state_dict())
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    g = torch.sqrt((w * w).sum(dim=(0, 1), keepdim=True))
    key = "encoder.pos_conv_embed.conv.parametrizations.weight."
    sd[key + "original0"], sd[key + "original1"] = g, w
    sd["masked_spec_embed"] = torch.zeros(SMALL["hidden_size"])
    torch.save(sd, tmp_path / "wavlm.pt")
    cfg = load_config(slm_config(root, config_path, "slm_path",
                                 {"enabled": True,
                                  "wavlm_path": str(tmp_path / "wavlm.pt")}))
    trainer = SLM.build_trainer(
        cfg, MultiOptimizer(build_inference_modules(cfg.model_params)), "cpu")
    want = WL.WavLM(small)
    want.load_hf_state_dict(sd)
    got = trainer.wl.wavlm.state_dict()
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    np.testing.assert_allclose(got["encoder.pos_conv_embed.conv.weight"], w,
                               rtol=1e-6, atol=1e-7)


def test_train_loop_runs_the_round_every_iter_steps(workspace, monkeypatch):
    """`allow_random_wavlm`, iter 2, two steps: no round after step 1, one
    after step 2 with finite slm_g / slm_d in its metrics and the scalar
    log; the round moves predictor, decoder and the head only, WavLM and
    every other module stay, and no .grad is left anywhere. --profile-dir
    (its window moved to step 0) writes the trace. The D/G step and the
    eval step are stubbed with zero losses (tests/test_torch_train_cli.py
    runs them through this loop; one takes ~17 s on two CPU threads)."""
    from styletts2_tpu_torch import train_loop as TL

    root, config_path, _, _ = workspace
    cfg_path = slm_config(root, config_path, "slm",
                          {"enabled": True, "allow_random_wavlm": True,
                           "iter": 2})
    small = small_cfgs()[1]
    monkeypatch.setattr(WL, "WavLMConfig", lambda: small)
    monkeypatch.setattr(TL, "PROFILE_STEPS", (0, 1))
    rounds = []
    step = SLM.SLMAdversarialTrainer.step

    def recorded(self, mods, *a, **kw):
        snap = {k: [p.detach().clone() for p in m.parameters()]
                for k, m in [*mods.items(), ("wavlm_d", self.wl.wd),
                             ("wavlm", self.wl.wavlm)]}
        out = step(self, mods, *a, **kw)
        now = {**mods, "wavlm_d": self.wl.wd, "wavlm": self.wl.wavlm}
        rounds.append(dict(
            moved={k for k, m in now.items() if any(
                not torch.equal(a, p) for a, p in zip(snap[k],
                                                      m.parameters()))},
            grads={k for k, m in now.items()
                   if any(p.grad is not None for p in m.parameters())}))
        return out

    monkeypatch.setattr(SLM.SLMAdversarialTrainer, "step", recorded)
    zero = {k: torch.zeros(()) for k in ("mel", "gen", "ce", "dur", "norm",
                                          "f0", "s2s", "mono", "g_loss",
                                          "d_loss")}
    monkeypatch.setattr(TL.Trainer, "train_step_for",
                        lambda self, bin_id: lambda mods, b, gen: dict(zero))
    monkeypatch.setattr(TL.Trainer, "eval_step_for",
                        lambda self, bin_id: lambda mods, b, gen: dict(zero))
    trainer = TL.main(["-p", cfg_path, "--profile-dir",
                       str(root / "trace_slm")], device="cpu")
    assert len(trainer.history) == 2 and len(rounds) == 1
    assert "slm_g" not in trainer.history[0]["metrics"]
    m = trainer.history[1]["metrics"]
    assert all(np.isfinite(m[k]) for k in ("slm_g", "slm_d")), m
    assert rounds[0] == {"moved": {"predictor", "decoder", "wavlm_d"},
                         "grads": set()}
    tags = open(root / "runs_slm" / "tensorboard" / "scalars.jsonl").read()
    assert '"train/slm_g"' in tags and '"train/slm_d"' in tags
    assert trainer.trace.endswith("steps_0-0.json")
    assert (root / "trace_slm" / "steps_0-0.json").stat().st_size > 0
