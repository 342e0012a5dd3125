"""The reference against the port at a tiny size on the CPU: the weight
layout, the style, the tokens, `generate` and `serve`."""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness.traffic import Texts, alphabet, voice_clip
from benchmark.reference import frontend as FE
from benchmark.reference import params as P
from benchmark.reference import synth as S
from benchmark.reference.model import Reference
from conftest import tiny_config

MIX = {"sentences": [1, 1], "words": [5, 7], "letters": [3, 8]}


def build(decoder):
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.infer import StyleTTS2

    cfg = tiny_config(decoder)
    symbols = FE.symbol_dict(cfg["symbol"])
    weights = P.make_weights(P.spec(cfg["model_params"], len(symbols) + 1),
                             2 ** 33 + 1, "cpu")
    eng = StyleTTS2(load_config(copy.deepcopy(cfg)),
                    params=P.host_tree(weights), seed=99, device="cpu")
    return cfg, weights, eng, Reference(cfg, weights, "cpu")


@pytest.mark.parametrize("decoder", ["hifigan", "vocos"])
def test_weight_layout_is_the_ports(decoder):
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.models import build_inference_modules

    cfg = tiny_config(decoder)
    pc = load_config(copy.deepcopy(cfg))
    mods = build_inference_modules(pc.model_params)
    W.split_weight_norm(mods)
    theirs = {f"{m}.{k}": tuple(v.shape) for m, mod in mods.items()
              for k, v in mod.state_dict().items()}
    sp = P.spec(cfg["model_params"], pc.model_params.n_token)
    mine = {f"{m}.{k}": v[1] for m, s in sp.items() for k, v in s.items()}
    assert mine == theirs


def test_weights_are_seeded():
    cfg = tiny_config()
    sp = P.spec(cfg["model_params"], 178)
    a = P.make_weights(sp, 5, "cpu")["decoder"]
    b = P.make_weights(sp, 5, "cpu")["decoder"]
    c = P.make_weights(sp, 6, "cpu")["decoder"]
    for k in ("encode.conv1.weight_v", "generator.conv_post.weight_g"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])


@pytest.mark.parametrize("decoder", ["hifigan", "vocos"])
def test_reference_matches_the_port(decoder):
    cfg, _, eng, ref = build(decoder)
    clip = voice_clip(5, cfg["preprocess_params"]["sr"], seconds=1.5)
    s_prog = eng.compute_style(clip).reshape(-1)
    s_ref = ref.style(clip)
    assert float((s_prog - s_ref).norm() / s_ref.norm()) < 1e-5
    texts = Texts(MIX, alphabet(cfg["symbol"]), 3)
    one = texts.text()
    assert FE.tokens(one, ref.symbols) == __import__(
        "styletts2_tpu_torch.text", fromlist=["x"]).tokens_for_sentence(
            one, eng.cleaner)
    raw = ref.phase1(FE.tokens(one, ref.symbols), s_ref)[2]
    scale = 4.0 / float(raw.mean())
    eng.duration_scale = scale
    style = {"style": s_prog[None], "speed": 1.0}
    seeds = S.base_seeds(99, 2)
    wav = eng.generate(one, style)
    v = S.compare(ref, S.plan_text(ref, one, s_ref, scale, seeds[0], 0, 16),
                  s_ref, wav)
    assert v.length_ok and v.gap < 1e-3 and v.err_rms < 1e-4, v
    batch = [one + " " + texts.text(), texts.text()]
    outs = next(iter(eng.serve([batch], style, n_merge=4)))
    for i, (text, out) in enumerate(zip(batch, outs)):
        chunks = S.plan_text(ref, text, s_ref, scale, seeds[1], i, 4)
        v = S.compare(ref, chunks, s_ref, out)
        assert v.length_ok and v.gap < 1e-3, (i, v)


def test_ambiguous_rounding_is_rendered_both_ways():
    dur = np.array([1.0, 2.5 + 1e-5, 3.2, 0.7])
    c = S.Chunk(None, None, dur, np.clip(np.round(dur), 1, None).astype(int))
    ways = [tuple(p) for p in S._roundings(c)]
    assert ways == [(1, 3, 3, 1), (1, 2, 3, 1)]
