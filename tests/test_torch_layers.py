"""The port's phase-1 and style modules against their JAX functions.

Each module is built at the small sizes of tools/golden.py SPECS, the JAX
init's parameters are carried across with weights.load_param_tree, and the
same numpy-seeded inputs go through both sides on the CPU. Everything is
f32 (the JAX side at Precision.HIGHEST), so the sides differ only in
summation order: atol 1e-4, rtol 1e-4 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.nn import layers as JL
from styletts2_tpu.nn import predictor as JPR
from styletts2_tpu.nn import style_encoder as JSE
from styletts2_tpu.nn import text_encoder as JTE
from styletts2_tpu.tools.golden import SPECS
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.nn import layers as TL
from styletts2_tpu_torch.nn.predictor import ProsodyPredictor
from styletts2_tpu_torch.nn.style_encoder import StyleEncoder
from styletts2_tpu_torch.nn.text_encoder import TextEncoder

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    W.load_param_tree({"m": module}, {"m": tree})
    return module.eval()


def _masks(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def test_lstm_packed_matches_masked_scan():
    """nn.LSTM over packed sequences == the JAX masked-carry BiLSTM scan,
    variable lengths, zeros at padding."""
    rng = np.random.default_rng(0)
    tree = _np_tree(JL.lstm_init(jax.random.PRNGKey(1), 24, 16))
    x = rng.standard_normal((3, 11, 24)).astype(np.float32)
    mask = _masks([11, 6, 1], 11)
    want = JL.lstm_apply(tree, jnp.asarray(x), jnp.asarray(mask))
    mod = _load(TL.bilstm(24, 16), tree)
    with torch.no_grad():
        got = TL.lstm(mod, torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_adain_and_layer_norms_match():
    rng = np.random.default_rng(1)
    b, t, c, sd = 2, 30, 24, 8
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    s = rng.standard_normal((b, sd)).astype(np.float32)
    mask = _masks([30, 17], t)
    ada = _np_tree(JL.adain_1d_init(jax.random.PRNGKey(2), sd, c))
    want = JL.adain_1d_act_apply(ada, jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(mask), act="lrelu")
    mod = _load(TL.AdaIN1d(sd, c), ada)
    with torch.no_grad():
        got = TL.adain_1d_act(mod, torch.from_numpy(x), torch.from_numpy(s),
                              torch.from_numpy(mask), act="lrelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    aln = _np_tree(JL.ada_layer_norm_init(jax.random.PRNGKey(3), sd, c))
    want = JL.ada_layer_norm_apply(aln, jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        got = _load(TL.AdaLayerNorm(sd, c), aln)(torch.from_numpy(x),
                                                 torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_text_encoder_matches():
    spec = SPECS["text_encoder"]
    tree = _np_tree(JTE.init(jax.random.PRNGKey(4), **spec))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, spec["n_symbols"], (2, 16)).astype(np.int32)
    mask = _masks([16, 9], 16)
    want = JTE.apply(tree, jnp.asarray(tokens), jnp.asarray(mask),
                     kernel_size=spec["kernel_size"])
    mod = _load(TextEncoder(**spec), tree)
    with torch.no_grad():
        got = mod(torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_style_encoder_matches():
    tree = _np_tree(JSE.init(jax.random.PRNGKey(5), **SPECS["style_encoder"]))
    rng = np.random.default_rng(5)
    # odd frame count exercises the edge-duplicated shortcut pooling
    mel = rng.standard_normal((2, 80, 97)).astype(np.float32)
    want = JSE.apply(tree, jnp.asarray(mel))
    with torch.no_grad():
        got = _load(StyleEncoder(**SPECS["style_encoder"]), tree)(
            torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def predictor():
    spec = {k: v for k, v in SPECS["predictor"].items() if k != "dropout"}
    tree = _np_tree(JPR.init(jax.random.PRNGKey(6), **spec))
    return spec, tree, _load(ProsodyPredictor(**spec), tree)


def test_predictor_duration_matches(predictor):
    spec, tree, mod = predictor
    rng = np.random.default_rng(6)
    b, t = 2, 14
    t_en = rng.standard_normal((b, t, spec["d_hid"])).astype(np.float32)
    s = rng.standard_normal((b, spec["style_dim"])).astype(np.float32)
    mask = _masks([14, 8], t)
    d_j = JPR.encode_duration(tree, jnp.asarray(t_en), jnp.asarray(s),
                              jnp.asarray(mask))
    want = JPR.duration_head(tree, d_j, jnp.asarray(mask))
    with torch.no_grad():
        d_t = mod.encode_duration(torch.from_numpy(t_en), torch.from_numpy(s),
                                  torch.from_numpy(mask))
        got = mod.duration_head(d_t, torch.from_numpy(mask))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predictor_f0n_matches(predictor):
    spec, tree, mod = predictor
    rng = np.random.default_rng(7)
    b, f = 2, 20
    en = rng.standard_normal(
        (b, f, spec["d_hid"] + spec["style_dim"])).astype(np.float32)
    s = rng.standard_normal((b, spec["style_dim"])).astype(np.float32)
    mask = _masks([20, 13], f)
    out_mask = np.repeat(mask, 2, axis=1)
    want = JPR.f0n_train(tree, jnp.asarray(en), jnp.asarray(s),
                         mask=jnp.asarray(mask), out_mask=jnp.asarray(out_mask))
    with torch.no_grad():
        got = mod.f0n(torch.from_numpy(en), torch.from_numpy(s),
                      mask=torch.from_numpy(mask),
                      out_mask=torch.from_numpy(out_mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
