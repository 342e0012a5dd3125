"""Gradient continuity of one D/G step under a 1e-6 weight change, in the
JAX package and in the port (not collected by pytest; a script):

    python tests/torch_grad_continuity.py [hifigan|istftnet|vocos]

At chip_smoke.py's small training config (TRAIN_TINY, its decoder block
replaced by TINY_DECODERS[type]), seeded random weights drawn by the port,
the draws fixed as tests/test_torch_train_parity.py fixes them (coin soft,
dropout and the aligner's unk masking off, the crops and the sine source's
phase and noise given): the step's D and G gradients at the weights and at
the text encoder's weights scaled by 1 + 1e-6, per module rel-l2, through
styletts2_tpu.train.make_grad_fns (jitted) and the port's make_grad_fns.
A gradient that is continuous at this level moves by ~1e-6-1e-5."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
import styletts2_tpu.nn.layers as JL  # noqa: E402
from styletts2_tpu import train as JT  # noqa: E402
from styletts2_tpu.config import load_config as jax_config  # noqa: E402
from styletts2_tpu.convert import tree_to_state_dict as jax_flat  # noqa: E402
from styletts2_tpu_torch import train as TT  # noqa: E402
from styletts2_tpu_torch import weights as W  # noqa: E402
from styletts2_tpu_torch.config import load_config  # noqa: E402
from styletts2_tpu_torch.models import build_model  # noqa: E402

EPS = 1e-6
B, T_TEXT, T_MEL, CROP = 2, 12, 100, 33


def main(dec: str) -> None:
    torch.set_num_threads(4)
    raw = copy.deepcopy(CS.TRAIN_TINY)
    if dec != "hifigan":
        raw["model_params"]["decoder"] = dict(CS.TINY_DECODERS[dec])
    cfg, jcfg = load_config(copy.deepcopy(raw)), jax_config(copy.deepcopy(raw))
    mods = build_model(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(3))
    W.split_weight_norm(mods)
    mods.train()
    mods["pitch_extractor"].eval()
    params = {k: jax.tree.map(jnp.asarray, W.module_tree(m))
              for k, m in mods.items()}
    hop = cfg.preprocess_params.spect_params.hop_length
    rng = np.random.default_rng(3)
    waves = (rng.standard_normal((B, T_MEL * hop)) * 0.1).astype(np.float32)
    texts = rng.integers(4, 170, (B, T_TEXT))
    in_len, mel_len = np.array([T_TEXT, T_TEXT - 3]), np.array([T_MEL,
                                                               T_MEL - 10])
    jbatch = JT.Batch(jnp.asarray(waves), jnp.asarray(texts, jnp.int32),
                      jnp.asarray(in_len, jnp.int32),
                      jnp.asarray(mel_len, jnp.int32))
    tbatch = TT.Batch(torch.tensor(waves), torch.tensor(texts),
                      torch.tensor(in_len), torch.tensor(mel_len))

    # JAX: dropout and unk masking off, the soft coin (as the parity test)
    uniform = jax.random.uniform
    JL.dropout = lambda x, rate, train, rng: x
    jax.random.uniform = lambda k, shape=(), *a, **kw: (
        jnp.ones(shape) if tuple(shape) == (B, T_TEXT)
        else uniform(k, shape, *a, **kw))
    jax.random.bernoulli = lambda *a, **kw: jnp.asarray(True)
    d_fn, g_fn = JT.make_grad_fns(jcfg, CROP)
    step = jax.jit(lambda p, b, k: (d_fn(p, b, k), g_fn(p, b, k)))

    def jax_grads(p):
        (_, dg), (_, gg) = step(p, jbatch, jax.random.PRNGKey(3))
        out = {}
        for k, v in {**dg, **gg}.items():
            flat = jax_flat(jax.tree.map(np.asarray, v))
            out[k] = np.concatenate([np.asarray(flat[n]).ravel()
                                     for n, _ in mods[k].named_parameters()])
        return out

    spf = mods["decoder"].generator.source_samples_per_frame
    rand_ini = rng.random((B, 9)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    noise = rng.standard_normal((B, 2 * CROP * max(spf, 1), 9)).astype(
        np.float32)
    pd, pg = TT.make_grad_fns(cfg, CROP)

    def port_grads(m):
        draws = TT.Draws(coin=True, starts=torch.tensor([5, 2]), source=(
            (torch.tensor(rand_ini), torch.tensor(noise)) if spf else None),
            dropout=False)
        _, dg = pd(m, tbatch, None, draws)
        _, gg = pg(m, tbatch, None, draws)
        return {k: torch.cat([g.flatten() for g in v]).numpy()
                for k, v in {**dg, **gg}.items()}

    scaled = dict(params)
    scaled["text_encoder"] = jax.tree.map(lambda x: x * (1 + EPS),
                                          params["text_encoder"])
    moved = copy.deepcopy(mods)
    with torch.no_grad():
        for p in moved["text_encoder"].parameters():
            p.mul_(1 + EPS)
    for name, (a, b) in (("JAX", (jax_grads(params), jax_grads(scaled))),
                         ("port", (port_grads(mods), port_grads(moved)))):
        print(f"{dec} {name}: text encoder x (1 + {EPS:g}) moves the step's "
              "gradients by (rel-l2) " + ", ".join(
                  f"{k} {np.linalg.norm(a[k] - b[k]) / np.linalg.norm(a[k]):.2e}"
                  for k in sorted(a)))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "vocos")
