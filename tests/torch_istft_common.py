"""Shared cases of tests/test_torch_istftnet.py and tests/test_torch_vocos.py:
the tiny engine config per decoder type, the JAX and port engines built
from one set of JAX inference parameters (the whole Decoder on its masked
route), the generator parity harness (masked route, training route and
its gradients), and one port D/G step with a checkpoint round trip into
the JAX package."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from styletts2_tpu.config import load_config as jax_load_config
from styletts2_tpu.infer import StyleTTS2 as JaxStyleTTS2
from styletts2_tpu.nn import decoder as JDE
from styletts2_tpu_torch import train as TT
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.checkpoint import save_checkpoint
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.infer import StyleTTS2
from styletts2_tpu_torch.models import build_inference_modules, build_model

# the tiny engine of tests/test_torch_engine.py (hop 60, f32 decoder) with
# one token bucket and one frame bucket and one layer in the text encoder
# and predictor stacks, so the JAX engine compiles once and little
BASE = {
    "max_len": 66,
    "preprocess_params": {"spect_params": {"n_fft": 512, "win_length": 240,
                                           "hop_length": 60}},
    "model_params": {
        "hidden_dim": 64, "max_conv_dim": 64, "dim_in": 16, "style_dim": 32,
        "max_dur": 10, "n_layer": 1,
        "ASR_params": {"input_dim": 80, "hidden_dim": 64, "n_layers": 2,
                       "token_embedding_dim": 64}},
    "tpu": {"token_buckets": [24], "frame_buckets": [120],
            "decoder_dtype": "float32"},
    "debug": False,
}
TEXT = "hello there you"  # one chunk, 17 tokens
FIXED_FRAMES = 6  # 17 x 6 = 102 frames: a valid prefix of the 120 bucket


def config(decoder):
    cfg = copy.deepcopy(BASE)
    cfg["model_params"]["decoder"] = dict(decoder)
    return cfg


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


_DECODER_TREES = {}


def jax_decoder_tree(cfg):
    """The JAX package's fresh decoder tree for `cfg` (decoder_init), built
    once per config and shared by the engine and checkpoint cases."""
    key = json.dumps(cfg, sort_keys=True)
    if key not in _DECODER_TREES:
        mp = jax_load_config(copy.deepcopy(cfg)).model_params
        with jax.default_device(jax.devices("cpu")[0]):
            _DECODER_TREES[key] = jax.tree.map(np.asarray, JDE.decoder_init(
                jax.random.PRNGKey(0), mp.decoder, dim_in=mp.hidden_dim,
                style_dim=mp.style_dim))
    return _DECODER_TREES[key]


def port_tree(module, seed=0):
    """Seeded random weights drawn by the port (faster than the JAX
    package's eager init) as a JAX-layout numpy tree (weight norm as
    weight_g / weight_v)."""
    W.init_random(module, torch.Generator().manual_seed(seed))
    W.split_weight_norm(module)
    return W.module_tree(module)


def inference_params(cfg):
    """{module: numpy tree} of the four inference modules: the JAX
    package's decoder and the port's random text encoder, predictor and
    style encoder."""
    mods = build_inference_modules(load_config(copy.deepcopy(cfg))
                                   .model_params)
    return {k: (jax_decoder_tree(cfg) if k == "decoder" else port_tree(m))
            for k, m in mods.items()}


def generate_pair(cfg):
    """One text through the JAX engine and the port's CPU engine, both on
    the two-phase path with pinned durations, from the same parameters;
    then the port's fused path. Returns (jax, port, port fused) waves."""
    params = inference_params(cfg)
    jax_engine = JaxStyleTTS2(jax_load_config(copy.deepcopy(cfg)),
                              params=params, seed=0)
    port = StyleTTS2(load_config(copy.deepcopy(cfg)), params=params, seed=0,
                     device="cpu")
    style = {"style": (np.random.default_rng(0).standard_normal((1, 32))
                       * 0.3).astype(np.float32), "speed": 1.0}
    out = []
    for engine, fused in ((jax_engine, False), (port, False), (port, True)):
        engine.fused_enabled = fused
        engine.fixed_duration = FIXED_FRAMES
        out.append(engine.generate(TEXT, style, stabilize=True, n_merge=8))
    return out


def generator_inputs(seed, dim, b=2, t=24, style_dim=32):
    """Seeded generator inputs at mel rate: x (B, T, dim), s, F0 and a
    valid-prefix mask whose row 1 ends 5 frames before the bucket (its F0
    zero past it, so the masked and the unmasked route see one F0)."""
    rng = np.random.default_rng(seed)
    mask = np.arange(t)[None, :] < np.array([[t], [t - 5]])
    f0 = (np.abs(rng.standard_normal((b, t))) * 100 + 80).astype(np.float32)
    return dict(x=(rng.standard_normal((b, t, dim)) * 0.3).astype(np.float32),
                s=rng.standard_normal((b, style_dim)).astype(np.float32),
                f0=np.where(mask, f0, 0.0).astype(np.float32), mask=mask)


def generator_parity(make, tree, jax_apply, inputs, seed=5):
    """A port generator against its JAX apply on the same tree: the masked
    inference route (weight norm fused, kernel B1's plain version), and the
    training route (no mask, weight norm split) with the gradients of every
    parameter for a seeded cotangent (jax.vjp; the JAX side jitted once).
    make() builds the port generator; jax_apply(p, mask) runs JAX's.
    Returns {"masked", "train"} as (port, jax) output pairs and "grads",
    the (port, jax) pair of all gradients concatenated."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}

    def jax_side(p, mask, cot):
        y, vjp = jax.vjp(lambda q: jax_apply(q, None), p)
        return jax_apply(p, mask), y, vjp(cot)[0]

    inf = make()
    W.load_param_tree({"g": inf}, {"g": tree})
    for m in inf.modules():
        if hasattr(m, "prepack"):
            m.prepack(torch.float32)
    with torch.no_grad():
        masked = inf(t["x"], t["s"], t["f0"], t["mask"])
    gen = make()
    W.split_weight_norm(gen)
    W.load_param_tree({"g": gen}, {"g": tree}, fuse=False)
    y = gen(t["x"], t["s"], t["f0"])
    cot = np.random.default_rng(seed).standard_normal(y.shape).astype(
        np.float32)
    y.backward(torch.from_numpy(cot))
    want_m, want_y, want_g = jax.jit(jax_side)(
        tree, jnp.asarray(inputs["mask"]), jnp.asarray(cot))
    flat = W.tree_to_state_dict(jax.tree.map(np.asarray, want_g), fuse=False)
    names = [k for k, _ in gen.named_parameters()]
    assert sorted(names) == sorted(flat)
    got_g = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in gen.parameters()]
    return {"masked": (masked.numpy(), np.asarray(want_m)),
            "train": (y.detach().numpy(), np.asarray(want_y)),
            "grads": (torch.cat([g.flatten() for g in got_g]).numpy(),
                      torch.cat([flat[k].flatten() for k in names]).numpy())}


def train_step_and_checkpoint(cfg, tmp_path):
    """One port D/G step (make_train_step) on seeded random weights at the
    tiny config: finite losses, every trained module moved, the pitch
    extractor frozen. Then the checkpoint: strictly into the JAX package
    (apply_checkpoint over a fresh JAX decoder tree, and the same keys)
    and into the port's CPU engine. Returns the step's metrics."""
    from styletts2_tpu.checkpoint import apply_checkpoint
    from styletts2_tpu.checkpoint import load_checkpoint as jax_load
    from styletts2_tpu_torch.optim import MultiOptimizer

    tcfg = load_config(copy.deepcopy(cfg))
    mods = build_model(tcfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(0))
    W.split_weight_norm(mods)
    mods.train()
    mods["pitch_extractor"].eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    t_text, t_mel = 12, 70
    batch = TT.Batch(
        torch.from_numpy((rng.standard_normal((1, t_mel * 60)) * 0.1)
                         .astype(np.float32)),
        torch.from_numpy(rng.integers(4, 170, (1, t_text))),
        torch.tensor([t_text]), torch.tensor([t_mel]))
    before = {k: [p.detach().clone() for p in m.parameters()]
              for k, m in mods.items()}
    step = TT.make_train_step(tcfg, MultiOptimizer(mods))
    metrics = step(mods, batch, torch.Generator().manual_seed(1))
    for k in TT.GEN_MODULES + TT.DISC_MODULES:
        assert any(not torch.equal(a, p) for a, p in
                   zip(before[k], mods[k].parameters())), f"{k} did not move"
    assert all(torch.equal(a, p) for a, p in zip(
        before["pitch_extractor"], mods["pitch_extractor"].parameters()))

    path = str(tmp_path / "step.ckpt")
    save_checkpoint(path, mods)
    state = jax_load(path)
    fresh = {"decoder": jax_decoder_tree(cfg)}
    loaded = apply_checkpoint(fresh, state, strict_shapes=True)
    flat = W.tree_to_state_dict(jax.tree.map(np.asarray, loaded["decoder"]),
                                fuse=False)
    want = mods["decoder"].state_dict()
    assert set(flat) == set(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())
    engine = StyleTTS2(tcfg, models_path=path, device="cpu")
    dec = engine.modules["decoder"]
    assert type(dec.generator) is type(mods["decoder"].generator)
    return {k: float(v) for k, v in metrics.items()}
