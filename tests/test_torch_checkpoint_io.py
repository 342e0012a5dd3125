"""Checkpoints across the packages: reference-layout .pth files both ways
(styletts2_tpu_torch.convert against styletts2_tpu.convert) for the three
decoders, the engine and train_loop built from a .pth, and a JAX-written
training checkpoint (optax's AdamW states) read by the port with and
without jax / optax importable, its moments carried into the port's
AdamW and a second step taken on both sides.

Weights are the port's seeded random trees at the small sizes of
tests/torch_istft_common.py; trees and moments must cross exactly, the
second AdamW step agree within f32 rounding (2e-7 of the parameters'
scale: the two libraries order the update's products differently)."""

import copy
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from styletts2_tpu import checkpoint as JC
from styletts2_tpu import convert as JCV
from styletts2_tpu.optim import MultiOptimizer as JaxMultiOptimizer
from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch import checkpoint as TC
from styletts2_tpu_torch import convert as TCV
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.flac import write_flac
from styletts2_tpu_torch.infer import StyleTTS2
from styletts2_tpu_torch.models import build_inference_modules
from styletts2_tpu_torch.nn.jdc import JDCNet
from styletts2_tpu_torch.nn.style_encoder import StyleEncoder
from styletts2_tpu_torch.nn.text_encoder import TextEncoder
from styletts2_tpu_torch.optim import MultiOptimizer
from torch_istft_common import BASE, config, port_tree

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DECODERS = {
    "hifigan": {"type": "hifigan", "upsample_initial_channel": 512,
                "upsample_rates": [10, 6], "upsample_kernel_sizes": [20, 12],
                "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]]},
    "istftnet": {"type": "istftnet", "upsample_initial_channel": 64,
                 "upsample_rates": [2, 6], "upsample_kernel_sizes": [4, 12],
                 "resblock_kernel_sizes": [3],
                 "resblock_dilation_sizes": [[1]],
                 "gen_istft_n_fft": 20, "gen_istft_hop_size": 5},
    "vocos": {"type": "vocos", "intermediate_dim": 128, "num_layers": 2,
              "gen_istft_n_fft": 240, "gen_istft_hop_size": 60},
}
STEP_REL = 2e-7
MODS = ("text_encoder", "style_encoder")  # the JAX-trained modules


def _net(decoder, whole_decoder=False):
    """{module: numpy tree} of the four inference modules. Unless
    whole_decoder, the decoder leaves out the shell's encode and decode
    blocks: 1024 channels wide whatever the config (~120 MB per file), the
    same for the three types, and plain old-style weight norm."""
    mp = load_config(config(DECODERS[decoder])).model_params
    mods = build_inference_modules(mp)
    if not whole_decoder:
        mods["decoder"] = torch.nn.ModuleDict(
            {k: m for k, m in mods["decoder"].named_children()
             if k not in ("encode", "decode")})
    return {k: port_tree(m, seed=i) for i, (k, m) in enumerate(mods.items())}


def _flat(tree):
    return {k: np.asarray(v) for k, v in JCV.tree_to_state_dict(tree).items()}


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = _flat(got[key]), _flat(want[key])
        assert sorted(g) == sorted(w), key
        for name in w:
            assert g[name].shape == w[name].shape, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


@pytest.fixture(scope="module")
def nets():
    out = {d: _net(d) for d in DECODERS}
    # BatchNorm running stats: num_batches_tracked written and dropped
    out["hifigan"]["pitch_extractor"] = port_tree(JDCNet(num_class=1), 9)
    return out


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_pth_crosses_exactly(nets, decoder, tmp_path):
    """A .pth the JAX package writes reads in the port exactly as in JAX,
    and one the port writes reads back in JAX exactly; Vocos's decoder
    with new-style weight-norm keys."""
    net = nets[decoder]
    new_style = ("decoder",) if decoder == "vocos" else ()
    jax_pth, port_pth = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    JCV.save_torch_checkpoint(net, jax_pth, iters=3,
                              new_style_modules=new_style)
    TCV.save_torch_checkpoint(net, port_pth, iters=3,
                              new_style_modules=new_style)
    raw = torch.load(port_pth, map_location="cpu", weights_only=False)
    keys = list(raw["net"]["decoder"])
    assert any(".parametrizations.weight.original1" in k
               for k in keys) == bool(new_style)
    assert raw["iters"] == 3 and raw["optimizer"] == {}
    want = JCV.load_torch_checkpoint(jax_pth)
    _assert_trees_equal(TCV.load_torch_checkpoint(jax_pth), want)
    _assert_trees_equal(JCV.load_torch_checkpoint(port_pth), net)
    # load_checkpoint's .pth branch (suffix and zip magic)
    os.replace(port_pth, str(tmp_path / "port.bin"))
    state = TC.load_checkpoint(str(tmp_path / "port.bin"))
    assert state["optimizer"] is None and state["iters"] == 0
    _assert_trees_equal(state["net"], net)


def test_engine_from_pth_equals_engine_from_tree(tmp_path):
    """StyleTTS2(cfg, "x.pth") gives the audio of StyleTTS2(cfg,
    params=tree), bit for bit."""
    net = _net("vocos", whole_decoder=True)
    pth = str(tmp_path / "model.pth")
    TCV.save_torch_checkpoint(net, pth, new_style_modules=("decoder",))
    cfg = config(DECODERS["vocos"])
    style = {"style": (np.random.default_rng(0).standard_normal((1, 32))
                       * 0.3).astype(np.float32), "speed": 1.0}
    outs = []
    for kw in (dict(models_path=pth), dict(params=net)):
        engine = StyleTTS2(load_config(copy.deepcopy(cfg)), seed=0,
                           device="cpu", **kw)
        engine.fixed_duration = 6
        outs.append(engine.generate("hello there you", style))
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------
# a JAX-written training checkpoint
# ---------------------------------------------------------------------

def _grads(net, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), net)


def _jax_step(opt, key, grads, state, params):
    return jax.jit(lambda g, s, p: opt.step(key, g, s, p))(grads, state,
                                                            params)


@pytest.fixture(scope="module")
def jax_ckpt(nets, tmp_path_factory):
    """The JAX package's MultiOptimizer, one step on seeded gradients for
    the text encoder (lr) and the style encoder (ft_lr), saved with its own
    save_checkpoint (epoch 1, iters 7)."""
    net = {k: nets["hifigan"][k] for k in MODS}
    opt = JaxMultiOptimizer(net, lr=1e-4, ft_lr=1e-5)
    states = jax.jit(opt.init)(net)  # jitted: eager optax is slower
    params = dict(net)
    for key in MODS:
        params[key], states[key] = _jax_step(opt, key, _grads(net[key], 1),
                                             states[key], params[key])
    params = jax.tree.map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "jax.ckpt")
    JC.save_checkpoint(path, params, optimizer=states, iters=7, epoch=1)
    return path, params, states, opt


def test_optimizer_state_crosses_from_jax(jax_ckpt):
    """count / mu / nu -> step / exp_avg / exp_avg_sq exactly; then one
    more step on the same gradients on both sides."""
    path, params, states, jopt = jax_ckpt
    state = TC.load_checkpoint(path)
    assert type(state["optimizer"]["style_encoder"][0]).__module__ == \
        TC.__name__
    mp = load_config(config(DECODERS["hifigan"])).model_params
    mods = torch.nn.ModuleDict({
        "text_encoder": TextEncoder(channels=mp.hidden_dim, kernel_size=5,
                                    depth=mp.n_layer, n_symbols=mp.n_token),
        "style_encoder": StyleEncoder(dim_in=mp.dim_in,
                                      style_dim=mp.style_dim,
                                      max_conv_dim=mp.max_conv_dim)})
    W.split_weight_norm(mods)
    TC.apply_checkpoint(mods, state)
    opt = MultiOptimizer(mods, lr=1e-4, ft_lr=1e-5)
    opt.load_state_trees(state["optimizer"])
    for key, mod in mods.items():
        adam = states[key][0]
        mu = W.tree_to_state_dict(jax.tree.map(np.asarray, adam.mu), False)
        nu = W.tree_to_state_dict(jax.tree.map(np.asarray, adam.nu), False)
        for name, p in mod.named_parameters():
            st = opt.opts[key].state[p]
            assert int(st["step"]) == int(adam.count) == 1
            torch.testing.assert_close(st["exp_avg"], mu[name], rtol=0,
                                       atol=0)
            torch.testing.assert_close(st["exp_avg_sq"], nu[name], rtol=0,
                                       atol=0)

        grads = _grads(params[key], 2)
        new, _ = _jax_step(jopt, key, grads, states[key], params[key])
        g = W.tree_to_state_dict(grads, fuse=False)
        for name, p in mod.named_parameters():
            p.grad = g[name].clone()
        opt.step(key)
        want = W.tree_to_state_dict(jax.tree.map(np.asarray, new), False)
        for name, p in mod.named_parameters():
            scale = float(want[name].abs().max())
            err = float((p.detach() - want[name]).abs().max())
            assert err <= STEP_REL * max(scale, 1.0), (key, name, err)


def test_optimizer_leaves_without_a_parameter():
    """The rule for moment leaves that name no parameter (the pitch
    extractor's BatchNorm running stats): dropped when zero, an error when
    not; a parameter without moments is an error too."""
    jdc = torch.nn.ModuleDict({"pitch_extractor": JDCNet(num_class=1)})
    zeros = jax.tree.map(np.zeros_like, W.module_tree(jdc["pitch_extractor"]))
    adam = TC.ScaleByAdamState(count=np.int32(1), mu=zeros,
                               nu=copy.deepcopy(zeros))
    chain = (adam, TC.EmptyState(), TC.EmptyState())
    opt = MultiOptimizer(jdc)
    opt.load_state_trees({"pitch_extractor": chain})
    assert len(opt.opts["pitch_extractor"].state) == len(
        list(jdc.parameters()))
    mu = copy.deepcopy(zeros)
    mu["conv_block"]["1"]["running_mean"][0] = 1.0
    with pytest.raises(ValueError, match="running_mean"):
        opt.load_state_trees({"pitch_extractor": (adam._replace(mu=mu),)})
    nu = copy.deepcopy(zeros)
    del nu["classifier"]["weight"]
    with pytest.raises(KeyError, match="classifier.weight"):
        opt.load_state_trees({"pitch_extractor": (adam._replace(nu=nu),)})
    with pytest.raises(TypeError, match="optimizer state layout"):
        opt.load_state_trees({"pitch_extractor": [1, 2]})


_BLOCKED = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "optax",
                                      "styletts2_tpu"):
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, Block())
    import pickle
    from styletts2_tpu_torch import checkpoint, weights
    state = checkpoint.load_checkpoint(sys.argv[1])
    opt = state["optimizer"]["style_encoder"]
    assert type(opt[0]).__name__ == "ScaleByAdamState", opt
    assert int(opt[0].count) == 1 and state["iters"] == 7
    net = weights.load_checkpoint_net(sys.argv[1])
    assert sorted(net) == ["style_encoder", "text_encoder"]
    try:
        checkpoint._Unpickler(open(sys.argv[2], "rb")).load()
    except pickle.UnpicklingError as e:
        assert "optax._src.transform.ScaleByRmsState" in str(e), e
    else:
        raise AssertionError("an unknown optax class loaded")
    print("ok", sorted(sys.modules).count("optax"))
""")


def test_jax_checkpoint_loads_with_jax_and_optax_blocked(jax_ckpt, tmp_path):
    """A fresh interpreter whose imports of jax, optax and styletts2_tpu
    fail reads the JAX-written checkpoint (optimizer included) through
    checkpoint.load_checkpoint and weights.load_checkpoint_net; an optax
    class other than AdamW's states raises, naming it."""
    other = tmp_path / "other.pkl"
    other.write_bytes(b"coptax._src.transform\nScaleByRmsState\n)R.")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _BLOCKED, jax_ckpt[0],
                          str(other)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "0"]


def test_train_loop_from_pth_and_jax_checkpoint(jax_ckpt, nets, tmp_path):
    """train_loop.main with a .pth as pretrained_model loads its modules;
    resuming from the JAX-written checkpoint (load_only_params false)
    restores its moments and step counts. Both configs end before a step
    (epochs = the checkpoint's epoch), so no step runs on the CPU here:
    chip_smoke.py's phase 9 takes one from a .pth on the card."""
    from styletts2_tpu_torch.train_loop import main

    path, params = jax_ckpt[:2]
    clip = (np.random.default_rng(0).standard_normal(7000) * 0.1).astype(
        np.float32)
    write_flac(str(tmp_path / "a.flac"), clip)  # the loader probes FLAC too
    AUD.write_wav(str(tmp_path / "b.wav"), clip)
    (tmp_path / "list.txt").write_text("a.flac|hello there\n"
                                       "b.wav|hello you\n")
    pth = str(tmp_path / "seed.pth")
    TCV.save_torch_checkpoint({k: nets["hifigan"][k]
                               for k in ("predictor", "style_encoder")}, pth)
    # the data pipeline's hop is 300: prod(upsample_rates) == 300
    cfg = copy.deepcopy(BASE)
    cfg["model_params"]["decoder"] = dict(
        DECODERS["hifigan"], upsample_rates=[10, 30],
        upsample_kernel_sizes=[20, 60])
    trainers = {}
    for name, pretrained, epochs in (("pth", pth, 0), ("jax", path, 1)):
        run = dict(cfg, log_dir=str(tmp_path / f"runs_{name}"),
                   epochs=epochs, batch_size=2, pretrained_model=pretrained,
                   load_only_params=False,
                   data_params={"train_data": str(tmp_path / "list.txt"),
                                "val_data": str(tmp_path / "list.txt"),
                                "root_path": str(tmp_path)})
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(run))
        trainers[name] = main(["-p", str(tmp_path / f"{name}.yaml")],
                              device="cpu")
    mods = trainers["pth"].modules
    _assert_trees_equal({k: W.module_tree(mods[k]) for k in
                         ("predictor", "style_encoder")},
                        {k: nets["hifigan"][k] for k in
                         ("predictor", "style_encoder")})
    t = trainers["jax"]
    assert not t.history
    _assert_trees_equal({k: W.module_tree(t.modules[k]) for k in MODS},
                        {k: params[k] for k in MODS})
    for key in MODS:
        steps = {int(s["step"]) for s in t.opt.opts[key].state.values()}
        assert steps == {1}
    assert not t.opt.opts["decoder"].state  # absent from the checkpoint
