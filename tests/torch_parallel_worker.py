"""One rank of the port's multi-process CPU tests (not collected by pytest).

    python tests/torch_parallel_worker.py MODE RANK WORLD STORE IO_DIR

joins a gloo process group of WORLD ranks through the `file://` store at
STORE (no port to race for), reads its inputs from IO_DIR/MODE_in.pkl
and writes what it computed to IO_DIR/MODE_out_<RANK>.pkl. MODE is
seqpar (the frame-sharded decode), engine (the data-parallel and the
sequence-parallel engine), single_engine (their single-device reference,
one rank), step (the data-parallel train step), single (its
single-process reference, one rank) or loop (`train_loop
--distributed`). Imports torch and the port only: nothing of
JAX or the styletts2_tpu package. The tests start the ranks with `launch`
(subprocesses: a spawn would re-import the test module, and JAX with it)
and read them back with `collect`.
"""

import hashlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from styletts2_tpu_torch import weights as W  # noqa: E402
from styletts2_tpu_torch.config import load_config  # noqa: E402
from styletts2_tpu_torch.parallel import (  # noqa: E402
    init_distributed, make_mesh)


def launch(mode, inp, io_dir, world=2):
    """Write `inp` and start WORLD ranks of MODE on it (one thread each;
    each rank's output goes to IO_DIR/MODE_log_<RANK>.txt, so no pipe
    fills while another rank is waited for)."""
    io = Path(io_dir)
    with open(io / f"{mode}_in.pkl", "wb") as f:
        pickle.dump(inp, f)
    store = io / f"{mode}_store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(io / f"{mode}_log_{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, mode, str(r), str(world),
                 str(store), str(io)], stdout=log, stderr=subprocess.STDOUT,
                env=env))
    return procs


def collect(procs, mode, io_dir, timeout=300):
    """Wait for every rank (raising with its log if one failed) and return
    their outputs in rank order."""
    io = Path(io_dir)
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            log = (io / f"{mode}_log_{r}.txt").read_text()
            raise RuntimeError(f"rank {r} of {mode} failed "
                               f"({p.returncode}):\n{log[-4000:]}")
    outs = []
    for r in range(len(procs)):
        path = io / f"{mode}_out_{r}.pkl"
        with open(path, "rb") as f:
            outs.append(pickle.load(f))
        path.unlink()  # up to ~1 GB (a whole model's parameters)
    return outs


def seeded_tree(module, seed):
    """Seeded random weights drawn by the port, as a JAX-layout numpy tree
    (weight norm as weight_g / weight_v): the tests and the ranks each
    draw the same tree from the seed, so no weights cross the processes."""
    W.init_random(module, torch.Generator().manual_seed(seed))
    W.split_weight_norm(module)
    return W.module_tree(module)


def decoder_tree(cfg_dict, seed):
    from styletts2_tpu_torch.nn.decoder import Decoder

    mp = load_config(cfg_dict).model_params
    return seeded_tree(Decoder(mp.decoder, 512, mp.style_dim), seed)


def engine_params(cfg_dict):
    """{module: tree} of the four inference modules, module i seeded i."""
    from styletts2_tpu_torch.models import build_inference_modules

    mods = build_inference_modules(load_config(cfg_dict).model_params)
    return {k: seeded_tree(m, i) for i, (k, m) in enumerate(mods.items())}


def _decoder(cfg_dict, seed):
    from styletts2_tpu_torch.nn.decoder import Decoder

    mp = load_config(cfg_dict).model_params
    dec = Decoder(mp.decoder, dim_in=512, style_dim=mp.style_dim)
    dec.load_state_dict(W.tree_to_state_dict(decoder_tree(cfg_dict, seed)),
                        strict=True)
    dec.prepack(torch.float32)
    return dec.eval()


def _inject_source(dec, har):
    """Make the decoder's generator take `har` (numpy) as its harmonic
    source: the NSF source (B, L, 1) for HiFi-GAN, the source STFT
    features for iSTFTNet."""
    t = torch.from_numpy(har)
    if dec.cfg.type == "hifigan":
        dec.generator.m_source.forward = lambda *a, **k: t
    else:
        dec.generator.source_features = lambda *a, **k: t


@torch.inference_mode()
def run_seqpar(mesh, inp):
    """sp_decoder_apply of each case, unpadded and with n_valid; a case
    with `har` / `har_padded` takes that harmonic source."""
    from styletts2_tpu_torch.parallel.seqpar import sp_decoder_apply

    out = {}
    for name, case in inp.items():
        dec = _decoder(case["cfg"], case["seed"])
        x = [torch.from_numpy(case[k]) for k in ("asr", "f0", "n", "s")]
        for suffix, nv in (("", None), ("_padded", case["nv"])):
            if "har" + suffix in case:
                _inject_source(dec, case["har" + suffix])
            out[name + suffix] = sp_decoder_apply(
                mesh, dec, *x, margin=case["margin"],
                n_valid=None if nv is None else torch.from_numpy(nv)).numpy()
    return out


def single_engine_run(inp):
    """What run_engine computes, on one device (the tests' reference):
    {"style", "wav", and for "dp" "batch" (each text's own generate)}."""
    from styletts2_tpu_torch.infer import StyleTTS2

    params = engine_params(inp["cfg"]) if inp.get("seeded") else None
    e = StyleTTS2(load_config(inp["cfg"]), params=params, seed=0,
                  device="cpu")
    return _engine_run(e, inp)


def _engine_run(e, inp):
    e.fused_enabled = False
    style = {"style": e.compute_style(inp["ref_wav"], denoise=0.0),
             "speed": 1.0}
    work = inp.get("sp") or inp["dp"]
    if "sp" in inp:  # ~170 frames -> the 256 bucket, sp active
        e.fixed_duration = work["fixed"]
    out = {"style": style["style"].numpy(),
           "wav": e.generate(work["text"], style, stabilize=False,
                             n_merge=1)}
    if "dp" in inp:
        e.fixed_duration = work["fixed"]
        calls0 = e.phase2_calls
        if e.mesh is not None:
            out["batch"] = e.generate_batch(work["texts"], style,
                                            stabilize=False, n_merge=1)
        else:
            out["batch"] = [e.generate(t, style, stabilize=False, n_merge=1)
                            for t in work["texts"]]
        out["batch_phase2_calls"] = e.phase2_calls - calls0
    return out


def run_engine(mesh, inp):
    """The seq-parallel (inp["sp"]) or data-parallel (inp["dp"]) engine
    over the ranks, the fused path off: generate, and for "dp"
    generate_batch; with the count of frame-sharded decodes."""
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.parallel import seqpar as SP

    params = engine_params(inp["cfg"]) if inp.get("seeded") else None
    e = StyleTTS2(load_config(inp["cfg"]), params=params, seed=0,
                  device="cpu", mesh=mesh, seq_parallel="sp" in inp)
    calls = []
    orig = SP.sp_decoder_apply

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    SP.sp_decoder_apply = spy
    out = _engine_run(e, inp)
    out["sp_calls"] = len(calls)
    out["batch_buckets"] = e.batch_buckets
    return out


def _step_tree(inp):
    """The step's {module: tree} of all eight modules, pickled by the test
    at inp["tree"] (JAX's build_model at PRNGKey(0))."""
    with open(inp["tree"], "rb") as f:
        return pickle.load(f)


def _train_modules(cfg, tree):
    from styletts2_tpu_torch.models import build_model

    mods = build_model(cfg.model_params)
    W.split_weight_norm(mods)
    W.load_param_tree(mods, tree, fuse=False)
    mods.train()
    mods["pitch_extractor"].eval()
    return mods


def _flat(mods, keys):
    return {k: torch.cat([p.detach().reshape(-1)
                          for p in mods[k].parameters()]).numpy()
            for k in keys}


def _step_setup(inp):
    """(config, crop, the global batch, its fixed draws with dropout off)."""
    from styletts2_tpu_torch import train as TT

    b = inp["batch"]
    batch = TT.Batch(*(torch.from_numpy(b[k]) for k in
                       ("waves", "texts", "input_lengths", "mel_lengths")))
    draws = TT.Draws(coin=True, starts=torch.from_numpy(inp["starts"]),
                     source=(torch.from_numpy(inp["rand_ini"]),
                             torch.from_numpy(inp["noise"])),
                     dropout=False)
    return load_config(inp["cfg"]), inp["crop"], batch, draws


def run_single(mesh, inp):
    """run_step's reference, in a process of its own: the parameters after
    one single-process step on the whole batch."""
    from styletts2_tpu_torch import train as TT
    from styletts2_tpu_torch.optim import MultiOptimizer

    cfg, crop, batch, draws = _step_setup(inp)
    mods = _train_modules(cfg, _step_tree(inp))
    TT.make_train_step(cfg, MultiOptimizer(mods), crop)(
        mods, batch, torch.Generator().manual_seed(0), draws)
    return {"params": _flat(mods, TT.DISC_MODULES + TT.GEN_MODULES)}


def run_step(mesh, inp):
    """On this rank's rows of the global batch, draws fixed and dropout
    off: the rank-averaged D/G gradients and losses of the initial
    parameters, and the parameters after one data-parallel step; then a
    generator forward with every draw made (dropout on), recording the
    per-row draws and the coin."""
    from styletts2_tpu_torch import train as TT
    from styletts2_tpu_torch.nn import layers as L
    from styletts2_tpu_torch.optim import MultiOptimizer
    from styletts2_tpu_torch.parallel import mean_metrics, shard_batch

    cfg, crop, batch, draws = _step_setup(inp)
    local, local_draws = shard_batch(mesh, (batch, draws))
    out = {"local_rows": local.waves.shape[0]}

    mods = _train_modules(cfg, _step_tree(inp))
    # the gradients and losses of the initial parameters, as the step
    # averages them
    d_fn, g_fn = TT.make_grad_fns(cfg, crop, mesh)
    d_loss, d_g = d_fn(mods, local, None, local_draws)
    met, g_g = g_fn(mods, local, None, local_draws)
    for g in (d_g, g_g):
        TT.sync_grads(mesh, g)
    out["metrics"] = {k: float(v) for k, v in mean_metrics(
        mesh, dict(met, d_loss=d_loss)).items()}
    out["grads"] = {k: torch.cat([t.reshape(-1) for t in gs]).numpy()
                    for g in (d_g, g_g) for k, gs in g.items()}

    keys = TT.DISC_MODULES + TT.GEN_MODULES
    step = TT.make_parallel_train_step(cfg, MultiOptimizer(mods), mesh, crop)
    step(mods, local, torch.Generator().manual_seed(0), local_draws)
    out["params_dp"] = _flat(mods, keys)

    # every draw made: per-row draws at the global batch, sliced
    rows, coins = [], []
    orig_rows, orig_rand = L.rand_rows, torch.rand

    def spy_rows(*a, **k):
        rows.append(orig_rows(*a, **k).clone())
        return rows[-1]

    def spy_rand(*a, **k):
        r = orig_rand(*a, **k)
        if r.dim() == 0:
            coins.append(float(r))
        return r

    L.rand_rows, torch.rand = spy_rows, spy_rand
    gen = torch.Generator().manual_seed(5)
    try:
        with torch.no_grad(), L.row_draws(mesh):
            mels = TT.compute_mels(local.waves, cfg.model_params,
                                   cfg.preprocess_params.spect_params)
            TT.generator_forward(mods, local, mels, gen, cfg.model_params,
                                 crop, True,
                                 cfg.preprocess_params.spect_params.hop_length)
    finally:
        L.rand_rows, torch.rand = orig_rows, orig_rand
    out["first_draw"] = rows[0].numpy()
    out["n_row_draws"] = len(rows)
    out["coins"] = coins
    out["gen_state"] = gen.get_state().numpy()
    return out


def _leaves(tree, prefix=""):
    """{dotted key: numpy array} of a nested tree of arrays/numbers."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def run_loop(mesh, inp):
    """`train_loop --distributed` on the workspace at inp["config"], with a
    small WavLM for the SLM stage: what each rank drew, the width its
    loader padded the texts to, the soft/mono coins, the generator's
    state, its parameters and optimizer states at the end, and the
    checkpoints it wrote."""
    import styletts2_tpu_torch.checkpoint as CK
    from styletts2_tpu_torch import train as TT
    from styletts2_tpu_torch import train_loop
    from styletts2_tpu_torch.nn import wavlm as WL

    small = WL.WavLMConfig
    WL.WavLMConfig = lambda: small(**inp["wavlm"])
    widths, coins, gens = [], [], []
    make_step, rand = TT.make_parallel_train_step, torch.rand

    def spy_make_step(*a, **k):
        step = make_step(*a, **k)

        def spied(mods, batch, gen, *sa, **sk):
            widths.append(batch.texts.shape[1])
            gens.append(gen)
            return step(mods, batch, gen, *sa, **sk)

        return spied

    def spy_rand(*a, **k):
        r = rand(*a, **k)
        if r.dim() == 0:
            coins.append(float(r))
        return r

    TT.make_parallel_train_step, torch.rand = spy_make_step, spy_rand
    # the checkpoint writes are recorded, not made (each would be ~1 GB)
    saved = []
    CK.save_checkpoint = lambda path, *a, **k: saved.append(
        os.path.basename(path))
    trainer = train_loop.main(["-p", inp["config"], "--distributed",
                               "--dist-url", inp["dist_url"]], device="cpu")
    sampler = trainer.train_loader.sampler
    out = {"drawn": sorted(i for _, b in sampler for i in b),
           "steps": len(trainer.history), "saved": saved,
           "rounds": sum("slm_g" in h["metrics"] for h in trainer.history),
           "metrics": [h["metrics"] for h in trainer.history],
           "text_widths": widths, "coins": coins,
           "gen_state": gens[-1].get_state().numpy()}
    state = {k: v.detach().numpy() for k, v in
             trainer.modules.state_dict().items()}
    state.update({f"wavlm_d.{k}": v.detach().numpy() for k, v in
                  trainer.slm.wl.wd.state_dict().items()})
    state.update({f"opt.{k}": v for k, v in
                  _leaves(trainer.opt.state_trees()).items()})
    wd_state = trainer.slm.wd_opt.state_dict()["state"]
    for i, st in wd_state.items():
        for k, v in st.items():
            state[f"wd_opt.{i}.{k}"] = np.asarray(v)
    # a digest per tensor: the bytes themselves would be ~1 GB
    out["state"] = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes())
                    .hexdigest() for k, v in state.items()}
    return out


def main():
    mode, rank, world, store, io_dir = sys.argv[1:6]
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    torch.set_num_threads(1)
    init_distributed(device="cpu", init_method=f"file://{store}")
    mesh = make_mesh(int(world), device="cpu")
    io = Path(io_dir)
    with open(io / f"{mode}_in.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {"seqpar": run_seqpar, "engine": run_engine,
           "single_engine": lambda _, i: single_engine_run(i),
           "step": run_step, "single": run_single,
           "loop": run_loop}[mode](mesh, inp)
    with open(io / f"{mode}_out_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
