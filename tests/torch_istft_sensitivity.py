"""How far one bf16 step at the generator's input moves its output, in the
JAX package and in the port (not collected by pytest; a script):

    python tests/torch_istft_sensitivity.py [frames per token]

At full width (configs/config_example.yaml, the iSTFTNet generator from
config.with_decoder_type, and the HiFi-GAN one beside it), bf16, on the
CPU: the port's engine with seed 0 (the random weights chip_smoke.py's
engines draw) runs one `generate` of a short text at a fixed duration;
its generator's input (x, style, F0, frame mask) is kept and the
generator's weights carried into the JAX package. Both generators then
run on that x and on the same x with every nonzero element moved by one
bf16 step (+-1 on its bit pattern, seeded signs: a relative 2^-8 to
2^-7). Prints, per decoder and package, the rel-l2 move of each stage
over the valid prefix (iSTFTNet: chip_smoke.istft_stages, from each
upsample to the clipped PCM; HiFi-GAN: the output and the PCM), the
first stage that moves more than 3x the stages it reads, and the port /
JAX ratio per stage. It answers whether the iSTFTNet generator's
amplification of a rounding change (the card's batch-8-vs-1 spread) is
the port's or the reference architecture's on random weights."""

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

import chip_smoke as CS  # noqa: E402
import styletts2_tpu.nn.blocks as JB  # noqa: E402
import styletts2_tpu.nn.layers as JL  # noqa: E402
from styletts2_tpu.config import load_config as jax_config  # noqa: E402
from styletts2_tpu.nn import decoder as JDE  # noqa: E402
from styletts2_tpu.nn import istftnet as JINET  # noqa: E402
from styletts2_tpu_torch import weights as W  # noqa: E402
from styletts2_tpu_torch.config import (load_config,  # noqa: E402
                                        with_decoder_type)
from styletts2_tpu_torch.infer import StyleTTS2  # noqa: E402

TEXT = "Hello there, how are you today?"


def one_ulp(x: np.ndarray, seed: int) -> np.ndarray:
    """bf16(x) with every nonzero element moved one bf16 step up or down
    (seeded), as f32 (each value exact in bf16)."""
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
    sign = torch.from_numpy(np.random.default_rng(seed).choice(
        [-1, 1], x.shape).astype(np.int16) * (x != 0))
    return (bits + sign).view(torch.bfloat16).float().numpy()


def engine_inputs(cfg, per_token: int):
    """The full-width bf16 engine (seed 0) on the CPU and its generator's
    input (x, s, F0, mask) in one `generate` of TEXT at `per_token` frames
    per token, as f32 numpy."""
    engine = StyleTTS2(cfg, seed=0, decoder_dtype="bfloat16", device="cpu")
    seen = []
    hook = engine.modules["decoder"].generator.register_forward_pre_hook(
        lambda mod, args: seen.append([a.clone() for a in args[:4]]))
    engine.fixed_duration = per_token
    style = (np.random.default_rng(3).standard_normal((1, 128)) * 0.3
             ).astype(np.float32)
    engine.generate(TEXT, {"style": style}, stabilize=False)
    hook.remove()
    return engine, [a.float().numpy() if a.is_floating_point() else a.numpy()
                    for a in seen[-1]]


def jax_taps(n_fft: int):
    """chip_smoke.istft_taps for the JAX generator, inside one jit trace
    (the recorded tracers are returned as outputs): patches the layers
    and blocks the generator calls, and returns (record, restore)."""
    rec = {"up": [], "block": [], "post": []}
    saved = (JL.conv_transpose1d_apply, JL.conv1d_apply,
             JB.adain_res_block1_apply)
    conv_t, conv, block = saved

    def tap_conv_t(*a, **kw):
        rec["up"].append(conv_t(*a, **kw))
        return rec["up"][-1]

    def tap_conv(*a, **kw):
        y = conv(*a, **kw)
        if y.shape[-1] == n_fft + 2:
            rec["post"].append(y)
        return y

    def tap_block(*a, **kw):
        rec["block"].append(block(*a, **kw))
        return rec["block"][-1]

    def restore():
        (JL.conv_transpose1d_apply, JL.conv1d_apply,
         JB.adain_res_block1_apply) = saved

    JL.conv_transpose1d_apply, JL.conv1d_apply = tap_conv_t, tap_conv
    JB.adain_res_block1_apply = tap_block
    return rec, restore


def main(per_token: int) -> None:
    torch.set_num_threads(4)
    raw = yaml.safe_load((ROOT / "configs" / "config_example.yaml")
                         .read_text())
    for dec_type in ("istftnet", "hifigan"):
        t0 = time.perf_counter()
        cfg = load_config(with_decoder_type(copy.deepcopy(raw), dec_type))
        jdc = jax_config(with_decoder_type(copy.deepcopy(raw),
                                           dec_type)).model_params.decoder
        dc = cfg.model_params.decoder
        engine, (x, s, f0, mask) = engine_inputs(cfg, per_token)
        gen = engine.modules["decoder"].generator
        jtree = jax.tree.map(jnp.asarray, W.module_tree(gen))
        x_moved = one_ulp(x, seed=1)
        frac, n = float(mask.mean()), int(mask.sum())
        print(f"{dec_type}: the engine's generator input {x.shape} bf16 (rms "
              f"{np.sqrt(np.mean(x[0, :n] ** 2)):.3g}), {n} valid mel "
              f"frames; one step moves it rel-l2 "
              f"{CS.rel_l2(x_moved[0, :n], x[0, :n]):.3g}", flush=True)
        istft = dec_type == "istftnet"
        n_up, n_k = len(dc.upsample_rates), len(dc.resblock_kernel_sizes)
        n_fft = dc.gen_istft_n_fft if istft else -1
        japply = (JINET.istftnet_generator_apply if istft
                  else JDE.hifigan_generator_apply)

        def stages(rec, out):
            if istft:
                return CS.istft_stages(rec, n_up, n_k, n_fft, out)
            out = out.float().numpy()
            return {"out": out, "pcm": np.clip(out, -1.0, 1.0)}

        def port_run(xv):
            with torch.inference_mode(), CS.istft_taps(n_fft) as rec:
                out = gen(torch.from_numpy(xv).to(torch.bfloat16),
                          torch.from_numpy(s).to(torch.bfloat16),
                          torch.from_numpy(f0), torch.from_numpy(mask))
            return stages(rec, out)

        def jax_fn(p, xv):
            rec, restore = jax_taps(n_fft)
            try:
                out = japply(p, xv.astype(jnp.bfloat16),
                             jnp.asarray(s, jnp.bfloat16), jnp.asarray(f0),
                             None, jdc, jnp.asarray(mask))
            finally:
                restore()
            return out, rec

        jitted = jax.jit(jax_fn)

        def jax_run(xv):
            out, rec = jitted(jtree, jnp.asarray(xv))
            return stages({k: [torch.from_numpy(np.array(v, np.float32))
                               for v in vs] for k, vs in rec.items()},
                          torch.from_numpy(np.array(out, np.float32)))

        moves = {}
        for name, run in (("JAX", jax_run), ("port", port_run)):
            ref = run(x)
            moves[name], first = CS.stage_moves(run(x_moved), ref, frac)
            out = ref["istft" if istft else "out"]
            out = out[0, : int(np.ceil(out.shape[1] * frac))]
            print(f"{dec_type} {name}: output rms "
                  f"{np.sqrt(np.mean(out ** 2)):.3g}, "
                  f"{np.mean(np.abs(out) > 1.0):.1%} of it beyond the clip;"
                  " one step at the input moves " + ", ".join(
                      f"{k} {v:.3g}" for k, v in moves[name].items())
                  + (f"; first stage > {CS.ISTFT_STAGE_AMPLIFIES:g}x the "
                     f"stages it reads: {first}" if istft else ""),
                  flush=True)
        ratios = {k: moves["port"][k] / max(moves["JAX"][k], 1e-30)
                  for k in moves["port"]}
        differ = next((k for k, r in ratios.items() if not 0.5 <= r <= 2.0),
                      None)
        print(f"{dec_type}: port / JAX move per stage "
              + ", ".join(f"{k} {r:.3g}" for k, r in ratios.items())
              + (f"; first stage beyond 2x: {differ}" if differ
                 else "; every stage within 2x")
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
