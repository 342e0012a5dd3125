"""StyleTTS2-lite's inference modules as plain functions of the weight
tree, one utterance at a time at its exact length, channels first.

Every weight-norm pair is fused here (w = g * v / ||v||, the norm over all
but dim 0); LSTMs are their recurrences written out (torch's gate order
i, f, g, o); AdaIN is instance norm over time with a style-made
(1 + gamma, beta); the HiFi-GAN source is the NSF sine bank with zero
initial phase and no noise (inference); Vocos's head is an iSTFT with
'same' padding. `Reference(..., precision="control")` computes the same
in the nearest precisions below the configuration's: TF32 matmuls and
convolutions for its float32 parts, and the bf16 decoder in float8 e4m3:
every weight, and every tensor the decoder makes (each conv, linear and
AdaIN output, each Snake, each residual sum), rounded to e4m3 under a
per-tensor scale (its largest magnitude to 448), where the program keeps
them in bf16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import frontend as FE

SQRT2 = math.sqrt(2.0)


def fuse(weights: Mapping[str, Mapping[str, torch.Tensor]]
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {key: tensor}} with every (weight_g, weight_v) pair merged
    into `weight`."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for m, leaves in weights.items():
        d = {}
        for k, v in leaves.items():
            if k.endswith(".weight_g"):
                continue
            if k.endswith(".weight_v"):
                g = leaves[k[: -len("weight_v")] + "weight_g"]
                norm = torch.sqrt((v * v).sum(dim=tuple(range(1, v.dim())),
                                              keepdim=True))
                d[k[: -len("_v")]] = g * v / norm
            else:
                d[k] = v
        out[m] = d
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    amax = x.abs().max()
    if float(amax) == 0.0:
        return x
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Ops:
    """conv / linear / AdaIN on one module's fused weights; q: every
    weight and every tensor made rounded to float8 (`act`)."""

    def __init__(self, p: Mapping[str, torch.Tensor], q: bool = False):
        self.p, self.q = p, q

    def act(self, x):
        """A tensor as the module stores it."""
        return _fp8(x) if self.q else x

    def _w(self, key):
        return self.act(self.p[f"{key}.weight"])

    def conv(self, key, x, **kw):
        """(C, T) -> (C', T') with F.conv1d's keywords."""
        return self.act(F.conv1d(self.act(x)[None], self._w(key),
                                 self.p.get(f"{key}.bias"), **kw)[0])

    def conv_t(self, key, x, **kw):
        return self.act(F.conv_transpose1d(
            self.act(x)[None], self._w(key), self.p.get(f"{key}.bias"),
            **kw)[0])

    def linear(self, key, x):
        return self.act(F.linear(self.act(x), self._w(key),
                                 self.p.get(f"{key}.bias")))

    def adain(self, key, x, s):
        """(1 + gamma) * InstanceNorm(x) + beta; x (C, T), s (style,)."""
        gamma, beta = self.linear(f"{key}.fc", s).chunk(2)
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
        return self.act((1.0 + gamma)[:, None] * (x - mean)
                        * torch.rsqrt(var + 1e-5) + beta[:, None])

    def bilstm(self, key, x):
        """(T, In) -> (T, 2H): both directions from zero states."""
        p = self.p
        hid = p[f"{key}.weight_hh_l0"].shape[1]
        sfx = ("", "_reverse")
        w_ih = torch.stack([p[f"{key}.weight_ih_l0{s}"] for s in sfx])
        w_hh = torch.stack([p[f"{key}.weight_hh_l0{s}"] for s in sfx])
        bias = torch.stack([p[f"{key}.bias_ih_l0{s}"] + p[f"{key}.bias_hh_l0{s}"]
                            for s in sfx])
        xs = torch.stack([x, x.flip(0)])                     # (2, T, In)
        gx = torch.matmul(xs, w_ih.transpose(1, 2)) + bias[:, None]
        h = torch.zeros(2, 1, hid, device=x.device)
        c = torch.zeros(2, hid, device=x.device)
        out = []
        for t in range(x.shape[0]):
            g = gx[:, t] + torch.bmm(h, w_hh.transpose(1, 2))[:, 0]
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            hh = torch.sigmoid(o) * torch.tanh(c)
            out.append(hh)
            h = hh[:, None]
        out = torch.stack(out, dim=1)                        # (2, T, H)
        return torch.cat([out[0], out[1].flip(0)], dim=-1)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _snake(o: "_Ops", x, alpha):
    a = alpha.reshape(-1, 1)
    return o.act(x + (1.0 / a) * torch.sin(a * x) ** 2)


def _resblk1d(o: _Ops, key, x, s, upsample=False):
    """AdainResBlk1d: x (C, T) -> (C', T or 2T)."""
    sc = x.repeat_interleave(2, dim=1) if upsample else x
    if f"{key}.conv1x1.weight" in o.p:
        sc = o.conv(f"{key}.conv1x1", sc)
    h = _lrelu(o.adain(f"{key}.norm1", x, s))
    if upsample:
        h = o.conv_t(f"{key}.pool", h, stride=2, padding=1,
                     output_padding=1, groups=h.shape[0])
    h = o.conv(f"{key}.conv1", h, padding=1)
    h = _lrelu(o.adain(f"{key}.norm2", h, s))
    h = o.conv(f"{key}.conv2", h, padding=1)
    return o.act((h + sc) / SQRT2)


def _resblock1(o: _Ops, key, x, s, k, dils):
    """AdaINResBlock1: per dilation, x += conv2(snake(adain2(conv1_d(
    snake(adain1(x))))))."""
    for i, d in enumerate(dils):
        xt = _snake(o, o.adain(f"{key}.adain1.{i}", x, s),
                    o.p[f"{key}.alpha1.{i}"])
        xt = o.conv(f"{key}.convs1.{i}", xt, dilation=d,
                    padding=d * (k - 1) // 2)
        xt = _snake(o, o.adain(f"{key}.adain2.{i}", xt, s),
                    o.p[f"{key}.alpha2.{i}"])
        x = o.act(x + o.conv(f"{key}.convs2.{i}", xt, padding=(k - 1) // 2))
    return x


class Reference:
    """The reference on one device. cfg: a configuration's dict (the keys
    of configs/config_example.yaml); weights: {module: {key: f32 tensor}}
    on `device`, weight norm unfused (params.make_weights)."""

    def __init__(self, cfg: Mapping, weights, device,
                 precision: str = "float32"):
        if precision not in ("float32", "control"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.device = cfg, torch.device(device)
        self.control = precision == "control"
        self.w = fuse(weights)
        self.mp = cfg["model_params"]
        self.dec = self.mp["decoder"]
        self.sr = cfg["preprocess_params"]["sr"]
        self.hop = cfg["preprocess_params"]["spect_params"]["hop_length"]
        self.symbols = FE.symbol_dict(cfg["symbol"])

    @contextlib.contextmanager
    def _precision(self):
        """TF32 off (on for the control) for the reference's own calls."""
        cm, cd = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.control
        torch.backends.cudnn.allow_tf32 = self.control
        try:
            with torch.inference_mode():
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = cm
            torch.backends.cudnn.allow_tf32 = cd

    def _ops(self, module, q=False):
        return _Ops(self.w[module], q and self.control)

    # ------------------------------------------------------------ style

    def style(self, wave: np.ndarray) -> torch.Tensor:
        """A voice clip -> (style_dim,): the mean of its windows' styles."""
        sp = self.cfg["preprocess_params"]["spect_params"]
        with self._precision():
            total, count = 0.0, 0
            for batch in FE.style_windows(wave, self.sr):
                mel = FE.log_mel(torch.from_numpy(batch).to(self.device),
                                 self.sr, sp["n_fft"], sp["win_length"],
                                 self.hop, self.mp["n_mels"])
                total = total + self._style_encoder(mel).sum(dim=0)
                count += batch.shape[0]
            return total / count

    def _style_encoder(self, mel):
        p = self.w["style_encoder"]

        def conv(key, x, **kw):
            return F.conv2d(x, p[f"{key}.weight"], p.get(f"{key}.bias"), **kw)

        x = conv("shared.0", mel[:, None], padding=1)
        for i in range(1, 5):
            k = f"shared.{i}"
            sc = conv(f"{k}.conv1x1", x) if f"{k}.conv1x1.weight" in p else x
            if sc.shape[3] % 2:
                sc = torch.cat([sc, sc[..., -1:]], dim=3)
            sc = F.avg_pool2d(sc, 2)
            h = conv(f"{k}.conv1", _lrelu(x), padding=1)
            h = conv(f"{k}.downsample_res.conv", h, stride=2, padding=1,
                     groups=h.shape[1])
            h = conv(f"{k}.conv2", _lrelu(h), padding=1)
            x = (sc + h) / SQRT2
        x = conv("shared.6", _lrelu(x))
        x = _lrelu(x.mean(dim=(2, 3)))
        return F.linear(x, p["unshared.weight"], p["unshared.bias"])

    # ------------------------------------------------------------ phase 1

    def phase1(self, toks: List[int], s: torch.Tensor):
        """Token ids -> (t_en (T, C), d (T, C + style), the duration head's
        expected durations (T,) as float32 numpy)."""
        with self._precision():
            te = self._ops("text_encoder")
            x = self.w["text_encoder"]["embedding.weight"][
                torch.tensor(toks, device=self.device)].T     # (C, T)
            for i in range(self.mp["n_layer"]):
                x = te.conv(f"cnn.{i}.0", x, padding=2)
                x = F.layer_norm(x.T, (x.shape[0],),
                                 te.p[f"cnn.{i}.1.gamma"],
                                 te.p[f"cnn.{i}.1.beta"], 1e-5).T
                x = _lrelu(x)
            t_en = te.bilstm("lstm", x.T)                      # (T, C)

            pr = self._ops("predictor")
            s_seq = s[None].expand(t_en.shape[0], -1)
            x = torch.cat([t_en, s_seq], dim=-1)
            for i in range(self.mp["n_layer"]):
                x = pr.bilstm(f"text_encoder.lstms.{2 * i}", x)
                gamma, beta = pr.linear(f"text_encoder.lstms.{2 * i + 1}.fc",
                                        s).chunk(2)
                x = (1.0 + gamma) * F.layer_norm(x, (x.shape[1],),
                                                 eps=1e-5) + beta
                x = torch.cat([x, s_seq], dim=-1)
            d = x
            logits = pr.linear("duration_proj.linear_layer",
                               pr.bilstm("lstm", d))
            dur = torch.sigmoid(logits).sum(dim=-1)
            return t_en, d, dur.cpu().numpy().astype(np.float32)

    # ------------------------------------------------------------ phase 2

    def phase2(self, t_en, d, s, pred: np.ndarray) -> np.ndarray:
        """Integer durations -> int16 PCM of sum(pred) * 2 * hop samples."""
        with self._precision():
            idx = torch.repeat_interleave(
                torch.arange(len(pred), device=self.device),
                torch.as_tensor(pred, device=self.device, dtype=torch.int64))
            en, asr = d[idx], t_en[idx]                        # (N, .)
            pr = self._ops("predictor")
            x = pr.bilstm("shared", en).T                      # (C, N)
            curves = []
            for head in ("F0", "N"):
                h = _resblk1d(pr, f"{head}.0", x, s)
                h = _resblk1d(pr, f"{head}.1", h, s, upsample=True)
                h = _resblk1d(pr, f"{head}.2", h, s)
                curves.append(pr.conv(f"{head}_proj", h)[0])  # (2N,)
            wav = self._decoder(asr.T, curves[0], curves[1], s)
            pcm = torch.clamp(wav, -1.0, 1.0) * 32767.0
            return pcm.to(torch.int16).cpu().numpy()

    def _decoder(self, asr, f0, n, s):
        o = self._ops("decoder", q=True)
        f0c = o.conv("F0_conv", f0[None], stride=2, padding=1)
        nc = o.conv("N_conv", n[None], stride=2, padding=1)
        x = _resblk1d(o, "encode", torch.cat([asr, f0c, nc]), s)
        asr_res = o.conv("asr_res.0", asr)
        for i in range(4):
            x = _resblk1d(o, f"decode.{i}", torch.cat([x, asr_res, f0c, nc]),
                          s, upsample=i == 3)
        if self.dec["type"] == "hifigan":
            return self._hifigan(o, x, s, f0)
        return self._vocos(o, x, s)

    def _hifigan(self, o: _Ops, x, s, f0):
        g = "generator"
        rates = self.dec["upsample_rates"]
        kups = self.dec["upsample_kernel_sizes"]
        up = int(np.prod(rates))
        length = f0.shape[0] * up
        # NSF source: per-frame instantaneous frequency of 9 harmonics,
        # integrated over frames, linearly upsampled to samples
        harm = torch.arange(1, 10, dtype=torch.float32, device=f0.device)
        rad = torch.remainder(f0[:, None] * harm / self.sr, 1.0)  # (M, 9)
        phase = torch.cumsum(rad, dim=0) * 2.0 * np.pi
        phase = F.interpolate(phase.T[None] * float(up), size=length,
                              mode="linear", align_corners=False)[0]
        uv = (f0 > 10.0).to(torch.float32).repeat_interleave(up)
        sines = torch.sin(phase) * 0.1 * uv                   # (9, L)
        har = torch.tanh(o.linear(f"{g}.m_source.l_linear", sines.T)).T
        n_k = len(self.dec["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(rates, kups)):
            x = _snake(o, x, o.p[f"{g}.alphas.{i}"])
            if i + 1 < len(rates):
                sf0 = int(np.prod(rates[i + 1:]))
                xs = o.conv(f"{g}.noise_convs.{i}", har, stride=sf0,
                            padding=(sf0 + 1) // 2)
                xs = _resblock1(o, f"{g}.noise_res.{i}", xs, s, 7, (1, 3, 5))
            else:
                xs = o.conv(f"{g}.noise_convs.{i}", har)
                xs = _resblock1(o, f"{g}.noise_res.{i}", xs, s, 11, (1, 3, 5))
            x = o.act(o.conv_t(f"{g}.ups.{i}", x, stride=u,
                               padding=u // 2 + u % 2,
                               output_padding=u % 2) + xs)
            acc = 0.0
            for j, (rk, rd) in enumerate(zip(
                    self.dec["resblock_kernel_sizes"],
                    self.dec["resblock_dilation_sizes"])):
                acc = acc + _resblock1(o, f"{g}.resblocks.{i * n_k + j}", x, s,
                                       rk, rd)
            x = o.act(acc / n_k)
        x = _snake(o, x, o.p[f"{g}.alphas.{len(rates)}"])
        return torch.tanh(o.conv(f"{g}.conv_post", x, padding=3))[0]

    def _vocos(self, o: _Ops, x, s):
        g = "generator"
        n_fft = self.dec["gen_istft_n_fft"]
        hop = self.dec["gen_istft_hop_size"]
        for i in range(self.dec["num_layers"]):
            k = f"{g}.convnext.{i}"
            h = o.conv(f"{k}.dwconv", x, padding=3, groups=x.shape[0])
            h = o.adain(f"{k}.norm", h, s).T
            h = o.linear(f"{k}.pwconv2", F.gelu(o.linear(f"{k}.pwconv1", h)))
            x = o.act(x + o.p[f"{k}.gamma"][:, None] * h.T)
        x = o.act(F.layer_norm(x.T, (x.shape[0],),
                               o.p[f"{g}.final_layer_norm.weight"],
                               o.p[f"{g}.final_layer_norm.bias"], 1e-6))
        h = o.linear(f"{g}.stft.out", x)                      # (M, n_fft + 2)
        mag = torch.clamp(torch.exp(h[:, : n_fft // 2 + 1]), max=1e2)
        ph = h[:, n_fft // 2 + 1:]
        frames = torch.fft.irfft(torch.polar(mag, ph), n=n_fft, dim=-1)
        win = torch.hann_window(n_fft, device=x.device)
        m = frames.shape[0]
        full = (m - 1) * hop + n_fft

        def ola(fr):
            return F.fold(fr.T[None], output_size=(1, full),
                          kernel_size=(1, n_fft), stride=(1, hop))[0, 0, 0]

        y = ola(frames * win) / torch.clamp(
            ola((win * win)[None].expand(m, -1)), min=1e-11)
        pad = (n_fft - hop) // 2
        return y[pad: full - pad]


def durations(raw: np.ndarray, scale: float, speed: float, prev_mean: float,
              t: float, rng: np.random.Generator
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """The duration glue of one chunk: the duration head's output scaled,
    blended toward N(prev_mean or its mean, its std) by t (the
    stabilisation, draws from `rng`), z-scores beyond 3 pulled to 2.85
    on tokens [1, n - 2), divided by the speed, rounded half to even, at
    least 1. Returns (the float durations before rounding, the integer
    durations, their mean, which chains into the next chunk)."""
    dur = raw * scale
    if t > 0:
        mean = prev_mean if prev_mean != 0 else dur.mean()
        dur = dur * (1 - t) + rng.normal(mean, dur.std(), size=dur.shape) * t
    dur = np.array(dur, dtype=np.float64)
    inner = dur[1:-2]
    if len(inner) >= 2:
        mu, sd = inner.mean(), inner.std(ddof=1)
        if sd != 0:
            out = np.abs((inner - mu) / sd) > 3.0
            inner[out] = (mu + np.sign(inner - mu) * (3.0 * sd * 0.95))[out]
    dur = dur / min(max(speed, 1e-4), 2.0)
    pred = np.clip(np.round(dur), 1, None).astype(np.int64)
    return dur, pred, float(dur.mean())
