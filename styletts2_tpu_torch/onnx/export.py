"""Export the full synthesis graph to ONNX: (tokens, style, speed) -> wav.

The port's copy of styletts2_tpu/onnx/export.py: the same graph, byte for
byte, from the same numpy tree. It reproduces the reference's exported
surface (ONNX/export_onnx.py:52-63 — one ModelProto with dynamic token
count, style vector and speed scalar in, trimmed waveform out, the whole
pipeline in-graph: text encoder, duration encoder, duration head +
outlier clamp, alignment matrix, F0/N heads, decoder shell, and the
HiFi-GAN generator with its NSF source, the iSTFTNet generator or the
Vocos generator; ONNX/inference_onnx.py:225-261). Differences, both
deliberate:

* weight-norm is fused into plain conv weights at export (numerically
  identical; halves the initializer count),
* the sine source is deterministic (zero initial phase, no additive
  noise) — the path nn/decoder.sine_gen takes without source draws — so
  the graph is reproducible; the reference exports torch.rand into the
  graph.

`export_onnx` takes an inference tree ({text_encoder, predictor, decoder}
of numpy arrays, weight norm fused or raw); `export_modules` reads the
port's nn.Modules (weights.module_tree) and exports what the engine runs.
Activations are NCW [1, C, T] (torch/ONNX conv layout); the trees store
torch-layout weights, so initializers drop in directly. The emitted ops
are all standard opset-19 (the reference's export contract,
ONNX/export_onnx.py:54), so the file loads under onnxruntime/netron
unchanged; onnx/runtime.py evaluates it with torch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.onnx import proto as P
from styletts2_tpu_torch.onnx.builder import GraphBuilder

SR = 24000
HARMONICS = 9  # harmonic_num 8 + fundamental


# numpy DFT bases, as the JAX package builds its (ops/stft.py there): the
# initializers must be the same bytes as that package's export (the port's
# ops/stft.py builds its bases in torch, with integer range reduction)

def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window parity), f32."""
    n = win_length + 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return w[:win_length].astype(np.float32)


def _padded_window(n_fft: int, win_length: int,
                   center_window: bool) -> np.ndarray:
    w = hann_window(win_length)
    window = np.zeros(n_fft, dtype=np.float64)
    if center_window:
        left = (n_fft - win_length) // 2
        window[left:left + win_length] = w
    else:
        window[:win_length] = w[:min(win_length, n_fft)]
    return window


def _dft_bases(n_fft: int, win_length: int, center_window: bool):
    """(cos, -sin) bases of shape (n_fft, freq_bins), window pre-multiplied;
    the DC and (even n_fft) Nyquist imaginary columns exact zeros."""
    window = _padded_window(n_fft, win_length, center_window)
    angle = 2.0 * np.pi * np.outer(np.arange(n_fft),
                                   np.arange(n_fft // 2 + 1)) / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(angle) * window[:, None]).astype(np.float32)
    sin_b[:, 0] = 0.0
    if n_fft % 2 == 0:
        sin_b[:, -1] = 0.0
    return cos_b, sin_b


def _idft_bases(n_fft: int, win_length: int, scale: bool,
                center_window: bool):
    """Inverse-DFT bases (freq_bins, n_fft), window (and 1/n_fft) folded
    in."""
    window = _padded_window(n_fft, win_length, center_window)
    angle = 2.0 * np.pi * np.outer(np.arange(n_fft),
                                   np.arange(n_fft // 2 + 1)) / n_fft
    inv_scale = (1.0 / n_fft) if scale else 1.0
    cos_b = (np.cos(angle).T * window[None, :] * inv_scale).astype(np.float32)
    sin_b = (np.sin(angle).T * window[None, :] * inv_scale).astype(np.float32)
    return cos_b, sin_b


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32) if np.asarray(a).dtype != np.int64 \
        else np.asarray(a)


def _fused_weight(p: Dict[str, Any]) -> np.ndarray:
    """weight_norm fusion (g * v / ||v||, dim 0) or the plain weight."""
    if "weight_v" in p:
        v = np.asarray(p["weight_v"], np.float32)
        g = np.asarray(p["weight_g"], np.float32)
        axes = tuple(range(1, v.ndim))
        return (g * v / np.sqrt((v * v).sum(axis=axes, keepdims=True)))
    return np.asarray(p["weight"], np.float32)


class _Exporter:
    def __init__(self, params: Dict[str, Any], cfg):
        self.p = params
        self.cfg = cfg
        self.b = GraphBuilder("styletts2_lite")
        mp = cfg.model_params
        self.hidden = mp.hidden_dim
        self.style_dim = mp.style_dim
        self.nlayer = mp.n_layer
        self.max_dur = mp.max_dur

    # -- primitives --------------------------------------------------------

    def conv(self, x: str, p: Dict[str, Any], prefix: str, stride: int = 1,
             pad: int = 0, dilation: int = 1, groups: int = 1) -> str:
        b = self.b
        w = b.init(prefix + ".weight", _fused_weight(p))
        ins = [x, w]
        if "bias" in p:
            ins.append(b.init(prefix + ".bias", _np(p["bias"])))
        return b.add("Conv", ins, strides=[stride], pads=[pad, pad],
                     dilations=[dilation], group=groups)

    def conv_t(self, x: str, p: Dict[str, Any], prefix: str, stride: int,
               pad: int, outpad: int, groups: int = 1) -> str:
        b = self.b
        w = b.init(prefix + ".weight", _fused_weight(p))
        ins = [x, w]
        if "bias" in p:
            ins.append(b.init(prefix + ".bias", _np(p["bias"])))
        return b.add("ConvTranspose", ins, strides=[stride], pads=[pad, pad],
                     output_padding=[outpad], group=groups)

    def linear(self, x: str, p: Dict[str, Any], prefix: str) -> str:
        """x [1, D_in] -> [1, D_out] (Gemm, transB)."""
        b = self.b
        w = b.init(prefix + ".weight", _np(p["weight"]))
        ins = [x, w]
        if "bias" in p:
            ins.append(b.init(prefix + ".bias", _np(p["bias"])))
        return b.add("Gemm", ins, transB=1)

    def matmul_linear(self, x_ntc: str, p: Dict[str, Any], prefix: str) -> str:
        """x [1, T, D_in] -> [1, T, D_out] (MatMul with W^T)."""
        b = self.b
        w = b.init(prefix + ".weight_t", _np(p["weight"]).T.copy())
        y = b.add("MatMul", [x_ntc, w])
        if "bias" in p:
            y = b.add("Add", [y, b.init(prefix + ".bias", _np(p["bias"]))])
        return y

    def lstm(self, x_nct: str, p: Dict[str, Any], prefix: str) -> str:
        """Bidirectional LSTM, NCW in -> NCW out [1, 2H, T].

        Torch gate order (i,f,g,o) -> ONNX (i,o,f,c)."""
        b = self.b
        hidden = np.asarray(p["weight_hh_l0"]).shape[1]

        def reorder(w):
            w = np.asarray(w, np.float32)
            h = hidden
            return np.concatenate([w[0:h], w[3 * h:4 * h], w[h:2 * h],
                                   w[2 * h:3 * h]], axis=0)

        W = np.stack([reorder(p["weight_ih_l0"]),
                      reorder(p["weight_ih_l0_reverse"])])
        R = np.stack([reorder(p["weight_hh_l0"]),
                      reorder(p["weight_hh_l0_reverse"])])
        B = np.stack([
            np.concatenate([reorder(p["bias_ih_l0"]),
                            reorder(p["bias_hh_l0"])]),
            np.concatenate([reorder(p["bias_ih_l0_reverse"]),
                            reorder(p["bias_hh_l0_reverse"])]),
        ])
        x_tnc = b.transpose(x_nct, (2, 0, 1))  # [T, 1, C]
        y = b.add("LSTM", [x_tnc, b.init(prefix + ".W", W),
                           b.init(prefix + ".R", R), b.init(prefix + ".B", B)],
                  n_outputs=3, hidden_size=int(hidden),
                  direction="bidirectional")[0]  # Y [T, 2, 1, H]
        y = b.transpose(y, (2, 0, 1, 3))        # [1, T, 2, H]
        y = b.reshape(y, [1, -1, 2 * int(hidden)])  # [1, T, 2H]
        return b.transpose(y, (0, 2, 1))        # [1, 2H, T]

    def layer_norm_nct(self, x_nct: str, gamma, beta, prefix: str) -> str:
        b = self.b
        xt = b.transpose(x_nct, (0, 2, 1))
        y = b.add("LayerNormalization",
                  [xt, b.init(prefix + ".gamma", _np(gamma)),
                   b.init(prefix + ".beta", _np(beta))], epsilon=1e-5)
        return b.transpose(y, (0, 2, 1))

    def style_affine(self, p_fc: Dict[str, Any], prefix: str, c: int):
        """fc(style) -> (1+gamma) [1,C,1], beta [1,C,1]."""
        b = self.b
        h = self.linear(self.style, p_fc, prefix)  # [1, 2C]
        h = b.unsqueeze(h, [2])  # [1, 2C, 1]
        gamma = b.slice(h, [0], [c], [1])
        beta = b.slice(h, [c], [2 * c], [1])
        return b.add_const(gamma, 1.0), beta

    def adain(self, x_nct: str, p_adain: Dict[str, Any], prefix: str,
              c: int) -> str:
        """(1+gamma) * InstanceNorm(x) + beta."""
        b = self.b
        ones = b.const(np.ones(c, np.float32), "in_scale")
        zeros = b.const(np.zeros(c, np.float32), "in_bias")
        y = b.add("InstanceNormalization", [x_nct, ones, zeros], epsilon=1e-5)
        scale, beta = self.style_affine(p_adain["fc"], prefix + ".fc", c)
        return b.add("Add", [b.add("Mul", [y, scale]), beta])

    def ada_layer_norm(self, x_nct: str, p: Dict[str, Any], prefix: str,
                       c: int) -> str:
        b = self.b
        ones = b.const(np.ones(c, np.float32), "ln_scale")
        xt = b.transpose(x_nct, (0, 2, 1))
        y = b.add("LayerNormalization", [xt, ones], epsilon=1e-5)
        y = b.transpose(y, (0, 2, 1))
        scale, beta = self.style_affine(p["fc"], prefix + ".fc", c)
        return b.add("Add", [b.add("Mul", [y, scale]), beta])

    def lrelu(self, x: str) -> str:
        return self.b.add("LeakyRelu", [x], alpha=0.2)

    def snake(self, x: str, alpha, prefix: str) -> str:
        """x + (1/a) * sin(a*x)^2; alpha torch-shape (1, C, 1)."""
        b = self.b
        a = b.init(prefix + ".alpha", _np(alpha).reshape(1, -1, 1))
        inv = b.init(prefix + ".inv_alpha",
                     (1.0 / _np(alpha)).reshape(1, -1, 1).astype(np.float32))
        sn = b.add("Sin", [b.add("Mul", [x, a])])
        return b.add("Add", [x, b.add("Mul", [b.add("Mul", [sn, sn]), inv])])

    def adain_res_blk1d(self, x: str, p: Dict[str, Any], prefix: str,
                        dim_in: int, dim_out: int,
                        upsample: bool = False) -> str:
        """models.py:326-370 block (lrelu activations, /sqrt(2))."""
        b = self.b
        sc = x
        if upsample:
            sc = b.add("Resize", [sc, "", b.f32([1.0, 1.0, 2.0], "scales")],
                       mode="nearest",
                       coordinate_transformation_mode="asymmetric",
                       nearest_mode="floor")
        if "conv1x1" in p:
            sc = self.conv(sc, p["conv1x1"], prefix + ".conv1x1")
        h = self.adain(x, p["norm1"], prefix + ".norm1", dim_in)
        h = self.lrelu(h)
        if upsample:
            h = self.conv_t(h, p["pool"], prefix + ".pool", stride=2, pad=1,
                            outpad=1, groups=dim_in)
        h = self.conv(h, p["conv1"], prefix + ".conv1", pad=1)
        h = self.adain(h, p["norm2"], prefix + ".norm2", dim_out)
        h = self.lrelu(h)
        h = self.conv(h, p["conv2"], prefix + ".conv2", pad=1)
        y = b.add("Add", [h, sc])
        return b.mul_const(y, 1.0 / math.sqrt(2.0))

    def adain_res_block1(self, x: str, p: Dict[str, Any], prefix: str,
                         c: int, kernel: int, dilations) -> str:
        """Vocoder AdaINResBlock1 (snake activations; hifigan.py:26-80)."""
        b = self.b
        for i, d in enumerate(dilations):
            si = str(i)
            h = self.adain(x, p["adain1"][si], f"{prefix}.adain1.{si}", c)
            h = self.snake(h, p["alpha1"][si], f"{prefix}.alpha1.{si}")
            h = self.conv(h, p["convs1"][si], f"{prefix}.convs1.{si}",
                          pad=(kernel * d - d) // 2, dilation=d)
            h = self.adain(h, p["adain2"][si], f"{prefix}.adain2.{si}", c)
            h = self.snake(h, p["alpha2"][si], f"{prefix}.alpha2.{si}")
            h = self.conv(h, p["convs2"][si], f"{prefix}.convs2.{si}",
                          pad=(kernel - 1) // 2)
            x = b.add("Add", [h, x])
        return x

    # -- pipeline stages ---------------------------------------------------

    def text_encoder(self, tokens2d: str) -> str:
        """-> t_en [1, C, T]."""
        b = self.b
        p = self.p["text_encoder"]
        emb = b.init("text_encoder.embedding", _np(p["embedding"]["weight"]))
        x = b.add("Gather", [emb, tokens2d], axis=0)  # [1, T, C]
        x = b.transpose(x, (0, 2, 1))
        for i in range(len(p["cnn"])):
            blk = p["cnn"][str(i)]
            x = self.conv(x, blk["0"], f"text_encoder.cnn.{i}.0", pad=2)
            x = self.layer_norm_nct(x, blk["1"]["gamma"], blk["1"]["beta"],
                                    f"text_encoder.cnn.{i}.1")
            x = self.lrelu(x)
        return self.lstm(x, p["lstm"], "text_encoder.lstm")

    def duration_encoder(self, t_en: str, s_seq: str) -> str:
        """-> d [1, C+S, T]."""
        b = self.b
        lstms = self.p["predictor"]["text_encoder"]["lstms"]
        x = b.concat([t_en, s_seq], axis=1)
        for i in range(len(lstms)):
            blk = lstms[str(i)]
            pre = f"predictor.text_encoder.lstms.{i}"
            if i % 2 == 0:
                x = self.lstm(x, blk, pre)
            else:
                x = self.ada_layer_norm(x, blk, pre, self.hidden)
                x = b.concat([x, s_seq], axis=1)
        return x

    def duration_head(self, d: str, speed: str) -> str:
        """-> pred_dur [T] f32 (rounded, >= 1)."""
        b = self.b
        p = self.p["predictor"]
        x = self.lstm(d, p["lstm"], "predictor.lstm")  # [1, C, T]
        x = b.transpose(x, (0, 2, 1))  # [1, T, C]
        logits = self.matmul_linear(x, p["duration_proj"]["linear_layer"],
                                    "predictor.duration_proj")
        dur = b.add("ReduceSum", [b.add("Sigmoid", [logits]),
                                  b.i64([-1], "axes")], keepdims=0)  # [1, T]
        dur = b.squeeze(dur, [0])  # [T]

        # outlier clamp on dur[1:-2] (inference_onnx.py:187-200: torch .std()
        # is unbiased -> n-1 denominator)
        big = 1 << 62
        first = b.slice(dur, [0], [1], [0])
        mid = b.slice(dur, [1], [-2], [0])
        last = b.slice(dur, [-2], [big], [0])
        mean = b.add("ReduceMean", [mid], keepdims=0)
        diff = b.binop("Sub", mid, mean)
        n = b.cast(b.add("ReduceSum", [b.add("Shape", [mid])], keepdims=0),
                   P.FLOAT)
        var = b.binop("Div", b.add("ReduceSum",
                                   [b.binop("Mul", diff, diff)], keepdims=0),
                      b.add_const(n, -1.0))
        std = b.add("Sqrt", [var])
        z = b.binop("Div", diff, std)
        outlier = b.binop("Greater", b.add("Abs", [z]),
                          b.f32(np.float32(3.0), "thresh"))
        repl = b.binop("Add", mean,
                       b.binop("Mul", b.add("Sign", [diff]),
                               b.mul_const(std, 3.0 * 0.95)))
        mid = b.add("Where", [outlier, repl, mid])
        dur = b.concat([first, mid, last], axis=0)

        dur = b.binop("Div", dur, speed)
        dur = b.add("Round", [dur])
        return b.add("Clip", [dur, b.f32(np.float32(1.0), "one")])

    def alignment(self, pred_dur: str) -> str:
        """-> align [T, L] f32 (inference_onnx.py:156-176)."""
        b = self.b
        total = b.add("ReduceSum", [pred_dur], keepdims=0)  # scalar f32
        head = b.slice(pred_dur, [0], [-1], [0])
        prefix = b.concat([b.f32([0.0], "zero1"),
                           b.add("CumSum", [head, b.i64(0, "axis0")])], axis=0)
        pos = b.add("Range", [b.f32(np.float32(0.0), "zero"), total,
                              b.f32(np.float32(1.0), "one")])  # [L]
        pos = b.unsqueeze(pos, [0])          # [1, L]
        start = b.unsqueeze(prefix, [1])     # [T, 1]
        end = b.add("Min", [b.binop("Add", start,
                                    b.unsqueeze(pred_dur, [1])),
                            total])
        mask = b.add("And", [b.binop("GreaterOrEqual", pos, start),
                             b.binop("Less", pos, end)])
        return b.cast(mask, P.FLOAT)

    def f0n(self, en: str):
        """shared BiLSTM + F0/N stacks -> (F0 [1,1,2L], N [1,1,2L])."""
        p = self.p["predictor"]
        x = self.lstm(en, p["shared"], "predictor.shared")
        h = self.hidden
        outs = []
        for name in ("F0", "N"):
            y = self.adain_res_blk1d(x, p[name]["0"], f"predictor.{name}.0",
                                     h, h)
            y = self.adain_res_blk1d(y, p[name]["1"], f"predictor.{name}.1",
                                     h, h // 2, upsample=True)
            y = self.adain_res_blk1d(y, p[name]["2"], f"predictor.{name}.2",
                                     h // 2, h // 2)
            outs.append(self.conv(y, p[name + "_proj"],
                                  f"predictor.{name}_proj"))
        return outs[0], outs[1]

    def source(self, f0_mel: str, total_up: int, mel_len_vec: str) -> str:
        """NSF harmonic source: f0 [1,1,2L] at mel rate -> har [1,1,600L]
        (nn/decoder.py sine_gen, deterministic path)."""
        b = self.b
        f0_up = b.add("Resize",
                      [f0_mel, "", b.f32([1.0, 1.0, float(total_up)],
                                         "scales")],
                      mode="nearest",
                      coordinate_transformation_mode="asymmetric",
                      nearest_mode="floor")  # [1, 1, La]
        harm = b.const(np.arange(1, HARMONICS + 1,
                                 dtype=np.float32).reshape(1, -1, 1), "harm")
        fn = b.add("Mul", [f0_up, harm])  # [1, 9, La]
        rad = b.mul_const(fn, 1.0 / SR)
        rad = b.binop("Sub", rad, b.add("Floor", [rad]))  # % 1
        # downsample inst. freq (linear), cumsum phase, upsample back
        sizes = b.concat([b.i64([1], "one1"), b.i64([HARMONICS], "nine"),
                          mel_len_vec], axis=0)
        rad_d = b.add("Resize", [rad, "", "", sizes], mode="linear",
                      coordinate_transformation_mode="pytorch_half_pixel")
        phase = b.mul_const(
            b.add("CumSum", [rad_d, b.i64(2, "axis2")]), 2.0 * math.pi)
        la = b.add("Shape", [f0_up])
        la = b.slice(la, [2], [3], [0])
        sizes_up = b.concat([b.i64([1], "one1"), b.i64([HARMONICS], "nine"),
                             la], axis=0)
        phase = b.add("Resize", [b.mul_const(phase, float(total_up)), "", "",
                                 sizes_up], mode="linear",
                      coordinate_transformation_mode="pytorch_half_pixel")
        sines = b.add("Sin", [phase])
        uv = b.cast(b.binop("Greater", f0_up,
                            b.f32(np.float32(10.0), "vthresh")), P.FLOAT)
        sine_waves = b.add("Mul", [b.mul_const(sines, 0.1), uv])
        # l_linear merge (harmonics -> 1) as a 1x1 conv + tanh
        lp = self.p["decoder"]["generator"]["m_source"]["l_linear"]
        w = b.init("decoder.generator.m_source.l_linear.weight",
                   _np(lp["weight"]).reshape(1, HARMONICS, 1))
        bias = b.init("decoder.generator.m_source.l_linear.bias",
                      _np(lp["bias"]))
        har = b.add("Conv", [sine_waves, w, bias])
        return b.add("Tanh", [har])

    def hifigan(self, x: str, f0_mel: str, mel_len_vec: str) -> str:
        """HiFi-GAN generator (nn/decoder.py) -> wav [1, 1, Lw]."""
        b = self.b
        g = self.p["decoder"]["generator"]
        cfg = self.cfg.model_params.decoder
        rates = list(cfg.upsample_rates)
        kernels = list(cfg.upsample_kernel_sizes)
        n_up = len(rates)
        total_up = int(np.prod(rates))
        har = self.source(f0_mel, total_up, mel_len_vec)
        c = cfg.upsample_initial_channel
        n_kernels = len(cfg.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(rates, kernels)):
            c_out = c // 2
            x = self.snake(x, g["alphas"][str(i)],
                           f"decoder.generator.alphas.{i}")
            if i + 1 < n_up:
                stride_f0 = int(np.prod(rates[i + 1:]))
                xs = self.conv(har, g["noise_convs"][str(i)],
                               f"decoder.generator.noise_convs.{i}",
                               stride=stride_f0, pad=(stride_f0 + 1) // 2)
            else:
                xs = self.conv(har, g["noise_convs"][str(i)],
                               f"decoder.generator.noise_convs.{i}")
            xs = self.adain_res_block1(
                xs, g["noise_res"][str(i)], f"decoder.generator.noise_res.{i}",
                c_out, 7 if i + 1 < n_up else 11, (1, 3, 5))
            x = self.conv_t(x, g["ups"][str(i)], f"decoder.generator.ups.{i}",
                            stride=u, pad=u // 2 + u % 2, outpad=u % 2)
            x = b.add("Add", [x, xs])
            acc = None
            for j in range(n_kernels):
                r = self.adain_res_block1(
                    x, g["resblocks"][str(i * n_kernels + j)],
                    f"decoder.generator.resblocks.{i * n_kernels + j}",
                    c_out, cfg.resblock_kernel_sizes[j],
                    tuple(cfg.resblock_dilation_sizes[j]))
                acc = r if acc is None else b.add("Add", [acc, r])
            x = b.mul_const(acc, 1.0 / n_kernels)
            c = c_out
        x = self.snake(x, g["alphas"][str(n_up)],
                       f"decoder.generator.alphas.{n_up}")
        x = self.conv(x, g["conv_post"], "decoder.generator.conv_post", pad=3)
        return b.add("Tanh", [x])

    def istftnet(self, x: str, f0_mel: str, mel_len_vec: str) -> str:
        """iSTFTNet generator (nn/istftnet.py): 2-stage upsampling,
        STFT-domain harmonic source, matmul-DFT iSTFT head — the DFT/iDFT
        bases become Conv/ConvTranspose weights with stride=hop."""
        b = self.b
        g = self.p["decoder"]["generator"]
        cfg = self.cfg.model_params.decoder
        rates = list(cfg.upsample_rates)
        kernels = list(cfg.upsample_kernel_sizes)
        n_up = len(rates)
        nk = len(cfg.resblock_kernel_sizes)
        n_fft, hop = cfg.gen_istft_n_fft, cfg.gen_istft_hop_size
        bins = n_fft // 2 + 1
        total_up = int(np.prod(rates)) * hop

        # harmonic source at sample rate -> STFT (replicate center pad;
        # the strided DFT-basis conv IS the framing+matmul)
        har_wav = self.source(f0_mel, total_up, mel_len_vec)  # [1, 1, La]
        har_pad = b.add("Pad", [har_wav,
                                b.i64([0, 0, n_fft // 2, 0, 0, n_fft // 2],
                                      "stft_pads")], mode="edge")
        cos_b, sin_b = _dft_bases(n_fft, n_fft, center_window=False)
        w_cos = b.init("stft.cos", cos_b.T.reshape(bins, 1, n_fft).copy())
        w_sin = b.init("stft.sin", sin_b.T.reshape(bins, 1, n_fft).copy())
        re = b.add("Conv", [har_pad, w_cos], strides=[hop])
        im = b.add("Conv", [har_pad, w_sin], strides=[hop])
        mag = b.add("Sqrt", [b.add_const(
            b.binop("Add", b.binop("Mul", re, re), b.binop("Mul", im, im)),
            1e-14)])
        # atan2(im, re) with the repo's branch-cut snapping
        # (ops/stft.py stft_mag_phase): near-axis -> exact 0/pi, silent -> 0
        base = b.add("Atan", [b.binop("Div", im, re)])
        neg_re = b.binop("Less", re, b.f32(np.float32(0.0), "zero"))
        corr = b.binop("Mul", b.cast(neg_re, P.FLOAT),
                       b.mul_const(b.add("Sign", [im]), math.pi))
        phase = b.binop("Add", base, corr)
        near = b.binop("LessOrEqual", b.add("Abs", [im]),
                       b.mul_const(mag, 1e-3))
        pi_c = b.f32(np.float32(math.pi), "pi")
        zero_c = b.f32(np.float32(0.0), "zero")
        phase = b.add("Where", [b.add("And", [near, neg_re]), pi_c, phase])
        pos_re = b.binop("GreaterOrEqual", re, zero_c)
        phase = b.add("Where", [b.add("And", [near, pos_re]), zero_c, phase])
        phase = b.add("Where", [b.binop("Less", mag,
                                        b.f32(np.float32(1e-5), "tiny")),
                                zero_c, phase])
        har = b.concat([mag, phase], axis=1)  # [1, n_fft+2, Tf]

        c = cfg.upsample_initial_channel
        for i, (u, k) in enumerate(zip(rates, kernels)):
            last = (i == n_up - 1)
            c_out = c // 2
            x = b.add("LeakyRelu", [x], alpha=0.1)
            if not last:
                stride_f0 = int(np.prod(rates[i + 1:]))
                xs = self.conv(har, g["noise_convs"][str(i)],
                               f"decoder.generator.noise_convs.{i}",
                               stride=stride_f0, pad=(stride_f0 + 1) // 2)
            else:
                xs = self.conv(har, g["noise_convs"][str(i)],
                               f"decoder.generator.noise_convs.{i}")
            x = self.conv_t(x, g["ups"][str(i)],
                            f"decoder.generator.ups.{i}", stride=u,
                            pad=(k - u) // 2, outpad=0)
            if last:
                # ReflectionPad1d((1, 0)) (reference istftnet.py:538,559)
                x = b.concat([b.slice(x, [1], [2], [2]), x], axis=2)
            xs = self.adain_res_block1(
                xs, g["noise_res"][str(i)],
                f"decoder.generator.noise_res.{i}", c_out,
                7 if not last else 11, (1, 3, 5))
            x = b.add("Add", [x, xs])
            acc = None
            for j in range(nk):
                r = self.adain_res_block1(
                    x, g["resblocks"][str(i * nk + j)],
                    f"decoder.generator.resblocks.{i * nk + j}",
                    c_out, cfg.resblock_kernel_sizes[j],
                    tuple(cfg.resblock_dilation_sizes[j]))
                acc = r if acc is None else b.add("Add", [acc, r])
            x = b.mul_const(acc, 1.0 / nk)
            c = c_out
        x = b.add("LeakyRelu", [x], alpha=0.01)
        x = self.conv(x, g["conv_post"], "decoder.generator.conv_post",
                      pad=3)  # [1, n_fft+2, Tf']
        spec = b.add("Exp", [b.slice(x, [0], [bins], [1])])
        ph = b.add("Sin", [b.slice(x, [bins], [2 * bins], [1])])
        real = b.binop("Mul", spec, b.add("Cos", [ph]))
        imag = b.binop("Mul", spec, b.add("Sin", [ph]))
        icos, isin = _idft_bases(n_fft, n_fft, scale=True,
                                 center_window=False)
        wi_cos = b.init("istft.cos", np.ascontiguousarray(
            icos.reshape(bins, 1, n_fft)))
        wi_sin = b.init("istft.sin", np.ascontiguousarray(
            isin.reshape(bins, 1, n_fft)))
        # overlap-add == stride-hop ConvTranspose with the iDFT bases
        wav_r = b.add("ConvTranspose", [real, wi_cos], strides=[hop])
        wav_i = b.add("ConvTranspose", [imag, wi_sin], strides=[hop])
        wav = b.binop("Sub", wav_r, wav_i)
        return b.slice(wav, [n_fft // 2], [-(n_fft // 2)], [2])

    def vocos(self, x: str) -> str:
        """Vocos generator (nn/vocos.py; reference Modules/vocos.py:
        27-69, 108-162, 190-296): ConvNeXt stack at constant mel-rate
        resolution + iSTFT head with window-envelope division. The irfft
        symmetry (bins 1..N-1 doubled) and the hann window fold into the
        ConvTranspose iDFT bases; the window envelope is the same
        stride-hop ConvTranspose applied to ones with a w^2 kernel.
        Beyond the reference: its ONNX stack exports only hifigan/istftnet
        (inference_onnx.py:130)."""
        b = self.b
        g = self.p["decoder"]["generator"]
        cfg = self.cfg.model_params.decoder
        n_fft, hop = cfg.gen_istft_n_fft, cfg.gen_istft_hop_size
        bins = n_fft // 2 + 1
        dim = 512  # the decoder shell's fixed output width
                   # (VocosGenerator's dim, nn/vocos.py)

        for i in range(cfg.num_layers):
            blk = g["convnext"][str(i)]
            pre = f"decoder.generator.convnext.{i}"
            h = self.conv(x, blk["dwconv"], pre + ".dwconv", pad=3,
                          groups=dim)
            h = self.adain(h, blk["norm"], pre + ".norm", dim)
            ht = b.transpose(h, (0, 2, 1))  # [1, T, C]
            ht = self.matmul_linear(ht, blk["pwconv1"], pre + ".pwconv1")
            # exact GELU (jax.nn.gelu approximate=False; torch default):
            # 0.5 * x * (1 + erf(x / sqrt(2)))
            erf = b.add("Erf", [b.mul_const(ht, 1.0 / math.sqrt(2.0))])
            ht = b.binop("Mul", ht,
                         b.mul_const(b.add_const(erf, 1.0), 0.5))
            ht = self.matmul_linear(ht, blk["pwconv2"], pre + ".pwconv2")
            ht = b.binop("Mul", ht, b.init(pre + ".gamma",
                                           _np(blk["gamma"])))
            x = b.add("Add", [x, b.transpose(ht, (0, 2, 1))])

        fl = g["final_layer_norm"]
        xt = b.transpose(x, (0, 2, 1))
        xt = b.add("LayerNormalization",
                   [xt,
                    b.init("decoder.generator.final_ln.gamma",
                           _np(fl["weight"])),
                    b.init("decoder.generator.final_ln.beta",
                           _np(fl["bias"]))],
                   epsilon=1e-6)
        h = self.matmul_linear(xt, g["stft"]["out"],
                               "decoder.generator.stft.out")  # [1,T,nfft+2]
        mag = b.slice(h, [0], [bins], [2])
        ph = b.slice(h, [bins], [2 * bins], [2])
        mag = b.add("Clip", [b.add("Exp", [mag]), "",
                             b.f32(np.float32(1e2), "mag_max")])
        real = b.transpose(b.binop("Mul", mag, b.add("Cos", [ph])),
                           (0, 2, 1))  # [1, bins, T]
        imag = b.transpose(b.binop("Mul", mag, b.add("Sin", [ph])),
                           (0, 2, 1))
        icos, isin = _idft_bases(n_fft, n_fft, scale=True,
                                 center_window=False)
        kk = np.arange(bins)[:, None]
        if n_fft % 2 == 0:
            freq_scale = np.where((kk > 0) & (kk < bins - 1), 2.0, 1.0)
        else:
            freq_scale = np.where(kk > 0, 2.0, 1.0)
        freq_scale = freq_scale.astype(np.float32)
        wi_cos = b.init("vocos_istft.cos", np.ascontiguousarray(
            (icos * freq_scale).reshape(bins, 1, n_fft)))
        wi_sin = b.init("vocos_istft.sin", np.ascontiguousarray(
            (isin * freq_scale).reshape(bins, 1, n_fft)))
        wav = b.binop("Sub",
                      b.add("ConvTranspose", [real, wi_cos], strides=[hop]),
                      b.add("ConvTranspose", [imag, wi_sin], strides=[hop]))
        # window envelope: OLA of w^2 over the same frame grid
        w = hann_window(n_fft)
        t_vec = b.slice(b.add("Shape", [real]), [2], [3], [0])
        ones_shape = b.concat([b.i64([1], "one1"), b.i64([1], "one1"),
                               t_vec], axis=0)
        ones = b.add("Expand", [b.f32(np.ones((1, 1, 1), np.float32),
                                      "onef"), ones_shape])
        env = b.add("ConvTranspose",
                    [ones, b.init("vocos_istft.env_kernel",
                                  (w * w).reshape(1, 1, n_fft))],
                    strides=[hop])
        wav = b.binop("Div", wav,
                      b.add("Max", [env, b.f32(np.float32(1e-11),
                                               "env_eps")]))
        pad = (n_fft - hop) // 2
        return b.slice(wav, [pad], [-pad], [2]) if pad > 0 else wav

    def decoder(self, asr: str, f0_2l: str, n_2l: str,
                mel_len_vec: str) -> str:
        """Decoder shell (nn/decoder.py Decoder) -> wav [1, 1, Lw]."""
        b = self.b
        p = self.p["decoder"]
        f0 = self.conv(f0_2l, p["F0_conv"], "decoder.F0_conv", stride=2,
                       pad=1)
        nn_ = self.conv(n_2l, p["N_conv"], "decoder.N_conv", stride=2, pad=1)
        x = b.concat([asr, f0, nn_], axis=1)
        x = self.adain_res_blk1d(x, p["encode"], "decoder.encode",
                                 self.hidden + 2, 1024)
        asr_res = self.conv(asr, p["asr_res"]["0"], "decoder.asr_res.0")
        res = True
        for i in range(4):
            if res:
                x = b.concat([x, asr_res, f0, nn_], axis=1)
            up = (i == 3)
            x = self.adain_res_blk1d(x, p["decode"][str(i)],
                                     f"decoder.decode.{i}",
                                     1024 + 2 + 64, 512 if up else 1024,
                                     upsample=up)
            if up:
                res = False
        dec_type = self.cfg.model_params.decoder.type
        if dec_type == "istftnet":
            return self.istftnet(x, f0_2l, mel_len_vec)
        if dec_type == "vocos":
            return self.vocos(x)
        return self.hifigan(x, f0_2l, mel_len_vec)

    # -- whole model -------------------------------------------------------

    def export(self) -> bytes:
        b = self.b
        cfg = self.cfg
        if cfg.model_params.decoder.type not in ("hifigan", "istftnet",
                                                 "vocos"):
            raise NotImplementedError(
                f"unknown decoder type {cfg.model_params.decoder.type!r}")
        b.add_input("tokens", P.INT64, ["num_token"])
        b.add_input("style", P.FLOAT, [1, self.style_dim])
        b.add_input("speed", P.FLOAT, [])
        self.style = "style"

        tokens2d = b.unsqueeze("tokens", [0])
        t_en = self.text_encoder(tokens2d)  # [1, C, T]

        # style broadcast along T: [1,S,1] expanded by [1,1,T]
        t_vec = b.add("Shape", ["tokens"])  # [1] == [T]
        s_col = b.unsqueeze("style", [2])
        shape_1_1_t = b.concat([b.i64([1], "one1"), b.i64([1], "one1"),
                                t_vec], axis=0)
        s_seq = b.add("Expand", [s_col, shape_1_1_t])  # [1, S, T]

        d = self.duration_encoder(t_en, s_seq)          # [1, C+S, T]
        pred_dur = self.duration_head(d, "speed")       # [T]
        align = self.alignment(pred_dur)                # [T, L]

        en = b.add("MatMul", [d, align])                # [1, C+S, L]
        asr = b.add("MatMul", [t_en, align])            # [1, C,   L]
        f0_2l, n_2l = self.f0n(en)                      # [1, 1, 2L]

        mel_len = b.add("Shape", [f0_2l])
        mel_len_vec = b.slice(mel_len, [2], [3], [0])   # [1] == [2L]

        wav = self.decoder(asr, f0_2l, n_2l, mel_len_vec)
        wav = b.squeeze(wav, [0, 1])
        big = 1 << 62
        wav = b.slice(wav, [4000], [-4000], [0])  # reference trim
        b.add("Identity", [wav], outputs=["output_wav"])
        b.add_output("output_wav", P.FLOAT, ["wav_length"])
        return b.build(opset=19)


def export_onnx(params: Dict[str, Any], cfg,
                path: Optional[str] = None) -> bytes:
    """Serialize the synthesis graph for `params` (an INFERENCE param tree:
    text_encoder/predictor/decoder, weight-norm fused or raw) + config.

    Returns the ModelProto bytes; writes to `path` when given."""
    data = _Exporter(params, cfg).export()
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


EXPORTED_MODULES = ("text_encoder", "predictor", "decoder")


def export_modules(modules, cfg, path: Optional[str] = None) -> bytes:
    """export_onnx of the port's modules: `modules` is an infer.StyleTTS2
    (its `.modules`) or a mapping holding the text encoder, predictor and
    decoder nn.Modules, on any device, weight norm fused (inference) or
    split (a training build). Returns the ModelProto bytes; writes to
    `path` when given."""
    mods = modules if hasattr(modules, "items") else modules.modules
    tree = {k: W.module_tree(mods[k]) for k in EXPORTED_MODULES}
    return export_onnx(tree, cfg, path)
