"""The weight tree of StyleTTS2-lite's four inference modules: its layout
(the reference checkpoint's torch module paths, weight norm as
`weight_g` / `weight_v` pairs) and its seeded random values.

`spec(model_params)` lists every leaf with its shape and distribution;
`make_weights(spec, seed, device)` draws all of them from one generator in
two calls (every uniform, then every normal) on `device`. Distributions:
U(+-1/sqrt(fan_in)) for conv and linear weights and biases (fan_in from
the weight's dims 1 and up, so a transposed conv's (in, out/g, k) weight
counts out/g * k), U(+-1/sqrt(H)) for LSTMs, N(0, 1) embeddings, a
xavier-uniform duration projection with a zero bias; a weight-norm gain
is the norm of its direction times U(0.9, 1.1) per channel, so the fused
weight differs from `weight_v`; Snake alphas U(0.5, 1.5), norm gains
U(0.9, 1.1) and shifts U(-0.1, 0.1), Vocos layer scales U(0.5, 1.5) / n.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# leaf -> (kind, shape, arg): "u" U(-arg, arg); "r" U(arg[0], arg[1]);
# "n" N(0, 1); "z" zeros; "g" the gain of the weight-norm pair whose
# direction is leaf `arg`
Spec = Dict[str, Tuple[str, Tuple[int, ...], Any]]


def _uniform(sp: Spec, key: str, shape, bound: float) -> None:
    sp[key] = ("u", tuple(shape), bound)


def _conv(sp: Spec, key: str, shape, bias: bool = True,
          wn: bool = False, n_bias: int = 0) -> None:
    """A conv (or linear) weight of `shape`; its bias has `n_bias` entries
    (default shape[0]; a transposed conv's are its output channels)."""
    bound = 1.0 / math.sqrt(int(np.prod(shape[1:])))
    if wn:
        _uniform(sp, f"{key}.weight_v", shape, bound)
        sp[f"{key}.weight_g"] = ("g", (shape[0],) + (1,) * (len(shape) - 1),
                                 f"{key}.weight_v")
    else:
        _uniform(sp, f"{key}.weight", shape, bound)
    if bias:
        _uniform(sp, f"{key}.bias", (n_bias or shape[0],), bound)


def _linear(sp: Spec, key: str, n_out: int, n_in: int) -> None:
    _conv(sp, key, (n_out, n_in))


def _lstm(sp: Spec, key: str, n_in: int, hidden: int) -> None:
    bound = 1.0 / math.sqrt(hidden)
    for sfx in ("", "_reverse"):
        _uniform(sp, f"{key}.weight_ih_l0{sfx}", (4 * hidden, n_in), bound)
        _uniform(sp, f"{key}.weight_hh_l0{sfx}", (4 * hidden, hidden), bound)
        _uniform(sp, f"{key}.bias_ih_l0{sfx}", (4 * hidden,), bound)
        _uniform(sp, f"{key}.bias_hh_l0{sfx}", (4 * hidden,), bound)


def _adain_resblk1d(sp: Spec, key: str, c_in: int, c_out: int,
                    style: int, upsample: bool = False) -> None:
    _conv(sp, f"{key}.conv1", (c_out, c_in, 3), wn=True)
    _conv(sp, f"{key}.conv2", (c_out, c_out, 3), wn=True)
    _linear(sp, f"{key}.norm1.fc", 2 * c_in, style)
    _linear(sp, f"{key}.norm2.fc", 2 * c_out, style)
    if c_in != c_out:
        _conv(sp, f"{key}.conv1x1", (c_out, c_in, 1), bias=False, wn=True)
    if upsample:
        _conv(sp, f"{key}.pool", (c_in, 1, 3), wn=True)


def _adain_resblock1(sp: Spec, key: str, c: int, k: int, dils,
                     style: int) -> None:
    for i in range(len(dils)):
        _conv(sp, f"{key}.convs1.{i}", (c, c, k), wn=True)
        _conv(sp, f"{key}.convs2.{i}", (c, c, k), wn=True)
        _linear(sp, f"{key}.adain1.{i}.fc", 2 * c, style)
        _linear(sp, f"{key}.adain2.{i}.fc", 2 * c, style)
        sp[f"{key}.alpha1.{i}"] = ("r", (1, c, 1), (0.5, 1.5))
        sp[f"{key}.alpha2.{i}"] = ("r", (1, c, 1), (0.5, 1.5))


def _norm(sp: Spec, key: str, c: int, names=("gamma", "beta")) -> None:
    sp[f"{key}.{names[0]}"] = ("r", (c,), (0.9, 1.1))
    sp[f"{key}.{names[1]}"] = ("r", (c,), (-0.1, 0.1))


def spec(mp: Mapping[str, Any], n_token: int) -> Dict[str, Spec]:
    """{module: {dotted key: (kind, shape, arg)}} for the text encoder,
    style encoder, predictor and decoder of `model_params` (a config's
    dict) with `n_token` symbols."""
    style, hid, dim_in = mp["style_dim"], mp["hidden_dim"], mp["dim_in"]
    dec = mp["decoder"]

    te: Spec = {"embedding.weight": ("n", (n_token, hid), None)}
    for i in range(mp["n_layer"]):
        _conv(te, f"cnn.{i}.0", (hid, hid, 5), wn=True)
        _norm(te, f"cnn.{i}.1", hid)
    _lstm(te, "lstm", hid, hid // 2)

    se: Spec = {}
    _conv(se, "shared.0", (dim_in, 1, 3, 3))
    d = dim_in
    for i in range(4):
        d_out = min(2 * d, mp["max_conv_dim"])
        k = f"shared.{1 + i}"
        _conv(se, f"{k}.conv1", (d, d, 3, 3))
        _conv(se, f"{k}.conv2", (d_out, d, 3, 3))
        _conv(se, f"{k}.downsample_res.conv", (d, 1, 3, 3))
        if d != d_out:
            _conv(se, f"{k}.conv1x1", (d_out, d, 1, 1), bias=False)
        d = d_out
    _conv(se, "shared.6", (d, d, 5, 5))
    _linear(se, "unshared", style, mp["max_conv_dim"])

    pr: Spec = {}
    for i in range(mp["n_layer"]):
        _lstm(pr, f"text_encoder.lstms.{2 * i}", hid + style, hid // 2)
        _linear(pr, f"text_encoder.lstms.{2 * i + 1}.fc", 2 * hid, style)
    _lstm(pr, "lstm", hid + style, hid // 2)
    max_dur = mp["max_dur"]
    pr["duration_proj.linear_layer.weight"] = (
        "u", (max_dur, hid), math.sqrt(6.0 / (hid + max_dur)))
    pr["duration_proj.linear_layer.bias"] = ("z", (max_dur,), None)
    _lstm(pr, "shared", hid + style, hid // 2)
    for head in ("F0", "N"):
        _adain_resblk1d(pr, f"{head}.0", hid, hid, style)
        _adain_resblk1d(pr, f"{head}.1", hid, hid // 2, style, upsample=True)
        _adain_resblk1d(pr, f"{head}.2", hid // 2, hid // 2, style)
        _conv(pr, f"{head}_proj", (1, hid // 2, 1))

    de: Spec = {}
    _adain_resblk1d(de, "encode", hid + 2, 1024, style)
    for i in range(4):
        _adain_resblk1d(de, f"decode.{i}", 1024 + 2 + 64,
                        512 if i == 3 else 1024, style, upsample=i == 3)
    _conv(de, "F0_conv", (1, 1, 3), wn=True)
    _conv(de, "N_conv", (1, 1, 3), wn=True)
    _conv(de, "asr_res.0", (64, hid, 1), wn=True)
    g = "generator"
    if dec["type"] == "hifigan":
        rates, kups = dec["upsample_rates"], dec["upsample_kernel_sizes"]
        c0 = dec["upsample_initial_channel"]
        _linear(de, f"{g}.m_source.l_linear", 1, 9)
        de[f"{g}.alphas.0"] = ("r", (1, c0, 1), (0.5, 1.5))
        n_k = len(dec["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(rates, kups)):
            c_in, c = c0 // 2 ** i, c0 // 2 ** (i + 1)
            _conv(de, f"{g}.ups.{i}", (c_in, c, k), wn=True, n_bias=c)
            if i + 1 < len(rates):
                sf0 = int(np.prod(rates[i + 1:]))
                _conv(de, f"{g}.noise_convs.{i}", (c, 1, 2 * sf0))
                _adain_resblock1(de, f"{g}.noise_res.{i}", c, 7, (1, 3, 5),
                                 style)
            else:
                _conv(de, f"{g}.noise_convs.{i}", (c, 1, 1))
                _adain_resblock1(de, f"{g}.noise_res.{i}", c, 11, (1, 3, 5),
                                 style)
            for j, (rk, rd) in enumerate(zip(dec["resblock_kernel_sizes"],
                                             dec["resblock_dilation_sizes"])):
                _adain_resblock1(de, f"{g}.resblocks.{i * n_k + j}", c, rk,
                                 rd, style)
            de[f"{g}.alphas.{i + 1}"] = ("r", (1, c, 1), (0.5, 1.5))
        _conv(de, f"{g}.conv_post", (1, c, 7), wn=True)
    elif dec["type"] == "vocos":
        n = dec["num_layers"]
        for i in range(n):
            k = f"{g}.convnext.{i}"
            _conv(de, f"{k}.dwconv", (512, 1, 7))
            _linear(de, f"{k}.norm.fc", 2 * 512, style)
            _linear(de, f"{k}.pwconv1", dec["intermediate_dim"], 512)
            _linear(de, f"{k}.pwconv2", 512, dec["intermediate_dim"])
            de[f"{k}.gamma"] = ("r", (512,), (0.5 / n, 1.5 / n))
        _norm(de, f"{g}.final_layer_norm", 512, ("weight", "bias"))
        _linear(de, f"{g}.stft.out", dec["gen_istft_n_fft"] + 2, 512)
    else:
        raise ValueError(f"reference: no decoder of type {dec['type']!r}")
    return {"text_encoder": te, "style_encoder": se, "predictor": pr,
            "decoder": de}


def make_weights(sp: Dict[str, Spec], seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every leaf of `sp`, f32 on `device`, from one torch.Generator on that
    device seeded with `seed`: one draw of every uniform and one of every
    normal, then scaled per leaf."""
    device = torch.device(device)
    leaves = [(m, k, v) for m, s in sp.items() for k, v in s.items()]
    n_u = sum(int(np.prod(sh)) for _, _, (kind, sh, _) in leaves
              if kind in ("u", "r", "g"))
    n_n = sum(int(np.prod(sh)) for _, _, (kind, sh, _) in leaves
              if kind == "n")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    uni = torch.rand(n_u, generator=gen, device=device)
    nor = torch.randn(n_n, generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in sp}
    pu = pn = 0
    for m, key, (kind, shape, arg) in leaves:
        n = int(np.prod(shape))
        if kind == "n":
            val = nor[pn: pn + n].view(shape)
            pn += n
        elif kind == "z":
            val = torch.zeros(shape, device=device)
        else:
            u = uni[pu: pu + n].view(shape)
            pu += n
            if kind == "u":
                val = (2.0 * u - 1.0) * arg
            elif kind == "r":
                val = arg[0] + (arg[1] - arg[0]) * u
            else:  # "g": the direction's norm over dims 1.., jittered
                v = out[m][arg]
                norm = torch.sqrt((v * v).sum(dim=tuple(range(1, v.dim())),
                                              keepdim=True))
                val = norm * (0.9 + 0.2 * u)
        out[m][key] = val
    return out


def host_tree(weights: Mapping[str, Mapping[str, torch.Tensor]]
              ) -> Dict[str, Dict[str, Any]]:
    """The weights as the nested {module: {name: ... numpy array}} tree a
    checkpoint holds, in one device-to-host copy."""
    flat = [(m, k, t) for m, d in weights.items() for k, t in d.items()]
    host = torch.cat([t.reshape(-1) for _, _, t in flat]).cpu().numpy()
    tree: Dict[str, Dict[str, Any]] = {m: {} for m in weights}
    pos = 0
    for m, key, t in flat:
        n = t.numel()
        node = tree[m]
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = host[pos: pos + n].reshape(tuple(t.shape))
        pos += n
    return tree


def to_device(tree: Mapping[str, Any], device
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A nested {module: ...} tree of arrays -> {module: {dotted key: f32
    tensor on device}}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def rec(node, prefix, flat):
        for k, v in node.items():
            if isinstance(v, Mapping):
                rec(v, prefix + [k], flat)
            else:
                flat[".".join(prefix + [k])] = torch.as_tensor(
                    np.asarray(v, np.float32)).to(device)

    for m, node in tree.items():
        out[m] = {}
        rec(node, [], out[m])
    return out
