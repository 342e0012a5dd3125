"""The yardstick: the card's peaks, the least time a piece of work needs
on it, kernel B1's launch shapes and bound, and the model's FLOPs.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates): bf16 on the tensor cores, float32 FMA on the CUDA cores (the
port's float32 parts run with TF32 off), and HBM3 bandwidth. A bound is
max(operations / peak, bytes / bandwidth): each input byte read once and
each output byte written once.

FLOPs are counted from the configuration per valid token and per valid
frame (matmuls and convolutions, two per multiply-add; elementwise work
left out), whatever implements them, so a count reads the same work on
every version of the program: float32 parts against PEAK_F32, the bf16
decoder (the shell and the generator) against PEAK_BF16.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12


def bound_ms(flops: float, nbytes: float, peak: float) -> float:
    """The least milliseconds `flops` operations moving `nbytes` take."""
    return max(flops / peak, nbytes / HBM_BYTES_S) * 1e3


def b1_bound(b: int, t: int, c: int, k: int, itemsize: int,
             residual: bool, peak: float = PEAK_BF16) -> float:
    """Kernel B1 (AdaIN affine + Snake + mask + conv, optional residual):
    2 b t c^2 k operations; x and out (and the residual) of b t c items
    each, the (k, c, c) weights once. Milliseconds."""
    flops = 2.0 * b * t * c * c * k
    nbytes = b * t * c * itemsize * (2 + int(residual)) + k * c * c * itemsize
    return bound_ms(flops, nbytes, peak)


def b1_launches(dec: Mapping, frames: int
                ) -> Iterator[Tuple[int, int, int, bool]]:
    """(c, t, k, residual) of every B1 launch of one phase-2 row of
    `frames` asr frames (2 * frames mel frames): per HiFi-GAN stage, the
    noise block (k 7, k 11 at the last stage) and the resblocks, two
    launches per dilation, the second adding the residual (the bf16
    path). Vocos runs none."""
    if dec["type"] != "hifigan":
        return
    rates = dec["upsample_rates"]
    for i in range(len(rates)):
        last = i + 1 == len(rates)
        c = dec["upsample_initial_channel"] // 2 ** (i + 1)
        t = 2 * frames * int(np.prod(rates[: i + 1]))
        blocks = [(11 if last else 7, (1, 3, 5))]
        blocks += list(zip(dec["resblock_kernel_sizes"],
                           dec["resblock_dilation_sizes"]))
        for k, dils in blocks:
            for _ in dils:
                yield c, t, k, False
                yield c, t, k, True


def b1_bound_rows(dec: Mapping, row_frames: List[int], n_calls: int) -> float:
    """The least milliseconds of B1's launches for phase-2 rows of these
    valid frames, spread over `n_calls` calls of every launch shape: per
    shape, the rows' operations and activation bytes together and the
    weights once per call (a bound no sum of per-launch bounds is under)."""
    shapes: Dict[Tuple[int, int, bool, int], List[float]] = {}
    for f in row_frames:
        for idx, (c, t, k, res) in enumerate(b1_launches(dec, f)):
            acc = shapes.setdefault((idx, c, k, res), [0.0, 0.0])
            acc[0] += 2.0 * t * c * c * k
            acc[1] += t * c * 2 * (2 + int(res))
    return sum(bound_ms(fl, by + n_calls * k * c * c * 2, PEAK_BF16)
               for (_, c, k, res), (fl, by) in shapes.items())


def _lstm(n_in: int, hidden: int) -> float:
    """Per step, both directions."""
    return 2 * 2.0 * 4 * hidden * (n_in + hidden)


def _resblk1d(c_in: int, c_out: int, upsample: bool) -> float:
    """AdainResBlk1d: FLOPs per frame at its output rate."""
    at_out = 2.0 * 3 * c_in * c_out + 2.0 * 3 * c_out * c_out
    if c_in != c_out:
        at_out += 2.0 * c_in * c_out
    if upsample:
        at_out += 2.0 * 3 * c_in  # the depthwise transposed conv
    return at_out


def flops(mp: Mapping, tokens: int, frames: int) -> Tuple[float, float]:
    """(float32 FLOPs, bf16 FLOPs) of one utterance of `tokens` tokens and
    `frames` asr frames."""
    hid, style = mp["hidden_dim"], mp["style_dim"]
    dec = mp["decoder"]
    n = mp["n_layer"]
    f32 = 0.0
    # phase 1, per token: text encoder convs and BiLSTM, the duration
    # encoder's BiLSTMs, the duration head's BiLSTM and projection
    f32 += tokens * (n * 2.0 * 5 * hid * hid + _lstm(hid, hid // 2))
    f32 += tokens * (n + 1) * _lstm(hid + style, hid // 2)
    f32 += tokens * 2.0 * hid * mp["max_dur"]
    # phase 2 prosody, per frame: the shared BiLSTM, then per head F0 / N
    # blocks at F, 2F, 2F and the projection at 2F
    f32 += frames * _lstm(hid + style, hid // 2)
    head = (_resblk1d(hid, hid, False)
            + 2 * _resblk1d(hid, hid // 2, True)
            + 2 * _resblk1d(hid // 2, hid // 2, False)
            + 2 * 2.0 * (hid // 2))
    f32 += frames * 2 * head
    # decoder shell (bf16): encode and three decode blocks at F, the last
    # at 2F, the asr residual at F
    bf = frames * (_resblk1d(hid + 2, 1024, False)
                   + 3 * _resblk1d(1024 + 2 + 64, 1024, False)
                   + 2 * _resblk1d(1024 + 2 + 64, 512, True)
                   + 2.0 * hid * 64)
    mel = 2 * frames
    if dec["type"] == "hifigan":
        rates, kups = dec["upsample_rates"], dec["upsample_kernel_sizes"]
        c, rate = dec["upsample_initial_channel"], mel
        bf += mel * int(np.prod(rates)) * 2.0 * 9  # the source's linear
        for i, (u, k) in enumerate(zip(rates, kups)):
            c_out, out_rate = c // 2, rate * u
            bf += 2.0 * rate * c * c_out * k             # transposed conv
            last = i + 1 == len(rates)
            k_noise = 1 if last else 2 * int(np.prod(rates[i + 1:]))
            bf += 2.0 * out_rate * c_out * k_noise       # the noise conv
            blocks = [(11 if last else 7, (1, 3, 5))]
            blocks += list(zip(dec["resblock_kernel_sizes"],
                               dec["resblock_dilation_sizes"]))
            for kk, dils in blocks:
                bf += len(dils) * 2 * 2.0 * out_rate * c_out * c_out * kk
            c, rate = c_out, out_rate
        bf += 2.0 * rate * c * 7                         # conv_post
    elif dec["type"] == "vocos":
        inter, n_fft = dec["intermediate_dim"], dec["gen_istft_n_fft"]
        bf += mel * dec["num_layers"] * (2.0 * 512 * 7
                                         + 2 * 2.0 * 512 * inter)
        bf += mel * 2.0 * 512 * (n_fft + 2)
        bf += mel * 2.5 * n_fft * math.log2(n_fft)       # the inverse rFFT
    else:
        raise ValueError(f"no FLOP count for decoder {dec['type']!r}")
    return f32, bf


def least_seconds(mp: Mapping, tokens: int, frames: int) -> float:
    """The least seconds the card needs for one utterance's FLOPs, each
    part at the peak of the precision it runs in."""
    f32, bf = flops(mp, tokens, frames)
    return f32 / PEAK_F32 + bf / PEAK_BF16
