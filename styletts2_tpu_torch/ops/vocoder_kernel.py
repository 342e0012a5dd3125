"""Kernel B1: fused AdaIN affine + Snake + prefix mask + dilated SAME conv
(csrc/vocoder.cu) and its plain version.

Replaces styletts2_tpu/ops/vocoder_pallas.py fused_ada_snake_conv. It runs
every AdaIN+Snake+conv pair of the HiFi-GAN generator's AdaINResBlock1
blocks: 16 blocks x 3 dilations x 2 convs = 96 launches per phase-2 call
at the default config.

    z   = snake(x * scale + shift, alpha)     # the AdaIN as an affine
    z   = where(t < n_valid, z, 0)            # bucket padding
    z   = z cast to x.dtype
    out = conv1d_same(z, w, dilation) + bias (+ residual), f32 accumulation

`ada_snake_conv` launches the kernel for CUDA tensors and runs
`ada_snake_conv_plain` for CPU tensors; there is no other route. It has no
backward (nor has the TPU kernel): it is inference only, and raises when
asked to build a graph, pointing to the training route (the block's plain
formulation, taken when the caller passes no valid prefix). bf16
runs its products on the tensor cores (wgmma), f32 on the CUDA cores in
true f32. The weight is prepacked (k, C_in, C_out) in x's dtype
(weights.py / the block's `prepack`) for both; the bf16 kernel reads it
N-major. The optional stats are the masked [sum, sum of squares] of the
quantized output per (batch, channel), shape (B, 2, C): the kernel writes
per-block partials, (B, 2, C, blocks along T), that are summed here over
the last axis (deterministic: no atomics).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# minimax fit of sin^2(r)/r^2 on [0, pi/2], degree 4 in u = r^2 (the TPU
# kernel's coefficients): max error 4.4e-7, far below bf16's step
SIN2_COEFFS = (0.9999919530071253, -0.3332866101072116,
               0.04435612637758055, -0.003101284637731907,
               0.00011299663600091553)


def sin2_poly(y: torch.Tensor) -> torch.Tensor:
    """sin(y)^2 via mod-pi range reduction + the even minimax polynomial
    (the bf16 snake of the TPU kernel and of csrc/vocoder.cu)."""
    r = y - 3.141592653589793 * torch.round(y * 0.3183098861837907)
    u = r * r
    p = torch.full_like(u, SIN2_COEFFS[-1])
    for c in SIN2_COEFFS[-2::-1]:
        p = p * u + c
    return u * p


def ada_snake_conv_plain(x: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor, alpha: torch.Tensor,
                         w: torch.Tensor, bias: torch.Tensor, dilation: int,
                         n_valid: torch.Tensor, *,
                         residual: Optional[torch.Tensor] = None,
                         out_stats: bool = False):
    """The kernel's arithmetic in PyTorch ops: f32 affine and snake (exact
    sin for f32 x, the sin^2 polynomial for bf16 x), cast to x.dtype, k
    shifted true-f32 matmuls of the cast values (bf16 products are exact in
    f32), bias, residual, cast back."""
    b, t, c = x.shape
    k = w.shape[0]
    halo = dilation * (k - 1) // 2
    a = alpha.float().view(1, 1, c)
    z = x.float() * scale.float()[:, None, :] + shift.float()[:, None, :]
    if x.dtype == torch.bfloat16:
        z = z + (1.0 / a) * sin2_poly(a * z)
    else:
        sn = torch.sin(a * z)
        z = z + (1.0 / a) * (sn * sn)
    pos = torch.arange(t, device=x.device)
    valid = (pos[None, :] < n_valid.to(x.device)[:, None])[..., None]
    z = torch.where(valid, z, torch.zeros_like(z)).to(x.dtype).float()
    zp = F.pad(z, (0, 0, halo, halo))
    wf = w.float()
    acc = torch.zeros(b, t, c, dtype=torch.float32, device=x.device)
    for i in range(k):  # accumulate in place: no (B, T, C) temporary a tap
        acc.baddbmm_(zp[:, i * dilation: i * dilation + t],
                     wf[i].expand(b, c, c))
    acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    out = acc.to(x.dtype)
    if not out_stats:
        return out
    om = torch.where(valid, out.float(), torch.zeros((), device=x.device))
    return out, torch.stack([om.sum(dim=1), (om * om).sum(dim=1)], dim=1)


def _check(x, scale, shift, alpha, w, bias, n_valid, residual):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype} is not float32 or bfloat16")
    k = w.shape[0]
    want = {"scale": (scale, (b, c), torch.float32),
            "shift": (shift, (b, c), torch.float32),
            "alpha": (alpha, (c,), torch.float32),
            "w": (w, (k, c, c), x.dtype),
            "bias": (bias, (c,), torch.float32),
            "n_valid": (n_valid, (b,), torch.int32)}
    if residual is not None:
        want["residual"] = (residual, (b, t, c), x.dtype)
    for name, (v, shape, dtype) in want.items():
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise ValueError(f"ada_snake_conv: {name} must be {shape} "
                             f"{dtype}, got {tuple(v.shape)} {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"ada_snake_conv: {name} on {v.device}, x on "
                             f"{x.device}")
        if not v.is_contiguous():
            raise ValueError(f"ada_snake_conv: {name} is not contiguous")
    if not x.is_contiguous():
        raise ValueError("ada_snake_conv: x is not contiguous")
    if k % 2 == 0:
        raise ValueError(f"ada_snake_conv: SAME conv needs an odd k, got {k}")


def ada_snake_conv(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   alpha: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   dilation: int, n_valid: torch.Tensor, *,
                   residual: Optional[torch.Tensor] = None,
                   out_stats: bool = False):
    """x: (B, T, C) f32 or bf16; scale, shift: (B, C) f32; alpha, bias:
    (C,) f32; w: (k, C, C) in x.dtype; n_valid: (B,) int32 valid prefix
    lengths; residual: optional (B, T, C) in x.dtype. Returns out (B, T, C)
    in x.dtype, and with out_stats also the (B, 2, C) f32 [sum, sum of
    squares] of the masked output.

    CPU tensors: the plain version. CUDA tensors: kernel B1, or an error.
    Inference only: raises if grad mode is on and any tensor argument
    requires a gradient."""
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad
            for v in (x, scale, shift, alpha, w, bias, residual)):
        raise RuntimeError(
            "ada_snake_conv is inference only (kernel B1 has no backward): "
            "a differentiable call takes the plain training route, "
            "AdaINResBlock1(x, s) with no mask and no n_valid (the "
            "decoder's frame_mask=None), as the training step does")
    _check(x, scale, shift, alpha, w, bias, n_valid, residual)
    if x.device.type == "cpu":
        return ada_snake_conv_plain(x, scale, shift, alpha, w, bias,
                                    dilation, n_valid, residual=residual,
                                    out_stats=out_stats)
    if x.device.type != "cuda":
        raise ValueError(f"ada_snake_conv: unsupported device {x.device}")
    b, t, c = x.shape
    if c % 32 != 0:
        raise ValueError(f"ada_snake_conv kernel needs C % 32 == 0, got {c}")
    from styletts2_tpu_torch.ops import _build

    is_bf16 = int(x.dtype == torch.bfloat16)
    for name, v in (("x", x), ("w", w), ("residual", residual)):
        if v is not None and v.data_ptr() % 16:
            raise ValueError(f"ada_snake_conv kernel needs 16-byte aligned "
                             f"{name}")
    lib = _build.load("vocoder")
    out = torch.empty_like(x)
    stats = None
    if out_stats:
        rows = lib.ada_snake_conv_rows_per_block(c, is_bf16)
        stats = torch.empty(b, 2, c, -(-t // rows), dtype=torch.float32,
                            device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ada_snake_conv(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), alpha.data_ptr(),
        w.data_ptr(), bias.data_ptr(), n_valid.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(), b, t, c, w.shape[0],
        int(dilation), is_bf16, stream)
    if err != 0:
        raise RuntimeError(f"ada_snake_conv kernel launch failed: CUDA "
                           f"error {err}")
    ada_snake_conv.launches += 1
    if not out_stats:
        return out
    return out, stats.sum(dim=-1)


ada_snake_conv.launches = 0
