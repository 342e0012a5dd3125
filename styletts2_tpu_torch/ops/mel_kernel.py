"""Kernel B2: fused log-mel front end (csrc/mel.cu) and its plain version.

Replaces styletts2_tpu/ops/mel_pallas.py fused_log_mel. Framing (reflect
pad + strided frames) stays in PyTorch; the kernel computes
`(log(1e-5 + ((frames@cos)^2 + (frames@sin)^2) @ fb) - mean) / std` with
the power spectrum kept on chip. Its grid splits the frequency axis into
tiles of TF columns: the first pass writes one partial mel per tile to a
scratch tensor, the second sums them in tile order and log-normalises.
`log_mel` launches the kernel for CUDA tensors and runs `log_mel_plain`
for CPU tensors; there is no other route. On CUDA it is differentiable
(`_LogMel`, the counterpart of mel_pallas.py's custom VJP): the forward is
the kernel, the backward is autograd over `log_mel_plain`, as JAX's
`_fused_bwd` is `jax.vjp` of the plain formula; there is no backward
kernel to write.
The style path calls it once per `compute_style` (twice when a >= 1-s tail
window remains); a training step calls it 8 times (`compute_mels` in the D
and G steps, 6 in the MRSTFT loss).
"""

from __future__ import annotations

import torch

from styletts2_tpu_torch.ops import launch_count
from styletts2_tpu_torch.ops import stft as S

TF = 64  # frequency tile of csrc/mel.cu: the bases are padded to a multiple


def log_mel_plain(wave: torch.Tensor, sr: int = 24000, n_fft: int = 2048,
                  win_length: int = 1200, hop_length: int = 300,
                  n_mels: int = 80, mean: float = S.LOG_MEL_MEAN,
                  std: float = S.LOG_MEL_STD) -> torch.Tensor:
    """(B, T) -> (B, n_mels, n_frames): the unfused true-f32 formula."""
    mel = S.mel_spectrogram(wave, sr=sr, n_fft=n_fft, win_length=win_length,
                            hop_length=hop_length, n_mels=n_mels)
    return S.log_mel_normalize(mel, mean, std)


@S.cached_constant
def _device_bases(sr: int, n_fft: int, win_length: int, n_mels: int,
                  device: torch.device):
    """Kernel operands, built once per (sr, n_fft, win, n_mels, device):
    cos/sin (n_fft, F_pad) and fb (F_pad, M_pad), zero-padded so the
    frequency axis tiles by TF and the mel axis by 16."""
    cos_b, sin_b = S.dft_bases(n_fft, win_length)
    freq = cos_b.shape[1]
    f_pad = -(-freq // TF) * TF
    m_pad = -(-n_mels // 16) * 16
    fb = torch.zeros(f_pad, m_pad, dtype=torch.float32)
    fb[:freq, :n_mels] = torch.from_numpy(S.mel_filterbank(sr, n_fft, n_mels))

    def pad_cols(b):
        return torch.nn.functional.pad(b, (0, f_pad - freq)).contiguous()

    return (pad_cols(cos_b).to(device), pad_cols(sin_b).to(device),
            fb.to(device))


def log_mel(wave: torch.Tensor, sr: int = 24000, n_fft: int = 2048,
            win_length: int = 1200, hop_length: int = 300, n_mels: int = 80,
            mean: float = S.LOG_MEL_MEAN,
            std: float = S.LOG_MEL_STD) -> torch.Tensor:
    """(B, T) f32 waveforms -> (B, n_mels, n_frames) normalised log-mels.

    CPU tensor: the plain version. CUDA tensor: kernel B2, or an error;
    differentiable in `wave`."""
    if wave.dim() != 2 or wave.dtype != torch.float32:
        raise ValueError(f"log_mel takes (B, T) float32 waves, got "
                         f"{tuple(wave.shape)} {wave.dtype}")
    if wave.device.type == "cpu":
        return log_mel_plain(wave, sr, n_fft, win_length, hop_length, n_mels,
                             mean, std)
    if wave.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {wave.device}")
    if n_fft % 32 != 0 or not 0 < n_mels <= 128:
        raise ValueError(f"log_mel kernel needs n_fft % 32 == 0 and "
                         f"n_mels <= 128, got {n_fft}, {n_mels}")
    return _LogMel.apply(wave, (sr, n_fft, win_length, hop_length, n_mels,
                                float(mean), float(std)))


class _LogMel(torch.autograd.Function):
    """Kernel B2 forward; backward = autograd of `log_mel_plain` at the
    saved wave against the incoming gradient."""

    @staticmethod
    def forward(ctx, wave, args):
        ctx.save_for_backward(wave)
        ctx.args = args
        return _launch(wave, *args)

    @staticmethod
    def backward(ctx, grad):
        wave, = ctx.saved_tensors
        with torch.enable_grad():
            w = wave.detach().requires_grad_()
            y = log_mel_plain(w, *ctx.args)
            gw, = torch.autograd.grad(y, w, grad)
        return gw, None


def _launch(wave: torch.Tensor, sr: int, n_fft: int, win_length: int,
            hop_length: int, n_mels: int, mean: float,
            std: float) -> torch.Tensor:
    """One launch of kernel B2 on a CUDA (B, T) f32 wave."""
    from styletts2_tpu_torch.ops import _build

    # the C side sets its shared-memory attribute on the thread's current
    # device: make it the wave's for the launch
    with torch.cuda.device(wave.device):
        lib = _build.load("mel")
        b = wave.shape[0]
        frames = S.frame_signal(wave.detach(), n_fft,
                                hop_length).contiguous()
        n_frames = frames.shape[1]
        cos_p, sin_p, fb_p = _device_bases(sr, n_fft, win_length, n_mels,
                                           wave.device)
        rows = b * n_frames
        partial = torch.empty(cos_p.shape[1] // TF, rows, fb_p.shape[1],
                              dtype=torch.float32, device=wave.device)
        out = torch.empty(rows, n_mels, dtype=torch.float32,
                          device=wave.device)
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        err = lib.log_mel(frames.data_ptr(), cos_p.data_ptr(),
                          sin_p.data_ptr(), fb_p.data_ptr(),
                          partial.data_ptr(), out.data_ptr(), rows, n_fft,
                          cos_p.shape[1], n_mels, mean, std, stream)
        if err != 0:
            raise RuntimeError(f"log_mel kernel launch failed: CUDA error "
                               f"{err}")
    launch_count.add("log_mel")
    return out.view(b, n_frames, n_mels).transpose(1, 2)
