"""Dataset: `path|transcript` list files -> (waveform, token) examples.

Parity: reference meldataset.FilePathDataset (meldataset.py:58-131):
* audio loading (audio.read_audio: WAV, or FLAC through flac.py; first
  channel of stereo), resample to 24 kHz
* 0.5 s of silence padded on both ends (meldataset.py:111)
* tokenized transcript wrapped with pad id 0 (meldataset.py:115-116)

Mel spectrograms are NOT computed here — the device computes them in the
train step (train.compute_mels, kernel B2 on CUDA), removing the
reference's CPU dataloader-worker bottleneck.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch.text import TextCleaner

SR = 24000
PAD_SAMPLES = 12000  # 0.5 s


def parse_data_list(lines: Sequence[str]) -> List[Tuple[str, str]]:
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        parts = line.split("|")
        out.append((parts[0], parts[1] if len(parts) > 1 else ""))
    return out


def wav_duration_samples_24k(path: str) -> int:
    """Fast length probe from the WAV/FLAC header (reference get_length,
    meldataset.py:181-183, via soundfile.info)."""
    return AUD.probe_duration_samples(path, SR)


class FilePathDataset:
    def __init__(self, data_list: Sequence[str], root_path: str,
                 symbol_dict: Dict[str, int], sr: int = SR,
                 validation: bool = False, debug: bool = True):
        self.data_list = parse_data_list(data_list)
        self.root_path = root_path
        self.cleaner = TextCleaner(symbol_dict, debug)
        self.sr = sr

    def __len__(self) -> int:
        return len(self.data_list)

    def lengths(self) -> List[int]:
        """Padded sample counts for the duration-binned sampler."""
        return [wav_duration_samples_24k(os.path.join(self.root_path, p))
                for p, _ in self.data_list]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        path, text = self.data_list[idx]
        wave, in_sr = AUD.read_audio(os.path.join(self.root_path, path))
        if in_sr != self.sr:
            wave = AUD.resample(wave, in_sr, self.sr)
        wave = np.concatenate([np.zeros(PAD_SAMPLES, np.float32), wave,
                               np.zeros(PAD_SAMPLES, np.float32)])
        tokens = [0] + self.cleaner(text) + [0]
        return wave.astype(np.float32), np.asarray(tokens, np.int64), path
