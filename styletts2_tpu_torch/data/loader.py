"""Batch assembly + background prefetch.

Parity: reference Collater + build_dataloader (meldataset.py:134-225), with
static per-bin shapes: a batch from duration-bin k pads every waveform to
the bin's upper edge and tokens to a fixed multiple, so the device sees one
set of shapes per (bin, text-bucket) pair instead of one per batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from styletts2_tpu_torch.data.dataset import FilePathDataset, PAD_SAMPLES
from styletts2_tpu_torch.data.sampler import (DurationBinSampler,
                                              FRAMES_PER_BIN, HOP, MIN_FRAMES)

TEXT_PAD_MULTIPLE = 32
# Bins are computed from the RAW file length (reference get_length,
# meldataset.py:181-183), but FilePathDataset pads 0.5 s of silence on both
# ends (meldataset.py:111) — every item is PAD_FRAMES longer than its bin
# edge suggests, and the static batch shape must cover that.
PAD_FRAMES = 2 * PAD_SAMPLES // HOP  # 80


def bin_upper_frames(bin_id: int) -> int:
    """Upper mel-frame edge (exclusive) of a duration bin, INCLUDING the
    dataset's silence padding."""
    return MIN_FRAMES + (bin_id + 1) * FRAMES_PER_BIN + PAD_FRAMES


def bin_min_frames(bin_id: int) -> int:
    """Minimum (even) mel frame count of any padded sample in the bin."""
    return MIN_FRAMES + bin_id * FRAMES_PER_BIN + PAD_FRAMES


def bin_crop_frames(bin_id: int, max_len: int) -> int:
    """Static per-bin training crop at the half-mel rate — the reference
    bounds its crop by the batch minimum (train.py:235): mel_len =
    min(mel_input_length.min()//2 - 1, max_len//2). Binning makes the batch
    minimum a static per-bin quantity."""
    return min(bin_min_frames(bin_id) // 2 - 1, max_len // 2)


class NumpyBatch:
    """Host-side batch matching train.Batch fields."""

    __slots__ = ("waves", "texts", "input_lengths", "mel_lengths", "paths")

    def __init__(self, waves, texts, input_lengths, mel_lengths, paths):
        self.waves = waves
        self.texts = texts
        self.input_lengths = input_lengths
        self.mel_lengths = mel_lengths
        self.paths = paths


def collate(dataset: FilePathDataset, indices: Sequence[int],
            bin_id: int) -> NumpyBatch:
    items = [dataset[i] for i in indices]
    max_frames = bin_upper_frames(bin_id)
    wav_len = max_frames * HOP
    b = len(items)
    max_text = max(len(t) for _, t, _ in items)
    text_pad = -(-max_text // TEXT_PAD_MULTIPLE) * TEXT_PAD_MULTIPLE

    waves = np.zeros((b, wav_len), np.float32)
    texts = np.zeros((b, text_pad), np.int32)
    input_lengths = np.zeros(b, np.int32)
    mel_lengths = np.zeros(b, np.int32)
    paths = []
    for i, (wave, tokens, path) in enumerate(items):
        # bin_upper_frames covers raw length + dataset silence padding, so
        # no sample content is ever dropped (min() guards resample rounding)
        n = min(len(wave), wav_len)
        assert len(wave) - n <= 1, \
            f"collate would truncate {len(wave) - n} samples (bin {bin_id})"
        waves[i, :n] = wave[:n]
        texts[i, :len(tokens)] = tokens
        input_lengths[i] = len(tokens)
        # mel frames of the (possibly truncated) wave, even count
        # (center=True STFT yields n//hop + 1 frames; reference truncates to
        # even, meldataset.py:97)
        frames = n // HOP + 1
        mel_lengths[i] = frames - frames % 2
        paths.append(path)
    return NumpyBatch(waves, texts, input_lengths, mel_lengths, paths)


class DataLoader:
    """Iterates (bin_id, NumpyBatch) with a background prefetch thread."""

    def __init__(self, dataset: FilePathDataset, sampler: DurationBinSampler,
                 prefetch: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for bin_id, idxs in self.sampler:
                    q.put((bin_id, collate(self.dataset, idxs, bin_id)))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def build_dataloader(path_list: Sequence[str], root_path: str, symbol_dict,
                     validation: bool = False, batch_size: int = 4,
                     num_replicas: int = 1, rank: int = 0, seed: int = 0,
                     debug: bool = True, prefetch: int = 4) -> DataLoader:
    """reference meldataset.build_dataloader parity (meldataset.py:185-225)."""
    dataset = FilePathDataset(path_list, root_path, symbol_dict,
                              validation=validation, debug=debug)
    sampler = DurationBinSampler(dataset.lengths(), batch_size,
                                 num_replicas=num_replicas, rank=rank,
                                 shuffle=not validation,
                                 drop_last=not validation, seed=seed)
    return DataLoader(dataset, sampler, prefetch=prefetch)
