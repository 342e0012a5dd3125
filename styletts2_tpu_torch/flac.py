"""FLAC input: a pure-python decoder, a C++ fast path and a minimal
encoder for tests.

The port's own copy of styletts2_tpu/flac.py (the reference reads any
soundfile-supported format, meldataset.py:101, and LibriTTS-style corpora
ship FLAC; this code has no libsndfile or ffmpeg to lean on). The decoder
follows the FLAC bitstream spec: STREAMINFO metadata, frames with
constant / verbatim / fixed / LPC subframes, 4- and 5-bit Rice-coded
residual partitions, and left-side / right-side / mid-side channel
decorrelation. `read_flac` decodes through native/flac_decode.cpp (built
with g++ at first use into build/styletts2_tpu_torch/) and falls back to
the python decoder when g++ is missing or the stream needs a path the
native one does not take. Set STYLETTS2_TPU_TORCH_NO_NATIVE_FLAC=1 to force
the python decoder. `audio.read_audio` and
`audio.probe_duration_samples` route FLAC files here by their magic.

The encoder exists for tests only: fixed 4096-sample blocks, one subframe
type per call (constant / verbatim / fixed order-2 / LPC order-2), enough
to exercise every decoder path without an external encoder.
"""

from __future__ import annotations

import struct
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {0: None, 1: 88200, 2: 176400, 3: 192000, 4: 8000,
                 5: 16000, 6: 22050, 7: 24000, 8: 32000, 9: 44100,
                 10: 48000, 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


class _BitReader:
    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # bit position

    def read(self, nbits: int) -> int:
        """Read an unsigned big-endian bit field."""
        out = 0
        pos = self.pos
        data = self.data
        end = pos + nbits
        while pos < end:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, end - pos)
            shift = avail - take
            bits = (byte >> shift) & ((1 << take) - 1)
            out = (out << take) | bits
            pos += take
        self.pos = end
        return out

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v >= (1 << (nbits - 1)):
            v -= 1 << nbits
        return v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1."""
        count = 0
        pos = self.pos
        data = self.data
        while True:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            chunk = byte & ((1 << avail) - 1)
            if chunk == 0:
                count += avail
                pos += avail
                continue
            lead = avail - chunk.bit_length()
            count += lead
            pos += lead + 1
            break
        self.pos = pos
        return count

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_utf8_number(self) -> int:
        first = self.read(8)
        if first < 0x80:
            return first
        n = 0
        mask = 0x40
        while first & mask:
            n += 1
            mask >>= 1
        value = first & (mask - 1)
        for _ in range(n):
            value = (value << 6) | (self.read(8) & 0x3F)
        return value


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method not in (0, 1):
        raise ValueError(f"unsupported residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    part_len = blocksize >> part_order
    res: List[int] = []
    for p in range(n_parts):
        n = part_len - (order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw = br.read(5)
            if raw == 0:
                res.extend([0] * n)
            else:
                res.extend(br.read_signed(raw) for _ in range(n))
        else:
            for _ in range(n):
                q = br.read_unary()
                u = (q << param) | br.read(param) if param else q
                res.append((u >> 1) ^ -(u & 1))  # zigzag
    return np.asarray(res, dtype=np.int64)


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted

    if ftype == 0:  # constant
        out = np.full(blocksize, br.read_signed(bps), dtype=np.int64)
    elif ftype == 1:  # verbatim
        out = np.asarray([br.read_signed(bps) for _ in range(blocksize)],
                         dtype=np.int64)
    elif 8 <= ftype <= 12:  # fixed
        order = ftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, dtype=np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        x = out
        for i in range(order, blocksize):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * x[i - 1 - j]
            x[i] = acc
    elif ftype >= 32:  # LPC
        order = ftype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        shift = max(br.read_signed(5), 0)  # negative shifts are invalid
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        out = np.empty(blocksize, dtype=np.int64)
        out[:order] = warm
        x = out
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coefs[j] * int(x[i - 1 - j])
            x[i] = (acc >> shift) + res[i - order]
    else:
        raise ValueError(f"reserved subframe type {ftype}")
    if wasted:
        out = out << wasted
    return out


def probe_flac_info(path: str) -> Tuple[int, int]:
    """(total samples, sample rate) from STREAMINFO only — a fast length
    probe for the duration-binned sampler."""
    with open(path, "rb") as f:
        data = f.read(4 + 4 + 34)
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC file")
    si = _BitReader(data, 8)
    si.read(16); si.read(16); si.read(24); si.read(24)
    sr = si.read(20)
    si.read(3); si.read(5)
    total = si.read(36)
    return total, sr


_NATIVE_LIB = None  # lazily compiled; False = unavailable
_NATIVE_LOCK = threading.Lock()
_NATIVE_SRC = Path(__file__).resolve().parent / "native" / "flac_decode.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "styletts2_tpu_torch"


def _native_lib():
    """ctypes binding to native/flac_decode.cpp, compiled on first use with
    g++ into build/styletts2_tpu_torch/libflac_decode-<source hash>.so.
    Returns None when it cannot be built; decoding then stays in python."""
    global _NATIVE_LIB
    with _NATIVE_LOCK:
        if _NATIVE_LIB is not None:
            return _NATIVE_LIB or None
        import ctypes
        import hashlib
        import os
        import subprocess

        try:
            digest = hashlib.sha256(_NATIVE_SRC.read_bytes()).hexdigest()[:16]
            so_path = _BUILD_DIR / f"libflac_decode-{digest}.so"
            if not so_path.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # a private temporary, then an atomic rename: another
                # process never loads a half-written library
                tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", "-std=c++17", "-O3", "-shared",
                                "-fPIC", "-o", str(tmp), str(_NATIVE_SRC)],
                               check=True, capture_output=True)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.flac_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.flac_decode.restype = ctypes.c_int64
        except (OSError, subprocess.CalledProcessError):
            _NATIVE_LIB = False
            return None
        _NATIVE_LIB = lib
        return lib


def _read_flac_native(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Decode via the C++ kernel; None -> caller uses the python path.
    Needs a nonzero STREAMINFO total (the output buffer's size)."""
    import ctypes
    import os

    if os.environ.get("STYLETTS2_TPU_TORCH_NO_NATIVE_FLAC") == "1":
        return None
    lib = _native_lib()
    if lib is None or len(data) < 42:
        return None
    if data[4] & 0x7F != 0:
        # first metadata block is not STREAMINFO: the fixed-offset total
        # below would be garbage (and size an allocation) — let the python
        # decoder produce its proper error instead
        return None
    si = _BitReader(data, 8)
    si.read(16); si.read(16); si.read(24); si.read(24); si.read(20)
    si.read(3); si.read(5)
    total = si.read(36)
    if total == 0 or total > len(data) * 4096:
        # unknown length (python path grows its buffer) or a corrupt total
        # — even all-constant silence at the standard 4096 blocksize stays
        # under ~400 samples per encoded byte, so don't size an allocation
        # from anything claiming more
        return None
    out = np.empty(total, np.float32)
    sr = ctypes.c_int32(0)
    got = lib.flac_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        total, ctypes.byref(sr))
    if got < 0:
        return None  # malformed/unsupported: let python raise its error
    return out[:got], int(sr.value)


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 mono samples in [-1, 1], sample rate).

    Multi-channel audio returns the FIRST channel (matching read_wav and
    the reference's meldataset.py:104-105 mono policy). Decodes through
    native/flac_decode.cpp when g++ is available (the corpus-read hot
    path), falling back to the pure-python bitstream decoder below."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC file")
    native = _read_flac_native(data)
    if native is not None:
        return native

    # metadata blocks
    pos = 4
    sr = channels = bps = None
    total = 0
    while True:
        header = data[pos]
        btype = header & 0x7F
        last = header & 0x80
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        if btype == 0:  # STREAMINFO
            si = _BitReader(data, pos + 4)
            si.read(16); si.read(16)  # min/max blocksize
            si.read(24); si.read(24)  # min/max framesize
            sr = si.read(20)
            channels = si.read(3) + 1
            bps = si.read(5) + 1
            total = si.read(36)
        pos += 4 + length
        if last:
            break
    if sr is None:
        raise ValueError(f"{path}: missing STREAMINFO")

    out: List[np.ndarray] = []
    got = 0
    while pos < len(data) and (total == 0 or got < total):
        br = _BitReader(data, pos)
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise ValueError(f"{path}: lost frame sync at byte {pos}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_number()
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SAMPLE_SIZES.get(ss_code, bps)
        br.read(8)  # header CRC-8

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(br, blocksize, frame_bps)
                    for _ in range(n_ch)]
            chans = subs
        else:
            # stereo decorrelation: one channel carries the 'side' at bps+1
            if ch_code == 8:  # left/side
                left = _decode_subframe(br, blocksize, frame_bps)
                side = _decode_subframe(br, blocksize, frame_bps + 1)
                chans = [left, left - side]
            elif ch_code == 9:  # right/side
                side = _decode_subframe(br, blocksize, frame_bps + 1)
                right = _decode_subframe(br, blocksize, frame_bps)
                chans = [right + side, right]
            elif ch_code == 10:  # mid/side
                mid = _decode_subframe(br, blocksize, frame_bps)
                side = _decode_subframe(br, blocksize, frame_bps + 1)
                mid2 = (mid << 1) | (side & 1)
                chans = [(mid2 + side) >> 1, (mid2 - side) >> 1]
            else:
                raise ValueError(f"reserved channel assignment {ch_code}")
        br.align()
        br.read(16)  # frame CRC-16
        pos = br.pos >> 3
        out.append(chans[0][:])
        got += blocksize

    samples = np.concatenate(out) if out else np.zeros(0, np.int64)
    if total:
        samples = samples[:total]
    scale = float(1 << (bps - 1))
    return (samples.astype(np.float32) / scale), sr


# ---------------------------------------------------------------------------
# Minimal encoder (tests only)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        self.bits.extend([0] * q)
        self.bits.append(1)

    def align(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def tobytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i: i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _write_rice(bw: _BitWriter, res: np.ndarray, param: int = 4) -> None:
    bw.write(0, 2)   # rice method 0 (4-bit params)
    bw.write(0, 4)   # partition order 0
    bw.write(param, 4)
    for r in res:
        u = (int(r) << 1) ^ (int(r) >> 63)  # zigzag
        bw.write_unary(u >> param)
        if param:
            bw.write(u & ((1 << param) - 1), param)


def write_flac(path: str, wav: np.ndarray, sr: int = 24000,
               subframe: str = "fixed2") -> None:
    """Test-fixture encoder: 16-bit mono, fixed 4096 blocks, one subframe
    type ('constant' requires constant input; 'verbatim', 'fixed2', 'lpc2')."""
    pcm = np.clip(np.asarray(wav, np.float64), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int64)
    bps, blocksize = 16, 4096

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(blocksize, 16); si.write(blocksize, 16)
    si.write(0, 24); si.write(0, 24)
    si.write(sr, 20); si.write(0, 3); si.write(bps - 1, 5)
    si.write(len(pcm) & ((1 << 36) - 1), 36)
    body = si.tobytes() + b"\x00" * 16  # md5 zeroed (decoder ignores)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    for fi in range(0, max(len(pcm), 1), blocksize):
        block = pcm[fi: fi + blocksize]
        n = len(block)
        bw = _BitWriter()
        bw.write(0b11111111111110, 14)
        bw.write(0, 1); bw.write(0, 1)
        bw.write(7, 4)      # 16-bit blocksize field follows
        bw.write(7, 4)      # sample rate code 7 = 24000 (field-free)
        bw.write(0, 4)      # 1 channel
        bw.write(4, 3)      # 16 bps
        bw.write(0, 1)
        bw.write(fi // blocksize, 8)  # UTF-8 frame number (< 128)
        bw.write(n - 1, 16)
        bw.write(0, 8)      # header CRC-8 (decoder skips)

        bw.write(0, 1)
        if subframe == "constant":
            assert (block == block[0]).all()
            bw.write(0, 6); bw.write(0, 1)
            bw.write_signed(int(block[0]), bps)
        elif subframe == "verbatim":
            bw.write(1, 6); bw.write(0, 1)
            for v in block:
                bw.write_signed(int(v), bps)
        elif subframe == "fixed2":
            order = min(2, n)
            bw.write(8 + order, 6); bw.write(0, 1)
            for v in block[:order]:
                bw.write_signed(int(v), bps)
            if order == 2:
                res = block[2:] - (2 * block[1:-1] - block[:-2])
            else:
                res = block[order:]
            _write_rice(bw, res)
        elif subframe == "lpc2":
            assert n > 2
            # LPC order 2 mimicking the fixed-2 predictor: coefs (2, -1),
            # shift 0 — exercises the LPC read path with exact residuals
            bw.write(32 + 1, 6); bw.write(0, 1)
            for v in block[:2]:
                bw.write_signed(int(v), bps)
            bw.write(14, 4)            # precision 15
            bw.write_signed(0, 5)      # shift 0
            bw.write_signed(2, 15); bw.write_signed(-1, 15)
            res = block[2:] - (2 * block[1:-1] - block[:-2])
            _write_rice(bw, res)
        else:
            raise ValueError(subframe)
        bw.align()
        bw.write(0, 16)  # frame CRC-16 (decoder skips)
        out += bw.tobytes()

    with open(path, "wb") as f:
        f.write(bytes(out))


_STEREO_CH_CODES = {"independent": 1, "left_side": 8, "right_side": 9,
                    "mid_side": 10}


def write_flac_stereo(path: str, left: np.ndarray, right: np.ndarray,
                      sr: int = 24000, mode: str = "left_side") -> None:
    """Test-fixture STEREO encoder (verbatim subframes only): exercises
    the decoders' channel-decorrelation paths — independent 2-channel,
    left/side, right/side, mid/side (the side subframe carries bps+1
    bits). Decoding returns the FIRST channel == `left` for every mode."""
    ch_code = _STEREO_CH_CODES[mode]
    l = (np.clip(np.asarray(left, np.float64), -1.0, 1.0)
         * 32767.0).astype(np.int64)
    r = (np.clip(np.asarray(right, np.float64), -1.0, 1.0)
         * 32767.0).astype(np.int64)
    assert len(l) == len(r)
    bps, blocksize = 16, 4096

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(blocksize, 16); si.write(blocksize, 16)
    si.write(0, 24); si.write(0, 24)
    si.write(sr, 20); si.write(1, 3); si.write(bps - 1, 5)  # 2 channels
    si.write(len(l) & ((1 << 36) - 1), 36)
    body = si.tobytes() + b"\x00" * 16
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    for fi in range(0, max(len(l), 1), blocksize):
        bl, br_ = l[fi: fi + blocksize], r[fi: fi + blocksize]
        n = len(bl)
        bw = _BitWriter()
        bw.write(0b11111111111110, 14)
        bw.write(0, 1); bw.write(0, 1)
        bw.write(7, 4)
        bw.write(7, 4)
        bw.write(ch_code, 4)
        bw.write(4, 3)
        bw.write(0, 1)
        bw.write(fi // blocksize, 8)
        bw.write(n - 1, 16)
        bw.write(0, 8)

        if mode == "independent":
            subs = [(bl, bps), (br_, bps)]
        elif mode == "left_side":
            subs = [(bl, bps), (bl - br_, bps + 1)]
        elif mode == "right_side":
            subs = [(bl - br_, bps + 1), (br_, bps)]
        else:  # mid_side
            subs = [((bl + br_) >> 1, bps), (bl - br_, bps + 1)]
        for vals, nb in subs:
            bw.write(0, 1)
            bw.write(1, 6); bw.write(0, 1)  # verbatim
            for v in vals:
                bw.write_signed(int(v), nb)
        bw.align()
        bw.write(0, 16)
        out += bw.tobytes()

    with open(path, "wb") as f:
        f.write(bytes(out))
