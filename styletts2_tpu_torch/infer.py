"""Inference engine: the user-facing StyleTTS2 API on PyTorch/CUDA.

Counterpart of styletts2_tpu/infer.py, with the same API:
  StyleTTS2(config, models_path, *, params, seed, decoder_dtype, device,
            mesh, seq_parallel)
  .get_styles(speaker, denoise, avg_style, load_styles) -> style dict
  .generate(phonem, style, stabilize, n_merge) -> np.ndarray waveform
  .generate_stream(...) -> iterator of waveform segments
  .generate_batch(phonems, style, ...) -> list of waveforms
  .serve(batches, style, ...) -> iterator of lists of waveforms
  .warmup(token_buckets, frame_buckets, style_seconds, batch_sizes)
  .compute_style / .save_styles / .load_styles

Execution follows the JAX engine:
* a single-chunk text takes the fused path (`_fused_impl`): phase 1, the
  duration post-processing on the device and phase 2 in one function on a
  (token bucket, frame bucket) pair whose frame bucket a host heuristic
  picks from the observed speaking rate. On CUDA each pair is one CUDA
  graph, captured at first use and replayed after (the counterpart of the
  JAX engine's jit cache): the host copies the inputs in, replays, and
  syncs once for the audio and the frame total. A total that overflows
  the bucket falls back to the two-phase path with the same seed.
* otherwise the two-phase plan: phase 1 (text encoder, duration encoder,
  duration head) batched per token bucket; one sync for every duration;
  the host glue (stabilisation blend, z-score clamp, speed, rounding) per
  rate chain with the JAX engine's numpy RNG streams; phase 2 (alignment,
  F0/N, decoder, int16 PCM) batched per frame bucket in groups of exactly
  the batch buckets, after splitting pieces that overflow the largest
  frame bucket at token boundaries. Both phases run eagerly.
The decoder is the config's type: hifigan, istftnet or vocos (outputs
are trimmed at total * 2 * hop samples whichever it is). The style mel
runs through kernel B2, and every AdaINResBlock1 conv pair of the
HiFi-GAN and iSTFTNet generators through kernel B1 on CUDA, in eager
calls and inside the captured graphs; Vocos runs no B1.

`fused_compile = "async"` (the serving tools set it) answers a request
whose (token, frame) pair has no graph yet on the two-phase path and
captures the pair's graph on a background thread meanwhile; the next
request on that pair replays it. `wait_fused_compiles` waits for the
queued captures and re-raises the first that failed.

Multi-GPU (parallel/; every rank runs the same calls, as torchrun
launches it): `mesh=parallel.make_mesh()` is the data-parallel engine:
batch buckets (n, 2n, 4n) for n ranks, the last phase-2 group of a frame
bucket padded with copies of its last row, each rank running its rows of
every phase-1 and phase-2 call and the rows gathered (an all-reduce of a
zero-filled buffer), so every rank keeps the whole batch, runs the same
host glue and returns every waveform; the fused graph path is off, so
phase 2 runs eagerly with kernel B1 on every rank. `seq_parallel=True`
(with a mesh) keeps the single-device batching and decodes a frame bucket
that divides over the ranks into at least max(32, the receptive field)
frames each through parallel/seqpar.py (one chunk's decode split over
its time axis; B1 stays off inside the windows, as in JAX).

Not ported yet: CUDA graphs for the batched two-phase calls.
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import Config, load_config
from styletts2_tpu_torch.models import build_inference_modules
from styletts2_tpu_torch.ops import align as ALN
from styletts2_tpu_torch.ops import launch_count as LC
from styletts2_tpu_torch.ops import stft as OPS
from styletts2_tpu_torch.text import (TextCleaner, build_symbol_dict,
                                      split_into_chunks, tokens_for_sentence)

# phase-1/phase-2 batch sizes: a phase-1 group is padded up to one, phase-2
# groups are cut to exactly these sizes
BATCH_BUCKETS = (1, 2, 4, 8, 16)
# the frame-bucket merge rule's costs (merge_frame_buckets): one more eager
# phase-2 call, and one more row per frame, bf16 decoder at full width;
# measured by `python3 chip_smoke.py` (phase 5, "[5 merge]") on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit: the median of the runs that
# passed every check (per call 40.32, 44.79 and 61.76 ms; per row 0.0185,
# 0.0186 and 0.0186 ms per frame). The per-call cost is host time and
# moves with the machine.
PHASE2_CALL_MS = 44.79
PHASE2_ROW_MS_PER_FRAME = 0.0186


def _bucket(buckets, n: int) -> int:
    i = bisect.bisect_left(buckets, n)
    if i == len(buckets):
        raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")
    return buckets[i]


def _split_spans(pred_dur: np.ndarray, max_frames: int) -> List[Tuple[int, int]]:
    """Split a chunk's tokens into contiguous spans whose duration sums each
    fit the largest frame bucket; every token keeps its duration, so the
    synthesized length equals the unsplit sum exactly."""
    if int(pred_dur.sum()) <= max_frames:
        return [(0, len(pred_dur))]
    spans: List[Tuple[int, int]] = []
    a = 0
    acc = 0
    for i, d in enumerate(pred_dur):
        if acc + int(d) > max_frames:
            spans.append((a, i))
            a, acc = i, 0
        acc += int(d)
    spans.append((a, len(pred_dur)))
    return spans


def _replace_outliers_zscore(x: np.ndarray, threshold: float = 3.0,
                             factor: float = 0.95) -> np.ndarray:
    """Clamp |z| > threshold values toward the mean (torch .std() is
    unbiased: ddof=1)."""
    if len(x) < 2:
        return x
    mean, std = x.mean(), x.std(ddof=1)
    if std == 0:
        return x
    z = (x - mean) / std
    out = np.abs(z) > threshold
    repl = mean + np.sign(x - mean) * (threshold * std * factor)
    y = x.copy()
    y[out] = repl[out]
    return y


def _device_postprocess_durations(duration: torch.Tensor, mask: torch.Tensor,
                                  speed: torch.Tensor,
                                  fixed_flag: torch.Tensor,
                                  fixed_value: torch.Tensor,
                                  dur_scale: torch.Tensor, t: torch.Tensor,
                                  prev_mean: torch.Tensor,
                                  noise: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host duration glue as tensor code on the device, vectorized over
    the padded token bucket, so it runs inside the fused graph: fixed or
    scaled durations; the stabilisation blend toward N(prev_mean or the
    row mean, row std) with the caller's standard-normal `noise` (the host
    RNG stays the one source of randomness; t = 0 makes it inert); the
    z-score clamp on the valid [1, n_valid - 3] region (ddof 1); the speed
    divide; round half to even; the min-1 clamp. duration, mask, noise:
    (B, Tb); the rest 0-d f32 tensors. Returns (pred int32 (B, Tb), total
    int32 (B,)). f32 masked row sums where the host glue takes numpy
    slices, so a duration exactly on the |z| = 3 or .5 boundary may round
    the other way (the caller's overflow fallback keeps that harmless)."""
    n_valid = mask.sum(dim=1)
    zero = torch.zeros((), dtype=duration.dtype, device=duration.device)
    duration = torch.where(fixed_flag > 0, fixed_value, duration * dur_scale)
    duration = torch.where(mask, duration, zero)
    nv = torch.clamp(n_valid, min=1)
    mean_all = duration.sum(dim=1) / nv
    var_all = torch.where(mask, (duration - mean_all[:, None]) ** 2,
                          zero).sum(dim=1) / nv  # ddof=0 (numpy .std())
    std_all = torch.sqrt(var_all)
    blend_mean = torch.where(prev_mean != 0.0, prev_mean, mean_all)
    dur_stats = blend_mean[:, None] + std_all[:, None] * noise
    duration = torch.where(mask, duration * (1.0 - t) + dur_stats * t, zero)
    idx = torch.arange(duration.shape[1], device=duration.device)[None, :]
    inner = mask & (idx >= 1) & (idx <= (n_valid - 3)[:, None])
    n_in = inner.sum(dim=1)
    mean = torch.where(inner, duration, zero).sum(dim=1) / torch.clamp(
        n_in, min=1)
    var = (torch.where(inner, (duration - mean[:, None]) ** 2, zero).sum(dim=1)
           / torch.clamp(n_in - 1, min=1))  # ddof=1 (torch/numpy .std())
    std = torch.sqrt(var)
    z = (duration - mean[:, None]) / torch.where(
        std > 0, std, torch.ones((), device=std.device))[:, None]
    clamp = inner & (torch.abs(z) > 3.0) & ((std > 0) & (n_in >= 2))[:, None]
    repl = mean[:, None] + (torch.sign(duration - mean[:, None])
                            * (3.0 * std * 0.95)[:, None])
    duration = torch.where(clamp, repl, duration)
    duration = duration / torch.clamp(speed, 1e-4, 2.0)
    pred = torch.clamp(torch.round(duration), min=1).to(torch.int32)
    pred = torch.where(mask, pred, torch.zeros((), dtype=torch.int32,
                                               device=pred.device))
    return pred, pred.sum(dim=1, dtype=torch.int32)


def _partition_exact(idxs, sizes, pad_tail: bool = False):
    """Split a work list into groups whose lengths are exactly batch sizes
    (descending greedy over `sizes`, e.g. 6 -> [4, 2]): a padded row costs
    a whole row of vocoder work, one more call only its fixed cost.

    pad_tail: when the sizes do not include 1 (data-parallel mode: every
    batch is a multiple of the rank count), a remainder smaller than the
    smallest size is a last short group, which the caller pads; every
    other group is still exact."""
    out = []
    pos = 0
    remaining = len(idxs)
    while remaining >= min(sizes):
        take = next(s for s in sorted(sizes, reverse=True) if s <= remaining)
        out.append(idxs[pos: pos + take])
        pos += take
        remaining -= take
    if remaining > 0:
        if not pad_tail:
            raise ValueError(
                f"cannot partition {len(idxs)} into sizes {sizes}")
        out.append(idxs[pos:])
    return out


def merge_frame_buckets(by_f: Dict[int, List[int]], max_batch: int,
                        call_ms: float, row_ms_per_frame: float
                        ) -> Dict[int, List[int]]:
    """Merge under-filled frame buckets upward (the JAX engine's rule,
    styletts2_tpu/infer.py `_plan_finish`): walking the buckets in
    ascending order, bucket a's pieces join the next bucket b when
    `calls(a + b) * call_ms + n_a * (b - a) * row_ms_per_frame` is below
    `(calls(a) + calls(b)) * call_ms`, calls(n) = ceil(n / max_batch).
    A frame bucket is padding only (the alignment zero-pads, the audio is
    trimmed to each piece's total), so merging is exact: it trades padded
    rows for fewer phase-2 calls. Returns a new {bucket: pieces} dict."""
    by_f = {k: list(v) for k, v in by_f.items()}
    fbs = sorted(by_f)

    def calls(n):
        return -(-n // max_batch)

    for a, b in zip(fbs, fbs[1:]):
        na, nb = len(by_f[a]), len(by_f[b])
        before = (calls(na) + calls(nb)) * call_ms
        after = calls(na + nb) * call_ms + na * (b - a) * row_ms_per_frame
        if after < before:
            by_f[b] = by_f[b] + by_f.pop(a)
    return by_f


class _HostCopy:
    """A device tensor's copy to the host, started when it is made: on CUDA
    into pinned memory on a copy stream that waits only for the work
    issued so far, so the copy overlaps whatever is issued after it; on
    the CPU the tensor itself. get() waits for this copy alone."""

    def __init__(self, buf: torch.Tensor, stream=None):
        self.event = None
        if stream is None:
            self.host = buf
        else:
            self.host = torch.empty(buf.shape, dtype=buf.dtype,
                                    pin_memory=True)
            stream.wait_stream(torch.cuda.current_stream(buf.device))
            with torch.cuda.stream(stream):
                self.host.copy_(buf, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(stream)
            buf.record_stream(stream)
        self._array: Optional[np.ndarray] = None

    def get(self) -> np.ndarray:
        if self._array is None:
            if self.event is not None:
                self.event.synchronize()
            self._array = self.host.numpy()
        return self._array


class _FusedGraph:
    """One captured `_fused_impl` at batch 1 on a (token, frame) bucket pair:
    static device inputs and outputs, pinned host copies of the outputs,
    and what the capture recorded."""

    def __init__(self, graph, inputs, pcm, total, launches, peak_bytes,
                 pool_growth_bytes, capture_ms, background):
        self.graph = graph
        self.inputs = inputs
        self.pcm = pcm
        self.total = total
        self.pcm_host = torch.empty(pcm.shape, dtype=pcm.dtype,
                                    pin_memory=True)
        self.total_host = torch.empty(total.shape, dtype=total.dtype,
                                      pin_memory=True)
        # kernel launches recorded in the graph (one replay's), by
        # wrapper name: the capturing thread's launches only
        self.launches = launches
        # peak bytes allocated while capturing, and how much the shared
        # graph pool grew; None for a background capture (the device-wide
        # memory stats would take in the serving thread's allocations)
        self.peak_bytes = peak_bytes
        self.pool_growth_bytes = pool_growth_bytes
        # wall ms of the eager warm-up call and the capture, and whether
        # the capture ran on the background thread
        self.capture_ms = capture_ms
        self.background = background


class StyleTTS2:
    """Zero-shot TTS engine on one device (CUDA by default), or over the
    ranks of a mesh."""

    def __init__(self, config, models_path: Optional[str] = None, *,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 decoder_dtype: Optional[str] = None, device="cuda",
                 mesh=None, seq_parallel: bool = False):
        """config: a Config or a YAML path. Weights: `params` ({module:
        numpy tree}, e.g. the JAX package's build_model output), else the
        `net` of the native .ckpt at `models_path`, else seeded random
        weights. device: "cuda" (the default) raises when no GPU is
        present; "cpu" must be asked for and runs the kernels' plain
        versions, with no graphs.

        mesh (parallel.make_mesh; every rank builds the engine with the
        same arguments and makes the same calls): the data-parallel
        engine. Batches are (n, 2n, 4n) rows for n ranks; each rank runs
        its rows of every phase-1 and phase-2 call and the rows are
        gathered, so every rank carries on with the whole batch (its host
        glue and RNG streams stay identical) and returns every waveform.
        The fused graph path is off, so phase 2 runs eagerly (kernel B1
        on every rank). The engine runs on the mesh's device, whose type
        `device` must name.

        seq_parallel (needs a mesh; all three decoders): shard the
        vocoder's FRAME axis over the ranks instead of the batch
        (parallel/seqpar.py): one long chunk's decode latency. Batching is
        the single-device engine's (inputs replicated); a frame bucket
        decodes frame-sharded when it divides by the rank count into at
        least max(32, the receptive field) frames per rank, else whole on
        every rank (a warning at init lists those buckets)."""
        if mesh is not None:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"StyleTTS2(device={device!r}) on a mesh "
                                 f"of {mesh.device} ranks")
            device = mesh.device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StyleTTS2(device='cuda'): no CUDA device is "
                               "available; pass device='cpu' to run on CPU")
        # f32 parity with the JAX package's true-f32 convs and matmuls:
        # cuDNN convolutions default to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg: Config = (config if isinstance(config, Config)
                            else load_config(config))
        mp = self.cfg.model_params
        self.symbol_dict = build_symbol_dict(self.cfg.symbol)
        self.cleaner = TextCleaner(self.symbol_dict, debug=self.cfg.debug)
        self.sr = self.cfg.preprocess_params.sr
        self.hop = self.cfg.preprocess_params.spect_params.hop_length
        self.ref_s: Optional[torch.Tensor] = None
        self._rng = np.random.default_rng(seed)
        # every token gets exactly this many frames when set (bypasses the
        # duration head): deterministic lengths for tests and load tests
        self.fixed_duration: Optional[int] = None
        # global multiplier on the duration head's raw output
        self.duration_scale: Optional[float] = None
        # observed frames per token (see _observe_rate): sizes the fused
        # path's frame bucket
        self._fpt_ema: Optional[float] = None
        # single-chunk texts take the fused path; False forces two phases
        self.fused_enabled: bool = True
        self.mesh = mesh
        self.seq_parallel = bool(seq_parallel)
        self.batch_buckets: Tuple[int, ...] = BATCH_BUCKETS
        if self.seq_parallel:
            if mesh is None:
                raise ValueError("seq_parallel requires a mesh")
            from styletts2_tpu_torch.parallel import seqpar as SP

            self._sp_margin = max(SP.DEFAULT_MARGIN,
                                  SP.decoder_receptive_field(mp.decoder))
            n = mesh.size
            skipped = [fb for fb in self.cfg.tpu.frame_buckets
                       if fb % n or fb // n < self._sp_margin]
            if skipped:
                warnings.warn(
                    f"seq_parallel: frame buckets {skipped} are not "
                    f"divisible by the {n}-rank mesh (or are < n * margin "
                    f"{n * self._sp_margin}) and will decode whole on every "
                    f"rank; set tpu.frame_buckets to multiples of {n} to "
                    "cover them")
        elif mesh is not None:
            # every batch divides over the ranks
            self.batch_buckets = (mesh.size, 2 * mesh.size, 4 * mesh.size)
        self.max_batch: int = self.batch_buckets[-1]
        self.dtype = (torch.bfloat16 if (decoder_dtype or
                                         self.cfg.tpu.decoder_dtype)
                      == "bfloat16" else torch.float32)
        # phase-2 evaluations run eagerly (two-phase calls and eager fused
        # calls, the background thread's included; graph captures and
        # replays are not among them), and fused-graph replays; a replay
        # adds its recorded launches to ops/launch_count
        self.phase2_calls = 0
        self.graph_replays = 0
        self._count_lock = threading.Lock()
        # (token bucket, frame bucket) -> _FusedGraph; every graph
        # allocates from one pool (see _capture_fused)
        self.graphs: Dict[Tuple[int, int], _FusedGraph] = {}
        self._graph_pool = None
        self._capture_lock = threading.Lock()
        # "sync": a cold (token, frame) pair is captured (CUDA) or run
        # (CPU) in the request; "async": the request takes the two-phase
        # path and the pair is captured on a background thread
        self.fused_compile: str = "sync"
        self._fused_ready: set = set()
        self._fused_pending: set = set()
        self._fused_failed: set = set()
        self._fused_errors: List[BaseException] = []
        self._fused_queue: Optional[queue.Queue] = None
        self._fused_thread: Optional[threading.Thread] = None
        # device-to-host copies of the two-phase path (see _HostCopy)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

        self.modules = build_inference_modules(mp)
        if params is None and models_path:
            # a native .ckpt or a reference .pth
            params = W.load_checkpoint_net(models_path)
        if params is not None:
            W.load_param_tree(self.modules, params, decoder_dtype=self.dtype)
        else:
            W.init_random(self.modules, torch.Generator().manual_seed(seed))
            self.modules["decoder"].prepack(self.dtype)
        self.modules.to(self.device).eval()

    # ------------------------------------------------------------------
    # the device phases
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _style(self, wav: np.ndarray) -> torch.Tensor:
        """(B, T) waveform -> (B, style_dim)."""
        sp = self.cfg.preprocess_params.spect_params
        mel = OPS.preprocess_wave(
            torch.as_tensor(np.ascontiguousarray(wav, np.float32),
                            device=self.device),
            sr=self.sr, n_fft=sp.n_fft, win_length=sp.win_length,
            hop_length=self.hop, n_mels=self.cfg.model_params.n_mels)
        return self.modules["style_encoder"](mel)

    @torch.inference_mode()
    def _phase1(self, tokens: torch.Tensor, mask: torch.Tensor,
                s: torch.Tensor):
        """`_phase1_impl` under inference mode."""
        return self._phase1_impl(tokens, mask, s)

    def _phase1_impl(self, tokens: torch.Tensor, mask: torch.Tensor,
                     s: torch.Tensor):
        """tokens (B, Tb) -> (t_en, d, durations (B, Tb) f32); s (1, D) or
        (B, D)."""
        s = s.expand(tokens.shape[0], -1)
        pred = self.modules["predictor"]
        t_en = self.modules["text_encoder"](tokens, mask)
        d = pred.encode_duration(t_en, s, mask)
        duration = torch.sigmoid(pred.duration_head(d, mask)).sum(dim=-1)
        return t_en, d, torch.where(mask, duration,
                                    torch.zeros((), device=duration.device))

    def _phase2_impl(self, t_en: torch.Tensor, d: torch.Tensor,
                     s: torch.Tensor, durs: torch.Tensor,
                     n_frames: int) -> torch.Tensor:
        """durations -> alignment -> F0/N -> decoder -> int16 PCM
        (B, 2 * n_frames * hop); s (1, D) or (B, D)."""
        s = s.expand(t_en.shape[0], -1)
        asr, f0, n_en, frame_mask = self._prosody(t_en, d, s, durs, n_frames)
        return self._decode(asr, f0, n_en, s, frame_mask)

    def _prosody(self, t_en, d, s, durs, n_frames: int):
        """The alignment products and the F0/N predictor: (asr, F0, N,
        frame mask) for the decoder; s (B, D)."""
        align_t = ALN.build_alignment(durs, n_frames).transpose(1, 2)
        total = durs.sum(dim=1)
        frame_mask = (torch.arange(n_frames, device=durs.device)[None, :]
                      < total[:, None])
        mel_mask = torch.repeat_interleave(frame_mask, 2, dim=1)
        en = torch.matmul(align_t, d)
        f0, n_en = self.modules["predictor"].f0n(en, s, mask=frame_mask,
                                                 out_mask=mel_mask)
        asr = torch.matmul(align_t, t_en)
        return asr, f0, n_en, frame_mask

    def _decode(self, asr, f0, n_en, s, frame_mask) -> torch.Tensor:
        """The decoder in the engine's dtype -> int16 PCM; frame-sharded
        over the ranks (parallel/seqpar.py) under seq_parallel when the
        frame bucket qualifies."""
        dt = self.dtype
        n_frames = frame_mask.shape[1]
        if (self.seq_parallel and n_frames % self.mesh.size == 0
                and n_frames // self.mesh.size >= self._sp_margin):
            from styletts2_tpu_torch.parallel import seqpar as SP

            wav = SP.sp_decoder_apply(
                self.mesh, self.modules["decoder"], asr.to(dt), f0.float(),
                n_en.float(), s.to(dt), margin=self._sp_margin,
                n_valid=frame_mask.sum(dim=1))
        else:
            wav = self.modules["decoder"](asr.to(dt), f0.float(),
                                          n_en.float(), s.to(dt), frame_mask)
        pcm = torch.clamp(wav[..., 0].float(), -1.0, 1.0) * 32767.0
        return pcm.to(torch.int16)

    def _count_eval(self) -> None:
        with self._count_lock:  # the capture thread counts too
            self.phase2_calls += 1

    @property
    def _dp(self) -> bool:
        """Data-parallel mode: a mesh, and its ranks split batch rows."""
        return self.mesh is not None and not self.seq_parallel

    @torch.inference_mode()
    def _run_phase1(self, tokens, mask, s):
        """_phase1 on the batch; data-parallel: on this rank's rows, then
        every rank's rows gathered."""
        if not self._dp:
            return self._phase1(tokens, mask, s)
        rows = self.mesh.rows(tokens.shape[0])
        return tuple(self.mesh.gather_rows(
            list(self._phase1(tokens[rows], mask[rows], s))))

    @torch.inference_mode()
    def _phase2(self, t_en, d, s, durs, n_frames: int) -> torch.Tensor:
        """One counted phase-2 evaluation; data-parallel: of this rank's
        rows, then every rank's PCM rows gathered."""
        self._count_eval()
        if not self._dp:
            return self._phase2_impl(t_en, d, s, durs, n_frames)
        rows = self.mesh.rows(t_en.shape[0])
        return self.mesh.gather_rows([self._phase2_impl(
            t_en[rows], d[rows], s, durs[rows], n_frames)])[0]

    def _fused_impl(self, tokens, mask, s, scal, noise, n_frames: int):
        """Single-dispatch synthesis: tokens -> (pcm int16 (B, 2 *
        n_frames * hop), total int32 (B,)) with the durations post-processed
        on the device. scal: (6,) f32 [speed, fixed_flag, fixed_value,
        dur_scale, t, prev_mean]; noise: (B, Tb) standard normals for the
        stabilisation blend. No host sync, so a CUDA graph captures it."""
        t_en, d, duration = self._phase1(tokens, mask, s)
        pred_dur, total = _device_postprocess_durations(
            duration, mask, scal[0], scal[1], scal[2], scal[3], scal[4],
            scal[5], noise)
        return self._phase2_impl(t_en, d, s, pred_dur, n_frames), total

    @torch.inference_mode()
    def _fused(self, tokens, mask, s, scal, noise, n_frames: int):
        """`_fused_impl` run eagerly (the CPU path, and the reference a
        graph's replay is held against)."""
        self._count_eval()
        return self._fused_impl(tokens, mask, s, scal, noise, n_frames)

    # ------------------------------------------------------------------
    # CUDA graphs of the fused path
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _capture_fused(self, tb: int, fb: int,
                       background: bool = False) -> _FusedGraph:
        """Capture `_fused_impl` at batch 1 on (tb, fb) into a CUDA graph
        after one eager warm-up call (cuDNN plans, kernel loads, cached
        constants), both on a side stream, in thread-local capture mode:
        another thread may launch, allocate and sync on its own streams
        meanwhile without breaking or joining the capture. The graph's
        launch counts are the capturing thread's alone
        (launch_count.recording). Captures run one at a time (a lock).

        Every graph allocates from one shared pool. A capture may reuse a
        block another graph uses while it replays, which is safe because a
        capture runs no kernel, and replays run one at a time on the
        serving thread's stream, each synced before the next. background:
        the caller is the capture thread, so the device-wide memory stats
        (and the sync and cache release that isolate them) are skipped. A
        failed capture raises: there is no eager fallback."""
        dev = self.device
        with self._capture_lock:
            t0 = time.perf_counter()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                inputs = dict(
                    tokens=torch.zeros(1, tb, dtype=torch.int64, device=dev),
                    mask=torch.ones(1, tb, dtype=torch.bool, device=dev),
                    s=torch.zeros(1, self.cfg.model_params.style_dim,
                                  device=dev),
                    scal=torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                                      device=dev),
                    noise=torch.zeros(1, tb, device=dev))
                self._fused(**inputs, n_frames=fb)
            side.synchronize()
            if not background:
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                allocated = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            graph = torch.cuda.CUDAGraph()
            pool = () if self._graph_pool is None else (self._graph_pool,)
            with torch.cuda.stream(side), LC.recording() as launches:
                graph.capture_begin(*pool, capture_error_mode="thread_local")
                try:
                    pcm, total = self._fused_impl(**inputs, n_frames=fb)
                finally:
                    graph.capture_end()
            if self._graph_pool is None:
                self._graph_pool = graph.pool()
            peak = growth = None
            if not background:
                peak = torch.cuda.max_memory_allocated(dev) - allocated
                growth = torch.cuda.memory_reserved(dev) - reserved
            g = _FusedGraph(graph, inputs, pcm, total, launches=launches,
                            peak_bytes=peak, pool_growth_bytes=growth,
                            capture_ms=(time.perf_counter() - t0) * 1e3,
                            background=background)
            self.graphs[(tb, fb)] = g
            self._fused_ready.add((tb, fb))
        return g

    def _enqueue_fused_capture(self, tb: int, fb: int) -> None:
        """Queue the (tb, fb) pair for the background thread (fused_compile
        == "async"): on CUDA it captures the pair's graph, on the CPU it
        runs one eager `_fused` call; then the pair is ready. A failure is
        kept for `wait_fused_compiles` to raise, and the pair stays on the
        two-phase path."""
        key = (tb, fb)
        if key in self._fused_pending or key in self._fused_ready:
            return
        self._fused_pending.add(key)
        if self._fused_thread is None:
            self._fused_queue = queue.Queue()
            self._fused_thread = threading.Thread(
                target=self._fused_worker, name="fused-capture", daemon=True)
            self._fused_thread.start()
        self._fused_queue.put(key)

    def _fused_worker(self) -> None:
        while True:
            key = self._fused_queue.get()
            try:
                # grad mode and the current device are per thread
                with torch.inference_mode():
                    if self.device.type == "cuda":
                        with torch.cuda.device(self.device):
                            self._capture_fused(*key, background=True)
                    else:
                        tb, fb = key
                        self._fused(
                            torch.zeros(1, tb, dtype=torch.int64),
                            torch.ones(1, tb, dtype=torch.bool),
                            torch.zeros(1, self.cfg.model_params.style_dim),
                            torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]),
                            torch.zeros(1, tb), n_frames=fb)
                        self._fused_ready.add(key)
            except Exception as e:  # the request path keeps serving
                self._fused_failed.add(key)
                self._fused_errors.append(e)
                warnings.warn(f"background fused capture {key} failed: "
                              f"{e!r}")
            finally:
                self._fused_pending.discard(key)
                self._fused_queue.task_done()

    def wait_fused_compiles(self) -> None:
        """Block until every queued background capture has finished, then
        re-raise the first one that failed (its pair stays on the
        two-phase path)."""
        if self._fused_queue is not None:
            self._fused_queue.join()
        if self._fused_errors:
            err = self._fused_errors[0]
            self._fused_errors = []
            raise RuntimeError(f"a background fused capture failed: "
                               f"{err!r}") from err

    @torch.inference_mode()
    def _replay_fused(self, tokens: np.ndarray, mask: np.ndarray, s,
                      scal: np.ndarray, noise: np.ndarray, fb: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Copy the inputs into the (tb, fb) graph's buffers (capturing it
        at first use), replay it, start both outputs' copies to pinned host
        buffers and sync once. Returns (pcm (1, 2 fb hop) int16, total
        (1,) int32) as numpy views of the pinned buffers (valid until the
        next replay of this graph)."""
        key = (tokens.shape[1], fb)
        g = self.graphs.get(key) or self._capture_fused(*key)
        inp = g.inputs
        for name, arr in (("tokens", tokens), ("mask", mask),
                          ("scal", scal), ("noise", noise)):
            inp[name].copy_(torch.from_numpy(arr), non_blocking=True)
        inp["s"].copy_(self._style_row(s), non_blocking=True)
        g.graph.replay()
        self.graph_replays += 1
        LC.add_recorded(g.launches)
        g.pcm_host.copy_(g.pcm, non_blocking=True)
        g.total_host.copy_(g.total, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return g.pcm_host.numpy(), g.total_host.numpy()

    # ------------------------------------------------------------------
    # style computation
    # ------------------------------------------------------------------

    def compute_style(self, path_or_wave, denoise: float = 0.3,
                      split_dur: int = 3) -> torch.Tensor:
        """Reference clip (path or waveform) -> (1, style_dim) style: the
        mean over 3-s windows (plus a >= 1-s tail window) for clips of
        4 s or more, one whole-second window otherwise."""
        denoise = min(denoise, 1.0)
        if split_dur != 0:
            split_dur = max(int(split_dur), 1)
        sr = self.sr
        if isinstance(path_or_wave, str):
            wave, in_sr = AUD.read_audio(path_or_wave)  # WAV or FLAC
            wave = AUD.resample(wave, in_sr, sr)
        else:
            wave = np.asarray(path_or_wave, dtype=np.float32)
        audio, _ = AUD.trim_silence(wave, top_db=30)
        audio = audio[: sr * 20]  # cap 20 s
        if denoise > 0.0:
            audio = AUD.maybe_denoise(audio, sr, denoise)

        if split_dur > 0 and len(audio) / sr >= 4:
            jump = sr * split_dur
            n_full = len(audio) // jump
            chunks = audio[: n_full * jump].reshape(n_full, jump)
            ref_s = self._style(chunks).sum(dim=0, keepdim=True)
            count = n_full
            left = len(audio) - n_full * jump
            if left >= sr:  # a leftover of >= 1 s counts
                secs = left // sr
                tail = audio[n_full * jump: n_full * jump + secs * sr]
                ref_s = ref_s + self._style(tail[None])
                count += 1
            return ref_s / count
        secs = max(1, len(audio) // sr)
        return self._style(audio[: secs * sr][None])

    def get_styles(self, speaker: Dict[str, Any], denoise: float = 0.3,
                   avg_style: bool = True, load_styles: bool = False
                   ) -> Dict[str, Any]:
        if not load_styles:
            self.ref_s = self.compute_style(speaker["path"], denoise,
                                            3 if avg_style else 0)
        elif self.ref_s is None:
            raise RuntimeError("Have to compute or load the styles first!")
        return {"style": self.ref_s, "path": speaker.get("path"),
                "speed": speaker.get("speed", 1.0)}

    def save_styles(self, save_path: str) -> None:
        if self.ref_s is None:
            raise RuntimeError("Have to compute the styles before saving.")
        np.save(save_path, self.ref_s.cpu().numpy())

    def load_styles(self, save_path: str) -> None:
        self.ref_s = torch.as_tensor(np.load(save_path), dtype=torch.float32,
                                     device=self.device)

    # ------------------------------------------------------------------
    # host helpers
    # ------------------------------------------------------------------

    def _style_row(self, ref_s) -> torch.Tensor:
        """A style (tensor or array, any leading shape) as (1, D) f32 on
        the engine's device."""
        if not isinstance(ref_s, torch.Tensor):
            ref_s = torch.from_numpy(np.array(ref_s, np.float32))
        return ref_s.to(self.device, torch.float32).reshape(1, -1)

    def _put(self, arrays: List[np.ndarray]) -> List[torch.Tensor]:
        """Integer host arrays -> int64 device tensors of the same shapes,
        in one host-to-device copy."""
        flat = np.concatenate([np.asarray(a, np.int64).ravel()
                               for a in arrays])
        dev = torch.from_numpy(flat).to(self.device, non_blocking=True)
        out, pos = [], 0
        for a in arrays:
            out.append(dev[pos: pos + a.size].view(a.shape))
            pos += a.size
        return out

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------

    def _postprocess_durations(self, duration: np.ndarray, speed: float,
                               prev_d_mean: float, t: float,
                               rng: np.random.Generator
                               ) -> Tuple[np.ndarray, float]:
        """Host duration glue: fixed/scaled durations, stochastic rate
        stabilisation, outlier clamp, speed, rounding. Returns (pred_dur
        int32, the mean that chains into the next chunk)."""
        if self.fixed_duration is not None:
            duration = np.full(len(duration), float(self.fixed_duration),
                               np.float32)
            t = 0.0
        elif self.duration_scale is not None:
            duration = duration * self.duration_scale
        if t > 0:
            mean = prev_d_mean if prev_d_mean != 0 else duration.mean()
            dur_stats = rng.normal(mean, duration.std(), size=duration.shape)
            duration = duration * (1 - t) + dur_stats * t
        duration = np.array(duration)
        duration[1:-2] = _replace_outliers_zscore(duration[1:-2])
        duration = duration / min(max(speed, 1e-4), 2.0)
        new_d_mean = float(duration.mean())
        pred_dur = np.clip(np.round(duration), 1, None).astype(np.int32)
        # a single token longer than the largest bucket cannot be split at
        # a token boundary: clamp it (only absurd speeds reach this)
        pred_dur = np.minimum(pred_dur, self.cfg.tpu.frame_buckets[-1])
        return pred_dur, new_d_mean

    def _synthesize_chunks(self, sentences: List[str], ref_s, speed: float,
                           prev_d_mean: float, t: float,
                           chain_of: Optional[List[int]] = None,
                           base_seed: Optional[int] = None
                           ) -> Tuple[List[np.ndarray], List[float],
                                      List[int]]:
        """Two-phase synthesis of many chunks (see _synthesize_plan).
        Returns (each chunk's float waveform, its duration mean, the input
        sentence it came from)."""
        wav_parts_of, means, origin = self._synthesize_plan(
            sentences, ref_s, speed, prev_d_mean, t, chain_of,
            base_seed=base_seed)
        return self._fetch_all(wav_parts_of), means, origin

    def _synthesize_plan(self, sentences: List[str], ref_s, speed: float,
                         prev_d_mean: float, t: float,
                         chain_of: Optional[List[int]] = None,
                         base_seed: Optional[int] = None):
        """Issue the whole two-phase synthesis without fetching audio.

        Every phase-1 call is issued, all durations come back in one sync,
        the host glue runs per rate chain (chain_of: per input sentence;
        the stabilisation mean and its noise stream chain only within a
        chain), then every phase-2 call is issued before any audio is
        fetched. base_seed: a seed the caller already drew from the engine
        RNG (the fused path's fallback). Returns (wav_parts_of, means,
        origin): wav_parts_of[i] is chunk i's ordered list of (device
        batch, row, n_frames) pieces; origin[i] the input sentence chunk i
        came from (token-bucket overflow splits a sentence into chunks)."""
        return self._plan_finish(self._plan_phase1(
            sentences, ref_s, speed, prev_d_mean, t, chain_of,
            base_seed=base_seed))

    @torch.inference_mode()
    def _plan_phase1(self, sentences: List[str], ref_s, speed: float,
                     prev_d_mean: float, t: float,
                     chain_of: Optional[List[int]] = None,
                     base_seed: Optional[int] = None) -> Dict[str, Any]:
        """Stage A of _synthesize_plan: split chunks whose tokens overflow
        the largest token bucket (at word boundaries), tokenize, and issue
        one phase-1 call per token bucket, its batch padded up to a batch
        bucket (phase 1's cost is per call: its BiLSTMs are serial). Draws
        base_seed when none is given. Nothing here waits on the device."""
        max_tokens = self.cfg.tpu.token_buckets[-1]
        work: List[str] = []
        origin: List[int] = []
        for src_i, sentence in enumerate(sentences):
            parts = [sentence]
            while parts:
                part = parts.pop(0)
                if (len(self.cleaner(part)) + 2 <= max_tokens
                        or len(part.split()) <= 1):
                    work.append(part)
                    origin.append(src_i)
                else:
                    words = part.split()
                    half = len(words) // 2
                    parts = [" ".join(words[:half]),
                             " ".join(words[half:])] + parts
        n_chunks = len(work)
        tokenized = [tokens_for_sentence(sent, self.cleaner) for sent in work]
        tbs = [_bucket(self.cfg.tpu.token_buckets, len(tk))
               for tk in tokenized]
        by_tb: Dict[int, List[int]] = {}
        for i, tb in enumerate(tbs):
            by_tb.setdefault(tb, []).append(i)
        s_dev = self._style_row(ref_s)

        groups, host = [], []
        for tb, idxs in by_tb.items():
            for part in range(0, len(idxs), self.max_batch):
                group = idxs[part: part + self.max_batch]
                bb = _bucket(self.batch_buckets, len(group))
                tokens = np.zeros((bb, tb), np.int64)
                mask = np.zeros((bb, tb), np.int64)
                for row, i in enumerate(group):
                    tokens[row, : len(tokenized[i])] = tokenized[i]
                    mask[row, : len(tokenized[i])] = 1
                groups.append(group)
                host += [tokens, mask]
        dev = self._put(host)
        t_en_of: List[Any] = [None] * n_chunks
        d_of: List[Any] = [None] * n_chunks
        dur_of: List[Any] = [None] * n_chunks
        for gi, group in enumerate(groups):
            t_en, d, dur = self._run_phase1(dev[2 * gi],
                                            dev[2 * gi + 1].bool(), s_dev)
            dur = _HostCopy(dur, self._copy_stream)
            for row, i in enumerate(group):
                t_en_of[i] = (t_en, row)
                d_of[i] = (d, row)
                dur_of[i] = (dur, row)
        if base_seed is None:
            # drawn here, so pipelined batches consume the engine RNG in
            # plan order
            base_seed = int(self._rng.integers(2 ** 63))
        return dict(origin=origin, tokenized=tokenized, tbs=tbs,
                    t_en_of=t_en_of, d_of=d_of, dur_of=dur_of, s_dev=s_dev,
                    speed=speed, prev_d_mean=prev_d_mean, t=t,
                    chain_of=chain_of, base_seed=base_seed)

    @torch.inference_mode()
    def _plan_finish(self, st: Dict[str, Any]):
        """Stage B of _synthesize_plan: one sync for every duration, the
        host glue per chain, pieces, frame-bucket groups and the phase-2
        calls."""
        origin, tokenized, tbs = st["origin"], st["tokenized"], st["tbs"]
        t_en_of, d_of, dur_of = st["t_en_of"], st["d_of"], st["dur_of"]
        chain_of, base_seed = st["chain_of"], st["base_seed"]
        n_chunks = len(tokenized)

        means: List[float] = []
        chain_mean: Dict[int, float] = {}
        chain_rng: Dict[int, np.random.Generator] = {}
        pred_of: List[np.ndarray] = []
        for i in range(n_chunks):
            copy, row = dur_of[i]
            duration = copy.get()[row, : len(tokenized[i])]
            chain = chain_of[origin[i]] if chain_of is not None else 0
            if chain not in chain_rng:
                # one noise stream per chain: a text's stabilised durations
                # do not depend on the texts that share its batch
                chain_rng[chain] = np.random.default_rng([base_seed, chain])
            prev = chain_mean.get(chain, st["prev_d_mean"])
            pred_dur, new_mean = self._postprocess_durations(
                duration, st["speed"], prev, st["t"], chain_rng[chain])
            chain_mean[chain] = new_mean
            means.append(new_mean)
            pred_of.append(pred_dur)
        if self.fixed_duration is None and pred_of:
            # the rounded, min-1 durations: the fused graph's total counts
            # the same units
            self._observe_rate(float(np.mean([p.mean() for p in pred_of])))

        # pieces: spans of each chunk whose frames fit the largest bucket
        max_frames = self.cfg.tpu.frame_buckets[-1]
        piece_chunk: List[int] = []
        piece_span: List[Tuple[int, int]] = []
        piece_total: List[int] = []
        pieces_of: List[List[int]] = [[] for _ in range(n_chunks)]
        for i in range(n_chunks):
            for a, b in _split_spans(pred_of[i], max_frames):
                pieces_of[i].append(len(piece_chunk))
                piece_chunk.append(i)
                piece_span.append((a, b))
                piece_total.append(int(pred_of[i][a:b].sum()))

        # one phase-2 call per frame bucket group; the token axis is padded
        # to the group's largest bucket (zero-duration tokens add nothing
        # to the alignment products)
        by_f: Dict[int, List[int]] = {}
        for p in range(len(piece_chunk)):
            by_f.setdefault(_bucket(self.cfg.tpu.frame_buckets,
                                    piece_total[p]), []).append(p)
        by_f = merge_frame_buckets(by_f, self.max_batch, PHASE2_CALL_MS,
                                   PHASE2_ROW_MS_PER_FRAME)

        calls, host = [], []
        for fb, idxs in by_f.items():
            # data-parallel: exact groups, then the remainder padded with
            # copies of its last row up to the smallest batch that fits
            for group in _partition_exact(idxs, self.batch_buckets,
                                          pad_tail=self._dp):
                bb = _bucket(self.batch_buckets, len(group))
                rows_of = list(group) + [group[-1]] * (bb - len(group))
                tb = max(tbs[piece_chunk[p]] for p in group)
                srcs = [t_en_of[piece_chunk[p]] for p in rows_of]
                whole = all(piece_span[p] == (0, len(pred_of[piece_chunk[p]]))
                            for p in rows_of)
                if (whole and srcs[0][0].shape[0] == bb
                        and all(x[0] is srcs[0][0] for x in srcs)
                        and [x[1] for x in srcs] == list(range(bb))):
                    # the group is one phase-1 batch, in order: no gather
                    t_en = srcs[0][0]
                    d = d_of[piece_chunk[group[0]]][0]
                else:
                    def rows(of):
                        out = []
                        for p in rows_of:
                            buf, row = of[piece_chunk[p]]
                            a, b = piece_span[p]
                            out.append(F.pad(buf[row, a:b],
                                             (0, 0, 0, tb - (b - a))))
                        return torch.stack(out)
                    t_en, d = rows(t_en_of), rows(d_of)
                durs = np.zeros((bb, tb), np.int64)
                for row, p in enumerate(rows_of):
                    a, b = piece_span[p]
                    durs[row, : b - a] = pred_of[piece_chunk[p]][a:b]
                calls.append((fb, group, t_en, d))
                host.append(durs)
        wav_of_piece: List[Any] = [None] * len(piece_chunk)
        if host:
            for (fb, group, t_en, d), durs in zip(calls, self._put(host)):
                wav = _HostCopy(self._phase2(t_en, d, st["s_dev"],
                                             durs.int(), fb),
                                self._copy_stream)
                for row, p in enumerate(group):
                    wav_of_piece[p] = (wav, row)
        wav_parts_of = [[wav_of_piece[p] + (piece_total[p],)
                         for p in pieces_of[i]] for i in range(n_chunks)]
        return wav_parts_of, means, origin

    def _fetch_chunk(self, wav_parts_of, i: int) -> np.ndarray:
        """Chunk i's waveform, its pieces concatenated (waits for its
        pieces' copies only)."""
        segs = [copy.get()[row, : total * 2 * self.hop]
                for copy, row, total in wav_parts_of[i]]
        return np.concatenate(segs).astype(np.float32) / 32767.0

    def _fetch_all(self, wav_parts_of) -> List[np.ndarray]:
        """Every chunk's waveform (every copy started when its phase-2 call
        was issued)."""
        return [self._fetch_chunk(wav_parts_of, i)
                for i in range(len(wav_parts_of))]

    @staticmethod
    def _with_edges(mid: np.ndarray) -> np.ndarray:
        z = np.zeros(4000, np.float32)
        return np.concatenate([z, mid, z])

    def generate(self, phonem: str, style: Dict[str, Any],
                 stabilize: bool = True, n_merge: int = 16) -> np.ndarray:
        """Long-form synthesis: sentence chunking, rate stabilisation,
        4000-sample edge trims and silence padding per chunk. A single
        chunk takes the fused path while `fused_enabled` is set and the
        engine has no mesh."""
        smooth = 0.2 if stabilize else 0.0
        chunks = split_into_chunks(phonem, n_merge=n_merge)
        if not chunks:
            return np.zeros(8000, np.float32)
        wav, base_seed = self._try_fused(chunks, style, smooth)
        if wav is not None:
            return wav
        wavs, _, _ = self._synthesize_chunks(chunks, style["style"],
                                             style.get("speed", 1.0), 0.0,
                                             smooth, base_seed=base_seed)
        return self._with_edges(np.concatenate([w[4000:-4000] for w in wavs]))

    def _try_fused(self, chunks: List[str], style: Dict[str, Any],
                   t: float) -> Tuple[Optional[np.ndarray], Optional[int]]:
        """(the edged waveform or None, base_seed): a single chunk goes
        through the fused path while `fused_enabled` is set, without a
        mesh (as in JAX: the mesh engines run two-phase). One seed draw
        per synthesis whichever path runs: the fused attempt and its
        two-phase fallback share it (None: the plan draws it)."""
        if len(chunks) != 1 or not self.fused_enabled or self.mesh is not None:
            return None, None
        base_seed = int(self._rng.integers(2 ** 63))
        wav = self._generate_fused(chunks[0], style, t=t, base_seed=base_seed)
        if wav is None:
            return None, base_seed
        return self._with_edges(wav[4000:-4000]), base_seed

    def _generate_fused(self, sentence: str, style: Dict[str, Any],
                        t: float = 0.0, base_seed: Optional[int] = None
                        ) -> Optional[np.ndarray]:
        """One-dispatch single-chunk synthesis (see _fused_impl): a graph
        replay on CUDA, an eager call on the CPU. Returns None when the
        chunk overflows the largest token bucket or its frames overflow
        the chosen frame bucket; the caller then runs the two-phase path.
        The stabilisation noise is the draws the two-phase plan's chain 0
        makes (default_rng([base_seed, 0])), so both paths give the same
        durations for the same seed."""
        tk = tokens_for_sentence(sentence, self.cleaner)
        fbs = self.cfg.tpu.frame_buckets
        try:
            tb = _bucket(self.cfg.tpu.token_buckets, len(tk))
        except ValueError:
            return None
        if self.fixed_duration is not None:
            need = int(self.fixed_duration) * len(tk)  # exact
        elif self._fpt_ema is not None:
            # observed speaking rate + 35% headroom: a wrong guess costs
            # masked vocoder rows, or the fallback on overflow
            need = int(np.ceil(len(tk) * self._fpt_ema * 1.35))
        else:
            need = 8 * len(tk)  # first call: a generous prior
        if need > fbs[-1]:
            return None
        fb = _bucket(fbs, max(need, 1))
        if self.fused_compile == "async" and (tb, fb) not in self._fused_ready:
            # this request takes the two-phase path; the pair's graph is
            # captured in the background for the next one
            if (tb, fb) not in self._fused_failed:
                self._enqueue_fused_capture(tb, fb)
            return None
        tokens = np.zeros((1, tb), np.int64)
        tokens[0, : len(tk)] = tk
        mask = np.zeros((1, tb), bool)
        mask[0, : len(tk)] = True
        fixed = self.fixed_duration
        scale = self.duration_scale
        t_eff = 0.0 if fixed is not None else t  # the host glue zeroes t
        noise = np.zeros((1, tb), np.float32)
        if t_eff > 0:
            chain_rng = np.random.default_rng([base_seed, 0])
            noise[0, : len(tk)] = chain_rng.normal(0.0, 1.0, size=len(tk))
        scal = np.array([style.get("speed", 1.0),
                         0.0 if fixed is None else 1.0,
                         0.0 if fixed is None else fixed,
                         1.0 if scale is None else scale,
                         t_eff, 0.0], np.float32)
        if self.device.type == "cuda":
            pcm, total = self._replay_fused(tokens, mask, style["style"],
                                            scal, noise, fb)
        else:
            pcm, total = self._fused(
                torch.from_numpy(tokens), torch.from_numpy(mask),
                self._style_row(style["style"]), torch.from_numpy(scal),
                torch.from_numpy(noise), n_frames=fb)
            pcm, total = pcm.numpy(), total.numpy()
            self._fused_ready.add((tb, fb))
        n = int(total[0])
        if self.fixed_duration is None:
            # the total is the true frame count even on overflow
            self._observe_rate(n / max(len(tk), 1))
        if n > fb:
            return None
        return pcm[0, : n * 2 * self.hop].astype(np.float32) / 32767.0

    def _observe_rate(self, frames_per_token: float) -> None:
        """Update the speaking-rate estimate that sizes the fused path's
        frame bucket: an EMA for small drift, a snap to the observation
        when it is more than 25% off (a new voice or speed converges in one
        call instead of walking through every bucket between)."""
        if (self._fpt_ema is None or frames_per_token > 1.25 * self._fpt_ema
                or frames_per_token < 0.8 * self._fpt_ema):
            self._fpt_ema = frames_per_token
        else:
            self._fpt_ema = 0.8 * self._fpt_ema + 0.2 * frames_per_token

    def generate_stream(self, phonem: str, style: Dict[str, Any],
                        stabilize: bool = True, n_merge: int = 16):
        """Yield the waveform chunk by chunk as each chunk's audio arrives,
        so playback can start after the first. `np.concatenate` of the
        stream equals `generate` from the same engine state exactly."""
        smooth = 0.2 if stabilize else 0.0
        chunks = split_into_chunks(phonem, n_merge=n_merge)
        if not chunks:
            yield np.zeros(8000, np.float32)
            return
        wav, base_seed = self._try_fused(chunks, style, smooth)
        if wav is not None:
            yield wav
            return
        wav_parts_of, _, _ = self._synthesize_plan(
            chunks, style["style"], style.get("speed", 1.0), 0.0, smooth,
            base_seed=base_seed)
        n = len(wav_parts_of)
        z = np.zeros(4000, np.float32)
        for i in range(n):
            seg = self._fetch_chunk(wav_parts_of, i)[4000:-4000]
            if i == 0:
                seg = np.concatenate([z, seg])
            if i == n - 1:
                seg = np.concatenate([seg, z])
            yield seg

    def generate_batch(self, phonems: List[str], style: Dict[str, Any],
                       stabilize: bool = True, n_merge: int = 16
                       ) -> List[np.ndarray]:
        """Synthesize several texts in one batched two-phase pass (shared
        style). Chunks of all texts share the phase calls; each text keeps
        its own rate chain and noise stream, so its audio does not depend
        on the other texts (the seed still advances the engine RNG once
        per call)."""
        return self._batch_assemble(
            self._batch_plan(phonems, style, stabilize, n_merge))

    def _batch_plan(self, phonems: List[str], style: Dict[str, Any],
                    stabilize: bool, n_merge: int):
        """Issue a generate_batch workload without fetching audio."""
        return self._batch_plan_finish(
            self._batch_plan_phase1(phonems, style, stabilize, n_merge))

    def _batch_plan_phase1(self, phonems: List[str], style: Dict[str, Any],
                           stabilize: bool, n_merge: int):
        """Stage A of _batch_plan: chunking and the phase-1 calls, one
        chain per text."""
        smooth = 0.2 if stabilize else 0.0
        flat: List[str] = []
        chain_of: List[int] = []
        for ti, text in enumerate(phonems):
            chunks = split_into_chunks(text, n_merge=n_merge)
            flat.extend(chunks)
            chain_of.extend([ti] * len(chunks))
        if not flat:
            return None, chain_of, len(phonems)
        st = self._plan_phase1(flat, style["style"], style.get("speed", 1.0),
                               0.0, smooth, chain_of)
        return st, chain_of, len(phonems)

    def _batch_plan_finish(self, pre):
        """Stage B of _batch_plan: the duration sync and the phase-2
        calls."""
        st, chain_of, n_texts = pre
        if st is None:
            return None, chain_of, [], n_texts
        wav_parts_of, _, origin = self._plan_finish(st)
        return wav_parts_of, chain_of, origin, n_texts

    def _batch_assemble(self, planned) -> List[np.ndarray]:
        """Fetch a planned batch and assemble each text's waveform."""
        wav_parts_of, chain_of, origin, n_texts = planned
        if wav_parts_of is None:
            return [np.zeros(8000, np.float32) for _ in range(n_texts)]
        wavs = self._fetch_all(wav_parts_of)
        outs: List[np.ndarray] = []
        for ti in range(n_texts):
            ws = [w for i, w in enumerate(wavs) if chain_of[origin[i]] == ti]
            if not ws:
                outs.append(np.zeros(8000, np.float32))
                continue
            outs.append(self._with_edges(
                np.concatenate([w[4000:-4000] for w in ws])))
        return outs

    def serve(self, batches, style: Dict[str, Any], stabilize: bool = True,
              n_merge: int = 16):
        """Pipelined serving: iterate over lists of texts, yield the lists
        of waveforms (generate_batch per list). Batch i+1's phase 1 is
        issued before batch i's durations are synced, and batch i's phase 2
        before batch i-1's audio is fetched, so the device has queued work
        while the host runs the duration glue and the fetches."""
        pre = None       # phase 1 issued, durations not synced
        pending = None   # phase 2 issued, audio not fetched
        for texts in batches:
            nxt = self._batch_plan_phase1(texts, style, stabilize, n_merge)
            if pre is not None:
                planned = self._batch_plan_finish(pre)
                if pending is not None:
                    yield self._batch_assemble(pending)
                pending = planned
            pre = nxt
        if pre is not None:
            planned = self._batch_plan_finish(pre)
            if pending is not None:
                yield self._batch_assemble(pending)
            pending = planned
        if pending is not None:
            yield self._batch_assemble(pending)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, token_buckets=None, frame_buckets=None,
               style_seconds=(1, 3), batch_sizes=None) -> None:
        """Run the style path and phases 1 and 2 once per (batch, bucket)
        asked for (cuDNN plans, kernel loads), and on CUDA capture the
        fused graphs at the frame buckets that 8 and 4 frames per token
        pick for each token bucket (the first-call prior and a typical
        rate; the runtime bucket follows the observed rate, so a first
        fused call can still capture a new pair)."""
        for sec in style_seconds:
            self._style(np.zeros((1, sec * self.sr), np.float32))
        s = torch.zeros(1, self.cfg.model_params.style_dim, device=self.device)
        fbs = self.cfg.tpu.frame_buckets
        for bb in batch_sizes or self.batch_buckets[:1]:
            for tb in token_buckets or self.cfg.tpu.token_buckets[:2]:
                tokens = torch.zeros(bb, tb, dtype=torch.int64,
                                     device=self.device)
                mask = torch.ones(bb, tb, dtype=torch.bool, device=self.device)
                t_en, d, _ = self._run_phase1(tokens, mask, s)
                durs = torch.ones(bb, tb, dtype=torch.int32,
                                  device=self.device)
                for fbk in frame_buckets or fbs[:2]:
                    self._phase2(t_en, d, s, durs, fbk)
                if (bb != 1 or not self.fused_enabled
                        or self.device.type != "cuda"
                        or self.mesh is not None):
                    continue
                for rate in (8, 4):
                    if rate * tb <= fbs[-1]:
                        key = (tb, _bucket(fbs, rate * tb))
                        if key not in self.graphs:
                            self._capture_fused(*key)
