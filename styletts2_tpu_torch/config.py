"""Config system: YAML -> typed dataclasses.

The port's own copy of styletts2_tpu/config.py (same schema, same
defaults), so the torch package imports nothing of the JAX package. The
`tpu:` section keeps its name: the torch engine reads its token_buckets,
frame_buckets and decoder_dtype exactly as the JAX engine does.

Schema-parity with the reference YAML (reference Configs/config_example.yaml:1-95
and utils.recursive_munch utils.py:63-69), but typed instead of Munch-duck-typed,
and extended with TPU-specific knobs (mesh shape, dtype policy, bucketing).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml


@dataclass
class SpectParams:
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300


@dataclass
class PreprocessParams:
    sr: int = 24000
    spect_params: SpectParams = field(default_factory=SpectParams)


@dataclass
class SymbolConfig:
    """Symbol inventory (reference config_example.yaml:17-22).

    The order pad -> punctuation -> letters -> letters_ipa -> extend defines
    the token ids (reference train.py:67-83)."""

    pad: str = "$"
    punctuation: str = ';:,.!?¡¿—…"«»“” '
    letters: str = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    letters_ipa: str = (
        "ɑɐɒæɓʙβɔɕçɗɖ"
        "ðʤəɘɚɛɜɝɞɟʄɡ"
        "ɠɢʛɦɧħɥʜɨɪʝɭ"
        "ɬɫɮʟɱɯɰŋɳɲɴø"
        "ɵɸθœɶʘɹɺɾɻʀʁ"
        "ɽʂʃʈʧʉʊʋⱱʌɣɤ"
        "ʍχʎʏʑʐʒʔʡʕʢǀ"
        "ǁǂǃˈˌːˑʼʴʰʱʲ"
        "ʷˠˤ˞↓↑→↗↘'̩'ᵻ"
    )
    extend: str = ""


@dataclass
class ASRParams:
    input_dim: int = 80
    hidden_dim: int = 256
    n_layers: int = 6
    token_embedding_dim: int = 512


@dataclass
class JDCParams:
    num_class: int = 1
    seq_len: int = 192


@dataclass
class DecoderConfig:
    """Vocoder decoder config; `type` dispatches hifigan/istftnet/vocos
    (reference models.py:535-561)."""

    type: str = "hifigan"
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    upsample_rates: List[int] = field(default_factory=lambda: [10, 5, 3, 2])
    upsample_initial_channel: int = 512
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [20, 10, 6, 4])
    # istftnet / vocos only
    gen_istft_n_fft: int = 20
    gen_istft_hop_size: int = 5
    # vocos only
    intermediate_dim: int = 1536
    num_layers: int = 8


@dataclass
class ModelConfig:
    """model_params (reference config_example.yaml:36-79)."""

    dim_in: int = 64
    hidden_dim: int = 512
    max_conv_dim: int = 512
    n_layer: int = 3
    n_mels: int = 80
    max_dur: int = 50
    style_dim: int = 128
    dropout: float = 0.2
    n_token: int = 178  # len(symbol_dict) + 1, set from SymbolConfig at load time
    ASR_params: ASRParams = field(default_factory=ASRParams)
    JDC_params: JDCParams = field(default_factory=JDCParams)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)


@dataclass
class LossParams:
    lambda_mel: float = 5.0
    lambda_gen: float = 1.0
    lambda_mono: float = 1.0
    lambda_s2s: float = 1.0
    lambda_F0: float = 1.0
    lambda_norm: float = 1.0
    lambda_dur: float = 1.0
    lambda_ce: float = 20.0
    # SLM adversarial loss knobs (upstream StyleTTS2 capability; reference
    # Modules/slmadv.py — dead code there, first-class here).
    lambda_slm: float = 1.0


@dataclass
class SLMAdvParams:
    """SLM (WavLM) adversarial stage — upstream StyleTTS2's slmadv_params
    block (Modules/slmadv.py + second-stage config), opt-in here.

    wavlm_path: local torch state_dict (or native ckpt) for the
    wavlm-base-plus backbone. Required when enabled — training the slmadv
    stage against a randomly initialized WavLM optimizes against noise;
    set allow_random_wavlm=true to opt into that for smoke tests only."""

    enabled: bool = False
    iter: int = 10          # run every `iter` train steps (skip_update)
    scale: float = 0.01     # loss scale (upstream config: 0.01)
    sig: float = 1.5        # soft-alignment gaussian width
    wavlm_path: str = ""
    allow_random_wavlm: bool = False


@dataclass
class OptimizerParams:
    lr: float = 1e-4
    ft_lr: float = 1e-5


@dataclass
class DataParams:
    train_data: str = ""
    val_data: str = ""
    root_path: str = ""


@dataclass
class TrainingStrats:
    freeze_modules: List[str] = field(default_factory=list)
    ignore_modules: List[str] = field(default_factory=list)


@dataclass
class TPUConfig:
    """TPU-native knobs (no reference equivalent)."""

    # Data-parallel mesh axis size; -1 = use all visible devices.
    dp: int = -1
    # Rematerialize (jax.checkpoint) the decoder synthesis and the
    # generator-side discriminator forwards in the G-step backward: the
    # waveform-rate activations that dominate training HBM are recomputed
    # instead of stored, trading ~one extra forward of each for a much
    # smaller live set — enables larger batch_size/max_len per chip.
    remat: bool = False
    # Average each D/G step's gradients over this many micro-batches
    # (batch_size must divide) before the single optimizer update: HBM
    # scales with batch_size/grad_accum. Composes with remat.
    grad_accum: int = 1
    # Compute dtype for the vocoder hot path ("bfloat16" | "float32").
    decoder_dtype: str = "bfloat16"
    # Static-shape buckets used by the inference engine. Frame buckets are
    # ~1.13x-spaced: padding waste (compute AND device->host audio bytes)
    # stays under ~12% while graphs are compiled lazily per bucket actually
    # hit (the persistent compilation cache amortizes across processes).
    token_buckets: Tuple[int, ...] = (32, 64, 96, 128, 192, 256, 384, 512)
    frame_buckets: Tuple[int, ...] = (
        104, 128, 152, 176, 200, 224, 256, 304, 352, 400, 456, 512, 576,
        648, 728, 800, 904, 1000, 1128, 1272, 1448, 1600, 1800, 2000,
        2200, 2400)


@dataclass
class Config:
    log_dir: str = "./runs/finetune"
    save_freq: int = 1
    log_interval: int = 10
    device: str = "tpu"
    epochs: int = 50
    batch_size: int = 5
    max_len: int = 300
    pretrained_model: str = ""
    load_only_params: bool = False
    debug: bool = True
    data_params: DataParams = field(default_factory=DataParams)
    symbol: SymbolConfig = field(default_factory=SymbolConfig)
    preprocess_params: PreprocessParams = field(default_factory=PreprocessParams)
    training_strats: TrainingStrats = field(default_factory=TrainingStrats)
    model_params: ModelConfig = field(default_factory=ModelConfig)
    loss_params: LossParams = field(default_factory=LossParams)
    optimizer_params: OptimizerParams = field(default_factory=OptimizerParams)
    slmadv_params: SLMAdvParams = field(default_factory=SLMAdvParams)
    tpu: TPUConfig = field(default_factory=TPUConfig)


def _from_dict(cls, d: Any):
    """Recursively build a dataclass from a (possibly partial) dict."""
    if d is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        if cls in (Tuple[int, ...],) and isinstance(d, (list, tuple)):
            return tuple(d)
        return d
    kwargs: Dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in d.items():
        if key not in fields:
            continue  # tolerate unknown keys, like the reference's .get() pattern
        f = fields[key]
        ftype = f.type
        # resolve nested dataclass types
        nested = _DATACLASS_FIELDS.get((cls.__name__, key))
        if nested is not None and isinstance(val, dict):
            kwargs[key] = _from_dict(nested, val)
        elif key in ("token_buckets", "frame_buckets") and isinstance(val, (list, tuple)):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


_DATACLASS_FIELDS = {
    ("Config", "data_params"): DataParams,
    ("Config", "symbol"): SymbolConfig,
    ("Config", "preprocess_params"): PreprocessParams,
    ("Config", "training_strats"): TrainingStrats,
    ("Config", "model_params"): ModelConfig,
    ("Config", "loss_params"): LossParams,
    ("Config", "optimizer_params"): OptimizerParams,
    ("Config", "slmadv_params"): SLMAdvParams,
    ("Config", "tpu"): TPUConfig,
    ("ModelConfig", "ASR_params"): ASRParams,
    ("ModelConfig", "JDC_params"): JDCParams,
    ("ModelConfig", "decoder"): DecoderConfig,
    ("PreprocessParams", "spect_params"): SpectParams,
}


def load_config(path_or_dict) -> Config:
    """Load a YAML config file (same schema as the reference's) into Config.

    Sets model_params.n_token = len(symbols) + 1, mirroring reference
    train.py:67-83 / inference.py:70-86.
    """
    if isinstance(path_or_dict, dict):
        raw = path_or_dict
    else:
        with open(path_or_dict, "r", encoding="utf-8") as f:
            raw = yaml.safe_load(f)
    cfg = _from_dict(Config, raw)
    _apply_decoder_type_defaults(cfg, raw)
    from styletts2_tpu_torch.text import build_symbol_dict

    symbol_dict = build_symbol_dict(cfg.symbol)
    cfg.model_params.n_token = len(symbol_dict) + 1
    return cfg


# Per-type decoder defaults (reference Configs/config_example.yaml:56-80 —
# the reference REQUIRES the user to swap these blocks by hand when
# switching decoder type; here `type: istftnet` alone yields the same
# architecture the reference documents for it).
_DECODER_TYPE_DEFAULTS = {
    "istftnet": {"upsample_rates": [10, 6],
                 "upsample_kernel_sizes": [20, 12],
                 "gen_istft_n_fft": 20, "gen_istft_hop_size": 5},
    "vocos": {"gen_istft_n_fft": 1200, "gen_istft_hop_size": 300},
}


def with_decoder_type(raw: Dict[str, Any], dec_type: str) -> Dict[str, Any]:
    """A copy of a raw config dict whose decoder block has type `dec_type`
    and none of HiFi-GAN's upsampling keys (upsample_rates,
    upsample_kernel_sizes), so that load_config applies the type's
    defaults below: configs/config_example.yaml sets those keys for
    HiFi-GAN, and an iSTFTNet would otherwise keep rates [10, 5, 3, 2]."""
    raw = copy.deepcopy(raw)
    dec = raw.setdefault("model_params", {}).setdefault("decoder", {})
    dec["type"] = dec_type
    if dec_type != "hifigan":
        for key in ("upsample_rates", "upsample_kernel_sizes"):
            dec.pop(key, None)
    return raw


def _apply_decoder_type_defaults(cfg: Config, raw: Dict[str, Any]) -> None:
    dec = cfg.model_params.decoder
    defaults = _DECODER_TYPE_DEFAULTS.get(dec.type)
    if not defaults:
        return
    given = ((raw.get("model_params") or {}).get("decoder") or {})
    for key, val in defaults.items():
        if key not in given:
            setattr(dec, key, val)
