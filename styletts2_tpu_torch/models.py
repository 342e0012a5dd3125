"""Model assembly: the modules of a config.

Counterpart of styletts2_tpu/models.py: the same module keys, so a JAX
param tree or native checkpoint maps 1:1. Inference builds the four
INFERENCE_MODULES; training builds all eight (`build_model`).
"""

from __future__ import annotations

import torch.nn as nn

from styletts2_tpu_torch.config import ModelConfig
from styletts2_tpu_torch.nn.asr import ASRCNN
from styletts2_tpu_torch.nn.decoder import Decoder
from styletts2_tpu_torch.nn.discriminators import (MultiPeriodDiscriminator,
                                                   MultiResSpecDiscriminator)
from styletts2_tpu_torch.nn.jdc import JDCNet
from styletts2_tpu_torch.nn.predictor import ProsodyPredictor
from styletts2_tpu_torch.nn.style_encoder import StyleEncoder
from styletts2_tpu_torch.nn.text_encoder import TextEncoder

INFERENCE_MODULES = ("decoder", "predictor", "text_encoder", "style_encoder")


def build_inference_modules(args: ModelConfig) -> nn.ModuleDict:
    """{module key: nn.Module} for the decoder, predictor, text encoder and
    style encoder, on the CPU, with torch's default init."""
    return nn.ModuleDict({
        "decoder": Decoder(args.decoder, dim_in=args.hidden_dim,
                           style_dim=args.style_dim),
        "predictor": ProsodyPredictor(style_dim=args.style_dim,
                                      d_hid=args.hidden_dim,
                                      nlayers=args.n_layer,
                                      max_dur=args.max_dur),
        "text_encoder": TextEncoder(channels=args.hidden_dim, kernel_size=5,
                                    depth=args.n_layer,
                                    n_symbols=args.n_token),
        "style_encoder": StyleEncoder(dim_in=args.dim_in,
                                      style_dim=args.style_dim,
                                      max_conv_dim=args.max_conv_dim),
    })


def build_model(args: ModelConfig) -> nn.ModuleDict:
    """All eight modules (reference models.build_model), on the CPU, with
    torch's default init: the inference four plus text_aligner,
    pitch_extractor, mpd and msd."""
    mods = build_inference_modules(args)
    a = args.ASR_params
    mods["text_aligner"] = ASRCNN(input_dim=a.input_dim,
                                  hidden_dim=a.hidden_dim,
                                  n_token=args.n_token, n_layers=a.n_layers,
                                  token_embedding_dim=a.token_embedding_dim)
    mods["pitch_extractor"] = JDCNet(num_class=args.JDC_params.num_class)
    mods["mpd"] = MultiPeriodDiscriminator()
    mods["msd"] = MultiResSpecDiscriminator()
    return mods
