"""Model zoo of the port (dense, pure SSM, hybrid, cross-attention VLM,
encoder-decoder and MoE families), mirroring ``repro.models``."""

from .config import SHAPES, ModelConfig, ShapeConfig
from .model import (decode_step, forward, init_params, init_serve_cache,
                    loss_fn, prefill, token_ce)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "decode_step", "forward",
           "init_params", "init_serve_cache", "loss_fn", "prefill",
           "token_ce"]
