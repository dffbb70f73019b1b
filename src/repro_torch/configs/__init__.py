"""Architecture configs of the port: the dense models (granite-3-2b,
minicpm-2b, deepseek-7b, llama3-405b), the SSM model (mamba2-1.3b), the
hybrid (zamba2-7b), the encoder-decoder (whisper-large-v3), the
cross-attention VLM (llama-3.2-vision-90b) and the MoE models
(deepseek-v3-671b with MLA, llama4-maverick-400b-a17b)."""

from __future__ import annotations

import importlib

ARCH_IDS = ["granite-3-2b", "minicpm-2b", "deepseek-7b", "llama3-405b",
            "mamba2-1.3b", "zamba2-7b", "whisper-large-v3",
            "llama-3.2-vision-90b", "deepseek-v3-671b",
            "llama4-maverick-400b-a17b"]


def get_config(arch_id: str, preset: str = "full"):
    """Load an architecture config by id.  preset='full' is the exact
    published configuration; preset='smoke' is a reduced same-family config
    for CPU tests."""
    if arch_id not in ARCH_IDS:
        raise ValueError(f"{arch_id!r} is not ported yet (have {ARCH_IDS})")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.full_config() if preset == "full" else mod.smoke_config()
