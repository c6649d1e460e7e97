"""Architecture configs of the port (the decoders the port serves: the
dense ones, the MoE ones, the vision-prefix one, the SSM one, the
RG-LRU hybrid and the audio encoder-decoder).
Importing ``load_all()`` populates the registry."""
import importlib

_MODULES = ("qwen2_5_3b", "yi_6b", "stablelm_12b", "granite_20b",
            "mixtral_8x7b", "olmoe_1b_7b", "phi3_vision_4_2b",
            "mamba2_2_7b", "recurrentgemma_9b", "whisper_tiny")


def load_all():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


from repro_torch.configs.base import ModelConfig, get_config  # noqa: E402,F401
