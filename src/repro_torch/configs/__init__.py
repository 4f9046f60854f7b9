from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config

__all__ = ["ARCH_IDS", "get_config", "reduced_config"]
