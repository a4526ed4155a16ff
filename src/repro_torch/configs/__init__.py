from repro_torch.configs.registry import get_config  # noqa: F401
