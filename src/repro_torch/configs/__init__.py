"""Model configurations of the port (own copies of ``repro.configs``)."""
from repro_torch.configs.base import (  # noqa: F401
    FFConfig, ModelConfig, SSMConfig, get_config, list_configs, register)
