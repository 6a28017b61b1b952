"""Model configurations of the port (own copies of ``repro.configs``)."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, SUBQUADRATIC, FFConfig, InputShape, MLAConfig,
    MLAModelConfig, ModelConfig, MoEConfig, RGLRUConfig, SigmoidMoEConfig,
    SSMConfig, get_config, list_configs, port_only, reference_names,
    register)
