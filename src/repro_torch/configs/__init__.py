from repro_torch.configs.base import (  # noqa: F401
    HybridConfig,
    MoEConfig,
    ModelConfig,
    REDUCED,
    REGISTRY,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    get_config,
    list_archs,
    register,
    shape_applicable,
)
from repro_torch.configs.fenix_models import (  # noqa: F401
    TrafficModelConfig,
    fenix_cnn,
    fenix_rnn,
)
