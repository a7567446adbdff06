"""Architecture configs, the port's copy of `repro.configs`: the 10
assigned architectures. Each <arch>.py exposes `config()` (the exact published
configuration) and `smoke()` (a reduced same-family variant for CPU tests).
"""

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    get_arch,
    list_archs,
)
