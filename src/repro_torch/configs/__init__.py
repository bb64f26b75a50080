from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    ARCH_IDS,
    ArchConfig,
    InputShape,
    SHAPES_BY_NAME,
    all_configs,
    get_config,
    shapes_for,
    skipped_shapes_for,
)
