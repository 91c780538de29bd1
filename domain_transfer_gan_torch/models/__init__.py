from .api import (
    AugmentedCycleGAN,
    GeneratorPair,
    build_generators,
    create_model,
)
