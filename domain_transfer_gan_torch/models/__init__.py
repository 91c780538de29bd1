from .api import (
    AugmentedCycleGAN,
    CycleGANBase,
    StochCycleGAN,
    create_model,
)
