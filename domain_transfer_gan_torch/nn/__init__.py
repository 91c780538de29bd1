from .norms import InstanceNorm, CondInstanceNorm, instance_norm_ref
from .blocks import ResnetBlock, CINResnetBlock
from .networks import (
    CINResnetGenerator,
    ResnetGenerator,
    TorchConvTranspose,
    define_G,
    define_stochastic_G,
    count_params,
)
