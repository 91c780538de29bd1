from .convs import (
    conv2d_torch,
    conv_transpose2d_torch,
    reflect_pad2d,
    replicate_pad2d,
)
