from .instance_norm import (
    instance_norm_fused,
    instance_norm_plain,
    launch_geometry,
)
