from .convert import (
    flatten_params,
    jax_params_to_state_dict,
    unflatten_params,
)
