"""The inputs each function of a ``tests/fixtures/jax_serve`` directory is
called on, for the fixture script, the tests and ``chip_smoke.py`` alike
(numpy only)."""

import numpy as np


def inputs(manifest, seed):
    """A and B uniform in [-1, 1], z standard normal, from
    ``RandomState(seed)``, at the directory's batch and widths."""
    rng = np.random.RandomState(seed)
    b, hw = manifest["batch"], manifest["grid_size"]
    return {
        "A": rng.uniform(-1, 1, (b, hw, hw, manifest["input_nc"])).astype(
            np.float32),
        "z": rng.randn(b, manifest["nlatent"]).astype(np.float32),
        "B": rng.uniform(-1, 1, (b, hw, hw, manifest["output_nc"])).astype(
            np.float32),
    }
