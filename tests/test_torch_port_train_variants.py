"""Flag variants of the two-phase train step (the ones
tests/test_train_steps.py exercises).

For each variant, two steps of the port's ``train_instance`` against two
steps of the JAX ``make_aug_train_step`` from the same weights, statistics,
inputs, ``prior_z`` and ``eps_post``.  Each of those compiles the JAX step
anew (30-60 s on a CPU), so they carry the ``slow`` marker:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_port_train_variants.py

Their cheap siblings run the port alone and check what each flag must
change.  The default flags are held against JAX on every run, in
tests/test_torch_port_train_step.py, and ``stoch_enc`` with ``norm="batch"``
in tests/test_torch_port_train_variant_jax.py."""

import numpy as np
import pytest

from torch_port_helpers import (
    check_two_step_parity,
    check_variant_specifics,
    run_both_train_steps,
    run_port_train_steps,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VARIANTS = [dict(stoch_enc=True), dict(z_gan=0), dict(enc_A_B=0),
            dict(no_lsgan=True), dict(stoch_enc=True, z_gan=0),
            dict(norm="batch")]


def _id(flags):
    return ",".join("%s=%s" % kv for kv in flags.items())


@pytest.mark.slow
@pytest.mark.parametrize("flags", VARIANTS, ids=_id)
def test_two_steps_match_the_jax_step(flags):
    run = run_both_train_steps(flags)
    z_gan_on = flags.get("z_gan", 1) and not flags.get("stoch_enc")
    check_two_step_parity(run, frozen=() if z_gan_on else ("netD_z_B",))
    check_variant_specifics(run, flags)


@pytest.mark.parametrize("flags", VARIANTS + [dict(use_dropout=True)],
                         ids=_id)
def test_variant_steps_on_the_port_alone(flags):
    run = run_port_train_steps(flags)
    for st in run["steps"]:
        assert all(np.isfinite(v) for v in st["losses"].values()), st
        assert all(np.isfinite(v) for v in st["gnorms"].values()), st
    check_variant_specifics(run, flags)


def test_dropout_masks_differ_from_step_to_step():
    """``use_dropout`` cannot be compared number by number (the two
    frameworks draw other masks): with lr = 0 two steps on the same inputs
    differ only because the masks do."""
    run = run_port_train_steps(dict(use_dropout=True, lr=0.0))
    first, second = (st["losses"] for st in run["steps"])
    assert first["Cyc_A"] != second["Cyc_A"]
    same = run_port_train_steps(dict(lr=0.0))
    assert same["steps"][0]["losses"]["G_A"] == \
        same["steps"][1]["losses"]["G_A"]
