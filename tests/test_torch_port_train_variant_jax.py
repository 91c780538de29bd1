"""The non-default branches of the two-phase train step against the JAX step
on every run.

tests/test_torch_port_train_variants.py holds each flag variant against a
JAX step of its own, one compile each, and carries the ``slow`` marker for
it.  Here one combination that leaves every default branch at once
(``stoch_enc`` and with it no z-GAN, ``enc_A_B=0``, sigmoid + BCE,
``norm="batch"`` with its two-forward score pair) goes through the same
two-step comparison, so a run without the slow cases still meets the JAX
step off the default path.  One JAX compile, shared by all assertions."""

import numpy as np
import pytest

from torch_port_helpers import (
    check_two_step_parity,
    check_variant_specifics,
    run_both_train_steps,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLAGS = dict(stoch_enc=True, norm="batch")


@pytest.fixture(scope="module")
def run():
    return run_both_train_steps(FLAGS)


def test_two_steps_of_the_combined_variant_match_the_jax_step(run):
    check_two_step_parity(run, frozen=("netD_z_B",))


def test_the_combined_variant_left_the_default_branches(run):
    check_variant_specifics(run, FLAGS)
    st = run["steps"][0]
    # the posterior is sampled: mu and logvar both spread
    assert st["gnorms"]["logvar_min"] < st["gnorms"]["logvar_max"]
    assert all(np.isfinite(v) for v in st["losses"].values())
