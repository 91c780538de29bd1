"""The step extras against the JAX package: two steps of the JAX step and of
the port's from the same weights, inputs, eps and pool draws
(``run_both_train_steps``), held by ``check_two_step_parity``:
``aug_cycle_gan --grad_accum 2`` at batch 8 (microbatches of 4: batch norm
over 2 samples is ill-conditioned), ``stoch_cycle_gan --grad_accum 2`` and
``aug_cycle_gan --pool_size 4 --ema 0.9`` (the pools and the shadows held
too, the shadows by their displacement from the start).  Each compiles a
JAX step (30-60 s on a CPU), so they are ``slow``; the port-only siblings
are in ``test_torch_port_step_extras.py`` and ``test_torch_port_pool.py``.
Run with ``-m slow``."""

import numpy as np
import pytest

from domain_transfer_gan_torch.parallel import selfcheck

from torch_port_helpers import (  # noqa: F401 (a fixture)
    check_two_step_parity,
    one_torch_thread,
    run_both_train_steps,
)

pytestmark = [pytest.mark.usefixtures("one_torch_thread"), pytest.mark.slow]

# a pool buffer holds generator outputs (tanh, |y| <= 1): float32 on both
# sides, other summation orders, after the step-2 parameters parted by up
# to 2 lr
POOL_ATOL = 1e-3
LR = 2e-4
DECAY = 0.9


def check_shadows(run):
    """Each tracked net's shadow, port against JAX, by its displacement
    from the start (both packages start the shadow at the parameters):
    ``selfcheck.hold_shadows``' rule after the two steps.  What the
    parameters part by (Adam's sign flips, up to 2 lr on a few entries)
    reads up to 0.11 (netG_A_B) with 3 % of its entries off."""
    for net, want in run["jax_ema"].items():
        names = list(want)
        selfcheck.hold_shadows([run["ema"][net][k] for k in names],
                               [want[k] for k in names],
                               [run["start"][net][k] for k in names],
                               DECAY, 2, LR)


@pytest.mark.parametrize("flags,batch", [
    (dict(model="aug_cycle_gan", grad_accum=2, batchSize=8), 8),
    (dict(model="stoch_cycle_gan", grad_accum=2), 4),
], ids=["aug_accum2_b8", "stoch_accum2_b4"])
def test_accumulation_steps_match_jax(flags, batch):
    # the stoch step's netG_A_B needs its gradients recorded (as in
    # test_torch_port_stoch_step.py): Adam flips the signs of its
    # sub-difference entries
    run = run_both_train_steps(flags, batch=batch,
                               grads=flags["model"] == "stoch_cycle_gan")
    check_two_step_parity(run)
    assert run["jax_step"] == run["model"].state.step == 2


def test_pool_and_ema_match_jax():
    run = run_both_train_steps(dict(pool_size=4, ema=DECAY))
    check_two_step_parity(run)
    assert set(run["pools"]) == set(run["jax_pools"]) == {"fake_A", "fake_B"}
    for name, (buf, n) in run["jax_pools"].items():
        got, got_n = run["pools"][name]
        assert got_n == n == 4
        assert np.abs(got - buf).max() <= POOL_ATOL, name
    assert set(run["ema"]) == set(run["jax_ema"]) == {
        "netG_A_B", "netG_B_A", "netE_B"}
    check_shadows(run)
