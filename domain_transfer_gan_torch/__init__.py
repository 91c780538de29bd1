"""domain_transfer_gan_torch: the PyTorch/CUDA port of domain_transfer_gan_tpu
for NVIDIA Hopper cards.

The port is a package of its own.  It imports torch, numpy and the standard
library, and nothing of JAX or of the JAX package; the sub-packages carry the
same names as their counterparts there, so a reader finds the twin of a module
by its path.

Layout
------
- ``config``     the experiment configuration (all fields of the JAX
                 package's ``TrainConfig``, so saved ``opt.json`` files load).
- ``ops``        conv/pad geometry helpers and the loss / clipping math
                 (``ops.numerics``); ``ops.kernels`` holds the hand-written
                 CUDA kernels, their wrappers, their plain PyTorch versions
                 and the build step that compiles ``csrc/``.
- ``csrc``       CUDA C++ sources (``sm_90a``), compiled at first use.
- ``nn``         instance / conditional-instance / batch norms, residual
                 blocks and the six networks.
- ``data``       the npz bundles, their resize, minibatch iterators.
- ``eval``       the evaluation metrics (MSE, the variational bound, the
                 test CLI's), proxy-FID, z-diversity and PNG grids.
- ``utils``      conversion of JAX parameter trees into ``state_dict``s,
                 checkpoints, the experiment artifacts.
- ``models``     training state and optimizers (``state``), the train steps
                 of the three variants and the supervised step (``steps``)
                 and the model API (``api``).
- ``cli``        ``train`` and ``test`` (the training and evaluation CLIs),
                 ``export`` (serving artifact) and ``serve`` (HTTP
                 endpoint).

Public tensors keep the JAX package's layout: images are NHWC float32 in
[-1, 1], latent codes are flat ``(N, nlatent)``.  Inside the networks the
activations are NCHW tensors in ``torch.channels_last`` memory format, whose
``permute(0, 2, 3, 1)`` is a contiguous ``(N, H, W, C)`` view.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
"""

__version__ = "0.1.0"
