"""Many-to-many (z-diversity) metric, the port of the JAX package's
``eval/diversity.py``: how far ``G_A_B(a, z)`` moves as z varies, in the
embedding of ``eval.fid``'s random-feature extractor.

- ``z_diversity_stats``: per-input mean pairwise distance of the embeddings
  across z draws (``intra_z``), the mean pairwise distance between
  per-input mean embeddings (``inter_input``), and their ratio.  A
  z-ignoring generator (``cycle_gan``) scores intra_z = 0.
- ``eval_z_diversity``: a model's ``generate_multi`` over a batch of A.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .fid import random_feature_extractor


def z_diversity_stats(multi_fake_B, num_z: int,
                      extractor: Optional[Callable] = None,
                      device="cuda") -> dict:
    """Diversity statistics of an input-major multi-z decode:
    ``multi_fake_B`` is (N * num_z, H, W, C) with input i's num_z decodes
    contiguous, as ``generate_multi`` returns them.  Returns ``{"intra_z",
    "inter_input", "ratio"}`` (``inter_input`` and ``ratio`` are NaN for a
    single input).  The default extractor runs on ``device``."""
    total = multi_fake_B.shape[0]
    if num_z < 2:
        raise ValueError("z-diversity needs num_z >= 2 z draws per input, "
                         "got %d" % num_z)
    if total % num_z != 0:
        raise ValueError("multi_fake_B length %d not divisible by num_z %d"
                         % (total, num_z))
    n = total // num_z
    extractor = extractor or random_feature_extractor(device=device)
    emb = extractor(multi_fake_B).reshape(n, num_z, -1)

    diffs = emb[:, :, None, :] - emb[:, None, :, :]      # (n, K, K, D)
    dists = np.sqrt(np.sum(diffs ** 2, axis=-1))          # (n, K, K)
    iu = np.triu_indices(num_z, k=1)
    intra = float(np.mean(dists[:, iu[0], iu[1]]))

    centers = emb.mean(axis=1)                            # (n, D)
    if n >= 2:
        cd = centers[:, None, :] - centers[None, :, :]
        cdists = np.sqrt(np.sum(cd ** 2, axis=-1))
        ciu = np.triu_indices(n, k=1)
        inter = float(np.mean(cdists[ciu]))
    else:
        inter = float("nan")
    ratio = intra / inter if inter and np.isfinite(inter) and inter > 0 \
        else float("nan")
    return {"intra_z": intra, "inter_input": inter, "ratio": ratio}


def eval_z_diversity(model, real_A, num_z: int = 10,
                     extractor: Optional[Callable] = None) -> dict:
    """Draw ``num_z`` prior z's per input, decode them in one batched
    ``generate_multi`` and return :func:`z_diversity_stats` of the
    result."""
    real_A = model._tensor(real_A)
    multi_z = model.sample_prior_z(real_A.shape[0] * num_z)
    multi_fake_B = model.generate_multi(real_A, multi_z)
    return z_diversity_stats(multi_fake_B, num_z, extractor,
                             device=model.device)
