"""The climate-segmentation loader of the port against the JAX package's
on the same files: items equal, iteration, the split-file protocol."""

import numpy as np
import pytest

from domain_transfer_gan_tpu.data.climate import ClimateSegLoader as \
    JaxLoader

from domain_transfer_gan_torch.data.climate import ClimateSegLoader


@pytest.fixture
def climate_dir(tmp_path):
    rng = np.random.RandomState(3)
    names = []
    for i in range(3):
        name = "c%d.npz" % i
        np.savez(str(tmp_path / name),
                 data=(rng.randn(16, 64) * 100).astype(np.float32),
                 labels=np.eye(4)[rng.randint(0, 4, 64)].T)
        names.append(name)
    for part in ("train", "val"):
        with open(tmp_path / (part + "_split.txt"), "w") as f:
            f.write("\n".join(names) + "\n\n")
    return tmp_path


@pytest.mark.parametrize("partition", ["train", "val"])
def test_items_are_the_jax_items(climate_dir, partition):
    mine = ClimateSegLoader(str(climate_dir), partition,
                            split_dir=str(climate_dir))
    theirs = JaxLoader(str(climate_dir), partition,
                       split_dir=str(climate_dir))
    assert len(mine) == len(theirs) == 3
    for (d, l), (jd, jl) in zip(mine, theirs):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(l, jl)
        assert d.shape == (16, 64) and l.shape == (64,)
        assert l.dtype == np.int64 and l.max() < 4


def test_custom_statistics(climate_dir):
    mean, std = [1.0] * 16, [2.0] * 16
    d, _ = ClimateSegLoader(str(climate_dir), "train", mean, std,
                            split_dir=str(climate_dir))[1]
    jd, _ = JaxLoader(str(climate_dir), "train", mean, std,
                      split_dir=str(climate_dir))[1]
    np.testing.assert_array_equal(d, jd)


def test_an_unknown_partition_is_refused(climate_dir):
    with pytest.raises(ValueError, match="partition"):
        ClimateSegLoader(str(climate_dir), "dev", split_dir=str(climate_dir))
