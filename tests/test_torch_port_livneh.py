"""The Livneh ETL of the port (``data/prep_livneh.py``) against the JAX
package's on the same NetCDF-3 files: every file it writes (the bundles
with their lat/lon/time metadata and the per-sample files) equal, the 80/20
chronological split, its CLI, and the clear exit on a NetCDF-4 file."""

import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from domain_transfer_gan_tpu.data import prep_livneh as jax_prep

from domain_transfer_gan_torch.data import prep_livneh


def write_nc(path, var_names, T, H, W, seed, nan_frac=0.1):
    """A Livneh-shaped classic NetCDF file: (time, lat, lon) float32
    variables over one NaN land mask, with lat/lon/time coordinates."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(H, W) < nan_frac
    with netcdf_file(str(path), "w") as ds:
        for dim, n in (("time", T), ("lat", H), ("lon", W)):
            ds.createDimension(dim, n)
            v = ds.createVariable(dim, "f4", (dim,))
            v[:] = np.arange(n, dtype=np.float32) + 0.5
        for name in var_names:
            v = ds.createVariable(name, "f4", ("time", "lat", "lon"))
            arr = rng.rand(T, H, W).astype(np.float32)
            arr[:, mask] = np.nan
            v[:] = arr


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("T,H,W,frac,per_sample", [
    (10, 6, 5, 0.8, True), (7, 4, 4, 0.5, True), (12, 8, 8, 0.8, False)])
def test_writes_the_jax_files(tmp_path, T, H, W, frac, per_sample):
    write_nc(tmp_path / "forcings.nc", prep_livneh.DOMAIN_A_VARS, T, H, W, 0)
    write_nc(tmp_path / "swe.nc", prep_livneh.DOMAIN_B_VARS, T, H, W, 1)
    args = (str(tmp_path / "forcings.nc"), str(tmp_path / "swe.nc"))
    prep_livneh.prepare(*args, str(tmp_path / "port"), frac, per_sample)
    jax_prep.prepare(*args, str(tmp_path / "jax"), frac, per_sample)
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "jax")
    n_train = int(T * frac)
    assert ("trainA/%05d.npz" % (n_train - 1) in names) == per_sample
    for name in names:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    with np.load(tmp_path / "port" / "trainA.npz") as f:
        assert f["data"].shape == (n_train, H, W, 4)
        assert np.isnan(f["data"]).any()
        np.testing.assert_array_equal(f["time"], np.arange(T) + 0.5)
    with np.load(tmp_path / "port" / "testB.npz") as f:
        assert f["data"].shape == (T - n_train, H, W, 1)


def test_chronological_split():
    tr, te = prep_livneh.chronological_split(10)
    np.testing.assert_array_equal(tr, np.arange(8))
    np.testing.assert_array_equal(te, np.arange(8, 10))


def test_cli(tmp_path, capsys):
    write_nc(tmp_path / "f.nc", prep_livneh.DOMAIN_A_VARS, 5, 4, 4, 2)
    write_nc(tmp_path / "s.nc", prep_livneh.DOMAIN_B_VARS, 5, 4, 4, 3)
    prep_livneh.main(["--forcings", str(tmp_path / "f.nc"), "--swe",
                      str(tmp_path / "s.nc"), "--out", str(tmp_path / "o"),
                      "--no_per_sample"])
    assert "wrote Livneh npz dataset" in capsys.readouterr().out
    assert _files(tmp_path / "o") == ["testA.npz", "testB.npz",
                                      "trainA.npz", "trainB.npz"]


def test_a_netcdf4_file_exits_with_the_reason(tmp_path):
    """An HDF5 (NetCDF-4) file without the netCDF4 package: SystemExit
    naming the file, as in the JAX package."""
    path = tmp_path / "nc4.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    with pytest.raises(SystemExit, match="nc4.nc could not be read"):
        prep_livneh.extract_variables(str(path), ["SWE"])
