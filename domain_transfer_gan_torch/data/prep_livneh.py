"""Offline ETL: Livneh hydrology NetCDF -> npz bundles + per-sample files.
The JAX package's ``data/prep_livneh.py`` in the port (numpy and scipy
only; it touches no device).

The upstream dataset-preparation notebook
(`datasets/Parse Livneh data to numpy.ipynb`, cells 6-16): extract the
atmospheric forcing variables [Prec, Tmax, Tmin, wind] as domain A and
snow-water equivalent [SWE] as domain B, keep lat/lon/time metadata, split
80/20 chronologically, and write BOTH loader formats:

- bundled ``{train,test}{A,B}.npz`` with key 'data'  (the in-memory path)
- per-sample ``{train,test}{A,B}/{i}.npz``           (the per-file path)

Reading prefers the optional ``netCDF4`` dependency (NetCDF-4/HDF5 files);
without it, classic NetCDF-3 files are read through scipy's built-in
reader, and a NetCDF-4 file degrades with a clear message.

Usage:
    python -m domain_transfer_gan_torch.data.prep_livneh \
        --forcings forcings.nc --swe swe.nc --out ./livneh_npz
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

DOMAIN_A_VARS = ["Prec", "Tmax", "Tmin", "wind"]
DOMAIN_B_VARS = ["SWE"]
TRAIN_FRACTION = 0.8


def _open_nc(nc_path: str):
    """Return ``(variables, close)`` for a NetCDF file.

    Prefers the optional ``netCDF4`` package (required for NetCDF-4/HDF5
    files); falls back to scipy's built-in classic NetCDF-3 reader so the
    ETL works — and is testable — without the optional dependency."""
    try:
        import netCDF4
    except ImportError:
        from scipy.io import netcdf_file
        try:
            ds = netcdf_file(nc_path, "r", mmap=False)
        except Exception as e:
            raise SystemExit(
                "%s could not be read with scipy's classic NetCDF-3 reader "
                "(%r) and the netCDF4 package (needed for NetCDF-4/HDF5 "
                "files) is not installed. Install netCDF4 or convert the "
                "file to npz externally." % (nc_path, e)) from e
        return ds.variables, ds.close
    ds = netCDF4.Dataset(nc_path)
    return ds.variables, ds.close


def extract_variables(nc_path: str, var_names: Sequence[str]) -> np.ndarray:
    """Stack (time, lat, lon) variables into (time, lat, lon, C)."""
    variables, close = _open_nc(nc_path)
    try:
        arrs = []
        for name in var_names:
            # read the variable ONCE: each [:] materializes (and
            # decompresses) the full (time, lat, lon) array from disk
            raw = variables[name][:]
            if np.ma.isMaskedArray(raw):
                v = np.ma.filled(raw, np.nan).astype(np.float32)
            else:
                # copy: scipy's reader may hand back a view of its buffer
                v = np.array(raw, dtype=np.float32)
            arrs.append(v)
        data = np.stack(arrs, axis=-1)
        meta = {}
        for extra in ("lat", "lon", "time"):
            if extra in variables:
                meta[extra] = np.array(variables[extra][:])
    finally:
        close()
    return data, meta


def chronological_split(n: int, train_fraction: float = TRAIN_FRACTION):
    n_train = int(n * train_fraction)
    return np.arange(n_train), np.arange(n_train, n)


def write_bundles(out_dir: str, trainA, trainB, testA, testB, meta=None):
    os.makedirs(out_dir, exist_ok=True)
    extras = {k: v for k, v in (meta or {}).items()}
    np.savez(os.path.join(out_dir, "trainA.npz"), data=trainA, **extras)
    np.savez(os.path.join(out_dir, "trainB.npz"), data=trainB, **extras)
    np.savez(os.path.join(out_dir, "testA.npz"), data=testA, **extras)
    np.savez(os.path.join(out_dir, "testB.npz"), data=testB, **extras)


def write_per_sample(out_dir: str, split: str, A: np.ndarray, B: np.ndarray):
    for sub, arr in ((split + "A", A), (split + "B", B)):
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        for i, x in enumerate(arr):
            np.savez(os.path.join(d, "%05d.npz" % i), data=x)


def prepare(forcings_nc: str, swe_nc: str, out_dir: str,
            train_fraction: float = TRAIN_FRACTION,
            per_sample: bool = True):
    A, metaA = extract_variables(forcings_nc, DOMAIN_A_VARS)
    B, metaB = extract_variables(swe_nc, DOMAIN_B_VARS)
    assert A.shape[0] == B.shape[0], "domains must share the time axis"
    tr, te = chronological_split(A.shape[0], train_fraction)
    write_bundles(out_dir, A[tr], B[tr], A[te], B[te], metaA)
    if per_sample:
        write_per_sample(out_dir, "train", A[tr], B[tr])
        write_per_sample(out_dir, "test", A[te], B[te])
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--forcings", required=True,
                   help="NetCDF with Prec/Tmax/Tmin/wind (domain A)")
    p.add_argument("--swe", required=True, help="NetCDF with SWE (domain B)")
    p.add_argument("--out", required=True)
    p.add_argument("--train_fraction", type=float, default=TRAIN_FRACTION)
    p.add_argument("--no_per_sample", action="store_true")
    args = p.parse_args(argv)
    prepare(args.forcings, args.swe, args.out, args.train_fraction,
            per_sample=not args.no_per_sample)
    print("wrote Livneh npz dataset to", args.out)


if __name__ == "__main__":
    main()
