"""Experiment-artifact helpers with the upstream file contract:
results.json, the results.txt tee, the loss-line format and the source
snapshot.  The text they write is the JAX package's, character for
character."""

from __future__ import annotations

import glob
import json
import os
import shutil


def save_results(expr_dir: str, results_dict: dict):
    """-> results.json, written atomically (temp file + rename): it is
    rewritten every eval, and a truncated file would break resuming."""
    fname = os.path.join(expr_dir, "results.json")
    tmp = fname + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results_dict, f, indent=4)
    os.replace(tmp, fname)


def copy_scripts_to_folder(expr_dir: str, src_dir: str = None):
    """Snapshot the port's Python sources into the experiment dir: the
    package's top-level modules flat at the expr_dir root (the upstream
    layout), its subpackages as a tree beside them."""
    if src_dir is None:
        src_dir = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    for f in glob.glob(os.path.join(src_dir, "*.py")):
        shutil.copy(f, expr_dir)
    for f in glob.glob(os.path.join(src_dir, "*", "**", "*.py"),
                       recursive=True):
        rel = os.path.relpath(f, src_dir)
        out = os.path.join(expr_dir, rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        shutil.copy(f, out)


def print_log(out_f, message: str):
    """Tee to the open log file and to stdout."""
    if out_f is not None:
        out_f.write(message + "\n")
        out_f.flush()
    print(message)


def format_log(epoch: int, i: int, errors: dict, t: float,
               prefix: bool = True) -> str:
    """The upstream loss line: ``(epoch: E, iters: I, time: T) k: v ...``.
    Values may be 0-d tensors; each is read with ``float``."""
    message = "(epoch: %d, iters: %d, time: %.3f) " % (epoch, i, t)
    if not prefix:
        message = " " * len(message)
    for k, v in errors.items():
        message += "%s: %.3f " % (k, float(v))
    return message
