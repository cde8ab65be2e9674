"""Positives for the ``atomic-write`` rule: every sanctioned idiom."""

import json
import os

import numpy as np


def tmp_replace(path, rec):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:           # tmp + os.replace in-function
        json.dump(rec, f)
    os.replace(tmp, path)


def excl_claim(path, rec):
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    with os.fdopen(fd, "w") as f:       # O_CREAT|O_EXCL claim
        json.dump(rec, f)


def _atomic_write(path, writer):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:          # the sanctioned helper itself
        writer(f)
    os.replace(tmp, path)


def delegated(path, arrays):
    _atomic_write(path, lambda f: np.savez(f, **arrays))  # via helper


def append_log(path, line):
    with open(path, "a") as f:          # append: the audited exception
        f.write(line)
