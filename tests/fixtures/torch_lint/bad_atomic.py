"""Seeded negatives for the ``atomic-write`` concurrency rule."""

import json

import numpy as np


def write_ledger_record(path, rec):
    with open(path, "w") as f:          # torn-readable plain write
        json.dump(rec, f)


def save_shard(path, arr):
    np.save(path, arr)                  # non-atomic array checkpoint


def rewrite_binary(path, payload):
    f = open(path, "wb")                # same class, expression form
    f.write(payload)
    f.close()
