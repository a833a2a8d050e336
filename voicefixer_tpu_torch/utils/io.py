"""Small JSON and pickle helpers, an own copy of
``voicefixer_tpu/utils/io.py`` (upstream ``tools/io.py``)."""

from __future__ import annotations

import json
import os
import pickle


def load_json(fname: str):
    with open(fname, "r") as f:
        return json.load(f)


def write_json(data, fname: str):
    with open(fname, "w") as f:
        json.dump(data, f, indent=2)


def save_pickle(obj, fname: str):
    with open(fname, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(fname: str):
    with open(fname, "rb") as f:
        return pickle.load(f)


def find_and_build(dirname: str) -> str:
    """mkdir -p; returns ``dirname``."""
    os.makedirs(dirname, exist_ok=True)
    return dirname
