"""Each frozen copy of the yardstick equals its origin at this commit; a
later change to the origin shows here as drift, and the copy stays."""

import ast
import importlib

import pytest

from bench_cuda import spec

FROZEN = ("work", "flops", "ref_state_dict")


def _segments(path, names) -> dict:
    src = path.read_text()
    out = {}
    for node in ast.parse(src).body:
        name = getattr(node, "name", None)
        if (name is None and isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
        if name in names:
            out[name] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("module", FROZEN)
def test_frozen_copy_equals_origin(module):
    mod = importlib.import_module(f"bench_cuda.frozen.{module}")
    origin = _segments(spec.ROOT / mod.ORIGIN, mod.FROZEN)
    copy = _segments(spec.HERE / "frozen" / f"{module}.py", mod.FROZEN)
    assert set(copy) == set(mod.FROZEN), "the copy lacks a frozen name"
    assert set(origin) == set(mod.FROZEN), f"{mod.ORIGIN} lost a name"
    for name in mod.FROZEN:
        assert copy[name] == origin[name], f"{module}.{name} drifted"
