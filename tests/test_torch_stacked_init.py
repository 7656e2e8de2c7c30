"""The in-place stacked init (``models/blocks.py::_stacked``), torch only.

``_stacked`` fills each ``[L, ...]`` leaf layer by layer and drops each
draw, where it used to keep every layer's draw and stack them.  Held
here: every registered config's SMOKE parameters, for serving and for
training (``master=True``), equal tensor for tensor (``torch.equal``,
dtype and shape too) to those of the old stack-of-draws, kept below as
the reference; and no draw outlives the next one.
"""
import weakref

import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import blocks
from repro_torch.models.lm import LM
from repro_torch.utils.trees import tree_leaves, tree_map


def _stacked_of_draws(fn, layers):
    """The stack-of-draws init that ``_stacked`` replaced."""
    if layers is None:
        return fn()
    draws = [fn() for _ in range(layers)]
    return tree_map(lambda *ts: torch.stack(ts), draws[0], *draws[1:])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, t in tree.items()
                for k, v in _flat(t, f"{prefix}/{name}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_in_place_init_equals_stack_of_draws(arch, master, monkeypatch):
    model = LM(get_arch(arch).smoke, "cpu")
    got = _flat(model.init(torch.Generator().manual_seed(5), master=master))
    monkeypatch.setattr(blocks, "_stacked", _stacked_of_draws)
    want = _flat(model.init(torch.Generator().manual_seed(5), master=master))
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
        assert torch.equal(got[name], t), name


def test_stacked_holds_one_draw_at_a_time():
    """When a layer is drawn, no earlier layer's draw is alive: the peak is
    the stack plus one draw.  The result is the draws in order."""
    g = torch.Generator().manual_seed(0)
    alive = []

    def draw():
        assert all(ref() is None for ref in alive)
        out = {"w": torch.randn((3, 4), generator=g),
               "b": [torch.randn(2, generator=g).to(torch.bfloat16)]}
        alive.extend(weakref.ref(t) for t in tree_leaves(out))
        return out

    out = blocks._stacked(draw, 5)
    assert all(ref() is None for ref in alive)
    g.manual_seed(0)
    want = _stacked_of_draws(
        lambda: {"w": torch.randn((3, 4), generator=g),
                 "b": [torch.randn(2, generator=g).to(torch.bfloat16)]}, 5)
    assert out["b"][0].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(out), tree_leaves(want)):
        assert torch.equal(a, b)
