"""The port's checkpoints (``training/checkpoint.py``): the cases of the
reference's ``tests/test_checkpoint.py`` on torch trees, device placement
in place of its resharding case, and the disk format shared with the JAX
package: either package reads the other's checkpoint of a SMOKE train
state with values equal, both spell keys as ``jax.tree_util.keystr``, and
both packages' ``latest_step`` / ``prune`` agree on the same directories.
The cross-package cases import the reference inside the test; the rest
need torch and numpy only.
"""
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.training import checkpoint as ck
from repro_torch.utils.trees import tree_leaves


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "blocks": (torch.arange(4.0), torch.ones((2, 3)))},
        "step": 7,
    }


def _zeros_like(tree):
    return {"params": {"w": torch.zeros((8, 16)),
                       "blocks": (torch.zeros(4), torch.zeros((2, 3)))},
            "step": 0}


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y and type(x) is type(y)


def test_roundtrip(tmp_path):
    tree = make_tree()
    ck.save(str(tmp_path), 10, tree)
    assert ck.latest_step(str(tmp_path)) == 10
    _same(ck.restore(str(tmp_path), 10, _zeros_like(tree)), tree)


def test_atomic_commit_no_tmp_visible(tmp_path):
    ck.save(str(tmp_path), 3, make_tree())
    names = os.listdir(tmp_path)
    assert "step_3" in names
    assert not any(n.endswith(".tmp") for n in names)


def test_corrupt_checkpoint_skipped(tmp_path):
    ck.save(str(tmp_path), 1, make_tree())
    ck.save(str(tmp_path), 2, make_tree())
    with open(tmp_path / "step_2" / "manifest.json", "w") as f:
        f.write("{not json")
    assert ck.latest_step(str(tmp_path)) == 1


def test_mid_save_crash_invisible(tmp_path):
    """A directory that was never renamed (a crash mid-save) is ignored."""
    ck.save(str(tmp_path), 1, make_tree())
    os.makedirs(tmp_path / "step_5.tmp")
    (tmp_path / "step_5.tmp" / "proc_0.npz").write_bytes(b"partial")
    assert ck.latest_step(str(tmp_path)) == 1


def test_failed_save_removes_its_tmp(tmp_path, monkeypatch):
    """A save that fails mid-write (here a full disk on the second
    array) leaves neither a ``.tmp`` directory nor a checkpoint."""
    ck.save(str(tmp_path), 1, make_tree())
    write, calls = np.lib.format.write_array, []

    def full_disk(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise OSError(28, "No space left on device")
        return write(*a, **kw)
    monkeypatch.setattr(np.lib.format, "write_array", full_disk)
    with pytest.raises(OSError, match="No space"):
        ck.save(str(tmp_path), 2, make_tree())
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    assert ck.latest_step(str(tmp_path)) == 1


def test_extra_manifest_fields(tmp_path):
    """``extra`` rides the manifest beside the reference's fields, which
    it cannot override."""
    ck.save(str(tmp_path), 3, make_tree(), extra={"plan_cell": [2, 1],
                                                  "step": 99})
    meta = ck.manifest(str(tmp_path), 3)
    assert meta["plan_cell"] == [2, 1] and meta["step"] == 3
    assert ck.latest_step(str(tmp_path)) == 3


def test_prune_keeps_newest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, make_tree())
    ck.prune(str(tmp_path), keep=2)
    left = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert left == ["step_4", "step_5"]


def test_restore_shape_mismatch_raises(tmp_path):
    ck.save(str(tmp_path), 1, make_tree())
    bad = make_tree()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), 1, bad)


def test_restore_missing_array_raises_key_error(tmp_path):
    ck.save(str(tmp_path), 1, make_tree())
    more = dict(make_tree(), error_fb={"w": torch.zeros(3)})
    with pytest.raises(KeyError, match="error_fb"):
        ck.restore(str(tmp_path), 1, more)


@pytest.mark.parametrize("to_meta", [False, True])
def test_restore_places_leaves_on_the_device(tmp_path, to_meta):
    """``device=`` in place of the reference's shardings: every leaf lands
    on it, from a template on the CPU or on ``meta`` (shapes only)."""
    tree = make_tree()
    ck.save(str(tmp_path), 1, tree)
    target = make_tree(seed=1)
    if to_meta:
        target = {"params": {"w": torch.empty((8, 16), device="meta"),
                             "blocks": (torch.empty(4, device="meta"),
                                        torch.empty((2, 3), device="meta"))},
                  "step": 0}
        with pytest.raises(ValueError, match="device="):
            ck.restore(str(tmp_path), 1, target)
    out = ck.restore(str(tmp_path), 1, target, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(out["params"]))
    _same(out, tree)


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_damaged_array_raises(tmp_path, damage):
    """A flipped byte fails the member's CRC-32; a cut file fails too."""
    ck.save(str(tmp_path), 1, make_tree())
    path = tmp_path / "step_1" / "proc_0.npz"
    data = bytearray(path.read_bytes())
    # 300 bytes into the data of ['params']['w'] (8 x 16 f32, 512 bytes)
    at = data.index(b"\x93NUMPY", data.index(b"['params']['w'].npy")) + 428
    if damage == "flip":
        data[at] ^= 0x40
    else:
        data = data[:at]
    path.write_bytes(bytes(data))
    with pytest.raises((ValueError, zipfile.BadZipFile)):
        ck.restore(str(tmp_path), 1, _zeros_like(make_tree()))


def test_dtype_cast_on_restore(tmp_path):
    ck.save(str(tmp_path), 1, {"w": torch.ones((4,), dtype=torch.float32)})
    out = ck.restore(str(tmp_path), 1,
                     {"w": torch.zeros((4,), dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.ones(4, dtype=torch.bfloat16))


def test_bf16_leaves_are_stored_widened_and_come_back_exact(tmp_path):
    w = torch.randn((5, 7), generator=torch.Generator().manual_seed(3)) \
        .to(torch.bfloat16)
    ck.save(str(tmp_path), 2, {"w": w, "step": 2})
    meta = ck.manifest(str(tmp_path), 2)
    assert meta["arrays"] == {"['step']": {"shape": [], "dtype": "int32"},
                              "['w']": {"shape": [5, 7],
                                        "dtype": "float32"}}
    with np.load(tmp_path / "step_2" / "proc_0.npz") as z:
        np.testing.assert_array_equal(z["['w']"], w.float().numpy())
        assert z["['step']"].dtype == np.int32 and int(z["['step']"]) == 2
    out = ck.restore(str(tmp_path), 2, {"w": torch.zeros_like(w), "step": 0})
    assert torch.equal(out["w"], w) and out["step"] == 2


# ---------------------------------------------------------------------------
# The disk format shared with the JAX package
# ---------------------------------------------------------------------------


def _smoke_state():
    """A SMOKE qwen train state after one AdamW step (m and v nonzero),
    the top-k hop's EF buffer and the compressor's residuals."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.parallel.steps import make_lm_train_step
    from repro_torch.training.compress import init_error_fb
    from repro_torch.training.optim import adamw
    cfg = get_arch("qwen1.5-4b").smoke
    model = LM(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), master=True)
    opt = adamw(1e-3, grad_clip=1.0)
    state = {"params": params, "opt_state": opt.init(params), "step": 0,
             "error_fb": init_error_fb(params)}
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)))
    step = make_lm_train_step(model, opt, compress=True)
    state, _ = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    state["wire_ef"] = torch.randn((2, 3, 1, 8, cfg.d_model),
                                   generator=torch.Generator().manual_seed(1))
    return state


def test_keys_are_spelled_as_jax_keystr():
    import jax

    from repro_torch import bridge
    state = _smoke_state()
    jtree = bridge.train_state_to_jax(state)
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = [jax.tree_util.keystr(path) for path, _ in flat]
    assert list(ck.flatten(state)) == want
    mixed = {"b": (np.zeros(1), {"z": np.zeros(1), "a": [np.zeros(1)]}),
             "a": None}
    flat, _ = jax.tree_util.tree_flatten_with_path(mixed)
    assert list(ck.flatten(mixed)) == [jax.tree_util.keystr(p)
                                       for p, _ in flat]


def test_reference_restores_a_port_checkpoint(tmp_path):
    import jax

    from repro.training import checkpoint as ref_ck
    from repro_torch import bridge
    state = _smoke_state()
    ck.save(str(tmp_path), 1, state)
    assert ref_ck.latest_step(str(tmp_path)) == 1
    target = bridge.train_state_to_jax(state)
    got = ref_ck.restore(str(tmp_path), 1, _jax_zeros(target))
    want_leaves = jax.tree.leaves(target)
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(want_leaves) > 10
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _jax_zeros(tree):
    import jax
    return jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), tree)


def test_port_restores_a_reference_checkpoint(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.training import checkpoint as ref_ck
    from repro_torch import bridge
    state = _smoke_state()
    jtree = bridge.train_state_to_jax(state)
    ref_ck.save(str(tmp_path), 4, jax.tree.map(jnp.asarray, jtree))
    assert ck.latest_step(str(tmp_path)) == 4
    out = ck.restore(str(tmp_path), 4, dict(state))
    _same(out, state)
    meta = ck.manifest(str(tmp_path), 4)
    assert meta["num_processes"] == 1 and meta["step"] == 4


def _layout(root, steps, tmp=(), corrupt=(), junk=()):
    for s in steps:
        ck.save(str(root), s, {"w": torch.zeros(2), "step": s})
    for s in tmp:
        os.makedirs(root / f"step_{s}.tmp")
    for s in corrupt:
        with open(root / f"step_{s}" / "manifest.json", "w") as f:
            f.write("{")
    for name in junk:
        os.makedirs(root / name)


@pytest.mark.parametrize("layout,keep", [
    (dict(steps=()), 3),
    (dict(steps=(1, 2, 3, 4, 5)), 2),
    (dict(steps=(3, 10, 7), tmp=(12,), corrupt=(10,)), 1),
    (dict(steps=(1, 2), junk=("step_x", "other")), 3),
    (dict(steps=(5, 6, 7, 8), corrupt=(8,), tmp=(9,)), 3)])
def test_latest_step_and_prune_agree_with_the_reference(tmp_path, layout,
                                                        keep):
    from repro.training import checkpoint as ref_ck
    roots = tmp_path / "port", tmp_path / "ref"
    for root in roots:
        root.mkdir()
        _layout(root, **layout)
    assert ck.latest_step(str(roots[0])) == ref_ck.latest_step(str(roots[1]))
    ck.prune(str(roots[0]), keep=keep)
    ref_ck.prune(str(roots[1]), keep=keep)
    assert sorted(os.listdir(roots[0])) == sorted(os.listdir(roots[1]))
    assert ck.latest_step(str(roots[0])) == ref_ck.latest_step(str(roots[1]))
    assert ck.latest_step(str(tmp_path / "absent")) is None
    ck.prune(str(tmp_path / "absent"))


def test_manifest_matches_the_reference_layout(tmp_path):
    from repro.training import checkpoint as ref_ck
    tree = {"params": {"w": np.ones((2, 3), np.float32)},
            "step": np.int32(3)}
    ref_ck.save(str(tmp_path / "ref"), 3, tree)
    ck.save(str(tmp_path / "port"), 3,
            {"params": {"w": torch.ones((2, 3))}, "step": 3})
    for side in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / side / "step_3")) == [
            "manifest.json", "proc_0.npz"]
    with open(tmp_path / "ref" / "step_3" / "manifest.json") as f:
        want = json.load(f)
    assert ck.manifest(str(tmp_path / "port"), 3) == want
