"""The port's C²P²SL step, batch sharding and model split against the JAX
package's, on the CPU.

Parameters, batches and helpers are those of ``test_torch_training.py``
(the smoke RWKV config in f32, the reference's ``init`` through
``bridge.py``).  Tolerances: the C²P²SL step 1e-5 on the loss and on
every parameter, the bound the port holds its model to in f32, both
against the reference's step and against the port's own full-batch step;
the split's loss 1e-6 against the unsplit forward (the same arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sl import c2p2sl as ref_c2p2sl
from repro.sl import split as ref_split
from repro.training import optim as ref_optim
from repro_torch import bridge
from repro_torch.models.lm import LM
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.sl import c2p2sl
from repro_torch.sl.split import lm_split
from repro_torch.training import optim
from repro_torch.utils.trees import tree_leaves
from test_torch_training import (CFG, close_trees, port_batch, port_state,
                                 ref_compile, reference_setup)


@pytest.fixture(scope="module")
def setup():
    return reference_setup()


def _pairs(a, b):
    """Matching leaves of two trees of nested dicts, by key."""
    if isinstance(b, dict):
        return [p for k in b for p in _pairs(a[k], b[k])]
    return [(a, b)]


def _sl_tree(state):
    return {"ue_params": state.ue_params, "bs_params": state.bs_params,
            "opt_state_ue": state.opt_state_ue,
            "opt_state_bs": state.opt_state_bs, "step": state.step}


def test_shard_batch_matches_reference():
    x = np.arange(23)[:, None] * np.ones((1, 3), np.int32)
    y = np.arange(23)
    for b, k in (([5, 3], 4), ([10, 0, 13], 3), ([4, 4], 5), ([1, 30], 2)):
        want = ref_c2p2sl.shard_batch(x, y, np.array(b), k)
        got = c2p2sl.shard_batch(x, y, np.array(b), k)
        for ws, gs in zip(want, got):
            assert len(ws) == len(gs)
            for wi, gi in zip(ws, gs):
                assert [len(a) for a in wi] == [len(a) for a in gi]
                for wa, ga in zip(wi, gi):
                    np.testing.assert_array_equal(wa, ga)


def test_c2p2sl_step_matches_reference_and_full_batch(setup):
    """2 UEs with ragged micro-batches (b = [3, 1], k = 2: sizes [2, 1]
    and [1, 0], so one UE sits out a micro-batch) through lm_split: the
    port's step against the reference's, and against the port's own
    full-batch step (SGD: linear in the gradients)."""
    ref, tree, batches = setup
    b = {n: a[:4] for n, a in batches[0].items()}
    alloc = np.array([3, 1])
    ref_opt = ref_optim.sgd(0.1, momentum=0.9)
    spec_r = ref_split.lm_split(ref, 1)
    st_r = _sl_tree(ref_c2p2sl.init_sl_state(
        spec_r, jax.tree.map(jnp.asarray, tree), ref_opt))
    xs, ys = ref_c2p2sl.shard_batch(jnp.asarray(b["tokens"]),
                                    jnp.asarray(b["labels"]), alloc, 2)
    st_r, mets_r = ref_compile(ref_c2p2sl.make_c2p2sl_step(spec_r, ref_opt, 2),
                               st_r, xs, ys)(st_r, xs, ys)

    model = LM(CFG, "cpu")
    opt = optim.sgd(0.1, momentum=0.9)
    spec = lm_split(model, 1)
    st = _sl_tree(c2p2sl.init_sl_state(spec, bridge.params_from_jax(tree),
                                       opt))
    pb = port_batch(b)
    xs, ys = c2p2sl.shard_batch(pb["tokens"], pb["labels"], alloc, 2)
    assert [[len(a) for a in xi] for xi in xs] == [[2, 1], [1, 0]]
    st, mets = c2p2sl.make_c2p2sl_step(spec, opt, 2)(st, xs, ys)
    np.testing.assert_allclose(float(mets["loss"]), float(mets_r["loss"]),
                               rtol=1e-5)
    for side in ("ue_params", "bs_params"):
        close_trees(st[side], st_r[side], 1e-5)

    full_opt = optim.sgd(0.1, momentum=0.9)
    full = port_state(tree, full_opt)
    full, fm = make_lm_train_step(model, full_opt)(full, pb)
    np.testing.assert_allclose(float(mets["loss"]), float(fm["loss"]),
                               rtol=1e-5)
    merged = spec.merge_params(st["ue_params"], st["bs_params"])
    for a, c in _pairs(merged, full["params"]):
        torch.testing.assert_close(a, c.detach(), rtol=1e-5, atol=1e-5)

    eps = c2p2sl.make_c2p2sl_step(spec, opt, 2, epsl_aggregate=True)
    st_e = _sl_tree(c2p2sl.init_sl_state(spec, bridge.params_from_jax(tree),
                                         opt))
    st_e, _ = eps(st_e, xs, ys)
    assert max(float((a - c).detach().abs().max()) for a, c in zip(
        tree_leaves(st_e["ue_params"]), tree_leaves(st["ue_params"]))) > 1e-6


def test_lm_split_round_trip_and_loss(setup):
    _ref, tree, batches = setup
    model = LM(CFG, "cpu")
    params = bridge.params_from_jax(tree)
    spec = lm_split(model, 1)
    ue, bs = spec.split_params(params)
    assert ue["blocks"]["time"]["w_r"].data_ptr() \
        != params["blocks"]["time"]["w_r"].data_ptr()
    for a, c in _pairs(spec.merge_params(ue, bs), params):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    b = port_batch(batches[1])
    with torch.no_grad():
        loss, _ = spec.bs_loss(bs, spec.ue_fwd(ue, b["tokens"]), b["labels"])
        want, _ = model.forward(params, b)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        lm_split(model, CFG.num_layers)
