"""The port's generic train loop (``training/loop.py``) against the JAX
package's, on the f32 SMOKE qwen1.5-4b: ``fit``'s loss history within
1e-5 of the reference's from the same weights and batches, the same
checkpoint steps on disk (each readable by the other package), and
``resume_or_init`` from a reference checkpoint.  AdamW at lr 1e-4, as
``tests/test_torch_training.py`` holds its step (Adam's first updates
divide by |g| + eps)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.data.synthetic import TokenTaskConfig as RefTask
from repro.data.synthetic import token_batches as ref_token_batches
from repro.models import LM as RefLM
from repro.parallel.steps import make_lm_loss as ref_lm_loss
from repro.training import checkpoint as ref_ck
from repro.training import loop as ref_loop
from repro.training import optim as ref_optim
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models.lm import LM
from repro_torch.parallel.steps import make_lm_loss
from repro_torch.training import checkpoint as ck
from repro_torch.training import loop
from repro_torch.training import optim

ARCH = "qwen1.5-4b"
BATCH, SEQ, STEPS = 4, 16, 4


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's ``fit`` over STEPS steps, logging and
    checkpointing every 2: its initial parameters (numpy), history and
    checkpoint directory."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    model = RefLM(ref_arch(ARCH).smoke)
    params = model.init(jax.random.key(0))
    init = jax.tree.map(np.asarray, params)
    opt = ref_optim.adamw(1e-4, grad_clip=1.0)
    state = ref_loop.init_state(params, opt)
    step = ref_loop.make_train_step(ref_lm_loss(model), opt, microbatches=2)
    data = ref_token_batches(RefTask(vocab=ref_arch(ARCH).smoke.vocab),
                             BATCH, SEQ, seed=5)
    final, history = ref_loop.fit(state, step, data, steps=STEPS,
                                  ckpt_dir=d, ckpt_every=2, log_every=1)
    return init, history, d, jax.tree.map(np.asarray, final.tree())


def _port(init):
    cfg = get_arch(ARCH).smoke
    model = LM(cfg, "cpu")
    opt = optim.adamw(1e-4, grad_clip=1.0)
    params = bridge.params_from_jax(init)
    return cfg, opt, loop.init_state(params, opt), make_lm_loss(model)


def _batches(vocab):
    from repro_torch.data.synthetic import TokenTaskConfig, token_batches
    for b in token_batches(TokenTaskConfig(vocab=vocab), BATCH, SEQ,
                           seed=5):
        yield {n: torch.from_numpy(a) for n, a in b.items()}


def test_fit_matches_reference_history_and_checkpoints(reference_run,
                                                       tmp_path):
    init, ref_history, ref_dir, ref_final = reference_run
    cfg, opt, state, loss_fn = _port(init)
    step = loop.make_train_step(loss_fn, opt, microbatches=2)
    seen = []
    final, history = loop.fit(state, step, _batches(cfg.vocab), steps=STEPS,
                              ckpt_dir=str(tmp_path), ckpt_every=2,
                              log_every=1, metrics_cb=seen.append)
    assert seen == history
    assert [r["step"] for r in history] == [r["step"] for r in ref_history] \
        == [1, 2, 3, 4]
    assert set(history[0]) == set(ref_history[0])
    np.testing.assert_allclose([r["loss"] for r in history],
                               [r["loss"] for r in ref_history], rtol=1e-5)
    assert final.step == int(ref_final["step"]) == STEPS
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(ref_dir)) \
        == ["step_2", "step_4"]
    assert ck.latest_step(str(tmp_path)) == ref_ck.latest_step(ref_dir) == 4
    for g, w in zip(jax.tree.leaves(bridge.params_to_jax(final.params)),
                    jax.tree.leaves(ref_final["params"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # the port's checkpoint reads back into the reference's tree
    back = ref_ck.restore(str(tmp_path), 4, ref_final)
    assert int(back["step"]) == STEPS


def test_resume_or_init_from_a_reference_checkpoint(reference_run):
    init, _, ref_dir, ref_final = reference_run
    _, _, state, _ = _port(init)
    assert loop.resume_or_init(state, None) is state
    got = loop.resume_or_init(state, ref_dir, device="cpu")
    assert got.step == STEPS
    for key in ("params", "opt_state"):
        want = jax.tree.leaves(ref_final[key])
        got_leaves = jax.tree.leaves(bridge.params_to_jax(getattr(got, key)))
        assert len(got_leaves) == len(want)
        for g, w in zip(got_leaves, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_resume_or_init_without_a_checkpoint_keeps_the_state(tmp_path):
    params = {"w": torch.ones(3)}
    opt = optim.adamw(1e-3)
    state = loop.init_state(params, opt)
    assert loop.resume_or_init(state, str(tmp_path)) is state
    assert state.tree()["step"] == 0
    again = loop.TrainState.from_tree(jax.tree.map(
        lambda x: x, {"params": params, "opt_state": state.opt_state,
                      "step": jnp.int32(3)}))
    assert again.step == 3 and isinstance(again.step, int)
