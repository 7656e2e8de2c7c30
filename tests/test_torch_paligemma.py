"""paligemma-3b, the prefix-LM, in the port against the JAX package, on the
CPU.

The SMOKE config (2 layers, d 64, 4 q heads on 1 kv head of 16, 8 stub
patches) in f32, with the reference's weights carried by ``bridge.py``
(the norms perturbed) and patch embeddings, tokens and labels from numpy
seeds.  Held at 1e-5 relative to the largest value: the training
forward's loss and final hidden states with ``patch_embeds`` before the
tokens (bidirectional over them, causal after, their labels -1), every
parameter's gradient, ``prefill_with_cache`` (the last logits and the k /
v cache, position 8 + S) and teacher-forced decode steps, and the
C²P²SL step at S 2, k 2, int8 and, at 4 layers, at S 2, v 2, k 2,
``int8+topk0.25``, whose EF buffer carries the 8 prefix rows (the
reference's pipelined steps run in a subprocess on 2 virtual devices).
The flash plain versions with ``prefix_len`` against the reference's
``chunked_attention(prefix_len=...)`` and its ``jax.grad``.  The
launchers: ``build_batch_iter``'s patch stream bit for bit, a resumed
train run equal to the uninterrupted one, the serve CLI's tokens (the
token loop, no patches) equal to the reference CLI's on the same
weights, and the refusals.  Fault 22: the planner bills the tokens
without the prefix, in both packages alike.

The reference runs through ``_ref_exe``: jitted and compiled at LLVM
optimisation level 0 (each graph runs a few times on small inputs).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.configs import param_specs
from repro.models import LM as RefLM
from repro.models.common import chunked_attention as ref_chunked_attention
from repro.parallel.steps import make_decode_step
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs.paligemma_3b import SKIPS
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, train
from repro_torch.models.lm import LM
from repro_torch.parallel import pipeline
from repro_torch.parallel.steps import make_lm_train_step
from repro_torch.training import optim
from repro_torch.utils.trees import tree_leaves

ARCH = "paligemma-3b"
CFG_REF = ref_arch(ARCH).smoke
CFG = get_arch(ARCH).smoke
P = CFG.num_patches
TOL = 1e-5
B, S, G = 2, 7, 4
SMOKE = ["--arch", ARCH, "--size", "smoke", "--device", "cpu"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _ref_exe(fn, *args):
    """``fn`` of the reference, jitted and compiled for ``args``' shapes at
    LLVM optimisation level 0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _close(got, want, tol=TOL):
    """Within ``tol`` relative to the largest value."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _perturb(tree, rng):
    """Random norm weights (the reference inits them to 0 or 1)."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if any(n in path for n in ("ln1", "ln2", "final_norm")):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                np.float32)
        return node
    return walk(tree)


@pytest.fixture(scope="module")
def ref_init():
    ref = RefLM(CFG_REF)
    key = jax.random.key(0)
    return ref, jax.tree.map(np.asarray, _ref_exe(ref.init, key)(key))


@pytest.fixture(scope="module")
def models(ref_init):
    ref, tree = ref_init
    tree = _perturb(tree, np.random.default_rng(1))
    return ref, jax.tree.map(jnp.asarray, tree), LM(CFG, "cpu"), \
        bridge.params_from_jax(tree)


def _inputs(seed=7, s=S, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, P, CFG.d_model)).astype(np.float32)
    labels = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    return toks, patches, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ the config


def test_configs_match_reference_and_the_parameter_counts():
    """FULL and SMOKE field for field; the long_500k skip; FULL's
    ``param_count()`` 2,508,587,008 in both packages against the
    2,508,662,784 parameters the reference's tree holds (the norm
    vectors, 37 x 2048 = 75,776, are not counted)."""
    for size in ("full", "smoke"):
        assert dataclasses.asdict(getattr(get_arch(ARCH), size)) == \
            dataclasses.asdict(getattr(ref_arch(ARCH), size))
    assert SKIPS == {"long_500k": ref_arch(ARCH).skip_reason("long_500k")}
    full = get_arch(ARCH).full
    drawn = sum(int(np.prod(a.shape))
                for a in jax.tree.leaves(param_specs(ref_arch(ARCH).full)))
    assert full.param_count() == ref_arch(ARCH).full.param_count() \
        == 2_508_587_008
    assert drawn == 2_508_662_784 == full.param_count() + 37 * 2048


def test_init_layout_and_the_bridge(ref_init):
    """The port's init has the reference's tree: tied (no head leaf), the
    stacked attention with one kv head of 16; the bridge carries it both
    ways unchanged."""
    _ref, tree = ref_init
    fresh = bridge.params_to_jax(LM(CFG, "cpu").init(
        torch.Generator().manual_seed(0), master=True))
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, tree)
    assert "head" not in fresh
    assert fresh["blocks"]["attn"]["k"].shape == (2, 64, 16)
    back = bridge.params_to_jax(bridge.params_from_jax(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("prefix_len,window", [(0, 0), (5, 0), (12, 0),
                                               (40, 0), (12, 6)])
def test_plain_prefix_attention_matches_reference(prefix_len, window):
    """``attention_plain`` and ``attention_bwd_plain`` with the prefix
    against the reference's ``chunked_attention(prefix_len=...)`` (its
    q chunk below Sq, so its chunked branch runs) and its ``jax.grad``:
    GQA 4 : 1 at dh 16, S 24; a ragged prefix, one past Sq, and a window
    on top of a prefix."""
    rng = np.random.default_rng(prefix_len + 100 * window)
    s, hq, hkv, dh = 24, 4, 1, 16
    q, do = (rng.standard_normal((2, s, hq, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    pos = jnp.arange(s)

    def ref(q_, k_, v_):
        return ref_chunked_attention(q_, k_, v_, q_positions=pos,
                                     kv_positions=pos, causal=True,
                                     window=window, prefix_len=prefix_len,
                                     q_chunk=8)

    out_r, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    grads_r = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (_t(a).transpose(1, 2) for a in (q, k, v, do))
    kw = dict(causal=True, window=window, prefix_len=prefix_len)
    out, lse = fa.attention_plain_lse(qt, kt, vt, **kw)
    _close(out.transpose(1, 2), out_r)
    grads = fa.attention_bwd_plain(qt, kt, vt, out, lse, dot, **kw)
    for g, w in zip(grads, grads_r):
        _close(g.transpose(1, 2), w)


# ------------------------------------------------------------ the model


def test_forward_loss_and_hidden_states_match_reference(models):
    ref, rp, port, params = models
    toks, patches, labels = _inputs()
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "patch_embeds": jnp.asarray(patches)}
    loss_r, mets_r = _ref_exe(ref.forward, rp, batch)(rp, batch)
    nolab = {k: v for k, v in batch.items() if k != "labels"}
    hid_r = _ref_exe(ref.hidden, rp, nolab)(rp, nolab)
    pb = {"tokens": _t(toks).long(), "labels": _t(labels),
          "patch_embeds": _t(patches)}
    with torch.no_grad():
        loss_p, mets_p = port.forward(params, pb)
        hid_p = port.hidden(params, pb)
    assert tuple(hid_p.shape) == hid_r.shape == (B, P + S, CFG.d_model)
    _close(hid_p, hid_r)
    _close(loss_p, loss_r)
    _close(mets_p["xent"], mets_r["xent"])


def test_gradients_match_reference(models):
    """Every parameter's gradient of the loss (the tied embedding's from
    the head and the lookup together) within 1e-5 of ``jax.grad``."""
    ref, rp, port, params = models
    toks, patches, labels = _inputs(seed=11)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "patch_embeds": jnp.asarray(patches)}
    grads_r = _ref_exe(jax.grad(lambda p, b: ref.forward(p, b)[0]), rp,
                       batch)(rp, batch)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = port.forward(params, {
            "tokens": _t(toks).long(), "labels": _t(labels),
            "patch_embeds": _t(patches)})
        got = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = bridge.params_to_jax(_replace_leaves(
        params, {id(t): g for t, g in zip(leaves, got)}))
    flat_p, flat_r = (
        {jax.tree_util.keystr(path): a
         for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
        for tree in (grads, grads_r))
    assert flat_p.keys() == flat_r.keys() and len(flat_p) == len(got)
    for name, want in flat_r.items():
        _close(flat_p[name], want)


def _replace_leaves(tree, by_leaf):
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, by_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace_leaves(v, by_leaf) for v in tree)
    return by_leaf[id(tree)].detach()


def test_prefill_with_patches_and_decode_match_reference(models):
    """Prefill logits, the k / v cache and the position P + S; then G
    teacher-forced decode steps from both caches.  A cache shorter than
    P + S raises."""
    ref, rp, port, params = models
    toks, patches, _ = _inputs()
    cache_len = P + S + G
    batch = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(
        patches)}
    rl, rs = _ref_exe(lambda p, b: ref.prefill_with_cache(
        p, b, cache_len, cache_dtype=jnp.float32), rp, batch)(rp, batch)
    pb = {"tokens": _t(toks).long(), "patch_embeds": _t(patches)}
    with torch.no_grad():
        pl, ps = port.prefill_with_cache(params, pb, cache_len,
                                         torch.float32)
        with pytest.raises(ValueError, match="exceeds cache_len"):
            port.prefill_with_cache(params, pb, P + S - 1, torch.float32)
    assert ps["position"] == int(rs["position"]) == P + S
    _close(pl, rl)
    for name in ("k", "v"):
        assert tuple(ps["cache"][name].shape) == rs["cache"][name].shape
        _close(ps["cache"][name], rs["cache"][name])
    decode = _ref_exe(make_decode_step(ref), rp, rs,
                      jnp.zeros((B, 1), jnp.int32))
    forced = np.random.default_rng(9).integers(0, CFG.vocab, (B, G))
    cache = ps["cache"]
    for i in range(G):
        tok = forced[:, i:i + 1].astype(np.int32)
        rl, rs = decode(rp, rs, jnp.asarray(tok))
        with torch.no_grad():
            pl, cache = port.decode_step(params, _t(tok).long(), cache,
                                         P + S + i)
        _close(pl, rl)
    for name in ("k", "v"):
        _close(cache[name], rs["cache"][name])


def test_unported_vlm_and_tied_dense_stacks_raise():
    for bad in (dict(tie_embeddings=False), dict(num_patches=0),
                dict(pattern=("attn", "local"), window=4)):
        with pytest.raises(NotImplementedError, match="vlm"):
            LM(dataclasses.replace(CFG, **bad), "cpu")
    with pytest.raises(NotImplementedError, match="untied head"):
        LM(dataclasses.replace(CFG, family="dense"), "cpu")


# ------------------------------------------------------------ training

_REF_STEPS = """
    import dataclasses, pickle, sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.launch.train import build_batch_iter
    from repro.models import LM
    from repro.parallel.compat import make_mesh, mesh_context
    from repro.parallel.pipeline import PipelineSpec, wire_ef_zeros
    from repro.parallel.steps import make_lm_train_step
    from repro.training.optim import sgd

    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
    out = {}
    for name, layers, spec in (
            ("int8", 2, PipelineSpec(num_stages=2, microbatches=2,
                                     wire_dtype="int8")),
            ("topk", 4, PipelineSpec(num_stages=2, microbatches=2,
                                     virtual_stages=2,
                                     wire_dtype="int8+topk0.25"))):
        cfg = dataclasses.replace(get_arch("paligemma-3b").smoke,
                                  num_layers=layers)
        m = LM(cfg)
        batch = next(build_batch_iter(cfg, 4, 8, seed=3))
        opt = sgd(0.1)
        params = m.init(jax.random.key(0))
        state = {"params": params, "opt_state": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        ef = wire_ef_zeros(cfg, spec, 4, 8)
        if ef is not None:
            state["wire_ef"] = ef
        init = jax.tree.map(np.asarray, state)
        step = jax.jit(make_lm_train_step(m, opt, pipeline=spec, mesh=mesh))
        with mesh_context(mesh):
            state, mets = step(state, jax.tree.map(jnp.asarray, batch))
        out[name] = {"init": init, "batch": batch,
                     "loss": float(mets["loss"]),
                     "state": jax.tree.map(np.asarray, state)}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref_pipelined(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REF_STEPS), str(path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name,layers,spec", [
    ("int8", 2, pipeline.PipelineSpec(2, 2, wire_dtype="int8")),
    ("topk", 4, pipeline.PipelineSpec(2, 2, virtual_stages=2,
                                      wire_dtype="int8+topk0.25"))])
def test_pipelined_step_matches_reference(ref_pipelined, name, layers, spec):
    """One SGD step (lr 0.1, momentum 0.9) of the C²P²SL pipeline from
    the reference's init and batch (4 x 8 tokens with 8 patches each):
    the loss, every parameter, and at top-k the EF buffer [S, ticks, mb,
    8 + 8, d] (``wire_ef_zeros`` counts the prefix rows the hop carries)
    within 1e-5; each hop's bytes the bill of its 2 x 16 rows.  SGD, not
    AdamW: AdamW's first step is about lr x sign(g), so where the int8
    hop rounds one value the other way (the reference's scale is one f32
    ULP off, ROADMAP Queue 3, fault 1) a near-zero gradient's element
    moves by a step of lr (fault 13)."""
    from repro_torch.runtime import protocol
    ref = ref_pipelined[name]
    cfg = dataclasses.replace(CFG, num_layers=layers)
    state = bridge.train_state_from_jax(ref["init"])
    ef = pipeline.wire_ef_zeros(cfg, spec, 4, 8)
    if name == "topk":
        assert tuple(ef.shape) == tuple(ref["init"]["wire_ef"].shape) \
            == (2, pipeline.wire_ef_ticks(spec), 2, 8 + P, CFG.d_model)
    else:
        assert ef is None and "wire_ef" not in state
    opt = optim.sgd(0.1)
    step = make_lm_train_step(LM(cfg, "cpu"), opt, pipeline=spec)
    batch = {n: _t(a) for n, a in ref["batch"].items()}
    assert tuple(batch["patch_embeds"].shape) == (4, P, CFG.d_model)
    step.meter.reset()
    state, mets = step(state, batch)
    np.testing.assert_allclose(float(mets["loss"]), ref["loss"], rtol=TOL)
    got = bridge.train_state_to_jax(state)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(ref["state"]["params"])):
        _close(a, b)
    hops = spec.num_stages * spec.virtual_stages - 1
    up = protocol.billed_hop_bytes(2 * (8 + P) * CFG.d_model, CFG.d_model,
                                   spec.wire_dtype, 4)
    assert step.meter.up == 2 * hops * up
    assert step.meter.hops_up == step.meter.hops_down == 2 * hops
    if name == "topk":
        _close(got["wire_ef"], ref["state"]["wire_ef"])
        assert np.abs(got["wire_ef"]).max() > 0


def test_build_batch_iter_matches_reference():
    """The patch stream bit for bit: [4, 8, 64] f32 from its own
    ``default_rng(seed + 1)``, one draw a batch after the tokens'."""
    from repro.launch.train import build_batch_iter as ref_iter
    port = train.build_batch_iter(CFG, 4, 8, seed=5)
    ref = ref_iter(CFG_REF, 4, 8, seed=5)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert sorted(a) == sorted(b) == ["labels", "patch_embeds",
                                          "tokens"]
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
    assert a["patch_embeds"].shape == (4, P, CFG.d_model)
    assert a["patch_embeds"].dtype == np.float32


def test_resumed_train_run_equals_the_uninterrupted_run(tmp_path):
    """Steps 1-2 with a checkpoint at 2, then step 3 from it: the loss
    and every leaf of the final state equal the 3-step run's bit for bit
    (the third batch's patches drawn after the first two's, as in the
    uninterrupted run); the int8 hop's bytes the bill of 2 x (8 + 8)
    rows."""
    from repro_torch.runtime import protocol
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        argv = SMOKE + ["--batch", "4", "--seq", "8", "--steps", "3",
                        "--log-every", "0", "--pipeline-stages", "2",
                        "--pipeline-k", "2", "--wire-dtype", "int8"]
        whole = train.main(argv)
        ck = str(tmp_path / "ck")
        train.main(argv + ["--ckpt-dir", ck, "--ckpt-every", "2"])
        assert sorted(os.listdir(ck)) == ["step_2"]
        resumed = train.main(argv + ["--ckpt-dir", ck])
    finally:
        torch.set_num_threads(threads)
    billed = protocol.billed_hop_bytes(2 * (8 + P) * CFG.d_model,
                                       CFG.d_model, "int8", 4)
    for row in whole["rows"]:
        assert np.isfinite(row["loss"])
        assert row["hop_bytes_up"] == row["hop_bytes_down"] == 2 * billed
    assert resumed["ckpt"]["resumed_from"] == 2
    assert [r["step"] for r in resumed["rows"]] == [3]
    assert resumed["rows"][0]["loss"] == whole["rows"][2]["loss"]
    for key in ("params", "opt_state"):
        la, lb = tree_leaves(resumed["state"][key]), \
            tree_leaves(whole["state"][key])
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------ serving


def test_serve_cli_tokens_match_reference_cli(ref_init, monkeypatch):
    """The serve CLI at SMOKE on the reference's weights (``LM.init``
    replaced by the bridge of the reference's init from the same seed):
    the vlm family takes the token loop without ``--token-loop-prefill``
    and without patches, as the reference's CLI does, and emits its
    greedy tokens."""
    from repro.launch import serve as ref_serve
    _ref, tree = ref_init
    monkeypatch.setattr(LM, "init", lambda self, gen, master=False:
                        bridge.params_from_jax(tree))
    argv = ["--arch", ARCH, "--size", "smoke", "--batch", "2",
            "--prompt-len", "6", "--gen", "5"]
    got = serve.main(argv + ["--device", "cpu"])
    want = ref_serve.main(argv)
    assert got["prefill_launches"] == {}
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want))
    loop = serve.main(argv + ["--device", "cpu", "--token-loop-prefill"])
    assert torch.equal(loop["tokens"], got["tokens"])


def test_serve_cli_refusals():
    """--continuous (the engine's slot arena serves decoder-only token
    LMs) and --split-cut (tied embeddings cannot be split at the head,
    the first of ``SplitDecode``'s checks, as in the reference)."""
    argv = SMOKE + ["--batch", "2", "--prompt-len", "6", "--gen", "4"]
    with pytest.raises(ValueError, match="continuous batching"):
        serve.main(SMOKE + ["--continuous", "--requests", "2"])
    with pytest.raises(ValueError, match="tied embeddings"):
        serve.main(argv + ["--split-cut", "1"])


# ------------------------------------------------------------ fault 22


@pytest.mark.parametrize("size,batch,seq", [("smoke", 8, 16),
                                            ("full", 8, 512)])
@pytest.mark.parametrize("k,wire", [(None, "int8"), ("auto", "auto"),
                                    (4, "int8")])
def test_paligemma_plan_matches_reference(monkeypatch, size, batch, seq, k,
                                          wire):
    """``resolve_pipeline_plan`` for paligemma under the reference's peak
    and link constants: the same spec and the same evidence, the hop
    billed without the prefix in both (fault 22)."""
    import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy)

    from repro.analysis import autotune as ref_at
    from repro.launch import train as ref_train
    from repro_torch.analysis import autotune as at
    monkeypatch.setattr(at, "HW", dict(ref_at.HW))
    monkeypatch.setattr(at, "LINK_PRIOR_BPS", ref_at.HW["dcn_bw"])
    monkeypatch.setattr(at, "HOP_OVERHEAD_PRIOR_S",
                        ref_at.HW["dcn_latency_s"])
    kw = dict(pipeline_stages=2, pipeline_k=k, virtual_stages=None,
              batch=batch, seq=seq, wire_dtype=wire, plan_hints=None)
    spec, info = train.resolve_pipeline_plan(
        cfg=getattr(get_arch(ARCH), size), **kw)
    ref_spec, ref_info = ref_train.resolve_pipeline_plan(
        cfg=getattr(ref_arch(ARCH), size), plan_roofline=None, **kw)
    assert (spec.num_stages, spec.microbatches, spec.virtual_stages,
            spec.wire_dtype) == (ref_spec.num_stages, ref_spec.microbatches,
                                 ref_spec.virtual_stages, ref_spec.wire_dtype)
    assert json.loads(json.dumps(info)) == json.loads(json.dumps(ref_info))


@pytest.mark.parametrize("size,batch,seq,billed,carried", [
    ("smoke", 1, 1, 256, 2304),
    ("full", 8, 512, 16_777_216, 25_165_824)])
def test_planner_bills_the_hop_without_the_prefix(size, batch, seq, billed,
                                                  carried):
    """Fault 22: ``plan_inputs_from_cfg`` bills batch x seq x d_model
    (``act_hop_bytes``; the tokens of the compute term alike) where the
    hop carries seq + num_patches rows: SMOKE at batch 1, seq 1 (f32)
    256 B against 2,304, FULL at 8 x 512 (bf16) 16,777,216 B against
    25,165,824, a third short.  Both packages alike; neither repaired."""
    from repro.analysis import autotune as ref_at
    from repro_torch.analysis import autotune as at
    port_cfg = getattr(get_arch(ARCH), size)
    got = at.plan_inputs_from_cfg(port_cfg, batch=batch, seq=seq,
                                  num_stages=2)
    want = ref_at.plan_inputs_from_cfg(getattr(ref_arch(ARCH), size),
                                       batch=batch, seq=seq, num_stages=2)
    assert got.act_hop_bytes == want.act_hop_bytes == billed
    rows = batch * (seq + port_cfg.num_patches)
    assert rows * port_cfg.d_model * got.act_bytes == carried
