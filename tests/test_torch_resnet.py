"""The port's ResNet-18 split training against the JAX package's, on the CPU.

Parameters come from the reference's ``init_resnet18`` through the
ResNet bridge (HWIO -> OIHW); data from ``image_batches``, the same numpy
code on both sides; batches are of 8 images.  The reference's forward
graphs are compiled by ``ref_compile`` (``test_torch_training.py``, LLVM
optimisation level 0); the graphs that differentiate the model by
``jax.jit`` at XLA's default level, since at level 0 this CPU's ResNet
gradients come out 2e-3 to 1.1e-2 of each leaf's largest value away
from the same step in f64 (SL's momenta, measured), where the default
build and the port's f32 stand within 5e-6 of it.
Tolerances, all f32:

* every cut unit's activation and the logits: 1e-5 of the largest
  |value|.  Elementwise 1e-5 would test XLA's and oneDNN's summation
  orders rather than the port: at the batch here both sides stand 4e-6 to
  1.6e-5 from the same forward in f64, at values up to 12 (measured
  unit by unit on the reference's weights);
* ``resnet_split``'s loss: 1e-5; both sides' gradients (and SL's
  momenta, which are sums of gradients): 1e-4 of ``jax.grad``, absolute
  and relative, for all but one element in 10^4 of a leaf, and every
  element within 1e-2 of the leaf's largest |gradient| (``_close_grads``).
  The two sides' forwards differ by up to ~1e-5, so a pre-activation that
  close to zero takes its ReLU's other side: at the weights here one of
  131,072 in block3's second unit does, and moves 3 of the 589,824
  gradients of its convolution by up to 1.2e-4 (2.6e-3 of the largest);
  the port's f32 gradients stand within 1e-6 of its f64 ones;
* a C²P²SL step against PSL, and the SL step against the reference's:
  2e-4, the bound of the reference's own ``tests/test_equivalence.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import resnet18_cifar10 as ref_config
from repro.core import costs as ref_costs
from repro.core import schedule as ref_schedule
from repro.data.synthetic import image_batches as ref_image_batches
from repro.models import resnet as ref_resnet
from repro.parallel.pipeline import PipelineSpec as RefPipelineSpec
from repro.sl import baselines as ref_baselines
from repro.sl import c2p2sl as ref_c2p2sl
from repro.sl import split as ref_split
from repro.training import optim as ref_optim
from repro.wireless import fleet as ref_fleet
from repro_torch import bridge
from repro_torch.configs import resnet18_cifar10 as config
from repro_torch.core import costs, schedule
from repro_torch.data.synthetic import image_batches
from repro_torch.models import resnet
from repro_torch.parallel.pipeline import PipelineSpec
from repro_torch.sl import baselines, c2p2sl
from repro_torch.sl.split import resnet_split
from repro_torch.training import optim
from repro_torch.utils.trees import tree_leaves, tree_unflatten
from repro_torch.wireless import fleet
from test_torch_training import ref_compile

TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: beside the other test workers, more
    threads oversubscribe the cores and run the ResNet slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    key = jax.random.key(0)
    return jax.tree.map(np.asarray,
                        ref_compile(ref_resnet.init_resnet18, key)(key))


@pytest.fixture(scope="module")
def images():
    return next(ref_image_batches(8, seed=0))


def _nhwc(t):
    """A port activation (NCHW, or logits) as the reference lays it out."""
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _close_scaled(got, want, tol=TOL):
    """|got - want| <= tol * max |want|, elementwise."""
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, np.abs(want).max())


def _close_trees(port_tree, ref_tree, tol):
    got = bridge.resnet_params_to_jax(port_tree)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


def _close_grads(port_tree, ref_tree, tol=GRAD_TOL):
    got = bridge.resnet_params_to_jax(port_tree)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref_tree)):
        w = np.asarray(w)
        bad = np.abs(g - w) > tol + tol * np.abs(w)
        assert bad.sum() <= w.size // 10_000, (bad.sum(), w.shape)
        _close_scaled(g, w, 1e-2)


def _sl_tree(state):
    return {"ue_params": state.ue_params, "bs_params": state.bs_params,
            "opt_state_ue": state.opt_state_ue,
            "opt_state_bs": state.opt_state_bs, "step": state.step}


def test_image_batches_are_bit_identical():
    for kw in ({}, {"seed": 3, "shard": 1, "num_shards": 2},
               {"noise": 0.0, "size": 16, "num_classes": 4, "seed": 7}):
        got, want = image_batches(12, **kw), ref_image_batches(12, **kw)
        for _ in range(3):
            g, w = next(got), next(want)
            for name in ("images", "labels"):
                assert g[name].dtype == w[name].dtype
                np.testing.assert_array_equal(g[name], w[name])


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_config_matches_reference(size):
    assert dataclasses.asdict(getattr(config, size)) \
        == dataclasses.asdict(getattr(ref_config, size))


def test_bridge_round_trip_and_port_init_layout(ref_params):
    port = bridge.resnet_params_from_jax(ref_params)
    assert tuple(port["conv1"].shape) == (64, 3, 3, 3)
    assert tuple(port["stage1"][0]["proj"].shape) == (128, 64, 1, 1)
    back = bridge.resnet_params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(ref_params)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    own = resnet.init_resnet18(torch.Generator().manual_seed(0))
    for g, w in zip(jax.tree.leaves(bridge.resnet_params_to_jax(own)),
                    jax.tree.leaves(ref_params)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.ndim == 1 and w.shape[0] != 10:       # GroupNorm: ones / zeros
            np.testing.assert_array_equal(g, w)
    # He-normal: std sqrt(2 / fan_in) within 10% on the 3x3x512 convolution
    w = own["stage3"][1]["c2"]
    assert abs(float(w.std()) / np.sqrt(2 / (9 * 512)) - 1) < 0.1


CONV_CASES = [  # (H, W, kernel, stride): SAME's pad (before, after)
    (8, 8, 3, 2),       # (0, 1): symmetric padding=1 takes other windows
    (9, 7, 3, 2),       # (1, 1) rows, (1, 1) columns
    (8, 8, 1, 2),       # negative total: no pad
    (8, 6, 3, 1),       # (1, 1)
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv_pads_as_xla_same(case):
    """``_conv`` against ``lax.conv_general_dilated(..., "SAME")``; on an
    even map at stride 2 it must differ from PyTorch's symmetric pad."""
    h, w, k, s = case
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    wt = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, wt, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xp = torch.from_numpy(x).permute(0, 3, 1, 2)
    wp = torch.from_numpy(wt).permute(3, 2, 0, 1)
    got = resnet._conv(xp, wp, s)
    _close_scaled(_nhwc(got), want)
    if case == CONV_CASES[0]:
        sym = F.conv2d(xp, wp, stride=s, padding=k // 2)
        assert sym.shape == got.shape
        assert float((sym - got).abs().max()) > 1e-1


@pytest.fixture(scope="module")
def ref_units(ref_params, images):
    """The reference's output of every cut unit, unit by unit."""
    def units(p, batch):
        out, h = [], batch["images"]
        for u in range(6):
            h = ref_resnet.forward_cut(p, h, u, u + 1)
            out.append(h)
        return (out, ref_resnet.forward(p, batch["images"]),
                ref_resnet.loss_fn(p, batch))

    b = {n: jnp.asarray(a) for n, a in images.items()}
    outs, logits, (loss, mets) = ref_compile(units, ref_params, b)(
        ref_params, b)
    return ([np.asarray(o) for o in outs], np.asarray(logits), float(loss),
            float(mets["acc"]))


@pytest.mark.parametrize("l", [1, 2, 3, 4, 5])
def test_forward_cut_matches_reference_at_every_cut(l, ref_params, images,
                                                    ref_units):
    """The UE side ``forward_cut(0, l)`` gives the reference's cut
    activation, and the BS side run from the reference's activation of
    unit l gives its next unit."""
    p = bridge.resnet_params_from_jax(ref_params)
    x = torch.from_numpy(images["images"])
    with torch.no_grad():
        act = resnet.forward_cut(p, x, 0, l)
        _close_scaled(_nhwc(act), ref_units[0][l - 1])
        a = torch.from_numpy(ref_units[0][l - 1]).permute(0, 3, 1, 2)
        nxt = resnet.forward_cut(p, a, l, l + 1)
    _close_scaled(_nhwc(nxt), ref_units[0][l])


def test_forward_and_loss_match_reference(ref_params, images, ref_units):
    p = bridge.resnet_params_from_jax(ref_params)
    x = torch.from_numpy(images["images"])
    y = torch.from_numpy(images["labels"])
    with torch.no_grad():
        logits = resnet.forward(p, x)
        loss, mets = resnet.loss_fn(p, {"images": x, "labels": y})
    _close_scaled(logits.numpy(), ref_units[1])
    np.testing.assert_allclose(float(loss), ref_units[2], rtol=TOL)
    assert float(mets["acc"]) == ref_units[3]


def test_forward_refuses_tf32():
    p = resnet.init_resnet18(torch.Generator().manual_seed(0))
    x = torch.zeros(1, 32, 32, 3)
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
        flags.allow_tf32 = True
        try:
            with pytest.raises(RuntimeError, match="TF32"):
                resnet.forward(p, x)
        finally:
            flags.allow_tf32 = False


@pytest.mark.parametrize("l", [1, 3])
def test_split_loss_and_gradients_match_jax_grad(l, ref_params, images):
    rspec = ref_split.resnet_split(l)
    x, y = images["images"], images["labels"]

    def loss(ue, bs):
        return rspec.bs_loss(bs, rspec.ue_fwd(ue, jnp.asarray(x)),
                             jnp.asarray(y))[0]

    rue, rbs = rspec.split_params(ref_params)
    want, (gue, gbs) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        rue, rbs)
    spec = resnet_split(l)
    ue, bs = spec.split_params(bridge.resnet_params_from_jax(ref_params))
    leaves = tree_leaves(ue) + tree_leaves(bs)
    for t in leaves:
        t.requires_grad_(True)
    got, _ = spec.bs_loss(bs, spec.ue_fwd(ue, torch.from_numpy(x)),
                          torch.from_numpy(y))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL)
    n = len(tree_leaves(ue))
    _close_grads(tree_unflatten(ue, grads[:n]), gue)
    _close_grads(tree_unflatten(bs, grads[n:]), gbs)
    with pytest.raises(ValueError):
        resnet_split(6)


def _port_run(ref_params, images, make, alloc, k, l=1):
    """One SGD step of ``make(spec, opt)`` from the reference's weights:
    (state tree, metrics)."""
    spec = resnet_split(l)
    opt = optim.sgd(0.05, momentum=0.9)
    st = _sl_tree(c2p2sl.init_sl_state(
        spec, bridge.resnet_params_from_jax(ref_params), opt))
    x = torch.from_numpy(images["images"][:sum(alloc)])
    y = torch.from_numpy(images["labels"][:sum(alloc)]).long()
    xs, ys = c2p2sl.shard_batch(x, y, np.array(alloc), k)
    return make(spec, opt)(st, xs, ys)


ALLOC = [3, 2, 1, 2]       # unequal; UE 2 sits out three of k = 4 micro-batches


@pytest.fixture(scope="module")
def psl_step(ref_params, images):
    return _port_run(ref_params, images, baselines.make_psl_step, ALLOC, 1)


def test_c2p2sl_equals_psl_on_an_unequal_allocation(ref_params, images,
                                                    psl_step):
    """k = 4 C²P²SL == k = 1 PSL (SGD: linear in the gradients), as the
    reference's ``test_equivalence.py`` holds its own, and the port's PSL
    equals the reference's PSL step."""
    got, mets = _port_run(ref_params, images,
                          lambda s, o: c2p2sl.make_c2p2sl_step(s, o, 4),
                          ALLOC, 4)
    want, wmets = psl_step
    for side in ("ue_params", "bs_params"):
        for a, b in zip(tree_leaves(got[side]), tree_leaves(want[side])):
            assert float((a - b).detach().abs().max()) < STEP_TOL
    np.testing.assert_allclose(float(mets["loss"]), float(wmets["loss"]),
                               rtol=1e-5)

    rspec = ref_split.resnet_split(1)
    ropt = ref_optim.sgd(0.05, momentum=0.9)
    rst = _sl_tree(ref_c2p2sl.init_sl_state(
        rspec, jax.tree.map(jnp.asarray, ref_params), ropt))
    xs, ys = ref_c2p2sl.shard_batch(jnp.asarray(images["images"]),
                                    jnp.asarray(images["labels"]),
                                    np.array(ALLOC), 1)
    rst, rmets = jax.jit(ref_baselines.make_psl_step(rspec, ropt))(rst, xs,
                                                                    ys)
    np.testing.assert_allclose(float(wmets["loss"]), float(rmets["loss"]),
                               rtol=1e-5)
    for side in ("ue_params", "bs_params"):
        _close_trees(want[side], rst[side], STEP_TOL)


def test_epsl_differs_from_psl_on_the_ue_side_only(ref_params, images,
                                                   psl_step):
    got, _ = _port_run(ref_params, images, baselines.make_epsl_step, ALLOC, 1)
    want, _ = psl_step
    ue = max(float((a - b).detach().abs().max()) for a, b in zip(
        tree_leaves(got["ue_params"]), tree_leaves(want["ue_params"])))
    bs = max(float((a - b).detach().abs().max()) for a, b in zip(
        tree_leaves(got["bs_params"]), tree_leaves(want["bs_params"])))
    assert ue > STEP_TOL and bs < STEP_TOL


def test_sl_step_matches_reference(ref_params, images):
    """Sequential SL over 2 UEs (b = [3, 5], k = 2 shards): each UE's turn
    sees the previous turn's update; parameters at 2e-4, momenta as
    gradients."""
    alloc = [3, 5]
    got, mets = _port_run(ref_params, images, baselines.make_sl_step, alloc,
                          2, l=2)
    rspec = ref_split.resnet_split(2)
    ropt = ref_optim.sgd(0.05, momentum=0.9)
    rst = _sl_tree(ref_c2p2sl.init_sl_state(
        rspec, jax.tree.map(jnp.asarray, ref_params), ropt))
    xs, ys = ref_c2p2sl.shard_batch(jnp.asarray(images["images"]),
                                    jnp.asarray(images["labels"]),
                                    np.array(alloc), 2)
    rst, rmets = jax.jit(ref_baselines.make_sl_step(rspec, ropt))(rst, xs,
                                                                   ys)
    np.testing.assert_allclose(float(mets["loss"]), float(rmets["loss"]),
                               rtol=1e-5)
    assert got["step"] == int(rst["step"]) == 1
    for side in ("ue_params", "bs_params"):
        _close_trees(got[side], rst[side], STEP_TOL)
    for side in ("opt_state_ue", "opt_state_bs"):
        _close_grads(got[side]["mom"], rst[side]["mom"])


def test_batch_wall_time_and_auto_k_match_reference():
    prof, rprof = costs.resnet18_profile(), ref_costs.resnet18_profile()
    rng = np.random.default_rng(0)
    for seed, v in ((0, 1), (1, 2), (2, 3)):
        b = rng.uniform(1.0, 100.0, 6)
        tau = rng.uniform(0.5, 1.0, 6) * 1.5e-3
        kw = dict(l=2, k=int(rng.integers(1, 9)), b=b, tau=tau, v=v)
        got = c2p2sl.batch_wall_time(prof, fleet.sample_fleet(6, seed=seed),
                                     schedule.Plan(**kw))
        want = ref_c2p2sl.batch_wall_time(
            rprof, ref_fleet.sample_fleet(6, seed=seed),
            ref_schedule.Plan(**kw))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    for comp, link, cap in ((1.0, 2.0, 16), (0.3, 0.31, 64), (2.0, 1.0, 8),
                            (1.0, 0.0, 4)):
        got = PipelineSpec.auto_k(comp, link, num_stages=3, k_cap=cap)
        want = RefPipelineSpec.auto_k(comp, link, num_stages=3, k_cap=cap)
        assert (got.num_stages, got.microbatches, got.virtual_stages) \
            == (want.num_stages, want.microbatches, want.virtual_stages)
    got = PipelineSpec.auto_k(1.0, 2.0, virtual_stages=2)
    want = RefPipelineSpec.auto_k(1.0, 2.0, virtual_stages=2)
    assert (got.microbatches, got.virtual_stages) \
        == (want.microbatches, want.virtual_stages)
