"""The chunked WKV6 algebra of ``csrc/wkv6.cu``'s tensor-core route, on CPU.

The route's kernels cannot run here, so their decomposition is written out
below in f64 with the kernels' own tiling -- chunks of C = 64 steps,
sub-chunks of 16, the state pass in tiles of BV columns (each warp of
``wkv6_state_kernel`` holds 32) -- and held to the step-by-step scan
(``wkv6_scan``'s recurrence in f64) and its autograd at 1e-9:

* state pass (``wkv6_state_kernel``): the state at every chunk boundary,
  ``S_out = diag(e^{L_C}) S_in + sum_j (k_j e^{L_C - L_{j+1}}) v_j^T``, and
  in reverse the adjoint ``dS_in = diag(e^{L_C}) dS_out + sum_t
  (r_t e^{L_t}) do_t^T`` (L is the cumulative log-decay from the chunk's
  start);
* output pass (``wkv6_out_kernel``): ``o = A V + (r e^{L}) S_in + bonus``,
  with A's off-diagonal 16 x 16 blocks a product of ``r_t e^{L_t - L_s}``
  and ``k_j e^{L_s - L_{j+1}}`` (s the query sub-chunk's start) and its
  diagonal blocks pairwise, so that no exponent is ever positive;
* gradient pass (``wkv6_grad_kernel``): dr, dk, dv from the same factors,
  and d log w from the chunk-local suffix sums of ``r dr_state`` and
  ``k dk_state`` plus ``X_end = sum_j dS_out S_out`` at the chunk's end.

Decays: the model's draws and constant log w = -1.4, -5 and -20, where the
reference's single-level chunked form overflows (ROADMAP Queue 3, fault 7).
With ``rnd = _bf16`` (and ``split = _split``) the same functions make the
bf16 roundings the kernels make (each tensor-core operand rounded once after
its f32 decay factor; S_in and dS_out as a bf16 pair where d log w needs
f32 accuracy), and are held to the bf16 route's 1e-2.  Imports torch only.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6 as rw

C, SUB = 64, 16
NSUB = C // SUB


def _same(x):
    return x


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _split(x):
    """A bf16 pair hi + lo, where the route needs f32 accuracy from the
    tensor cores (the state terms of dr and dk, whose sums d log w takes
    the difference of)."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _prefix(lw):
    """[..., C, dh] log-decays -> [..., C + 1, dh]: P_t = sum_{p<t} lw_p."""
    return torch.cat([torch.zeros_like(lw[..., :1, :]), lw.cumsum(-2)], -2)


def _pairwise(p):
    """e^{P_t - P_{m+1}} for t > m within each 16-step sub-chunk, 0
    elsewhere: [..., C, C, dh] (t, m, i).  Never a positive exponent."""
    t = torch.arange(C)
    keep = (t[:, None] > t[None, :]) & (t[:, None] // SUB == t[None, :] // SUB)
    diff = p[..., :C, None, :] - p[..., None, 1:, :]
    return torch.where(keep[..., None], diff, -torch.inf).exp()


def state_pass(x, y, lw, init, reverse, bv, rnd=_same):
    """The state (or, reversed, its adjoint) at every chunk boundary,
    column tile by column tile.  x, y, lw: [B, H, N C, dh] (zero-padded);
    init: [B, H, dh, dh] or None -> [B, H, N + 1, dh, dh]."""
    b, h, tp, dh = x.shape
    n = tp // C
    out = x.new_zeros((b, h, n + 1, dh, dh))
    for j0 in range(0, dh, bv):
        cols = slice(j0, j0 + bv)
        st = x.new_zeros((b, h, dh, bv)) if init is None \
            else init[..., cols].clone()
        for c in (reversed(range(n)) if reverse else range(n)):
            sl = slice(c * C, (c + 1) * C)
            p = _prefix(lw[:, :, sl])
            out[:, :, c + 1 if reverse else c, :, cols] = st
            if reverse:               # r_t e^{L_t}
                xh = x[:, :, sl] * p[:, :, :C].exp()
            else:                     # k_j e^{L_C - L_{j+1}}
                xh = x[:, :, sl] * (p[:, :, C:] - p[:, :, 1:]).exp()
            st = p[:, :, C, :, None].exp() * st + torch.einsum(
                "bhti,bhtj->bhij", rnd(xh), y[:, :, sl, cols])
        out[:, :, 0 if reverse else n, :, cols] = st
    return out


def _factors(r, k, p, rnd):
    """The tensor-core operands of one chunk: r e^{L_t - L_s} (rt) and,
    for query sub-chunk a, k_j e^{L_{s_a} - L_{j+1}} for j < s_a (kt[a])."""
    sa = (torch.arange(C) // SUB) * SUB
    eq = (p[..., :C, :] - p[..., sa, :]).exp()
    kt = [None] + [rnd(k[..., :SUB * a, :] * (
        p[..., SUB * a:SUB * a + 1, :] - p[..., 1:SUB * a + 1, :]).exp())
        for a in range(1, NSUB)]
    return eq, rnd(r * eq), kt


def _intra(r, k, p, rt, kt, pair):
    """A[t, m] for m < t: off-diagonal blocks on the tensor cores, the
    diagonal blocks pairwise in f32."""
    a_mat = torch.einsum("...ti,...mi,...tmi->...tm", r, k, pair)
    for a in range(1, NSUB):
        rows = slice(SUB * a, SUB * (a + 1))
        a_mat[..., rows, :SUB * a] = rt[..., rows, :] @ kt[a].transpose(-1, -2)
    return a_mat


def _bhtd(x, n):
    """[B, S, H, dh] -> [B, H, n C, dh], zero-padded in time."""
    x = x.transpose(1, 2)
    return torch.nn.functional.pad(x, (0, 0, 0, n * C - x.shape[2]))


def chunked_forward(r, k, v, logw, u, s0, bv, rnd=_same):
    """(out [B, S, H, dh], final state) as the state pass and the output
    pass compute them."""
    b, s, h, dh = r.shape
    n = -(-s // C)
    r_, k_, v_, lw = (_bhtd(x, n) for x in (r, k, v, logw))
    states = state_pass(k_, v_, lw, s0, False, bv, rnd)
    outs = []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc = r_[:, :, sl], k_[:, :, sl], v_[:, :, sl]
        p = _prefix(lw[:, :, sl])
        eq, rt, kt = _factors(rc, kc, p, rnd)
        a_mat = rnd(_intra(rc, kc, p, rt, kt, _pairwise(p)))
        rs = rnd(rc * p[:, :, :C].exp())
        coef = (rc * u[:, None] * kc).sum(-1, keepdim=True)
        outs.append(a_mat @ vc + rs @ rnd(states[:, :, c]) + coef * vc)
    out = rnd(torch.cat(outs, 2)[:, :, :s].transpose(1, 2))
    return out, states[:, :, n]


def chunked_backward(r, k, v, logw, u, s0, dout, ds_t, bv, rnd=_same,
                     split=_same):
    """(dr, dk, dv, dlogw, du, ds0) as the two state passes and the
    gradient pass compute them."""
    b, s, h, dh = r.shape
    n = -(-s // C)
    r_, k_, v_, do_, lw = (_bhtd(x, n) for x in (r, k, v, dout, logw))
    states = state_pass(k_, v_, lw, s0, False, bv, rnd)
    dstates = state_pass(r_, do_, lw, ds_t, True, bv, rnd)
    grads = [torch.zeros_like(r_) for _ in range(4)]
    du = r.new_zeros((h, dh))
    t = torch.arange(C)
    strict = (t[:, None] > t[None, :]).to(r.dtype)
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, dc = (x[:, :, sl] for x in (r_, k_, v_, do_))
        p = _prefix(lw[:, :, sl])
        s_in, ds_out = states[:, :, c], dstates[:, :, c + 1]
        eq, rt, kt = _factors(rc, kc, p, rnd)
        pair = _pairwise(p)
        a_mat = rnd(_intra(rc, kc, p, rt, kt, pair))
        dv_mat = (dc @ vc.transpose(-1, -2)) * strict       # do_t . v_m
        dv_off = rnd(dv_mat)
        vdo = (vc * dc).sum(-1, keepdim=True)
        coef = (rc * u[:, None] * kc).sum(-1, keepdim=True)
        # dr (state part): e^{L_t - L_s} [e^{L_s} (do S_in^T) + DV kt] + diag
        dr_st = dc @ split(s_in).transpose(-1, -2)
        dr_p = torch.einsum("...tm,...mi,...tmi->...ti", dv_mat, kc, pair)
        # dk (state part): e^{L_e - L_{m+1}} [e^{L_C - L_e} (v dS_out^T)
        #                  + DV^T rb] + diag, e the key sub-chunk's end
        dk_st = vc @ split(ds_out).transpose(-1, -2)
        dk_p = torch.einsum("...tm,...ti,...tmi->...mi", dv_mat, rc, pair)
        for a in range(NSUB):
            rows = slice(SUB * a, SUB * (a + 1))
            sa, ea = SUB * a, SUB * (a + 1)
            acc = p[:, :, sa:sa + 1].exp() * dr_st[:, :, rows]
            if a:
                acc = acc + dv_off[:, :, rows, :sa] @ kt[a]
            dr_p[:, :, rows] += eq[:, :, rows] * acc
            kbar = (p[:, :, ea:ea + 1] - p[:, :, sa + 1:ea + 1]).exp()
            acc = (p[:, :, C:] - p[:, :, ea:ea + 1]).exp() * dk_st[:, :, rows]
            if ea < C:
                rb = rnd(rc[:, :, ea:] * (p[:, :, ea:C] - p[:, :, ea:ea + 1])
                         .exp())
                acc = acc + dv_off[:, :, ea:, rows].transpose(-1, -2) @ rb
            dk_p[:, :, rows] += kbar * acc
        kh = rnd(kc * (p[:, :, C:] - p[:, :, 1:]).exp())
        dv_c = a_mat.transpose(-1, -2) @ dc + kh @ rnd(ds_out) + coef * dc
        # d log w: X_end + sum_{t'>t} P_t' - sum_{t'>=t} Q_t' in the chunk
        xend = (dstates[:, :, c + 1] * states[:, :, c + 1]).sum(-1)
        pp, qq = rc * dr_p, kc * dk_p
        suffix = lambda x: x.flip(2).cumsum(2).flip(2)
        dlw = xend[:, :, None] + suffix(pp) - pp - suffix(qq)
        du += (rc * kc * vdo).sum((0, 2))
        for g, x in zip(grads, (dr_p + u[:, None] * kc * vdo,
                                dk_p + rc * u[:, None] * vdo, dv_c, dlw)):
            g[:, :, sl] = x
    dr, dk, dv, dlogw = (g[:, :, :s].transpose(1, 2) for g in grads)
    return rnd(dr), rnd(dk), rnd(dv), dlogw, du, dstates[:, :, 0]


# ------------------------------------------------------------------ tests


def _inputs(s, dh, decay, with_s0, seed, b=1, h=2):
    """f64 r, k, v, log w, u, s0, dout, ds_t; ``decay`` is "model" (the
    reference's draws, w = exp(-exp(U(-6, 0.5)))) or a constant log w."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape))
    shape = (b, s, h, dh)
    if decay == "model":
        logw = -torch.from_numpy(np.exp(rng.uniform(-6.0, 0.5, shape)))
    else:
        logw = torch.full(shape, float(decay), dtype=torch.float64)
    s0 = f(b, h, dh, dh) * 0.1 if with_s0 else None
    ds_t = f(b, h, dh, dh) if with_s0 else None
    return f(*shape), f(*shape), f(*shape), logw, f(h, dh) * 0.2, s0, \
        f(*shape), ds_t


def _scan(r, k, v, logw, u, s0):
    """The step-by-step recurrence (``wkv6_scan``'s) in the inputs' f64."""
    b, s, h, dh = r.shape
    state = r.new_zeros((b, h, dh, dh)) if s0 is None else s0
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = logw[:, t].exp()[..., None] * state + kv
    return torch.stack(outs, 1), state


def _scan_and_grads(r, k, v, logw, u, s0, dout, ds_t):
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u)]
    s0p = None if s0 is None else s0.clone().requires_grad_(True)
    out, s_t = _scan(*ins, s0p)
    loss = (out * dout).sum()
    if ds_t is not None:
        loss = loss + (s_t * ds_t).sum()
    grads = torch.autograd.grad(loss, ins + ([s0p] if s0 is not None else []))
    return out.detach(), s_t.detach(), grads


CASES = [(s, dh, decay, with_s0)
         for s in (70, 96, 130) for dh in (16, 64)
         for decay in ("model", -1.4, -5.0, -20.0)
         for with_s0 in (False, True)]


@pytest.mark.parametrize("s,dh,decay,with_s0", CASES, ids=str)
def test_chunked_decomposition_matches_scan_and_autograd(s, dh, decay,
                                                         with_s0):
    r, k, v, logw, u, s0, dout, ds_t = _inputs(s, dh, decay, with_s0,
                                               seed=s + dh)
    bv = 32 if dh == 64 else 16
    want_o, want_s, want_g = _scan_and_grads(r, k, v, logw, u, s0, dout,
                                             ds_t)
    out, s_t = chunked_forward(r, k, v, logw, u, s0, bv)
    got = chunked_backward(r, k, v, logw, u, s0, dout, ds_t, bv)
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-9,
                                                    atol=1e-9)
    assert bool(torch.isfinite(out).all())
    close(out, want_o)
    close(s_t, want_s)
    for g, wnt in zip(got, want_g):
        close(g, wnt)
    if s0 is None:                       # ds0 of a zero initial state
        assert got[5].shape == (1, 2, dh, dh)


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("decay", ["model", -5.0, -20.0])
def test_chunked_bf16_roundings_hold_the_contract(decay):
    """The algebra with the bf16 roundings of the tensor-core route (r, k,
    v, do given in bf16; every product operand rounded once after its f32
    decay factor; outputs rounded) stays within the route's 1e-2 of the
    exact result, relative to the largest value, and finite."""
    r, k, v, logw, u, s0, dout, ds_t = _inputs(130, 64, decay, True, seed=5)
    r, k, v, dout = (_bf16(x) for x in (r, k, v, dout))
    want_o, want_s, want_g = _scan_and_grads(r, k, v, logw, u, s0, dout,
                                             ds_t)
    out, s_t = chunked_forward(r, k, v, logw, u, s0, 32, _bf16)
    got = chunked_backward(r, k, v, logw, u, s0, dout, ds_t, 32, _bf16,
                           _split)
    errs = [_rel(out, want_o), _rel(s_t, want_s)] + [
        _rel(g, w) for g, w in zip(got, want_g)]
    assert all(bool(torch.isfinite(x).all()) for x in (out, s_t, *got))
    assert max(errs) <= 1e-2, errs


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "chunked"),     # the training call
    (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 16, "simt"),
    (torch.float32, 64, "simt"),         # f32 keeps the 1e-4 contract
    (torch.float32, 16, "simt"),
])
def test_route_by_dtype_and_head_dim(dtype, dh, want):
    assert rw.route(dtype, dh) == want
    assert rw.route(dtype, dh, (256, 512, 1024)) == want


def test_route_takes_unaligned_bases_to_simt():
    """cp.async moves 16 aligned bytes: a base off 16 bytes is SIMT's."""
    assert rw.route(torch.bfloat16, 64, (256, 514)) == "simt"
    assert rw.route(torch.bfloat16, 64, (256, 528)) == "chunked"
