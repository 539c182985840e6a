"""The torch port's delay-transducer loss against the JAX package.

- The row-scan twins (``ops/transducer/lattice.py``) against the JAX XLA
  scans (``jnp_impl._alphas``/``_expected_delay``, ``analytic._betas``/
  ``_beta_shifts``/``_expected_delay_bwd``), against the Pallas kernels in
  interpret mode (``pallas_alphas``, ``pallas_betas``,
  ``pallas_affine_rows`` forward and reverse), and against the numpy oracle
  ``ops/transducer/reference.py``;
- ``DelayTransducerLoss`` (loss and d/dacts) against ``jax.grad`` of
  ``delay_transducer_loss_vjp`` for the three delay functions,
  temperature 1 and 0.5, ragged lengths, once with the JAX lattice on its
  Pallas kernels; a float64 ``torch.autograd.gradcheck``;
- the twins of the fused walks (``lattice.alphas_and_expected_delay``,
  ``lattice.betas_and_expected_delay_bwd``) against the JAX pieces in
  sequence, the XLA scans and the Pallas kernels in interpret mode, for the
  three delay functions and lengths down to T_b = 1, U_b = 0;
- the kernel wrappers (``kernels.py``) run their twins on CPU tensors and
  launch nothing; ``kernels.lattice_path`` picks the kernel set by U.

Tolerances, float32: lattices rtol 2e-5 (atol 2e-4 on values of order
100), the losses rtol 1e-5, gradients rtol 1e-4 atol 1e-5.  The beta
lattices are compared on the valid cells (t < T_b, u <= U_b): cells that
reach the end only through a BLOCKed edge hold BLOCK-sized values whose
digits differ between formulations (tests/test_pallas_transducer.py does
the same).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_s_tpu.ops.transducer import analytic as jax_analytic
from wav2vec_s_tpu.ops.transducer import jnp_impl
from wav2vec_s_tpu.ops.transducer import pallas_kernel
from wav2vec_s_tpu.ops.transducer import reference
from wav2vec_s_tpu_torch.ops.transducer import kernels, lattice
from wav2vec_s_tpu_torch.ops.transducer.analytic import (
    delay_transducer_loss)

JAX_DELAY = {"zero": jnp_impl.delay_cost_zero,
             "diagonal": jnp_impl.delay_cost_diagonal,
             "diag_positive": jnp_impl.delay_cost_diag_positive}


@functools.lru_cache(maxsize=None)
def problem(B=3, T=9, U=6, V=11, seed=0):
    """Seeded acts [B, T, U, V], labels, ragged lengths (row 0 fills the
    lattice, row 2 has no labels left past 1)."""
    rng = np.random.default_rng(seed)
    acts = rng.standard_normal((B, T, U, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    act_lens = np.array([T, max(T - 3, 1), min(4, T)][:B], np.int32)
    label_lens = np.array([U - 1, min(3, U - 2), 1][:B], np.int32)
    return acts, labels, act_lens, label_lens


def torch_lattice(seed=0):
    acts, labels, al, ll = problem(seed=seed)
    lpb, lpe, _ = lattice.lattice_log_probs_lse(
        torch.from_numpy(acts), torch.from_numpy(labels), 0)
    return lpb, lpe, torch.from_numpy(al), torch.from_numpy(ll)


def jax_lattice(seed=0):
    acts, labels, al, ll = problem(seed=seed)
    lpb, lpe, _ = jnp_impl._lattice_log_probs_lse(
        jnp.asarray(acts), jnp.asarray(labels), 0)
    return lpb, lpe, jnp.asarray(al), jnp.asarray(ll)


def valid_cells(al, ll, T, U):
    return ((np.arange(T)[None, :, None] < np.asarray(al)[:, None, None])
            & (np.arange(U)[None, None, :] <= np.asarray(ll)[:, None, None]))


def close(got, want, rtol=2e-5, atol=2e-4, where=None):
    got, want = np.asarray(got), np.asarray(want)
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_log_probs_match_jax():
    lpb, lpe, _, _ = torch_lattice()
    jb, je, _, _ = jax_lattice()
    close(lpb, jb, atol=1e-5)
    close(lpe, je, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_alphas_and_expected_delay_match_xla_scans(seed):
    lpb, lpe, al, ll = torch_lattice(seed)
    jb, je, jal, jll = jax_lattice(seed)
    a = lattice.alphas(lpb, lpe)
    close(a, jnp_impl._alphas(jb, je))
    dv = lattice.delay_cost_diag_positive(lpb.shape, al, ll)
    jdv = jnp_impl.delay_cost_diag_positive(jb.shape, jal, jll)
    close(dv, jdv, atol=1e-6)
    close(lattice.expected_delay(lpb, lpe, a, dv),
          jnp_impl._expected_delay(jb, je, jnp_impl._alphas(jb, je), jdv),
          atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_betas_and_delay_bwd_match_xla_scans(seed):
    lpb, lpe, al, ll = torch_lattice(seed)
    jb, je, jal, jll = jax_lattice(seed)
    B, T, U = lpb.shape
    valid = valid_cells(al, ll, T, U)
    be, lpb_eff, t_valid, emit_ok = lattice.betas(lpb, lpe, al, ll)
    jbe, jlpb_eff, jt_valid, jemit_ok = jax_analytic._betas(jb, je, jal, jll)
    close(be, jbe, where=valid)
    close(lpb_eff, jlpb_eff, atol=1e-6)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(jt_valid))
    np.testing.assert_array_equal(emit_ok.numpy(), np.asarray(jemit_ok))
    down, up = lattice.beta_shifts(be, ll)
    jdown, jup = jax_analytic._beta_shifts(jbe, jll)
    close(down, jdown, where=valid)
    close(up, jup, where=valid)
    dv = lattice.delay_cost_zero(lpb.shape, al, ll)
    jdv = jnp_impl.delay_cost_zero(jb.shape, jal, jll)
    bd, dve = lattice.expected_delay_bwd(lpb, lpe, be, down, up, dv,
                                         t_valid, emit_ok)
    jbd, jdve = jax_analytic._expected_delay_bwd(
        jb, je, jbe, jdown, jup, jdv, jt_valid, jemit_ok)
    close(bd, jbd, atol=1e-5, where=valid)
    close(dve, jdve, atol=1e-6)


def test_twins_match_pallas_kernels_in_interpret_mode():
    lpb, lpe, al, ll = torch_lattice()
    jb, je, jal, jll = jax_lattice()
    B, T, U = lpb.shape
    valid = valid_cells(al, ll, T, U)
    a = lattice.alphas(lpb, lpe)
    close(a, pallas_kernel.pallas_alphas(jb, je, interpret=True))
    be = lattice.betas(lpb, lpe, al, ll)[0]
    close(be, pallas_kernel.pallas_betas(jb, je, jal, jll, interpret=True),
          where=valid)
    # the affine rows, forward (expected delay) and reverse (its backward)
    dv = lattice.delay_cost_diag_positive(lpb.shape, al, ll)
    jdv = jnp.asarray(dv.numpy())
    close(lattice.expected_delay(lpb, lpe, a, dv),
          pallas_kernel.pallas_expected_delay(
              jb, je, jnp.asarray(a.numpy()), jdv, interpret=True),
          atol=1e-5)
    t_valid, emit_ok = lattice.lattice_masks((B, T, U), al, ll)
    down, up = lattice.beta_shifts(be, ll)
    bd = lattice.expected_delay_bwd(lpb, lpe, be, down, up, dv, t_valid,
                                    emit_ok)[0]
    jbd = pallas_kernel.pallas_expected_delay_bwd(
        jb, je, *(jnp.asarray(x.numpy()) for x in (be, down, up, dv,
                                                   t_valid, emit_ok)),
        interpret=True)[0]
    close(bd, jbd, atol=1e-5, where=valid)
    # and the raw kernel on random coefficients, both directions
    rng = np.random.default_rng(3)
    coef = [rng.uniform(0, 1, (B, T, U)).astype(np.float32)
            for _ in range(3)]
    for reverse in (False, True):
        tc = [torch.from_numpy(c) for c in coef]
        jc = [jnp.asarray(c) for c in coef]
        flip = (lambda x: jnp.flip(x, axis=(1, 2))) if reverse else (
            lambda x: x)
        want = flip(pallas_kernel.pallas_affine_rows(
            *map(flip, jc), interpret=True))
        close(lattice.affine_rows(*tc, reverse=reverse), want, atol=1e-5)


def test_twins_match_numpy_oracle():
    acts, labels, al, ll = problem()
    lpb, lpe, tal, tll = torch_lattice()
    B, T, U = lpb.shape
    dv = lattice.delay_cost_diagonal(lpb.shape, tal, tll)
    a = lattice.alphas(lpb, lpe).double().numpy()
    be = lattice.betas(lpb, lpe, tal, tll)[0].double().numpy()
    logp = reference.log_softmax(acts.astype(np.float64))
    for b in range(B):
        Tb, Ub = al[b], ll[b]
        al_ref, _ = reference.forward_alphas(logp[b, :Tb, :Ub + 1],
                                             labels[b, :Ub])
        np.testing.assert_allclose(a[b, :Tb, :Ub + 1], al_ref, rtol=2e-5,
                                   atol=2e-4)
        be_ref = reference.backward_betas(logp[b, :Tb, :Ub + 1],
                                          labels[b, :Ub])
        np.testing.assert_allclose(be[b, :Tb, :Ub + 1], be_ref, rtol=2e-5,
                                   atol=2e-4)
    total, prob, delay = delay_transducer_loss(
        torch.from_numpy(acts), torch.from_numpy(labels), tal, tll, dv)
    want_p, want_d = reference.transduce_batch(
        acts.astype(np.float64), labels, al, ll, dv.double().numpy())
    np.testing.assert_allclose(prob.numpy(), want_p, rtol=1e-5)
    np.testing.assert_allclose(delay.numpy(), want_d, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(total.numpy(), want_p + want_d, rtol=1e-5)


def _jax_loss_and_grad(delay_func, temperature, weights):
    acts, labels, al, ll = problem()
    jal, jll = jnp.asarray(al), jnp.asarray(ll)
    dv = JAX_DELAY[delay_func](acts.shape[:3], jal, jll)

    def f(a):
        total, prob, delay = jax_analytic.delay_transducer_loss_vjp(
            a, jnp.asarray(labels), jal, jll, dv, 0.7, 0, temperature)
        return jnp.sum(total * weights[0] + prob * weights[1]
                       + delay * weights[2]), (total, prob, delay)

    (_, outs), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(acts))
    return [np.asarray(o) for o in outs], np.asarray(g)


def _torch_loss_and_grad(delay_func, temperature, weights):
    acts, labels, al, ll = problem()
    a = torch.from_numpy(acts).requires_grad_(True)
    tal, tll = torch.from_numpy(al), torch.from_numpy(ll)
    dv = lattice.DELAY_FUNCS[delay_func](a.shape[:3], tal, tll)
    outs = delay_transducer_loss(a, torch.from_numpy(labels), tal, tll, dv,
                                 0.7, 0, temperature)
    w = [torch.from_numpy(x) for x in weights]
    sum(o * wi for o, wi in zip(outs, w)).sum().backward()
    return [o.detach().numpy() for o in outs], a.grad.numpy()


# all three outputs carry a cotangent, so the prob and delay cotangents of
# the backward are exercised, not only the total's
WEIGHTS = tuple(np.asarray(w, np.float32) for w in
                ([1.0, 2.0, 0.5], [0.3, -1.0, 0.0], [0.0, 0.5, 2.0]))


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("delay_func", ["zero", "diagonal", "diag_positive"])
def test_loss_and_grad_match_jax(delay_func, temperature):
    want_outs, want_g = _jax_loss_and_grad(delay_func, temperature, WEIGHTS)
    outs, g = _torch_loss_and_grad(delay_func, temperature, WEIGHTS)
    for o, w in zip(outs, want_outs):
        np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-5)


def test_loss_and_grad_match_jax_on_its_pallas_lattice():
    jax_analytic.set_lattice_impl("pallas", interpret=True)
    try:
        want_outs, want_g = _jax_loss_and_grad("diag_positive", 1.0,
                                               WEIGHTS)
    finally:
        jax_analytic.set_lattice_impl("auto")
    outs, g = _torch_loss_and_grad("diag_positive", 1.0, WEIGHTS)
    for o, w in zip(outs, want_outs):
        np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-5)


def test_gradcheck_float64():
    acts, labels, al, ll = problem(B=2, T=4, U=3, V=5, seed=4)
    a = torch.from_numpy(acts).double().requires_grad_(True)
    tal, tll = torch.from_numpy(al), torch.from_numpy(ll)
    dv = lattice.delay_cost_diag_positive(a.shape[:3], tal, tll).double()

    def f(x):
        total, prob, delay = delay_transducer_loss(
            x, torch.from_numpy(labels), tal, tll, dv, 0.7)
        return total, prob, delay

    assert torch.autograd.gradcheck(f, (a,), eps=1e-6, atol=1e-6)


def test_kernel_wrappers_run_twins_on_cpu():
    lpb, lpe, al, ll = torch_lattice()
    for fn in (kernels.alphas, kernels.betas, kernels.affine_rows):
        fn.launches = 0
    assert torch.equal(kernels.alphas(lpb, lpe), lattice.alphas(lpb, lpe))
    assert torch.equal(kernels.betas(lpb, lpe, al, ll),
                       lattice.betas(lpb, lpe, al, ll)[0])
    c = [torch.rand(lpb.shape) for _ in range(3)]
    for rev in (False, True):
        assert torch.equal(kernels.affine_rows(*c, reverse=rev),
                           lattice.affine_rows(*c, reverse=rev))
    assert (kernels.alphas.launches, kernels.betas.launches,
            kernels.affine_rows.launches) == (0, 0, 0)
    with pytest.raises(ValueError):
        kernels.alphas(lpb, lpe[:, :-1])


# --- the fused walks' twins and the kernel-set chooser ---

def ragged(seed=0):
    """The torch and JAX lattices of ``problem`` with the shortest lengths
    a batch can hold: one frame, then no label."""
    acts, labels, _, _ = problem(seed=seed)
    B, T, U, _ = acts.shape
    al = np.array([T, 1, 5], np.int32)
    ll = np.array([U - 1, 2, 0], np.int32)
    lpb, lpe, _ = lattice.lattice_log_probs_lse(
        torch.from_numpy(acts), torch.from_numpy(labels), 0)
    jb, je, _ = jnp_impl._lattice_log_probs_lse(
        jnp.asarray(acts), jnp.asarray(labels), 0)
    return ((lpb, lpe, torch.from_numpy(al), torch.from_numpy(ll)),
            (jb, je, jnp.asarray(al), jnp.asarray(ll)))


def _jax_delay_bwd(jb, je, jal, jll, jdv, pallas):
    """(betas, bd) of the JAX package: pallas_betas +
    pallas_expected_delay_bwd in interpret mode, or the XLA scans."""
    _, _, t_valid, emit_ok = jax_analytic._betas(jb, je, jal, jll)
    if pallas:
        jbe = pallas_kernel.pallas_betas(jb, je, jal, jll, interpret=True)
    else:
        jbe = jax_analytic._betas(jb, je, jal, jll)[0]
    down, up = jax_analytic._beta_shifts(jbe, jll)
    if pallas:
        jbd = pallas_kernel.pallas_expected_delay_bwd(
            jb, je, jbe, down, up, jdv, t_valid, emit_ok, interpret=True)[0]
    else:
        jbd = jax_analytic._expected_delay_bwd(jb, je, jbe, down, up, jdv,
                                               t_valid, emit_ok)[0]
    return jbe, jbd


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("delay_func", ["zero", "diagonal", "diag_positive"])
@pytest.mark.parametrize("short", [False, True], ids=["ragged", "shortest"])
def test_fused_walk_twins_match_jax(delay_func, pallas, short):
    """The twins of the forward and the reverse fused walk against the JAX
    package's alphas + expected delay and betas + expected delay backward,
    on the XLA scans or on the Pallas kernels in interpret mode; beta and
    bd on the valid cells."""
    if short:
        (lpb, lpe, al, ll), (jb, je, jal, jll) = ragged()
    else:
        lpb, lpe, al, ll = torch_lattice()
        jb, je, jal, jll = jax_lattice()
    B, T, U = lpb.shape
    valid = valid_cells(al, ll, T, U)
    dv = lattice.DELAY_FUNCS[delay_func](lpb.shape, al, ll)
    jdv = JAX_DELAY[delay_func](jb.shape, jal, jll)
    close(dv, jdv, atol=1e-6)
    a, ad = lattice.alphas_and_expected_delay(lpb, lpe, dv)
    if pallas:
        ja = pallas_kernel.pallas_alphas(jb, je, interpret=True)
        jad = pallas_kernel.pallas_expected_delay(jb, je, ja, jdv,
                                                  interpret=True)
    else:
        ja = jnp_impl._alphas(jb, je)
        jad = jnp_impl._expected_delay(jb, je, ja, jdv)
    close(a, ja)
    close(ad, jad, atol=1e-5)
    be, bd = lattice.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)
    jbe, jbd = _jax_delay_bwd(jb, je, jal, jll, jdv, pallas)
    close(be, jbe, where=valid)
    close(bd, jbd, atol=1e-5, where=valid)


@pytest.mark.parametrize("U,want", [(1, kernels.WARP), (32, kernels.WARP),
                                    (33, kernels.WARP), (256, kernels.WARP),
                                    (257, kernels.BLOCK),
                                    (1025, kernels.BLOCK)])
def test_lattice_path_follows_u_alone(U, want):
    """The warp set up to 256 label cells (32 lanes x 8 columns), the block
    set beyond; CaatConfig.max_target_positions 1024 gives U up to 1025."""
    assert kernels.lattice_path(U) == want


def test_fused_wrappers_run_twins_on_cpu():
    lpb, lpe, al, ll = torch_lattice()
    dv = lattice.delay_cost_diag_positive(lpb.shape, al, ll)
    counted = (kernels.alphas_and_expected_delay, kernels.betas_and_expected_delay_bwd,
               kernels.alphas, kernels.betas, kernels.affine_rows)
    before = [fn.launches for fn in counted]
    sets = [dict(fn.path_launches) for fn in counted[2:]]
    got = kernels.alphas_and_expected_delay(lpb, lpe, dv)
    want = lattice.alphas_and_expected_delay(lpb, lpe, dv)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    got = kernels.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)
    want = lattice.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert [fn.launches for fn in counted] == before
    assert [fn.path_launches for fn in counted[2:]] == sets
    with pytest.raises(ValueError):
        kernels.alphas_and_expected_delay(lpb, lpe, dv[:, :-1])
    with pytest.raises(ValueError):
        kernels.betas_and_expected_delay_bwd(lpb, lpe[:, :, :-1], al, ll, dv)


def test_fused_twins_are_the_pieces_in_sequence():
    """The fused twins return what the single recursions give in sequence
    (the block set's path): the same alphas, betas, ad and bd, bit for
    bit."""
    (lpb, lpe, al, ll), _ = ragged(seed=1)
    dv = lattice.delay_cost_diagonal(lpb.shape, al, ll)
    a, ad = lattice.alphas_and_expected_delay(lpb, lpe, dv)
    assert torch.equal(a, lattice.alphas(lpb, lpe))
    assert torch.equal(ad, lattice.expected_delay(lpb, lpe, a, dv))
    be, bd = lattice.betas_and_expected_delay_bwd(lpb, lpe, al, ll, dv)
    be2, _, t_valid, emit_ok = lattice.betas(lpb, lpe, al, ll)
    down, up = lattice.beta_shifts(be2, ll)
    assert torch.equal(be, be2)
    assert torch.equal(bd, lattice.expected_delay_bwd(
        lpb, lpe, be2, down, up, dv, t_valid, emit_ok)[0])
