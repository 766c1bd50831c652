"""Diagonal-plus-site-flip generators (transverse-field Ising family)
through the fused complex128 scan and the host loop.

The reference tests its kernels against dense ``expm`` at 1e-10
(``test/test_cheby.jl:8``) and its driven generators
``Ĥ₀ + Σₗ aₗ(t)Ĥₗ`` (``src/generators.jl:44-61``) through the
propagation loop; these cases hold ``cheby_propagate_fused`` and
``propagate(fused=True)`` to the same contracts on the chain and the
2-D lattice, forward and backward, with uniform and per-site fields.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import expm

import quantumpropagators as qp
from quantumpropagators.fused import cheby_propagate_fused
from quantumpropagators.models.lattice import (
    SiteOperatorSum,
    transverse_field_ising,
    transverse_field_ising_2d,
)
from quantumpropagators.ops.operators import DiagonalOperator

J, H_FIELD = 1.0, 0.3
SX = np.array([[0.0, 1.0], [1.0, 0.0]])


def _state(L, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    return jnp.asarray(psi / np.linalg.norm(psi))


def _static_tfim(geometry, per_site):
    """``(L, Operator, dense H)`` for a static chain or 2-D lattice with
    uniform (g=1.2) or per-site transverse fields."""
    if geometry == "chain":
        L = 8
        H_diag, H_x = transverse_field_ising(L, J=J, g=1.2, h=H_FIELD)
    else:
        L = 8
        H_diag, H_x = transverse_field_ising_2d(2, 4, J=J, g=1.2, h=H_FIELD)
    if per_site:
        gs = np.linspace(0.5, 1.5, L)
        H_x = SiteOperatorSum(jnp.asarray(gs[:, None, None] * SX), L=L)
    op = qp.Operator([H_diag, H_x], np.array([1.0]))
    return L, op, np.asarray(qp.to_dense(op))


@pytest.mark.parametrize("entry", ["cheby_propagate_fused", "propagate"])
@pytest.mark.parametrize("per_site", [False, True], ids=["uniform", "site"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("geometry", ["chain", "lattice2d"])
def test_tfim_vs_expm(geometry, direction, per_site, entry):
    """Static TFIM over a 10-step grid against ``expm`` at 1e-10."""
    L, op, Hd = _static_tfim(geometry, per_site)
    psi0 = _state(L, 7)
    tlist = np.linspace(0.0, 0.5, 11)
    backward = direction == "backward"
    if entry == "propagate":
        got = qp.propagate(psi0, op, tlist, method="cheby", fused=True,
                           backward=backward)
    else:
        got, _ = cheby_propagate_fused(psi0, op, tlist, backward=backward)
    sign = 1.0 if backward else -1.0
    want = expm(sign * 1j * Hd * (tlist[-1] - tlist[0])) @ np.asarray(psi0)
    assert got.dtype == jnp.complex128
    assert np.abs(np.asarray(got) - want).max() < 1e-10


def _driven(kind):
    """Driven L=8 chain generators: diagonal drive, flip drive, both,
    two independently driven flip groups on disjoint sites, and several
    static diagonal terms (an Operator)."""
    L = 8
    H_diag, H_x = transverse_field_ising(L, J=J, g=1.0, h=H_FIELD)
    eps_d = lambda t: 1.0 + 0.3 * np.sin(0.9 * t)
    eps_g = lambda t: 1.2 + 0.4 * np.cos(1.7 * t)
    if kind == "diag":
        return L, qp.hamiltonian((H_diag, eps_d), H_x, check=False)
    if kind == "flip":
        return L, qp.hamiltonian(H_diag, (H_x, eps_g), check=False)
    if kind == "both":
        return L, qp.hamiltonian((H_diag, eps_d), (H_x, eps_g), check=False)
    if kind == "two_groups":
        g_site = np.random.default_rng(29).uniform(0.7, 1.3, size=L)
        odd = tuple(i % 2 == 1 for i in range(L))
        even = tuple(not o for o in odd)
        mats = g_site[:, None, None] * SX
        Hx_odd = SiteOperatorSum(jnp.asarray(mats * np.array(odd)[:, None,
                                 None]), L=L, active=odd)
        Hx_even = SiteOperatorSum(jnp.asarray(mats * np.array(even)[:, None,
                                  None]), L=L, active=even)
        eps_e = lambda t: 0.9 + 0.5 * np.sin(2.3 * t)
        return L, qp.hamiltonian((H_diag, eps_d), (Hx_odd, eps_g),
                                 (Hx_even, eps_e), check=False)
    extra = DiagonalOperator(
        jnp.asarray(np.random.default_rng(33).normal(size=2 ** L)))
    return L, qp.Operator([H_diag, extra, H_x], np.array([1.0, 0.5, 1.1]))


DRIVES = ["diag", "flip", "both", "two_groups", "static_multi_diag"]


@pytest.mark.parametrize("kind", DRIVES)
def test_driven_100_steps_vs_host_loop(kind):
    """100 driven steps through the fused scan match the host
    ``propagate`` loop to 1e-12."""
    L, gen = _driven(kind)
    psi0 = _state(L, 21)
    tlist = np.linspace(0.0, 2.0, 101)
    want = qp.propagate(psi0, gen, tlist, method="cheby")
    got = qp.propagate(psi0, gen, tlist, method="cheby", fused=True)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() < 1e-12
    assert abs(np.linalg.norm(np.asarray(got)) - 1.0) < 1e-11


@pytest.mark.parametrize("kind", DRIVES)
def test_driven_round_trip(kind):
    """Forward then backward through the fused scan returns to psi0."""
    L, gen = _driven(kind)
    psi0 = _state(L, 22)
    tlist = np.linspace(0.0, 0.5, 11)
    fwd, _ = cheby_propagate_fused(psi0, gen, tlist)
    back, _ = cheby_propagate_fused(fwd, gen, tlist, backward=True)
    assert np.abs(np.asarray(back) - np.asarray(psi0)).max() < 1e-12
