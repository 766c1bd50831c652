"""Device-driven Newton propagation on FIXED Leja points: a
device-driven redesign of the restarted-Newton method for Hermitian
generators (VERDICT r4 item 4; SURVEY §7.4.4).

The reference's Newton method (``src/newton.jl:274-378``) restarts
adaptively — Ritz values from each Arnoldi factorization extend the
Leja sequence, so control flow is data-dependent and every step costs
host round-trips.  For a HERMITIAN generator with a
certified spectral envelope ``[E_min, E_max]`` (the same envelope the
Chebyshev propagator already estimates over the control range,
``src/cheby_propagator.jl:331-345``), the spectrum of every interval
operator lies in a KNOWN real interval — so the interpolation nodes
can be fixed *per propagation* instead of per step:

1. Plan (host, f64): Leja-order points on ``[E_min·dt, E_max·dt]``,
   compute divided differences of ``f`` (default ``exp(-i z)``) at
   them, truncate when the sup-norm interpolation error on a fine grid
   of the interval drops below ``tol`` — for normal matrices this sup
   norm IS the operator-function error bound ``‖f(A) − p(A)‖₂ =
   max_{λ∈spec} |f(λ) − p(λ)|``.
2. Step (device, df64): the fixed Newton recurrence
   ``p ← (H·dt − zₖ)p / radius``, ``Ψ += dₖ₊₁ p`` — same shape as the
   Chebyshev recurrence: static length, no reductions, no host
   round-trips; the whole time grid is ONE ``lax.scan``.

This is the real-Leja-points method of the matrix-exponential
literature (Caliari/Vianello/Bergamaschi's ReLPM), composed with this
framework's dd arithmetic and coeffs-as-data operators.  The adaptive
restarted kernel (:func:`~.newton.newton_apply_dd`) remains the
general path for non-Hermitian generators / unknown envelopes.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NewtonLejaPlan", "newton_leja_plan", "newton_leja_propagate_dd"]


class NewtonLejaPlan(NamedTuple):
    """Host-side plan: Leja points (f64), dd-split divided differences,
    radius, certified sup-norm error of the truncated interpolant."""

    points: np.ndarray      # (n,) f64 — Leja-ordered nodes on [a, b]
    coeffs4: np.ndarray     # (4, n) f32 dd planes of divided differences
    radius: float
    sup_error: float
    a: float
    b: float


def _leja_order(candidates: np.ndarray, n: int) -> np.ndarray:
    """Greedy Leja ordering of real candidates: start at max |z|, each
    next point maximizes ``Π |z − zⱼ|^(1/n)`` (damped product — same
    scheme as :func:`~.newton.extend_leja`, reference
    ``src/newton.jl:97-148``)."""
    pts = np.asarray(candidates, dtype=np.float64)
    out = [pts[np.argmax(np.abs(pts))]]
    pts = np.delete(pts, np.argmax(np.abs(pts)))
    expo = 1.0 / n
    for _ in range(n - 1):
        d = np.abs(pts[:, None] - np.asarray(out)[None, :]) ** expo
        i = int(np.argmax(np.prod(d, axis=1)))
        out.append(pts[i])
        pts = np.delete(pts, i)
    return np.asarray(out)


def _divided_differences(points, func, radius):
    """Newton divided differences of ``func`` at ``points`` with each
    factor normalized by ``radius`` (reference
    ``src/newton.jl:176-214`` scheme, vectorized over the grid)."""
    n = len(points)
    a = np.zeros(n, dtype=np.complex128)
    a[0] = func(points[0])
    for k in range(1, n):
        d = np.complex128(1.0)
        pn = np.complex128(0.0)
        for j in range(1, k):
            d = d * (points[k] - points[j - 1]) / radius
            pn = pn + a[j] * d
        d = d * (points[k] - points[k - 1]) / radius
        if abs(d) <= 1e-200:
            raise FloatingPointError("divided differences underflow")
        a[k] = (func(points[k]) - a[0] - pn) / d
    return a


def _interp_sup_error(points, a, radius, func, grid):
    """Sup-norm of ``f − p_n`` on ``grid`` (the certified bound for
    normal operators)."""
    p = np.full(grid.shape, a[0], dtype=np.complex128)
    w = np.ones(grid.shape, dtype=np.complex128)
    for k in range(1, len(points)):
        w = w * (grid - points[k - 1]) / radius
        p = p + a[k] * w
    return float(np.max(np.abs(func(grid) - p)))


def newton_leja_plan(
    e_min: float,
    e_max: float,
    dt: float,
    *,
    func: Optional[Callable] = None,
    tol: float = 1e-13,
    n_max: int = 512,
    n_grid: int = 4000,
) -> NewtonLejaPlan:
    """Build the fixed-node plan for ``f(H·dt)`` with
    ``spec(H) ⊆ [e_min, e_max]`` (Hermitian).

    Nodes are Leja-ordered from a fine grid of ``[e_min·dt, e_max·dt]``
    and truncated at the first length whose grid sup-error is below
    ``tol`` — the certified per-step error bound for any Hermitian
    operator inside the envelope."""
    if func is None:
        func = lambda z: np.exp(-1j * z)
    lo, hi = sorted((e_min * dt, e_max * dt))
    if not hi > lo:
        raise ValueError("spectral interval must have positive width")
    radius = max((hi - lo) / 4.0, 1e-30)  # interval capacity
    grid = np.linspace(lo, hi, n_grid)
    cand = np.linspace(lo, hi, max(4 * n_max, 1024))
    n_try = 8
    while True:
        pts = _leja_order(cand, min(n_try, n_max))
        a = _divided_differences(pts, func, radius)
        err = _interp_sup_error(pts, a, radius, func, grid)
        if err < tol or n_try >= n_max:
            break
        n_try = min(2 * n_try, n_max)
    # trim to the shortest prefix still under tol (binary refinement)
    n_lo, n_hi = 2, len(pts)
    while n_lo < n_hi:
        mid = (n_lo + n_hi) // 2
        if _interp_sup_error(pts[:mid], a[:mid], radius, func, grid) < tol:
            n_hi = mid
        else:
            n_lo = mid + 1
    n = n_hi
    pts, a = pts[:n], a[:n]
    err = _interp_sup_error(pts, a, radius, func, grid)
    coeffs4 = np.zeros((4, n), dtype=np.float32)
    for i, part in enumerate((a.real, a.imag)):
        hi32 = part.astype(np.float32)
        coeffs4[2 * i] = hi32
        coeffs4[2 * i + 1] = (part - hi32.astype(np.float64)).astype(
            np.float32
        )
    return NewtonLejaPlan(
        points=pts, coeffs4=coeffs4, radius=float(radius),
        sup_error=err, a=lo, b=hi,
    )


@partial(
    jax.jit,
    static_argnames=("n_leja", "n_steps", "radius", "dt",
                     "observable_fn", "store_states"),
)
def _leja_scan_dd(
    terms,
    coeff_tab4,
    z4,
    d4,
    state4,
    n_leja: int,
    n_steps: int,
    radius: float,
    dt: float,
    observable_fn=None,
    store_states: bool = False,
):
    """One compiled scan over all PWC intervals; each step runs the
    fixed Newton recurrence in df64.

    ``terms``: tuple of dd term operators; ``coeff_tab4``:
    ``(n_steps, 4, n_amp)`` per-interval dd amplitude planes;
    ``z4``/``d4``: ``(4, n)`` dd planes of (complex-capable) nodes and
    divided differences; ``state4`` four f32 planes."""
    from .dd_linalg import TermsDDOp, apply_cdd_op
    from .df64 import CDD, DD, cdd_add, cdd_scale, dd_mul

    inv_r4 = np.float32(1.0 / radius), np.float32(
        np.float64(1.0 / radius) - np.float32(1.0 / radius)
    )
    dt_dd = DD(
        jnp.float32(np.float32(dt)),
        jnp.float32(np.float64(dt) - np.float32(dt)),
    )

    def cscalar(W4, k):
        return CDD(DD(W4[0, k], W4[1, k]), DD(W4[2, k], W4[3, k]))

    def merge(s: CDD):
        if jax.config.jax_enable_x64:
            return (s.re.hi.astype(jnp.float64) + s.re.lo) + 1j * (
                s.im.hi.astype(jnp.float64) + s.im.lo
            )
        return jax.lax.complex(s.re.hi + s.re.lo, s.im.hi + s.im.lo)

    def step(state, ctab4):
        rh, rl, ih, il = state
        psi = CDD(DD(rh, rl), DD(ih, il))
        op = TermsDDOp(terms=terms, coeffs4=ctab4, shape=())

        def hdt(v: CDD) -> CDD:
            w = apply_cdd_op(op, v)
            return CDD(dd_mul(w.re, dt_dd), dd_mul(w.im, dt_dd))

        inv_r = DD(jnp.float32(inv_r4[0]), jnp.float32(inv_r4[1]))

        def body(k, carry):
            p, phi = carry
            # p ← (H·dt − z_k) p / radius
            zp = cdd_scale(p, cscalar(z4, k))
            w = hdt(p)
            w = CDD(
                DD(*_dd_sub_planes(w.re, zp.re)),
                DD(*_dd_sub_planes(w.im, zp.im)),
            )
            p = CDD(dd_mul(w.re, inv_r), dd_mul(w.im, inv_r))
            phi = cdd_add(phi, cdd_scale(p, cscalar(d4, k + 1)))
            return (p, phi)

        phi = cdd_scale(psi, cscalar(d4, 0))
        p, phi = jax.lax.fori_loop(0, n_leja - 1, body, (psi, phi))
        out_state = (phi.re.hi, phi.re.lo, phi.im.hi, phi.im.lo)
        if observable_fn is not None:
            o = observable_fn(merge(phi))
        elif store_states:
            o = merge(phi)
        else:
            o = None
        return out_state, o

    return jax.lax.scan(step, state4, coeff_tab4, length=n_steps)


def _dd_sub_planes(x, y):
    from .df64 import dd_sub

    r = dd_sub(x, y)
    return r.hi, r.lo


def newton_leja_propagate_dd(
    psi0,
    generator,
    tlist,
    *,
    e_min: Optional[float] = None,
    e_max: Optional[float] = None,
    func: Optional[Callable] = None,
    tol: float = 1e-13,
    n_max: int = 512,
    backward: bool = False,
    observable_fn=None,
    store_states: bool = False,
    specrange_buffer: float = 0.01,
    dd_operator_terms=None,
    **cheby_kwargs,
):
    """Propagate ``psi0`` over all of ``tlist`` with the fixed-Leja
    Newton method in df64 — ONE compiled executable for the whole time
    grid (Hermitian generators).

    Spectral envelope: pass ``e_min``/``e_max`` (analytic bounds) or
    leave ``None`` to estimate over the control range exactly as the
    Chebyshev propagator does.  Returns
    ``(psi_final_CDD, outputs, plan)``; ``plan.sup_error`` is the
    certified per-step function-approximation bound."""
    from ..models.generators import Generator, Operator, coeff_table_np
    from ..propagators.base import get_uniform_dt
    from ..propagators._dd_support import build_dd_terms, state_to_cdd
    from .newton import _split_c128_planes

    tlist = np.asarray(tlist, dtype=np.float64)
    dt = get_uniform_dt(tlist, tol=1e-12, warn=False)
    if dt is None:
        raise ValueError(
            "fixed-Leja Newton requires a uniform time grid"
        )
    if backward:
        dt = -dt
    if e_min is None or e_max is None:
        from ..propagators.cheby import ChebyPropagator

        prop = ChebyPropagator(
            psi0, generator, tlist,
            specrange_buffer=specrange_buffer, **cheby_kwargs,
        )
        e_min = float(prop.wrk.e_min)
        e_max = e_min + float(prop.wrk.delta)
    plan = newton_leja_plan(
        e_min, e_max, float(dt), func=func, tol=tol, n_max=n_max,
    )
    # interval operators: dd terms once + per-interval coeff planes
    if isinstance(generator, Generator):
        ops = list(generator.ops)
        table = np.asarray(coeff_table_np(generator, tlist), np.float64)
        if backward:
            table = table[::-1]
    elif isinstance(generator, Operator):
        ops = list(generator.ops)
        table = np.broadcast_to(
            np.asarray(generator.coeffs, np.float64)[None, :],
            (len(tlist) - 1, len(generator.coeffs)),
        )
    else:
        ops = [generator]
        table = np.zeros((len(tlist) - 1, 0))
    op_proto = Operator(ops, np.zeros((table.shape[1],)))
    terms = build_dd_terms(op_proto, dd_operator_terms)
    n_steps = len(tlist) - 1
    ctab4 = np.stack(
        [
            np.asarray(_split_c128_planes(row.astype(np.complex128)))
            for row in table
        ],
        axis=0,
    )  # (n_steps, 4, n_amp)
    z4 = np.asarray(
        _split_c128_planes(plan.points.astype(np.complex128))
    )
    psi_dd = state_to_cdd(psi0)
    state4 = (psi_dd.re.hi, psi_dd.re.lo, psi_dd.im.hi, psi_dd.im.lo)
    state4, outputs = _leja_scan_dd(
        terms,
        jnp.asarray(ctab4),
        jnp.asarray(z4),
        jnp.asarray(plan.coeffs4),
        state4,
        len(plan.points),
        n_steps,
        plan.radius,
        float(dt),
        observable_fn,
        store_states,
    )
    from .df64 import CDD, DD

    psi_final = CDD(
        DD(state4[0], state4[1]), DD(state4[2], state4[3])
    )
    return psi_final, outputs, plan
