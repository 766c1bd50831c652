"""Generator / Operator algebra — the "model" layer (reference L3).

A :class:`Generator` represents a time-dependent operator
``Ĥ(t) = Ĥ₀ + Σₗ aₗ(t) Ĥₗ`` as static operator terms plus amplitudes
(reference ``src/generators.jl:44-61``).  Evaluating it at a point in
time yields an :class:`Operator` — a *lazy* sum ``Σₗ cₗ Ĥₗ`` holding the
(immutable) terms and a coefficient vector (``src/generators.jl:111-125``).

Design: :class:`Operator` is a pytree whose coefficient vector
is an ordinary array leaf, so a jitted propagation step takes
``(ops_pytree, coeffs)`` and control updates flow as array data — zero
retracing, zero reassembly (SURVEY §7.1).  For full propagations the
amplitudes are pre-evaluated once into an ``(nt-1, n_amplitudes)``
*coefficient table* (:func:`coeff_table`), the device-side analogue of
the reference's midpoint-discretized parameter dict
(``src/pwc_utils.jl:29-45``).
"""

from __future__ import annotations

import warnings
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import operators as _ops
from ..ops.operators import (
    add_operators,
    apply,
    is_operator,
    to_dense,
)
from ..utils.iddict import IdDict
from .controls import evaluate, get_controls, substitute

__all__ = [
    "Generator",
    "Operator",
    "ScaledOperator",
    "hamiltonian",
    "liouvillian",
    "coeff_table",
]


class Operator:
    """Lazy static operator ``Σₗ cₗ Ĥₗ``.

    If ``len(coeffs) < len(ops)``, the first ``len(ops) - len(coeffs)``
    operators are *drift* terms with an implicit coefficient of 1
    (reference ``src/generators.jl:100-125``).  Registered as a pytree:
    terms are children (their arrays are leaves) and ``coeffs`` is an
    array leaf, so propagators can feed time-dependent coefficients as
    traced data.
    """

    def __init__(self, ops: Sequence, coeffs):
        ops = list(ops)
        if not isinstance(coeffs, (jnp.ndarray, np.ndarray)):
            coeffs = np.asarray(coeffs)
        if len(coeffs) > len(ops):
            raise ValueError(
                "The number of coefficients cannot exceed the number of "
                "operators in an Operator"
            )
        self.ops = ops
        self.coeffs = coeffs

    @property
    def drift_offset(self) -> int:
        return len(self.ops) - len(self.coeffs)

    @property
    def shape(self):
        return _ops.op_shape(self.ops[0])

    def apply(self, psi):
        """``psi' = (Σₗ cₗ Ĥₗ) psi`` — one fused expression for XLA."""
        off = self.drift_offset
        out = None
        for i, op in enumerate(self.ops):
            term = apply(op, psi)
            if i >= off:
                term = self.coeffs[i - off] * term
            out = term if out is None else out + term
        return out

    def to_dense(self):
        off = self.drift_offset
        acc = None
        for i, op in enumerate(self.ops):
            A = to_dense(op)
            if i >= off:
                A = self.coeffs[i - off] * A
            acc = A if acc is None else acc + A
        return acc

    def _get_controls(self):
        return ()

    def _evaluate(self, *args, vals_dict=None):
        return self

    def _substitute(self, replacements):
        ops = [substitute(op, replacements) for op in self.ops]
        return Operator(ops, self.coeffs)

    def __getitem__(self, idx):
        """Matrix-interface read access ``O[i, j]`` (reference
        ``src/generators.jl:184-216``): the lazily-summed entry."""
        off = self.drift_offset
        val = 0
        for i, op in enumerate(self.ops):
            if isinstance(op, (jnp.ndarray, np.ndarray)):
                entry = op[idx]
            else:
                entry = to_dense(op)[idx]
            if i >= off:
                entry = self.coeffs[i - off] * entry
            val = val + entry
        return val

    def ishermitian(self, tol: float = 1e-12) -> bool:
        """Best-effort hermiticity check (densifies; reference
        ``src/generators.jl:219-221``)."""
        A = np.asarray(self.to_dense())
        return bool(np.allclose(A, A.conj().T, atol=tol))

    def __repr__(self):
        return f"Operator({len(self.ops)} ops, coeffs={np.asarray(self.coeffs)!r})"


def _operator_flatten(O):
    return (tuple(O.ops), O.coeffs), (len(O.ops),)


def _operator_unflatten(aux, children):
    ops, coeffs = children
    obj = object.__new__(Operator)
    obj.ops = list(ops)
    obj.coeffs = coeffs
    return obj


jax.tree_util.register_pytree_node(Operator, _operator_flatten, _operator_unflatten)


class ScaledOperator:
    """Lazy ``α · Ĥ`` (reference ``src/generators.jl:238-249``)."""

    def __init__(self, coeff, operator):
        if isinstance(operator, ScaledOperator):
            coeff = coeff * operator.coeff
            operator = operator.operator
        self.coeff = coeff
        self.operator = operator

    @property
    def shape(self):
        return _ops.op_shape(self.operator)

    def apply(self, psi):
        return self.coeff * apply(self.operator, psi)

    def to_dense(self):
        return self.coeff * to_dense(self.operator)

    def _get_controls(self):
        return ()

    def _evaluate(self, *args, vals_dict=None):
        return self

    def _substitute(self, replacements):
        return ScaledOperator(self.coeff, substitute(self.operator, replacements))

    def __repr__(self):
        return f"ScaledOperator({self.coeff!r}, {self.operator!r})"


def _scaled_flatten(O):
    return (O.coeff, O.operator), ()


def _scaled_unflatten(aux, children):
    obj = object.__new__(ScaledOperator)
    obj.coeff, obj.operator = children
    return obj


jax.tree_util.register_pytree_node(ScaledOperator, _scaled_flatten, _scaled_unflatten)


class Generator:
    """Time-dependent generator ``Ĥ(t) = Σ (drift) + Σₗ aₗ(t) Ĥₗ``.

    ``ops`` contains first the drift terms (no amplitude), then one term
    per amplitude; ``amplitudes`` are controls (callables / midpoint
    arrays / :class:`~quantumpropagators.models.amplitudes` objects).
    Host-side only: propagators turn a Generator into coefficient tables
    + an :class:`Operator` pytree at initialization.
    """

    def __init__(self, ops: Sequence, amplitudes: Sequence):
        ops = list(ops)
        amplitudes = list(amplitudes)
        if len(amplitudes) > len(ops):
            raise ValueError("A Generator requires at least as many operators as amplitudes")
        if len(amplitudes) == 0:
            raise ValueError(
                "A Generator requires at least one amplitude; use a plain "
                "operator for static dynamics"
            )
        shapes = {tuple(_ops.op_shape(op)) for op in ops}
        if len(shapes) > 1:
            raise ValueError(f"All operators must have the same shape, got {shapes}")
        self.ops = ops
        self.amplitudes = amplitudes

    @property
    def drift_offset(self) -> int:
        return len(self.ops) - len(self.amplitudes)

    @property
    def shape(self):
        return _ops.op_shape(self.ops[0])

    def _get_controls(self):
        controls = []
        for ampl in self.amplitudes:
            for c in get_controls(ampl):
                if not any(c is k for k in controls):
                    controls.append(c)
        return tuple(controls)

    def _evaluate(self, *args, vals_dict=None) -> Operator:
        """Evaluate to a static :class:`Operator` at a point in time
        (reference ``src/generators.jl:740-753``)."""
        if vals_dict is None:
            vals_dict = IdDict()
        coeffs = []
        for i, ampl in enumerate(self.amplitudes):
            c = evaluate(ampl, *args, vals_dict=vals_dict)
            if not isinstance(c, (int, float, complex, np.number)) and not (
                hasattr(c, "ndim") and np.ndim(c) == 0
            ):
                raise TypeError(
                    f"amplitude {i} evaluates to {type(c)}, not a number"
                )
            coeffs.append(c)
        return Operator(self.ops, np.asarray(coeffs))

    def _substitute(self, replacements):
        ops = [substitute(op, replacements) for op in self.ops]
        amplitudes = [substitute(a, replacements) for a in self.amplitudes]
        return Generator(ops, amplitudes)

    def __repr__(self):
        return (
            f"Generator({len(self.ops)} ops, {len(self.amplitudes)} amplitudes)"
        )


def hamiltonian(*terms, check: bool = True):
    """Construct a time-dependent Hamiltonian from operator terms.

    Each term is either a static operator (drift) or a 2-tuple
    ``(op, amplitude)``.  Terms with identical amplitudes (by equality
    for numbers, identity otherwise) are merged; drift terms are summed.
    Returns a plain operator if there are no amplitudes, an
    :class:`Operator` if all amplitudes are static numbers, or a
    :class:`Generator` (reference ``src/generators.jl:388-469``).
    """
    ops: list = []
    amplitudes: list = []
    drift: list = []
    for term in terms:
        if isinstance(term, (tuple, list)):
            if len(term) != 2:
                raise ValueError("time-dependent term must be a 2-tuple (op, ampl)")
            op, ampl = term
            if check and is_operator(ampl) and not is_operator(op):
                warnings.warn("It looks like (op, ampl) in term are reversed")
            idx = None
            for i, a in enumerate(amplitudes):
                same = (a is ampl) or (
                    isinstance(a, (int, float, complex))
                    and isinstance(ampl, (int, float, complex))
                    and a == ampl
                )
                if same:
                    idx = i
                    break
            if idx is None:
                ops.append(op)
                amplitudes.append(ampl)
            else:
                ops[idx] = add_operators(ops[idx], op)
        else:
            if len(drift) == 0:
                drift.append(term)
            else:
                drift[0] = add_operators(drift[0], term)
    all_ops = drift + ops
    if len(amplitudes) == 0:
        if len(drift) == 0:
            raise ValueError("Generator has no terms")
        return drift[0]
    if all(isinstance(a, (int, float, complex, np.number)) for a in amplitudes):
        return Operator(all_ops, np.asarray(amplitudes))
    return Generator(all_ops, amplitudes)


# --------------------------------------------------------------------------
# Liouvillian (vectorized Lindblad master equation)
# --------------------------------------------------------------------------

def _ham_to_superop(H, convention: str):
    """``vec(Hρ - ρH)`` generator: ``L = 𝟙⊗H − Hᵀ⊗𝟙``.

    Column-stacking vectorization convention (``vec(AXB) = (Bᵀ⊗A) vec X``),
    matching reference ``src/generators.jl:473-490`` (after
    arXiv:1312.0111, App. B.2).
    """
    import scipy.sparse as sp

    from ..ops.operators import to_scipy_sparse

    H = to_scipy_sparse(H).tocsr().astype(np.complex128)
    Id = sp.identity(H.shape[0], dtype=np.complex128, format="csr")
    L = sp.kron(Id, H) - sp.kron(H.T, Id)
    if convention == "TDSE":
        return L.tocsr()
    if convention == "LvN":
        return (1j * L).tocsr()
    raise ValueError("convention must be 'TDSE' or 'LvN'")


def _lindblad_to_superop(A, convention: str):
    """Dissipator superoperator for a single Lindblad operator
    (reference ``src/generators.jl:493-513``)."""
    import scipy.sparse as sp

    from ..ops.operators import to_scipy_sparse

    A = to_scipy_sparse(A).tocsr().astype(np.complex128)
    Ad = A.conj().T.tocsr()
    AdA = (Ad @ A).tocsr()
    Id = sp.identity(A.shape[0], dtype=np.complex128, format="csr")
    D = sp.kron(Ad.T, A) - 0.5 * sp.kron(Id, AdA) - 0.5 * sp.kron(AdA.T, Id)
    if convention == "TDSE":
        return (1j * D).tocsr()
    if convention == "LvN":
        return D.tocsr()
    raise ValueError("convention must be 'TDSE' or 'LvN'")


def liouvillian(H=None, c_ops=(), *, convention: str):
    """Build the Liouvillian superoperator for a (time-dependent)
    Hamiltonian and collapse operators.

    With ``convention='TDSE'``, the returned ``L`` is directly usable in
    Schrödinger-form propagators (``i ∂ₜ ρ⃗ = L ρ⃗``); with
    ``convention='LvN'``, ``∂ₜ ρ⃗ = L ρ⃗`` (reference
    ``src/generators.jl:571-631``).  ``H`` may be a static operator or a
    :class:`Generator`; the mapping is applied term by term so the
    amplitude structure is preserved.  States are column-stacked
    vectorizations ``ρ⃗ = vec(ρ)`` (Fortran order: ``rho.T.reshape(-1)``
    in numpy).
    """
    from ..ops.operators import csr_from_scipy

    import scipy.sparse as sp

    if isinstance(H, tuple):
        H = hamiltonian(*H, check=False)
    terms = []
    if isinstance(H, Generator):
        off = H.drift_offset
        drift_sup = None
        for i, op in enumerate(H.ops):
            L = _ham_to_superop(op, convention)
            if i < off:
                drift_sup = L if drift_sup is None else drift_sup + L
            else:
                terms.append((csr_from_scipy(L), H.amplitudes[i - off]))
        if c_ops:
            D = None
            for A in c_ops:
                DA = _lindblad_to_superop(A, convention)
                D = DA if D is None else D + DA
            drift_sup = D if drift_sup is None else drift_sup + D
        if drift_sup is not None:
            terms.insert(0, csr_from_scipy(drift_sup))
        return hamiltonian(*terms, check=False)
    # static H (or None)
    L = None
    if H is not None:
        L = _ham_to_superop(H, convention)
    for A in c_ops:
        DA = _lindblad_to_superop(A, convention)
        L = DA if L is None else L + DA
    if L is None:
        raise ValueError("liouvillian requires a Hamiltonian and/or collapse operators")
    return csr_from_scipy(L.tocsr())


# --------------------------------------------------------------------------
# Coefficient tables (device-friendly time dependence)
# --------------------------------------------------------------------------

def coeff_table_np(generator, tlist, *, vals_dict=None):
    """Host-side float64 coefficient table (``(nt-1, n_amplitudes)``
    numpy array) — full f64 precision regardless of ``jax_enable_x64``
    (the df64 kernel path dd-splits it; downcasting through a jnp f32
    array first would lose the lo planes)."""
    if isinstance(generator, Operator):
        nt = len(np.asarray(tlist))
        return np.broadcast_to(
            np.asarray(generator.coeffs, dtype=np.float64),
            (nt - 1, len(generator.coeffs)),
        )
    if not isinstance(generator, Generator):
        nt = len(np.asarray(tlist))
        return np.zeros((nt - 1, 0))
    tlist = np.asarray(tlist, dtype=np.float64)
    nt = len(tlist)
    n_ampl = len(generator.amplitudes)
    C = np.zeros((nt - 1, n_ampl), dtype=np.complex128)
    for l, ampl in enumerate(generator.amplitudes):
        for n in range(nt - 1):
            C[n, l] = evaluate(ampl, tlist, n, vals_dict=vals_dict)
    if np.all(C.imag == 0):
        C = C.real
    return C


def coeff_table(generator, tlist, *, vals_dict=None, dtype=None):
    """Pre-evaluate all amplitudes of ``generator`` on the midpoints of
    ``tlist``.

    Returns an ``(nt-1, n_amplitudes)`` array ``C`` with
    ``C[n, l] = aₗ(t_mid(tlist, n))``.  This is the device-side analogue
    of the reference's per-propagator parameter dict
    (``src/pwc_utils.jl:29-45``): a jitted step for interval ``n``
    consumes ``C[n]`` as plain data, so control updates between
    optimal-control iterations are array updates, never retraces.
    """
    if isinstance(generator, Operator):
        nt = len(np.asarray(tlist))
        return jnp.broadcast_to(
            jnp.asarray(generator.coeffs), (nt - 1, len(generator.coeffs))
        )
    if not isinstance(generator, Generator):
        # static operator: no amplitudes
        nt = len(np.asarray(tlist))
        return jnp.zeros((nt - 1, 0))
    tlist = np.asarray(tlist, dtype=np.float64)
    nt = len(tlist)
    n_ampl = len(generator.amplitudes)
    C = np.zeros((nt - 1, n_ampl), dtype=np.complex128)
    is_complex = False
    for l, ampl in enumerate(generator.amplitudes):
        for n in range(nt - 1):
            v = evaluate(ampl, tlist, n, vals_dict=vals_dict)
            C[n, l] = v
            if isinstance(v, complex) and v.imag != 0:
                is_complex = True
    if not is_complex and np.all(C.imag == 0):
        C = C.real
    if dtype is not None:
        C = C.astype(dtype)
    return jnp.asarray(C)
