"""Krylov (expv) PWC propagator.

The analogue of the reference's ExponentialUtilities propagator
(``src/exponential_utilities_propagator.jl`` +
``ext/QuantumPropagatorsODEExt...ExponentialUtilitiesExt.jl``): each
interval applies ``exp(-i dt H_n)`` via a single Krylov subspace
(:func:`~quantumpropagators.ops.expv.expv_apply`) — no restart loop, no
spectral-range estimate, works for any generator.
"""

from __future__ import annotations

from typing import Optional

from ..ops.expv import expv_apply, expv_apply_dd
from ..utils.timings import TimingData
from ._dd_support import (
    build_dd_terms,
    interval_terms_dd,
    resolve_dd_precision,
    state_to_cdd,
)
from .base import register_method
from .pwc import PWCPropagatorBase

__all__ = ["KrylovPropagator"]


class KrylovPropagator(PWCPropagatorBase):
    """``precision``: see
    :class:`~quantumpropagators.propagators.newton.NewtonPropagator` —
    ``'auto'`` runs compensated double-float when x64 is off, the
    float64-free route to BASELINE config 3's 1e-10 accuracy."""

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        m_max: int = 30,
        tol: Optional[float] = None,
        norm_min: float = 1e-15,
        precision: str = "auto",
        dd_operator_terms=None,
        **_ignored,
    ):
        super().__init__(
            state, generator, tlist, backward=backward, parameters=parameters
        )
        self.m_max = int(m_max)
        self.tol = tol
        self.norm_min = float(norm_min)
        self.timing_data = TimingData()
        self.precision = resolve_dd_precision(precision)
        self._state_dd = None
        self._dd_terms = None
        if self.precision == "dd":
            self._dd_terms = build_dd_terms(
                self._interval_operator(0), dd_operator_terms
            )
            self._state_dd = state_to_cdd(state)

    def set_state(self, state):
        self.state = state
        if self.precision == "dd":
            self._state_dd = state_to_cdd(state)
        return self.state

    @property
    def state_dd(self):
        """The full-precision CDD state (``precision='dd'`` only)."""
        return self._state_dd

    def prop_step(self):
        if self._done:
            return None
        with self.timing_data.section("prop_step"):
            n = self.n
            dt = float(self.tlist[n + 1] - self.tlist[n])
            if self.backward:
                dt = -dt
            if self.precision == "dd":
                from ..ops.dd_linalg import cdd_to_device_complex

                op = interval_terms_dd(
                    self._dd_terms, self._interval_coeffs(n)
                )
                self._state_dd = expv_apply_dd(
                    op,
                    self._state_dd,
                    dt,
                    m=self.m_max,
                    tol=self.tol,
                    norm_min=max(self.norm_min, 1e-13),
                )
                self.state = cdd_to_device_complex(self._state_dd)
            else:
                op = self._interval_operator(n)
                self.state = expv_apply(
                    op,
                    self.state,
                    dt,
                    m=self.m_max,
                    tol=self.tol,
                    norm_min=self.norm_min,
                )
            self.timing_data.count("matvec", self.m_max)
            self._advance()
            return self.state


def _factory(state, generator, tlist, **kwargs):
    keep = ("backward", "parameters", "m_max", "tol", "norm_min",
            "precision", "dd_operator_terms")
    return KrylovPropagator(
        state, generator, tlist, **{k: v for k, v in kwargs.items() if k in keep}
    )


register_method("krylov", _factory)
register_method("expv", _factory)
