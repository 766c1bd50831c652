"""Newton-with-restarted-Arnoldi PWC propagator (reference
``src/newton_propagator.jl``).

The general-purpose method for non-Hermitian generators (Liouvillians):
each interval applies ``f(H·dt)`` via
:func:`~quantumpropagators.ops.newton.newton_apply`, with
``func``/``norm_min``/``relerr``/``max_restarts`` carried through
(reference ``src/newton_propagator.jl:137-146``).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..ops.newton import NewtonInfo, newton_apply, newton_apply_dd
from ..utils.timings import TimingData
from ._dd_support import (
    build_dd_terms,
    interval_terms_dd,
    resolve_dd_precision,
    state_to_cdd,
)
from .base import register_method
from .pwc import PWCPropagatorBase

__all__ = ["NewtonPropagator"]


class NewtonPropagator(PWCPropagatorBase):
    """``precision``: ``'auto'`` (double-float when ``jax_enable_x64`` is
    off, native dtype otherwise), ``'dd'`` (force compensated double-float —
    the path without float64 arrays to the reference's 1e-10 contract,
    ``test/test_newton.jl:20``), or ``'native'`` (device dtype)."""

    def __init__(
        self,
        state,
        generator,
        tlist,
        *,
        backward: bool = False,
        parameters=None,
        func: Optional[Callable] = None,
        m_max: int = 10,
        norm_min: float = 1e-14,
        relerr: float = 1e-12,
        max_restarts: int = 50,
        precision: str = "auto",
        dd_operator_terms=None,
        **_ignored,
    ):
        super().__init__(
            state, generator, tlist, backward=backward, parameters=parameters
        )
        self.func = func
        self.m_max = int(m_max)
        self.norm_min = float(norm_min)
        self.relerr = float(relerr)
        self.max_restarts = int(max_restarts)
        self.timing_data = TimingData()
        self.newton_info = NewtonInfo()
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
                self._state_dd = newton_apply_dd(
                    op,
                    self._state_dd,
                    dt,
                    func=self.func,
                    m_max=self.m_max,
                    norm_min=max(self.norm_min, 1e-13),
                    relerr=self.relerr,
                    max_restarts=self.max_restarts,
                    info=self.newton_info,
                )
                self.state = cdd_to_device_complex(self._state_dd)
            else:
                op = self._interval_operator(n)
                self.state = newton_apply(
                    op,
                    self.state,
                    dt,
                    func=self.func,
                    m_max=self.m_max,
                    norm_min=self.norm_min,
                    relerr=self.relerr,
                    max_restarts=self.max_restarts,
                    info=self.newton_info,
                )
            self.timing_data.count("matvec", self.newton_info.matvecs)
            self.newton_info.matvecs = 0
            self._advance()
            return self.state


def _factory(state, generator, tlist, **kwargs):
    keep = (
        "backward",
        "parameters",
        "func",
        "m_max",
        "norm_min",
        "relerr",
        "max_restarts",
        "precision",
        "dd_operator_terms",
    )
    return NewtonPropagator(
        state, generator, tlist, **{k: v for k, v in kwargs.items() if k in keep}
    )


register_method("newton", _factory)
