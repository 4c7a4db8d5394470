"""Model problems: Taylor-Green vortex, Kelvin-Helmholtz, double shear layer.

Rebuild of reference src/model_problems.py.  Expressions are
plain jnp-compatible closures ``(x, y) -> value`` evaluated at DG nodal points
(the analogue of UFL expressions + ``Function.interpolate``); they remain
traceable so forcing terms can be evaluated at traced stage times inside a
jitted step.
"""

from abc import ABC, abstractmethod
import numpy as np
import jax.numpy as jnp

__all__ = ["ModelProblem", "TaylorGreen", "KelvinHelmholtz", "DoubleLayerShearFlow"]


class ModelProblem(ABC):
    """Abstract base class (reference model_problems.py:10-35).

    :arg disc: the HDGDiscretisation providing V_Q / V_p interpolation
    """

    def __init__(self, disc):
        self.disc = disc

    @abstractmethod
    def initial_condition(self):
        """Return (Q_expr, p_expr) initial-condition expressions."""

    @abstractmethod
    def f_rhs(self):
        """Return ``t -> ((x, y) -> (fx, fy))`` forcing factory."""

    def solution(self, t):
        """Exact solution at time t as interpolated coefficient arrays, or None."""
        return None


class TaylorGreen(ModelProblem):
    """Taylor-Green vortex (reference model_problems.py:38-105).

    Stationary fields on the unit square:
        Q_s = (-cos((x-1/2) pi) sin((y-1/2) pi), sin((x-1/2) pi) cos((y-1/2) pi))
        p_s = (sin^2((x-1/2) pi) + sin^2((y-1/2) pi)) / 2
    with exponential or linear decay driven by the forcing -kappa Psi'(t) Q_s.
    """

    def __init__(self, disc, forcing="exponential", kappa=0.5):
        super().__init__(disc)
        assert forcing in ("exponential", "constant"), (
            "Forcing must be 'constant' or 'exponential'"
        )
        self.forcing = forcing
        self.kappa = kappa

    @staticmethod
    def _Q_stationary(x, y):
        pi = jnp.pi
        return (
            -jnp.cos((x - 0.5) * pi) * jnp.sin((y - 0.5) * pi),
            jnp.sin((x - 0.5) * pi) * jnp.cos((y - 0.5) * pi),
        )

    @staticmethod
    def _p_stationary(x, y):
        pi = jnp.pi
        return (jnp.sin((x - 0.5) * pi) ** 2 + jnp.sin((y - 0.5) * pi) ** 2) / 2.0

    def initial_condition(self):
        return self._Q_stationary, self._p_stationary

    def f_rhs(self):
        """Forcing factory (model_problems.py:71-80)."""
        kappa = self.kappa
        if kappa == 0:
            return lambda t: (lambda x, y: (jnp.zeros_like(x), jnp.zeros_like(y)))
        if self.forcing == "exponential":

            def factory(t):
                def f(x, y):
                    qx, qy = self._Q_stationary(x, y)
                    s = -kappa * jnp.exp(-kappa * t)
                    return s * qx, s * qy

                return f

        else:

            def factory(t):
                def f(x, y):
                    qx, qy = self._Q_stationary(x, y)
                    return -kappa * qx, -kappa * qy

                return f

        return factory

    def solution(self, t):
        """Interpolated exact solution with zero-mean pressure (model_problems.py:82-105)."""
        disc = self.disc
        Q_s = disc.interpolate_velocity(self._Q_stationary)
        p_s = disc.interpolate_pressure(self._p_stationary)
        if self.forcing == "exponential":
            Q_exact = jnp.exp(-self.kappa * t) * Q_s
            p_exact = jnp.exp(-2.0 * self.kappa * t) * p_s
        else:
            Q_exact = (1.0 - self.kappa * t) * Q_s
            p_exact = (1.0 - self.kappa * t) ** 2 * p_s
        from ..ops import fields as F

        # reference subtracts the raw integral (unit-volume domain)
        p_exact = p_exact - F.integral(disc.geom, disc.geom.phi0, p_exact)
        return Q_exact, p_exact


class KelvinHelmholtz(ModelProblem):
    """Rigid-rotation disk initial condition on the unit disk mesh
    (reference model_problems.py:108-131); no exact solution."""

    def __init__(self, disc, r_max=0.5):
        super().__init__(disc)
        self.r_max = r_max

    def initial_condition(self):
        r_max = self.r_max

        def Q0(x, y):
            inside = x**2 + y**2 < r_max**2
            return jnp.where(inside, -y, 0.0), jnp.where(inside, x, 0.0)

        return Q0, (lambda x, y: jnp.zeros_like(x))

    def f_rhs(self):
        return lambda t: (lambda x, y: (jnp.zeros_like(x), jnp.zeros_like(y)))


class DoubleLayerShearFlow(ModelProblem):
    """Double shear layer on the 2 pi-periodic square (model_problems.py:134-196).

    Initial pressure uses the reference's 28-term Fourier series whose
    coefficients are oscillatory-weight quadratures (scipy QUADPACK, host-side
    setup only — not in the hot path).
    """

    def __init__(self, disc, rho=np.pi / 15.0, delta=0.05, kmax=28):
        super().__init__(disc)
        self.rho = rho
        self.delta = delta
        import scipy.integrate as integrate

        coeffs = []
        for k in range(kmax):
            c = integrate.quad(
                lambda z: np.where(
                    z <= 0.0,
                    1 - np.tanh((np.pi + 2 * z) / (4 * np.pi * rho)) ** 2,
                    -1 + np.tanh((np.pi - 2 * z) / (4 * np.pi * rho)) ** 2,
                )
                / (np.pi**2 * rho),
                -np.pi,
                np.pi,
                weight="sin",
                wvar=2 * k + 1,
                epsabs=1e-12,
                epsrel=1e-12,
            )[0]
            coeffs.append(c / (1 + (2 * k + 1) ** 2))
        self._coeffs = np.asarray(coeffs)

    def initial_condition(self):
        rho, delta = self.rho, self.delta
        coeffs = jnp.asarray(self._coeffs)

        def Q0(x, y):
            pi = jnp.pi
            u = jnp.where(
                y <= pi,
                jnp.tanh((y - pi / 2.0) / rho),
                jnp.tanh((3.0 / 2.0 * pi - y) / rho),
            )
            return u, delta * jnp.sin(x)

        def p0(x, y):
            pi = jnp.pi
            k = jnp.arange(coeffs.shape[0])
            series = jnp.sum(
                coeffs * jnp.sin((2 * k + 1) * (y[..., None] - pi)), axis=-1
            )
            return delta * jnp.cos(x) * series

        return Q0, p0

    def f_rhs(self):
        return lambda t: (lambda x, y: (jnp.zeros_like(x), jnp.zeros_like(y)))
