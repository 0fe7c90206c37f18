"""Piecewise control-parameterization helpers.

The reference feeds piecewise-constant controls to its steppers as per-STEP
parameter slabs (seulexted.py:17-27 ``nparams_step``; dopri853ted.hpp:224-229
``theta`` sliced by step count, with exhaustion errors :417-421). Step-indexed
slabs are ill-defined under adaptive stepping, so the batched counterpart
is TIME-indexed: a [K]-knot schedule evaluated inside the RHS. (For fixed-grid
training runs, ``solve.fixed.odeint_fixed(step_args=...)`` keeps the exact
per-step-slab semantics.)
"""

from __future__ import annotations

import jax.numpy as jnp


def piecewise_constant(t_knots, values):
    """u(t): values[k] on [t_knots[k], t_knots[k+1]); values may be
    [K] or [K, U] or batched [M, K(,U)] with t broadcast accordingly."""
    t_knots = jnp.asarray(t_knots)

    def u(t):
        idx = jnp.clip(jnp.searchsorted(t_knots, t, side="right") - 1,
                       0, values.shape[-2] if values.ndim > 1 else
                       values.shape[-1])
        idx = jnp.clip(idx, 0, (values.shape[0] if values.ndim == 1
                                else values.shape[-2]) - 1)
        if values.ndim == 1:
            return values[idx]
        return jnp.take(values, idx, axis=-2)

    return u


def piecewise_linear(t_knots, values):
    """Linear interpolation between knots, clamped at the ends."""
    t_knots = jnp.asarray(t_knots)

    def u(t):
        return jnp.interp(t, t_knots, values) if values.ndim == 1 else \
            jnp.stack([jnp.interp(t, t_knots, values[..., j])
                       for j in range(values.shape[-1])], axis=-1)

    return u
