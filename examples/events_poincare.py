"""Event detection: batched Poincaré-section crossing times for Van der Pol.

Reference analog: EventZeroFcn root-polish on the dense output
(src/cpp/radaute_impl.hpp:2031-2185) and the vdp_interpolate.cpp dense-output
demo. Here: one batched solve finds, for 4096 different stiffness values mu,
the first time the limit-cycle trajectory crosses x1 = 0 moving downward —
event location rides the solver's collocation interpolant, no re-solving.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax.numpy as jnp
import numpy as np

from janus_tpu.models.problems import vdp_rhs, vdp_jac
from janus_tpu.solve import EVENT_TERMINATED, Options, solve_ivp
from janus_tpu.solve.events import Event

from janus_tpu import config  # noqa: E402

config.use_default_dtype()


def main():
    m = 4096
    # the falling x1=0 crossing happens ~0.81*mu into the relaxation cycle,
    # so cap mu such that every lane crosses inside the horizon
    mus = jnp.asarray(10.0 ** np.linspace(0.0, 1.5, m))   # mu in [1, 31.6]
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1))

    def crossing(t, y, args):
        return y[:, 0]                       # section x1 = 0

    opts = Options(rtol=1e-8, atol=1e-10)
    sol = solve_ivp(vdp_rhs, (0.0, 50.0), y0, method="radau", args=mus,
                    jac=vdp_jac, options=opts,
                    events=Event(crossing, terminal=True, direction=-1.0))

    hit = np.asarray(sol.status) == EVENT_TERMINATED
    t_hit = np.asarray(sol.event_t)
    print(f"crossings found: {int(hit.sum())}/{m}")
    for mu_probe in (1.0, 3.0, 10.0, 30.0):
        i = int(np.argmin(np.abs(np.asarray(mus) - mu_probe)))
        print(f"  mu={float(mus[i]):8.1f}  first x1=0 (falling) at "
              f"t={t_hit[i]:.6f}  x2={float(sol.event_y[i, 1]):+.4f}")
    assert hit.all()
    # sanity: crossing times grow with mu (relaxation slows the descent)
    assert t_hit[-1] > t_hit[0]


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
