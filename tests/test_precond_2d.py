"""2-D method-of-lines stage preconditioning: Options(precond='lines'|'block').

The reference leaned on GMRES+ILU for PDE-line stage systems
(odesolvers/linsolve.py:60-111; examples/cpp/meinhart_pseudo_transient.cpp —
a 2-D reaction-diffusion problem). ILU's sequential triangular sweeps don't
batch well; the same role is filled by structure-probed preconditioners:
'lines' (exact in-line tridiagonal of a line-blocked layout, 6 colored jvp's,
applied with the existing Thomas/PCR sweeps) and 'block' (exact diagonal
blocks for cell-interleaved layouts, 2b colored jvp's, batched unrolled LU).

Oracles: dense jax.jacfwd for band/block extraction exactness; scipy Radau at
tighter tol for solves; central FD for adjoint gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from janus_tpu.control.precond import (blocks_of_jacobian, line_tridiag_bands,
                                       tridiag_bands)
from janus_tpu.models.problems import (brusselator_2d_rhs, heat_2d_rhs,
                                       laplacian_2d)
from janus_tpu.solve import Options, SUCCESS, solve_ivp
from janus_tpu.solve.radau import solve_radau

# heavy tier: large custom-vjp / jacfwd-through-solve compiles (CLAUDE.md
# suite-budget notes); excluded from the fast tier (pytest -m 'not slow')
pytestmark = pytest.mark.slow


def _dense_jac(f, y):
    """[M, D, D] dense Jacobian oracle (per lane, forward mode)."""
    return jax.vmap(jax.jacfwd(lambda yy: f(yy[None])[0]))(y)


def test_line_tridiag_bands_exact_on_5pt_stencil():
    """nx = 6 (divisible by 3): the plain 3-color extractor folds the ±nx
    diffusion couplings straight onto the diagonal; the 6-color line
    extractor recovers the exact in-line bands."""
    nx, ny = 6, 4
    dx = 0.1
    rng = np.random.default_rng(0)
    m, n = 2, nx * ny
    y = jnp.asarray(rng.normal(size=(m, n)))

    def f(u):
        return 0.3 * laplacian_2d(u, nx, ny, dx) + u * u

    jd = np.asarray(_dense_jac(f, y))                       # [M, N, N]
    want_d = np.diagonal(jd, axis1=-2, axis2=-1)
    want_dl = np.zeros((m, n))
    want_du = np.zeros((m, n))
    for i in range(n):
        if i % nx > 0:
            want_dl[:, i] = jd[:, i, i - 1]
        if i % nx < nx - 1:
            want_du[:, i] = jd[:, i, i + 1]

    dl, d, du = line_tridiag_bands(f, y, nx)
    np.testing.assert_allclose(np.asarray(d), want_d, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dl), want_dl, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(du), want_du, rtol=1e-12,
                               atol=1e-12)

    # the plain 3-color probe IS polluted here (±6 ≡ 0 mod 3)
    _, d3, _ = tridiag_bands(f, y)
    assert float(jnp.max(jnp.abs(d3 - jnp.asarray(want_d)))) > 1.0


def test_blocks_of_jacobian_exact_interleaved():
    """Cell-interleaved 2-species reaction-diffusion on a line: reaction
    couplings are in-block (2×2), spatial neighbors are ±2 (adjacent
    blocks) — the parity-extended 2b-color probe recovers exact blocks."""
    ncell, b = 17, 2
    n = ncell * b
    rng = np.random.default_rng(1)
    m = 3
    y = jnp.asarray(rng.normal(size=(m, n)))

    def f(z):
        u, v = z[:, 0::2], z[:, 1::2]
        left = jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        lap_u = left - 2 * u + right
        lv = jnp.pad(v[:, :-1], ((0, 0), (1, 0)))
        rv = jnp.pad(v[:, 1:], ((0, 0), (0, 1)))
        lap_v = lv - 2 * v + rv
        fu = 0.5 * lap_u + 1.0 - 4.0 * u + u * u * v
        fv = 0.25 * lap_v + 3.0 * u - u * u * v
        out = jnp.zeros_like(z)
        out = out.at[:, 0::2].set(fu)
        return out.at[:, 1::2].set(fv)

    jd = np.asarray(_dense_jac(f, y))
    blocks = np.asarray(blocks_of_jacobian(f, y, b))        # [M, nb, b, b]
    for k in range(ncell):
        np.testing.assert_allclose(
            blocks[:, k], jd[:, k * b:(k + 1) * b, k * b:(k + 1) * b],
            rtol=1e-12, atol=1e-12, err_msg=f"block {k}")


def _scipy_heat_2d(nx, ny, dx, nu, r, y0, tf, rtol, atol):
    from scipy.integrate import solve_ivp as ssolve

    def f1(t, y):
        g = y.reshape(ny, nx)
        lap = np.zeros_like(g)
        lap[:, 1:] += g[:, :-1]
        lap[:, :-1] += g[:, 1:]
        lap[1:, :] += g[:-1, :]
        lap[:-1, :] += g[1:, :]
        lap -= 4.0 * g
        return (nu * lap / dx ** 2).ravel() + r * y * (1 - y)

    ref = ssolve(f1, (0, tf), y0, method="Radau", rtol=rtol, atol=atol)
    assert ref.success
    return ref.y[:, -1]


@pytest.mark.parametrize("stage_solver,iters", [("gmres", 12), ("gmres", 4)])
def test_lines_2d_heat_matches_scipy(stage_solver, iters):
    """16×16 2-D Fisher-KPP (D = 256, far beyond the unrolled LU): the
    line preconditioner captures the in-row couplings exactly; GMRES
    carries the cross-row diffusion — even at 4 iterations."""
    nx = ny = 16
    dx = 1.0 / (nx + 1)
    xg = np.linspace(dx, 1.0 - dx, nx)
    xx, yy = np.meshgrid(xg, xg)
    u0 = np.exp(-40 * ((xx - 0.4) ** 2 + (yy - 0.55) ** 2)).ravel()
    m = 2
    y0 = jnp.tile(jnp.asarray(u0)[None], (m, 1))
    rates = jnp.array([1.0, 6.0])[:, None]
    nu = 0.02
    rhs = heat_2d_rhs(nx, ny, dx)
    tf = 0.3
    opts = Options(rtol=1e-6, atol=1e-9, stage_solver=stage_solver,
                   gmres_iters=iters, precond="lines", precond_block=nx)
    sol = solve_radau(rhs, 0.0, tf, y0, args=(nu, rates), options=opts)
    assert bool(jnp.all(sol.status == SUCCESS))
    for i in range(m):
        want = _scipy_heat_2d(nx, ny, dx, nu, float(rates[i, 0]), u0, tf,
                              1e-9, 1e-12)
        np.testing.assert_allclose(np.asarray(sol.y[i]), want, rtol=1e-4,
                                   atol=1e-7, err_msg=f"lane {i}")


def test_lines_2d_brusselator_adjoint_matches_fd():
    """Species-major 2-D Brusselator (ny ODD so the cross-species diagonal
    coupling can't alias into the line bands), gmres+lines stage solves,
    reverse-mode gradient of a terminal loss w.r.t. the b parameter vs FD.
    This is VERDICT round-3 item 1's 'done' shape (scaled for CPU CI; the
    full-size 32×33 grid is a candidate GPU measurement, see ROADMAP)."""
    from janus_tpu.solve.adjoint import radau_adjoint

    nx, ny = 8, 5
    n = nx * ny
    dx = 1.0 / (nx + 1)
    rhs = brusselator_2d_rhs(nx, ny, dx)
    rng = np.random.default_rng(2)
    m = 2
    u0 = 1.0 + 0.1 * rng.normal(size=(m, n))
    v0 = 3.0 + 0.1 * rng.normal(size=(m, n))
    y0 = jnp.asarray(np.concatenate([u0, v0], axis=1))
    a = jnp.array([1.0, 1.0])
    b = jnp.array([3.0, 3.4])
    du_, dv_ = 0.02, 0.01
    tf = 0.5
    opts = Options(rtol=1e-7, atol=1e-10, stage_solver="gmres",
                   gmres_iters=12, precond="lines", precond_block=nx,
                   adjoint_steps=256)

    @jax.jit
    def loss(bb):
        yT = radau_adjoint(rhs, (0.0, tf), y0, args=(a, bb, du_, dv_),
                           options=opts)
        return jnp.sum(yT ** 2)

    g = jax.jit(jax.grad(loss))(b)
    eps = 1e-5
    for i in range(m):
        e = jnp.zeros((m,)).at[i].set(eps)
        fd = (loss(b + e) - loss(b - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=2e-4,
                                   err_msg=f"lane {i}")

    # primal oracle: scipy Radau on lane 0
    from scipy.integrate import solve_ivp as ssolve

    def f1(t, y):
        return np.asarray(rhs(jnp.zeros((1,)), jnp.asarray(y)[None],
                              (a[:1], b[:1], du_, dv_))[0])

    sol = solve_radau(rhs, 0.0, tf, y0, args=(a, b, du_, dv_), options=opts)
    ref = ssolve(f1, (0, tf), np.asarray(y0[0]), method="Radau",
                 rtol=1e-9, atol=1e-12)
    assert ref.success
    np.testing.assert_allclose(np.asarray(sol.y[0]), ref.y[:, -1],
                               rtol=1e-5, atol=1e-8)


def test_block_precond_interleaved_solve_and_tangents():
    """Cell-interleaved stiff 2-species line with precond='block': the 2×2
    blocks carry the stiff local reaction coupling; GMRES carries the
    (mild) diffusion. IND tangents reuse the same frozen block solvers."""
    ncell, b = 24, 2
    n = ncell * b
    dx = 1.0 / (ncell + 1)
    k_stiff = 200.0

    def rhs(t, y, args):
        kk = args
        u, v = y[:, 0::2], y[:, 1::2]
        left = jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        lap_u = (left - 2 * u + right) / dx ** 2
        lv = jnp.pad(v[:, :-1], ((0, 0), (1, 0)))
        rv = jnp.pad(v[:, 1:], ((0, 0), (0, 1)))
        lap_v = (lv - 2 * v + rv) / dx ** 2
        fu = 0.001 * lap_u - kk * (u - v)
        fv = 0.001 * lap_v + kk * (u - v) - v
        out = jnp.zeros_like(y)
        out = out.at[:, 0::2].set(fu)
        return out.at[:, 1::2].set(fv)

    rng = np.random.default_rng(3)
    m = 2
    y0 = jnp.asarray(1.0 + 0.2 * rng.normal(size=(m, n)))
    tf = 0.5
    opts = Options(rtol=1e-7, atol=1e-10, stage_solver="gmres",
                   gmres_iters=10, precond="block", precond_block=b)
    seeds = jnp.asarray(rng.normal(size=(1, m, n)))
    sol = solve_radau(rhs, 0.0, tf, y0, args=k_stiff, options=opts,
                      tangents=seeds)
    assert bool(jnp.all(sol.status == SUCCESS))

    from scipy.integrate import solve_ivp as ssolve

    def f1(t, y):
        return np.asarray(rhs(jnp.zeros((1,)), jnp.asarray(y)[None],
                              k_stiff)[0])

    ref = ssolve(f1, (0, tf), np.asarray(y0[0]), method="Radau",
                 rtol=1e-9, atol=1e-12)
    assert ref.success
    np.testing.assert_allclose(np.asarray(sol.y[0]), ref.y[:, -1],
                               rtol=1e-5, atol=1e-8)

    @jax.jit
    def term(z):
        return solve_radau(rhs, 0.0, tf, z, args=k_stiff, options=opts).y

    eps = 1e-5
    fd = (term(y0 + eps * seeds[0]) - term(y0 - eps * seeds[0])) / (2 * eps)
    np.testing.assert_allclose(np.asarray(sol.sens[0]), np.asarray(fd),
                               rtol=5e-4, atol=5e-7)


def test_block_precond_adjoint_matches_fd():
    """Reverse mode through the block-preconditioned stage solves: the
    backward sweep transposes the probed blocks per block."""
    from janus_tpu.solve.adjoint import radau_adjoint

    ncell, b = 16, 2
    n = ncell * b
    dx = 1.0 / (ncell + 1)

    def rhs(t, y, args):
        kk = args
        u, v = y[:, 0::2], y[:, 1::2]
        left = jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        lap_u = (left - 2 * u + right) / dx ** 2
        lv = jnp.pad(v[:, :-1], ((0, 0), (1, 0)))
        rv = jnp.pad(v[:, 1:], ((0, 0), (0, 1)))
        lap_v = (lv - 2 * v + rv) / dx ** 2
        fu = 0.001 * lap_u - kk * (u - v)
        fv = 0.001 * lap_v + kk * (u - v) - v
        out = jnp.zeros_like(y)
        out = out.at[:, 0::2].set(fu)
        return out.at[:, 1::2].set(fv)

    rng = np.random.default_rng(4)
    m = 2
    y0 = jnp.asarray(1.0 + 0.2 * rng.normal(size=(m, n)))
    kk = jnp.array([150.0, 220.0])[:, None]
    opts = Options(rtol=1e-7, atol=1e-10, stage_solver="gmres",
                   gmres_iters=10, precond="block", precond_block=b,
                   adjoint_steps=256)

    @jax.jit
    def loss(k):
        yT = radau_adjoint(rhs, (0.0, 0.4), y0, args=k, options=opts)
        return jnp.sum(yT ** 2)

    g = jax.jit(jax.grad(loss))(kk)
    eps = 1e-4
    for i in range(m):
        e = jnp.zeros((m, 1)).at[i, 0].set(eps)
        fd = (loss(kk + e) - loss(kk - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i, 0]), float(fd), rtol=2e-4,
                                   err_msg=f"lane {i}")


def test_precond_option_validation():
    f = lambda t, y, a: -y                              # noqa: E731
    y0 = jnp.zeros((1, 6))
    with pytest.raises(ValueError):                     # unknown structure
        solve_radau(f, 0.0, 1.0, y0,
                    options=Options(stage_solver="gmres", precond="ilu"))
    with pytest.raises(ValueError):                     # block must divide D
        solve_radau(f, 0.0, 1.0, y0,
                    options=Options(stage_solver="gmres", precond="lines",
                                    precond_block=4))
    with pytest.raises(ValueError):                     # block required
        solve_radau(f, 0.0, 1.0, y0,
                    options=Options(stage_solver="gmres", precond="block"))
