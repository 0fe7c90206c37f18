"""Run the batched stiff solvers' main path on the GPU and check every phase.

    python chip_smoke.py               # one card: phases a-g
    python chip_smoke.py --multi-gpu   # four cards: the sharded phases only

Phases, at the repo's deployment sizes:

  a  headline: 65,536 heterogeneous-μ stiff Van der Pol lanes, Radau9,
     rtol 1e-6, f64, 2 IND tangents, against the native f64 Radau5 oracle
  b  the same solve in compensated f32
  c  the stage-LU Pallas kernel against the plain LU: bare, and end to end
  d  D=128 Fisher-KPP method of lines, 1,024 lanes, PCR against Thomas
  e  rodas and radau adjoint gradients against IND forward tangents
  f  every method of ``solve.FEATURES`` on 8,192 lanes against the oracle
  g  the dry run's neural-Hamiltonian training step and sharded solve

Each phase prints one line with its compile seconds, its run seconds (the
median of warm calls ending in ``block_until_ready``) and every number it
compared beside its limit, then raises if a check failed. The
card's name and power limit come first; the last line is one JSON object
naming the device. Without a GPU it exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

import jax
import jax.numpy as jnp

HEADLINE_M = 65_536
ADJOINT_M = 8_192
MATRIX_M = 8_192
MOL_D, MOL_M = 128, 1_024
TF = 1.0
ORACLE_RTOL, ORACLE_ATOL = 1e-12, 1e-14
FD_EPS = 1e-6
WARM_RUNS = 5
AB_PAIRS = 10


# ---------------------------------------------------------------- checks --

class Phase:
    """Collects one phase's timings and checks into its printed line."""

    def __init__(self, name: str):
        self.name = name
        self.items: list[str] = []
        self.failed: list[str] = []

    def seconds(self, key: str, value: float) -> None:
        self.items.append(f"{key}={value:.3f}s")

    def note(self, key: str, value) -> None:
        self.items.append(f"{key}={value}")

    def check(self, key: str, value: float, op: str, limit: float) -> None:
        value = float(value)
        ok = np.isfinite(value) and {"<=": value <= limit,
                                     ">=": value >= limit}[op]
        self.items.append(f"{key}={value:.6g} ({op} {limit:g})"
                          + ("" if ok else " FAILED"))
        if not ok:
            self.failed.append(key)

    def done(self) -> None:
        print(f"phase {self.name}: " + " | ".join(self.items), flush=True)
        if self.failed:
            raise AssertionError(f"phase {self.name} failed: {self.failed}")


def rel_err(x, ref) -> float:
    """Largest per-lane normwise relative difference; lanes on axis 0."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64).reshape(ref.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    scale = np.maximum(np.max(np.abs(ref), axis=1), np.finfo(float).tiny)
    return float(np.max(np.max(np.abs(x - ref), axis=1) / scale))


def success_fraction(status) -> float:
    from janus_tpu.solve import SUCCESS
    return float(np.mean(np.asarray(status) == SUCCESS))


def sample_lanes(m: int, n: int) -> np.ndarray:
    """n lanes spread evenly over the batch (and so over its μ range)."""
    return np.unique(np.linspace(0, m - 1, n).round().astype(int))


def compile_fn(fn, *args):
    """(executable, compile seconds)."""
    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.perf_counter() - t0


def call_timed(exe, *args):
    """(outputs, seconds) of one call ending in block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(exe(*args))
    return out, time.perf_counter() - t0


def run_timed(exe, *args, reps: int = WARM_RUNS):
    """(outputs, median seconds of ``reps`` calls after one warm-up call)."""
    call_timed(exe, *args)
    times = []
    for _ in range(reps):
        out, t = call_timed(exe, *args)
        times.append(t)
    return out, float(np.median(times))


# ---------------------------------------------------------------- oracle --

def vdp_oracle(y0, mus, tf=TF):
    """Final states [n, 2] from the native f64 Radau5 at rtol 1e-12."""
    from janus_tpu import native
    return np.stack([
        native.radau5_cpu(native.RHS_VDP, 0.0, tf, y, [mu],
                          rtol=ORACLE_RTOL, atol=ORACLE_ATOL)[0]
        for y, mu in zip(np.asarray(y0, np.float64),
                         np.asarray(mus, np.float64))])


def vdp_oracle_jacobian(y0, mus, tf=TF, eps=FD_EPS):
    """∂y(T)/∂y0 [n, 2, 2] by central differences of the oracle."""
    y0 = np.asarray(y0, np.float64)
    cols = []
    for j in range(y0.shape[1]):
        e = np.zeros_like(y0)
        e[:, j] = eps
        cols.append((vdp_oracle(y0 + e, mus, tf)
                     - vdp_oracle(y0 - e, mus, tf)) / (2 * eps))
    return np.stack(cols, axis=-1)


# -------------------------------------------------------------- problems --

def vdp_batch(m: int, dtype, log_mu=(1.0, 3.0)):
    """(y0 [m, 2], μ [m], unit tangent seeds [2, m, 2])."""
    mus = jnp.logspace(*log_mu, m, dtype=dtype)
    y0 = jnp.tile(jnp.array([[2.0, 0.0]], dtype), (m, 1))
    seeds = jnp.stack([jnp.zeros_like(y0).at[:, j].set(1.0)
                       for j in range(2)])
    return y0, mus, seeds


def headline_fn(opts):
    from janus_tpu.models.problems import vdp_jac, vdp_rhs
    from janus_tpu.solve import solve_ivp

    def run(y0, mus, seeds):
        sol = solve_ivp(vdp_rhs, (0.0, TF), y0, method="radau9", args=mus,
                        options=opts, jac=vdp_jac, tangents=seeds)
        return sol.y, sol.sens, sol.status
    return run


def headline_options(**kw):
    from janus_tpu.solve import Options
    return Options(rtol=1e-6, atol=1e-9, pivoting=False, **kw)


def check_against_oracle(ph, y, sens, status, y0, mus, lanes, state_tol,
                         sens_tol=None, success_min=1.0):
    ph.check("success_fraction", success_fraction(status), ">=", success_min)
    y0s, mus_s = np.asarray(y0)[lanes], np.asarray(mus)[lanes]
    ph.check("state_rel_err", rel_err(np.asarray(y)[lanes],
                                      vdp_oracle(y0s, mus_s)),
             "<=", state_tol)
    if sens_tol is not None:
        jac = np.moveaxis(np.asarray(sens)[:, lanes], 0, -1)   # [n, D, K]
        ph.check("tangent_rel_err",
                 rel_err(jac, vdp_oracle_jacobian(y0s, mus_s)),
                 "<=", sens_tol)


# ---------------------------------------------------------------- phases --

def phase_headline(m=HEADLINE_M, n_oracle=64):
    """a: the headline f64 solve with 2 IND tangents."""
    ph = Phase("a headline radau9 f64")
    y0, mus, seeds = vdp_batch(m, jnp.float64)
    exe, c = compile_fn(headline_fn(headline_options()), y0, mus, seeds)
    (y, sens, status), r = run_timed(exe, y0, mus, seeds)
    ph.note("lanes", m)
    ph.seconds("compile", c)
    ph.seconds("median_run", r)
    check_against_oracle(ph, y, sens, status, y0, mus,
                         sample_lanes(m, n_oracle), 1e-4, sens_tol=1e-3)
    ph.done()


def phase_compensated_f32(m=HEADLINE_M, n_oracle=64):
    """b: the headline solve in compensated f32 (HIGHEST einsums)."""
    ph = Phase("b headline radau9 compensated-f32")
    y0, mus, seeds = vdp_batch(m, jnp.float32)
    exe, c = compile_fn(headline_fn(headline_options(compensated=True)),
                        y0, mus, seeds)
    (y, sens, status), r = run_timed(exe, y0, mus, seeds)
    ph.note("lanes", m)
    ph.note("einsum_precision", "HIGHEST")
    ph.seconds("compile", c)
    ph.seconds("median_run", r)
    check_against_oracle(ph, y, sens, status, y0, mus,
                         sample_lanes(m, n_oracle), 1e-3, success_min=0.999)
    ph.done()


def diag_dominant(key, m, d, dtype):
    a = jax.random.normal(key, (m, d, d), dtype)
    return a + 2.0 * d * jnp.eye(d, dtype=dtype)


def phase_stage_lu_kernel(m=HEADLINE_M, dims=(2, 4, 6, 10),
                          e2e_m=HEADLINE_M, n_oracle=16):
    """c: the Pallas stage-LU kernel against the plain LU, bare and in the
    headline solve (medians of warm runs; end to end, AB_PAIRS pairs with
    the order alternating)."""
    from janus_tpu import ops
    from janus_tpu.linalg import smalllu

    ph = Phase("c stage-lu kernel")

    def plain(a, b):
        lu, piv = smalllu.lu_factor(a, pivot=False)
        return smalllu.lu_solve(lu, piv, b)

    def kernel(a, b):
        return ops.lu_solve(ops.lu_factor(a), b)

    compile_s = 0.0
    for dtype, tol in ((jnp.float64, 1e-12), (jnp.float32, 1e-5)):
        for d in dims:
            ka, kb = jax.random.split(jax.random.PRNGKey(d))
            a = diag_dominant(ka, m, d, dtype)
            b = jax.random.normal(kb, (m, d), dtype)
            ep, cp = compile_fn(plain, a, b)
            ek, ck = compile_fn(kernel, a, b)
            compile_s += cp + ck
            xp, tp = run_timed(ep, a, b)
            xk, tk = run_timed(ek, a, b)
            tag = f"{jnp.dtype(dtype).name}_d{d}"
            ph.check(f"{tag}_rel_diff", rel_err(xk, xp), "<=", tol)
            if dtype == jnp.float64:
                ph.note(f"{tag}_us", f"kernel {tk * 1e6:.1f} plain "
                                     f"{tp * 1e6:.1f}")
    ph.seconds("bare_compile", compile_s)

    y0, mus, seeds = vdp_batch(e2e_m, jnp.float64)
    args = (y0, mus, seeds)
    e_plain, c_plain = compile_fn(headline_fn(headline_options()), *args)
    e_kern, c_kern = compile_fn(
        headline_fn(headline_options(pallas_lu=True)), *args)
    ph.seconds("e2e_compile_plain", c_plain)
    ph.seconds("e2e_compile_kernel", c_kern)
    call_timed(e_plain, *args)
    out_k, _ = call_timed(e_kern, *args)
    pairs = [("plain", e_plain), ("kernel", e_kern)]
    times = {"plain": [], "kernel": []}
    for i in range(AB_PAIRS):
        for name, exe in pairs[::1 if i % 2 == 0 else -1]:
            times[name].append(call_timed(exe, *args)[1])
    t_plain, t_kern = (float(np.median(times[k]))
                       for k in ("plain", "kernel"))
    ph.seconds("e2e_median_plain", t_plain)
    ph.seconds("e2e_median_kernel", t_kern)
    ph.note("e2e_speedup", f"{t_plain / t_kern:.3f}")
    wins = sum(k < p for p, k in zip(times["plain"], times["kernel"]))
    ph.note("kernel_wins", f"{wins}/{AB_PAIRS}")
    y, sens, status = out_k
    check_against_oracle(ph, y, sens, status, y0, mus,
                         sample_lanes(e2e_m, n_oracle), 1e-4, sens_tol=1e-3)
    ph.done()


def mol_fn(d=MOL_D):
    """D=128 Fisher-KPP method of lines (the bench's MOL cell)."""
    from janus_tpu.solve import Options, solve_ivp

    dx = 1.0 / (d + 1)
    opts = Options(rtol=1e-4, atol=1e-7, stage_solver="tridiag",
                   pivoting=False)

    def rhs(t, y, args):
        nu, r = args
        left = jnp.pad(y[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(y[:, 1:], ((0, 0), (0, 1)))
        return nu * (left - 2 * y + right) / dx ** 2 + r * y * (1.0 - y)

    def run(y0, rates):
        sol = solve_ivp(rhs, (0.0, 0.4), y0, method="radau",
                        args=(0.01, rates), options=opts)
        return sol.y, sol.status
    return run


def mol_batch(m=MOL_M, d=MOL_D):
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    y0 = jnp.tile(jnp.asarray(np.exp(-100 * (xg - 0.3) ** 2))[None], (m, 1))
    rates = jnp.linspace(1.0, 8.0, m)[:, None]
    return y0, rates


def phase_mol_tridiag(m=MOL_M, d=MOL_D):
    """d: tridiagonal stage solves by PCR and by Thomas."""
    from janus_tpu import config

    ph = Phase(f"d mol-d{d} tridiag")
    y0, rates = mol_batch(m, d)
    exes, outs, times = {}, {}, {}
    for method in ("pcr", "thomas"):
        with mock.patch.object(config, "tridiag_method",
                               lambda platform=None, _m=method: _m):
            exes[method], c = compile_fn(mol_fn(d), y0, rates)
        ph.seconds(f"compile_{method}", c)
    for method in ("pcr", "thomas"):
        outs[method], times[method] = run_timed(exes[method], y0, rates)
        ph.seconds(f"median_{method}", times[method])
        ph.check(f"success_{method}", success_fraction(outs[method][1]),
                 ">=", 1.0)
    ph.check("pcr_vs_thomas_rel_diff",
             rel_err(outs["pcr"][0], outs["thomas"][0]), "<=", 1e-10)
    ph.note("platform_choice", config.tridiag_method())
    ph.done()


def vdp_grad_fns(adjoint, method, opts):
    """(adjoint gradient of Σ y(T)², the same gradient from IND forward
    tangents) as functions of (y0, μ)."""
    from janus_tpu.models.problems import vdp_jac, vdp_rhs
    from janus_tpu.solve import solve_ivp

    def adj(y0, mus):
        def loss(z, mm):
            yT = adjoint(vdp_rhs, (0.0, TF), z, args=mm, options=opts,
                         jac=vdp_jac)
            return jnp.sum(yT ** 2)
        gy, gm = jax.grad(loss, argnums=(0, 1))(y0, mus)
        return jnp.concatenate([gy, gm[:, None]], axis=1)

    def fwd(y0, mus):
        m = y0.shape[0]
        seeds = jnp.stack([jnp.zeros_like(y0).at[:, 0].set(1.0),
                           jnp.zeros_like(y0).at[:, 1].set(1.0),
                           jnp.zeros_like(y0)])
        mu_seeds = jnp.stack([jnp.zeros(m, mus.dtype), jnp.zeros(m, mus.dtype),
                              jnp.ones(m, mus.dtype)])
        sol = solve_ivp(vdp_rhs, (0.0, TF), y0, method=method, args=mus,
                        options=opts, jac=vdp_jac, tangents=seeds,
                        args_tangents=mu_seeds)
        return 2.0 * jnp.einsum("md,kmd->mk", sol.y, sol.sens)
    return adj, fwd


def phase_adjoints(m=ADJOINT_M):
    """e: discrete (rodas) and continuous (radau) adjoint gradients."""
    from janus_tpu.solve import Options, radau_adjoint, rodas_adjoint

    ph = Phase("e adjoints")
    y0, mus, _ = vdp_batch(m, jnp.float64, log_mu=(1.5, 3.0))
    cases = (
        ("rodas", rodas_adjoint, "rodas", 1e-8,
         Options(rtol=1e-4, atol=1e-7, pivoting=False, adjoint_steps=128)),
        ("radau", radau_adjoint, "radau", 1e-5,
         Options(rtol=1e-8, atol=1e-11, pivoting=False, adjoint_steps=512)),
    )
    for name, adjoint, method, tol, opts in cases:
        adj, fwd = vdp_grad_fns(adjoint, method, opts)
        e_adj, c_adj = compile_fn(adj, y0, mus)
        e_fwd, c_fwd = compile_fn(fwd, y0, mus)
        g_adj, r_adj = run_timed(e_adj, y0, mus)
        g_fwd, r_fwd = run_timed(e_fwd, y0, mus)
        ph.seconds(f"{name}_adjoint_compile", c_adj)
        ph.seconds(f"{name}_adjoint_median_run", r_adj)
        ph.seconds(f"{name}_forward_compile", c_fwd)
        ph.seconds(f"{name}_forward_median_run", r_fwd)
        ph.check(f"{name}_nonfinite_lanes",
                 int(np.sum(~np.isfinite(np.asarray(g_adj)).all(axis=1))),
                 "<=", 0)
        ph.check(f"{name}_adjoint_vs_tangent_rel_err",
                 rel_err(g_adj, g_fwd), "<=", tol)
    ph.done()


def phase_method_matrix(m=MATRIX_M, n_oracle=16):
    """f: every method of solve.FEATURES, f64 at rtol 1e-6."""
    from janus_tpu.models.problems import vdp_jac, vdp_rhs
    from janus_tpu.solve import FEATURES, Options, solve_ivp

    ph = Phase("f method matrix")
    lanes = sample_lanes(m, n_oracle)
    explicit = {m_ for m_, sup in FEATURES.items() if not sup[0]}
    opts = Options(rtol=1e-6, atol=1e-9)
    for method in FEATURES:
        stiff = method not in explicit
        y0, mus, _ = vdp_batch(m, jnp.float64,
                               log_mu=(1.0, 3.0) if stiff else (0.0, 1.0))
        kw = {"jac": vdp_jac} if stiff else {}

        def run(y0, mus, method=method, kw=kw):
            sol = solve_ivp(vdp_rhs, (0.0, TF), y0, method=method, args=mus,
                            options=opts, **kw)
            return sol.y, sol.status

        exe, c = compile_fn(run, y0, mus)
        (y, status), r = run_timed(exe, y0, mus)
        ph.seconds(f"{method}_compile", c)
        ph.seconds(f"{method}_median_run", r)
        ph.check(f"{method}_success", success_fraction(status), ">=", 0.999)
        ph.check(f"{method}_rel_err",
                 rel_err(np.asarray(y)[lanes],
                         vdp_oracle(np.asarray(y0)[lanes],
                                    np.asarray(mus)[lanes])),
                 "<=", 1e-3)
    ph.done()


def phase_dryrun(reference_devices=None):
    """g: the dry run's training step and sharded solve on one device,
    against the same step on the CPU; matmuls at 'highest' on both."""
    import __graft_entry__ as graft

    ph = Phase("g neural-hamiltonian dry run")
    ph.note("matmul_precision", "highest")
    ref_devs = reference_devices or jax.devices("cpu")
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        loss = graft._dryrun_body(1)
        ph.seconds("compile_and_run", time.perf_counter() - t0)
        # XLA:CPU executables cached on another host may not run on this
        # one: compile the CPU reference afresh
        cache_on = jax.config.jax_enable_compilation_cache
        jax.config.update("jax_enable_compilation_cache", False)
        try:
            loss_ref = graft._dryrun_body(1, devices=ref_devs)
        finally:
            jax.config.update("jax_enable_compilation_cache", cache_on)
    ph.check("loss_rel_err_vs_cpu", abs(loss - loss_ref) / abs(loss_ref),
             "<=", 1e-5)
    ph.done()


PHASES = (phase_headline, phase_compensated_f32, phase_stage_lu_kernel,
          phase_mol_tridiag, phase_adjoints, phase_method_matrix,
          phase_dryrun)


def phase_multi_gpu(n=4, m_per_card=HEADLINE_M):
    """The headline solve dp-sharded over an n-card mesh against the same
    lanes on one card, then the dp × tp dry run on n cards."""
    import __graft_entry__ as graft
    from jax.sharding import NamedSharding, PartitionSpec as P

    from janus_tpu.parallel.mesh import make_mesh, shard_batch

    ph = Phase(f"multi-gpu x{n} headline sharded")
    if len(jax.devices()) < n:
        raise RuntimeError(f"--multi-gpu needs {n} devices, "
                           f"found {len(jax.devices())}")
    m = n * m_per_card
    y0, mus, seeds = vdp_batch(m, jnp.float64)
    run = headline_fn(headline_options())
    mesh = make_mesh(n)
    sharded = (shard_batch(y0, mesh), shard_batch(mus, mesh),
               jax.device_put(seeds, NamedSharding(mesh, P(None, "data"))))
    e_sh, c_sh = compile_fn(run, *sharded)
    _, r_sh_first = call_timed(e_sh, *sharded)     # includes NCCL set-up
    out_sh, r_sh = run_timed(e_sh, *sharded)

    # the reference: the same lanes in one batch on one card (the any()
    # gates of a trip span the whole batch, so the batch must be the same)
    one = jax.devices()[0]
    single = tuple(jax.device_put(x, one) for x in (y0, mus, seeds))
    e_one, c_one = compile_fn(run, *single)
    out_one, r_one = run_timed(e_one, *single)
    # the same lanes with y0 moved by one ulp: how far ulp-level rounding
    # differences (other fusions in the partitioned program) can move each
    # output of this problem
    y0_ulp = jax.device_put(np.nextafter(np.asarray(y0), np.inf), one)
    out_ulp, _ = call_timed(e_one, y0_ulp, *single[1:])
    ph.note("lanes", m)
    ph.seconds("sharded_compile", c_sh)
    ph.seconds("sharded_first_run", r_sh_first)
    ph.seconds("sharded_median_run", r_sh)
    ph.seconds("one_card_compile", c_one)
    ph.seconds("one_card_median_run", r_one)
    ph.check("sharded_devices", len(out_sh[0].sharding.device_set), ">=", n)
    ph.check("success_fraction", success_fraction(out_sh[2]), ">=", 1.0)
    y_sh, s_sh, st_sh = (np.asarray(x) for x in out_sh)
    y_one, s_one, st_one = (np.asarray(x) for x in out_one)
    y_ulp, s_ulp = (np.asarray(x) for x in out_ulp[:2])
    identical = (np.array_equal(y_sh, y_one) and np.array_equal(s_sh, s_one)
                 and np.array_equal(st_sh, st_one))
    ph.note("bit_identical", identical)
    tangents = lambda s_: np.moveaxis(s_, 0, 1)                # noqa: E731
    ulp_state = rel_err(y_ulp, y_one)
    ulp_tangent = rel_err(tangents(s_ulp), tangents(s_one))
    ph.note("one_ulp_y0_state_rel_diff", f"{ulp_state:.3g}")
    ph.note("one_ulp_y0_tangent_rel_diff", f"{ulp_tangent:.3g}")
    # bit-identical is the target; else within 1e-14, or within 10x what a
    # one-ulp change of y0 does to the same output on one card
    ph.check("state_rel_diff", rel_err(y_sh, y_one), "<=",
             max(1e-14, 10 * ulp_state))
    ph.check("tangent_rel_diff", rel_err(tangents(s_sh), tangents(s_one)),
             "<=", max(1e-14, 10 * ulp_tangent))
    ph.done()

    ph = Phase(f"multi-gpu x{n} dp-tp dry run")
    t0 = time.perf_counter()
    loss = graft.dryrun_multichip(n)
    ph.seconds("compile_and_run", time.perf_counter() - t0)
    ph.check("loss_finite", float(np.isfinite(loss)), ">=", 1.0)
    ph.done()


# ------------------------------------------------------------------ main --

def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi-gpu", action="store_true",
                        help="run only the four-card sharded phases")
    args = parser.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1

    from janus_tpu import config

    config.enable_compile_cache()
    dtype = config.use_default_dtype()
    print(f"card: {card_name_and_power_limit()}", flush=True)
    print(f"jax {jax.__version__} | device_kind={dev.device_kind} | "
          f"devices={len(jax.devices())} | dtype={jnp.dtype(dtype).name}",
          flush=True)

    t0 = time.perf_counter()
    if args.multi_gpu:
        phase_multi_gpu()
    else:
        for phase in PHASES:
            phase()
    print(f"total_seconds={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
