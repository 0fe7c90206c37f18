"""chip_smoke.py on the CPU: its comparison helpers, its phases at tiny
sizes, and its refusal to run without a GPU."""

import json

import numpy as np
import pytest

import chip_smoke as cs


@pytest.mark.parametrize("x,ref,expect", [
    ([[1.0, 2.0]], [[1.0, 2.0]], 0.0),
    ([[1.0, 2.5]], [[1.0, 2.0]], 0.25),          # normwise: 0.5 / max|ref|
    ([[1.0, 1e-3], [3.0, 0.0]], [[1.0, 0.0], [2.0, 0.0]], 0.5),  # worst lane
    ([[[1.0, 0.0], [0.0, 1.5]]], [[[1.0, 0.0], [0.0, 1.0]]], 0.5),  # [n,D,K]
])
def test_rel_err_is_per_lane_normwise(x, ref, expect):
    assert cs.rel_err(np.array(x), np.array(ref)) == pytest.approx(expect)


def test_sample_lanes_spread_over_batch():
    lanes = cs.sample_lanes(65536, 64)
    assert len(lanes) == 64 and lanes[0] == 0 and lanes[-1] == 65535
    assert np.all(np.diff(lanes) > 0)
    assert list(cs.sample_lanes(3, 8)) == [0, 1, 2]


def test_phase_check_reports_and_raises(capsys):
    ph = cs.Phase("t")
    ph.check("small", 1e-9, "<=", 1e-6)
    ph.check("frac", 1.0, ">=", 1.0)
    ph.done()
    assert "small=1e-09 (<= 1e-06)" in capsys.readouterr().out
    ph = cs.Phase("t")
    ph.check("nan", float("nan"), "<=", 1.0)
    ph.check("big", 2.0, "<=", 1.0)
    with pytest.raises(AssertionError, match="nan.*big"):
        ph.done()
    assert "FAILED" in capsys.readouterr().out


def test_oracle_and_its_jacobian_match_ind_tangents():
    """The native oracle and its central differences agree with the
    library's own f64 solve and IND tangents at tight tolerance."""
    import jax.numpy as jnp

    from janus_tpu.models.problems import vdp_jac, vdp_rhs
    from janus_tpu.solve import solve_ivp

    y0, mus, seeds = cs.vdp_batch(3, jnp.float64)
    sol = solve_ivp(vdp_rhs, (0.0, cs.TF), y0, method="radau", args=mus,
                    jac=vdp_jac, tangents=seeds, rtol=1e-10, atol=1e-12)
    assert cs.rel_err(sol.y, cs.vdp_oracle(y0, mus)) < 1e-7
    jac = np.moveaxis(np.asarray(sol.sens), 0, -1)
    assert cs.rel_err(jac, cs.vdp_oracle_jacobian(y0, mus)) < 1e-4


def test_headline_phase_tiny(capsys):
    cs.phase_headline(m=32, n_oracle=4)
    assert "state_rel_err" in capsys.readouterr().out


def test_compensated_f32_phase_tiny(capsys):
    cs.phase_compensated_f32(m=32, n_oracle=4)
    assert "success_fraction=1" in capsys.readouterr().out


def test_mol_phase_tiny(capsys):
    cs.phase_mol_tridiag(m=4, d=16)
    out = capsys.readouterr().out
    assert "pcr_vs_thomas_rel_diff" in out and "platform_choice=thomas" in out


def test_adjoint_phase_tiny(capsys):
    cs.phase_adjoints(m=8)
    assert "radau_adjoint_vs_tangent_rel_err" in capsys.readouterr().out


def test_dryrun_phase_on_cpu_devices(capsys):
    cs.phase_dryrun()
    assert "loss_rel_err_vs_cpu=0" in capsys.readouterr().out


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.out.strip().splitlines()[-1] if out.out.strip()
                   else "")


@pytest.mark.gpu
def test_headline_phase_on_gpu():
    cs.phase_headline(m=4096, n_oracle=16)
