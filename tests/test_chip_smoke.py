"""chip_smoke.py's phases, called directly at small sizes on the CPU
(the script itself runs them at full size on a GPU), and its refusal to
run anywhere but on a GPU."""
import pytest

import chip_smoke


def test_main_refuses_a_non_gpu_platform(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_poisson_gmg_small():
    line = chip_smoke.phase_poisson_gmg(n=12, levels=3)
    assert line["dtype"] == "float64"
    assert line["l2_error"] < 1e-6 and line["true_rel_residual"] <= 1e-7


def test_phase_flagship_f32_small():
    line = chip_smoke.phase_flagship_f32(n=12, levels=3)
    assert line["dtype"] == "float32" and line["true_rel_residual"] <= 1e-4


def test_phase_stokes_graddiv_small():
    line, K = chip_smoke.phase_stokes_graddiv(n=8, levels=2)
    it = line["engines"]
    assert abs(it["block"]["iters"] - it["flat"]["iters"]) <= 1
    assert K.shape[0] == K.shape[1] > 0


def test_phase_amg_cg_small():
    line, A = chip_smoke.phase_amg_cg(n=10)
    assert line["true_rel_residual"] <= 1e-7 and A.shape[0] == 11 ** 3


def test_phase_ns_newton_small():
    line = chip_smoke.phase_ns_newton(nc=8, levels=2)
    assert line["final_residual"] <= max(1e-8, 1e-6 * line["initial_residual"])


def test_phase_ell_spmv_small():
    from gridapsolvers_tpu.algebra.convert import to_scipy
    from gridapsolvers_tpu.fem import poisson_problem

    A = to_scipy(poisson_problem((6, 6, 6)).A)
    line = chip_smoke.phase_ell_spmv({"poisson": A})
    assert set(line["cases"]) == {"poisson_float32", "poisson_float64"}


def test_phase_matmul_precision_small():
    line = chip_smoke.phase_matmul_precision(n_cells=6)
    assert line["dofs"] == 7 ** 3 and line["rel_err_vs_f64"] <= 1e-5


def test_phase_four_cards_small():
    """The distributed phase on 4 of the 8 simulated CPU devices: shards
    on 4 distinct devices, iterations and solutions match the 1-device
    mesh."""
    line = chip_smoke.phase_four_cards(n_poisson=16, n_stokes=16)
    for case in line["cases"].values():
        assert case["devices_4"] == 4
        assert abs(case["iters_1"] - case["iters_4"]) <= 1
        assert case["rel_diff"] <= 1e-10
