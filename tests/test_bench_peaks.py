"""bench.py: its peak table (keyed by device_kind, unknown devices fail)
and its main path end to end at tiny sizes on the CPU."""
import types

import pytest

import bench


def test_h100_peak_bandwidth():
    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert bench.peak_hbm_bw(dev) == 3.35e12


def test_unknown_device_is_an_error():
    dev = types.SimpleNamespace(device_kind="cpu")
    with pytest.raises(KeyError, match="no peak bandwidth"):
        bench.peak_hbm_bw(dev)


def test_main_runs_every_section_at_tiny_sizes(monkeypatch, capsys):
    """bench.main end to end on the CPU through its size knobs: every
    section runs (none logs 'skipped') and the result line is complete.
    The CPU gets a stand-in peak bandwidth, since the table only knows
    GPUs. x64 is off, as in a plain `python bench.py` run."""
    import json
    import signal

    import jax

    for knob in ("NCELLS", "ELL_NC", "STOKES_NC", "STOKES_GD_NC", "AMG_NC",
                 "NS_NC"):
        monkeypatch.setenv(f"BENCH_{knob}", "8")
    monkeypatch.setenv("BENCH_NLEVELS", "2")
    monkeypatch.setenv("BENCH_BUDGET_S", "3600")
    kind = jax.devices()[0].device_kind
    monkeypatch.setitem(bench.PEAK_HBM_BW, kind, 1e11)
    old = signal.getsignal(signal.SIGALRM)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        out = bench.main()
    finally:
        jax.config.update("jax_enable_x64", x64)
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    captured = capsys.readouterr()
    assert "skipped" not in captured.err, captured.err
    assert json.loads(captured.out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out, default=str)
    )
    assert out["status"] == "complete"
    assert out["gmg_cg_dofs"] == 9 ** 3 and out["gmg_cg_iters"] > 0
    for key in ("stokes_fgmres_iters", "stokes_graddiv_iters",
                "amg_cycle_ms", "ns_newton_iters", "ns_graddiv_newton_iters",
                "refine_resid_rel", "ell_xla_ms", "banded_xla_bf16_ms"):
        assert key in out, key
