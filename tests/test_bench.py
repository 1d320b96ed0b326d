"""Smoke coverage for the driver benchmark entry (bench.py): the headline
pipeline + oracle-khat experiment must run end-to-end at toy scale, emit
every artifact column, and show the oracle ordering the round-3 analysis
rests on (exact-moment Gaussians beat the fitted mixture through the
identical PSIS+resample pipeline)."""

import sys
from pathlib import Path

import numpy as np
import pytest

_REPO_ROOT = str(Path(__file__).resolve().parent.parent)


@pytest.fixture(scope="module")
def bench_module():
    if _REPO_ROOT not in sys.path:
        sys.path.insert(0, _REPO_ROOT)
    import bench

    return bench


def test_run_bench_smoke_with_oracle(bench_module):
    stats = bench_module.run_bench(
        d=50, n_paths=8, maxiters=16, ndraws=80, repeats=1, oracle=True
    )
    for key in (
        "elapsed_s", "paths_per_sec", "trace_lower_s", "xla_compile_s",
        "first_run_s", "compile_total_s", "khat", "khat_oracle_mixture",
        "khat_oracle_moment", "n_success", "logp_grad_evals",
        "frac_paths_capped", "moment_err_mean_sd_units",
        "moment_err_mean_oracle_moment",
        # seed-spread columns
        "khat_range", "khat_verdict", "khat_verdict_stable",
        "moment_err_mean_sd_units_range", "logp_grad_evals_range",
        # the documented remedy (optimizer="cg") measured through the
        # same pipeline on the same keys
        "khat_cg", "khat_cg_verdict", "elapsed_cg_s",
        "moment_err_mean_sd_units_cg",
        # the strongest remedy chain: cg + laplace_resample("diag")
        # inside one jitted program
        "khat_cg_laplace", "khat_cg_laplace_verdict",
        "elapsed_cg_laplace_s", "moment_err_mean_sd_units_cg_laplace",
    ):
        assert key in stats, key
    assert stats["n_success"] == 8
    assert stats["finite_draws"]
    # the oracle ordering that substantiates the khat analysis: an exact
    # moment-matched Gaussian must beat the fitted mixture (measured
    # margins at d=50: ~0.19 vs ~0.54)
    assert stats["khat_oracle_moment"] < stats["khat"]
    assert (
        stats["moment_err_mean_oracle_moment"]
        < stats["moment_err_mean_sd_units"]
    )


def test_quality_spread_semantics(bench_module):
    """Median + range aggregation, NaN accounting, and verdict-boundary
    stability flags."""
    qs = bench_module._quality_spread

    out = qs([{"khat": 0.95, "me": 1.0}, {"khat": 1.1, "me": 2.0},
              {"khat": float("nan"), "me": 1.5}])
    assert out["khat"] == 1.025 and out["khat_range"] == [0.95, 1.1]
    assert out["khat_n_nonfinite"] == 1
    assert out["khat_verdict"] == "very bad"
    # the range crosses the 1.0 boundary (and a repeat was NaN): unstable
    assert out["khat_verdict_stable"] is False
    assert out["me"] == 1.5 and out["me_range"] == [1.0, 2.0]
    assert "me_verdict" not in out  # verdicts only for khat columns

    out2 = qs([{"khat": 0.60}, {"khat": 0.65}])
    assert out2["khat_verdict"] == "ok" and out2["khat_verdict_stable"] is True

    out3 = qs([{"khat": float("nan")}])
    assert out3["khat"] != out3["khat"]  # NaN median preserved
    assert out3["khat_verdict"] == "not computed"

    # the verdict comes from the UNROUNDED median: 0.7004 rounds to the
    # reported 0.7 but is strictly > 0.7, i.e. "bad" not "ok"
    out4 = qs([{"khat": 0.7004}, {"khat": 0.7004}])
    assert out4["khat"] == 0.7
    assert out4["khat_verdict"] == "bad"


def test_hierarchical_truth_matches_zoo(bench_module):
    """bench's truth wrapper and the zoo helper agree (one source of
    truth for the moment-error columns)."""
    from pathfinder_tpu.models.zoo import hierarchical_gaussian_truth

    m1, s1 = bench_module.hierarchical_truth(40, seed=0)
    m2, s2 = hierarchical_gaussian_truth(40, seed=0)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(s1, s2)
    assert m1.shape == (40,)
    assert np.all(s1 > 0)


def test_run_nuts_bench_smoke(bench_module, capsys):
    """--nuts mode: one JSON line with the throughput metric + sampler
    health columns."""
    import json

    bench_module.run_nuts_bench(d=8, num_samples=50, num_warmup=30)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(line)
    assert d["metric"] == "nuts_transitions_per_sec_d8"
    assert d["value"] > 0
    for k in ("elapsed_s", "step_size", "mean_tree_depth", "divergences"):
        assert k in d["extra"]
