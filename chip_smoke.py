"""Smoke run of Pathfinder on CUDA GPUs through the public API.

    python chip_smoke.py              # one GPU: every single-device phase
    python chip_smoke.py --four-gpus  # four GPUs: only the mesh comparisons

One process opens the GPU once. Each phase prints its own lines, with the
card's name and power limit beside every time; any failure raises and the
script exits non-zero. Without a GPU it exits non-zero before any phase.
The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases of the one-GPU run:

1. device gate: platform, device kind and count, versions, XLA_FLAGS, the
   compile-cache directory, and the card from ``nvidia-smi``;
2. operators at real widths: ``WoodburyPDMat`` (n=1000, m=12 and 40) and
   the L-BFGS inverse-Hessian factors of a recorded d=1000 trajectory
   against dense float64 NumPy, and PSIS k̂ against the CPU device — each
   at the default matmul precision and under ``"highest"``;
3. headline: 100 paths on the 1000-D hierarchical posterior, 3 keys, with
   the same keys on the CPU device and one key repeated on the GPU;
4. the 1000-path configuration with its memory analysis and peak memory;
5. the 100-D correlated Gaussian, the 25-D logistic regression, and a
   short NUTS warm start from the Gaussian fit.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

# Operator tolerance (relative, float32, d=1000). Exact f32 arithmetic
# leaves ~1e-5 here: unit roundoff 6e-8 grown by the 1000-term sums of the
# Gram matrix XᵀX and the m×m solves. 1e-3 — what earlier f32 accelerator
# checks of the same operators at d=1000 used — leaves two orders of
# margin, and is what a matmul that rounds its inputs to TF32's 10-bit
# mantissa (unit roundoff 5e-4) would break.
OPERATOR_RTOL = 1e-3
# PSIS k̂ on the GPU vs the CPU device, same f32 log ratios: only the
# order of the sums differs. Verdict thresholds sit at 0.5/0.7/1.0 and k̂
# is reported to two decimals.
KHAT_ATOL = 1e-3
# Mesh floats, sharded vs unsharded (--four-gpus): the compiler may pick
# different kernels for a per-device batch of K/4 paths than for K, and a
# 64-iteration trajectory carries that rounding into the fits. Decisions
# (success, ELBO winners, resample ids, NUTS tree depths) stay exact. CG
# trajectories and NUTS samples are only required finite: on an H100 a
# batch of 25 vs 100 lanes diverged from the sixth CG iteration and the
# first NUTS draw, with or without full-precision matmuls.
MESH_RTOL = 1e-3
# Moment-error bounds, in posterior sd units, at 2.5x the worst of five
# keys recorded for these configurations in float32 before (100-D
# Gaussian: mean 2.0, sd 0.47; logistic regression: mean 0.17, sd 0.11).
# A broken fit or sampler is off by many sd.
GAUSS100_BOUNDS = (5.0, 1.2)
LOGREG25_BOUNDS = (0.43, 0.28)

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(nruns=100, maxiters=64, history_length=6, ndraws_elbo=5)


def log(msg):
    print(msg, flush=True)


def require_gpu(count):
    """The device gate: JAX's default devices must be ``count`` or more
    GPUs. Exits non-zero otherwise; there is no fallback."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a CUDA GPU; JAX's default platform is "
            f"{devices[0].platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs; JAX found {len(devices)}"
        )
    return devices[:count]


def result_line(devices):
    """The contracted last line for the devices the run used."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def card_names():
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def gate(count):
    import jax
    import jaxlib

    from compile_cache import use_compile_cache

    cache = use_compile_cache()
    devices = require_gpu(count)
    cards = card_names()
    log(f"[gate] platform={devices[0].platform} "
        f"kind={devices[0].device_kind!r} count={len(jax.devices())} "
        f"jax={jax.__version__} jaxlib={jaxlib.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache}")
    for line in cards:
        log(f"card: {line}")
    return devices, cards[0]


def _rel(a, ref):
    """Largest absolute error over the reference's largest magnitude."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _at_both_precisions(run):
    """``run()`` at the default matmul precision and under "highest"."""
    import jax

    out = {"default": run()}
    with jax.default_matmul_precision("highest"):
        out["highest"] = run()
    return out


def woodbury_errors(n, m, seed=0):
    """Relative errors of the Woodbury operators at (n, m) vs float64."""
    import jax
    import jax.numpy as jnp

    from pathfinder_tpu.ops.woodbury import WoodburyPDMat

    rng = np.random.default_rng(seed)
    A = rng.uniform(0.5, 2.0, n)
    B = rng.standard_normal((n, m)) * (3.0 / np.sqrt(n))
    U = np.linalg.qr(rng.standard_normal((m, m)))[0]
    D = U @ np.diag(rng.uniform(0.5, 2.0, m)) @ U.T
    W = np.diag(A) + B @ D @ B.T
    X = rng.standard_normal((n, 8))
    W_inv_X = np.linalg.solve(W, X)
    logdet = np.linalg.slogdet(W)[1]

    @jax.jit
    def ops(A, B, D, X, W):
        Wb = WoodburyPDMat.from_parts(A, B, D)
        L = Wb.unwhiten(jnp.eye(n, dtype=A.dtype))
        Z = Wb.whiten(W)  # L⁻¹ W
        return (Wb.solve(X), Wb.logdet(), Wb.invquad(X), L,
                Wb.whiten(Z.T).T)  # L⁻¹ W L⁻ᵀ

    f32 = [jnp.asarray(v, jnp.float32) for v in (A, B, D, X, W)]

    def run():
        solve, ld, iq, L, white = ops(*f32)
        L = np.asarray(L, np.float64)
        return {
            "solve": _rel(solve, W_inv_X),
            "logdet": abs(float(ld) - logdet) / abs(logdet),
            "invquad": _rel(iq, np.sum(X * W_inv_X, axis=0)),
            "unwhiten": _rel(L @ L.T, W),
            "whiten": _rel(white, np.eye(n)),
        }

    return _at_both_precisions(run)


def _dense_inverse_hessians(xs, gs, num_valid, J, eps):
    """Textbook float64 L-BFGS inverse Hessians at every valid point of a
    trace: diag(α) H₀ by the Gilbert–Lemaréchal recursion over accepted
    steps, then H ← (I − ρ s yᵀ) H (I − ρ y sᵀ) + ρ s sᵀ over the ≤ J most
    recent accepted steps before the point, oldest first."""
    xs = np.asarray(xs, np.float64)
    gs = np.asarray(gs, np.float64)
    s = xs[1:] - xs[:-1]
    y = gs[:-1] - gs[1:]  # trace holds ∇logp; the minimizer's y
    L, d = s.shape
    accept = (np.arange(L) < num_valid - 1) & (
        np.sum(y * s, axis=1) > eps * np.sum(y * y, axis=1)
    )
    alphas = [np.ones(d)]
    for i in range(L):
        alpha = alphas[-1]
        if accept[i]:
            a = np.sum(y[i] * alpha * y[i])
            b = np.sum(y[i] * s[i])
            c = np.sum(s[i] / alpha * s[i])
            alpha = b / (a / alpha + y[i] ** 2 - (a / c) * (s[i] / alpha) ** 2)
        alphas.append(alpha)
    out = []
    for p in range(num_valid):
        H = np.diag(alphas[p])
        for i in [i for i in range(p) if accept[i]][-J:]:
            rho = 1.0 / (y[i] @ s[i])
            Hy = H @ y[i]
            H = (H - rho * (np.outer(s[i], Hy) + np.outer(Hy, s[i]))
                 + (rho + rho**2 * (y[i] @ Hy)) * np.outer(s[i], s[i]))
        out.append(H)
    return np.stack(out)


def lbfgs_errors(d=1000, history_length=6, maxiters=64):
    """The L-BFGS inverse-Hessian factors rebuilt from a d=1000 trajectory
    (recorded once on the CPU device) vs a dense float64 build, at every
    valid trajectory point.

    Asserted: the factors themselves (``A + B D Bᵀ`` densified, and its
    product with vectors). Reported beside the CPU device's: what goes
    through the float32 Woodbury factorization of those factors (points
    its finite-PD guard rejects, solve residuals, logdet errors) — that
    factorization loses accuracy on these histories on every backend, so
    the comparison that tells a device apart is with the CPU device."""
    import jax
    import jax.numpy as jnp

    from pathfinder_tpu.models.zoo import HierarchicalGaussian
    from pathfinder_tpu.ops.lbfgs import (
        lbfgs_inverse_hessians,
        minimize_lbfgs_trace,
    )

    target = HierarchicalGaussian(d, seed=0)
    x0 = np.random.default_rng(1).uniform(-2.0, 2.0, d).astype(np.float32)
    cpu = jax.devices("cpu")[0]
    trace = jax.device_get(jax.jit(
        lambda x: minimize_lbfgs_trace(
            jax.value_and_grad(target.logp), x, maxiters=maxiters,
            history_length=history_length,
        )
    )(jax.device_put(x0, cpu)))
    nv = int(trace.num_valid)
    eps = 1e-12  # PathfinderConfig.epsilon_curvature
    H_ref = _dense_inverse_hessians(
        trace.xs, trace.gradients, nv, history_length, eps
    )
    V = np.random.default_rng(2).standard_normal((d, 4))
    logdet_ref = np.linalg.slogdet(H_ref)[1]

    @jax.jit
    def factors(trace, V):
        fits, _, _ = lbfgs_inverse_hessians(
            trace, history_length=history_length, epsilon_curvature=eps
        )
        at = jax.tree_util.tree_map(lambda leaf: leaf[:nv], fits)
        return (jax.vmap(lambda w: w.to_dense())(at),
                jax.vmap(lambda w: w.mul(V))(at),
                jax.vmap(lambda w: w.is_finite_pd())(at),
                jax.vmap(lambda w: w.solve(V))(at),
                jax.vmap(lambda w: w.logdet())(at))

    def run(device):
        put = lambda a: jax.device_put(a, device)  # noqa: E731
        dense, mul, pd, solve, ld = jax.device_get(factors(
            jax.tree_util.tree_map(put, trace), put(V.astype(np.float32))))
        ok = np.asarray(pd, bool)
        res = [_rel(H @ x, V) for H, x, g in zip(H_ref, solve, ok) if g]
        ld_err = np.abs(np.asarray(ld, np.float64)[ok] - logdet_ref[ok]) / (
            np.maximum(np.abs(logdet_ref[ok]), 1.0))
        return {
            "dense": max(_rel(a, r) for a, r in zip(dense, H_ref)),
            "mul": max(_rel(a, H @ V) for a, H in zip(mul, H_ref)),
        }, {
            "guard_rejected": int(np.sum(~ok)),
            "solve_residual_median": float(np.median(res)),
            "solve_residual_max": float(np.max(res)),
            "logdet_err_max": float(np.max(ld_err)),
        }

    out = _at_both_precisions(lambda: run(jax.devices()[0]))
    out["cpu"] = run(cpu)
    return nv, out


def psis_khats():
    """PSIS k̂ of one fixed log-ratio vector on the default device and on
    the CPU device."""
    import jax

    from pathfinder_tpu.ops.psis import psis

    ratios = (np.random.default_rng(7).standard_normal(10_000) * 1.5).astype(
        np.float32)
    fn = jax.jit(lambda r: psis(r).pareto_shape)

    def run():
        return float(fn(jax.device_put(ratios, jax.devices()[0])))

    out = _at_both_precisions(run)
    cpu = float(fn(jax.device_put(ratios, jax.devices("cpu")[0])))
    return {p: (k, cpu) for p, k in out.items()}


def _fmt(errs):
    return " ".join(
        f"{k}={v}" if isinstance(v, int) else f"{k}={v:.3g}"
        for k, v in errs.items()
    )


def operators_phase(card):
    t0 = time.perf_counter()
    worst = {}
    for m in (12, 40):
        for prec, e in woodbury_errors(1000, m).items():
            log(f"[operators] woodbury n=1000 m={m} precision={prec}: "
                f"{_fmt(e)}")
            worst[prec] = max(worst.get(prec, 0.0), *e.values())
    nv, errs = lbfgs_errors()
    for prec, (asserted, factorization) in errs.items():
        log(f"[operators] lbfgs inverse Hessians at the {nv} points of a "
            f"d=1000 trajectory, {'CPU device' if prec == 'cpu' else 'precision=' + prec}: "
            f"{_fmt(asserted)}; float32 factorization: {_fmt(factorization)}")
        if prec in worst:
            worst[prec] = max(worst[prec], *asserted.values())
    for prec, (k_dev, k_cpu) in psis_khats().items():
        log(f"[operators] psis khat precision={prec}: gpu={k_dev:.6f} "
            f"cpu={k_cpu:.6f} diff={abs(k_dev - k_cpu):.3g} "
            f"(tolerance {KHAT_ATOL:g})")
        if not abs(k_dev - k_cpu) <= KHAT_ATOL:
            raise AssertionError(f"psis khat differs from the CPU device "
                                 f"beyond {KHAT_ATOL} ({prec})")
    log(f"[operators] worst asserted relative error: "
        f"default={worst['default']:.3g} highest={worst['highest']:.3g} "
        f"tolerance={OPERATOR_RTOL:g} ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")
    if not worst["default"] <= OPERATOR_RTOL:
        raise AssertionError(
            f"operators at the default matmul precision miss the "
            f"{OPERATOR_RTOL:g} tolerance: {worst['default']:.3g}"
        )
    return worst


def _moment_errors(draws, mean, sd):
    """Max standardized errors of a (d, N) draw matrix's mean and sd."""
    x = np.asarray(draws, np.float64)
    return (float(np.max(np.abs(x.mean(axis=1) - mean) / sd)),
            float(np.max(np.abs(x.std(axis=1) - sd) / sd)))


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def headline_phase(card, d=1000, nruns=100, seeds=(0, 1, 2)):
    import jax

    from pathfinder_tpu import multipathfinder
    from pathfinder_tpu.models.zoo import (
        HierarchicalGaussian,
        hierarchical_gaussian_truth,
    )

    target = HierarchicalGaussian(d, seed=0)
    mean_true, sd_true = hierarchical_gaussian_truth(d, seed=0)

    def run(seed):
        return multipathfinder(target, 10 * nruns, key=jax.random.key(seed),
                               **dict(HEADLINE, nruns=nruns))

    gpu = {}
    for seed in seeds:
        res, t = _timed(lambda: run(seed))
        gpu[seed] = res
        success = np.asarray(res.states.success)
        first_try = int(np.sum(np.asarray(res.num_tries) == 1))
        finite = bool(np.all(np.isfinite(np.asarray(res.draws))))
        me, se = _moment_errors(res.draws, mean_true, sd_true)
        log(f"[headline] key={seed}: {int(success.sum())}/{nruns} succeeded "
            f"({first_try} on the first try), finite draws={finite}, "
            f"khat={float(res.psis_result.pareto_shape):.3f}, moment errors "
            f"mean={me:.3f} sd={se:.3f} (sd units), wall {t:.3f} s "
            f"{'incl. compile ' if seed == seeds[0] else ''}[{card}]")
        if not (success.all() and finite):
            raise AssertionError(f"headline key {seed}: "
                                 f"{int(success.sum())}/{nruns}, "
                                 f"finite={finite}")

    res2, t = _timed(lambda: run(seeds[0]))
    first, again = np.asarray(gpu[seeds[0]].draws), np.asarray(res2.draws)
    same = np.array_equal(first, again)
    log(f"[headline] key={seeds[0]} repeated on the GPU: draws "
        f"bit-identical={same}, max abs diff="
        f"{float(np.max(np.abs(first - again))):.3g}, wall {t:.3f} s "
        f"[{card}]")

    with jax.default_device(jax.devices("cpu")[0]):
        for seed in seeds:
            res_c, t = _timed(lambda: run(seed))
            g = gpu[seed]
            ok_g = np.asarray(g.states.success)
            ok_c = np.asarray(res_c.states.success)
            fi_g = np.asarray(g.states.fit_iteration)
            fi_c = np.asarray(res_c.states.fit_iteration)
            nv_g = np.asarray(g.states.trace.num_valid)
            nv_c = np.asarray(res_c.states.trace.num_valid)
            me, se = _moment_errors(res_c.draws, mean_true, sd_true)
            log(f"[headline] key={seed} on the CPU device: "
                f"{int(ok_c.sum())}/{nruns} succeeded, "
                f"khat={float(res_c.psis_result.pareto_shape):.3f}, moment "
                f"errors mean={me:.3f} sd={se:.3f}; vs GPU: success equal="
                f"{bool(np.array_equal(ok_g, ok_c))}, fit_iteration equal in "
                f"{int(np.sum(fi_g == fi_c))}/{nruns} paths, trajectory "
                f"length equal in {int(np.sum(nv_g == nv_c))}/{nruns}, max |Δ "
                f"fit_iteration|={int(np.max(np.abs(fi_g - fi_c)))}; CPU "
                f"wall {t:.3f} s")
            if not np.array_equal(ok_g, ok_c):
                raise AssertionError(f"headline key {seed}: per-path success "
                                     "differs between the GPU and the CPU")
    return same


def k1000_phase(card, d=1000, K=1000):
    import jax
    import jax.numpy as jnp

    from pathfinder_tpu import multipathfinder
    from pathfinder_tpu.models.zoo import HierarchicalGaussian
    from pathfinder_tpu.singlepath import pathfinder_core

    target = HierarchicalGaussian(d, seed=0)
    kw = dict(HEADLINE, nruns=K)
    res, t_first = _timed(lambda: multipathfinder(
        target, 10 * K, key=jax.random.key(5), **kw))
    res, t = _timed(lambda: multipathfinder(
        target, 10 * K, key=jax.random.key(6), **kw))
    success = int(np.sum(np.asarray(res.states.success)))
    finite = bool(np.all(np.isfinite(np.asarray(res.draws))))
    log(f"[k1000] {success}/{K} succeeded, finite draws={finite}, "
        f"khat={float(res.psis_result.pareto_shape):.3f}, draws "
        f"{tuple(res.draws.shape)}, wall {t_first:.3f} s incl. compile, "
        f"{t:.3f} s warm [{card}]")
    if not (success == K and finite):
        raise AssertionError(f"k1000: {success}/{K}, finite={finite}")

    config = res.config
    keys = jax.random.split(jax.random.key(0), K)
    x0s = jnp.zeros((K, d), jnp.float32)
    compiled = jax.jit(jax.vmap(
        lambda k, x: pathfinder_core(k, x, target, config)
    )).lower(keys, x0s).compile()
    log(f"[k1000] path-batch program memory_analysis: "
        f"{compiled.memory_analysis()}")
    # the CPU backend reports no memory statistics
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"[k1000] peak_bytes_in_use={peak} of bytes_limit="
        f"{stats.get('bytes_limit')} [{card}]")
    return peak


def configs_phase(card):
    import jax

    from pathfinder_tpu import multipathfinder, pathfinder
    from pathfinder_tpu.integrations import nuts_warm_start
    from pathfinder_tpu.models.zoo import (
        CorrelatedGaussian,
        LogisticRegression,
        german_credit_synthetic,
    )

    target2 = CorrelatedGaussian(100, seed=0)
    res2, t = _timed(lambda: pathfinder(
        target2, key=jax.random.key(2), ndraws=2000, maxiters=128,
        history_length=20, ndraws_elbo=100))
    me, se = _moment_errors(res2.draws, target2.mean,
                            np.sqrt(np.diag(target2.cov)))
    log(f"[config2] CorrelatedGaussian(100): success={res2.success}, "
        f"moment errors mean={me:.3f} sd={se:.3f} (bounds "
        f"{GAUSS100_BOUNDS}), wall {t:.3f} s incl. compile [{card}]")
    if not (res2.success and me < GAUSS100_BOUNDS[0]
            and se < GAUSS100_BOUNDS[1]):
        raise AssertionError("config 2 out of bounds")

    X, y, _ = german_credit_synthetic(n=1000, d=25, seed=0)
    target4 = LogisticRegression(X.astype(np.float32), y.astype(np.float32))
    res4, t = _timed(lambda: multipathfinder(
        target4, 1000, key=jax.random.key(4), nruns=32, maxiters=64))
    truth = np.load(os.path.join(REPO, "benchmarks", "logreg25_truth.npz"))
    me, se = _moment_errors(res4.draws, truth["mean"], truth["sd"])
    ok4 = int(np.sum(np.asarray(res4.states.success)))
    log(f"[config4] LogisticRegression d=25, 32 paths: {ok4}/32 succeeded, "
        f"khat={float(res4.psis_result.pareto_shape):.3f}, moment errors vs "
        f"NUTS truth mean={me:.3f} sd={se:.3f} (bounds {LOGREG25_BOUNDS}), "
        f"wall {t:.3f} s incl. compile [{card}]")
    if not (ok4 == 32 and me < LOGREG25_BOUNDS[0]
            and se < LOGREG25_BOUNDS[1]):
        raise AssertionError("config 4 out of bounds")

    out, t = _timed(lambda: nuts_warm_start(
        jax.random.key(1), res2, num_samples=200, num_warmup=200))
    samples = np.asarray(out.samples)
    finite = bool(np.all(np.isfinite(samples)))
    divergences = int(np.sum(np.asarray(out.diverging)))
    log(f"[nuts] warm start from the config-2 fit: samples "
        f"{samples.shape} finite={finite}, divergences={divergences}, "
        f"step size={float(out.step_size):.4f}, mean tree depth="
        f"{float(np.mean(np.asarray(out.tree_depths))):.2f}, wall {t:.3f} s "
        f"incl. compile [{card}]")
    if not finite:
        raise AssertionError("NUTS samples are not finite")


def four_gpu_phase(devices, card):
    from __graft_entry__ import check_meshes

    t0 = time.perf_counter()
    check_meshes(devices, d=1000, paths_per_device=25, maxiters=64,
                 rtol=MESH_RTOL, log=lambda m: log(f"[mesh] {m}"))
    log(f"[mesh] tolerance {MESH_RTOL:g} relative; "
        f"{time.perf_counter() - t0:.1f} s incl. compile [{card}]")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-gpus", action="store_true",
        help="run only the mesh comparisons, over four GPUs",
    )
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    if args.four_gpus:
        devices, card = gate(4)
        four_gpu_phase(devices, card)
    else:
        devices, card = gate(1)
        operators_phase(card)
        headline_phase(card)
        k1000_phase(card)
        configs_phase(card)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
