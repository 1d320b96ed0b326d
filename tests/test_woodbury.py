"""Woodbury operator-vs-dense sweeps.

Ports the numerical contract of reference ``test/woodbury.jl:117-404``: every
operator is compared against explicit dense materialization ``A + B D Bᵀ``
over {float32, float64} × {diag, dense A} × {diag-like, dense D} × n ∈ {5, 10},
m = 8, plus masked-column and empty-history (m = 0) cases that this build
adds for fixed-shape batching.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pathfinder_tpu.ops.woodbury import WoodburyPDMat, pdfactorize, pdunfactorize


def rand_pd_mat(rng, n, dtype):
    """Random PD matrix (reference ``test/test_utils.jl:7-10``)."""
    U = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = rng.uniform(0.5, 2.0, n)
    return (U @ np.diag(lam) @ U.T).astype(dtype)


def rand_woodbury(rng, n, m, dtype, diag_A=True, diag_D=False, psd_D=True):
    if diag_A:
        A = rng.uniform(0.5, 2.0, n).astype(dtype)
        A_dense = np.diag(A)
    else:
        A = rand_pd_mat(rng, n, dtype)
        A_dense = A
    B = (rng.standard_normal((n, m)) / np.sqrt(n)).astype(dtype)
    if diag_D:
        D = np.diag(rng.uniform(0.5, 2.0, m)).astype(dtype)
    elif psd_D:
        D = rand_pd_mat(rng, m, dtype)
    else:
        # indefinite symmetric D chosen small enough that W stays PD
        D = rng.standard_normal((m, m)).astype(dtype)
        D = 0.1 * (D + D.T)
    W_dense = A_dense + B @ D @ B.T
    return A, B, D, W_dense


CASES = [
    (np.float64, True, False, 5),
    (np.float64, True, True, 10),
    (np.float64, False, False, 10),
    (np.float64, False, True, 5),
    (np.float32, True, False, 10),
    (np.float32, False, False, 5),
]


@pytest.mark.parametrize("dtype,diag_A,diag_D,n", CASES)
def test_woodbury_ops_vs_dense(dtype, diag_A, diag_D, n):
    rng = np.random.default_rng(42)
    m = 8
    A, B, D, W_dense = rand_woodbury(rng, n, m, dtype, diag_A, diag_D)
    W = WoodburyPDMat.from_parts(A, B, D)
    rtol = 1e-10 if dtype == np.float64 else 2e-4
    atol = 1e-10 if dtype == np.float64 else 2e-4

    assert W.dtype == dtype
    np.testing.assert_allclose(W.to_dense(), W_dense, rtol=rtol, atol=atol)
    np.testing.assert_allclose(W.diag(), np.diag(W_dense), rtol=rtol, atol=atol)

    sign, ld = np.linalg.slogdet(W_dense)
    assert sign > 0
    np.testing.assert_allclose(W.logdet(), ld, rtol=rtol, atol=atol)
    la, s = W.logabsdet()
    np.testing.assert_allclose(la, ld, rtol=rtol, atol=atol)
    assert s == 1.0

    x = rng.standard_normal(n).astype(dtype)
    Xm = rng.standard_normal((n, 4)).astype(dtype)

    np.testing.assert_allclose(W.mul(x), W_dense @ x, rtol=rtol, atol=atol)
    np.testing.assert_allclose(W.mul(Xm), W_dense @ Xm, rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        W.solve(x), np.linalg.solve(W_dense, x), rtol=100 * rtol, atol=100 * atol
    )
    np.testing.assert_allclose(
        W.solve(Xm), np.linalg.solve(W_dense, Xm), rtol=100 * rtol, atol=100 * atol
    )

    np.testing.assert_allclose(W.quad(x), x @ W_dense @ x, rtol=10 * rtol, atol=atol)
    np.testing.assert_allclose(
        W.quad(Xm), np.einsum("ij,ik,kj->j", Xm, W_dense, Xm), rtol=10 * rtol,
        atol=10 * atol,
    )
    np.testing.assert_allclose(
        W.invquad(x), x @ np.linalg.solve(W_dense, x), rtol=100 * rtol, atol=atol
    )
    np.testing.assert_allclose(
        W.invquad(Xm),
        np.einsum("ij,ik,kj->j", Xm, np.linalg.inv(W_dense), Xm),
        rtol=100 * rtol,
        atol=100 * atol,
    )

    # factor identities: L Lᵀ = W, whiten/unwhiten round trips
    F = W.factor
    L = np.asarray(F.dense_L())
    np.testing.assert_allclose(L @ L.T, W_dense, rtol=10 * rtol, atol=10 * atol)
    np.testing.assert_allclose(F.Lt_mul(x), L.T @ x, rtol=10 * rtol, atol=10 * atol)
    np.testing.assert_allclose(
        F.L_solve(x), np.linalg.solve(L, x), rtol=100 * rtol, atol=100 * atol
    )
    np.testing.assert_allclose(
        F.Lt_solve(x), np.linalg.solve(L.T, x), rtol=100 * rtol, atol=100 * atol
    )
    np.testing.assert_allclose(
        W.unwhiten(W.whiten(Xm)), Xm, rtol=100 * rtol, atol=100 * atol
    )
    # whitened covariance is the identity: L⁻¹ W L⁻ᵀ = I
    Z = np.asarray(F.L_solve(W_dense))  # L⁻¹ W
    np.testing.assert_allclose(
        np.asarray(F.L_solve(Z.T)).T,  # (L⁻¹ Zᵀ)ᵀ = Z L⁻ᵀ
        np.eye(n),
        rtol=100 * rtol,
        atol=100 * atol,
    )
    np.testing.assert_allclose(
        W.inv_unwhiten(x), np.linalg.solve(L.T, x), rtol=100 * rtol, atol=100 * atol
    )


def test_woodbury_indefinite_D():
    """The L-BFGS core ``D`` is indefinite — W must still factorize
    (reference ``src/inverse_hessian.jl:79-96`` produces such ``D``)."""
    rng = np.random.default_rng(7)
    A, B, D, W_dense = rand_woodbury(
        rng, 12, 6, np.float64, diag_A=True, diag_D=False, psd_D=False
    )
    assert np.all(np.linalg.eigvalsh(W_dense) > 0)
    W = WoodburyPDMat.from_parts(A, B, D)
    np.testing.assert_allclose(W.to_dense(), W_dense, rtol=1e-10)
    np.testing.assert_allclose(W.logdet(), np.linalg.slogdet(W_dense)[1], rtol=1e-10)
    L = np.asarray(W.factor.dense_L())
    np.testing.assert_allclose(L @ L.T, W_dense, rtol=1e-9, atol=1e-12)


def test_woodbury_inv_and_scale():
    rng = np.random.default_rng(3)
    A, B, D, W_dense = rand_woodbury(rng, 8, 4, np.float64)
    W = WoodburyPDMat.from_parts(A, B, D)

    W_inv = W.inv()
    assert isinstance(W_inv, WoodburyPDMat)
    np.testing.assert_allclose(W_inv.to_dense(), np.linalg.inv(W_dense), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(W_inv.logdet(), -W.logdet(), rtol=1e-9)

    W3 = W.scale(3.0)
    np.testing.assert_allclose(W3.to_dense(), 3.0 * W_dense, rtol=1e-10)
    np.testing.assert_allclose((2.0 * W).to_dense(), 2.0 * W_dense, rtol=1e-10)

    # non-positive scalar densifies, exactly like the reference
    # (src/woodbury.jl:357-360: a < 0 falls back to a * Matrix(W))
    Wneg = W * -2.0
    assert not isinstance(Wneg, WoodburyPDMat)
    np.testing.assert_allclose(np.asarray(Wneg), -2.0 * W_dense, rtol=1e-10)
    W0 = W.scale(0)
    assert not isinstance(W0, WoodburyPDMat)
    np.testing.assert_allclose(np.asarray(W0), 0.0 * W_dense)
    # numpy scalars and untraced 0-d arrays are concrete too: they must
    # take the SAME densify path, not silently produce a NaN lazy form
    for c in (np.float64(-2.0), jnp.asarray(-2.0)):
        Wn = W * c
        assert not isinstance(Wn, WoodburyPDMat), type(c)
        np.testing.assert_allclose(np.asarray(Wn), -2.0 * W_dense, rtol=1e-10)


def test_construction_input_contract():
    """Shape/dtype contract: a 1-D B raises (it would silently broadcast
    into an (n, n) X and factor a different matrix); list col_masks are
    accepted; mixed-precision parts are stored in the promoted dtype so
    the pytree has consistent leaves and .dtype matches the factor."""
    rng = np.random.default_rng(5)
    A = rng.uniform(0.5, 2.0, 6)
    B = rng.standard_normal((6, 2)) * 0.3
    D = np.eye(2)
    with pytest.raises(ValueError, match="B must be"):
        WoodburyPDMat.from_parts(A, B[:, 0], D)
    with pytest.raises(ValueError, match="B must be"):
        WoodburyPDMat.from_parts(A, B, np.eye(3))
    Wm = WoodburyPDMat.from_parts(A, B, D, col_mask=[1.0, 0.0])
    np.testing.assert_allclose(
        np.asarray(Wm.to_dense()),
        np.diag(A) + np.outer(B[:, 0], B[:, 0]),
        rtol=1e-9,
    )
    Wmixed = WoodburyPDMat.from_parts(
        jnp.asarray(A),  # f64 under x64
        jnp.asarray(B, jnp.float32),
        jnp.asarray(D, jnp.float32),
    )
    assert Wmixed.B.dtype == Wmixed.A.dtype == Wmixed.dtype
    assert Wmixed.factor.a_half.dtype == Wmixed.dtype


def test_add_scaled_identity_and_add():
    """``W + c·I`` stays in Woodbury form (parity: the reference's
    UniformScaling add, ``src/woodbury.jl:333-338``, checked numerically at
    ``test/woodbury.jl`` "+ ::UniformScaling"); ``W1 + W2`` concatenates the
    low-rank parts."""
    rng = np.random.default_rng(17)
    for diag_A in (True, False):
        A, B, D, W_dense = rand_woodbury(rng, 7, 3, np.float64, diag_A=diag_A)
        W = WoodburyPDMat.from_parts(A, B, D)
        c = 0.37
        Wc = W.add_scaled_identity(c)
        assert isinstance(Wc, WoodburyPDMat)
        np.testing.assert_allclose(
            Wc.to_dense(), W_dense + c * np.eye(7), rtol=1e-10, atol=1e-12
        )
        # the factorization of the shifted matrix is consistent
        np.testing.assert_allclose(
            Wc.logdet(),
            np.linalg.slogdet(W_dense + c * np.eye(7))[1],
            rtol=1e-9,
        )

    A1, B1, D1, Wd1 = rand_woodbury(rng, 6, 2, np.float64, diag_A=True)
    A2, B2, D2, Wd2 = rand_woodbury(rng, 6, 3, np.float64, diag_A=True)
    W12 = WoodburyPDMat.from_parts(A1, B1, D1) + WoodburyPDMat.from_parts(
        A2, B2, D2
    )
    assert isinstance(W12, WoodburyPDMat)
    assert W12.B.shape == (6, 5)
    np.testing.assert_allclose(W12.to_dense(), Wd1 + Wd2, rtol=1e-10, atol=1e-12)
    # mixed diag/dense A promotes to dense A
    A3, B3, D3, Wd3 = rand_woodbury(rng, 6, 2, np.float64, diag_A=False)
    W13 = WoodburyPDMat.from_parts(A1, B1, D1) + WoodburyPDMat.from_parts(
        A3, B3, D3
    )
    np.testing.assert_allclose(W13.to_dense(), Wd1 + Wd3, rtol=1e-10, atol=1e-12)


def test_astype_and_entry():
    rng = np.random.default_rng(31)
    A, B, D, W_dense = rand_woodbury(rng, 6, 3, np.float64)
    W = WoodburyPDMat.from_parts(A, B, D)
    W32 = W.astype(jnp.float32)
    assert W32.dtype == jnp.float32
    np.testing.assert_allclose(W32.to_dense(), W_dense, rtol=1e-5)
    for i, j in [(0, 0), (2, 4), (5, 1)]:
        np.testing.assert_allclose(W.entry(i, j), W_dense[i, j], rtol=1e-12)
    Ad = rand_pd_mat(rng, 6, np.float64)
    Wd = WoodburyPDMat.from_parts(Ad, B, D)
    np.testing.assert_allclose(
        Wd.entry(1, 3), (Ad + B @ D @ B.T)[1, 3], rtol=1e-12
    )


def test_pdunfactorize_roundtrip():
    rng = np.random.default_rng(11)
    for diag_A in (True, False):
        A, B, D, W_dense = rand_woodbury(rng, 9, 4, np.float64, diag_A=diag_A)
        F = pdfactorize(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D))
        A2, B2, D2 = pdunfactorize(F)
        A2_dense = np.diag(A2) if A2.ndim == 1 else np.asarray(A2)
        W2 = A2_dense + np.asarray(B2) @ np.asarray(D2) @ np.asarray(B2).T
        np.testing.assert_allclose(W2, W_dense, rtol=1e-9, atol=1e-12)


def test_masked_columns_match_truncated():
    """A factorization with trailing masked columns must equal the
    factorization of the truncated matrices — the contract the fixed-shape
    L-BFGS history relies on."""
    rng = np.random.default_rng(5)
    n, m, k = 10, 8, 5  # only first k columns active
    A, B, D, _ = rand_woodbury(rng, n, m, np.float64)
    mask = (np.arange(m) < k).astype(np.float64)
    D = D * mask[:, None] * mask[None, :]

    W_masked = WoodburyPDMat.from_parts(A, B, D, col_mask=jnp.asarray(mask))
    W_trunc = WoodburyPDMat.from_parts(A, B[:, :k], D[:k, :k])

    np.testing.assert_allclose(W_masked.to_dense(), W_trunc.to_dense(), rtol=1e-10)
    np.testing.assert_allclose(W_masked.logdet(), W_trunc.logdet(), rtol=1e-10)
    x = rng.standard_normal((n, 3))
    np.testing.assert_allclose(W_masked.mul(x), W_trunc.mul(x), rtol=1e-10)
    np.testing.assert_allclose(W_masked.solve(x), W_trunc.solve(x), rtol=1e-9)
    np.testing.assert_allclose(W_masked.unwhiten(x), W_trunc.unwhiten(x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(W_masked.whiten(x), W_trunc.whiten(x), rtol=1e-9, atol=1e-12)
    # interleaved mask
    mask2 = np.array([1, 0, 1, 1, 0, 1, 0, 0], dtype=np.float64)
    D2 = rand_pd_mat(rng, m, np.float64) * mask2[:, None] * mask2[None, :]
    W_m2 = WoodburyPDMat.from_parts(A, B, D2, col_mask=jnp.asarray(mask2))
    idx = np.where(mask2 > 0)[0]
    W_t2 = WoodburyPDMat.from_parts(A, B[:, idx], D2[np.ix_(idx, idx)])
    np.testing.assert_allclose(W_m2.to_dense(), W_t2.to_dense(), rtol=1e-10)
    np.testing.assert_allclose(W_m2.logdet(), W_t2.logdet(), rtol=1e-10)
    np.testing.assert_allclose(W_m2.whiten(x), W_t2.whiten(x), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", ["chol", "eigh"])
def test_methods_agree_on_deficient_cases(method):
    """Both factorization routes must represent W correctly on the hard
    cases: duplicated columns (exact quadratic L-BFGS histories) and
    m > n."""
    rng = np.random.default_rng(21)
    # duplicated columns
    n, mh = 8, 3
    A = rng.uniform(0.5, 2.0, n)
    Bh = rng.standard_normal((n, mh)) / np.sqrt(n)
    B = np.concatenate([Bh, Bh], axis=1)  # exact duplicates
    Dh = rand_pd_mat(rng, 2 * mh, np.float64) * 0.3
    Wd = np.diag(A) + B @ Dh @ B.T
    W = WoodburyPDMat.from_parts(A, B, Dh, method=method)
    np.testing.assert_allclose(W.to_dense(), Wd, rtol=1e-9, atol=1e-11)
    L = np.asarray(W.factor.dense_L())
    np.testing.assert_allclose(L @ L.T, Wd, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(W.logdet(), np.linalg.slogdet(Wd)[1], rtol=1e-9)
    # m > n
    A2, B2, D2, Wd2 = rand_woodbury(rng, 4, 9, np.float64)
    W2 = WoodburyPDMat.from_parts(A2, B2, D2, method=method)
    np.testing.assert_allclose(W2.to_dense(), Wd2, rtol=1e-9, atol=1e-11)
    x = rng.standard_normal((4, 3))
    np.testing.assert_allclose(W2.solve(x), np.linalg.solve(Wd2, x), rtol=1e-7)
    np.testing.assert_allclose(W2.logdet(), np.linalg.slogdet(Wd2)[1], rtol=1e-9)


def test_all_masked_equals_diagonal():
    rng = np.random.default_rng(9)
    n, m = 6, 4
    A = rng.uniform(0.5, 2.0, n)
    B = rng.standard_normal((n, m))
    D = rng.standard_normal((m, m))
    D = D + D.T
    mask = np.zeros(m)
    W = WoodburyPDMat.from_parts(A, B, D, col_mask=jnp.asarray(mask))
    np.testing.assert_allclose(W.to_dense(), np.diag(A), rtol=1e-12)
    np.testing.assert_allclose(W.logdet(), np.sum(np.log(A)), rtol=1e-12)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(W.whiten(x), x / np.sqrt(A), rtol=1e-12)


def test_empty_lowrank_m0():
    """m = 0 degenerate case (reference ``lbfgs_inverse_hessian`` with J = 0,
    ``src/inverse_hessian.jl:103``)."""
    A = jnp.array([1.0, 4.0, 9.0])
    B = jnp.zeros((3, 0))
    D = jnp.zeros((0, 0))
    W = WoodburyPDMat.from_parts(A, B, D)
    np.testing.assert_allclose(W.to_dense(), np.diag([1.0, 4.0, 9.0]))
    np.testing.assert_allclose(W.logdet(), np.log(36.0))
    x = jnp.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(W.mul(x), np.array([1.0, 8.0, 27.0]))
    np.testing.assert_allclose(W.whiten(x), np.array([1.0, 1.0, 1.0]))


def test_jit_vmap_compatibility():
    rng = np.random.default_rng(17)
    n, m, batch = 7, 4, 5
    As = rng.uniform(0.5, 2.0, (batch, n))
    Bs = rng.standard_normal((batch, n, m)) / np.sqrt(n)
    Ds = np.stack([rand_pd_mat(rng, m, np.float64) for _ in range(batch)])

    @jax.jit
    @jax.vmap
    def batched_logdet_and_solve(A, B, D):
        W = WoodburyPDMat.from_parts(A, B, D)
        return W.logdet(), W.solve(jnp.ones(n))

    lds, solves = batched_logdet_and_solve(As, Bs, Ds)
    for i in range(batch):
        Wd = np.diag(As[i]) + Bs[i] @ Ds[i] @ Bs[i].T
        np.testing.assert_allclose(lds[i], np.linalg.slogdet(Wd)[1], rtol=1e-9)
        np.testing.assert_allclose(solves[i], np.linalg.solve(Wd, np.ones(n)), rtol=1e-8)

    # pytree flatten/unflatten round trip
    W = WoodburyPDMat.from_parts(As[0], Bs[0], Ds[0])
    leaves, treedef = jax.tree_util.tree_flatten(W)
    W2 = jax.tree_util.tree_unflatten(treedef, leaves)
    np.testing.assert_allclose(W2.to_dense(), W.to_dense())


def test_non_pd_yields_nan_flag():
    A = jnp.array([1.0, 1.0, 1.0])
    B = jnp.eye(3)[:, :2]
    D = jnp.diag(jnp.array([-2.0, 0.5]))  # makes W indefinite
    W = WoodburyPDMat.from_parts(A, B, D)
    assert not bool(W.is_finite_pd())
    Agood = jnp.array([3.0, 3.0, 3.0])
    Wg = WoodburyPDMat.from_parts(Agood, B, D)
    assert bool(Wg.is_finite_pd())


def test_derived_constructors_accept_method():
    """Derived objects refactorize; a caller that chose method="eigh" for
    robustness can keep it through inv/astype/scale/add_scaled_identity
    (derived objects do not remember their construction method)."""
    rng = np.random.default_rng(3)
    A = jnp.asarray(rng.uniform(0.5, 2.0, 5))
    B = jnp.asarray(rng.standard_normal((5, 2)))
    D = jnp.asarray(np.eye(2) * 0.5)
    W = WoodburyPDMat.from_parts(A, B, D, method="eigh")
    dense = np.diag(np.asarray(A)) + np.asarray(B) @ np.asarray(D) @ np.asarray(B).T
    for derived, expected in (
        (W.inv(method="eigh"), np.linalg.inv(dense)),
        (W.astype(jnp.float64, method="eigh"), dense),
        (W.scale(2.0, method="eigh"), 2.0 * dense),
        (W.add_scaled_identity(0.3, method="eigh"), dense + 0.3 * np.eye(5)),
    ):
        np.testing.assert_allclose(
            np.asarray(derived.to_dense()), expected, rtol=1e-5, atol=1e-8
        )
